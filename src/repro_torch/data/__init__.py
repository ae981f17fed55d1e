"""Clip dataset pipeline (port of ``repro/data``): ``dataset.py`` only,
which ``launch/serve.py --service`` builds its requests with; the
multicore dataset and the training pipeline come with ROADMAP item 7."""
from repro_torch.data.dataset import (  # noqa: F401
    BuildConfig, BuildStats, ClipDataset, batches, build_dataset,
    build_set_datasets, split_dataset)
