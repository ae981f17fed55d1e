"""Clip dataset pipeline (port of ``repro/data``): ``dataset.py``, which
``launch/serve.py --service`` builds its requests with and
``launch/train.py`` trains on, and ``multicore_dataset.py``, the
multicore training set."""
from repro_torch.data.dataset import (  # noqa: F401
    BuildConfig, BuildStats, ClipDataset, batches, build_dataset,
    build_set_datasets, split_dataset)
