"""The token-embedding gather with a hand-written gradient on the card."""
from repro_torch.kernels.embedding.ops import embedding_lookup  # noqa: F401
