"""Distributed helpers (port of ``repro/distributed``): the logical-axis
sharding rules (``sharding``), the collectives that join the LM zoo's
shard bodies across ranks (``collectives``), gradient compression, and
fault tolerance with the elastic ``rescale_state``."""
from repro_torch.distributed.sharding import (  # noqa: F401
    LOGICAL_RULES_DECODE,
    LOGICAL_RULES_DECODE_LONG,
    LOGICAL_RULES_TRAIN,
    axis_rules,
    current_mesh,
    current_rules,
    logical_sharding,
    shard_logical,
    use_mesh_and_rules,
)
