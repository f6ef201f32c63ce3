from repro_torch.distributed.compression import (
    ErrorFeedbackState,
    compress_decompress,
    init_error_feedback,
)
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    PartitionSpec,
    ShardingRules,
    constrain,
    local_shape,
    make_rules,
    mesh_context,
    placements,
    spec,
)

__all__ = [
    "ErrorFeedbackState",
    "compress_decompress",
    "init_error_feedback",
    "DEFAULT_RULES",
    "PartitionSpec",
    "ShardingRules",
    "constrain",
    "local_shape",
    "make_rules",
    "mesh_context",
    "placements",
    "spec",
]
