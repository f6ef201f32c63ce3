from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm_clip,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "global_norm_clip",
    "warmup_cosine",
]
