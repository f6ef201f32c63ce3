"""Atomic, keep-k, delta-chained checkpoints (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.store import (
    STREAMING_DELTA_KIND,
    CheckpointManager,
    CheckpointMismatchError,
    checkpoint_kind,
    latest_step,
    list_steps,
    load_pytree,
    read_manifest_extra,
    restore_pytree,
    resume_chain,
    save_pytree,
)

__all__ = [
    "STREAMING_DELTA_KIND",
    "CheckpointManager",
    "CheckpointMismatchError",
    "checkpoint_kind",
    "latest_step",
    "list_steps",
    "load_pytree",
    "read_manifest_extra",
    "restore_pytree",
    "resume_chain",
    "save_pytree",
]
