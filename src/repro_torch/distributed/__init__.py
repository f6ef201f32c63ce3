"""Gradient compression with error feedback.  The sharding rules wait for the
sharded training half (``ROADMAP.md`` Queue 1, ``models.config.
SHARDED_TRAINING_QUEUE_ITEM``)."""

from repro_torch.distributed.compression import (
    ErrorFeedbackState,
    compress_decompress,
    init_error_feedback,
)

__all__ = ["ErrorFeedbackState", "compress_decompress", "init_error_feedback"]
