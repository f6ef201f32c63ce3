"""Per-UE sums whose bits do not depend on the batch.

On the card PyTorch lays a reduction's threads out by the tensor's shape, the
number of UEs included, so one UE's sum can round differently in a batch of 8
than in a batch of 16 (a shard of a multi-cell campaign, or a bank re-packed
under churn).  ``ue_sum`` reduces each output from its own entries in one
fixed order made of elementwise launches only: the entries are padded with
zeros to a power of two and halved pairwise until one is left.  The CPU takes
the same form, so both devices reduce in one order.
"""

from __future__ import annotations

import torch


def _dims(x: torch.Tensor, dim) -> tuple[int, ...]:
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    return tuple(sorted(d % x.ndim for d in dims))


def ue_sum(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``x.sum(dim)`` as a fixed pairwise tree per output."""
    dims = _dims(x, dim)
    rest = [d for d in range(x.ndim) if d not in dims]
    out_shape = [x.shape[d] for d in rest]
    y = x.permute(*rest, *dims).reshape(*out_shape, -1)
    n = y.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        y = torch.cat([y, y.new_zeros(*out_shape, width - n)], dim=-1)
    while y.shape[-1] > 1:
        half = y.shape[-1] // 2
        y = y[..., :half] + y[..., half:]
    y = y[..., 0]
    if keepdim:
        y = y.reshape([1 if d in dims else x.shape[d] for d in range(x.ndim)])
    return y


def ue_mean(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` as ``ue_sum`` over the count."""
    dims = _dims(x, dim)
    count = 1
    for d in dims:
        count *= x.shape[d]
    return ue_sum(x, dims, keepdim) / count
