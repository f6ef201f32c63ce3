"""Gradient compression with error feedback (port of ``repro.distributed.compression``).

Compressing gradients to int8 before the slowest all-reduce hop cuts its
bytes 2x against bf16 and 4x against float32; the quantisation error is fed
back into the next step's gradient, so the sum of applied updates is
unbiased (error feedback, Karimireddy et al.).  ``train_step`` runs the
round trip under ``TrainConfig.compress_grads``: quantise, dequantise, keep
the residual.

The arithmetic is the reference's, operation for operation: block-wise
absmax scales over 256-element blocks, a true division ``blocks / scale``
(not a product with a reciprocal), ``torch.round`` (half to even, as
``jnp.round``) and a clip to [-127, 127].  So the int8 payload, the scales,
the dequantised gradients and the residuals are the reference's bits.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import spans, tree_leaves, tree_map, tree_unflatten

_QBLOCK = 256  # divides UPDATE_CHUNK, so the spans hold whole blocks


class ErrorFeedbackState(NamedTuple):
    residual: Any  # tree of float32 residuals, the gradients' structure


def init_error_feedback(grads_template: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_template))


def _q8_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (int8 payload (blocks, 256), float32 scales (blocks, 1))."""
    flat = g.reshape(-1)
    blocks = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % _QBLOCK)).reshape(-1, _QBLOCK)
    # a 0-d tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the reference's division
    d127 = torch.full((), 127.0, dtype=torch.float32, device=g.device)
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=1, keepdim=True), min=1e-20) / d127
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8_leaf(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(shape)


def compress_decompress(grads: Any, ef: ErrorFeedbackState) -> tuple[Any, ErrorFeedbackState]:
    """int8 round trip with error feedback: the gradients as they would
    arrive after a compressed all-reduce, in their own dtypes, and the new
    float32 residuals."""

    def leaf(g, r):
        out = torch.empty(g.shape, dtype=g.dtype, device=g.device)
        res = torch.empty(g.shape, dtype=torch.float32, device=g.device)
        g_flat, r_flat = g.reshape(-1), r.reshape(-1)
        for lo, hi in spans(g.numel()):  # spans of whole blocks: one pass's bits
            g32 = g_flat[lo:hi].to(torch.float32) + r_flat[lo:hi]
            q, scale = _q8_leaf(g32)
            dq = _dq8_leaf(q, scale, g32.shape)
            out.view(-1)[lo:hi] = dq.to(g.dtype)
            res.view(-1)[lo:hi] = g32 - dq
        return out, res

    out = [leaf(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual),
                                      strict=True)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            ErrorFeedbackState(residual=tree_unflatten(grads, [o[1] for o in out])))
