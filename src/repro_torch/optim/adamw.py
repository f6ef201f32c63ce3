"""AdamW from scratch, with optional quantized moments (port of
``repro.optim.adamw``).

Parameters, gradients and moments are nested dicts, lists and tuples of
tensors (the AI expert's weight dict with its ``res`` list, the LM's param
tree).  The update math runs in float32 whatever the parameter dtype, and
the bias corrections are ``1 - b ** step`` on a float32 step, as the
reference computes them.  The moments are materialised independently, so
``m`` and ``v`` never share a tensor.

The quantized-moment path stores the first moment as block-wise absmax int8
(128-element blocks, one float32 scale a block) and the second as bfloat16:
block absmax int8 would collapse small-but-nonzero second moments to zero
wherever a block mixes magnitudes, and ``m_hat / (sqrt(0) + eps)`` then
diverges, while bf16 keeps float32's exponent range.  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the int8 payload is the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, NamedTuple

import torch

_QBLOCK = 128
#: the update runs over flat spans of at most this many elements of a leaf, a
#: multiple of every quantisation block (128 here, 256 in the gradient
#: compression): every operation is elementwise or within a block, so the
#: bits are those of one pass over the leaf, and the temporaries are one
#: span's (a stacked full-width leaf holds 604 M elements, 2.4 GB a float32
#: temporary)
UPDATE_CHUNK = 1 << 24


def spans(n: int) -> list[tuple[int, int]]:
    """``[lo, hi)`` spans of a flat leaf of ``n`` elements, ``UPDATE_CHUNK`` at a time."""
    return [(lo, min(n, lo + UPDATE_CHUNK)) for lo in range(0, n, UPDATE_CHUNK)]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 1e-3  # used when ``adamw_update`` gets no learning_rate
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    quantize_moments: bool = False  # int8 block-wise m, bf16 v


class _Q8(NamedTuple):
    q: torch.Tensor  # int8 payload, (blocks, 128)
    scale: torch.Tensor  # float32 per-block absmax scales, (blocks, 1)


def _quantize(x: torch.Tensor) -> _Q8:
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % _QBLOCK))
    blocks = flat.reshape(-1, _QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return _Q8(q=q, scale=scale.to(torch.float32))


def _dequantize(q8: _Q8, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return _dequantize_span(q8, 0, n).reshape(shape)


def _dequantize_span(q8: _Q8, lo: int, hi: int) -> torch.Tensor:
    """Flat elements ``[lo, hi)`` of a quantized leaf (``lo`` on a block edge)."""
    b0, b1 = lo // _QBLOCK, -(-hi // _QBLOCK)
    return (q8.q[b0:b1].to(torch.float32) * q8.scale[b0:b1]).reshape(-1)[: hi - lo]


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any  # tree of float32 tensors or _Q8
    v: Any  # tree of float32 (bf16 when quantized) tensors


def _leaves(like: Any, tree: Any) -> Iterator[Any]:
    """The nodes of ``tree`` at the leaves of ``like`` (a nested dict / list /
    tuple of tensors), in ``like``'s order; a ``tree`` node there may itself
    be a tuple (a quantized moment)."""
    if isinstance(like, dict):
        for k in like:
            yield from _leaves(like[k], tree[k])
    elif isinstance(like, (list, tuple)):
        for a, b in zip(like, tree, strict=True):
            yield from _leaves(a, b)
    else:
        yield tree


def _rebuild(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def tree_leaves(tree: Any) -> list[Any]:
    """The leaves of a nested dict / list / tuple of tensors, in order."""
    return list(_leaves(tree, tree))


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure holding ``leaves`` (in ``tree_leaves`` order)."""
    return _rebuild(like, iter(leaves))


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching nodes of ``rest``."""
    columns = [_leaves(tree, tree)] + [_leaves(tree, r) for r in rest]
    return _rebuild(tree, (fn(*xs) for xs in zip(*columns)))


def adamw_init(params: Any, config: AdamWConfig) -> AdamWState:
    def m_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize(z) if config.quantize_moments else z

    def v_like(p):
        dt = torch.bfloat16 if config.quantize_moments else torch.float32
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    first = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(m_like, params),
        v=tree_map(v_like, params),
    )


def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    config: AdamWConfig,
    *,
    learning_rate: torch.Tensor | float | None = None,
) -> tuple[Any, AdamWState]:
    """Returns ``(new_params, new_state)``.  Update math in float32 whatever
    the param dtype; a Python-float learning rate enters as float32, as the
    reference's jitted step takes it."""
    lr = config.learning_rate if learning_rate is None else learning_rate
    step = state.step + 1
    b1, b2 = config.b1, config.b2
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, step_f)
    bc2 = 1.0 - torch.pow(b2, step_f)

    def span_update(g, m_f, v_f, p):
        g = g.to(torch.float32)
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * g * g
        m_hat = m_f / bc1
        v_hat = v_f / bc2
        upd = m_hat / (torch.sqrt(v_hat) + config.eps)
        if config.weight_decay:
            upd = upd + config.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * upd).to(p.dtype), m_f, v_f

    def leaf_update(g, m, v, p):
        quant = config.quantize_moments
        new_p = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        new_v = torch.empty(p.shape, dtype=v.dtype, device=p.device)
        if quant:
            n_blocks = -(-p.numel() // _QBLOCK)
            new_m = _Q8(q=torch.empty((n_blocks, _QBLOCK), dtype=torch.int8, device=p.device),
                        scale=torch.empty((n_blocks, 1), dtype=torch.float32, device=p.device))
        else:
            new_m = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        g_flat, v_flat, p_flat = g.reshape(-1), v.reshape(-1), p.reshape(-1)
        for lo, hi in spans(p.numel()):
            if quant:  # v is stored bf16 (see the module docstring)
                m_f, v_f = _dequantize_span(m, lo, hi), v_flat[lo:hi].to(torch.float32)
            else:
                m_f, v_f = m.reshape(-1)[lo:hi], v_flat[lo:hi]
            p_new, m_f, v_f = span_update(g_flat[lo:hi], m_f, v_f, p_flat[lo:hi])
            new_p.view(-1)[lo:hi] = p_new
            new_v.view(-1)[lo:hi] = v_f
            if quant:
                q8 = _quantize(m_f)
                b0 = lo // _QBLOCK
                new_m.q[b0: b0 + q8.q.shape[0]] = q8.q
                new_m.scale[b0: b0 + q8.q.shape[0]] = q8.scale
            else:
                new_m.view(-1)[lo:hi] = m_f
        return new_p, new_m, new_v

    out = list(map(leaf_update, _leaves(grads, grads), _leaves(grads, state.m),
                   _leaves(grads, state.v), _leaves(grads, params)))
    new_p = _rebuild(grads, (o[0] for o in out))
    new_m = _rebuild(grads, (o[1] for o in out))
    new_v = _rebuild(grads, (o[2] for o in out))
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


def global_norm_clip(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / global_norm)``; returns the
    scaled tree and the float32 global norm."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    # a true division: ``float / tensor`` in PyTorch multiplies by a reciprocal
    num = torch.full((), max_norm, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp(num / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gnorm
