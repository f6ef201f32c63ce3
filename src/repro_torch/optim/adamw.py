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
    blocks = q8.q.to(torch.float32) * q8.scale
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


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

    def leaf_update(g, m, v, p):
        g = g.to(torch.float32)
        if config.quantize_moments:
            m_f = _dequantize(m, g.shape)
            v_f = v.to(torch.float32)  # v is stored bf16 (see the module docstring)
        else:
            m_f, v_f = m, v
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * g * g
        m_hat = m_f / bc1
        v_hat = v_f / bc2
        upd = m_hat / (torch.sqrt(v_hat) + config.eps)
        if config.weight_decay:
            upd = upd + config.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * upd).to(p.dtype)
        if config.quantize_moments:
            return new_p, _quantize(m_f), v_f.to(torch.bfloat16)
        return new_p, m_f, v_f

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
