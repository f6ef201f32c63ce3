"""Mixture-of-Experts FFN with top-k routing (port of ``repro.models.moe``):
dbrx (16 experts, top-4) and kimi-k2 (384 experts, top-8, one shared
expert, the first layer dense).

The reference's sort-based capacity dispatch, kept as it is: the token-slot
pairs are sorted stably by their expert, each expert keeps its first
``cap`` of them (``expert_capacity``, which depends on the token count
``n = B * S``: a prefill and a decode step each have their own), the kept
rows go into an ``(E, C, D)`` buffer and every projection is one batched
product over the expert axis.  The products read every expert's weights
whatever the batch.  Over-capacity pairs are dropped: their token keeps
only the other experts' share, the shared expert and the residual.

Each op has a form that is deterministic on the card under
``torch.use_deterministic_algorithms(True)`` and runs on ``meta`` tensors
(the planner's): the expert counts are a comparison of the assignment with
``arange(E)`` summed in int64 (``expert_counts``: integer sums, so
``bincount``'s bits; ``bincount`` has no meta kernel and syncs with the
host on the card), the two scatter-adds are ``index_add`` into a zero
buffer (every dropped pair lands on its expert's slot 0 with a zero
row, so those collisions add nothing), the gathers are ``index_select``
(whose backward is an ``index_add``), and the integer prefix sum of the
counts is an integer ``cumsum``.  ``torch.topk`` (sorted) and
``torch.sort(stable=True)`` stand for ``jax.lax.top_k`` and
``jnp.argsort(stable=True)``.

Sharded (the sharded step's DTensors), the block keeps the reference's
semantics, one global dispatch with one capacity over all ``N`` tokens,
and its ``constrain`` sites: the tokens are split on ``moe_tokens``, the
expert buffer on ``("experts", "moe_cap")``.  Each rank routes its own
tokens; the assignments (``N x K`` ids and weights) are gathered, so every
rank computes the same dispatch plan.  A rank fills its block of the
``(E, C, D)`` buffer (its experts on ``model``, its capacity slots on
``("pod", "data")``) from the gathered tokens, runs its experts, and
scatters its block's outputs into a partial ``(N, D)`` sum that the
``embed_act`` constraint reduces onto the token shards.
"""

from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import einsum
from repro_torch.models.params import ParamDef

DEFAULT_CAPACITY_FACTOR = 1.25


def moe_defs(cfg: ModelConfig) -> dict[str, Any]:
    m = cfg.moe
    d, e, ff = cfg.d_model, m.n_experts, m.d_ff_expert
    defs: dict[str, Any] = {
        "router": ParamDef((d, e), ("embed", "experts"), init="small"),
        "w_gate": ParamDef((e, d, ff), ("experts", "embed", "ff")),
        "w_up": ParamDef((e, d, ff), ("experts", "embed", "ff")),
        "w_down": ParamDef((e, ff, d), ("experts", "ff", "embed")),
    }
    if m.n_shared_experts:
        sff = m.d_ff_shared * m.n_shared_experts
        defs["shared_gate"] = ParamDef((d, sff), ("embed", "ff"))
        defs["shared_up"] = ParamDef((d, sff), ("embed", "ff"))
        defs["shared_down"] = ParamDef((sff, d), ("ff", "embed"))
    return defs


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    c = math.ceil(n_tokens * top_k * capacity_factor / n_experts)
    return max(8, -(-c // 8) * 8)  # sublane-align


class Routing(NamedTuple):
    probs: torch.Tensor  # (N, E) float32 router softmax
    topv: torch.Tensor  # (N, K) float32, renormalised over the K
    topi: torch.Tensor  # (N, K) int64 expert of each token-slot pair


class Dispatch(NamedTuple):
    """The token-slot pairs sorted by expert, and where each lands."""

    st: torch.Tensor  # (N*K,) int64 token of each sorted pair
    sw: torch.Tensor  # (N*K,) float32 its combine weight
    keep: torch.Tensor  # (N*K,) bool within its expert's capacity
    slot: torch.Tensor  # (N*K,) int64 row in the (E * cap, D) buffer
    cap: int


def expert_counts(topi: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Token-slot pairs given to each expert, ``(E,)`` int64, from the
    assignment ``topi``: ``bincount(topi.reshape(-1), minlength=E)``."""
    experts = torch.arange(n_experts, device=topi.device)
    return (topi.reshape(-1, 1) == experts).sum(0, dtype=torch.int64)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    v, i = torch.topk(probs, k, dim=-1, sorted=True)
    return v, i


def route(cfg: ModelConfig, p: dict, xf: torch.Tensor) -> Routing:
    """Router softmax and top-k of ``xf (N, D)``, as the reference routes."""
    logits = constrain(einsum("nd,de->ne", xf, p["router"]).to(torch.float32),
                       ("moe_tokens", None))
    probs = torch.softmax(logits, dim=-1)
    if S.is_dtensor(probs):  # each rank's tokens, every expert: a local top-k
        topv, topi = S.local(functools.partial(_top_k, k=cfg.moe.top_k), probs,
                             out=(probs.placements, probs.placements))
    else:
        topv, topi = _top_k(probs, cfg.moe.top_k)
    topv = topv / torch.clamp(torch.sum(topv, -1, keepdim=True), min=1e-9)
    return Routing(probs, topv, topi)


def dispatch(cfg: ModelConfig, r: Routing, *,
             capacity_factor: float = DEFAULT_CAPACITY_FACTOR) -> Dispatch:
    """The sort-based dispatch plan of a routing over ``N`` tokens."""
    n, k = r.topi.shape
    e = cfg.moe.n_experts
    dev = r.topi.device
    e_flat = r.topi.reshape(-1)  # (N*K,) row-major: token-major order
    tok = torch.arange(n, device=dev).repeat_interleave(k)
    w_flat = r.topv.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices
    se = e_flat.index_select(0, order)
    st = tok.index_select(0, order)
    sw = w_flat.index_select(0, order)
    counts = expert_counts(e_flat, e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n * k, device=dev) - starts.index_select(0, se)
    cap = expert_capacity(n, e, k, capacity_factor)
    keep = pos_in_e < cap
    slot = se * cap + torch.where(keep, pos_in_e, 0)
    return Dispatch(st=st, sw=sw, keep=keep, slot=slot, cap=cap)


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            capacity_factor: float = DEFAULT_CAPACITY_FACTOR
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed FFN. x (B, S, D) -> (y, aux_loss).

    Over-capacity tokens are dropped (they receive only the shared-expert /
    residual path), as the reference drops them.
    """
    if S.is_dtensor(x):
        return _moe_ffn_sharded(cfg, p, x, capacity_factor)
    m = cfg.moe
    b, s, d = x.shape
    n, k, e = b * s, m.top_k, m.n_experts
    xf = x.reshape(n, d)
    r = route(cfg, p, xf)

    # Switch-style load-balancing auxiliary loss; a 0-d divisor keeps the
    # division a true one on every device, as the reference's
    counts = expert_counts(r.topi, e).to(torch.float32)
    onehot_frac = counts / torch.full((), n * k, dtype=torch.float32, device=x.device)
    frac_probs = torch.mean(r.probs, dim=0)
    aux = e * torch.sum(onehot_frac * frac_probs) * m.aux_loss_coef

    # ---- sort-based dispatch ----
    dp = dispatch(cfg, r, capacity_factor=capacity_factor)
    kept = dp.keep[:, None]
    xg = xf.index_select(0, dp.st) * kept.to(x.dtype)  # (N*K, D)
    xe = torch.zeros((e * dp.cap, d), dtype=x.dtype, device=x.device).index_add(
        0, dp.slot, torch.where(kept, xg, torch.zeros((), dtype=x.dtype, device=x.device)))
    xe = xe.reshape(e, dp.cap, d)

    # ---- expert FFNs (batched over the expert axis) ----
    g = einsum("ecd,edf->ecf", xe, p["w_gate"])
    u = einsum("ecd,edf->ecf", xe, p["w_up"])
    h = F.silu(g) * u
    ye = einsum("ecf,efd->ecd", h, p["w_down"])

    # ---- combine ----
    yg = ye.reshape(e * dp.cap, d).index_select(0, dp.slot) * (
        dp.sw * dp.keep).to(x.dtype)[:, None]
    y = torch.zeros((n, d), dtype=x.dtype, device=x.device).index_add(
        0, dp.st, yg.to(x.dtype))

    if m.n_shared_experts:
        sg = F.silu(einsum("nd,df->nf", xf, p["shared_gate"]))
        su = einsum("nd,df->nf", xf, p["shared_up"])
        y = y + einsum("nf,fd->nd", sg * su, p["shared_down"])

    return y.reshape(b, s, d), aux


def _shared(cfg: ModelConfig, p: dict, xf: torch.Tensor) -> torch.Tensor:
    sg = F.silu(einsum("nd,df->nf", xf, p["shared_gate"]))
    su = einsum("nd,df->nf", xf, p["shared_up"])
    return einsum("nf,fd->nd", sg * su, p["shared_down"])


def _fill_block(xf_all: torch.Tensor, tok: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """A rank's block of the expert buffer: the token of each of its slots
    (``tok (E_l, C_l)``), zero where a slot holds no pair."""
    rows = xf_all.index_select(0, tok.reshape(-1)).reshape(*tok.shape, xf_all.shape[-1])
    return rows * valid[..., None].to(rows.dtype)


def _combine_block(ye: torch.Tensor, w: torch.Tensor, tok: torch.Tensor, n: int) -> torch.Tensor:
    """A rank's part of the combine: its slots' outputs, weighted, added into
    an ``(N, D)`` buffer at their tokens."""
    d = ye.shape[-1]
    yg = ye.reshape(-1, d) * w.reshape(-1, 1).to(ye.dtype)
    return torch.zeros((n, d), dtype=ye.dtype, device=ye.device).index_add(0, tok.reshape(-1), yg)


def _moe_ffn_sharded(cfg: ModelConfig, p: dict, x, capacity_factor: float):
    """``moe_ffn`` on DTensors (see the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate

    m = cfg.moe
    b, s, d = x.shape
    n, k, e = b * s, m.top_k, m.n_experts
    xf = constrain(x.reshape(n, d), ("moe_tokens", "embed_act"))
    r = route(cfg, p, xf)
    full = tuple(Replicate() for _ in x.placements)
    topi = S.replicated(r.topi).to_local()
    # each rank's combine uses its slots' weights: their gradient is a partial sum
    topv = S.replicated(r.topv).to_local(grad_placements=tuple(Partial() for _ in full))

    counts = S.place(expert_counts(topi, e).to(torch.float32), (None,), like=x)
    onehot_frac = counts / torch.full((), n * k, dtype=torch.float32, device=topi.device)
    frac_probs = S.replicated(torch.mean(r.probs, dim=0))
    aux = e * torch.sum(onehot_frac * frac_probs) * m.aux_loss_coef

    dp = dispatch(cfg, Routing(None, topv, topi), capacity_factor=capacity_factor)
    cap = dp.cap
    # the sorted pair of slot (expert, c) is starts[expert] + c, a pair when c < counts
    counts_i = expert_counts(topi, e)
    starts = torch.cumsum(counts_i, 0) - counts_i
    pl, ((e0, el), (c0, cl), _) = S.block((e, cap, d), ("experts", "moe_cap", "embed_act"), like=x)
    c_idx = torch.arange(c0, c0 + cl, device=topi.device)
    pair = starts[e0:e0 + el, None] + c_idx[None, :]
    valid = c_idx[None, :] < torch.clamp(counts_i[e0:e0 + el, None], max=cap)
    pair = torch.clamp(pair, max=n * k - 1)
    tok = torch.where(valid, dp.st.index_select(0, pair.reshape(-1)).reshape(el, cl), 0)
    w = torch.where(valid, dp.sw.index_select(0, pair.reshape(-1)).reshape(el, cl), 0.0)

    xf_all = S.replicated(xf)
    xe = S.local(functools.partial(_fill_block, tok=tok, valid=valid), xf_all, out=pl)
    xe = constrain(xe, ("experts", "moe_cap", "embed_act"))
    g = einsum("ecd,edf->ecf", xe, p["w_gate"])
    u = einsum("ecd,edf->ecf", xe, p["w_up"])
    h = constrain(F.silu(g) * u, ("experts", "moe_cap", "ff"))
    ye = constrain(einsum("ecf,efd->ecd", h, p["w_down"]), ("experts", "moe_cap", "embed_act"))

    partial = tuple(Partial() for _ in full)
    y = S.local(functools.partial(_combine_block, w=w, tok=tok, n=n), ye, out=partial)
    y = constrain(y, ("moe_tokens", "embed_act"))
    if m.n_shared_experts:
        y = y + constrain(_shared(cfg, p, xf), ("moe_tokens", "embed_act"))
    return constrain(y.reshape(b, s, d), ("batch", "seq", "embed_act")), aux
