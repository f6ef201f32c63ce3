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
``jnp.argsort(stable=True)``.  The GSPMD ``constrain`` hints of the
reference do nothing on one card and are left out.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

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


def route(cfg: ModelConfig, p: dict, xf: torch.Tensor) -> Routing:
    """Router softmax and top-k of ``xf (N, D)``, as the reference routes."""
    logits = einsum("nd,de->ne", xf, p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, cfg.moe.top_k, dim=-1, sorted=True)
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
