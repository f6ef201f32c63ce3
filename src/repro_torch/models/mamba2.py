"""Mamba2 mixer via SSD, state-space duality (port of ``repro.models.mamba2``;
arXiv:2405.21060).

Used standalone (mamba2-130m) and as the backbone of the zamba2-7b hybrid.

Train/prefill path: the chunked dual form.  The sequence is split into
chunks of Q tokens; within a chunk the interactions are a masked
(attention-like) product, across chunks they flow through a state carried
from one chunk to the next.  The reference scans the chunks with
``lax.scan``; here it is a loop over the ``S / Q`` chunks, and each step
holds the reference's peak intermediate, ``(B, Q, Q, H)``.

Decode path: the recurrence, one token a step, carrying the
``(conv_state, ssm_state)`` caches, the SSM analogue of a KV cache, O(1) in
the sequence length.

Layer structure follows the official Mamba2 block:
  in_proj -> [z | x | B | C | dt] ; causal conv1d on [x|B|C] ; SSD ;
  gated RMSNorm (norm(y * silu(z))) ; out_proj.

Every cast of the reference is kept: the block returns its SSM and conv
states in the activations' dtype, so with bf16 weights the state is rounded
to bf16 every step whatever the dtype of the cache that holds it.

Sharded (the sharded step's DTensors), the projections are sharded as the
rules place them, and the mixer between them runs on each rank's batch
shard: the fused ``[z | x | B | C | dt]`` projection is gathered over
``model`` (its parts do not split evenly there), the conv, the SSD scan and
the gated norm run whole on the rank's rows, and ``out_proj``'s partial
sums are reduced at the reference's ``embed_act`` constraint.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import einsum
from repro_torch.models.params import ParamDef


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, conv_dim)
    ssm: torch.Tensor  # (B, H, P, N)


def mamba_defs(cfg: ModelConfig) -> dict[str, Any]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nh = s.n_heads(d)
    g, n = s.n_groups, s.d_state
    conv_dim = d_in + 2 * g * n
    proj_out = 2 * d_in + 2 * g * n + nh  # z, x, B, C, dt
    return {
        "in_proj": ParamDef((d, proj_out), ("embed", "ssm_inner")),
        "conv_w": ParamDef((s.d_conv, conv_dim), ("conv", "ssm_inner")),
        "conv_b": ParamDef((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamDef((nh,), ("ssm_heads",), init="zeros"),  # A = -exp(a)
        "dt_bias": ParamDef((nh,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef((nh,), ("ssm_heads",), init="ones"),
        "norm_w": ParamDef((d_in,), ("ssm_inner",), init="zeros"),
        "out_proj": ParamDef((d_in, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    g, n = s.n_groups, s.d_state
    nh = s.n_heads(cfg.d_model)
    z, x, b, c, dt = torch.split(zxbcdt, [d_in, d_in, g * n, g * n, nh], dim=-1)
    return z, x, b, c, dt  # dt (..., nh)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: ``F.softplus`` turns into the
    identity above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    yf = y.to(torch.float32)
    yf = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
    return (yf * (1.0 + w.to(torch.float32))).to(y.dtype)


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B, S, C), w (K, C) -> (B, S, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    segs = [xp[:, i:i + x.shape[1], :] * w[i] for i in range(k)]
    return F.silu(sum(segs) + b)


def _cumsum_chunk(da: torch.Tensor) -> torch.Tensor:
    """The in-chunk prefix sum of ``da (B, Q, H)`` along Q, as a product with a
    lower-triangular ones mask in float32 (TF32 off, ``resolve_device``):
    ``torch.cumsum`` of a floating tensor, and its backward, have no
    deterministic form on the card.  The same form runs on every device; its
    order of summation differs from XLA's ``cumsum``, within float32
    rounding."""
    q = da.shape[1]
    tri = torch.tril(torch.ones((q, q), dtype=torch.float32, device=da.device))
    return torch.einsum("qj,bjh->bqh", tri, da.to(torch.float32))


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)   softplus'd step sizes
    a: torch.Tensor,  # (H,)        negative decay rates
    bmat: torch.Tensor,  # (B, S, G, N)
    cmat: torch.Tensor,  # (B, S, G, N)
    *,
    chunk: int,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD dual form, a loop over chunks. Returns (y, final_state).

    State shape (B, H, P, N).  G groups broadcast over H heads (G divides H),
    each group to ``H / G`` consecutive heads.
    """
    bsz, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD chunk {chunk}")
    nc = s // chunk
    rep = h // g

    # expand groups to heads
    bh = torch.repeat_interleave(bmat, rep, dim=2)  # (B, S, H, N)
    ch = torch.repeat_interleave(cmat, rep, dim=2)

    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    h_prev = (init_state.to(torch.float32) if init_state is not None
              else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        x_i, dt_i, b_i, c_i = x[:, sl], dt[:, sl], bh[:, sl], ch[:, sl]
        b32, c32, x32 = (t.to(torch.float32) for t in (b_i, c_i, x_i))
        da = dt_i * a[None, None, :]  # (B,Q,H)
        cum = _cumsum_chunk(da)

        # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j
        li = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Q,Q,H)
        decay = torch.where(mask[None, :, :, None], torch.exp(li), zero)
        scores = torch.einsum("bqhn,bkhn->bqkh", c32, b32)
        w = scores * decay * dt_i[:, None, :, :]  # weight by dt_j
        y_intra = torch.einsum("bqkh,bkhp->bqhp", w, x32)

        # inter-chunk: y_q += C_q exp(cum_q) h_prev
        y_inter = torch.einsum("bqhn,bhpn->bqhp", c32 * torch.exp(cum)[..., None], h_prev)

        # state update: h_new = exp(sum da) h_prev + sum_j exp(last-cum_j) dt_j B_j x_j
        last = cum[:, -1:, :]
        w_state = torch.exp(last - cum) * dt_i  # (B,Q,H)
        chunk_state = torch.einsum("bqh,bqhn,bqhp->bhpn", w_state, b32, x32)
        h_prev = (h_prev * torch.exp(torch.sum(da, dim=1))[:, :, None, None]
                  + chunk_state)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h_prev


def _last_positions(conv_in: torch.Tensor, keep: int) -> torch.Tensor:
    """The conv state a prompt leaves: its last ``keep`` positions, left-padded
    with zeros when the prompt is shorter."""
    s = conv_in.shape[1]
    if s >= keep:
        return conv_in[:, s - keep:]
    return F.pad(conv_in, (0, 0, keep - s, 0))


def mamba_block(
    cfg: ModelConfig,
    p: dict,
    u: torch.Tensor,
    *,
    cache: MambaCache | None = None,
) -> tuple[torch.Tensor, MambaCache]:
    """One Mamba2 mixer. u (B, S, D) -> (y (B, S, D), new cache).

    With ``cache`` set, S must be 1 (decode recurrence).
    """
    zxbcdt = einsum("bsd,dk->bsk", u, p["in_proj"])
    small = {k: p[k] for k in ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm_w")}
    if S.is_dtensor(u):
        zxbcdt = constrain(zxbcdt, ("batch", "seq", None))
        small = {k: S.replicated(v) for k, v in small.items()}
        conv = ssm = None
        if cache is not None:
            conv = constrain(cache.conv, ("batch", "conv", None))
            ssm = constrain(cache.ssm, ("batch", None, None, None))
        bsz, s_len = u.shape[:2]
        s_cfg = cfg.ssm
        nh = s_cfg.n_heads(cfg.d_model)
        conv_dim = s_cfg.d_inner(cfg.d_model) + 2 * s_cfg.n_groups * s_cfg.d_state
        conv_pl, _ = S.block((bsz, s_cfg.d_conv - 1, conv_dim), ("batch", "conv", None), like=u)
        ssm_pl, _ = S.block((bsz, nh, s_cfg.head_dim, s_cfg.d_state),
                            ("batch", None, None, None), like=u)
        keys = list(small)

        def mixer(zxbcdt, *rest):
            return _mixer(cfg, zxbcdt, dict(zip(keys, rest)), *rest[len(keys):],
                          u_dtype=u.dtype)

        y, new_conv, new_ssm = S.local(mixer, zxbcdt, *small.values(), conv, ssm,
                                       out=(u.placements, conv_pl, ssm_pl))
    else:
        conv, ssm = (cache.conv, cache.ssm) if cache is not None else (None, None)
        y, new_conv, new_ssm = _mixer(cfg, zxbcdt, small, conv, ssm, u_dtype=u.dtype)
    out = einsum("bsk,kd->bsd", y, p["out_proj"])
    return constrain(out, ("batch", "seq", "embed_act")), MambaCache(conv=new_conv, ssm=new_ssm)


def _mixer(cfg: ModelConfig, zxbcdt: torch.Tensor, p: dict, conv_cache: torch.Tensor | None,
           ssm_cache: torch.Tensor | None, *, u_dtype: torch.dtype):
    """The mixer between the projections, on whole tensors or on one rank's
    batch shard: the causal conv (or its one-step roll with a cache), the
    SSD scan (or the recurrence), the skip and the gated norm.  Returns
    (y (B, S, d_inner), new conv state, new SSM state)."""
    s_cfg = cfg.ssm
    bsz, s, _ = zxbcdt.shape
    d_in = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.n_heads(cfg.d_model)
    g, n, pdim = s_cfg.n_groups, s_cfg.d_state, s_cfg.head_dim
    f32 = torch.float32

    z, x, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([x, bmat, cmat], dim=-1)  # (B,S,conv_dim)
    a = -torch.exp(p["a_log"].to(f32))  # (H,)

    if conv_cache is None:
        conv_out = _conv1d_causal(conv_in, p["conv_w"], p["conv_b"])
        x, bmat, cmat = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)
        xh = x.reshape(bsz, s, nh, pdim)
        dtp = _softplus(dt.to(f32) + p["dt_bias"])
        y, final = ssd_chunked(xh, dtp, a, bmat.reshape(bsz, s, g, n),
                               cmat.reshape(bsz, s, g, n), chunk=min(s_cfg.chunk, s))
        y = y + xh.to(f32) * p["d_skip"][None, None, :, None]
        new_conv = _last_positions(conv_in, s_cfg.d_conv - 1).to(u_dtype)
        new_ssm = final.to(u_dtype)
    else:
        # decode: roll conv state, apply conv taps, single recurrence step
        conv_state = torch.cat([conv_cache, conv_in], dim=1)  # (B,K,C), promoted
        conv_out = einsum("bkc,kc->bc", conv_state, p["conv_w"]) + p["conv_b"]
        conv_out = F.silu(conv_out)[:, None, :]  # (B,1,C)
        x, bmat, cmat = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)
        xh = x.reshape(bsz, nh, pdim)
        bm = torch.repeat_interleave(bmat.reshape(bsz, g, n), nh // g, dim=1)
        cm = torch.repeat_interleave(cmat.reshape(bsz, g, n), nh // g, dim=1)
        dtp = _softplus(dt[:, 0].to(f32) + p["dt_bias"])  # (B,H)
        decay = torch.exp(dtp * a[None, :])  # (B,H)
        ssm = ssm_cache.to(f32)
        upd = torch.einsum("bh,bhn,bhp->bhpn", dtp, bm.to(f32), xh.to(f32))
        ssm_new = ssm * decay[:, :, None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", ssm_new, cm.to(f32))
        y = y + xh.to(f32) * p["d_skip"][None, :, None]
        y = y[:, None]  # (B,1,H,P)
        new_conv = conv_state[:, 1:].to(u_dtype)
        new_ssm = ssm_new.to(u_dtype)
    y = y.reshape(bsz, s, d_in).to(u_dtype)
    return _gated_norm(y, z, p["norm_w"]), new_conv, new_ssm


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device: torch.device | str = "cuda") -> MambaCache:
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return MambaCache(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
        ssm=torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=dtype, device=device),
    )
