"""Transformer building blocks (port of ``repro.models.layers``): norms,
RoPE / M-RoPE, GQA attention (bias / softcap / sliding-window / cross),
SwiGLU / GeGLU / GELU MLPs.

Every function is pure over tensors; parameters come in as dict leaves
defined by the matching ``*_defs`` function (see ``params.py``).  Attention
is written as the reference writes it, einsums, the mask and a float32
softmax, not through ``scaled_dot_product_attention``, so the CPU tests
compare like with like.  The reference's ``constrain`` sites are kept: on
a plain tensor ``constrain`` is the identity, and in the sharded step it
redistributes the DTensor to the site's placements.  There the attention
itself (RoPE, the cache insert, the KV expansion, the mask and the
softmax) runs on each rank's shard of batch and heads (``local``).

Einsums promote mixed operands to a common dtype as ``jnp.einsum`` does (a
bf16 query against a float32 KV cache computes in float32).  The KV cache
is updated out of place, as ``dynamic_update_slice`` updates it: an expert
that decodes from a cache never changes the cache it was given.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import cached_const
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted to one dtype, as
    ``jnp.einsum`` promotes them."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


# -- norms ---------------------------------------------------------------------


def norm_defs(d: int) -> ParamDef:
    return ParamDef((d,), ("embed_act",), init="zeros")  # rmsnorm: w = 1 + p


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(torch.float32))).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * (1.0 + w.to(torch.float32))).to(dt)


def rmsnorm_bf16(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Mixed-precision RMSNorm: only the variance reduction runs in float32;
    the stream stays bf16."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + w.to(x.dtype))


def apply_norm(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if cfg.norms_bf16 and x.dtype == torch.bfloat16:
        return rmsnorm_bf16(x, w)
    return rmsnorm(x, w) if cfg.norm_kind == "rmsnorm" else layernorm(x, w)


# -- rotary embeddings -----------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, head_dim, 2, np.float64) / head_dim)


def _freqs(d: int, theta: float, device) -> torch.Tensor:
    return cached_const(("rope_freqs", d, float(theta)), device,
                        lambda: rope_freqs(d, theta).astype(np.float32))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) -> rotated x."""
    freqs = _freqs(x.shape[-1], theta, x.device)  # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, d/2)
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple[int, int, int],
                *, theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions (3, B, S) = (t, h, w) ids; the head_dim/2
    frequency bands are split into ``sections`` (t, h, w) groups, each
    rotated by its own position stream."""
    d = x.shape[-1]
    freqs = _freqs(d, theta, x.device)
    sec = np.asarray(sections)
    if sec.sum() != d // 2:
        raise ValueError(f"mrope sections {sections} do not cover head_dim {d}")
    band_src = cached_const(("mrope_bands", tuple(sections)), x.device,
                            lambda: np.repeat(np.arange(3), sec))  # (d/2,)
    pos = positions.to(torch.float32)  # (3, B, S)
    pos_per_band = pos.index_select(0, band_src)  # (d/2, B, S)
    angles = torch.movedim(pos_per_band, 0, -1) * freqs  # (B, S, d/2)
    return _rotate(x, angles)


def sinusoidal_positions(n_pos: int, d: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal embeddings (n_pos, d)."""
    inv = 1.0 / 10000 ** (np.arange(0, d, 2) / d)
    pos = np.arange(n_pos)[:, None] * inv[None, :]
    out = np.zeros((n_pos, d), np.float32)
    out[:, 0::2] = np.sin(pos)
    out[:, 1::2] = np.cos(pos)
    return out


# -- attention -------------------------------------------------------------------


def attention_defs(cfg: ModelConfig, *, cross: bool = False) -> dict[str, Any]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    defs: dict[str, Any] = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        defs["bq"] = ParamDef((h, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = ParamDef((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return defs


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, kv_x: torch.Tensor):
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", kv_x, p["wk"])
    v = einsum("bsd,dhk->bshk", kv_x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = constrain(q, ("batch", "seq", "heads", "head_dim"))
    k = constrain(k, ("batch", "kv_seq", "kv_heads", "head_dim"))
    v = constrain(v, ("batch", "kv_seq", "kv_heads", "head_dim"))
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int, rep: int, q_off: int = 0,
               kv_off: int = 0) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D) by repeating each KV head ``rep`` times.
    On a shard: ``n_heads`` query heads from global head ``q_off`` on, over
    the KV heads from ``kv_off`` on."""
    if n_heads == k.shape[2] * rep and q_off == kv_off * rep:
        return torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    heads = (torch.arange(n_heads, device=k.device) + q_off) // rep - kv_off
    return k.index_select(2, heads)


def _softcap(scores: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, 0.0, -1e30).to(torch.float32)


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None, *, softcap: float | None = None,
                  scores_bf16: bool = False) -> torch.Tensor:
    """Direct attention. q (B,Sq,H,D), k/v (B,Sk,H,D), mask (B|1,1,Sq,Sk).

    ``scores_bf16``: keep the (B,H,Sq,Sk) score and weight tensors in the
    query's dtype with float32 row sums only (the reference's mixed-precision
    preset); otherwise the scores and the softmax are float32.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    if scores_bf16:
        scores = einsum("bqhd,bkhd->bhqk", q, k) * torch.tensor(scale, dtype=q.dtype,
                                                                 device=q.device)
        scores = _softcap(scores, softcap)
        if mask is not None:
            scores = scores + _mask_bias(mask).to(scores.dtype)
        m = torch.amax(scores, dim=-1, keepdim=True).detach()
        e = torch.exp(scores - m)
        denom = torch.sum(e, dim=-1, keepdim=True, dtype=torch.float32)
        w = (e / denom.to(e.dtype)).to(v.dtype)
        return einsum("bhqk,bkhd->bqhd", w, v)
    scores = einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    scores = _softcap(scores, softcap)
    if mask is not None:
        scores = scores + _mask_bias(mask)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return einsum("bhqk,bkhd->bqhd", w, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                      window: int | None = None, softcap: float | None = None,
                      q_offset: int = 0, kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style online-softmax attention, a loop over KV chunks: the peak
    score buffer is (B, H, Sq, kv_chunk) instead of (B, H, Sq, Sk)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sk % kv_chunk:
        kv_chunk = math.gcd(sk, kv_chunk) or sk
    n_chunks = sk // kv_chunk
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    q32 = (q.to(torch.float32) * scale).transpose(1, 2)  # (B,H,Sq,D)
    kc = k.reshape(b, n_chunks, kv_chunk, h, d).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, n_chunks, kv_chunk, h, d).permute(1, 0, 3, 2, 4)
    q_pos = q_offset + torch.arange(sq, device=dev)

    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kc[idx].to(torch.float32))
        s = _softcap(s, softcap)
        kv_pos = idx * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = torch.ones((sq, kv_chunk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        if window is not None:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        s = s + _mask_bias(mask)[None, None]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    vc[idx].to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _insert(cache: torch.Tensor, new: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``dynamic_update_slice(cache, new, (0, index, 0, 0))``, out of place:
    ``new (B, Sq, ...)`` lands at positions ``[start, start + Sq)`` of a
    fresh copy of ``cache (B, S_max, ...)``, with ``start`` clamped so the
    update fits, as XLA clamps it; the index never leaves the device."""
    s_max, sq = cache.shape[1], new.shape[1]
    start = torch.clamp(index, 0, s_max - sq)
    rel = torch.arange(s_max, device=cache.device) - start
    sel = ((rel >= 0) & (rel < sq)).reshape((1, s_max) + (1,) * (cache.ndim - 2))
    spread = new.to(cache.dtype).index_select(1, torch.clamp(rel, 0, sq - 1))
    return torch.where(sel, spread, cache)


def attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    is_local: bool = False,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_index: torch.Tensor | None = None,
    cross_memory: torch.Tensor | None = None,
    causal: bool = True,
    use_chunked: bool | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """GQA attention covering every variant the configs use.

    Modes:
      * training / prefill: full-sequence self-attention (chunked past 2,048
        query positions); returns the fresh K/V for seeding the cache.
      * decode: ``kv_cache=(K, V)`` of shape (B, S_max, KV, D) plus a 0-d
        ``cache_index``; the new token's K/V goes into a new cache at that
        index and attention runs over it.
      * cross: ``cross_memory`` (B, S_enc, D) provides K/V.
    """
    kv_src = cross_memory if cross_memory is not None else x
    q, k, v = _project_qkv(cfg, p, x, kv_src)
    if use_chunked is None:
        use_chunked = x.shape[1] > 2048 and kv_cache is None
    ck, cv = kv_cache if kv_cache is not None else (None, None)
    core = functools.partial(_attend, cfg, is_local=is_local, cross=cross_memory is not None,
                             causal=causal, use_chunked=use_chunked,
                             q_off=S.shard_offset(q, 2), kv_off=S.shard_offset(k, 2))
    if S.is_dtensor(q):
        pos_axes = ("batch", "seq") if positions.ndim == 2 else (None, "batch", "seq")
        positions = constrain(S.place(positions, pos_axes, like=q), pos_axes)
        kv_pl = ck.placements if ck is not None else k.placements
        out, k, v = S.local(core, q, k, v, positions, ck, cv, cache_index,
                            out=(q.placements, kv_pl, kv_pl))
    else:
        out, k, v = core(q, k, v, positions, ck, cv, cache_index)

    out = constrain(out, ("batch", "seq", "heads", "head_dim"))
    y = einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    y = constrain(y, ("batch", "seq", "embed_act"))
    return y, (k, v)


def _cross_cached(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, *, rep: int,
                  q_off: int = 0, kv_off: int = 0) -> torch.Tensor:
    kh = _expand_kv(ck, q.shape[2], rep, q_off, kv_off)
    vh = _expand_kv(cv, q.shape[2], rep, q_off, kv_off)
    return dot_attention(q, kh, vh, None)


def cross_attention_cached(cfg: ModelConfig, p: dict, h: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor) -> torch.Tensor:
    """whisper's decode-time cross attention over the cached cross K/V
    (B, S_enc, KV, D): no mask, no RoPE.  Sharded, each rank attends with
    its shard of batch and heads."""
    q = constrain(einsum("bsd,dhk->bshk", h, p["wq"]), ("batch", "seq", "heads", "head_dim"))
    core = functools.partial(_cross_cached, rep=cfg.n_heads // cfg.n_kv_heads,
                             q_off=S.shard_offset(q, 2), kv_off=S.shard_offset(ck, 2))
    out = S.local(core, q, ck, cv, out=q.placements) if S.is_dtensor(q) else core(q, ck, cv)
    out = constrain(out, ("batch", "seq", "heads", "head_dim"))
    return constrain(einsum("bshk,hkd->bsd", out.to(h.dtype), p["wo"]),
                     ("batch", "seq", "embed_act"))


def _attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            positions: torch.Tensor, ck: torch.Tensor | None, cv: torch.Tensor | None,
            cache_index: torch.Tensor | None, *, is_local: bool, cross: bool, causal: bool,
            use_chunked: bool, q_off: int = 0, kv_off: int = 0):
    """The attention of ``attention`` after the projections, on whole
    tensors or on one rank's shard of batch and heads (query heads from
    global head ``q_off``, KV heads from ``kv_off``): RoPE, the cache insert
    at ``cache_index`` (decode), the KV expansion, the mask and the softmax.
    Returns (out, K, V): the K/V the layer hands back, the new cache's in
    decode and the fresh, rotated ones otherwise."""
    sq = q.shape[1]
    if not cross:
        if cfg.mrope_sections is not None:
            q = apply_mrope(q, positions, cfg.mrope_sections, theta=cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.mrope_sections, theta=cfg.rope_theta)
        elif cfg.rope_theta > 0:
            pos2 = positions if positions.ndim == 2 else positions[None]
            q = apply_rope(q, pos2, theta=cfg.rope_theta)
            k = apply_rope(k, pos2, theta=cfg.rope_theta)

    if ck is not None:  # decode: insert at cache_index
        k, v = _insert(ck, k, cache_index), _insert(cv, v, cache_index)

    rep = cfg.n_heads // cfg.n_kv_heads
    kh = _expand_kv(k, q.shape[2], rep, q_off, kv_off)
    vh = _expand_kv(v, q.shape[2], rep, q_off, kv_off)

    # alternating local/global layers window only the local ones
    window = cfg.sliding_window if (cfg.sliding_window is not None and is_local) else None

    sk = kh.shape[1]
    if use_chunked:
        out = chunked_attention(q, kh, vh, causal=causal and not cross,
                                window=window, softcap=cfg.attn_softcap)
    else:
        dev = q.device
        if cross:
            mask = None  # full encoder-decoder cross attention
        elif ck is not None:  # decode over the cache
            kv_pos = torch.arange(sk, device=dev)
            valid = kv_pos[None, :] <= cache_index  # (1, Sk)
            if cfg.sliding_window is not None and is_local:
                valid = valid & (cache_index - kv_pos[None, :] < cfg.sliding_window)
            mask = valid[None, None].expand(1, 1, sq, sk)
        else:  # training / short prefill, direct path
            m = torch.ones((sq, sk), dtype=torch.bool, device=dev)
            if causal:
                m = torch.tril(m, diagonal=sk - sq)
            if cfg.sliding_window is not None and is_local:
                qp = torch.arange(sq, device=dev)[:, None] + (sk - sq)
                m = m & (qp - torch.arange(sk, device=dev)[None, :] < cfg.sliding_window)
            mask = m[None, None]
        out = dot_attention(q, kh, vh, mask, softcap=cfg.attn_softcap,
                            scores_bf16=cfg.attn_scores_bf16)
    return out, k, v


# -- MLPs ------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict[str, Any]:
    d = cfg.d_model
    ff = cfg.d_ff if d_ff is None else d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamDef((d, ff), ("embed", "ff")),
            "w_up": ParamDef((d, ff), ("embed", "ff")),
            "w_down": ParamDef((ff, d), ("ff", "embed")),
        }
    return {
        "w_up": ParamDef((d, ff), ("embed", "ff")),
        "w_down": ParamDef((ff, d), ("ff", "embed")),
    }


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind in ("swiglu", "geglu"):
        gate = einsum("bsd,df->bsf", x, p["w_gate"])
        g = F.silu(gate) if cfg.mlp_kind == "swiglu" else F.gelu(gate, approximate="tanh")
        u = einsum("bsd,df->bsf", x, p["w_up"])
        h = constrain(g * u, ("batch", "seq", "ff"))
    else:
        h = F.gelu(einsum("bsd,df->bsf", x, p["w_up"]), approximate="tanh")
        h = constrain(h, ("batch", "seq", "ff"))
    return constrain(einsum("bsf,fd->bsd", h, p["w_down"]), ("batch", "seq", "embed_act"))
