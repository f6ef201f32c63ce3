"""KV/SSM-cache serving paths: prefill and single-token decode, per family
(port of ``repro.models.decode``).

Cache layouts, stacked over layers as the reference stacks them, each with
a 0-d int32 ``index`` on the cache's device:

  dense/moe/vlm  {"k","v"}: (L, B, S_max, KV, hd); an MoE model's leading
                 dense layers first (offset 0)
  ssm            {"conv": (L, B, K-1, C), "ssm": (L, B, H, P, N)}, O(1) in
                 sequence length
  hybrid         the ssm caches plus one shared-attention KV cache for each
                 of the G call sites of the shared block (G, B, S_max, KV, hd)
  enc_dec        the decoder's self K/V plus the cross K/V of the encoder's
                 output (L, B, S_enc, KV, hd); ``prefill`` replaces the cross
                 leaves with the frames' own length, as the reference does

``prefill`` consumes the prompt and returns the last position's logits only.
``decode_step`` inserts the new token's K/V into a new cache at ``index``
(out of place, as ``dynamic_update_slice``) and attends to
``kv_pos <= index``, within the window for a windowed config or a local
gemma2 layer; the SSM leaves are the recurrence's new states.  whisper's
decoder attends to every cached frame, and its self attention never
windows: the reference's decode body calls the attention with ``is_local``
left False, so a windowed copy of its config decodes the same bits.  The
cache it was given is left as it was.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.transformer import (
    _DENSE,
    _dense_block,
    _mamba_block_apply,
    _moe_block,
    dense_cfg,
    embed,
    enc_dec_cfg,
    encode,
    hybrid_groups,
    layer,
    local_layer,
    n_stacked,
    need_frames,
    sinusoid,
    unembed,
)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: torch.device | str = "cuda") -> dict[str, Any]:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    c: dict[str, Any] = {"index": torch.zeros((), dtype=torch.int32, device=device)}

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in (*_DENSE, Family.MOE, Family.ENC_DEC):
        c["k"] = zeros(cfg.n_layers, batch, max_seq, kv, hd)
        c["v"] = zeros(cfg.n_layers, batch, max_seq, kv, hd)
        if cfg.family is Family.ENC_DEC:
            c["cross_k"] = zeros(cfg.n_layers, batch, cfg.encoder_seq, kv, hd)
            c["cross_v"] = zeros(cfg.n_layers, batch, cfg.encoder_seq, kv, hd)
    else:
        s = cfg.ssm
        d_in = s.d_inner(cfg.d_model)
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        nh = s.n_heads(cfg.d_model)
        c["conv"] = zeros(cfg.n_layers, batch, s.d_conv - 1, conv_dim)
        c["ssm"] = zeros(cfg.n_layers, batch, nh, s.head_dim, s.d_state)
        if cfg.family is Family.HYBRID:
            g = cfg.n_layers // cfg.attn_every
            c["k"] = zeros(g, batch, max_seq, kv, hd)
            c["v"] = zeros(g, batch, max_seq, kv, hd)
    return c


def _positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    if cfg.mrope_sections is not None:
        return pos[None].expand(3, *pos.shape)
    return pos


def _pad_kv(cache: dict[str, Any], ks: list, vs: list) -> None:
    """Stack the prompt's K/V per layer, pad to the cache's length, cast."""
    pad = (0, 0, 0, 0, 0, max(cache["k"].shape[2] - ks[0].shape[1], 0))
    cache["k"] = F.pad(torch.stack(ks), pad).to(cache["k"].dtype)
    cache["v"] = F.pad(torch.stack(vs), pad).to(cache["v"].dtype)


def _put_states(cache: dict[str, Any], states: list) -> None:
    cache["conv"] = torch.stack([c.conv for c in states]).to(cache["conv"].dtype)
    cache["ssm"] = torch.stack([c.ssm for c in states]).to(cache["ssm"].dtype)


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, cache: dict[str, Any], *,
            encoder_frames: torch.Tensor | None = None) -> tuple[torch.Tensor, dict[str, Any]]:
    """Consume the prompt; returns (last-token logits (B, V), filled cache).
    The encoder-decoder family needs ``encoder_frames`` (B, S_enc, D)."""
    b, s = tokens.shape
    positions = _positions(cfg, torch.arange(s, device=tokens.device)[None].expand(b, s))
    x = embed(cfg, params, tokens)
    cache = dict(cache)
    blocks = params["blocks"]
    ks, vs, states = [], [], []
    if cfg.family in _DENSE:
        lg = cfg.local_global_pattern
        for i in range(n_stacked(blocks)):
            x, (k, v) = _dense_block(cfg, layer(blocks, i), x, positions=positions,
                                     is_local=local_layer(i) if lg else None)
            ks.append(k)
            vs.append(v)
    elif cfg.family is Family.MOE:
        if cfg.moe.first_k_dense:
            dcfg, dense = dense_cfg(cfg), params["dense_blocks"]
            for i in range(n_stacked(dense)):
                x, (k, v) = _dense_block(dcfg, layer(dense, i), x, positions=positions)
                ks.append(k)
                vs.append(v)
        for i in range(n_stacked(blocks)):
            x, (k, v), _aux = _moe_block(cfg, layer(blocks, i), x, positions=positions)
            ks.append(k)
            vs.append(v)
    elif cfg.family is Family.SSM:
        for i in range(n_stacked(blocks)):
            x, c = _mamba_block_apply(cfg, layer(blocks, i), x)
            states.append(c)
    elif cfg.family is Family.HYBRID:
        groups, tail = hybrid_groups(cfg)
        for group in groups:
            for i in group:
                x, c = _mamba_block_apply(cfg, layer(blocks, i), x)
                states.append(c)
            x, (k, v) = _dense_block(cfg, params["shared_attn"], x, positions=positions)
            ks.append(k)
            vs.append(v)
        for i in tail:
            x, c = _mamba_block_apply(cfg, layer(blocks, i), x)
            states.append(c)
    else:  # encoder-decoder: the cross K/V of the frames replace the cache's
        memory = encode(cfg, params, need_frames(encoder_frames))
        dcfg = enc_dec_cfg(cfg)
        x = x + sinusoid(s, cfg.d_model, x.dtype, x.device)[None]
        cks, cvs = [], []
        for i in range(n_stacked(blocks)):
            p = layer(blocks, i)
            x, (k, v) = _dense_block(dcfg, p, x, positions=positions, cross_memory=memory)
            ks.append(k)
            vs.append(v)
            cks.append(L.einsum("bsd,dhk->bshk", memory, p["cross_attn"]["wk"]))
            cvs.append(L.einsum("bsd,dhk->bshk", memory, p["cross_attn"]["wv"]))
        cache["cross_k"] = torch.stack(cks).to(cache["cross_k"].dtype)
        cache["cross_v"] = torch.stack(cvs).to(cache["cross_v"].dtype)
    if states:
        _put_states(cache, states)
    if ks:
        _pad_kv(cache, ks, vs)
    cache["index"] = torch.full((), s, dtype=torch.int32, device=tokens.device)
    logits = unembed(cfg, params, x[:, -1:])[:, 0]
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                cache: dict[str, Any]) -> tuple[torch.Tensor, dict[str, Any]]:
    """One new token per sequence. tokens (B, 1) -> (logits (B, V), new cache)."""
    b = tokens.shape[0]
    idx = cache["index"]
    positions = _positions(cfg, idx.reshape(1, 1).expand(b, 1).to(torch.int32))
    x = embed(cfg, params, tokens)
    blocks = params["blocks"]
    new_cache = dict(cache)
    ks, vs, states = [], [], []

    def attend(block_fn, bcfg, p, x, j, **kw):
        out = block_fn(bcfg, p, x, positions=positions,
                       kv_cache=(cache["k"][j], cache["v"][j]), cache_index=idx, **kw)
        ks.append(out[1][0])
        vs.append(out[1][1])
        return out[0]

    def recur(x, i):
        x, c = _mamba_block_apply(cfg, layer(blocks, i), x,
                                  cache=M.MambaCache(conv=cache["conv"][i],
                                                     ssm=cache["ssm"][i]))
        states.append(c)
        return x

    if cfg.family in _DENSE:
        lg = cfg.local_global_pattern
        for i in range(n_stacked(blocks)):
            x = attend(_dense_block, cfg, layer(blocks, i), x, i,
                       is_local=local_layer(i) if lg else None)
    elif cfg.family is Family.MOE:
        off = cfg.moe.first_k_dense
        if off:
            dcfg, dense = dense_cfg(cfg), params["dense_blocks"]
            for i in range(off):
                x = attend(_dense_block, dcfg, layer(dense, i), x, i)
        for i in range(n_stacked(blocks)):
            x = attend(_moe_block, cfg, layer(blocks, i), x, off + i)
    elif cfg.family is Family.SSM:
        for i in range(n_stacked(blocks)):
            x = recur(x, i)
    elif cfg.family is Family.HYBRID:
        groups, tail = hybrid_groups(cfg)
        for gi, group in enumerate(groups):
            for i in group:
                x = recur(x, i)
            x = attend(_dense_block, cfg, params["shared_attn"], x, gi)
        for i in tail:
            x = recur(x, i)
    else:  # encoder-decoder
        x = _decode_enc_dec(cfg, blocks, x, positions, cache, ks, vs)
    if states:
        _put_states(new_cache, states)
    if ks:
        new_cache["k"] = torch.stack(ks).to(cache["k"].dtype)
        new_cache["v"] = torch.stack(vs).to(cache["v"].dtype)
    new_cache["index"] = idx + 1
    logits = unembed(cfg, params, x)[:, 0]
    return logits, new_cache


def _decode_enc_dec(cfg: ModelConfig, blocks: dict, x: torch.Tensor, positions: torch.Tensor,
                    cache: dict[str, Any], ks: list, vs: list) -> torch.Tensor:
    """whisper's decoder for one token, as the reference's decode body: the
    position row ``sinusoid(S_max)[index]`` with the index clamped to
    ``S_max - 1`` (``dynamic_slice_in_dim`` clamps it), self attention over
    the cache (never windowed), cross attention with no mask over every
    cached frame, the MLP."""
    dcfg = enc_dec_cfg(cfg)
    idx = cache["index"]
    max_seq = cache["k"].shape[2]
    row = torch.clamp(idx, 0, max_seq - 1).reshape(1).to(torch.int64)
    x = x + sinusoid(max_seq, cfg.d_model, x.dtype, x.device).index_select(0, row)[None]
    for i in range(n_stacked(blocks)):
        p = layer(blocks, i)
        h = L.apply_norm(dcfg, x, p["norm_attn"])
        a, (k, v) = L.attention(dcfg, p["attn"], h, positions=positions,
                                kv_cache=(cache["k"][i], cache["v"][i]), cache_index=idx)
        ks.append(k)
        vs.append(v)
        x = x + a
        h = L.apply_norm(dcfg, x, p["norm_cross"])
        q = L.einsum("bsd,dhk->bshk", h, p["cross_attn"]["wq"])
        kh = L._expand_kv(cache["cross_k"][i], dcfg.n_heads)
        vh = L._expand_kv(cache["cross_v"][i], dcfg.n_heads)
        out = L.dot_attention(q, kh, vh, None)
        x = x + L.einsum("bshk,hkd->bsd", out.to(x.dtype), p["cross_attn"]["wo"])
        h = L.apply_norm(dcfg, x, p["norm_mlp"])
        x = x + L.mlp(dcfg, p["mlp"], h)
    return x
