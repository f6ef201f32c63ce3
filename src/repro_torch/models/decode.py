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

``prefill`` consumes the prompt and returns the last position's logits only.
``decode_step`` inserts the new token's K/V into a new cache at ``index``
(out of place, as ``dynamic_update_slice``) and attends to
``kv_pos <= index``, within the window for a windowed config; the SSM
leaves are the recurrence's new states.  The cache it was given is left as
it was.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import mamba2 as M
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.transformer import (
    _DENSE,
    _dense_block,
    _mamba_block_apply,
    _moe_block,
    check_ported,
    dense_cfg,
    embed,
    hybrid_groups,
    layer,
    n_stacked,
    unembed,
)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: torch.device | str = "cuda") -> dict[str, Any]:
    check_ported(cfg)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    c: dict[str, Any] = {"index": torch.zeros((), dtype=torch.int32, device=device)}

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in (*_DENSE, Family.MOE):
        c["k"] = zeros(cfg.n_layers, batch, max_seq, kv, hd)
        c["v"] = zeros(cfg.n_layers, batch, max_seq, kv, hd)
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


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            cache: dict[str, Any]) -> tuple[torch.Tensor, dict[str, Any]]:
    """Consume the prompt; returns (last-token logits (B, V), filled cache)."""
    check_ported(cfg)
    b, s = tokens.shape
    positions = _positions(cfg, torch.arange(s, device=tokens.device)[None].expand(b, s))
    x = embed(cfg, params, tokens)
    cache = dict(cache)
    blocks = params["blocks"]
    ks, vs, states = [], [], []
    if cfg.family in _DENSE:
        for i in range(n_stacked(blocks)):
            x, (k, v) = _dense_block(cfg, layer(blocks, i), x, positions=positions)
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
    else:
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
    check_ported(cfg)
    b = tokens.shape[0]
    idx = cache["index"]
    positions = _positions(cfg, idx.reshape(1, 1).expand(b, 1).to(torch.int32))
    x = embed(cfg, params, tokens)
    blocks = params["blocks"]
    new_cache = dict(cache)
    ks, vs, states = [], [], []

    def attend(block_fn, bcfg, p, x, j):
        out = block_fn(bcfg, p, x, positions=positions,
                       kv_cache=(cache["k"][j], cache["v"][j]), cache_index=idx)
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
        for i in range(n_stacked(blocks)):
            x = attend(_dense_block, cfg, layer(blocks, i), x, i)
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
    else:
        groups, tail = hybrid_groups(cfg)
        for gi, group in enumerate(groups):
            for i in group:
                x = recur(x, i)
            x = attend(_dense_block, cfg, params["shared_attn"], x, gi)
        for i in tail:
            x = recur(x, i)
    if states:
        _put_states(new_cache, states)
    if ks:
        new_cache["k"] = torch.stack(ks).to(cache["k"].dtype)
        new_cache["v"] = torch.stack(vs).to(cache["v"].dtype)
    new_cache["index"] = idx + 1
    logits = unembed(cfg, params, x)[:, 0]
    return logits, new_cache
