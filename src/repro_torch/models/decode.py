"""KV-cache serving paths: prefill and single-token decode (port of
``repro.models.decode``), dense family.

Cache layout, stacked over layers as the reference stacks it:
``{"k", "v"}: (L, B, S_max, KV, hd)`` plus a 0-d int32 ``index`` on the
cache's device.  ``prefill`` consumes the prompt and returns the last
position's logits only.  ``decode_step`` inserts the new token's K/V into a
new cache at ``index`` (out of place, as ``dynamic_update_slice``) and
attends to ``kv_pos <= index``, within the window for a windowed config;
the cache it was given is left as it was.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    _dense_block,
    check_ported,
    embed,
    layer,
    n_stacked,
    unembed,
)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: torch.device | str = "cuda") -> dict[str, Any]:
    check_ported(cfg)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_seq, kv, hd)
    return {"index": torch.zeros((), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    if cfg.mrope_sections is not None:
        return pos[None].expand(3, *pos.shape)
    return pos


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            cache: dict[str, Any]) -> tuple[torch.Tensor, dict[str, Any]]:
    """Consume the prompt; returns (last-token logits (B, V), filled cache)."""
    check_ported(cfg)
    b, s = tokens.shape
    positions = _positions(cfg, torch.arange(s, device=tokens.device)[None].expand(b, s))
    x = embed(cfg, params, tokens)
    cache = dict(cache)
    max_seq = cache["k"].shape[2]
    ks, vs = [], []
    blocks = params["blocks"]
    for i in range(n_stacked(blocks)):
        x, (k, v) = _dense_block(cfg, layer(blocks, i), x, positions=positions)
        ks.append(k)
        vs.append(v)
    pad = (0, 0, 0, 0, 0, max(max_seq - s, 0))
    cache["k"] = torch.nn.functional.pad(torch.stack(ks), pad).to(cache["k"].dtype)
    cache["v"] = torch.nn.functional.pad(torch.stack(vs), pad).to(cache["v"].dtype)
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
    ks, vs = [], []
    blocks = params["blocks"]
    for i in range(n_stacked(blocks)):
        x, (k, v) = _dense_block(cfg, layer(blocks, i), x, positions=positions,
                                 kv_cache=(cache["k"][i], cache["v"][i]), cache_index=idx)
        ks.append(k)
        vs.append(v)
    new_cache = dict(cache)
    new_cache["k"], new_cache["v"] = torch.stack(ks), torch.stack(vs)
    new_cache["index"] = idx + 1
    logits = unembed(cfg, params, x)[:, 0]
    return logits, new_cache
