"""Forward pass of the side LM stack (port of ``repro.models.transformer``),
dense family.

One parameter-def tree and one set of apply functions, as the reference
has them.  The port carries the dense family (command-r-plus's parallel
block, granite's MQA with a GELU MLP, qwen1.5's QKV bias) and the VLM
backbone that shares its blocks; the MoE, SSM, hybrid, encoder-decoder and
local/global (gemma2) paths raise ``NotImplementedError`` and wait in
``ROADMAP.md`` Queue 1.

The stacked layer params keep their leading layer axis, as the reference
stacks them for ``lax.scan``, so the weight converter is a direct map; the
scan becomes a loop over that axis.  Rematerialisation (``cfg.remat``)
trades memory for recompute in training and means nothing here.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.params import ParamDef, tree_map_defs

_DENSE = (Family.DENSE, Family.VLM)


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it waits in ROADMAP.md Queue 1, item 7 (the LM "
        f"stack's MoE, SSM, hybrid, encoder-decoder and local/global paths)")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a family or layer pattern the port does not carry yet."""
    if cfg.family not in _DENSE:
        raise unported(f"the {cfg.family.value} family ({cfg.name})")
    if cfg.local_global_pattern:
        raise unported(f"the local/global layer pattern ({cfg.name})")


# -- parameter definition tree ---------------------------------------------------


def _stack(defs: Any, n: int) -> Any:
    """Prefix every leaf with a stacked ``layers`` axis of length n."""
    return tree_map_defs(
        lambda d: ParamDef((n, *d.shape), ("layers", *d.axes), d.init, d.scale), defs)


def _dense_block_defs(cfg: ModelConfig) -> dict[str, Any]:
    d = {
        "attn": L.attention_defs(cfg),
        "mlp": L.mlp_defs(cfg),
        "norm_attn": L.norm_defs(cfg.d_model),
        "norm_mlp": L.norm_defs(cfg.d_model),
    }
    if cfg.post_block_norm:  # gemma2
        d["post_norm_attn"] = L.norm_defs(cfg.d_model)
        d["post_norm_mlp"] = L.norm_defs(cfg.d_model)
    if cfg.parallel_block:  # command-r: one shared input norm
        d.pop("norm_mlp")
    return d


def make_defs(cfg: ModelConfig) -> dict[str, Any]:
    check_ported(cfg)
    v, d = cfg.vocab, cfg.d_model
    defs: dict[str, Any] = {
        "embed": ParamDef((v, d), ("vocab", "embed"), init="small"),
        "final_norm": L.norm_defs(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"), init="small")
    defs["blocks"] = _stack(_dense_block_defs(cfg), cfg.n_layers)
    return defs


def layer(stacked: Any, i: int) -> Any:
    """Layer ``i``'s params out of a stacked tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def n_stacked(stacked: Any) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


# -- block bodies -----------------------------------------------------------------


def _dense_block(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    is_local: bool | None = None,
    kv_cache=None,
    cache_index=None,
    causal: bool = True,
):
    """Pre-norm residual block covering every dense variant."""
    if is_local is None:
        # uniform-window configs (no local/global alternation) window everywhere
        is_local = cfg.sliding_window is not None and not cfg.local_global_pattern
    if cfg.parallel_block:  # command-r: x + attn(n(x)) + mlp(n(x))
        h = L.apply_norm(cfg, x, p["norm_attn"])
        a, cache_out = L.attention(cfg, p["attn"], h, positions=positions, is_local=is_local,
                                   kv_cache=kv_cache, cache_index=cache_index, causal=causal)
        m = L.mlp(cfg, p["mlp"], h)
        return x + a + m, cache_out

    h = L.apply_norm(cfg, x, p["norm_attn"])
    a, cache_out = L.attention(cfg, p["attn"], h, positions=positions, is_local=is_local,
                               kv_cache=kv_cache, cache_index=cache_index, causal=causal)
    if cfg.post_block_norm:
        a = L.apply_norm(cfg, a, p["post_norm_attn"])
    x = x + a
    h = L.apply_norm(cfg, x, p["norm_mlp"])
    m = L.mlp(cfg, p["mlp"], h)
    if cfg.post_block_norm:
        m = L.apply_norm(cfg, m, p["post_norm_mlp"])
    return x + m, cache_out


# -- embedding / head --------------------------------------------------------------


def embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = F.embedding(tokens.to(torch.int64), params["embed"])
    if cfg.family is Family.ENC_DEC or cfg.name.startswith("gemma"):
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, x, params["final_norm"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.einsum("bsd,dv->bsv", x, w)
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# -- full forward (train / eval) ----------------------------------------------------


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor


def _default_positions(cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    if cfg.mrope_sections is not None:
        return pos[None].expand(3, b, s)  # text-only: t=h=w
    return pos


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    positions: torch.Tensor | None = None,
    encoder_frames: torch.Tensor | None = None,
) -> ForwardOut:
    """Full-sequence forward -> logits (B, S, V) + aux loss (0 for the dense
    family)."""
    check_ported(cfg)
    if encoder_frames is not None:
        raise unported("the encoder-decoder path")
    if positions is None:
        positions = _default_positions(cfg, tokens)
    x = embed(cfg, params, tokens)
    blocks = params["blocks"]
    for i in range(n_stacked(blocks)):
        x, _ = _dense_block(cfg, layer(blocks, i), x, positions=positions)
    logits = unembed(cfg, params, x)
    return ForwardOut(logits=logits,
                      aux_loss=torch.zeros((), dtype=torch.float32, device=x.device))
