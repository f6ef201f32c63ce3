"""Forward pass of the side LM stack (port of ``repro.models.transformer``).

One parameter-def tree and one set of apply functions, as the reference
has them, for every family: the dense family (command-r-plus's parallel
block, granite's MQA with a GELU MLP, qwen1.5's QKV bias, gemma2's
alternating local/global layers with softcaps and post-block norms), the
VLM backbone that shares its blocks (qwen2-vl, M-RoPE), the MoE family
(dbrx; kimi-k2 with its dense first layer and shared expert), the SSM
family (mamba2), the hybrid (zamba2: a mamba2 backbone and one shared
attention block applied after every ``attn_every`` layers) and the
encoder-decoder (whisper: an encoder over precomputed frame embeddings, the
stub frontend, and a decoder with cross attention).

The stacked layer params keep their leading layer axis, as the reference
stacks them for ``lax.scan``, so the weight converter is a direct map; the
scan becomes a loop over that axis.  gemma2's layer ``2i`` is local
(windowed) and ``2i + 1`` global, as the reference's scan over pairs runs
them.

Rematerialisation (``cfg.remat``) applies when gradients are on: each block
the reference scans (dense, MoE and mamba blocks, whisper's encoder and
decoder blocks, each of gemma2's two layers of a pair; not zamba2's shared
block, which the reference applies outside its scans) runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its scan
body in ``jax.checkpoint``.  ``"full"`` saves nothing and recomputes the
block in the backward pass; ``"block"`` saves the outputs of the products
without batch dimensions (the projections and the MLP, which
``torch.einsum`` runs as ``bmm`` with a batch of 1, or ``mm`` / ``addmm``)
and recomputes the rest, as ``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable`` does; ``"none"`` keeps every
activation.  The recompute runs the same operations on the same inputs, so
the loss and the gradients are the same bits under every setting (the
reference remats gemma2's pair as one body, which gives the same values).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.device import cached_const
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MoE
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.params import ParamDef, tree_map_defs

_DENSE = (Family.DENSE, Family.VLM)


# -- parameter definition tree ---------------------------------------------------


def _stack(defs: Any, n: int) -> Any:
    """Prefix every leaf with a stacked ``layers`` axis of length n."""
    return tree_map_defs(
        lambda d: ParamDef((n, *d.shape), ("layers", *d.axes), d.init, d.scale), defs)


def _dense_block_defs(cfg: ModelConfig, *, cross: bool = False) -> dict[str, Any]:
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
    if cross:  # whisper decoder
        d["cross_attn"] = L.attention_defs(cfg, cross=True)
        d["norm_cross"] = L.norm_defs(cfg.d_model)
    return d


def _moe_block_defs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "attn": L.attention_defs(cfg),
        "moe": MoE.moe_defs(cfg),
        "norm_attn": L.norm_defs(cfg.d_model),
        "norm_mlp": L.norm_defs(cfg.d_model),
    }


def _mamba_block_defs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "mixer": M.mamba_defs(cfg),
        "norm": L.norm_defs(cfg.d_model),
    }


def dense_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of an MoE model's leading dense layers (their FF width)."""
    return cfg.with_(d_ff=cfg.moe.d_ff_dense)


def make_defs(cfg: ModelConfig) -> dict[str, Any]:
    v, d = cfg.vocab, cfg.d_model
    defs: dict[str, Any] = {
        "embed": ParamDef((v, d), ("vocab", "embed"), init="small"),
        "final_norm": L.norm_defs(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"), init="small")
    if cfg.family in _DENSE:
        defs["blocks"] = _stack(_dense_block_defs(cfg), cfg.n_layers)
    elif cfg.family is Family.MOE:
        k = cfg.moe.first_k_dense
        if k:
            defs["dense_blocks"] = _stack(_dense_block_defs(dense_cfg(cfg)), k)
        defs["blocks"] = _stack(_moe_block_defs(cfg), cfg.n_layers - k)
    elif cfg.family is Family.ENC_DEC:
        defs["encoder"] = {
            "blocks": _stack(_dense_block_defs(cfg), cfg.n_encoder_layers),
            "final_norm": L.norm_defs(d),
        }
        defs["blocks"] = _stack(_dense_block_defs(cfg, cross=True), cfg.n_layers)
    else:  # SSM, or the hybrid's backbone and its one shared block
        defs["blocks"] = _stack(_mamba_block_defs(cfg), cfg.n_layers)
        if cfg.family is Family.HYBRID:
            defs["shared_attn"] = _dense_block_defs(cfg)
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
    cross_memory: torch.Tensor | None = None,
    causal: bool = True,
):
    """Pre-norm residual block covering every dense variant; whisper's decoder
    block adds non-causal cross attention over ``cross_memory`` after the
    self-attention residual."""
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
    if "cross_attn" in p:  # whisper decoder
        h = L.apply_norm(cfg, x, p["norm_cross"])
        c, _ = L.attention(cfg, p["cross_attn"], h, positions=positions,
                           cross_memory=cross_memory, causal=False)
        x = x + c
    h = L.apply_norm(cfg, x, p["norm_mlp"])
    m = L.mlp(cfg, p["mlp"], h)
    if cfg.post_block_norm:
        m = L.apply_norm(cfg, m, p["post_norm_mlp"])
    return x + m, cache_out


def _moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor, **kw):
    """Attention (never windowed: the reference calls it with ``is_local``
    left False) and the routed FFN; returns (x, K/V, aux loss)."""
    h = L.apply_norm(cfg, x, p["norm_attn"])
    a, cache_out = L.attention(cfg, p["attn"], h, **kw)
    x = x + a
    h = L.apply_norm(cfg, x, p["norm_mlp"])
    m, aux = MoE.moe_ffn(cfg, p["moe"], h)
    return x + m, cache_out, aux


def _mamba_block_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, cache=None):
    h = L.apply_norm(cfg, x, p["norm"])
    y, new_cache = M.mamba_block(cfg, p["mixer"], h, cache=cache)
    return x + y, new_cache


# -- embedding / head --------------------------------------------------------------


def embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = F.embedding(tokens.to(torch.int64), params["embed"])
    if cfg.family is Family.ENC_DEC or cfg.name.startswith("gemma"):
        # sqrt(d_model) rounded once to the activation dtype, as the reference's
        # ``jnp.asarray(np.sqrt(d), x.dtype)``; built once a device, so a decode
        # step makes no host-to-device copy (a synchronisation)
        x = x * cached_const(("embed_scale", cfg.d_model, x.dtype), x.device,
                             lambda: torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, x, params["final_norm"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.einsum("bsd,dv->bsv", x, w)
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# -- rematerialisation -----------------------------------------------------------------

_REMAT = ("none", "block", "full")
#: products without batch dimensions: ``torch.einsum`` runs a projection as a
#: ``bmm`` with a batch of 1, an attention product as a ``bmm`` over batch x heads
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dot_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _DOTS or (op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    return create_selective_checkpoint_contexts(_dot_policy)


def _needs_grad(x: torch.Tensor, blocks: Any) -> bool:
    """Whether autograd records this forward (remat matters only then)."""
    while isinstance(blocks, dict):
        blocks = next(iter(blocks.values()))
    return x.requires_grad or blocks.requires_grad


def _dense_out(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
               is_local: bool | None = None, cross_memory: torch.Tensor | None = None,
               causal: bool = True):
    return _dense_block(cfg, p, x, positions=positions, is_local=is_local,
                        cross_memory=cross_memory, causal=causal)[0]


def _moe_out(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    y, _, aux = _moe_block(cfg, p, x, positions=positions)
    return y, aux


def _mamba_out(cfg: ModelConfig, p: dict, x: torch.Tensor):
    return _mamba_block_apply(cfg, p, x)[0]


def _apply(remat: str, fn, *args):
    """One scanned block, ``fn(*args)``, under the remat setting."""
    if remat == "none":
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_save_dots if remat == "block" else noop_context_fn)


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


def sinusoid(n_pos: int, d: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``layers.sinusoidal_positions(n_pos, d)`` on ``device``, cast to
    ``dtype`` (the float32 table is built once per device)."""
    table = cached_const(("sinusoid", n_pos, d), device,
                         lambda: L.sinusoidal_positions(n_pos, d))
    return table.to(dtype)


def local_layer(i: int) -> bool:
    """gemma2: layer ``2i`` of the stack is local (windowed), ``2i + 1`` global."""
    return i % 2 == 0


def enc_dec_cfg(cfg: ModelConfig) -> ModelConfig:
    """whisper's encoder and decoder blocks: absolute sinusoidal positions, no RoPE."""
    return cfg.with_(rope_theta=0.0)


def _remat_of(cfg: ModelConfig, x: torch.Tensor, blocks: Any) -> str:
    remat = cfg.remat if torch.is_grad_enabled() and _needs_grad(x, blocks) else "none"
    if remat not in _REMAT:
        raise ValueError(f"remat {cfg.remat!r}: one of {_REMAT}")
    return remat


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """whisper's encoder over precomputed frame embeddings (the stub
    frontend): the sinusoidal table in the frames' dtype, the encoder blocks
    non-causal, then the encoder's final norm."""
    b, s, _ = frames.shape
    x = frames + sinusoid(s, cfg.d_model, frames.dtype, frames.device)[None]
    ecfg = enc_dec_cfg(cfg)
    positions = torch.arange(s, device=frames.device)[None].expand(b, s)
    blocks = params["encoder"]["blocks"]
    remat = _remat_of(cfg, x, blocks)
    for i in range(n_stacked(blocks)):
        x = _apply(remat, _dense_out, ecfg, layer(blocks, i), x, positions, None, None, False)
    return L.apply_norm(cfg, x, params["encoder"]["final_norm"])


def need_frames(encoder_frames: torch.Tensor | None) -> torch.Tensor:
    """The encoder-decoder family's frames; the reference asserts them, and
    this raises the same error type."""
    if encoder_frames is None:
        raise AssertionError("enc_dec needs encoder_frames")
    return encoder_frames


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    positions: torch.Tensor | None = None,
    encoder_frames: torch.Tensor | None = None,
) -> ForwardOut:
    """Full-sequence forward -> logits (B, S, V) + aux loss (the MoE layers'
    load-balancing losses summed; 0 for the other families).  The
    encoder-decoder family needs ``encoder_frames`` (B, S_enc, D); the
    others ignore them, as the reference does."""
    if positions is None:
        positions = _default_positions(cfg, tokens)
    x = embed(cfg, params, tokens)
    blocks = params["blocks"]
    remat = _remat_of(cfg, x, blocks)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in _DENSE:
        lg = cfg.local_global_pattern
        if lg and cfg.n_layers % 2:
            raise ValueError(f"local/global pairs need an even n_layers, not {cfg.n_layers}")
        for i in range(n_stacked(blocks)):
            x = _apply(remat, _dense_out, cfg, layer(blocks, i), x, positions,
                       local_layer(i) if lg else None)
    elif cfg.family is Family.MOE:
        if cfg.moe.first_k_dense:
            dcfg, dense = dense_cfg(cfg), params["dense_blocks"]
            for i in range(n_stacked(dense)):
                x = _apply(remat, _dense_out, dcfg, layer(dense, i), x, positions)
        auxes = []
        for i in range(n_stacked(blocks)):
            x, aux = _apply(remat, _moe_out, cfg, layer(blocks, i), x, positions)
            auxes.append(aux)
        aux_total = aux_total + torch.sum(torch.stack(auxes))
    elif cfg.family is Family.SSM:
        for i in range(n_stacked(blocks)):
            x = _apply(remat, _mamba_out, cfg, layer(blocks, i), x)
    elif cfg.family is Family.HYBRID:
        x = _forward_hybrid(cfg, params, x, positions, remat)
    else:  # encoder-decoder
        memory = encode(cfg, params, need_frames(encoder_frames))
        dcfg = enc_dec_cfg(cfg)
        x = x + sinusoid(tokens.shape[1], cfg.d_model, x.dtype, x.device)[None]
        for i in range(n_stacked(blocks)):
            x = _apply(remat, _dense_out, dcfg, layer(blocks, i), x, positions, None, memory)
    logits = unembed(cfg, params, x)
    return ForwardOut(logits=logits, aux_loss=aux_total)


def hybrid_groups(cfg: ModelConfig) -> tuple[list[range], range]:
    """zamba2's layer plan: ``G = n_layers // attn_every`` groups of mamba
    layers, the shared block after each, then the remaining layers as a
    tail (81 = 13 x 6 + 3 for zamba2-7b)."""
    k = cfg.attn_every
    n_groups = cfg.n_layers // k
    return ([range(g * k, (g + 1) * k) for g in range(n_groups)],
            range(n_groups * k, cfg.n_layers))


def _forward_hybrid(cfg, params, x, positions, remat):
    """zamba2: mamba backbone; one *shared* attention block every k layers."""
    blocks = params["blocks"]
    groups, tail = hybrid_groups(cfg)
    for group in groups:
        for i in group:
            x = _apply(remat, _mamba_out, cfg, layer(blocks, i), x)
        x, _ = _dense_block(cfg, params["shared_attn"], x, positions=positions)
    for i in tail:
        x = _apply(remat, _mamba_out, cfg, layer(blocks, i), x)
    return x
