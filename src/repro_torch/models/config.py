"""Unified model configuration of the side LM stack (port of
``repro.models.config``).

One dataclass describes every family (dense / MoE / SSM / hybrid / enc-dec /
VLM backbone), with the reference's exact parameter counts; per-arch
constructor modules live in ``repro_torch.configs.<id>`` and the registry
here maps ``--arch <id>`` to them.  The port carries the three uniform dense
configs so far (``PORTED_ARCHS``); ``get_config`` names the queue that holds
the others.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import torch


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    ENC_DEC = "enc_dec"
    VLM = "vlm"


class Attention(str, enum.Enum):
    GLOBAL = "global"
    LOCAL = "local"  # sliding window


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    first_k_dense: int = 0  # leading dense layers (kimi/deepseek style)
    d_ff_dense: int = 0  # their FF width
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads

    # attention variants
    qkv_bias: bool = False  # qwen1.5
    attn_softcap: float | None = None  # gemma2 (50.0)
    logit_softcap: float | None = None  # gemma2 (30.0)
    sliding_window: int | None = None  # gemma2 local layers (4096)
    local_global_pattern: bool = False  # gemma2 alternating
    parallel_block: bool = False  # command-r (attn + mlp in parallel)
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl (t,h,w)
    rope_theta: float = 10000.0

    # MLP
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    post_block_norm: bool = False  # gemma2 extra norms
    tie_embeddings: bool = False

    # family extras
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int = 0  # hybrid: shared attn block every k ssm layers
    n_encoder_layers: int = 0  # enc-dec
    encoder_seq: int = 1500  # whisper frame count (stub frontend)

    # numerics / training
    dtype: str = "bfloat16"
    remat: str = "block"  # none | block | full
    scan_layers: bool = True  # False unrolls (dry-run cost calibration)
    attn_scores_bf16: bool = False  # mixed-precision softmax (perf preset)
    norms_bf16: bool = False  # mixed-precision norms (perf preset)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family is Family.SSM

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell."""
        return self.family in (Family.SSM, Family.HYBRID)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_dtype(self):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    # -- parameter counts (exact, used for 6ND roofline maths) --------------

    def attn_params(self) -> int:
        hd = self.resolved_head_dim
        q = self.d_model * self.n_heads * hd
        kv = 2 * self.d_model * self.n_kv_heads * hd
        o = self.n_heads * hd * self.d_model
        bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def mlp_params(self, d_ff: int | None = None) -> int:
        ff = self.d_ff if d_ff is None else d_ff
        n_mats = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        return n_mats * self.d_model * ff

    def ssm_params(self) -> int:
        assert self.ssm is not None
        s = self.ssm
        d_in = s.d_inner(self.d_model)
        nh = s.n_heads(self.d_model)
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        in_proj = self.d_model * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
        conv = conv_dim * s.d_conv
        out_proj = d_in * self.d_model
        extras = nh * 2 + d_in  # A_log, D, norm
        return in_proj + conv + out_proj + extras

    def params_per_layer(self) -> int:
        """Decoder-side params for one layer (norms excluded, negligible)."""
        if self.family is Family.SSM:
            return self.ssm_params()
        if self.family is Family.HYBRID:
            return self.ssm_params()  # shared attn counted once in n_params
        if self.family is Family.MOE:
            m = self.moe
            per_expert = self.mlp_params(m.d_ff_expert)
            shared = m.n_shared_experts * self.mlp_params(m.d_ff_shared)
            router = self.d_model * m.n_experts
            return self.attn_params() + m.n_experts * per_expert + shared + router
        return self.attn_params() + self.mlp_params()

    def n_params(self) -> int:
        core = self.n_layers * self.params_per_layer()
        if self.family is Family.MOE and self.moe.first_k_dense:
            dense = self.attn_params() + self.mlp_params(self.moe.d_ff_dense)
            core += self.moe.first_k_dense * (dense - self.params_per_layer())
        if self.family is Family.HYBRID and self.attn_every:
            core += self.attn_params() + self.mlp_params()  # one shared block
        if self.family is Family.ENC_DEC:
            enc = self.n_encoder_layers * (self.attn_params() + self.mlp_params())
            dec_cross = self.n_layers * self.attn_params()  # cross-attn
            core += enc + dec_cross
        emb = self.vocab * self.d_model
        return core + emb * (1 if self.tie_embeddings else 2)

    def n_active_params(self) -> int:
        """Per-token active params (MoE: only routed experts count)."""
        if self.family is not Family.MOE:
            return self.n_params()
        m = self.moe
        active_layer = (
            self.attn_params()
            + m.top_k * self.mlp_params(m.d_ff_expert)
            + m.n_shared_experts * self.mlp_params(m.d_ff_shared)
            + self.d_model * m.n_experts
        )
        core = self.n_layers * active_layer
        if m.first_k_dense:
            dense = self.attn_params() + self.mlp_params(m.d_ff_dense)
            core += m.first_k_dense * (dense - active_layer)
        emb = self.vocab * self.d_model
        return core + emb * (1 if self.tie_embeddings else 2)


# -- input-shape cells ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCell("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524288, 1, "decode")

ALL_SHAPES: tuple[ShapeCell, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(config: ModelConfig) -> tuple[ShapeCell, ...]:
    """The assigned shape set for an arch (long_500k only if sub-quadratic)."""
    if config.subquadratic:
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)


# -- registry ------------------------------------------------------------------

ARCH_IDS: tuple[str, ...] = (
    "command-r-plus-104b",
    "granite-20b",
    "qwen1.5-110b",
    "gemma2-9b",
    "zamba2-7b",
    "mamba2-130m",
    "whisper-large-v3",
    "dbrx-132b",
    "kimi-k2-1t-a32b",
    "qwen2-vl-72b",
)


#: the configs ported so far: the uniform dense family
PORTED_ARCHS: tuple[str, ...] = ("granite-20b", "command-r-plus-104b", "qwen1.5-110b")


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    """Load ``repro_torch.configs.<arch>`` and return its (full or smoke) config."""
    import importlib

    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; one of {ARCH_IDS}")
    if arch not in PORTED_ARCHS:
        raise NotImplementedError(
            f"{arch} is not ported yet: its family and config wait in ROADMAP.md "
            f"Queue 1, item 7 (the LM stack's training half); ported: {PORTED_ARCHS}")
    mod_name = "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(mod_name)
    return mod.reduced_config() if reduced else mod.full_config()
