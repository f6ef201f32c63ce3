"""Config: command-r-plus-104b [dense]

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000 — GQA,
no-bias, Cohere parallel attention+FFN residual block.
Source: hf:CohereForAI/c4ai-command-r-v01 (unverified tier)
"""

from repro_torch.models.config import Family, ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family=Family.DENSE,
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab=256000,
        parallel_block=True,
        norm_kind="layernorm",
        rope_theta=75_000_000.0,
    )


def reduced_config() -> ModelConfig:
    """Same family, tiny dims — CPU smoke tests (one fwd/train step)."""
    return ModelConfig(
        name="command-r-plus-104b-smoke",
        family=Family.DENSE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        parallel_block=True,
        norm_kind="layernorm",
        dtype="float32",
        remat="none",
    )
