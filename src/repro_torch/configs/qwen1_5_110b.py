"""Config: qwen1.5-110b [dense]

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064 — QKV bias.
Source: hf:Qwen/Qwen1.5-110B (hf tier)
"""

from repro_torch.models.config import Family, ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        family=Family.DENSE,
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=49152,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def reduced_config() -> ModelConfig:
    """Same family, tiny dims — CPU smoke tests (one fwd/train step)."""
    return ModelConfig(
        name="qwen1.5-110b-smoke",
        family=Family.DENSE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        qkv_bias=True,
        dtype="float32",
        remat="none",
    )
