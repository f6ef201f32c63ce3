"""Config: zamba2-7b [hybrid]

81L d_model=3584 32H (kv=32, MHA shared block) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + one shared attention+MLP
block invoked every 6 backbone layers (shared weights).
Source: arXiv:2411.15242 (unverified tier)
"""

from repro_torch.models.config import Family, ModelConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family=Family.HYBRID,
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab=32000,
        ssm=SSMConfig(d_state=64, head_dim=64, n_groups=2),
        attn_every=6,
    )


def reduced_config() -> ModelConfig:
    """Same family, tiny dims — CPU smoke tests (one fwd/train step)."""
    return ModelConfig(
        name="zamba2-7b-smoke",
        family=Family.HYBRID,
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=16, n_groups=2, chunk=8),
        attn_every=2,
        dtype="float32",
        remat="none",
    )
