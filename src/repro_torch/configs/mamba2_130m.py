"""Config: mamba2-130m [ssm]

24L d_model=768 (attention-free) vocab=50280, ssm_state=128 — SSD
(state-space duality), tied embeddings.
Source: arXiv:2405.21060 (unverified tier)
"""

from repro_torch.models.config import Family, ModelConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family=Family.SSM,
        n_layers=24,
        d_model=768,
        n_heads=24,  # d_inner / head_dim
        n_kv_heads=24,
        d_ff=0,
        vocab=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1),
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    """Same family, tiny dims — CPU smoke tests (one fwd/train step)."""
    return ModelConfig(
        name="mamba2-130m-smoke",
        family=Family.SSM,
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=8,
        d_ff=0,
        vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, chunk=8),
        tie_embeddings=True,
        dtype="float32",
        remat="none",
    )
