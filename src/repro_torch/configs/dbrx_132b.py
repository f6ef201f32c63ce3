"""Config: dbrx-132b [moe]

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352 —
MoE 16 experts top-4, fine-grained.
Source: hf:databricks/dbrx-base (unverified tier)
"""

from repro_torch.models.config import Family, ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family=Family.MOE,
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
        rope_theta=500_000.0,
    )


def reduced_config() -> ModelConfig:
    """Same family, tiny dims — CPU smoke tests (one fwd/train step)."""
    return ModelConfig(
        name="dbrx-132b-smoke",
        family=Family.MOE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
        dtype="float32",
        remat="none",
    )
