"""Config: kimi-k2-1t-a32b [moe]

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840 —
MoE 384 experts top-8 + 1 shared expert, first layer dense (DeepSeek-V3
style) — trillion-param scale, 32B active.
Source: arXiv:2501.kimi2 paper table (unverified tier)
"""

from repro_torch.models.config import Family, ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family=Family.MOE,
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,
        vocab=163840,
        moe=MoEConfig(
            n_experts=384,
            top_k=8,
            d_ff_expert=2048,
            n_shared_experts=1,
            d_ff_shared=2048,
            first_k_dense=1,
            d_ff_dense=18432,
        ),
        rope_theta=50_000.0,
    )


def reduced_config() -> ModelConfig:
    """Same family, tiny dims — CPU smoke tests (one fwd/train step)."""
    return ModelConfig(
        name="kimi-k2-1t-a32b-smoke",
        family=Family.MOE,
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab=256,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_ff_expert=64,
            n_shared_experts=1,
            d_ff_shared=64,
            first_k_dense=1,
            d_ff_dense=128,
        ),
        dtype="float32",
        remat="none",
    )
