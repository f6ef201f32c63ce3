"""Config: gemma2-9b [dense]

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000 —
local/global alternating attention (window 4096), attn softcap 50,
final-logit softcap 30, GeGLU, post-block norms, head_dim=256.
Source: arXiv:2408.00118 (hf tier)
"""

from repro_torch.models.config import Family, ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family=Family.DENSE,
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        d_ff=14336,
        vocab=256000,
        head_dim=256,
        attn_softcap=50.0,
        logit_softcap=30.0,
        sliding_window=4096,
        local_global_pattern=True,
        mlp_kind="geglu",
        post_block_norm=True,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    """Same family, tiny dims — CPU smoke tests (one fwd/train step)."""
    return ModelConfig(
        name="gemma2-9b-smoke",
        family=Family.DENSE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        attn_softcap=50.0,
        logit_softcap=30.0,
        sliding_window=8,
        local_global_pattern=True,
        mlp_kind="geglu",
        post_block_norm=True,
        tie_embeddings=True,
        dtype="float32",
        remat="none",
    )
