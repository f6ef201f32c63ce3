"""Config: granite-20b [dense]

52L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152 —
llama-style code model.
Source: arXiv:2405.04324; hf (hf tier)
"""

from repro_torch.models.config import Family, ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family=Family.DENSE,
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        mlp_kind="gelu",  # 2-matrix MLP: hits the 20B name (SwiGLU would be 28B)
    )


def reduced_config() -> ModelConfig:
    """Same family, tiny dims — CPU smoke tests (one fwd/train step)."""
    return ModelConfig(
        name="granite-20b-smoke",
        family=Family.DENSE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab=256,
        mlp_kind="gelu",
        dtype="float32",
        remat="none",
    )
