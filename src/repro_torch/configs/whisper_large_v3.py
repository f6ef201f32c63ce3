"""Config: whisper-large-v3 [audio]

32L (x2: encoder + decoder) d_model=1280 20H (MHA) d_ff=5120
vocab=51866 — enc-dec; conv/mel frontend is a stub (input_specs provides
precomputed frame embeddings, 1500 frames).
Source: arXiv:2212.04356 (unverified tier)
"""

from repro_torch.models.config import Family, ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family=Family.ENC_DEC,
        n_layers=32,
        n_encoder_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51866,
        norm_kind="layernorm",
        mlp_kind="gelu",
        rope_theta=0.0,  # absolute sinusoidal positions
        encoder_seq=1500,
    )


def reduced_config() -> ModelConfig:
    """Same family, tiny dims — CPU smoke tests (one fwd/train step)."""
    return ModelConfig(
        name="whisper-large-v3-smoke",
        family=Family.ENC_DEC,
        n_layers=2,
        n_encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        norm_kind="layernorm",
        mlp_kind="gelu",
        rope_theta=0.0,
        encoder_seq=16,
        dtype="float32",
        remat="none",
    )
