"""Config: qwen2-vl-72b [vlm]

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE
(3-section rotary: temporal/height/width), dynamic-resolution vision
frontend is a stub (input_specs provides patch-merged token embeddings).
Source: arXiv:2409.12191 (hf tier)
"""

from repro_torch.models.config import Family, ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family=Family.VLM,
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab=152064,
        qkv_bias=True,
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
    )


def reduced_config() -> ModelConfig:
    """Same family, tiny dims — CPU smoke tests (one fwd/train step)."""
    return ModelConfig(
        name="qwen2-vl-72b-smoke",
        family=Family.VLM,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        qkv_bias=True,
        mrope_sections=(2, 3, 3),
        dtype="float32",
        remat="none",
    )
