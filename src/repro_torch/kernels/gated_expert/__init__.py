from repro_torch.kernels.gated_expert.ops import (
    ai_expert_dense,
    gated_expert_apply,
    gated_expert_apply_ref,
)

__all__ = ["ai_expert_dense", "gated_expert_apply", "gated_expert_apply_ref"]
