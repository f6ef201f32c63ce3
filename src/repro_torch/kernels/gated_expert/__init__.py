from repro_torch.kernels.gated_expert.ops import gated_expert_apply, gated_expert_apply_ref

__all__ = ["gated_expert_apply", "gated_expert_apply_ref"]
