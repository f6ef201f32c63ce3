from repro_torch.kernels.tree_infer.ops import (
    policy_step,
    policy_step_ref,
    tree_infer,
    tree_infer_ref,
)

__all__ = ["policy_step", "policy_step_ref", "tree_infer", "tree_infer_ref"]
