from repro_torch.kernels.tree_infer.ops import tree_infer, tree_infer_ref

__all__ = ["tree_infer", "tree_infer_ref"]
