"""Decision-tree inference: the wrapper of the hand-written kernel and its
plain PyTorch version.

``tree_infer(x, feature, threshold, leaf_values, depth)`` replaces
``repro.kernels.tree_infer.ops.tree_infer``.  It takes the level-order
tables directly (children of node ``n`` are ``2n+1``/``2n+2``; go right if
``x[feature] > threshold``), so there is no ``pack_tree`` step.  On a CUDA
tensor it launches ``csrc/tree_infer.cu`` (or raises); on a CPU tensor it
runs ``tree_infer_ref``, the literal walk the reference uses as its oracle.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def tree_infer_ref(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
                   leaf_values: torch.Tensor, depth: int) -> torch.Tensor:
    """Plain version: descend the complete binary tree for each row of ``x``."""
    idx = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    feature = feature.to(torch.int64)
    for _ in range(depth):
        f = feature[idx]
        go_right = torch.gather(x, 1, f[:, None])[:, 0] > threshold[idx]
        idx = 2 * idx + 1 + go_right.to(torch.int64)
    return leaf_values[idx - (2**depth - 1)]


def tree_infer(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
               leaf_values: torch.Tensor, depth: int) -> torch.Tensor:
    """Evaluate the tree on ``x (B, F)`` float32 -> float32 predictions ``(B,)``."""
    n_nodes = 2**depth - 1
    if x.ndim != 2:
        raise ValueError(f"x must be (B, F), got {tuple(x.shape)}")
    if feature.shape != (n_nodes,) or threshold.shape != (n_nodes,):
        raise ValueError(f"depth {depth} needs {n_nodes} internal nodes")
    if leaf_values.shape != (2**depth,):
        raise ValueError(f"depth {depth} needs {2**depth} leaves")
    if x.device.type != "cuda":
        return tree_infer_ref(x, feature, threshold, leaf_values, depth)
    for t, dt in ((x, torch.float32), (feature, torch.int32),
                  (threshold, torch.float32), (leaf_values, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("tree_infer kernel needs contiguous float32 x/threshold/"
                             "leaves and int32 feature on one device")
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    fn = build.function("tree_infer", "tree_infer_launch",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    build.check(fn(x.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
                   leaf_values.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                   depth, build.stream(x)), "tree_infer")
    build.launch_counts["tree_infer"] += 1
    return out
