from repro_torch.kernels.switch_select.ops import (
    switch_gather_batched_leaf,
    switch_gather_batched_ref,
    switch_gather_batched_tree_ref,
    switch_scatter,
    switch_select,
    switch_select_batched_leaf,
    switch_select_batched_ref,
    switch_select_batched_tree_ref,
    switch_select_leaf,
    switch_select_ref,
    switch_select_tree_ref,
)

__all__ = ["switch_gather_batched_leaf", "switch_gather_batched_ref",
           "switch_gather_batched_tree_ref", "switch_scatter", "switch_select",
           "switch_select_batched_leaf", "switch_select_batched_ref",
           "switch_select_batched_tree_ref", "switch_select_leaf", "switch_select_ref",
           "switch_select_tree_ref"]
