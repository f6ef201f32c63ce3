from repro_torch.kernels.switch_select.ops import (
    switch_select,
    switch_select_batched_ref,
)

__all__ = ["switch_select", "switch_select_batched_ref"]
