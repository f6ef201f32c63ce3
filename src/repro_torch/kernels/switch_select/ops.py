"""Per-UE expert switch: the wrapper of the hand-written kernel and its plain
PyTorch version.

``switch_select(modes, outputs)`` replaces the batched branch of
``repro.kernels.switch_select.ops.switch_select``: ``outputs`` lists one
tensor per expert, designated expert first, each with a leading UE axis;
UE ``u`` ends up holding expert ``modes[u]``'s output.

On a CUDA tensor the kernel (``csrc/switch_select.cu``) switches **in place
into the designated tensor** and returns it: mode-0 UEs cost nothing, the
others copy their alternative's slice.  The reference aliases the
designated buffer to the output too, but JAX keeps the pre-switch value
alive, so there ``outputs[0]`` still reads the unswitched designated
output afterwards; in the port ``outputs[0]`` *is* the switched buffer.
On a CPU tensor the plain version ``switch_select_batched_ref`` gathers
into a new tensor and leaves the inputs untouched.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build


def switch_select_batched_ref(modes: torch.Tensor,
                              outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: stack the experts and gather each UE's selection."""
    stacked = torch.stack(list(outputs), dim=0)  # (E, U, ...)
    idx = modes.to(torch.int64).reshape((1, -1) + (1,) * (stacked.ndim - 2))
    idx = idx.expand((1,) + tuple(stacked.shape[1:]))
    return torch.gather(stacked, 0, idx)[0]


def _float_view(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        if x.dtype != torch.complex64:
            raise TypeError(f"complex leaves must be complex64, got {x.dtype}")
        return torch.view_as_real(x)
    if x.dtype != torch.float32:
        raise TypeError(f"switch leaves must be float32/complex64, got {x.dtype}")
    return x


def _launch(modes: torch.Tensor, alt: torch.Tensor, designated: torch.Tensor,
            want: int) -> None:
    n_ues = designated.shape[0]
    per_ue = designated.numel() // max(n_ues, 1)
    lib = build.library("switch_select")
    fn = lib.switch_select_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(modes.data_ptr(), alt.data_ptr(), designated.data_ptr(), n_ues,
                   per_ue, want, build.stream_ptr(designated)), "switch_select")
    build.launch_counts["switch_select_batched"] += 1


def switch_select(modes: torch.Tensor, outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-UE zero-gap switch over a designated-first list of expert outputs."""
    designated, *alternatives = outputs
    if modes.ndim != 1 or modes.shape[0] != designated.shape[0]:
        raise ValueError(f"modes {tuple(modes.shape)} vs UE axis {designated.shape[0]}")
    for a in alternatives:
        if a.shape != designated.shape or a.dtype != designated.dtype:
            raise ValueError("expert outputs must share shape and dtype")
        if a.device != designated.device or modes.device != designated.device:
            raise ValueError("modes and expert outputs must share one device")
    if designated.device.type != "cuda":
        return switch_select_batched_ref(modes, outputs)
    if modes.dtype != torch.int32:
        raise TypeError(f"modes must be int32, got {modes.dtype}")
    des = _float_view(designated)
    if not (des.is_contiguous() and modes.is_contiguous()):
        raise ValueError("switch kernel needs contiguous designated buffer and modes")
    for k, a in enumerate(alternatives):
        alt = _float_view(a)
        if not alt.is_contiguous():
            raise ValueError("switch kernel needs contiguous alternatives")
        _launch(modes, alt, des, k + 1)
    return designated
