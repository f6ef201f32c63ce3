"""MMSE/Wiener interpolation: the wrapper of the hand-written kernel and its
plain PyTorch version.

``mmse_interp(h_pilot, w)`` replaces ``repro.kernels.mmse_interp.ops.mmse_interp``:
complex ``(..., Np)`` pilot estimates times the complex ``(Np, Nsc)`` Wiener
matrix -> ``(..., Nsc)``.  On a CUDA tensor it launches
``csrc/mmse_interp.cu`` (or raises), a 3xTF32 tensor-core product whose
k-tiles are summed in float32 on the CUDA cores; on a CPU tensor it runs
``mmse_interp_ref``, the reference's Gauss 3-multiply form over float32
planes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def mmse_interp_ref(h_pilot: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: Gauss form over float32 planes, as the reference kernel."""
    hr, hi = h_pilot.real, h_pilot.imag
    wr, wi = w.real, w.imag
    p1 = torch.matmul(hr, wr)
    p2 = torch.matmul(hi, wi)
    p3 = torch.matmul(hr + hi, wr + wi)
    return torch.complex(p1 - p2, p3 - p1 - p2)


def _launch(h2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, np_ = h2.shape
    nsc = w.shape[1]
    out = torch.empty((b, nsc), dtype=torch.complex64, device=h2.device)
    fn = build.function("mmse_interp", "mmse_interp_launch",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    build.check(fn(h2.data_ptr(), w.data_ptr(), out.data_ptr(), b, np_, nsc,
                   build.stream(h2)), "mmse_interp")
    build.launch_counts["mmse_interp"] += 1
    return out


def mmse_interp(h_pilot: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Wiener-interpolate pilot estimates to the full band.

    ``h_pilot`` complex64 ``(..., Np)``, ``w`` complex64 ``(Np, Nsc)`` on the
    same device -> complex64 ``(..., Nsc)``.
    """
    if h_pilot.device != w.device:
        raise ValueError(f"h_pilot on {h_pilot.device}, w on {w.device}")
    if h_pilot.dtype != torch.complex64 or w.dtype != torch.complex64:
        raise TypeError(f"complex64 operands required, got {h_pilot.dtype}, {w.dtype}")
    if w.ndim != 2 or h_pilot.shape[-1] != w.shape[0]:
        raise ValueError(f"pilot dims disagree: {tuple(h_pilot.shape)} @ {tuple(w.shape)}")
    batch_shape = h_pilot.shape[:-1]
    h2 = h_pilot.reshape(-1, h_pilot.shape[-1])
    if h_pilot.device.type != "cuda":
        out = mmse_interp_ref(h2, w)
    else:
        if not (h2.is_contiguous() and w.is_contiguous()):
            raise ValueError("mmse_interp kernel needs contiguous operands")
        out = _launch(h2, w)
    return out.reshape(*batch_shape, w.shape[1])
