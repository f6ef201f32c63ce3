"""MMSE/Wiener interpolation: the wrapper of the hand-written kernel and its
plain PyTorch version.

``mmse_interp(h_pilot, w, use_gauss=True)`` replaces
``repro.kernels.mmse_interp.ops.mmse_interp``: complex ``(..., Np)`` pilot
estimates times the complex ``(Np, Nsc)`` Wiener matrix -> ``(..., Nsc)``, in
the reference kernel's two forms over real planes: the Gauss 3-multiply form
(the default, as in the reference) or the 4-multiply form.  On a CUDA tensor
it launches ``csrc/mmse_interp.cu``'s kernel of that form (or raises), a
3xTF32 tensor-core product whose k-tiles are summed in float32 on the CUDA
cores; on a CPU tensor it runs ``mmse_interp_ref`` in the same form over
float32 planes, the reference kernel's arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def mmse_interp_ref(h_pilot: torch.Tensor, w: torch.Tensor, *,
                    use_gauss: bool = True) -> torch.Tensor:
    """Plain version over float32 planes, in the reference kernel's form:
    ``p1 = Hr Wr``, ``p2 = Hi Wi``, ``p3 = (Hr + Hi)(Wr + Wi)``, then
    ``(p1 - p2, p3 - p1 - p2)`` (Gauss); or ``(Hr Wr - Hi Wi, Hr Wi + Hi Wr)``."""
    hr, hi = h_pilot.real, h_pilot.imag
    wr, wi = w.real, w.imag
    if not use_gauss:
        return torch.complex(torch.matmul(hr, wr) - torch.matmul(hi, wi),
                             torch.matmul(hr, wi) + torch.matmul(hi, wr))
    p1 = torch.matmul(hr, wr)
    p2 = torch.matmul(hi, wi)
    p3 = torch.matmul(hr + hi, wr + wi)
    return torch.complex(p1 - p2, p3 - p1 - p2)


#: the C entry point and launch counter of each form
_ENTRY = {True: ("mmse_interp_gauss_launch", "mmse_interp_gauss"),
          False: ("mmse_interp_launch", "mmse_interp")}


def _launch(h2: torch.Tensor, w: torch.Tensor, use_gauss: bool) -> torch.Tensor:
    b, np_ = h2.shape
    nsc = w.shape[1]
    out = torch.empty((b, nsc), dtype=torch.complex64, device=h2.device)
    symbol, counter = _ENTRY[use_gauss]
    fn = build.function("mmse_interp", symbol,
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    build.check(fn(h2.data_ptr(), w.data_ptr(), out.data_ptr(), b, np_, nsc,
                   build.stream(h2)), counter)
    build.launch_counts[counter] += 1
    return out


def mmse_interp(h_pilot: torch.Tensor, w: torch.Tensor, *,
                use_gauss: bool = True) -> torch.Tensor:
    """Wiener-interpolate pilot estimates to the full band.

    ``h_pilot`` complex64 ``(..., Np)``, ``w`` complex64 ``(Np, Nsc)`` on the
    same device -> complex64 ``(..., Nsc)``.  ``use_gauss`` picks the
    3-multiply form (the reference's default) or the 4-multiply form.
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
        out = mmse_interp_ref(h2, w, use_gauss=use_gauss)
    else:
        if not (h2.is_contiguous() and w.is_contiguous()):
            raise ValueError("mmse_interp kernel needs contiguous operands")
        out = _launch(h2, w, bool(use_gauss))
    return out.reshape(*batch_shape, w.shape[1])
