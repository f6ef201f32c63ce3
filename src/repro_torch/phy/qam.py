"""Gray-coded QAM modulation, max-log LLR demapping and the per-axis
nearest-point slicer (TS 38.211 5.1)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import cached_const


def _gray_pam_levels(bits_per_axis: int) -> np.ndarray:
    """Gray-mapped PAM levels indexed by the per-axis bit group."""
    m = 1 << bits_per_axis
    levels = np.arange(-(m - 1), m, 2, dtype=np.float64)
    out = np.zeros(m)
    for code in range(m):
        out[code] = levels[code ^ (code >> 1)]
    return out


_NORM = {2: np.sqrt(2.0), 4: np.sqrt(10.0), 6: np.sqrt(42.0), 8: np.sqrt(170.0)}


def constellation_np(qm: int) -> np.ndarray:
    """All 2**qm points in bit-label order, complex64 (MSB first, I then Q)."""
    half = qm // 2
    pam = _gray_pam_levels(half)
    pts = np.zeros(1 << qm, np.complex128)
    for label in range(1 << qm):
        pts[label] = pam[label >> half] + 1j * pam[label & ((1 << half) - 1)]
    return (pts / _NORM[qm]).astype(np.complex64)


def constellation(qm: int, device: torch.device | str = "cpu") -> torch.Tensor:
    return cached_const(("constellation", qm), device, lambda: constellation_np(qm))


def modulate(bits: torch.Tensor, qm: int) -> torch.Tensor:
    """``(..., n*qm)`` bits in {0,1} -> ``(..., n)`` unit-energy symbols."""
    groups = bits.reshape(bits.shape[:-1] + (-1, qm)).to(torch.int64)
    weights = cached_const(("bit_weights", qm), bits.device, lambda: np.asarray(
        [1 << (qm - 1 - i) for i in range(qm)], np.int64))
    labels = (groups * weights).sum(dim=-1)
    return constellation(qm, bits.device)[labels]


def demap_llr(y: torch.Tensor, noise_var: torch.Tensor | float, qm: int) -> torch.Tensor:
    """Max-log LLRs: ``(..., n)`` equalized symbols -> ``(..., n*qm)``.

    Positive LLR means bit 0 is more likely (``log P(b=0) / P(b=1)``).
    """
    pts = constellation(qm, y.device)
    d2 = torch.abs(y[..., None] - pts) ** 2  # (..., n, M)
    nv = torch.clamp(torch.as_tensor(noise_var, dtype=torch.float32, device=y.device),
                     min=1e-9)
    if nv.ndim:  # per-RE noise variance: broadcast over the constellation
        nv = nv[..., None]
    metric = -d2 / nv
    labels = np.arange(1 << qm)
    neg_inf = torch.full((), float("-inf"), dtype=metric.dtype, device=y.device)
    llrs = []
    for b in range(qm):
        is_one = cached_const(("llr_bit", qm, b), y.device,
                              lambda b=b: ((labels >> (qm - 1 - b)) & 1).astype(bool))
        m0 = torch.where(is_one, neg_inf, metric).amax(dim=-1)
        m1 = torch.where(is_one, metric, neg_inf).amax(dim=-1)
        llrs.append(m0 - m1)
    return torch.stack(llrs, dim=-1).reshape(y.shape[:-1] + (-1,))


def hard_bits(llr: torch.Tensor) -> torch.Tensor:
    """LLR -> hard decisions (bit 1 where the LLR is negative)."""
    return (llr < 0).to(torch.uint8)


def _gray_inverse(bits_per_axis: int) -> np.ndarray:
    m = 1 << bits_per_axis
    inv = np.zeros(m, np.int64)
    for code in range(m):
        inv[code ^ (code >> 1)] = code
    return inv


def nearest_point(y: torch.Tensor, qm: int) -> torch.Tensor:
    """Nearest constellation point per symbol: the closest PAM level on each
    of the I and Q axes (square Gray QAM factorizes), gathered from the
    exact ``constellation`` table."""
    half = qm // 2
    m = 1 << half
    pts = constellation(qm, y.device)
    inv = cached_const(("gray_inverse", half), y.device, lambda: _gray_inverse(half))
    norm = float(_NORM[qm])

    def level_idx(x):
        return torch.clamp(torch.round((x * norm + (m - 1)) / 2.0), 0, m - 1).long()

    code_i = inv[level_idx(y.real)]
    code_q = inv[level_idx(y.imag)]
    return pts[code_i * m + code_q]
