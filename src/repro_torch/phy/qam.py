"""Gray-coded QAM modulation and the per-axis nearest-point slicer."""

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
