"""The work the algorithms need, counted once, and the card's peaks.

Frozen here so that no change to the program moves the yardstick.  A
complex multiply-add counts 8 real operations, a convolution's
multiply-add 2; every input, weight and output byte counts once, however
often an implementation reads it.  Float32 operands are held to the H100's
TF32 tensor rate: no float32-accurate implementation can pass it (3xTF32
runs three TF32 products for each counted one), so no share of it can pass
100 %.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

#: the PUSCH slot: 12 subcarriers a PRB, comb-2 pilots, complex64 (8 bytes)
_SC_PER_PRB, _C64, _F32 = 12, 8, 4


def mmse_interp(n_prb: int, rows: int) -> tuple[float, float]:
    """``(operations, bytes)`` of the Wiener interpolation of ``rows`` pilot
    rows (UEs x antennas x DMRS symbols): ``(rows, Np) @ (Np, n_sc)``."""
    n_sc = _SC_PER_PRB * n_prb
    n_p = n_sc // 2
    flops = 8.0 * rows * n_p * n_sc
    nbytes = float(_C64 * (rows * n_p + n_p * n_sc + rows * n_sc))
    return flops, nbytes


def ai_expert(n_prb: int, n_ant: int, n_dmrs_sym: int, channels: int, n_res_blocks: int,
              ues: int) -> tuple[float, float]:
    """``(operations, bytes)`` of the residual CNN on ``ues`` UEs' antenna
    images (pilot subcarriers x DMRS symbols): 3x3 'same' convolutions
    counted over the (output, input) symbol pairs that fall inside the image
    (a tap on the zero padding is no work), the stem, two per residual
    block, the x2 up-projection and the head at full band; the LS input,
    the weights and the full-band estimate as bytes."""
    n_p = _SC_PER_PRB * n_prb // 2
    pairs = 3 * n_dmrs_sym - 2
    c = channels
    layers = ([(2, c, n_p)] + [(c, c, n_p)] * (2 * n_res_blocks)
              + [(c, 2 * c, n_p), (c, 2, 2 * n_p)])
    per_image = sum(2.0 * co * ci * 3 * pairs * length for ci, co, length in layers)
    weights = sum(co * ci * 9 + co for ci, co, _ in layers)
    images = ues * n_ant
    flops = images * per_image
    nbytes = float(images * n_dmrs_sym * (n_p + 2 * n_p) * _C64 + weights * _F32)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the slower of its two roofs."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S)
