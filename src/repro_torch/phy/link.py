"""Link-level abstraction: MIESM TB success under a smooth outage model.

Port of ``repro.phy.link``: the traced path batched over a leading UE axis
(``*_dynamic``), and the host loop's forms for one UE with a static MCS,
plus hard-decision bit errors and CRC-24A.  The decision compares one
uniform draw per UE with the success probability, so a float difference in
the probability can flip an outcome when the draw lands within rounding of
it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.phy.mcs import McsEntry
from repro_torch.ue_reduce import ue_mean


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp``: ``max + log1p(exp(-|a - b|))``."""
    amax = torch.maximum(a, b)
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       amax + torch.log1p(torch.exp(-delta.abs())))


def qam_mutual_information_dynamic(sinr: torch.Tensor, qm: torch.Tensor) -> torch.Tensor:
    """Capped-capacity MIESM: ``softmin(qm, log2(1 + snr / 1.25))``."""
    gamma = 1.25
    cap = torch.log2(1.0 + sinr / gamma)
    beta = 3.0
    return -_logaddexp(-beta * cap, -beta * qm) / beta


def effective_mi_dynamic(sinr_data: torch.Tensor, qm: torch.Tensor) -> torch.Tensor:
    """Per-UE mean MI per symbol / qm; ``sinr_data (U, n)``, ``qm (U,)``."""
    qm_f = qm.to(torch.float32)
    mi = qam_mutual_information_dynamic(sinr_data, qm_f[:, None])
    return ue_mean(mi, -1) / qm_f


def tb_success_dynamic(
    sinr_data: torch.Tensor,
    qm: torch.Tensor,
    code_rate: torch.Tensor,
    *,
    margin: float = 0.05,
    key: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-UE TB CRC outcome (bool ``(U,)``); ``key (U, 2)`` draws one
    uniform per UE against a logistic success probability."""
    mi = effective_mi_dynamic(sinr_data, qm)
    margin_mi = mi - (code_rate + margin)
    if key is None:
        return margin_mi > 0
    p_success = torch.sigmoid(margin_mi * 80.0)
    return jr.uniform(key, ()) < p_success


def qam_mutual_information(sinr: torch.Tensor, qm: int) -> torch.Tensor:
    """Static-``qm`` form of ``qam_mutual_information_dynamic``."""
    return qam_mutual_information_dynamic(sinr, torch.full_like(sinr, float(qm)))


def effective_mi(sinr_data: torch.Tensor, qm: int) -> torch.Tensor:
    """One UE's mean MI per symbol over the data allocation, over ``qm``."""
    return qam_mutual_information(sinr_data, qm).mean() / float(qm)


def tb_success(sinr_data: torch.Tensor, mcs: McsEntry, *, margin: float = 0.05,
               key: torch.Tensor | None = None) -> torch.Tensor:
    """One UE's TB CRC outcome (0-d bool) at a static MCS; ``key (2,)``
    draws the uniform against the logistic success probability."""
    margin_mi = effective_mi(sinr_data, mcs.qm) - (mcs.code_rate + margin)
    if key is None:
        return margin_mi > 0
    return jr.uniform(key, ()) < torch.sigmoid(margin_mi * 80.0)


def throughput_bits(tbs_bits: int, success: torch.Tensor,
                    slot_duration_s: float) -> torch.Tensor:
    """Delivered PHY throughput for one slot, in bit/s (float32)."""
    rate = torch.full((), tbs_bits / slot_duration_s, dtype=torch.float32,
                      device=success.device)
    return torch.where(success, rate, torch.zeros_like(rate))


def count_bit_errors(tx_bits: torch.Tensor, llr: torch.Tensor) -> torch.Tensor:
    """Exact hard-decision bit errors over the TB."""
    return (tx_bits != (llr < 0).to(tx_bits.dtype)).sum()


def crc24(bits: np.ndarray) -> int:
    """CRC-24A (TS 38.212) over a host-side bit array."""
    poly = 0x1864CFB
    reg = 0
    for b in np.asarray(bits, np.uint8):
        reg = ((reg << 1) | int(b)) & 0xFFFFFF
        if (reg >> 23) & 1:
            reg ^= poly & 0xFFFFFF
    return reg
