"""Link-level abstraction: MIESM TB success under a smooth outage model.

Port of ``repro.phy.link``'s traced path, batched over a leading UE axis.
The decision compares one uniform draw per UE with the success
probability, so a float difference in the probability can flip an
outcome when the draw lands within rounding of it.
"""

from __future__ import annotations

import torch

from repro_torch import random as jr


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
    return mi.mean(dim=-1) / qm_f


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
