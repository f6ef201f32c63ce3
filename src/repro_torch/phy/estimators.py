"""Channel estimators: LS at the pilots and the Wiener interpolator (paper 5.1-5.2).

``WienerInterpolator.build`` runs the same numpy arithmetic as the
reference, so ``W`` is identical before the final cast to complex64.  The
interpolation itself is the ``mmse_interp`` kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.phy import dmrs as dmrs_mod
from repro_torch.phy.nr import SlotConfig


def ls_estimate(cfg: SlotConfig, rx_grid: torch.Tensor,
                pilots: torch.Tensor) -> torch.Tensor:
    """LS estimates at DMRS REs: ``rx_grid (..., ant, sc, sym)`` ->
    ``(..., ant, n_dmrs_sym, n_pilot_sc)``."""
    rx_pilots = dmrs_mod.extract_pilot_re(cfg, rx_grid)
    num = rx_pilots * torch.conj(pilots)
    den = torch.abs(pilots) ** 2 + 1e-12
    return torch.complex(num.real / den, num.imag / den)


def exponential_pdp_correlation(cfg: SlotConfig, rms_delay_spread_s: float) -> np.ndarray:
    """Frequency correlation ``r(df) = 1 / (1 + j 2 pi tau_rms df)``."""
    df = cfg.scs_khz * 1e3
    k = np.arange(cfg.n_sc)
    dk = (k[:, None] - k[None, :]) * df
    return 1.0 / (1.0 + 2j * np.pi * rms_delay_spread_s * dk)


@dataclasses.dataclass(frozen=True)
class WienerInterpolator:
    """Precomputed ``W = R_fp (R_pp + sigma^2 I)^-1``, pilot -> full band."""

    w: torch.Tensor  # (n_pilot_sc, n_sc) complex64

    @classmethod
    def build(
        cls,
        cfg: SlotConfig,
        *,
        rms_delay_spread_s: float = 100e-9,
        noise_var: float = 1e-2,
        device: torch.device | str = "cpu",
    ) -> "WienerInterpolator":
        r = exponential_pdp_correlation(cfg, rms_delay_spread_s)
        p = cfg.pilot_sc_indices
        r_fp = r[:, p]
        r_pp = r[np.ix_(p, p)]
        w = r_fp @ np.linalg.inv(r_pp + noise_var * np.eye(len(p)))
        return cls(w=torch.as_tensor(np.ascontiguousarray(w.T).astype(np.complex64),
                                     device=device))


def estimator_flops(cfg: SlotConfig) -> float:
    """Complex-matmul FLOPs for the Wiener interpolation (cost model)."""
    b = cfg.n_ant * cfg.n_dmrs_sym
    return 8.0 * b * cfg.n_pilot_sc * cfg.n_sc
