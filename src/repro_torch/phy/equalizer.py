"""MMSE equalizer with time-domain interpolation (paper 5.1), per UE."""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.device import cached_const
from repro_torch.phy.nr import SlotConfig
from repro_torch.ue_reduce import ue_sum


@functools.lru_cache(maxsize=None)
def _time_weights(cfg: SlotConfig) -> np.ndarray:
    """Piecewise-linear weights (n_sym, n_dmrs_sym), edge symbols clamped."""
    sym = np.arange(cfg.n_sym, dtype=np.float64)
    anchors = np.asarray(cfg.dmrs_symbols, np.float64)
    w = np.zeros((cfg.n_sym, cfg.n_dmrs_sym))
    for i, s in enumerate(sym):
        j = int(np.clip(np.searchsorted(anchors, s) - 1, 0, len(anchors) - 2))
        t0, t1 = anchors[j], anchors[j + 1]
        a = np.clip((s - t0) / (t1 - t0), 0.0, 1.0)
        w[i, j] = 1.0 - a
        w[i, j + 1] = a
    return w.astype(np.float32)


def time_interpolate(cfg: SlotConfig, h_dmrs: torch.Tensor) -> torch.Tensor:
    """``(..., n_sc, n_dmrs_sym)`` at the DMRS symbols -> ``(..., n_sc, n_sym)``."""
    w = cached_const(("time_weights", cfg, h_dmrs.dtype), h_dmrs.device,
                     lambda: torch.as_tensor(_time_weights(cfg)).to(h_dmrs.dtype))
    return _symbol_sum(h_dmrs, w)


def _symbol_sum(h_dmrs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...sd,md->...sm")`` one DMRS symbol at a time, in order: the
    same bits in any batch."""
    out = None
    for d in range(w.shape[1]):
        term = h_dmrs[..., d, None] * w[:, d]
        out = term if out is None else out + term
    return out


def mmse_equalize(
    cfg: SlotConfig,
    rx_grid: torch.Tensor,
    h_est_dmrs: torch.Tensor,
    noise_var: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Equalize every UE's slot.

    ``rx_grid (U, ant, sc, sym)``, ``h_est_dmrs (U, ant, l, sc, n_dmrs)``,
    ``noise_var (U,)`` -> ``(x_hat, sinr)``, both ``(U, sc, sym)``: the
    layer-0 MRC/MMSE symbols and the nominal post-MRC SINR.
    """
    h = time_interpolate(cfg, h_est_dmrs)[:, :, 0]  # (U, ant, sc, sym)
    num = ue_sum(torch.conj(h) * rx_grid, 1)
    den = ue_sum(torch.abs(h) ** 2, 1)
    nv = noise_var.reshape(-1, 1, 1)
    d = den + nv
    x_hat = torch.complex(num.real / d, num.imag / d)
    sinr = den / torch.clamp(nv, min=1e-12)
    return x_hat, sinr
