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


def effective_noise_var(sinr: torch.Tensor) -> torch.Tensor:
    """Per-RE effective noise variance for the LLR demapper (unit signal)."""
    return torch.full((), 1.0, dtype=sinr.dtype, device=sinr.device) / torch.clamp(
        sinr, min=1e-9)


def mmse_irc_equalize(
    cfg: SlotConfig,
    rx_grid: torch.Tensor,
    h_est_dmrs: torch.Tensor,
    pilots: torch.Tensor,
    noise_var,
    *,
    prb_per_subband: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MMSE-IRC: interference-rejection combining (Aerial's UL combiner), one UE.

    The interference-plus-noise covariance ``R`` is estimated per frequency
    subband from the DMRS residuals ``e = rx_pilot - h_est * pilot``, what
    the selected expert's estimate leaves unexplained at the pilots; the
    combiner ``w = R^-1 h / (h^H R^-1 h)`` then nulls in-band interference
    spatially.

    ``rx_grid (n_ant, n_sc, n_sym)``, ``h_est_dmrs (n_ant, n_layers, n_sc,
    n_dmrs_sym)``, ``pilots (n_dmrs_sym, n_pilot_sc)``, scalar thermal
    ``noise_var`` (the diagonal loading) -> ``(x_hat, sinr)``: the layer-0
    symbol estimates and the per-RE post-IRC SINR ``h^H R^-1 h``, both
    ``(n_sc, n_sym)``.
    """
    n_ant, n_sc = cfg.n_ant, cfg.n_sc
    dev = rx_grid.device
    h_full = time_interpolate(cfg, h_est_dmrs)[:, 0]  # (ant, sc, sym)

    # residuals at the pilot REs
    pilot_sc = torch.as_tensor(cfg.pilot_sc_indices, device=dev)
    dmrs_sym = torch.as_tensor(cfg.dmrs_symbols, device=dev)
    rx_p = rx_grid[:, pilot_sc][:, :, dmrs_sym]  # (ant, n_pilot, n_dmrs)
    h_p = h_full[:, pilot_sc][:, :, dmrs_sym]
    e = rx_p - h_p * pilots.transpose(0, 1)[None]

    # per-subband covariance, averaged over pilots x DMRS symbols
    sb_pilots = prb_per_subband * 6  # comb-2: 6 pilots a PRB
    n_sb = cfg.n_pilot_sc // sb_pilots
    e_sb = e[:, : n_sb * sb_pilots].reshape(n_ant, n_sb, sb_pilots, -1)
    r = torch.einsum("aspd,bspd->sab", e_sb, torch.conj(e_sb)) / (sb_pilots * cfg.n_dmrs_sym)
    noise_var = torch.as_tensor(noise_var, dtype=torch.float32, device=dev)
    eye = torch.eye(n_ant, dtype=r.dtype, device=dev)
    r = r + (noise_var * 0.1 + 1e-6) * eye[None]

    # every subcarrier's subband, then the combiner per RE
    sc_to_sb = torch.clamp(torch.arange(n_sc, device=dev) // (12 * prb_per_subband),
                           0, n_sb - 1)
    h_t = h_full.movedim(0, -1)  # (sc, sym, ant)
    r_sc = r[sc_to_sb]  # (sc, ant, ant)
    rinv_h = torch.linalg.solve(r_sc[:, None], h_t[..., None])[..., 0]  # (sc, sym, ant)
    hrh = torch.sum(torch.conj(h_t) * rinv_h, dim=-1).real
    rx_t = rx_grid.movedim(0, -1)
    num = torch.sum(torch.conj(rinv_h) * rx_t, dim=-1)  # (R^-1 h)^H y
    d = torch.clamp(hrh, min=1e-9)
    return torch.complex(num.real / d, num.imag / d), hrh
