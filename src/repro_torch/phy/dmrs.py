"""DMRS generation and resource-grid mapping (paper 5.1, Fig. 6).

Type-1 DMRS, comb-2, on OFDM symbols {0, 5, 10}; QPSK symbols from the
TS 38.211 Gold sequence, computed on the host in numpy exactly as
``repro.phy.dmrs`` does.  The grid maps take a leading UE axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.device import cached_const, resolve_device
from repro_torch.phy.nr import SlotConfig


def _gold_sequence(c_init: int, length: int) -> np.ndarray:
    """TS 38.211 5.2.1 length-31 Gold sequence."""
    nc = 1600
    x1 = np.zeros(nc + length + 31, np.int8)
    x2 = np.zeros(nc + length + 31, np.int8)
    x1[0] = 1
    for i in range(31):
        x2[i] = (c_init >> i) & 1
    for n in range(len(x1) - 31):
        x1[n + 31] = (x1[n + 3] + x1[n]) % 2
        x2[n + 31] = (x2[n + 3] + x2[n + 2] + x2[n + 1] + x2[n]) % 2
    return ((x1[nc: nc + length] + x2[nc: nc + length]) % 2).astype(np.int8)


@functools.lru_cache(maxsize=None)
def dmrs_sequence_np(cfg: SlotConfig, slot: int = 0, cell_id: int = 42) -> np.ndarray:
    """QPSK DMRS symbols, (n_dmrs_sym, n_pilot_sc) complex64."""
    seqs = []
    for sym in cfg.dmrs_symbols:
        c_init = ((14 * slot + sym + 1) * (2 * cell_id + 1) * 2**17
                  + 2 * cell_id) % (2**31)
        bits = _gold_sequence(int(c_init), 2 * cfg.n_pilot_sc).astype(np.float32)
        re = (1.0 - 2.0 * bits[0::2]) / np.sqrt(2.0)
        im = (1.0 - 2.0 * bits[1::2]) / np.sqrt(2.0)
        seqs.append(re + 1j * im)
    return np.stack(seqs).astype(np.complex64)


def dmrs_sequence(cfg: SlotConfig, *, slot: int = 0, cell_id: int = 42,
                  device: torch.device | str = "cuda") -> torch.Tensor:
    """QPSK DMRS symbols of ``slot`` in cell ``cell_id``, (n_dmrs_sym,
    n_pilot_sc) complex64 on ``device`` (the card unless the caller asks for
    the CPU), bitwise ``repro.phy.dmrs.dmrs_sequence``."""
    return torch.as_tensor(dmrs_sequence_np(cfg, slot, cell_id), device=resolve_device(device))


@functools.lru_cache(maxsize=None)
def data_mask(cfg: SlotConfig) -> np.ndarray:
    """(n_sc, n_sym) bool, True where PUSCH data lives."""
    mask = np.ones((cfg.n_sc, cfg.n_sym), bool)
    for sym in cfg.dmrs_symbols:
        mask[cfg.pilot_sc_indices, sym] = False
    return mask


@functools.lru_cache(maxsize=None)
def _data_flat_idx(cfg: SlotConfig) -> np.ndarray:
    return np.nonzero(data_mask(cfg).reshape(-1))[0]


def _data_idx(cfg: SlotConfig, device) -> torch.Tensor:
    return cached_const(("data_idx", cfg), device, lambda: _data_flat_idx(cfg))


def _pilot_idx(cfg: SlotConfig, device) -> torch.Tensor:
    return cached_const(("pilot_idx", cfg), device, lambda: cfg.pilot_sc_indices)


def map_slot_grid(cfg: SlotConfig, data_symbols: torch.Tensor,
                  pilots: torch.Tensor) -> torch.Tensor:
    """TX grid ``(U, n_layers, n_sc, n_sym)`` from ``(U, n_data_re)`` data
    symbols in grid scan order and ``(n_dmrs_sym, n_pilot_sc)`` pilots."""
    n_ues = data_symbols.shape[0]
    dev = data_symbols.device
    flat = torch.zeros((n_ues, cfg.n_sc * cfg.n_sym), dtype=torch.complex64,
                       device=dev)
    flat[:, _data_idx(cfg, dev)] = data_symbols
    grid = flat.reshape(n_ues, cfg.n_sc, cfg.n_sym)
    pilot_sc = _pilot_idx(cfg, dev)
    for i, sym in enumerate(cfg.dmrs_symbols):
        grid[:, pilot_sc, sym] = pilots[i]
    out = torch.zeros((n_ues, cfg.n_layers, cfg.n_sc, cfg.n_sym),
                      dtype=torch.complex64, device=dev)
    out[:, 0] = grid
    return out


def extract_data_re(cfg: SlotConfig, grid: torch.Tensor) -> torch.Tensor:
    """Inverse of the data mapping: (..., n_sc, n_sym) -> (..., n_data_re)."""
    flat = grid.reshape(grid.shape[:-2] + (-1,))
    return flat[..., _data_idx(cfg, grid.device)]


def extract_pilot_re(cfg: SlotConfig, grid: torch.Tensor) -> torch.Tensor:
    """RX samples at DMRS REs: (..., n_sc, n_sym) -> (..., n_dmrs_sym, n_pilot_sc)."""
    pilot_sc = _pilot_idx(cfg, grid.device)
    return torch.stack([grid[..., pilot_sc, sym] for sym in cfg.dmrs_symbols],
                       dim=-2)
