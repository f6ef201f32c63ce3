"""Cross-layer KPM telemetry (paper 2, 4.3, 6) and the per-UE KPM window.

The paper's selected KPM set is copied from ``repro.core.telemetry``.  ``KPMRing`` holds every UE's rolling window
with a leading UE axis (``buf (U, W, F)``, ``idx (U,)``, ``count (U,)``),
so one push serves the whole slot.  The window mean adds the newest
entries one at a time in a fixed order: the same elementwise float32 ops
on any device, which is what makes the device loop and its host replay
agree bitwise.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import torch

#: The paper's final policy input set (4.3): 5 Aerial + 5 OAI KPMs.
SELECTED_KPMS: tuple[str, ...] = (
    "phy_throughput", "mcs_index", "pdu_length", "ndi", "rsrp", "snr",
    "mac_throughput", "lcid4_throughput", "mac_rx_bytes", "lcid4_rx_bytes",
)


def flatten_kpm_sources(kpms_by_source: Mapping[str, Mapping[str, torch.Tensor]]) -> dict:
    """Merge ``{source: {kpm: value}}`` into one flat ``{kpm: value}`` map."""
    flat: dict = {}
    for kpms in kpms_by_source.values():
        flat.update(kpms)
    return flat


def trajectory_kpm_matrix(
    kpms_by_source: Mapping[str, Mapping[str, torch.Tensor]],
    names: Sequence[str] = SELECTED_KPMS,
) -> torch.Tensor:
    """Stack KPM leaves of any leading shape into ``(..., len(names))`` float32."""
    flat = flatten_kpm_sources(kpms_by_source)
    return torch.stack([flat[n].to(torch.float32) for n in names], dim=-1)


class KPMRing(NamedTuple):
    buf: torch.Tensor  # (U, capacity, n_kpms) float32
    idx: torch.Tensor  # (U,) int64 -- next write position
    count: torch.Tensor  # (U,) int64 -- total pushes (saturating)


def ring_init(n_ues: int, capacity: int, n_kpms: int,
              device: torch.device | str = "cpu") -> KPMRing:
    z = torch.zeros(n_ues, dtype=torch.int64, device=device)
    return KPMRing(
        buf=torch.zeros((n_ues, capacity, n_kpms), dtype=torch.float32, device=device),
        idx=z, count=z.clone(),
    )


def ring_push(ring: KPMRing, vecs: torch.Tensor) -> KPMRing:
    """Write each UE's ``vecs[u]`` at its ring position (functional)."""
    cap = ring.buf.shape[1]
    buf = ring.buf.clone()
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, ring.idx] = vecs.to(torch.float32)
    return KPMRing(
        buf=buf,
        idx=(ring.idx + 1) % cap,
        count=torch.clamp(ring.count + 1, max=2**30),
    )


def ring_window_mean(ring: KPMRing, window: int) -> torch.Tensor:
    """Per-UE mean over the most recent ``min(window, count)`` entries."""
    n_ues, cap, _ = ring.buf.shape
    window = min(window, cap)
    rows = torch.arange(n_ues, device=ring.buf.device)
    acc = torch.zeros_like(ring.buf[:, 0])
    n_valid = torch.zeros(n_ues, dtype=torch.float32, device=ring.buf.device)
    for off in range(1, window + 1):  # newest first, fixed order
        valid = (off <= ring.count).to(torch.float32)
        acc = acc + ring.buf[rows, (ring.idx - off) % cap] * valid[:, None]
        n_valid = n_valid + valid
    return acc / torch.clamp(n_valid, min=1.0)[:, None]
