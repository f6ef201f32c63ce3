"""Cross-layer KPM telemetry (paper 2, 4.3, 6) and the per-UE KPM window.

KPM names and layer attribution follow the paper:

* **Aerial Data Lake** (PHY, per slot): code rate, SINR, QAM order, MCS
  index, TB size, code blocks, PDU length, NDI, RSRP, plus PHY throughput,
  which is cumulative and so excluded from the correlation analysis (paper
  4.3) but kept as a policy input.
* **OAI** (L2+): SNR, MAC throughput, LCID4 throughput, MAC RX bytes, LCID4
  RX bytes.

The candidate and selected KPM sets are copied from ``repro.core.telemetry``,
and so is ``segment_telemetry``, the campaign service's per-segment reduction
of a history.  ``KPMRing`` holds every UE's rolling window
with a leading UE axis (``buf (U, W, F)``, ``idx (U,)``, ``count (U,)``),
so one push serves the whole slot.  The window mean adds the newest
entries one at a time in a fixed order: the same elementwise float32 ops
on any device, which is what makes the device loop and its host replay
agree bitwise.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

AERIAL_CANDIDATE_KPMS: tuple[str, ...] = (
    "code_rate", "sinr", "qam_order", "mcs_index", "tb_size", "num_cbs",
    "pdu_length", "ndi", "rsrp",
)
AERIAL_CUMULATIVE_KPMS: tuple[str, ...] = ("phy_throughput",)
OAI_CANDIDATE_KPMS: tuple[str, ...] = (
    "snr", "mac_throughput", "lcid4_throughput", "mac_rx_bytes", "lcid4_rx_bytes",
)

#: The paper's final policy input set (4.3): 5 Aerial + 5 OAI KPMs.
SELECTED_KPMS: tuple[str, ...] = (
    "phy_throughput", "mcs_index", "pdu_length", "ndi", "rsrp", "snr",
    "mac_throughput", "lcid4_throughput", "mac_rx_bytes", "lcid4_rx_bytes",
)

ALL_CANDIDATE_KPMS: tuple[str, ...] = AERIAL_CANDIDATE_KPMS + OAI_CANDIDATE_KPMS

#: Execution-cost leaves the batched engine adds to every trajectory: cost
#: accounting, not channel KPMs, so outside the GATED == CONCURRENT contract.
EXECUTION_COST_KPMS: tuple[str, ...] = (
    "executed_flops", "gated_overflow", "audit_tripped", "health_tripped", "quarantined",
)


def physical_trajectory(traj: Mapping[str, torch.Tensor]) -> dict:
    """A trajectory's physical leaves: everything but the cost accounting,
    the leaves on which GATED and CONCURRENT execution must agree bitwise."""
    return {k: v for k, v in traj.items() if k not in EXECUTION_COST_KPMS}


def kpm_vector(kpms: Mapping[str, torch.Tensor | float], names: Sequence[str]) -> torch.Tensor:
    """Order a KPM mapping into a dense float32 feature vector, on the device
    of the KPMs' tensors (host numbers stay on the host)."""
    device = next((v.device for v in kpms.values() if isinstance(v, torch.Tensor)), "cpu")
    return torch.stack([torch.as_tensor(kpms[n], dtype=torch.float32, device=device)
                        for n in names])


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


#: fall-back leaves folded into the served-by-AI reduction and exported as
#: per-segment counters when present
_FALLBACK_LEAVES = ("gated_overflow", "audit_tripped", "health_tripped", "quarantined")


def segment_telemetry(history, t0: int, t1: int, *, local: bool = False) -> dict:
    """Reduce one slot span ``[t0, t1)`` of a ``BatchedRunHistory`` to flat scalars.

    Mean throughput and AI share over resident slot-UEs (served, not merely
    selected, as ``BatchedRunHistory.ai_share``), executed FLOPs, the
    fall-back counters and, under a multi-cell topology, the per-cell
    throughput.  Everything comes out as plain Python scalars and lists, so
    it outlives the driver's reused accumulators and serializes to JSON.
    ``local=True`` says ``history`` holds exactly the span's rows (the
    streaming driver's ``SegmentEvent.segment_history``); ``t0`` / ``t1``
    name the global span either way and are echoed in the result.
    """
    if t0 < 0 or t1 <= t0:
        raise ValueError(f"slot span [{t0}, {t1}) is empty or negative")
    n_rows = int(np.shape(history.modes)[0])
    if local:
        if n_rows != t1 - t0:
            raise ValueError(f"local span view holds {n_rows} slot rows but the span "
                             f"[{t0}, {t1}) covers {t1 - t0}")
        lo, hi = 0, n_rows
    elif t1 <= n_rows:
        lo, hi = t0, t1
    else:
        raise ValueError(f"slot span [{t0}, {t1}) outside the campaign horizon [0, {n_rows})")
    modes = np.asarray(history.modes)[lo:hi]
    resident = (np.ones(modes.shape, bool) if history.attached is None
                else np.asarray(history.attached, bool)[lo:hi])
    served = (modes == 0) & resident
    for k in _FALLBACK_LEAVES:
        if k in history.outputs:
            served &= np.asarray(history.outputs[k])[lo:hi] == 0
    n_resident = int(resident.sum())
    out: dict = {
        "t0": int(t0),
        "t1": int(t1),
        "resident_slot_ues": n_resident,
        "ai_share": float(served[resident].mean()) if n_resident else 0.0,
    }
    if "phy_throughput" in history.kpms:
        tput = np.asarray(history.kpms["phy_throughput"])[lo:hi]
        out["throughput_bps"] = float(tput[resident].mean()) if n_resident else 0.0
        if history.cell_of_ue is not None:
            cells = np.asarray(history.cell_of_ue)
            per_cell = []
            for c in range(int(cells.max()) + 1):
                sel = resident[:, cells == c]
                per_cell.append(float(tput[:, cells == c][sel].mean()) if sel.any() else 0.0)
            out["per_cell_throughput_bps"] = per_cell
    if "executed_flops" in history.outputs:
        out["executed_flops"] = float(
            np.asarray(history.outputs["executed_flops"], np.float64)[lo:hi].sum())
    for k in _FALLBACK_LEAVES:
        if k in history.outputs:
            out[f"{k}_slot_ues"] = int((np.asarray(history.outputs[k])[lo:hi] > 0).sum())
    return out


class KPMRing(NamedTuple):
    buf: torch.Tensor  # (U, capacity, n_kpms) float32
    idx: torch.Tensor  # (U,) int64 -- next write position
    count: torch.Tensor  # (U,) int64 -- total pushes (saturating)


def ring_init(n_ues: int, capacity: int, n_kpms: int,
              device: torch.device | str = "cuda") -> KPMRing:
    """Empty KPM rings of ``n_ues`` UEs on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
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


def ring_matrix(ring: KPMRing) -> tuple[torch.Tensor, torch.Tensor]:
    """Every UE's rows (oldest to newest not guaranteed) and their validity
    mask ``(U, capacity)``."""
    cap = ring.buf.shape[1]
    valid = torch.arange(cap, device=ring.buf.device)[None] < ring.count[:, None]
    return ring.buf, valid
