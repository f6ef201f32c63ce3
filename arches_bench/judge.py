"""The comparison that decides ``correct``: a campaign the program ran
against the same campaign worked out by ``arches_bench.reference``.

The numbers, each held to its own limit (``arches_bench/limits``):

* ``unexplained_splits`` -- an exact comparison of the discrete outcomes
  (active mode, raw decision, MCS, TB outcome, GATED overflow): the UEs
  whose path first leaves the reference's at a slot where the reference's
  own decision was not on a knife edge.  Rounding can flip an outcome only
  where the reference decided within rounding of its threshold: the MCS
  within ``EDGE_DB`` of an SNR threshold, the TB draw within ``EDGE_P`` of
  its success probability, a tree node within ``EDGE_TREE`` of its
  threshold; an overflow flag may follow a lower-numbered UE's split (the
  compaction counts in UE order).  Anything else is an outcome the program
  got wrong.
* ``kpm_gap.mmse`` and ``kpm_gap.ai`` -- over the slot-UEs whose path
  still agrees and that the MMSE (or the AI) expert served, the median of
  the relative gap in the two KPMs that read the selected estimate
  directly: the RSRP (the estimate's mean power) and the measured SINR
  (linear), the larger of the two.  The median, not the widest gap: the
  widest is set by rare slot-UEs that every precision shares (the
  benchmark's look, ``PERF.md``), the median by the experts' precision.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

DISCRETE = ("mcs", "tb_ok", "decisions", "gated_overflow", "modes")
#: how close to its threshold the reference's own decision has to be for a
#: different outcome of the program to count as rounding
EDGE_DB, EDGE_P, EDGE_TREE = 0.01, 0.01, 1e-3
KPMS = ("code_rate", "sinr", "qam_order", "mcs_index", "tb_size", "n_code_blocks",
        "pdu_length", "ndi", "rsrp", "phy_throughput", "snr", "mac_throughput",
        "lcid4_throughput", "mac_rx_bytes", "lcid4_rx_bytes")


def program_leaves(hist) -> dict[str, np.ndarray]:
    """The leaves of a ``BatchedRunHistory`` that the judge compares."""
    out = {"modes": hist.modes, "decisions": hist.decisions,
           **{k: hist.outputs[k] for k in ("mcs", "tb_ok", "gated_overflow")}}
    out.update({k: hist.kpms[k] for k in KPMS})
    return {k: np.asarray(v) for k, v in out.items()}


def _gaps(got, want) -> np.ndarray:
    """Per slot-UE relative gap: the larger of RSRP's and the linear SINR's."""
    def rel(g, w):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        return np.abs(g - w) / np.maximum(np.abs(w), 1e-30)

    def lin(db):
        return 10.0 ** (np.asarray(db, np.float64) / 10.0)

    return np.maximum(rel(got["rsrp"], want["rsrp"]), rel(lin(got["sinr"]), lin(want["sinr"])))


def compare(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]) -> dict[str, float]:
    """The numbers of ``got`` (the program's leaves) against ``want`` (the
    reference's, margins included), with ``path_split`` (the share of
    slot-UEs after their UE's first split) and ``kpm_gap.max`` (the widest
    gap of any KPM over its mean magnitude) beside them for the look."""
    n_slots, n_ues = np.shape(want["modes"])
    differs = {k: np.asarray(got[k]) != np.asarray(want[k]) for k in DISCRETE}
    any_diff = np.zeros((n_slots, n_ues), bool)
    for d in differs.values():
        any_diff |= d
    split_at = np.where(any_diff.any(axis=0), any_diff.argmax(axis=0), n_slots)
    agree = np.arange(n_slots)[:, None] < split_at[None, :]

    mode_split = np.where(differs["modes"].any(axis=0), differs["modes"].argmax(axis=0),
                          n_slots)
    unexplained = 0
    for u in np.nonzero(split_at < n_slots)[0]:
        s = split_at[u]
        if differs["mcs"][s, u]:
            edge = want["mcs_margin"][s, u] <= EDGE_DB
        elif differs["tb_ok"][s, u]:
            edge = want["tb_margin"][s, u] <= EDGE_P
        elif differs["decisions"][s, u]:
            edge = want["tree_margin"][s, u] <= EDGE_TREE
        elif differs["gated_overflow"][s, u]:
            edge = bool((mode_split[:u] <= s).any())
        else:
            edge = False
        unexplained += int(not edge)

    gaps = _gaps(got, want)
    ai = (np.asarray(want["modes"]) == 0) & (np.asarray(want["gated_overflow"]) == 0)
    out = {"unexplained_splits": float(unexplained), "path_split": float(1.0 - agree.mean())}
    for name, served in (("kpm_gap.mmse", ~ai), ("kpm_gap.ai", ai)):
        g = gaps[agree & served]
        out[name] = float(np.median(g)) if g.size else 0.0
    widest = 0.0
    for k in KPMS:
        w, g = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        d = np.abs(g - w)[agree]
        scale = float(np.abs(w).mean())
        if d.size and d.max() > 0:
            widest = max(widest, float(d.max()) / scale if scale > 0 else float("inf"))
    out["kpm_gap.max"] = widest
    return out


def verdict(numbers: Mapping[str, float], limits: Mapping[str, Mapping]) -> tuple[bool, list]:
    """``(correct, [(name, value, limit), ...])``: correct where every
    number the limits name is finite and at or under its limit."""
    rows = [(k, float(numbers[k]), float(limits[k]["limit"])) for k in sorted(limits)]
    return all(np.isfinite(v) and v <= lim for _, v, lim in rows), rows
