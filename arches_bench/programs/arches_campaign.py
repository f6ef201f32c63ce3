"""The ARCHES closed-loop campaign: the program that a configuration
without a ``"program"`` key names.

``Program`` reaches ``repro_torch`` through its public entry (a fitted
policy, then one fresh ``ArchesSession`` a campaign); ``reference`` is the
same campaign worked out by ``arches_bench.reference``; ``compare`` holds
the one against the other.  The numbers, each held to its own limit
(``arches_bench/limits``):

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

from arches_bench import cells

#: the kernels that run in one span alone, by a part of their name, and
#: that span: each has to land in it, or the spans are not trusted
HOME = {"mmse_interp": "bank.mmse", "gated_expert": "bank.ai",
        "copy_rows_kernel": "bank.switch", "policy_step": "slot.decision"}
#: the kernels ``mmse_interp_roofline``, ``ai_expert_roofline`` and
#: ``device_us_per_slot.switch_policy`` claim, as ``device_ms_per_slot.rest``
#: leaves them out
CLAIMED = ("mmse_interp", "gated_expert", "copy_rows_kernel", "switch_select",
           "policy_step", "tree_infer")

DISCRETE = ("mcs", "tb_ok", "decisions", "gated_overflow", "modes")
#: how close to its threshold the reference's own decision has to be for a
#: different outcome of the program to count as rounding
EDGE_DB, EDGE_P, EDGE_TREE = 0.01, 0.01, 1e-3
KPMS = ("code_rate", "sinr", "qam_order", "mcs_index", "tb_size", "n_code_blocks",
        "pdu_length", "ndi", "rsrp", "phy_throughput", "snr", "mac_throughput",
        "lcid4_throughput", "mac_rx_bytes", "lcid4_rx_bytes")


def units(cell: cells.Cell) -> int:
    """Slot-UEs one campaign serves."""
    return cell.n_slots * cell.n_ues


def ai_rows(cell: cells.Cell, leaves: dict) -> np.ndarray:
    """UEs the AI expert ran on, per slot: every UE on a CONCURRENT bank,
    the selected ones within capacity on a GATED bank."""
    n_slots, n_ues = leaves["modes"].shape
    if not cell.gated:
        return np.full(n_slots, n_ues)
    return ((leaves["modes"] == 0) & (leaves["gated_overflow"] == 0)).sum(axis=1)


class Program:
    """The system under test, ``repro_torch``, reached through its public
    entry: a fitted policy, then one fresh ``ArchesSession`` a campaign."""

    def __init__(self, cell: cells.Cell, params_seed: int, device: str):
        self.cell, self.params_seed, self.device = cell, params_seed, device
        self.policies = None

    def load_kernels(self) -> None:
        from repro_torch.kernels import build

        build.build_all()
        for name in build.KERNELS:
            build.library(name)

    def fit_policy(self, seed: int) -> None:
        from repro_torch.core.session import ArchesSession

        spec = cells.campaign_spec(self.cell, seed, self.params_seed)
        self.policies = ArchesSession(spec, device=self.device).host_policies

    def campaign(self, seed: int) -> dict:
        from repro_torch.core.session import ArchesSession

        spec = cells.campaign_spec(self.cell, seed, self.params_seed)
        hist = ArchesSession(spec, device=self.device, host_policies=self.policies).run()
        return program_leaves(hist)


def reference(cell: cells.Cell, seed: int, params_seed: int, device: str, *,
              tf32: bool = False) -> dict:
    """The reference's trajectory of one campaign, in float32 with TF32 off,
    or (``tf32``, the control) with TF32 on for its products and convolutions."""
    import torch

    from arches_bench.reference import campaign

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            return campaign.run_campaign(cell.config, cell.traffic, seed,
                                         params_seed=params_seed, device=device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def program_leaves(hist) -> dict[str, np.ndarray]:
    """The leaves of a ``BatchedRunHistory`` that ``compare`` reads."""
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
