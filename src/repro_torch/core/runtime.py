"""Campaign results: ``BatchedRunHistory`` (the batched result type) and
``suggest_gated_capacity``.

The port of ``repro.core.runtime``'s result type, built from the batched
engine's open-loop and closed-loop trajectories.  Arrays are copied to
the host as numpy.  The host-loop ``ArchesRuntime`` waits for a later
slice (ROADMAP, Queue 1: host-loop path).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.telemetry import flatten_kpm_sources


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


@dataclasses.dataclass
class BatchedRunHistory:
    """Trajectory of a multi-UE campaign; every array leads with ``(S, U)``."""

    modes: np.ndarray  # (S, U) int32 -- per-UE active mode each slot
    kpms: dict[str, np.ndarray]  # name -> (S, U)
    outputs: dict[str, np.ndarray]  # tb_ok / mcs / tbs / phy_bits_per_s / ...
    decisions: np.ndarray | None = None  # (S, U) raw per-slot policy output
    n_switches: np.ndarray | None = None  # (U,) boundary transitions
    cell_of_ue: np.ndarray | None = None
    provisioned_capacity: int | None = None
    attached: np.ndarray | None = None
    bank_slot: np.ndarray | None = None

    @classmethod
    def from_trajectory(cls, modes, traj, *,
                        provisioned_capacity: int | None = None) -> "BatchedRunHistory":
        """Build from ``BatchedPuschPipeline.run`` output."""
        kpms = {k: _np(v) for k, v in flatten_kpm_sources(traj["kpms"]).items()}
        outputs = {k: _np(v) for k, v in traj.items() if k != "kpms"}
        return cls(modes=_np(modes), kpms=kpms, outputs=outputs,
                   provisioned_capacity=provisioned_capacity)

    @classmethod
    def from_closed_loop(cls, traj, final_switch=None, *,
                         provisioned_capacity: int | None = None) -> "BatchedRunHistory":
        """Build from ``BatchedPuschPipeline.run_closed_loop`` output:
        ``modes`` are the device-decided active modes."""
        extras = ("active_mode", "raw_decision", "pending_mode", "kpms")
        kpms = {k: _np(v) for k, v in flatten_kpm_sources(traj["kpms"]).items()}
        outputs = {k: _np(v) for k, v in traj.items() if k not in extras}
        return cls(
            modes=_np(traj["active_mode"]),
            kpms=kpms,
            outputs=outputs,
            decisions=_np(traj["raw_decision"]),
            n_switches=None if final_switch is None else _np(final_switch.n_switches),
            provisioned_capacity=provisioned_capacity,
        )

    @property
    def ai_share(self) -> float:
        """Fraction of slot-UEs served by the designated (AI) expert."""
        served = self.modes == 0
        for fell_back in ("gated_overflow", "audit_tripped", "health_tripped",
                          "quarantined"):
            if fell_back in self.outputs:
                served = served & (np.asarray(self.outputs[fell_back]) == 0)
        return float(np.mean(served))

    def executed_flops_per_slot(self) -> np.ndarray:
        """Per-slot realized compute, summed over UEs ((S,) float64)."""
        return np.asarray(self.outputs["executed_flops"], np.float64).sum(axis=1)

    @property
    def overflow_slot_ues(self) -> int:
        """Total GATED capacity-overflow events (0 without a gated bank)."""
        if "gated_overflow" not in self.outputs:
            return 0
        return int(np.asarray(self.outputs["gated_overflow"]).sum())

    @property
    def audit_tripped_slot_ues(self) -> int:
        """Total NMSE-audit fail-safe events: slot-UEs whose gated-expert
        output failed the audit and were served the MMSE baseline."""
        if "audit_tripped" not in self.outputs:
            return 0
        return int(np.asarray(self.outputs["audit_tripped"]).sum())


def suggest_gated_capacity(history: BatchedRunHistory, *, quantile: float = 1.0,
                           headroom: int = 0, n_shards: int = 1) -> int:
    """Pick ``gated_capacity`` from a recorded campaign's telemetry.

    Demand at slot ``s`` counts the UEs whose committed mode selected the
    designated expert, overflowed ones included, so an under-provisioned
    campaign suggests more than it ran with.  A history with an ``attached``
    residency leaf counts resident slot-UEs only.  ``quantile`` 1.0 covers
    the peak demand (a rerun overflows nothing); lower values shed the top
    demand slots to the fail-safe expert.  ``headroom`` adds UEs of margin.
    With ``n_shards`` > 1 the demand is measured per contiguous UE shard and
    the result is ``n_shards`` times the worst shard's (at least 1 each),
    clipped to the batch; otherwise it is clamped to ``[0, n_ues]``.
    """
    if not 0.0 <= quantile <= 1.0:
        raise ValueError(f"quantile {quantile} outside [0, 1]")
    modes = np.asarray(history.modes)
    n_ues = modes.shape[1]
    if n_shards < 1 or n_ues % n_shards:
        raise ValueError(f"n_shards={n_shards} does not divide n_ues={n_ues}")
    demand = modes == 0
    if history.attached is not None:
        demand = demand & np.asarray(history.attached, bool)
    per = n_ues // n_shards
    cap_shard = max(
        int(np.ceil(np.quantile(demand[:, s * per:(s + 1) * per].sum(axis=1), quantile)))
        for s in range(n_shards)
    ) + int(headroom)
    if n_shards > 1:
        return int(min(max(cap_shard, 1) * n_shards, n_ues))
    return int(np.clip(cap_shard, 0, n_ues))
