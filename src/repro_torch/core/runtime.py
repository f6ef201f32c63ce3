"""Campaign results: ``BatchedRunHistory`` (the batched result type).

The port of ``repro.core.runtime``'s result type, built from the batched
engine's open-loop and closed-loop trajectories.  Arrays are copied to
the host as numpy.  The host-loop ``ArchesRuntime`` waits for a later
slice (ROADMAP, Queue 1 item 6).
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
    def from_trajectory(cls, modes, traj) -> "BatchedRunHistory":
        """Build from ``BatchedPuschPipeline.run`` output."""
        kpms = {k: _np(v) for k, v in flatten_kpm_sources(traj["kpms"]).items()}
        outputs = {k: _np(v) for k, v in traj.items() if k != "kpms"}
        return cls(modes=_np(modes), kpms=kpms, outputs=outputs)

    @classmethod
    def from_closed_loop(cls, traj, final_switch=None) -> "BatchedRunHistory":
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
