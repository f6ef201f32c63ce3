"""The ARCHES slot loop and its results (paper Fig. 1).

Port of ``repro.core.runtime``.  ``ArchesRuntime`` has two operating points:

* the host loop (``run``), the paper's seed architecture.  Per slot n:
  1. *slot setup*: poll the E3 control inbox; a decision generated during
     slot n-1 is committed and becomes active now (slot boundary).  Stale
     control planes decay to the fail-safe mode after ``ttl_slots``.
  2. the pipeline runs with the active mode (the expert bank and the switch
     kernel inside ``slot_fn``).
  3. the slot's KPMs go to the dApp via E3; a resulting decision lands in
     the control inbox for slot n+1.
* the closed loop (``from_spec`` + ``run_batched``, which
  ``ArchesSession``'s closed-loop path runs): the decision path runs inside
  the batched engine's slot loop on the device.

``BatchedRunHistory`` is the one result type of every campaign path; arrays
are copied to the host as numpy.  ``suggest_gated_capacity`` sizes a GATED
bank from a recorded campaign.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping

import numpy as np

from repro_torch import tracing
from repro_torch.core.e3 import E3Agent, E3IndicationMessage
from repro_torch.core.switch import (
    SlotSwitchState,
    commit_decision,
    init_switch_state,
    slot_boundary,
)
from repro_torch.core.telemetry import flatten_kpm_sources


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


@dataclasses.dataclass
class SlotRecord:
    slot: int
    active_mode: int
    kpms: dict[str, float]
    output: Any = None


@dataclasses.dataclass
class RunHistory:
    """A host-loop run: one record per slot and the final switch register."""

    records: list[SlotRecord]
    final_state: SlotSwitchState

    @property
    def modes(self) -> np.ndarray:
        return np.asarray([r.active_mode for r in self.records])

    def kpm_series(self, name: str) -> np.ndarray:
        return np.asarray([r.kpms.get(name, np.nan) for r in self.records])


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
    def from_trajectory(cls, modes, traj, *, cell_of_ue=None,
                        provisioned_capacity: int | None = None) -> "BatchedRunHistory":
        """Build from ``BatchedPuschPipeline.run`` output (``cell_of_ue``: the
        topology's ``(U,)`` cell ids, for the per-cell reductions)."""
        kpms = {k: _np(v) for k, v in flatten_kpm_sources(traj["kpms"]).items()}
        outputs = {k: _np(v) for k, v in traj.items() if k != "kpms"}
        return cls(modes=_np(modes), kpms=kpms, outputs=outputs,
                   cell_of_ue=None if cell_of_ue is None else np.asarray(cell_of_ue),
                   provisioned_capacity=provisioned_capacity)

    @classmethod
    def from_closed_loop(cls, traj, final_switch=None, *, cell_of_ue=None,
                         provisioned_capacity: int | None = None) -> "BatchedRunHistory":
        """Build from ``BatchedPuschPipeline.run_closed_loop`` output:
        ``modes`` are the device-decided active modes."""
        extras = ("active_mode", "raw_decision", "pending_mode", "kpms")
        with tracing.span("campaign.history"):
            kpms = {k: _np(v) for k, v in flatten_kpm_sources(traj["kpms"]).items()}
            outputs = {k: _np(v) for k, v in traj.items() if k not in extras}
            modes, decisions = _np(traj["active_mode"]), _np(traj["raw_decision"])
            n_switches = None if final_switch is None else _np(final_switch.n_switches)
        return cls(
            modes=modes,
            kpms=kpms,
            outputs=outputs,
            decisions=decisions,
            n_switches=n_switches,
            cell_of_ue=None if cell_of_ue is None else np.asarray(cell_of_ue),
            provisioned_capacity=provisioned_capacity,
        )

    @classmethod
    def from_host(cls, hist: RunHistory) -> "BatchedRunHistory":
        """Lift a host-loop ``RunHistory`` into the batched result type: every
        array gets an ``(n_slots, 1)`` shape, and the scalar outputs
        (``tb_ok`` / ``tbs`` / ``mcs`` / ``phy_bits_per_s``) ride along when
        the run kept outputs."""
        modes = hist.modes[:, None].astype(np.int32)
        names = list(hist.records[0].kpms) if hist.records else []
        kpms = {k: np.asarray([[r.kpms.get(k, np.nan)] for r in hist.records])
                for k in names}
        outputs: dict[str, np.ndarray] = {}
        if hist.records and isinstance(hist.records[0].output, Mapping):
            for k in ("tb_ok", "tbs", "mcs", "phy_bits_per_s"):
                if k in hist.records[0].output:
                    outputs[k] = np.asarray([[float(r.output[k])] for r in hist.records])
        return cls(modes=modes, kpms=kpms, outputs=outputs)

    @property
    def n_slots(self) -> int:
        return self.modes.shape[0]

    @property
    def n_ues(self) -> int:
        return self.modes.shape[1]

    def modes_for(self, ue: int) -> np.ndarray:
        return self.modes[:, ue]

    def kpm_series(self, name: str, ue: int = 0) -> np.ndarray:
        return self.kpms[name][:, ue]

    def cell_kpm_series(self, name: str) -> np.ndarray:
        """Cell-level aggregate: per-slot mean over UEs."""
        return self.kpms[name].mean(axis=1)

    # -- per-cell reductions (multi-cell campaigns) ------------------------------

    def _cells(self) -> np.ndarray:
        if self.cell_of_ue is None:
            raise ValueError("this history has no cell layout: per-cell reductions need "
                             "a campaign run under a TopologySpec")
        return np.asarray(self.cell_of_ue)

    @property
    def n_cells(self) -> int:
        return int(self._cells().max()) + 1

    @property
    def per_cell_ai_share(self) -> np.ndarray:
        """Per-cell share of slot-UEs served by the AI expert ``(C,)``, as
        ``ai_share`` (resident slot-UEs only in a streaming history)."""
        cells = self._cells()
        served = self.modes == 0
        for fell_back in ("gated_overflow", "audit_tripped", "health_tripped",
                          "quarantined"):
            if fell_back in self.outputs:
                served = served & (np.asarray(self.outputs[fell_back]) == 0)
        if self.attached is not None:
            att = np.asarray(self.attached, bool)
            return np.asarray([
                served[:, cells == c][att[:, cells == c]].mean()
                if att[:, cells == c].any() else 0.0
                for c in range(self.n_cells)])
        return np.asarray([served[:, cells == c].mean() for c in range(self.n_cells)])

    def per_cell_kpm(self, name: str) -> np.ndarray:
        """Per-slot per-cell mean of one KPM ``(S, C)``."""
        cells = self._cells()
        v = self.kpms[name]
        return np.stack([v[:, cells == c].mean(axis=1) for c in range(self.n_cells)], axis=1)

    @property
    def per_cell_throughput(self) -> np.ndarray:
        """Per-cell mean PHY throughput over the campaign ``(C,)`` bit/s."""
        return self.per_cell_kpm("phy_throughput").mean(axis=0)

    def per_ue(self, ue: int) -> list[SlotRecord]:
        """One UE's trajectory as host-loop-style slot records."""
        return [
            SlotRecord(
                slot=s,
                active_mode=int(self.modes[s, ue]),
                kpms={k: float(v[s, ue]) for k, v in self.kpms.items()},
                output={k: v[s, ue] for k, v in self.outputs.items()},
            )
            for s in range(self.n_slots)
        ]

    @property
    def ai_share(self) -> float:
        """Fraction of slot-UEs served by the designated (AI) expert.  A
        streaming history counts resident slot-UEs only."""
        served = self.modes == 0
        for fell_back in ("gated_overflow", "audit_tripped", "health_tripped",
                          "quarantined"):
            if fell_back in self.outputs:
                served = served & (np.asarray(self.outputs[fell_back]) == 0)
        if self.attached is not None:
            att = np.asarray(self.attached, bool)
            return float(served[att].mean()) if att.any() else 0.0
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

    @property
    def health_tripped_slot_ues(self) -> int:
        """Total health-screen events: slot-UEs whose AI estimate was not
        finite and was served the fail-safe baseline (0 without faults)."""
        if "health_tripped" not in self.outputs:
            return 0
        return int(np.asarray(self.outputs["health_tripped"]).sum())

    @property
    def quarantined_slot_ues(self) -> int:
        """Total slot-UEs that started under the breaker's quarantine."""
        if "quarantined" not in self.outputs:
            return 0
        return int((np.asarray(self.outputs["quarantined"]) > 0).sum())

    def resident_ues_per_slot(self) -> np.ndarray:
        """Resident UEs per slot ((S,) int64; the whole batch without churn)."""
        if self.attached is None:
            return np.full(self.n_slots, self.n_ues, np.int64)
        return np.asarray(self.attached, bool).sum(axis=1)


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


def replay_batched_telemetry(agent: E3Agent, traj, *, n_slots: int | None = None) -> int:
    """Replay a batched trajectory's KPMs as per-slot E3 indications.

    Each slot's KPMs are averaged over UEs (the cell-level mean) and pushed
    through the same E3 path the host loop uses, so dApp subscriptions see
    batched campaigns unchanged.  Every array is copied to the host once.
    Returns the number of slots replayed.
    """
    host = {source: {k: _np(v) for k, v in kpms.items()}
            for source, kpms in traj["kpms"].items()}
    first = next(iter(next(iter(host.values())).values()))
    n = int(first.shape[0]) if n_slots is None else n_slots
    for s in range(n):
        for source, kpms in host.items():
            vals = {k: float(np.mean(v[s])) for k, v in kpms.items()}
            agent.indicate(E3IndicationMessage(slot=s, source=source, kpms=vals))
    return n


class ArchesRuntime:
    """Slot loop wiring pipeline, E3 agent and switch register.

    * **host loop** (``run``): per-slot Python loop; decisions travel E3
      agent -> dApp -> control inbox and commit at the next slot boundary
      (``SlotSwitchState``).
    * **closed loop** (``closed_loop=True`` + ``run_batched``): the exported
      policy tables and the switch register run inside the batched engine's
      slot loop.
    """

    def __init__(
        self,
        slot_fn: Callable[..., tuple[Any, Any, Mapping[str, Mapping[str, float]]]]
        | None = None,
        agent: E3Agent | None = None,
        *,
        default_mode: int | None = None,
        fail_safe_mode: int | None = None,
        ttl_slots: int = 16,
        keep_outputs: bool = False,
        closed_loop: bool = False,
        engine: Any = None,
        device_policy: Any = None,
        switch_config: Any = None,
    ):
        """``slot_fn(active_mode, carry, slot_input) ->
        (carry, output, {source: {kpm: value}})``, with ``active_mode`` an int.

        With ``closed_loop=True``, ``engine`` (a ``BatchedPuschPipeline``),
        ``device_policy`` and ``switch_config`` replace ``slot_fn``
        (``from_spec`` builds them from a spec).  ``default_mode`` /
        ``fail_safe_mode`` default to the switch config's ``default_mode`` in
        the closed loop and to mode 1 in the host loop.
        """
        if closed_loop and (engine is None or device_policy is None
                            or switch_config is None):
            raise ValueError("closed_loop=True needs engine, device_policy and "
                             "switch_config")
        if default_mode is None:
            default_mode = (int(getattr(switch_config, "default_mode", 1))
                            if closed_loop and switch_config is not None else 1)
        if fail_safe_mode is None:
            fail_safe_mode = default_mode
        self.slot_fn = slot_fn
        self.agent = agent
        self.default_mode = default_mode
        self.fail_safe_mode = fail_safe_mode
        self.ttl_slots = ttl_slots
        self.keep_outputs = keep_outputs
        self.closed_loop = closed_loop
        self.engine = engine
        self.device_policy = device_policy
        self.switch_config = switch_config

    @classmethod
    def from_spec(cls, spec, *, engine: Any = None, device_policy: Any = None,
                  agent: E3Agent | None = None, device: Any = "cuda") -> "ArchesRuntime":
        """A closed-loop runtime from a ``CampaignSpec``: the switch config
        comes from ``spec.switch`` / ``spec.feature_names``, and what is not
        passed in (engine, exported policy) is built by an ``ArchesSession``
        on ``device``.  ``agent`` receives the KPMs of a ``run_batched(...,
        replay_telemetry=True)``."""
        if engine is None or device_policy is None:
            from repro_torch.core.session import ArchesSession

            session = ArchesSession(spec, engine=engine,
                                    device=engine.device if engine is not None else device)
            engine = engine if engine is not None else session.engine
            if device_policy is None:
                device_policy = session.device_policy
        sw_cfg = spec.switch.to_config(spec.feature_names)
        return cls(agent=agent, default_mode=sw_cfg.default_mode,
                   fail_safe_mode=sw_cfg.default_mode, ttl_slots=spec.switch.ttl_slots,
                   closed_loop=True, engine=engine, device_policy=device_policy,
                   switch_config=sw_cfg)

    def run_batched(self, schedule, *, n_slots: int, n_ues: int, key=None, ue_keys=None,
                    replay_telemetry: bool = False,
                    provisioned_capacity: int | None = None,
                    faults=None) -> BatchedRunHistory:
        """Closed-loop batched campaign: device-decided modes in one slot loop.
        ``ue_keys (U, ...)`` replace the keys folded from ``key``; with
        ``replay_telemetry=True`` the campaign's KPMs go through the agent
        after the run (``replay_batched_telemetry``), so the dApp's
        subscriptions see it; ``provisioned_capacity`` is recorded in the
        history as given; ``faults`` (a ``FaultSpec``) arms the degradation
        ladder."""
        if not self.closed_loop:
            raise RuntimeError("run_batched requires closed_loop=True")
        _, final_switch, traj = self.engine.run_closed_loop(
            schedule, self.device_policy, self.switch_config, n_slots=n_slots,
            n_ues=n_ues, key=key, ue_keys=ue_keys, faults=faults)
        if replay_telemetry and self.agent is not None:
            replay_batched_telemetry(self.agent, traj)
        return BatchedRunHistory.from_closed_loop(
            traj, final_switch, provisioned_capacity=provisioned_capacity)

    def run(self, inputs: Iterable[Any], carry: Any = None) -> RunHistory:
        """The host loop over ``inputs`` (one per slot)."""
        if self.slot_fn is None or self.agent is None:
            raise RuntimeError("the host loop needs slot_fn and agent")
        state = init_switch_state(self.default_mode)
        records: list[SlotRecord] = []
        for slot, x in enumerate(inputs):
            # -- slot setup phase --
            ctrl = self.agent.poll_control()
            if ctrl is not None:
                state = commit_decision(state, ctrl.mode)
            state = slot_boundary(state, fail_safe_mode=self.fail_safe_mode,
                                  ttl_slots=self.ttl_slots)
            # -- pipeline execution --
            carry, output, kpms_by_source = self.slot_fn(state.active_mode, carry, x)
            # -- telemetry indication --
            flat: dict[str, float] = {}
            for source, kpms in kpms_by_source.items():
                kpms_f = {k: float(v) for k, v in kpms.items()}
                flat.update(kpms_f)
                self.agent.indicate(E3IndicationMessage(slot=slot, source=source,
                                                        kpms=kpms_f))
            records.append(SlotRecord(slot=slot, active_mode=state.active_mode, kpms=flat,
                                      output=output if self.keep_outputs else None))
        return RunHistory(records=records, final_state=state)
