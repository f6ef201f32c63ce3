"""ArchesSession: one declarative entry point for a campaign.

    spec = CampaignSpec(path="closed_loop", scenario="good_poor_good",
                        n_ues=4, n_slots=30, policies=(PolicySpec(kind="tree"),))
    hist = ArchesSession(spec, device="cuda").run()   # -> BatchedRunHistory

``CampaignSpec`` and its parts keep every field of the reference's spec
tree with the same names and defaults, so ``to_json`` and ``spec_hash``
are identical for the same campaign and one JSON spec drives both
packages.  ``use_pallas_switch`` keeps its name and means "use the
hand-written switch kernel"; ``SwitchSpec.backend`` takes the reference's
values, with ``"pallas"`` meaning the hand-written tree kernel.

Every execution path runs:

* ``host`` -- the seed architecture: a per-slot Python loop whose decisions
  travel E3 agent -> dApp -> control inbox (one UE);
* ``batched`` -- the open-loop multi-UE loop over a declared mode plan;
* ``closed_loop`` -- the decision path inside the device slot loop;
* ``gated`` -- open loop with compaction-gated expert execution;
* ``perturbed`` -- the methodology's stage-1 sweep (``rho`` rides the UE
  axis),

on CONCURRENT, SELECTED_ONLY and GATED banks (fused or not, float32 or
bf16 experts, with the NMSE audit), and ``run(auto_capacity=True)``.
``faults`` (a ``FaultSpec``) arms the degradation ladder on the batched,
gated and closed-loop paths; ``churn`` (a ``ChurnSchedule``) makes the
campaign a streaming one (``run_streaming``, ``repro_torch.core.streaming``).
``topology`` (a ``TopologySpec``) runs the campaign as ``n_cells`` coupled
cells, its UE axis split over the ranks of the default ``torch.distributed``
group (``repro_torch.core.topology``; one shard without a group): per-shard
GATED compaction, one ``all_reduce`` of the cell loads a slot, and the
history gains the per-cell reductions.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import tracing
from repro_torch.core.closed_loop import SwitchConfig, per_ue_policy
from repro_torch.core.expert_bank import ExecutionMode, coerce_enum
from repro_torch.core.faults import FaultSpec
from repro_torch.core.runtime import (
    ArchesRuntime,
    BatchedRunHistory,
    suggest_gated_capacity,
)
from repro_torch.core.streaming import ChurnSchedule
from repro_torch.core.telemetry import SELECTED_KPMS
from repro_torch.core.topology import (
    CellTopology,
    TopologySpec,
    per_shard_capacity,
    rank_device,
)
from repro_torch.device import resolve_device


class ExecutionPath(enum.Enum):
    """The campaign shapes ``ArchesSession.run`` dispatches over."""

    HOST = "host"
    BATCHED = "batched"
    CLOSED_LOOP = "closed_loop"
    GATED = "gated"
    PERTURBED = "perturbed"

    @classmethod
    def coerce(cls, value: "ExecutionPath | str") -> "ExecutionPath":
        return coerce_enum(cls, value, "execution path")


def _tuplify(x):
    """Recursively normalize to the spec's JSON-stable form: lists, arrays
    and tensors become tuples, numpy scalars become Python scalars."""
    if isinstance(x, (list, tuple)):
        return tuple(_tuplify(v) for v in x)
    if isinstance(x, torch.Tensor):
        return _tuplify(x.detach().cpu().numpy().tolist())
    if isinstance(x, np.ndarray):
        return _tuplify(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


@dataclasses.dataclass(frozen=True)
class ExpertBankSpec:
    """Expert-bank + AI-estimator configuration (one bank per campaign)."""

    execution_mode: str = "concurrent"
    gated_capacity: int | None = None
    use_pallas_switch: bool = True
    channels: int = 8
    n_res_blocks: int = 1
    params_seed: int = 0
    fused: bool = False
    dtype: str = "float32"
    audit_nmse_threshold: float | None = None

    def __post_init__(self):
        object.__setattr__(self, "execution_mode",
                           ExecutionMode.coerce(self.execution_mode).value)
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {self.dtype!r}; one of 'float32', 'bfloat16'")
        mode = ExecutionMode.coerce(self.execution_mode)
        if self.fused and mode is not ExecutionMode.GATED:
            raise ValueError("fused=True requires execution_mode='gated'")
        if self.audit_nmse_threshold is not None:
            if mode is not ExecutionMode.GATED:
                raise ValueError("audit_nmse_threshold requires execution_mode='gated'")
            if not self.audit_nmse_threshold > 0:
                raise ValueError(
                    f"audit_nmse_threshold {self.audit_nmse_threshold} must be > 0")


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """One switching policy: a profiled Gini ``tree`` or a ``threshold`` gate."""

    kind: str = "tree"
    depth: int = 2
    train_slots: int | None = None
    train_ues: int = 2
    train_scenario: str | None = None
    train_scenario_args: tuple = ()
    feature: str = "snr"
    threshold: float = 18.0
    hysteresis: float = 0.0
    mode_above: int = 1
    mode_below: int = 0

    def __post_init__(self):
        if self.kind not in ("tree", "threshold"):
            raise ValueError(f"unknown policy kind {self.kind!r}")
        object.__setattr__(self, "train_scenario_args",
                           _tuplify(self.train_scenario_args))


@dataclasses.dataclass(frozen=True)
class SwitchSpec:
    """Declarative form of ``SwitchConfig``."""

    window_slots: int = 8
    hysteresis_slots: int = 1
    period_slots: int = 1
    default_mode: int = 1
    backend: str = "auto"
    ttl_slots: int = 16

    def __post_init__(self):
        if self.backend not in ("auto", "pallas", "cuda", "ref"):
            raise ValueError(f"unknown switch backend {self.backend!r}")

    def to_config(self, feature_names: Sequence[str]) -> SwitchConfig:
        return SwitchConfig(
            feature_names=tuple(feature_names),
            window_slots=self.window_slots,
            hysteresis_slots=self.hysteresis_slots,
            period_slots=self.period_slots,
            default_mode=self.default_mode,
            backend=self.backend,
            ttl_slots=self.ttl_slots,
        )


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """A whole campaign as data: serialize it, hash it, run it.

    Same fields, defaults and normalization as the reference's spec.
    ``churn`` (a ``ChurnSchedule`` or its dict form) turns the campaign into
    a streaming one: ``n_ues`` becomes the bank capacity and the history's
    UE axis the schedule's stable ids.  ``faults`` (a ``FaultSpec`` or its
    dict form) injects decision loss, expert corruption and telemetry loss
    on the batched, gated and closed-loop paths; ``FaultSpec()`` is bitwise
    the same as ``None``.  ``topology`` (a ``TopologySpec`` or its dict
    form) lays the campaign out as coupled cells over shards.
    """

    path: str = "batched"
    scenario: str = "good_poor_good"
    scenario_args: tuple = ()
    n_ues: int = 4
    n_slots: int = 30
    n_prb: int = 24
    seed: int = 0
    modes: Any = 1
    bank: ExpertBankSpec = dataclasses.field(default_factory=ExpertBankSpec)
    policies: tuple = ()
    policy_assignment: tuple | None = None
    switch: SwitchSpec = dataclasses.field(default_factory=SwitchSpec)
    feature_names: tuple = SELECTED_KPMS
    rho: tuple | None = None
    topology: TopologySpec | None = None
    churn: ChurnSchedule | None = None
    faults: FaultSpec | None = None

    def __post_init__(self):
        object.__setattr__(self, "path", ExecutionPath.coerce(self.path).value)
        if self.topology is not None and not isinstance(self.topology, TopologySpec):
            object.__setattr__(self, "topology", TopologySpec(**dict(self.topology)))
        if self.churn is not None and not isinstance(self.churn, ChurnSchedule):
            object.__setattr__(self, "churn", ChurnSchedule(**dict(self.churn)))
        if self.faults is not None and not isinstance(self.faults, FaultSpec):
            object.__setattr__(self, "faults", FaultSpec(**dict(self.faults)))
        for name in ("scenario_args", "policies", "feature_names"):
            object.__setattr__(self, name, _tuplify(getattr(self, name)))
        object.__setattr__(self, "modes", _tuplify(self.modes))
        for name in ("policy_assignment", "rho"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, _tuplify(v))
        if self.n_ues < 1 or self.n_slots < 1:
            raise ValueError("n_ues and n_slots must be >= 1")
        for k, _ in self.scenario_args:
            if not isinstance(k, str):
                raise ValueError("scenario_args must be (name, value) pairs")
        if self.policy_assignment is not None:
            if not self.policies:
                raise ValueError("policy_assignment indexes spec.policies, which is empty")
            if len(self.policy_assignment) != self.n_ues:
                raise ValueError(
                    f"policy_assignment has {len(self.policy_assignment)} "
                    f"entries for n_ues={self.n_ues}")
            if not all(0 <= int(i) < len(self.policies) for i in self.policy_assignment):
                raise ValueError("policy_assignment indexes out of range")
        # path/bank mismatches fail at spec construction, as in the reference
        bank_mode = ExecutionMode.coerce(self.bank.execution_mode)
        path = self.execution_path
        if path is ExecutionPath.GATED and bank_mode is ExecutionMode.SELECTED_ONLY:
            raise ValueError(
                "path='gated' with a 'selected_only' bank would silently run "
                "un-gated at the concurrent cost envelope; declare the bank "
                "'gated' (or 'concurrent', which the path normalizes)")
        if path is ExecutionPath.PERTURBED and bank_mode is not ExecutionMode.CONCURRENT:
            raise ValueError(
                f"path='perturbed' ignores the expert bank; a {bank_mode.value!r} "
                "bank spec would never take effect -- drop it")
        if path is ExecutionPath.HOST and bank_mode is ExecutionMode.GATED:
            raise ValueError("gated execution is the batched path: the host loop "
                             "serves one UE and has no sub-batch to compact")
        device_paths = (ExecutionPath.BATCHED, ExecutionPath.GATED, ExecutionPath.CLOSED_LOOP)
        if self.topology is not None:
            if path is ExecutionPath.HOST:
                raise ValueError("a sharded topology needs a batched path: the host loop "
                                 "serves one UE on one device")
            if self.n_ues % self.topology.n_cells:
                raise ValueError(f"topology n_cells={self.topology.n_cells} does not divide "
                                 f"n_ues={self.n_ues}")
        if self.churn is not None:
            if path not in device_paths:
                raise ValueError(
                    f"churn campaigns stream the batched loop; path={self.path!r} has no "
                    "segmented form (the host loop serves one pinned UE, the perturbed "
                    "sweep has no notion of churn)")
            if self.policy_assignment is not None:
                raise ValueError(
                    "policy_assignment is bank-slot-indexed; a churn campaign re-packs "
                    "bank slots, so per-UE policy heterogeneity under churn is not "
                    "supported -- declare one shared policy")
            self.churn.validate(self.n_slots, self.n_ues,
                                n_cells=1 if self.topology is None else self.topology.n_cells)
        if self.faults is not None and path not in device_paths:
            raise ValueError(
                f"fault injection targets the device slot loop; path={self.path!r} has "
                "no fault machinery (the host loop models dApp failure via DApp.fail(), "
                "the perturbed sweep is MMSE-only)")

    @property
    def execution_path(self) -> ExecutionPath:
        return ExecutionPath.coerce(self.path)

    @property
    def scenario_kwargs(self) -> dict:
        return dict(self.scenario_args)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CampaignSpec":
        d = dict(d)
        if "bank" in d and not isinstance(d["bank"], ExpertBankSpec):
            d["bank"] = ExpertBankSpec(**d["bank"])
        if "switch" in d and not isinstance(d["switch"], SwitchSpec):
            d["switch"] = SwitchSpec(**d["switch"])
        if "policies" in d:
            d["policies"] = tuple(p if isinstance(p, PolicySpec) else PolicySpec(**p)
                                  for p in d["policies"])
        return cls(**d)

    def to_json(self) -> str:
        """Canonical JSON (sorted keys) -- the provenance string."""
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CampaignSpec":
        return cls.from_dict(json.loads(s))


def spec_hash(spec: CampaignSpec) -> str:
    """Short stable fingerprint of a spec's canonical JSON."""
    return hashlib.sha256(spec.to_json().encode()).hexdigest()[:16]


def as_streaming_spec(spec: CampaignSpec, *, max_segment_slots: int = 8) -> CampaignSpec:
    """Lift a monolithic campaign spec into its streaming form.

    A spec that declares ``churn`` comes back unchanged.  A churn-free
    batched, gated or closed-loop spec gains a full-residency
    ``ChurnSchedule`` (every bank slot attached at slot 0, no events) whose
    segment length is the largest divisor of ``n_slots`` up to
    ``max_segment_slots``, so the segmented executor runs it in
    checkpointable segments, bitwise the same as the monolithic ``run()``.
    """
    if spec.churn is not None:
        return spec
    if spec.execution_path not in (ExecutionPath.BATCHED, ExecutionPath.GATED,
                                   ExecutionPath.CLOSED_LOOP):
        raise ValueError(f"path={spec.path!r} has no streaming form (the host loop serves "
                         "one pinned UE, the perturbed sweep has no segmented executor)")
    if max_segment_slots < 1:
        raise ValueError(f"max_segment_slots {max_segment_slots} must be >= 1")
    seg = max(d for d in range(1, min(max_segment_slots, spec.n_slots) + 1)
              if spec.n_slots % d == 0)
    return dataclasses.replace(spec, churn=ChurnSchedule(
        n_ue_ids=spec.n_ues, segment_slots=seg, initial=tuple(range(spec.n_ues))))


class ArchesSession:
    """Compile a ``CampaignSpec`` into runnable components and run it.

    ``device`` defaults to the card.  AI weights are drawn from
    ``bank.params_seed`` with the ported PRNG on the host (so every device
    gets the same weights) unless ``ai_params`` (the port's weight dict,
    e.g. from ``repro_torch.convert``) is given; ``host_policies``
    overrides the trained/built policy objects; ``engine`` reuses a built
    engine.  ``run()`` returns a ``BatchedRunHistory``; after a host run,
    ``dapp`` is that run's ``DApp`` (its ``decisions`` carry the measured
    policy times).  A churn campaign's scenario is instantiated over the
    stable-id universe, so channel conditions follow the UE, not its bank
    slot.  ``cell_topology`` is the resolved multi-cell layout (None: one
    cell on one rank); under one, every rank of the group builds the same
    session and runs its shard, and each returns the whole campaign.
    """

    def __init__(self, spec: CampaignSpec, *, device: torch.device | str = "cuda",
                 ai_params: Any = None, host_policies: Sequence | None = None,
                 engine: Any = None):
        from repro_torch.phy.nr import SlotConfig
        from repro_torch.phy.scenario import get_scenario

        self.spec = spec
        self.path = spec.execution_path
        self.device = resolve_device(device)
        self.cell_topology = (CellTopology.build(spec.topology, spec.n_ues)
                              if spec.topology is not None else None)
        if self.cell_topology is not None:
            self.device = rank_device(self.device)
        self._validate()
        self.cfg = SlotConfig(n_prb=spec.n_prb)
        scenario = get_scenario(spec.scenario)
        n_scenario_ues = spec.churn.n_ue_ids if spec.churn is not None else spec.n_ues
        self.schedule = scenario.schedule(
            n_ues=n_scenario_ues if scenario.per_ue else None, **spec.scenario_kwargs)
        self._ai_params = ai_params
        self._host_policies = tuple(host_policies) if host_policies is not None else None
        self._engine = engine
        self._train_engine = None
        self._pipeline = None
        self._device_policy = None
        self.dapp = None

    def _validate(self) -> None:
        from repro_torch.phy.scenario import get_scenario

        spec, path = self.spec, self.path
        bank_mode = ExecutionMode.coerce(spec.bank.execution_mode)
        if len(spec.policies) > 1 and spec.policy_assignment is None:
            raise ValueError("several policies need an explicit policy_assignment "
                             "(which UE runs which table)")
        if path is ExecutionPath.HOST:
            if spec.n_ues != 1:
                raise ValueError("the host loop serves one UE: n_ues must be 1")
            if not spec.policies:
                raise ValueError("the host loop needs one PolicySpec")
            if get_scenario(spec.scenario).per_ue:
                raise ValueError(f"scenario {spec.scenario!r} is per-UE; the host path "
                                 "needs a homogeneous scenario")
            if spec.switch.hysteresis_slots != 1:
                raise ValueError("the host E3/dApp loop has no hysteresis streak; "
                                 "hysteresis_slots > 1 needs the closed_loop path")
        if path is ExecutionPath.CLOSED_LOOP and not spec.policies:
            raise ValueError("closed_loop needs at least one PolicySpec")
        if path is ExecutionPath.PERTURBED:
            if spec.rho is None:
                raise ValueError("perturbed needs a rho grid")
            if len(spec.rho) != spec.n_ues:
                raise ValueError(f"rho rides the UE axis: len(rho)={len(spec.rho)} "
                                 f"must equal n_ues={spec.n_ues}")
        # the path name is the declaration: "gated" implies a gated bank
        # (normalized on the session, never mutating the user's spec)
        self.bank_spec = (
            dataclasses.replace(spec.bank, execution_mode="gated")
            if path is ExecutionPath.GATED and bank_mode is ExecutionMode.CONCURRENT
            else spec.bank)
        topo = self.cell_topology
        if topo is not None:
            if self._gated and self.bank_spec.gated_capacity is not None:
                per_shard_capacity(self.bank_spec.gated_capacity, topo.n_shards)
            declared_cells = spec.scenario_kwargs.get("n_cells")
            if declared_cells is None:
                # a cell-aware scenario not passed n_cells lays out its default
                import inspect

                p = inspect.signature(get_scenario(spec.scenario).factory).parameters.get(
                    "n_cells")
                if p is not None and p.default is not inspect.Parameter.empty:
                    declared_cells = p.default
            if declared_cells is not None and declared_cells != topo.n_cells:
                raise ValueError(
                    f"scenario lays out n_cells={declared_cells} but the topology lays out "
                    f"{topo.n_cells} cells: one cell count per campaign (pass n_cells in "
                    "scenario_args)")

    @property
    def _gated(self) -> bool:
        return ExecutionMode.coerce(self.bank_spec.execution_mode) is ExecutionMode.GATED

    @property
    def _cells(self):
        return None if self.cell_topology is None else self.cell_topology.cell_of_ue

    # -- compiled components ---------------------------------------------------

    @property
    def net(self):
        from repro_torch.phy.ai_estimator import AiEstimatorConfig

        return AiEstimatorConfig(channels=self.bank_spec.channels,
                                 n_res_blocks=self.bank_spec.n_res_blocks)

    @property
    def ai_params(self):
        if self._ai_params is None:
            from repro_torch.phy.ai_estimator import init_params

            self._ai_params = init_params(jr.PRNGKey(self.bank_spec.params_seed),
                                          self.cfg, self.net)
        return self._ai_params

    def _engine_capacity(self, campaign_capacity: int | None) -> int | None:
        """The engine's GATED capacity for a campaign-wide one: compaction is
        shard-local, so under a topology it is the per-shard share."""
        if campaign_capacity is None or self.cell_topology is None or not self._gated:
            return campaign_capacity
        return per_shard_capacity(campaign_capacity, self.cell_topology.n_shards)

    def _build_engine(self, campaign_capacity: int | None):
        from repro_torch.phy.pipeline import BatchedPuschPipeline

        bank = self.bank_spec
        return BatchedPuschPipeline(
            self.cfg, self.ai_params, net=self.net,
            execution_mode=ExecutionMode.coerce(bank.execution_mode),
            use_pallas_switch=bank.use_pallas_switch,
            gated_capacity=self._engine_capacity(campaign_capacity), fused_gated=bank.fused,
            expert_dtype=bank.dtype, audit_nmse_threshold=bank.audit_nmse_threshold,
            device=self.device,
        )

    @property
    def engine(self):
        """The batched multi-UE engine configured per the bank spec."""
        if self._engine is None:
            self._engine = self._build_engine(self.bank_spec.gated_capacity)
        return self._engine

    @property
    def pipeline(self):
        """The single-UE host pipeline (host path only)."""
        if self._pipeline is None:
            from repro_torch.phy.pipeline import PuschPipeline

            bank = self.bank_spec
            self._pipeline = PuschPipeline(
                self.cfg, self.ai_params, net=self.net,
                execution_mode=ExecutionMode.coerce(bank.execution_mode),
                use_pallas_switch=bank.use_pallas_switch, device=self.device)
        return self._pipeline

    def _training_engine(self):
        """A CONCURRENT engine for profiling the experts (the campaign's own
        engine when its bank is CONCURRENT)."""
        if ExecutionMode.coerce(self.bank_spec.execution_mode) is ExecutionMode.CONCURRENT:
            return self.engine
        if self._train_engine is None:
            from repro_torch.phy.pipeline import BatchedPuschPipeline

            self._train_engine = BatchedPuschPipeline(
                self.cfg, self.ai_params, net=self.net,
                execution_mode=ExecutionMode.CONCURRENT,
                use_pallas_switch=self.bank_spec.use_pallas_switch, device=self.device)
        return self._train_engine

    def _train_schedule(self, ps: PolicySpec):
        from repro_torch.phy.scenario import get_scenario, good_poor_good_schedule

        if ps.train_scenario is not None:
            sc = get_scenario(ps.train_scenario)
            if sc.per_ue:
                raise ValueError(
                    f"train_scenario {ps.train_scenario!r} is per-UE; "
                    "policies train on one labelled condition stream")
            return sc.schedule(**dict(ps.train_scenario_args))
        if callable(self.schedule):
            return self.schedule
        n = ps.train_slots or self.spec.n_slots
        return good_poor_good_schedule(poor_start=n // 3, poor_end=2 * n // 3)

    @property
    def host_policies(self) -> tuple:
        """The host policy objects, trained/built per ``spec.policies``."""
        if self._host_policies is None:
            from repro_torch.core.policy import ThresholdPolicy, profile_and_fit_tree

            built = []
            for ps in self.spec.policies:
                if ps.kind == "threshold":
                    built.append(ThresholdPolicy(
                        feature_idx=self.spec.feature_names.index(ps.feature),
                        threshold=ps.threshold, hysteresis=ps.hysteresis,
                        mode_above=ps.mode_above, mode_below=ps.mode_below))
                else:
                    built.append(profile_and_fit_tree(
                        self._training_engine(), self._train_schedule(ps),
                        n_slots=ps.train_slots or self.spec.n_slots,
                        n_ues=ps.train_ues, depth=ps.depth,
                        feature_names=self.spec.feature_names))
            self._host_policies = tuple(built)
        return self._host_policies

    @property
    def device_policy(self):
        """Exported device tables: one table, or a per-UE ``PerUEPolicy``."""
        if self._device_policy is None:
            spec = self.spec
            tables = tuple(p.to_device(self.device) for p in self.host_policies)
            if len(tables) == 1 and spec.policy_assignment is None:
                self._device_policy = tables[0]
            else:
                if spec.policy_assignment is None:
                    raise ValueError("several policies need an explicit policy_assignment")
                self._device_policy = per_ue_policy(tables, spec.policy_assignment,
                                                    self.device)
        return self._device_policy

    def host_replay(self, hist: BatchedRunHistory) -> dict:
        """Replay a closed-loop history through the host policy objects;
        compare ``hist.modes`` with ``result["active_mode"]``.  Under faults
        the device's recorded health and audit trips drive the oracle's
        breaker; a streaming history's ``attached`` leaf drives its
        detach and cold-start."""
        from repro_torch.core.closed_loop import host_replay_closed_loop

        spec = self.spec
        feats = np.stack([hist.kpms[n] for n in spec.feature_names],
                         axis=-1).astype(np.float32)
        sw_cfg = spec.switch.to_config(spec.feature_names)
        trips = None
        if spec.faults is not None:
            trips = np.zeros(hist.modes.shape, bool)
            for k in ("health_tripped", "audit_tripped"):
                if k in hist.outputs:
                    trips |= np.asarray(hist.outputs[k]) > 0
        kw = dict(faults=spec.faults, trips=trips, attached=hist.attached)
        if len(self.host_policies) == 1 and spec.policy_assignment is None:
            return host_replay_closed_loop(self.host_policies[0], feats, sw_cfg, **kw)
        assignment = (spec.policy_assignment if spec.policy_assignment is not None
                      else (0,) * spec.n_ues)
        return host_replay_closed_loop(list(self.host_policies), feats, sw_cfg,
                                       policy_idx=assignment, **kw)

    # -- execution -------------------------------------------------------------

    def run(self, *, auto_capacity: bool = False) -> BatchedRunHistory:
        """Execute the campaign; one result type for every path.

        ``auto_capacity=True`` (GATED banks only) sizes ``gated_capacity``
        from the campaign's own demand before the main run: the open-loop
        paths read the peak demand off the declared mode plan; the closed
        loop runs a full-capacity pre-pass and sizes from the demand its
        decisions realized (``suggest_gated_capacity``).  The history
        records the chosen capacity in ``provisioned_capacity``.

        The campaign is a ``campaign`` span (``repro_torch.tracing``); in
        the closed loop the engine's and the device policy's construction
        is ``session.build``, and the loop's set-up ``campaign.init``.
        """
        with tracing.span("campaign", self.device):
            if auto_capacity:
                return self._run_auto_capacity()
            if self.spec.churn is not None:
                return self.run_streaming()
            runner = {
                ExecutionPath.HOST: self._run_host,
                ExecutionPath.BATCHED: self._run_open_loop,
                ExecutionPath.GATED: self._run_open_loop,
                ExecutionPath.CLOSED_LOOP: self._run_closed_loop,
                ExecutionPath.PERTURBED: self._run_perturbed,
            }[self.path]
            return runner()

    def _run_auto_capacity(self) -> BatchedRunHistory:
        spec = self.spec
        if ExecutionMode.coerce(self.bank_spec.execution_mode) is not ExecutionMode.GATED:
            raise ValueError("auto_capacity sizes a gated bank; this campaign's bank is "
                             f"{self.bank_spec.execution_mode!r}")
        if self.path is ExecutionPath.CLOSED_LOOP:
            # pre-pass at full capacity (no overflow), then size from the
            # demand the decisions actually realized
            pre_spec = dataclasses.replace(
                spec, bank=dataclasses.replace(spec.bank, gated_capacity=None))
            demand_hist = ArchesSession(pre_spec, device=self.device,
                                        ai_params=self.ai_params,
                                        host_policies=self.host_policies).run()
        else:
            from repro_torch.phy.pipeline import normalize_modes

            # open loop: the demand is the declared plan, no pre-pass; under
            # churn it lives on the stable-id axis and only resident
            # slot-UEs claim capacity
            n_axis = spec.churn.n_ue_ids if spec.churn is not None else spec.n_ues
            modes = normalize_modes(np.asarray(spec.modes, np.int32), spec.n_slots, n_axis)
            demand_hist = BatchedRunHistory(
                modes=modes.numpy(), kpms={}, outputs={},
                attached=None if spec.churn is None else spec.churn.residency(spec.n_slots))
        n_shards = 1 if self.cell_topology is None else self.cell_topology.n_shards
        if spec.churn is not None:
            # the demand lives on the stable-id axis, which need not split across
            # bank shards: size from the resident demand, round up to an equal
            # share a shard and clip to the bank
            cap = suggest_gated_capacity(demand_hist)
            cap = min(max(-(-cap // n_shards), 1) * n_shards, spec.n_ues)
        else:
            # compaction is shard-local: cover the worst shard's peak demand,
            # one row a shard at least
            cap = max(suggest_gated_capacity(demand_hist, n_shards=n_shards), n_shards)
        self._engine = self._build_engine(cap)
        if spec.churn is not None:
            return dataclasses.replace(self.run_streaming(), provisioned_capacity=cap)
        if self.path is ExecutionPath.CLOSED_LOOP:
            return self._run_closed_loop(provisioned_capacity=cap)
        return self._run_open_loop(provisioned_capacity=cap)

    def run_streaming(self, churn=None, *, checkpoint_dir=None, resume_from=None,
                      max_segments=None, on_segment=None, pipeline=True,
                      checkpoint_format="delta", stats=None) -> BatchedRunHistory:
        """Epoch-chunked streaming campaign: attach and detach under churn.

        Runs the slot loop in fixed-length segments over the ``n_ues``-slot
        bank, with an admission pass at each segment boundary
        (``repro_torch.core.streaming.run_streaming``, which documents every
        option).  ``churn`` overrides the spec's schedule for this run and
        reuses this session's AI weights, engine and policies.  Returns a
        ``BatchedRunHistory`` on the stable-id axis.
        """
        from repro_torch.core import streaming

        kw = dict(checkpoint_dir=checkpoint_dir, resume_from=resume_from,
                  max_segments=max_segments, on_segment=on_segment, pipeline=pipeline,
                  checkpoint_format=checkpoint_format, stats=stats)
        if churn is not None:
            if not isinstance(churn, ChurnSchedule):
                churn = ChurnSchedule(**dict(churn))
            if churn != self.spec.churn:
                fresh = ArchesSession(dataclasses.replace(self.spec, churn=churn),
                                      device=self.device, ai_params=self._ai_params,
                                      host_policies=self._host_policies, engine=self._engine)
                return streaming.run_streaming(fresh, **kw)
        if self.spec.churn is None:
            raise ValueError("run_streaming needs a ChurnSchedule: set spec.churn or "
                             "pass churn=...")
        return streaming.run_streaming(self, **kw)

    def _run_open_loop(self, provisioned_capacity: int | None = None) -> BatchedRunHistory:
        from repro_torch.phy.pipeline import normalize_modes

        spec = self.spec
        modes = normalize_modes(np.asarray(spec.modes, np.int32), spec.n_slots,
                                spec.n_ues, self.device)
        key = jr.PRNGKey(spec.seed, self.device)
        if self.cell_topology is not None:
            from repro_torch.core.topology import run_sharded

            _, traj = run_sharded(self.engine, self.cell_topology, self.schedule, modes,
                                  n_slots=spec.n_slots, key=key, faults=spec.faults)
        else:
            _, traj = self.engine.run(self.schedule, modes, n_slots=spec.n_slots,
                                      n_ues=spec.n_ues, key=key, faults=spec.faults)
        return BatchedRunHistory.from_trajectory(modes, traj, cell_of_ue=self._cells,
                                                 provisioned_capacity=provisioned_capacity)

    def _run_closed_loop(self, provisioned_capacity: int | None = None) -> BatchedRunHistory:
        spec = self.spec
        with tracing.span("session.build"):
            engine, device_policy = self.engine, self.device_policy
        if self.cell_topology is not None:
            from repro_torch.core.topology import run_closed_loop_sharded

            _, final_switch, traj = run_closed_loop_sharded(
                engine, self.cell_topology, self.schedule, device_policy,
                spec.switch.to_config(spec.feature_names), n_slots=spec.n_slots,
                key=jr.PRNGKey(spec.seed, self.device), faults=spec.faults)
            return BatchedRunHistory.from_closed_loop(
                traj, final_switch, cell_of_ue=self._cells,
                provisioned_capacity=provisioned_capacity)
        runtime = ArchesRuntime.from_spec(spec, engine=engine, device_policy=device_policy)
        return runtime.run_batched(self.schedule, n_slots=spec.n_slots, n_ues=spec.n_ues,
                                   key=jr.PRNGKey(spec.seed, self.device),
                                   provisioned_capacity=provisioned_capacity,
                                   faults=spec.faults)

    def _run_host(self) -> BatchedRunHistory:
        from repro_torch.core.dapp import DApp, connect_dapp
        from repro_torch.core.e3 import E3Agent

        spec = self.spec
        agent = E3Agent()
        # the single UE may still be assigned any declared policy table
        pol = spec.policy_assignment[0] if spec.policy_assignment else 0
        self.dapp = DApp(self.host_policies[pol], spec.feature_names,
                         window_slots=spec.switch.window_slots,
                         period_slots=spec.switch.period_slots)
        connect_dapp(agent, self.dapp)
        runtime = ArchesRuntime(
            self.pipeline.make_slot_fn(self.schedule), agent,
            default_mode=spec.switch.default_mode,
            fail_safe_mode=spec.switch.default_mode,
            ttl_slots=spec.switch.ttl_slots, keep_outputs=True)
        return BatchedRunHistory.from_host(runtime.run(range(spec.n_slots)))

    def _run_perturbed(self) -> BatchedRunHistory:
        spec = self.spec
        key = jr.PRNGKey(spec.seed, self.device)
        if self.cell_topology is not None:
            from repro_torch.core.topology import run_perturbed_sharded

            _, traj = run_perturbed_sharded(self.engine, self.cell_topology, self.schedule,
                                            spec.rho, n_slots=spec.n_slots, key=key)
        else:
            _, traj = self.engine.run_perturbed(self.schedule, spec.rho, n_slots=spec.n_slots,
                                                key=key)
        # stage 1 is MMSE-only by construction: the mode grid is all-1
        modes = np.ones((spec.n_slots, spec.n_ues), np.int32)
        return BatchedRunHistory.from_trajectory(modes, traj, cell_of_ue=self._cells)
