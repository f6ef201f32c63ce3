"""The ARCHES dApp: telemetry windows, policy inference, mode decisions
(paper 3.3, 6.1); a copy of ``repro.core.dapp``.

The dApp accumulates cross-layer KPMs from E3 indications, runs the switching
policy on the host at a configurable periodicity, and replies with the single
scalar ``mode``.  The latency model carries the paper's measured constants so
every decision is annotated with an end-to-end control-loop estimate
(~135 us framework + 0.41 us tree + 3.36/4.89 us switch ~= 140 us), the same
estimate the reference gives.

Failure injection (``fail()``) lets the tests exercise the fail-safe path:
a failed dApp simply stops producing decisions and the RAN-side
``SlotSwitchState`` decays to the conventional expert after ``ttl_slots``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.e3 import E3Agent, E3IndicationMessage, E3Manager


@dataclasses.dataclass(frozen=True)
class ControlLoopLatency:
    """End-to-end control-loop latency model (paper 6.1).

    The constants are the paper's, measured on its GH200 testbed (E3
    framework overhead, tree inference, switch kernel); they are not this
    port's or its card's.  The measured policy time replaces the tree
    constant when given; the port's own switch times are in ``PERF.md``.
    """

    framework_overhead_us: float = 135.0  # shm copies + ZeroMQ messaging
    policy_inference_us: float = 0.41  # decision tree on GH200
    switch_kernel_us: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: {0: 3.36, 1: 4.89}  # AI no-op vs MMSE copy
    )

    def end_to_end_us(self, mode: int, measured_policy_us: float | None = None) -> float:
        policy = (
            measured_policy_us
            if measured_policy_us is not None
            else self.policy_inference_us
        )
        switch = self.switch_kernel_us.get(int(mode), max(self.switch_kernel_us.values()))
        return self.framework_overhead_us + policy + switch


@dataclasses.dataclass(frozen=True)
class Decision:
    slot: int
    mode: int
    policy_us: float  # measured host inference time
    end_to_end_us: float  # modeled control-loop latency


class DApp:
    """Processing layer of the dApp (paper Fig. 1/2)."""

    def __init__(
        self,
        policy,
        feature_names: Sequence[str],
        *,
        window_slots: int = 8,
        period_slots: int = 1,
        latency: ControlLoopLatency | None = None,
    ):
        self.policy = policy
        self.feature_names = tuple(feature_names)
        self.window_slots = window_slots
        self.period_slots = period_slots
        self.latency = latency or ControlLoopLatency()
        self._window: list[dict[str, float]] = []
        self._pending: dict[int, dict[str, float]] = {}
        self._failed = False
        self.decisions: list[Decision] = []

    # -- lifecycle (client interface) --
    def fail(self) -> None:
        self._failed = True

    def recover(self) -> None:
        self._failed = False

    # -- processing layer --
    def on_indication(self, msg: E3IndicationMessage) -> Decision | None:
        if self._failed:
            return None
        slot_kpms = self._pending.setdefault(msg.slot, {})
        slot_kpms.update({k: float(v) for k, v in msg.kpms.items()})
        if not all(n in slot_kpms for n in self.feature_names):
            return None  # waiting for the other layer's indication
        self._pending.pop(msg.slot)
        self._window.append(slot_kpms)
        if len(self._window) > self.window_slots:
            self._window.pop(0)
        if msg.slot % self.period_slots != 0:
            return None
        x = np.asarray(
            [
                np.mean([w[n] for w in self._window])
                for n in self.feature_names
            ],
            np.float32,
        )
        t0 = time.perf_counter()
        mode = int(self.policy(x))
        policy_us = (time.perf_counter() - t0) * 1e6
        decision = Decision(
            slot=msg.slot,
            mode=mode,
            policy_us=policy_us,
            end_to_end_us=self.latency.end_to_end_us(mode, policy_us),
        )
        self.decisions.append(decision)
        return decision


def connect_dapp(agent: E3Agent, dapp: DApp) -> E3Manager:
    """Wire a dApp to a RAN-side E3 agent; decisions flow back as controls."""
    manager = E3Manager(agent)

    def on_indication(msg: E3IndicationMessage) -> None:
        decision = dapp.on_indication(msg)
        if decision is not None:
            manager.send_mode(decision.slot, decision.mode)

    manager.setup(on_indication)
    return manager
