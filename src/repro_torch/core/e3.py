"""E3 interface emulation (paper 3.3); a copy of ``repro.core.e3``.

On the X5G testbed the E3 Agent (RAN side) exposes telemetry via shared
memory + ZeroMQ indication messages and the E3 Manager (dApp side) handles
setup/subscription/delivery.  This container has no SHM/NIC fabric, so the
*transport* is an in-process queue while the *protocol logic* — setup,
subscription with periodicity, indication delivery, control replies, failure
detection — is implemented faithfully.  Transport cost is carried by the
latency model (paper: ~135 us framework overhead per loop).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Mapping


@dataclasses.dataclass(frozen=True)
class E3IndicationMessage:
    """Telemetry push: one source's KPMs for one slot."""

    slot: int
    source: str  # "aerial" | "oai"
    kpms: Mapping[str, float]


@dataclasses.dataclass(frozen=True)
class E3ControlMessage:
    """dApp -> RAN reply: the mode variable (a single scalar, paper 2)."""

    slot: int
    mode: int


@dataclasses.dataclass
class E3Subscription:
    callback: Callable[[E3IndicationMessage], None]
    period_slots: int = 1
    sources: tuple[str, ...] = ("aerial", "oai")


class E3Agent:
    """RAN-side endpoint: publishes KPMs, receives control messages."""

    def __init__(self):
        self._subs: list[E3Subscription] = []
        self._control_inbox: deque[E3ControlMessage] = deque()
        self.indications_sent = 0
        self.controls_received = 0

    def subscribe(self, sub: E3Subscription) -> None:
        self._subs.append(sub)

    def indicate(self, msg: E3IndicationMessage) -> None:
        for sub in self._subs:
            if msg.source in sub.sources and msg.slot % sub.period_slots == 0:
                sub.callback(msg)
                self.indications_sent += 1

    def send_control(self, msg: E3ControlMessage) -> None:
        self._control_inbox.append(msg)
        self.controls_received += 1

    def poll_control(self) -> E3ControlMessage | None:
        """RAN slot-setup phase: drain the newest pending control message."""
        latest = None
        while self._control_inbox:
            latest = self._control_inbox.popleft()
        return latest


class E3Manager:
    """dApp-side endpoint: wires the dApp logic to an agent."""

    def __init__(self, agent: E3Agent):
        self.agent = agent

    def setup(
        self,
        on_indication: Callable[[E3IndicationMessage], None],
        *,
        period_slots: int = 1,
        sources: tuple[str, ...] = ("aerial", "oai"),
    ) -> None:
        self.agent.subscribe(
            E3Subscription(
                callback=on_indication, period_slots=period_slots, sources=sources
            )
        )

    def send_mode(self, slot: int, mode: int) -> None:
        self.agent.send_control(E3ControlMessage(slot=slot, mode=mode))
