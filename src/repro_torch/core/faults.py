"""Declarative fault injection: decision loss, expert corruption, telemetry loss.

A copy of ``repro.core.faults`` (numpy only).  ARCHES's safety story (paper
3.3, 5) is that switching *degrades* instead of crashing: a dead dApp decays
every UE to the conventional expert after ``ttl_slots``, a sick AI expert is
caught and reverted the same slot, and missing telemetry never poisons a
decision window.  ``FaultSpec`` makes those failure modes a campaign input,
hashed into ``CampaignSpec.faults`` like the churn spec, covering three
classes:

* **control-plane decision loss** -- scheduled outage spans (all UEs) plus a
  seeded per-slot Bernoulli drop; the device loop carries a decision-age
  counter that mirrors the host ``slot_boundary`` TTL decay bitwise;
* **expert-output corruption bursts** -- NaN/Inf or scaled-error injection
  into the AI estimator output, caught by the slot's ``isfinite`` health
  screen and fed into a per-UE circuit breaker (M trips in a window
  quarantines the AI expert until a cooldown re-probe);
* **telemetry loss** -- invalidated KPM samples are masked out of the rolling
  window (the ring does not advance for that UE that slot).

``FaultSpec.resolve`` lowers the spec to dense per-(slot, UE) mask arrays
with a *fixed* numpy draw order, so the device loop and the host replay
consume the same arrays, and the masks equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

_CORRUPTION_KINDS = ("nan", "inf", "scale")


def _tuplify_spans(spans) -> tuple:
    out = []
    for span in spans:
        start, end = span
        start, end = int(start), int(end)
        if not 0 <= start < end:
            raise ValueError(
                f"fault span ({start}, {end}) must satisfy 0 <= start < end"
            )
        out.append((start, end))
    return tuple(out)


def _check_prob(name: str, p: float) -> float:
    p = float(p)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"{name} {p} outside [0, 1]")
    return p


class ResolvedFaults(NamedTuple):
    """Dense per-(slot, UE) fault masks, one row a slot of the slot loop.

    ``decision_valid``: False where the control plane lost this slot's
    decision.  ``corrupt``: True where the AI expert output is corrupted.
    ``telemetry_valid``: False where the KPM sample is invalidated (masked
    out of the rolling window).  All ``(n_slots, n_ues)`` bool.
    """

    decision_valid: np.ndarray
    corrupt: np.ndarray
    telemetry_valid: np.ndarray


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Frozen, hashable, JSON-round-trippable fault-injection campaign.

    Spans are ``(start, end)`` half-open slot intervals applying to every
    UE; Bernoulli probabilities apply per (slot, UE) with the spec's own
    ``seed`` (independent of the campaign seed, so the same channel
    realization can be replayed under different fault draws).

    A default-constructed ``FaultSpec()`` injects nothing -- but still
    arms the fault machinery, and is bitwise-identical to a
    ``faults=None`` run on every trajectory leaf (the zero-fault identity
    contract; requires ``ttl_slots >= period_slots`` so a healthy loop
    never ages out).

    The circuit breaker: ``breaker_trips`` health/audit trips inside the
    last ``breaker_window`` slots quarantines the AI expert for that UE
    (it is served by the default expert and claims no gated capacity) for
    ``breaker_cooldown`` slots, after which a hysteresis re-probe starts
    from a cleared trip window.
    """

    seed: int = 0
    decision_outages: tuple = ()
    decision_drop_prob: float = 0.0
    corruption_spans: tuple = ()
    corruption_kind: str = "nan"
    corruption_scale: float = 1000.0
    corruption_prob: float = 1.0
    telemetry_spans: tuple = ()
    telemetry_drop_prob: float = 0.0
    breaker_trips: int = 3
    breaker_window: int = 8
    breaker_cooldown: int = 16

    def __post_init__(self):
        object.__setattr__(self, "seed", int(self.seed))
        object.__setattr__(
            self, "decision_outages", _tuplify_spans(self.decision_outages)
        )
        object.__setattr__(
            self, "corruption_spans", _tuplify_spans(self.corruption_spans)
        )
        object.__setattr__(
            self, "telemetry_spans", _tuplify_spans(self.telemetry_spans)
        )
        object.__setattr__(
            self,
            "decision_drop_prob",
            _check_prob("decision_drop_prob", self.decision_drop_prob),
        )
        object.__setattr__(
            self,
            "corruption_prob",
            _check_prob("corruption_prob", self.corruption_prob),
        )
        object.__setattr__(
            self,
            "telemetry_drop_prob",
            _check_prob("telemetry_drop_prob", self.telemetry_drop_prob),
        )
        if str(self.corruption_kind) not in _CORRUPTION_KINDS:
            raise ValueError(
                f"corruption_kind {self.corruption_kind!r}; "
                f"one of {_CORRUPTION_KINDS}"
            )
        object.__setattr__(
            self, "corruption_kind", str(self.corruption_kind)
        )
        scale = float(self.corruption_scale)
        if not scale > 0:
            raise ValueError(f"corruption_scale {scale} must be > 0")
        object.__setattr__(self, "corruption_scale", scale)
        for name in ("breaker_trips", "breaker_window", "breaker_cooldown"):
            val = int(getattr(self, name))
            if val < 1:
                raise ValueError(f"{name} {val} must be >= 1")
            object.__setattr__(self, name, val)

    @property
    def injects_nothing(self) -> bool:
        """True when no fault can ever fire (masks are all-pass)."""
        return (
            not self.decision_outages
            and self.decision_drop_prob == 0.0
            and not self.corruption_spans
            and not self.telemetry_spans
            and self.telemetry_drop_prob == 0.0
        )

    @classmethod
    def from_dict(cls, d) -> "FaultSpec":
        return cls(**dict(d))

    def _span_mask(self, spans: tuple, n_slots: int) -> np.ndarray:
        mask = np.zeros(n_slots, bool)
        for start, end in spans:
            mask[start:min(end, n_slots)] = True
        return mask

    def resolve(self, n_slots: int, n_ues: int) -> ResolvedFaults:
        """Lower to dense ``(n_slots, n_ues)`` masks.

        The numpy draw order is fixed (decision, corruption, telemetry --
        each a full ``(n_slots, n_ues)`` uniform draw regardless of its
        probability) so any two resolutions of the same spec over the same
        shape are identical arrays: the device loop and the host oracle
        consume the *same* masks.  Streaming resolves over the stable-id
        axis and column-gathers per segment, so a UE's fault stream is
        tied to its identity, not its bank slot.
        """
        rng = np.random.default_rng(self.seed)
        dec_span = self._span_mask(self.decision_outages, n_slots)
        dec_drop = rng.random((n_slots, n_ues)) < self.decision_drop_prob
        decision_valid = ~(dec_span[:, None] | dec_drop)
        cor_span = self._span_mask(self.corruption_spans, n_slots)
        cor_draw = rng.random((n_slots, n_ues)) < self.corruption_prob
        corrupt = cor_span[:, None] & cor_draw
        tel_span = self._span_mask(self.telemetry_spans, n_slots)
        tel_drop = rng.random((n_slots, n_ues)) < self.telemetry_drop_prob
        telemetry_valid = ~(tel_span[:, None] | tel_drop)
        return ResolvedFaults(
            decision_valid=decision_valid,
            corrupt=corrupt,
            telemetry_valid=telemetry_valid,
        )
