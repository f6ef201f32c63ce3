"""OTA experiment scenarios (paper 6, Figs. 7/9) + the scenario registry.

A copy of ``repro.phy.scenario`` (numpy/Python only).

The paper's two OTA operating points are ``good`` (LOS, no interference)
and ``poor`` (same link + frequency-selective in-band UL interference from
the neighbouring UE2->gNB2 pair, PRB-allocation controlled).  Everything a
campaign can run is expressed as a *schedule* — ``schedule(slot) ->
ChannelConfig`` — so conditions may change per slot while the TDL profile
stays static (the traced-channel contract of
``repro_torch.phy.channel.channel_params_schedule``).

**Scenario registry.**  Named scenarios are registered with
``register_scenario`` and looked up with ``get_scenario``; ``CampaignSpec`` (``repro_torch.core.session``) references them
by name so a campaign's channel conditions serialize as a string + kwargs.
Registered entries:

* ``good`` / ``poor`` — constant single-condition schedules.
* ``good_poor_good`` — the Fig. 9 time series (good -> poor -> good at
  configurable slot boundaries).
* ``bursty_interference`` — periodic interference bursts (on for
  ``burst_slots`` out of every ``period``), the TDM-scheduled neighbour.
* ``snr_ramp`` — triangle sweep of the thermal SNR between ``snr_hi_db``
  and ``snr_lo_db`` (no interference): exercises link adaptation across
  the whole MCS table.
* ``mixed_cell`` — **per-UE heterogeneous**: UE ``u`` cycles through
  {good, good_poor_good, bursty_interference}, so one cell carries clean,
  phase-transition and bursty users simultaneously.  Per-UE scenarios
  return one schedule per UE; the batched engine stacks them into
  ``ChannelParams`` with a ``(n_slots, n_ues)`` leading shape.
* ``churn_cell`` — **per-id**: every stable UE id gets the same periodic
  interference stream, phase-shifted by ``(id * stagger) % period``, so a UE
  re-packed into another bank slot keeps its own burst phase (streaming
  campaigns).
* ``multi_cell`` — ``n_cells`` cells, each running a named registered
  homogeneous scenario over its contiguous block of UEs (the layout of
  ``repro_torch.core.topology``).

All registered scenarios share the ``INDOOR_LOS`` profile, so any mix of
them is device-traceable in one scan (including per-UE mixes).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.phy.channel import INDOOR_LOS, ChannelConfig

# Operating point chosen so link adaptation sits in the paper's regime
# (median MCS ~19-20 good / ~11-12 poor, Fig. 10b) rather than saturating at
# the table top, where estimator quality cannot show up in throughput.
GOOD = ChannelConfig(profile=INDOOR_LOS, snr_db=8.0, interference=False)
# Frame-aligned neighbour-cell UL: its DMRS collides with ours (pilot
# contamination), so interference corrupts channel *estimation* first and
# data REs second — the regime where expert choice matters most (paper 6.2).
POOR = ChannelConfig(
    profile=INDOOR_LOS,
    snr_db=8.0,
    interference=True,
    inr_db=18.0,
    interference_prb_frac=0.5,
    interference_symbol_duty=3.0 / 14.0,  # DMRS symbols only
    dmrs_collision=True,
)


@dataclasses.dataclass(frozen=True)
class PoorWindow:
    """The Fig. 9 interference window: poor conditions on ``[start, end)``."""

    start: int = 100
    end: int = 200

    def __contains__(self, slot: int) -> bool:
        return self.start <= slot < self.end


#: Default Fig. 9 window (slots 100..200 poor).
POOR_WINDOW = PoorWindow()


def constant_schedule(cfg: ChannelConfig) -> Callable[[int], ChannelConfig]:
    return lambda slot: cfg


def good_poor_good_schedule(
    *, poor_start: int = POOR_WINDOW.start, poor_end: int = POOR_WINDOW.end
) -> Callable[[int], ChannelConfig]:
    """Fig. 9: good -> poor -> good transitions at slot boundaries."""
    window = PoorWindow(poor_start, poor_end)

    def schedule(slot: int) -> ChannelConfig:
        return POOR if slot in window else GOOD

    return schedule


def bursty_interference_schedule(
    *, period: int = 40, burst_slots: int = 10, offset: int = 0
) -> Callable[[int], ChannelConfig]:
    """Periodic interference bursts: poor for the first ``burst_slots`` of
    every ``period``-slot cycle (phase-shifted by ``offset``)."""
    if period < 1:
        raise ValueError(f"period {period} must be >= 1")
    if not 0 <= burst_slots <= period:
        raise ValueError(f"burst_slots {burst_slots} outside [0, {period}]")

    def schedule(slot: int) -> ChannelConfig:
        return POOR if (slot + offset) % period < burst_slots else GOOD

    return schedule


def snr_ramp_schedule(
    *, snr_hi_db: float = 14.0, snr_lo_db: float = 2.0, period: int = 60
) -> Callable[[int], ChannelConfig]:
    """Triangle SNR sweep hi -> lo -> hi over ``period`` slots, no
    interference — drives link adaptation across the MCS table."""
    if period < 1:
        raise ValueError(f"period {period} must be >= 1")
    half = period / 2.0

    def schedule(slot: int) -> ChannelConfig:
        phase = slot % period
        frac = phase / half if phase < half else (period - phase) / half
        snr = snr_hi_db + (snr_lo_db - snr_hi_db) * frac
        return dataclasses.replace(GOOD, snr_db=float(snr))

    return schedule


# -- scenario registry ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, parameterizable campaign scenario.

    ``factory(**kwargs)`` returns ``schedule(slot) -> ChannelConfig``; with
    ``per_ue=True`` the factory additionally takes ``n_ues`` and returns one
    schedule per UE (a list) — the heterogeneous-cell case.
    """

    name: str
    factory: Callable[..., object]
    per_ue: bool = False
    description: str = ""

    def schedule(self, *, n_ues: int | None = None, **kwargs):
        """Instantiate: one slot schedule, or ``n_ues`` of them (per-UE)."""
        if self.per_ue:
            if n_ues is None:
                raise ValueError(
                    f"scenario {self.name!r} is per-UE: pass n_ues"
                )
            schedules = list(self.factory(n_ues=n_ues, **kwargs))
            if len(schedules) != n_ues:
                raise ValueError(
                    f"scenario {self.name!r} produced {len(schedules)} "
                    f"schedules for n_ues={n_ues}"
                )
            return schedules
        return self.factory(**kwargs)


_SCENARIOS: dict[str, Scenario] = {}


def register_scenario(
    name: str,
    factory: Callable[..., object],
    *,
    per_ue: bool = False,
    description: str = "",
    overwrite: bool = False,
) -> Scenario:
    """Register a named scenario; returns the registry entry."""
    if name in _SCENARIOS and not overwrite:
        raise ValueError(f"scenario {name!r} already registered")
    sc = Scenario(
        name=name, factory=factory, per_ue=per_ue, description=description
    )
    _SCENARIOS[name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {scenario_names()}"
        ) from None


def scenario_names() -> tuple[str, ...]:
    return tuple(sorted(_SCENARIOS))


def _mixed_cell(
    n_ues: int,
    *,
    poor_start: int = 5,
    poor_end: int = 15,
    period: int = 12,
    burst_slots: int = 4,
) -> list:
    """Heterogeneous cell: UE u cycles {good, good_poor_good, bursty}."""
    bases = (
        constant_schedule(GOOD),
        good_poor_good_schedule(poor_start=poor_start, poor_end=poor_end),
        bursty_interference_schedule(period=period, burst_slots=burst_slots),
    )
    return [bases[u % len(bases)] for u in range(n_ues)]


def _multi_cell(n_ues: int, *, n_cells: int = 2,
                per_cell_scenario: Sequence[str] = ("good", "poor")) -> list:
    """Multi-cell campaign: cell ``c`` runs a named registered scenario.

    ``per_cell_scenario`` names one homogeneous scenario per cell (cycled
    when shorter than ``n_cells``) and every member UE follows its cell's
    schedule.  UE ``u`` belongs to cell ``u // (n_ues / n_cells)``, the
    layout of ``repro_torch.core.topology``.
    """
    if n_cells < 1:
        raise ValueError(f"n_cells {n_cells} must be >= 1")
    if n_ues % n_cells:
        raise ValueError(f"n_cells={n_cells} does not divide n_ues={n_ues}: cells "
                         "partition the UE axis into equal sub-batches")
    names = tuple(per_cell_scenario)
    if not names:
        raise ValueError("per_cell_scenario names at least one scenario")
    cell_schedules = []
    for c in range(n_cells):
        sc = get_scenario(names[c % len(names)])  # an unknown name raises KeyError
        if sc.per_ue:
            raise ValueError(f"per_cell_scenario entry {sc.name!r} is per-UE; each cell "
                             "needs one homogeneous condition stream")
        cell_schedules.append(sc.schedule())
    ues_per_cell = n_ues // n_cells
    return [cell_schedules[u // ues_per_cell] for u in range(n_ues)]


def _churn_cell(n_ues: int, *, period: int = 12, burst_slots: int = 4,
                stagger: int = 3) -> list:
    """Churn-campaign cell: phase-staggered bursty interference per UE id, so
    each stable identity carries its own condition trajectory whatever bank
    slot it is packed into."""
    return [
        bursty_interference_schedule(period=period, burst_slots=burst_slots,
                                     offset=(u * stagger) % period)
        for u in range(n_ues)
    ]


register_scenario(
    "good", lambda: constant_schedule(GOOD),
    description="LOS, no interference (paper: UE1->gNB1 clean)",
)
register_scenario(
    "poor", lambda: constant_schedule(POOR),
    description="in-band neighbour-cell UL interference, DMRS collision",
)
register_scenario(
    "good_poor_good", good_poor_good_schedule,
    description="Fig. 9 time series: good -> poor -> good",
)
register_scenario(
    "bursty_interference", bursty_interference_schedule,
    description="periodic interference bursts (TDM neighbour traffic)",
)
register_scenario(
    "snr_ramp", snr_ramp_schedule,
    description="triangle thermal-SNR sweep, no interference",
)
register_scenario(
    "mixed_cell", _mixed_cell, per_ue=True,
    description="per-UE heterogeneous: good / good_poor_good / bursty mix",
)
register_scenario(
    "multi_cell", _multi_cell, per_ue=True,
    description="n_cells cells, each running a named registered scenario",
)
register_scenario(
    "churn_cell", _churn_cell, per_ue=True,
    description="per-id phase-staggered interference bursts (streaming)",
)
