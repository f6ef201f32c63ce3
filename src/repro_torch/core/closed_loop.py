"""Closed-loop expert switching inside the slot loop (the E3/dApp path on device).

Port of ``repro.core.closed_loop``:

* ``DeviceTreePolicy`` / ``DeviceThresholdPolicy`` / ``PerUEPolicy`` -- host
  policies exported to device tensors.  A tree is its level-order
  ``feature``/``threshold``/``leaf_modes`` tables; the ``tree_infer``
  kernel walks them directly, so there is no packed form.
* ``DeviceSwitchState`` -- per-UE KPM window, hysteresis streak, switch
  register and the fault ladder's state (decision age, circuit-breaker trip
  window, quarantine countdown), carried from slot to slot.
* ``switch_update`` / ``switch_boundary`` / ``breaker_update`` -- a decision
  made during slot ``n`` is written to the register; only the boundary into
  slot ``n+1`` makes it the active mode.  Under a ``FaultSpec`` the update
  drops masked telemetry and lost decisions, the boundary runs the TTL decay
  to the fail-safe mode, and the breaker quarantines a UE whose AI expert
  tripped too often.  For a ``DeviceTreePolicy`` the slot loop runs the whole
  phase as one launch, ``repro_torch.kernels.tree_infer.policy_step``, whose
  plain version ``policy_step_ref`` is this composition.
* ``host_replay_closed_loop`` -- the equivalence oracle: a slot-by-slot
  host loop through the literal host policy, with faults and churn.  Device
  and host mode trajectories must match bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.telemetry import KPMRing, ring_init, ring_push, ring_window_mean
from repro_torch.device import resolve_device
from repro_torch.kernels.tree_infer import tree_infer, tree_infer_ref

# -- device policy tables -----------------------------------------------------


class DeviceTreePolicy(NamedTuple):
    """A fitted decision tree as flat device tensors (level order)."""

    feature: torch.Tensor  # (2**d - 1,) int32
    threshold: torch.Tensor  # (2**d - 1,) float32
    leaf_modes: torch.Tensor  # (2**d,) float32

    @property
    def depth(self) -> int:
        return int(self.feature.shape[0] + 1).bit_length() - 1


class DeviceThresholdPolicy(NamedTuple):
    """``ThresholdPolicy`` as device scalars (single-KPM gate + band)."""

    feature_idx: torch.Tensor  # int64
    lo: torch.Tensor  # float32
    hi: torch.Tensor  # float32
    mode_above: torch.Tensor  # int32
    mode_below: torch.Tensor  # int32


class PerUEPolicy(NamedTuple):
    """A bank of exported tables plus a per-UE ``(U,)`` table assignment."""

    tables: tuple
    policy_idx: torch.Tensor  # (U,) int64


def per_ue_policy(tables: Sequence, assignment,
                  device: torch.device | str = "cuda") -> PerUEPolicy:
    """Build a validated ``PerUEPolicy`` from tables + per-UE assignment, its
    assignment on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    tables = tuple(tables)
    if not tables:
        raise ValueError("per-UE policy needs at least one table")
    idx = np.asarray(assignment, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"assignment must be (n_ues,), got {idx.shape}")
    if idx.min() < 0 or idx.max() >= len(tables):
        raise ValueError(f"assignment references tables outside [0, {len(tables)})")
    return PerUEPolicy(tables=tables, policy_idx=torch.as_tensor(idx, device=device))


DevicePolicy = DeviceTreePolicy | DeviceThresholdPolicy | PerUEPolicy


def export_tree_tables(feature, threshold, leaf_values, n_features: int | None = None,
                       depth: int | None = None, *,
                       device: torch.device | str = "cuda") -> DeviceTreePolicy:
    """Level-order tree arrays -> a ``DeviceTreePolicy`` on ``device`` (the
    card unless the caller asks for the CPU).  ``n_features`` and ``depth``,
    where given, are checked against the arrays: ``2**depth - 1`` nodes,
    ``2**depth`` leaves, every node's feature in ``[0, n_features)``."""
    device = resolve_device(device)
    feat = np.asarray(feature)
    if depth is not None and (feat.shape != (2**depth - 1,)
                              or np.shape(leaf_values) != (2**depth,)):
        raise ValueError(f"a depth-{depth} tree has {2**depth - 1} nodes and {2**depth} "
                         f"leaves, got {feat.shape} and {np.shape(leaf_values)}")
    if n_features is not None and feat.size and not (
            0 <= feat.min() and feat.max() < n_features):
        raise ValueError(f"tree features {feat.tolist()} outside [0, {n_features})")
    return DeviceTreePolicy(
        feature=torch.as_tensor(np.asarray(feature, np.int32), device=device),
        threshold=torch.as_tensor(np.asarray(threshold, np.float32), device=device),
        leaf_modes=torch.as_tensor(np.asarray(leaf_values, np.float32), device=device),
    )


def policy_infer(policy: DevicePolicy, x: torch.Tensor, prev_mode: torch.Tensor,
                 *, backend: str = "auto") -> torch.Tensor:
    """Evaluate a device policy on ``x (U, F)`` -> int32 modes ``(U,)``.

    ``backend`` picks the tree evaluator: ``"auto"``, ``"pallas"`` and
    ``"cuda"`` go through the ``tree_infer`` wrapper (the kernel on a CUDA
    tensor, its plain version on a CPU one); ``"ref"`` runs the literal
    walk oracle on any device.  ``prev_mode`` only matters for the
    threshold policy's keep-band.
    """
    if isinstance(policy, PerUEPolicy):
        outs = torch.stack([policy_infer(t, x, prev_mode, backend=backend)
                            for t in policy.tables], dim=0)  # (P, U)
        return torch.gather(outs, 0, policy.policy_idx[None, :])[0].to(torch.int32)
    if isinstance(policy, DeviceThresholdPolicy):
        v = x[:, policy.feature_idx]
        above = v > policy.hi
        below = v < policy.lo
        keep = ~(above | below)
        return torch.where(keep, prev_mode.to(torch.int32),
                           torch.where(above, policy.mode_above, policy.mode_below)
                           ).to(torch.int32)
    args = (x.to(torch.float32).contiguous(), policy.feature, policy.threshold,
            policy.leaf_modes, policy.depth)
    if backend in ("auto", "pallas", "cuda"):
        out = tree_infer(*args)
    elif backend == "ref":
        out = tree_infer_ref(*args)
    else:
        raise ValueError(f"unknown policy backend {backend!r}")
    return out.to(torch.int32)


# -- switch-register state ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SwitchConfig:
    """Static configuration of the in-loop control: telemetry window,
    hysteresis, decision period, fail-safe mode, tree backend, TTL."""

    feature_names: tuple[str, ...]
    window_slots: int = 8
    hysteresis_slots: int = 1
    period_slots: int = 1
    default_mode: int = 1
    backend: str = "auto"  # "auto" | "pallas" | "cuda" | "ref"
    ttl_slots: int = 16

    def __post_init__(self):
        object.__setattr__(self, "feature_names", tuple(self.feature_names))
        if self.window_slots < 1:
            raise ValueError("window_slots must be >= 1")
        if self.hysteresis_slots < 1:
            raise ValueError("hysteresis_slots must be >= 1")
        if self.period_slots < 1:
            raise ValueError("period_slots must be >= 1")
        if self.ttl_slots < 1:
            raise ValueError("ttl_slots must be >= 1")


class DeviceSwitchState(NamedTuple):
    """Per-UE control-loop state carried from slot to slot.

    ``active_mode`` is what the pipeline runs this slot, ``pending_mode`` the
    switch register, ``streak`` the hysteresis count, ``n_switches`` the
    boundary transitions.  The fault ladder's three leaves are in every
    state, as in the reference, and stay untouched without a ``FaultSpec``:
    ``decision_age`` counts slots since the last decision heard,
    ``trip_ring (U, breaker_window)`` is the breaker's rolling trip window
    (width 1 without faults) and ``quarantine`` the cooldown countdown
    (``> 0``: the UE is served by the default expert).
    """

    rings: KPMRing
    active_mode: torch.Tensor  # (U,) int32
    pending_mode: torch.Tensor  # (U,) int32
    streak: torch.Tensor  # (U,) int32
    n_switches: torch.Tensor  # (U,) int32
    decision_age: torch.Tensor  # (U,) int32
    trip_ring: torch.Tensor  # (U, breaker_window) int32
    quarantine: torch.Tensor  # (U,) int32


def init_device_switch(n_ues: int, n_features: int, cfg: SwitchConfig,
                       device: torch.device | str = "cuda", *,
                       faults=None) -> DeviceSwitchState:
    """The switch state of ``n_ues`` UEs at the default mode, on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    d = torch.full((n_ues,), cfg.default_mode, dtype=torch.int32, device=device)
    z = torch.zeros((4, n_ues), dtype=torch.int32, device=device)
    breaker_window = 1 if faults is None else faults.breaker_window
    return DeviceSwitchState(
        rings=ring_init(n_ues, cfg.window_slots, n_features, device),
        active_mode=d, pending_mode=d.clone(), streak=z[0], n_switches=z[1],
        decision_age=z[2],
        trip_ring=torch.zeros((n_ues, breaker_window), dtype=torch.int32, device=device),
        quarantine=z[3],
    )


def select_rows(mask: torch.Tensor, new, old):
    """Per-UE select over a state's leaves (NamedTuples, nested): ``new``
    where ``mask``, else ``old``.  A streaming campaign's detached lanes keep
    their whole state this way, ring included."""
    return type(new)(*(
        select_rows(mask, n, o) if isinstance(n, tuple)
        else torch.where(mask.reshape(mask.shape + (1,) * (n.ndim - 1)), n, o)
        for n, o in zip(new, old)))


def switch_update(state: DeviceSwitchState, kpm_vecs: torch.Tensor,
                  policy: DevicePolicy, cfg: SwitchConfig, *, decide: bool = True,
                  decision_valid: torch.Tensor | None = None,
                  telemetry_valid: torch.Tensor | None = None,
                  ) -> tuple[DeviceSwitchState, torch.Tensor]:
    """Decision phase of slot ``n``: window push -> policy -> register.

    ``decide`` is False on the hold slots of a periodic policy: the KPMs
    still enter the window, but register and streak freeze and the held
    register is reported as the raw decision.

    The fault masks (``(U,)`` bool): where ``telemetry_valid`` is False the
    slot's KPMs never enter the window (the ring does not advance for that
    UE); where ``decision_valid`` is False the decision is lost, and
    register, streak and raw decision freeze as on a hold slot.  With
    ``decision_valid`` given, ``decision_age`` resets on every decision slot
    that arrived, whatever the hysteresis does.
    """
    rings = ring_push(state.rings, kpm_vecs)
    if telemetry_valid is not None:
        rings = select_rows(telemetry_valid, rings, state.rings)
    if not decide:
        return state._replace(rings=rings), state.pending_mode
    window = ring_window_mean(rings, cfg.window_slots)
    raw = policy_infer(policy, window, state.pending_mode, backend=cfg.backend)
    agree = raw == state.pending_mode
    streak = torch.where(agree, torch.zeros_like(state.streak), state.streak + 1)
    commit = streak >= cfg.hysteresis_slots
    pending = torch.where(commit, raw, state.pending_mode)
    streak = torch.where(commit, torch.zeros_like(streak), streak)
    age = state.decision_age
    if decision_valid is not None:
        dv = decision_valid
        raw = torch.where(dv, raw, state.pending_mode)
        pending = torch.where(dv, pending, state.pending_mode)
        streak = torch.where(dv, streak, state.streak)
        age = torch.where(dv, torch.zeros_like(age), age)
    return state._replace(rings=rings, pending_mode=pending, streak=streak,
                          decision_age=age), raw


def switch_boundary(state: DeviceSwitchState, *, ttl_slots: int | None = None,
                    fail_safe_mode: int | None = None) -> DeviceSwitchState:
    """Boundary into slot ``n+1``: the register becomes the active mode.

    With ``ttl_slots`` (fault campaigns) the boundary also runs the TTL
    decay, as the host ``slot_boundary`` does: a UE whose decision age has
    reached ``ttl_slots`` (checked before the age advances) has its active
    mode and its register forced to ``fail_safe_mode``; then every age
    advances one slot.
    """
    pending = state.pending_mode
    age = state.decision_age
    if ttl_slots is not None:
        stale = age >= ttl_slots
        pending = torch.where(stale, torch.full_like(pending, fail_safe_mode), pending)
        age = age + 1
    switched = (pending != state.active_mode).to(torch.int32)
    return state._replace(active_mode=pending, pending_mode=pending, decision_age=age,
                          n_switches=state.n_switches + switched)


def breaker_update(state: DeviceSwitchState, trip: torch.Tensor, slot_idx: int,
                   faults) -> DeviceSwitchState:
    """Circuit breaker: ``breaker_trips`` trips in a window quarantine the AI
    expert.

    ``trip (U,)`` bool flags this slot's health-screen or audit trips.  The
    per-UE trip window is a ring written at ``slot_idx % breaker_window``;
    a UE not already quarantined that reaches ``breaker_trips`` trips in it
    enters quarantine for ``breaker_cooldown`` slots with a cleared window,
    so the re-probe after the cooldown starts clean.  While quarantined the
    countdown falls by one a slot.
    """
    window = state.trip_ring.shape[1]
    onehot = torch.arange(window, device=trip.device) == (slot_idx % window)
    ring = torch.where(onehot[None, :], trip.to(torch.int32)[:, None], state.trip_ring)
    count = ring.sum(dim=1)
    newly = (state.quarantine <= 0) & (count >= faults.breaker_trips)
    ring = torch.where(newly[:, None], torch.zeros_like(ring), ring)
    quar = torch.where(newly, torch.full_like(state.quarantine, faults.breaker_cooldown),
                       torch.clamp(state.quarantine - 1, min=0))
    return state._replace(trip_ring=ring, quarantine=quar)


# -- host equivalence oracle ---------------------------------------------------


def host_replay_closed_loop(host_policy, features, cfg: SwitchConfig, *,
                            policy_idx=None, attached=None, faults=None,
                            trips=None) -> dict[str, np.ndarray]:
    """Replay the closed loop on the host, slot by slot, UE by UE.

    ``host_policy`` is a host object (``DecisionTreePolicy`` -- the literal
    walk per KPM vector -- or ``ThresholdPolicy``), or a sequence of them
    with ``policy_idx (U,)`` for a per-UE campaign.  ``features (S, U, F)``
    is the device trajectory's telemetry in ``cfg.feature_names`` order.
    The window reuses the ring arithmetic of the device loop (on CPU
    tensors, one UE at a time); control flow is plain Python ints.

    ``attached (S, U)`` replays a streaming campaign: a detached UE is
    skipped (its entries carry ``-1``), and at every (re)attach it
    cold-starts as the device's admission pass does (fresh ring, default
    register and mode, cleared streak and fault state).  ``faults`` replays
    a fault campaign: the spec is resolved again to the masks the device
    ran, and the oracle drops masked telemetry, holds the register on lost
    decisions, resets the decision age on heard ones, runs the TTL decay and
    the breaker.  ``trips (S, U)`` gives the device's health/audit trip
    flags for the breaker; without it trips come from the corruption masks
    (exact for NaN and Inf, which always trip the screen).

    Returns ``{"active_mode", "raw_decision", "pending_mode",
    "quarantined", "n_switches"}`` (``(S, U)`` int32; ``n_switches (U,)``).
    """
    from repro_torch.core.policy import ThresholdPolicy

    feats = torch.as_tensor(np.asarray(features, np.float32))
    n_slots, n_ues, n_feat = feats.shape
    if n_feat != len(cfg.feature_names):
        raise ValueError(
            f"features carry {n_feat} KPMs, config names {len(cfg.feature_names)}")
    if isinstance(host_policy, (list, tuple)):
        if policy_idx is None:
            raise ValueError("a per-UE policy sequence needs policy_idx")
        idx = np.asarray(policy_idx, int)
        if idx.shape != (n_ues,):
            raise ValueError(f"policy_idx {idx.shape} vs n_ues {n_ues}")
        if idx.size and (idx.min() < 0 or idx.max() >= len(host_policy)):
            raise ValueError(
                f"policy_idx references policies outside [0, {len(host_policy)})")
        policy_for_ue = [host_policy[int(i)] for i in idx]
    else:
        if policy_idx is not None:
            raise ValueError("policy_idx given but host_policy is not a sequence")
        policy_for_ue = [host_policy] * n_ues
    if attached is not None:
        attached = np.asarray(attached, bool)
        if attached.shape != (n_slots, n_ues):
            raise ValueError(f"attached {attached.shape} vs features {(n_slots, n_ues)}")
    resolved = None if faults is None else faults.resolve(n_slots, n_ues)
    if trips is not None:
        trips = np.asarray(trips).astype(bool)
        if trips.shape != (n_slots, n_ues):
            raise ValueError(f"trips {trips.shape} vs features {(n_slots, n_ues)}")

    def fresh_ring():
        return ring_init(1, cfg.window_slots, n_feat, "cpu")

    rings = [fresh_ring() for _ in range(n_ues)]
    active = [cfg.default_mode] * n_ues
    pending = [cfg.default_mode] * n_ues
    streak = [0] * n_ues
    n_switches = [0] * n_ues
    age = [0] * n_ues
    trip_ring = (np.zeros((n_ues, faults.breaker_window), np.int32)
                 if faults is not None else None)
    quarantine = [0] * n_ues
    active_hist = np.zeros((n_slots, n_ues), np.int32)
    raw_hist = np.zeros((n_slots, n_ues), np.int32)
    pending_hist = np.zeros((n_slots, n_ues), np.int32)
    quar_hist = np.zeros((n_slots, n_ues), np.int32)

    for s in range(n_slots):
        for u in range(n_ues):
            if attached is not None:
                if not attached[s, u]:
                    for h in (active_hist, raw_hist, pending_hist, quar_hist):
                        h[s, u] = -1
                    continue
                if s == 0 or not attached[s - 1, u]:  # (re)attach: cold start
                    rings[u] = fresh_ring()
                    active[u] = pending[u] = cfg.default_mode
                    streak[u] = age[u] = quarantine[u] = 0
                    if trip_ring is not None:
                        trip_ring[u] = 0
            in_quar = quarantine[u] > 0
            active_hist[s, u] = active[u]
            quar_hist[s, u] = 1 if in_quar else 0
            if resolved is None or resolved.telemetry_valid[s, u]:
                rings[u] = ring_push(rings[u], feats[s, u][None])
            window = ring_window_mean(rings[u], cfg.window_slots)[0]
            heard = s % cfg.period_slots == 0 and (
                resolved is None or resolved.decision_valid[s, u])
            if not heard:  # hold or lost decision: register and streak frozen
                raw = pending[u]
            else:
                pol = policy_for_ue[u]
                if isinstance(pol, ThresholdPolicy):
                    raw = int(pol(window, prev_mode=pending[u]))
                else:
                    raw = int(pol(window))
                if raw == pending[u]:
                    streak[u] = 0
                else:
                    streak[u] += 1
                    if streak[u] >= cfg.hysteresis_slots:
                        pending[u] = raw
                        streak[u] = 0
                if resolved is not None:
                    age[u] = 0  # a heard decision refreshes the TTL
            raw_hist[s, u] = raw
            pending_hist[s, u] = pending[u]
            nxt = pending[u]  # the boundary into slot s + 1, with the TTL decay
            if resolved is not None:
                if age[u] >= cfg.ttl_slots:
                    nxt = pending[u] = cfg.default_mode
                age[u] += 1
            if nxt != active[u]:
                n_switches[u] += 1
            active[u] = nxt
            if resolved is not None:  # the breaker takes this slot's trip
                if trips is not None:
                    trip = bool(trips[s, u])
                else:
                    exec_mode = cfg.default_mode if in_quar else active_hist[s, u]
                    trip = bool(resolved.corrupt[s, u] and exec_mode == 0
                                and faults.corruption_kind in ("nan", "inf"))
                trip_ring[u, s % faults.breaker_window] = int(trip)
                if not in_quar and int(trip_ring[u].sum()) >= faults.breaker_trips:
                    trip_ring[u] = 0
                    quarantine[u] = faults.breaker_cooldown
                else:
                    quarantine[u] = max(quarantine[u] - 1, 0)

    return {
        "active_mode": active_hist,
        "raw_decision": raw_hist,
        "pending_mode": pending_hist,
        "quarantined": quar_hist,
        "n_switches": np.asarray(n_switches, np.int32),
    }
