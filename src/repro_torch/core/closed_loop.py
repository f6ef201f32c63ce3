"""Closed-loop expert switching inside the slot loop (the E3/dApp path on device).

Port of ``repro.core.closed_loop`` for fault-free campaigns:

* ``DeviceTreePolicy`` / ``DeviceThresholdPolicy`` / ``PerUEPolicy`` -- host
  policies exported to device tensors.  A tree is its level-order
  ``feature``/``threshold``/``leaf_modes`` tables; the ``tree_infer``
  kernel walks them directly, so there is no packed form.
* ``DeviceSwitchState`` -- per-UE KPM window, hysteresis streak and switch
  register, carried from slot to slot.
* ``switch_update`` / ``switch_boundary`` -- a decision made during slot
  ``n`` is written to the register; only the boundary into slot ``n+1``
  makes it the active mode.  For a ``DeviceTreePolicy`` the slot loop runs
  both as one launch, ``repro_torch.kernels.tree_infer.policy_step``, whose
  plain version is this composition.
* ``host_replay_closed_loop`` -- the equivalence oracle: a slot-by-slot
  host loop through the literal host policy.  Device and host mode
  trajectories must match bitwise.

The circuit breaker and the fault masks wait for the faults slice
(ROADMAP, Queue 1: faults, streaming and checkpoints).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.telemetry import KPMRing, ring_init, ring_push, ring_window_mean
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
                  device: torch.device | str = "cpu") -> PerUEPolicy:
    """Build a validated ``PerUEPolicy`` from tables + per-UE assignment."""
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


def export_tree_tables(feature, threshold, leaf_values,
                       device: torch.device | str = "cpu") -> DeviceTreePolicy:
    """Level-order tree arrays -> a ``DeviceTreePolicy`` on ``device``."""
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
    """Per-UE control-loop state carried from slot to slot."""

    rings: KPMRing
    active_mode: torch.Tensor  # (U,) int32
    pending_mode: torch.Tensor  # (U,) int32
    streak: torch.Tensor  # (U,) int32
    n_switches: torch.Tensor  # (U,) int32


def init_device_switch(n_ues: int, n_features: int, cfg: SwitchConfig,
                       device: torch.device | str = "cpu") -> DeviceSwitchState:
    d = torch.full((n_ues,), cfg.default_mode, dtype=torch.int32, device=device)
    z = torch.zeros(n_ues, dtype=torch.int32, device=device)
    return DeviceSwitchState(
        rings=ring_init(n_ues, cfg.window_slots, n_features, device),
        active_mode=d, pending_mode=d.clone(), streak=z, n_switches=z.clone(),
    )


def switch_update(state: DeviceSwitchState, kpm_vecs: torch.Tensor,
                  policy: DevicePolicy, cfg: SwitchConfig, *,
                  decide: bool = True) -> tuple[DeviceSwitchState, torch.Tensor]:
    """Decision phase of slot ``n``: window push -> policy -> register.

    ``decide`` is False on the hold slots of a periodic policy: the KPMs
    still enter the window, but register and streak freeze and the held
    register is reported as the raw decision.
    """
    rings = ring_push(state.rings, kpm_vecs)
    window = ring_window_mean(rings, cfg.window_slots)
    if not decide:
        return state._replace(rings=rings), state.pending_mode
    raw = policy_infer(policy, window, state.pending_mode, backend=cfg.backend)
    agree = raw == state.pending_mode
    streak = torch.where(agree, torch.zeros_like(state.streak), state.streak + 1)
    commit = streak >= cfg.hysteresis_slots
    pending = torch.where(commit, raw, state.pending_mode)
    streak = torch.where(commit, torch.zeros_like(streak), streak)
    return state._replace(rings=rings, pending_mode=pending, streak=streak), raw


def switch_boundary(state: DeviceSwitchState) -> DeviceSwitchState:
    """Boundary into slot ``n+1``: the register becomes the active mode."""
    pending = state.pending_mode
    switched = (pending != state.active_mode).to(torch.int32)
    return state._replace(active_mode=pending, n_switches=state.n_switches + switched)


# -- host equivalence oracle ---------------------------------------------------


def host_replay_closed_loop(host_policy, features, cfg: SwitchConfig, *,
                            policy_idx=None) -> dict[str, np.ndarray]:
    """Replay the closed loop on the host, slot by slot, UE by UE.

    ``host_policy`` is a host object (``DecisionTreePolicy`` -- the literal
    walk per KPM vector -- or ``ThresholdPolicy``), or a sequence of them
    with ``policy_idx (U,)`` for a per-UE campaign.  ``features (S, U, F)``
    is the device trajectory's telemetry in ``cfg.feature_names`` order.
    The window reuses the ring arithmetic of the device loop (on CPU
    tensors, one UE at a time); control flow is plain Python ints.
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

    rings = [ring_init(1, cfg.window_slots, n_feat) for _ in range(n_ues)]
    active = [cfg.default_mode] * n_ues
    pending = [cfg.default_mode] * n_ues
    streak = [0] * n_ues
    n_switches = [0] * n_ues
    active_hist = np.zeros((n_slots, n_ues), np.int32)
    raw_hist = np.zeros((n_slots, n_ues), np.int32)
    pending_hist = np.zeros((n_slots, n_ues), np.int32)

    for s in range(n_slots):
        for u in range(n_ues):
            active_hist[s, u] = active[u]
            rings[u] = ring_push(rings[u], feats[s, u][None])
            window = ring_window_mean(rings[u], cfg.window_slots)[0]
            if s % cfg.period_slots != 0:
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
            raw_hist[s, u] = raw
            pending_hist[s, u] = pending[u]
            if pending[u] != active[u]:
                n_switches[u] += 1
            active[u] = pending[u]

    return {
        "active_mode": active_hist,
        "raw_decision": raw_hist,
        "pending_mode": pending_hist,
        "quarantined": np.zeros((n_slots, n_ues), np.int32),
        "n_switches": np.asarray(n_switches, np.int32),
    }
