"""Decision-tree inference and the closed loop's fused decision phase: the
wrappers of the hand-written kernels and their plain PyTorch versions.

``tree_infer(x, feature, threshold, leaf_values, depth)`` replaces
``repro.kernels.tree_infer.ops.tree_infer``.  It takes the level-order
tables directly (children of node ``n`` are ``2n+1``/``2n+2``; go right if
``x[feature] > threshold``), so there is no ``pack_tree`` step.  On a CUDA
tensor it launches ``csrc/tree_infer.cu`` (or raises); on a CPU tensor it
runs ``tree_infer_ref``, the literal walk the reference uses as its oracle.

``policy_step(state, kpm_vecs, policy, cfg, decide=..., ...)`` is one
slot's decision phase for every UE -- ring push, window mean, tree walk,
hysteresis register, slot boundary, and under faults and churn the masks,
the TTL decay, the circuit breaker and the detached lanes' freeze -- in one
launch of the same source's second entry point for a ``DeviceTreePolicy``
on a CUDA tensor.  It returns a new state and the raw decisions (and, if
asked, the register as the decision left it), and leaves its inputs as
they were.  Its
plain version ``policy_step_ref`` is the composition ``switch_update`` ->
``switch_boundary`` -> ``breaker_update`` -> freeze; it runs on a CPU
tensor, with ``cfg.backend == "ref"``, and for threshold and per-UE
policies on any device.  Either launch counts under ``tree_infer``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
#: (x, feature, threshold, leaves, out, rows, features, depth, stream)
_TREE_ARGS = (_P,) * 5 + (_I,) * 3 + (_P,)
#: (state in, kpm, feature, threshold, leaves, masks, state out, raw, register, n_ues,
#: ring capacity, features, window, depth, hysteresis, decide, slot, ttl, default mode,
#: breaker trips, breaker window, breaker cooldown, stream)
_STEP_ARGS = ((ctypes.POINTER(_P), _P, _P, _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P),
               _P, _P) + (_I,) * 13 + (_P,))
_STATE = _P * 10
_MASKS = _P * 4
#: the policy step keeps a block's window means in shared memory: 8 UEs x F floats
MAX_STEP_FEATURES = 1536


def tree_infer_ref(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
                   leaf_values: torch.Tensor, depth: int) -> torch.Tensor:
    """Plain version: descend the complete binary tree for each row of ``x``."""
    idx = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    feature = feature.to(torch.int64)
    for _ in range(depth):
        f = feature[idx]
        go_right = torch.gather(x, 1, f[:, None])[:, 0] > threshold[idx]
        idx = 2 * idx + 1 + go_right.to(torch.int64)
    return leaf_values[idx - (2**depth - 1)]


def _check_tables(dev: int, feature, threshold, leaf_values, depth: int) -> None:
    n_nodes = 2**depth - 1
    if feature.shape != (n_nodes,) or threshold.shape != (n_nodes,):
        raise ValueError(f"depth {depth} needs {n_nodes} internal nodes")
    if leaf_values.shape != (2**depth,):
        raise ValueError(f"depth {depth} needs {2**depth} leaves")
    if dev < 0:
        return
    for t, dt in ((feature, torch.int32), (threshold, torch.float32),
                  (leaf_values, torch.float32)):
        if t.dtype is not dt or t.get_device() != dev or not t.is_contiguous():
            raise ValueError("the tree kernels need contiguous float32 thresholds and "
                             "leaves and int32 features on the input's device")


def tree_infer(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
               leaf_values: torch.Tensor, depth: int) -> torch.Tensor:
    """Evaluate the tree on ``x (B, F)`` float32 -> float32 predictions ``(B,)``."""
    if x.ndim != 2:
        raise ValueError(f"x must be (B, F), got {tuple(x.shape)}")
    dev = x.get_device()
    _check_tables(dev, feature, threshold, leaf_values, depth)
    if dev < 0:
        return tree_infer_ref(x, feature, threshold, leaf_values, depth)
    if x.dtype is not torch.float32 or not x.is_contiguous():
        raise ValueError("tree_infer kernel needs a contiguous float32 x")
    rows = x.shape[0]
    out = build.unfilled(torch.empty, rows, dtype=torch.float32, device=x.device)
    fn = build.function("tree_infer", "tree_infer_launch", _TREE_ARGS)
    build.check(fn(x.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
                   leaf_values.data_ptr(), out.data_ptr(), rows, x.shape[1], depth,
                   build.stream(x)), "tree_infer")
    build.launch_counts["tree_infer"] += 1
    return out


class _Ladder(NamedTuple):
    """What a decision slot's fault ladder and streaming mask hand the step,
    in the order of the kernel's ``Masks``."""

    telemetry_valid: torch.Tensor | None
    decision_valid: torch.Tensor | None
    trip: torch.Tensor | None
    active: torch.Tensor | None


def policy_step_ref(state, kpm_vecs: torch.Tensor, policy, cfg, *, decide: bool = True,
                    decision_valid=None, telemetry_valid=None, trip=None, active=None,
                    slot_idx: int = 0, faults=None, return_register: bool = False):
    """Plain version: ``switch_update`` -> ``switch_boundary`` (with the TTL
    decay under ``faults``) -> ``breaker_update`` (where ``trip`` is given)
    -> the detached lanes' freeze (where ``active`` is given).

    Returns ``(new state, raw decisions)``, and with ``return_register``
    also the register as the decision left it (before the boundary); a
    detached lane reports 0 for both.
    """
    from repro_torch.core.closed_loop import (
        breaker_update,
        select_rows,
        switch_boundary,
        switch_update,
    )

    new, raw = switch_update(state, kpm_vecs, policy, cfg, decide=decide,
                             decision_valid=decision_valid, telemetry_valid=telemetry_valid)
    reg = new.pending_mode
    if faults is not None:
        new = switch_boundary(new, ttl_slots=cfg.ttl_slots, fail_safe_mode=cfg.default_mode)
    else:
        new = switch_boundary(new)
    if trip is not None:
        new = breaker_update(new, trip, slot_idx, faults)
    if active is not None:
        new = select_rows(active, new, state)
        raw = torch.where(active, raw, torch.zeros_like(raw))
        reg = torch.where(active, reg, torch.zeros_like(reg))
    return (new, raw, reg) if return_register else (new, raw)


def policy_step(state, kpm_vecs: torch.Tensor, policy, cfg, *, decide: bool = True,
                decision_valid=None, telemetry_valid=None, trip=None, active=None,
                slot_idx: int = 0, faults=None, return_register: bool = False):
    """Slot ``n``'s decision phase and the boundary into slot ``n + 1``:
    ``(new state, raw decisions (U,) int32)``, and with ``return_register``
    the register (U,) int32 as the decision left it, before the boundary.

    ``state`` is a ``DeviceSwitchState``, ``kpm_vecs (U, F)`` the slot's
    KPMs in ``cfg.feature_names`` order, ``decide`` False on a periodic
    policy's hold slots.  ``faults`` (a ``FaultSpec``) arms the TTL decay at
    ``cfg.ttl_slots`` and gives the breaker its settings; the ``(U,)`` bool
    masks ``decision_valid``, ``telemetry_valid``, ``trip`` (this slot's
    health or audit trips) and ``active`` (the streaming mask) may each be
    None; ``slot_idx`` is the global slot index (the breaker's ring
    position).  For a ``DeviceTreePolicy`` on a CUDA tensor (``cfg.backend``
    "auto", "pallas" or "cuda") one launch writes the whole new state; a CPU
    tensor, ``cfg.backend == "ref"`` or another policy takes the plain
    version.
    """
    from repro_torch.core.closed_loop import DeviceTreePolicy

    if cfg.backend not in ("auto", "pallas", "cuda", "ref"):
        raise ValueError(f"unknown policy backend {cfg.backend!r}")
    if trip is not None and faults is None:
        raise ValueError("the breaker needs the FaultSpec's settings (faults=...)")
    ladder = _Ladder(telemetry_valid, decision_valid, trip, active)
    rings = state.rings
    dev = kpm_vecs.get_device()
    if dev < 0 or cfg.backend == "ref" or not isinstance(policy, DeviceTreePolicy):
        return policy_step_ref(state, kpm_vecs, policy, cfg, decide=decide,
                               slot_idx=slot_idx, faults=faults,
                               return_register=return_register, **ladder._asdict())
    n_ues, cap, n_feat = rings.buf.shape
    depth = policy.depth
    _check_tables(dev, policy.feature, policy.threshold, policy.leaf_modes, depth)
    if n_feat > MAX_STEP_FEATURES:
        raise ValueError(f"the policy step takes at most {MAX_STEP_FEATURES} KPMs, "
                         f"not {n_feat}")
    window = state.trip_ring.shape[1]
    ins = (rings.buf, rings.idx, rings.count, state.active_mode, state.pending_mode,
           state.streak, state.n_switches, state.decision_age, state.trip_ring,
           state.quarantine)
    dtypes = (torch.float32,) + (torch.int64,) * 2 + (torch.int32,) * 7
    shapes = ((n_ues, cap, n_feat),) + ((n_ues,),) * 7 + ((n_ues, window), (n_ues,))
    for t, dt, shape in zip(ins + (kpm_vecs,), dtypes + (torch.float32,),
                            shapes + ((n_ues, n_feat),)):
        if t.dtype is not dt or t.shape != shape or t.get_device() != dev \
                or not t.is_contiguous():
            raise ValueError(f"policy step needs contiguous {dt} {shape} state and KPMs "
                             f"on one device, got {t.dtype} {tuple(t.shape)}")
    for name, t in ladder._asdict().items():
        if t is not None and (t.dtype is not torch.bool or t.shape != (n_ues,)
                              or t.get_device() != dev or not t.is_contiguous()):
            raise ValueError(f"policy step needs {name} as a contiguous ({n_ues},) bool "
                             f"mask on the state's device")
    buf = build.unfilled(torch.empty_like, rings.buf)
    i64 = build.unfilled(torch.empty, (2, n_ues), dtype=torch.int64, device=kpm_vecs.device)
    i32 = build.unfilled(torch.empty, (8, n_ues), dtype=torch.int32, device=kpm_vecs.device)
    trip_ring = build.unfilled(torch.empty_like, state.trip_ring)
    idx, count = i64
    active_mode, pending, streak, n_switches, age, quarantine, raw, reg = i32
    outs = (buf, idx, count, active_mode, pending, streak, n_switches, age, trip_ring,
            quarantine)
    ttl = cfg.ttl_slots if faults is not None else 0
    breaker = ((faults.breaker_trips, faults.breaker_cooldown) if faults is not None
               else (1, 0))
    fn = build.function("tree_infer", "policy_step_launch", _STEP_ARGS)
    build.check(fn(_STATE(*[t.data_ptr() for t in ins]), kpm_vecs.data_ptr(),
                   policy.feature.data_ptr(), policy.threshold.data_ptr(),
                   policy.leaf_modes.data_ptr(),
                   _MASKS(*[None if t is None else t.data_ptr() for t in ladder]),
                   _STATE(*[t.data_ptr() for t in outs]), raw.data_ptr(), reg.data_ptr(),
                   n_ues, cap, n_feat, min(cfg.window_slots, cap), depth,
                   cfg.hysteresis_slots, int(decide), int(slot_idx), ttl, cfg.default_mode,
                   breaker[0], window, breaker[1], build.stream(kpm_vecs)), "policy_step")
    build.launch_counts["tree_infer"] += 1
    new = state._replace(rings=rings._replace(buf=buf, idx=idx, count=count),
                         active_mode=active_mode, pending_mode=pending, streak=streak,
                         n_switches=n_switches, decision_age=age, trip_ring=trip_ring,
                         quarantine=quarantine)
    return (new, raw, reg) if return_register else (new, raw)
