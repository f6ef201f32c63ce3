"""The fused decision phase against ``repro``'s.

``policy_step`` (on the CPU its plain version ``policy_step_ref``, the
composition ``switch_update`` then ``switch_boundary``) is held against
``repro``'s ``switch_update`` then ``switch_boundary`` run through JAX on the
CPU, slot by slot, on KPM streams made with numpy from a seed.  Everything
here is integer logic or elementwise float32 on identical inputs, so modes,
register, streak, switch counts, the ring and its window mean compare
bitwise.  The kernel itself runs on the card (``test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import closed_loop as rcl
from repro.core import policy as rpol
from repro.core import telemetry as rtel
from repro_torch.convert import device_tree_policy
from repro_torch.core import closed_loop as tcl
from repro_torch.core import telemetry as ttel
from repro_torch.kernels.tree_infer import policy_step, policy_step_ref

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

F = len(ttel.SELECTED_KPMS)
WINDOW = 8


def _stream(rng, n_slots, n_ues):
    """KPMs whose means move between phases, so the window's decisions change."""
    shift = np.where((np.arange(n_slots) // 5) % 2 == 0, -1.0, 1.0)[:, None, None]
    return (shift + rng.normal(size=(n_slots, n_ues, F))).astype(np.float32)


def _tree(rng, depth):
    """A fitted tree on labelled KPMs (pass-through nodes included)."""
    x = rng.normal(size=(400, F)).astype(np.float32)
    y = (x[:, 1] + 0.5 * x[:, 4] - 0.3 * x[:, 7] + 0.4 * rng.normal(size=400) > 0)
    return rpol.fit_decision_tree(x, y.astype(np.int32), depth=depth)


@pytest.mark.parametrize("depth", [2, 3, 5])
@pytest.mark.parametrize("hyst", [1, 3])
@pytest.mark.parametrize("period", [1, 2])
def test_policy_step_matches_reference(depth, hyst, period):
    rng = np.random.default_rng(100 * depth + 10 * hyst + period)
    n_slots, n_ues = 12, 4  # the first WINDOW - 1 slots average fewer than WINDOW
    feats = _stream(rng, n_slots, n_ues)
    tree = _tree(rng, depth)
    rdev = rpol.DecisionTreePolicy(tree, ttel.SELECTED_KPMS).to_device()
    tdev = device_tree_policy(tree.feature, tree.threshold, tree.leaf_values)
    kw = dict(feature_names=ttel.SELECTED_KPMS, window_slots=WINDOW, hysteresis_slots=hyst,
              period_slots=period)
    rcfg = rcl.SwitchConfig(**kw, backend="ref")
    tcfg = tcl.SwitchConfig(**kw)
    rs = rcl.init_device_switch(n_ues, F, rcfg)
    ts = tcl.init_device_switch(n_ues, F, tcfg, "cpu")
    raws = []
    for s in range(n_slots):
        decide = s % period == 0
        rs, rraw = rcl.switch_update(rs, jnp.asarray(feats[s]), rdev, rcfg,
                                     decide=True if period == 1 else jnp.asarray(decide))
        rs = rcl.switch_boundary(rs)
        held = ts.pending_mode
        ts, traw = policy_step(ts, torch.as_tensor(feats[s]), tdev, tcfg, decide=decide)
        raws.append(traw.numpy())
        np.testing.assert_array_equal(traw.numpy(), np.asarray(rraw))
        if not decide:  # a hold slot reports the held register
            np.testing.assert_array_equal(traw.numpy(), held.numpy())
        for name in ("active_mode", "pending_mode", "streak", "n_switches"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(rs, name)), err_msg=name)
        for name in ("buf", "idx", "count"):
            np.testing.assert_array_equal(getattr(ts.rings, name).numpy(),
                                          np.asarray(getattr(rs.rings, name)), err_msg=name)
        np.testing.assert_array_equal(
            ttel.ring_window_mean(ts.rings, WINDOW).numpy(),
            np.asarray(jax.vmap(lambda r: rtel.ring_window_mean(r, WINDOW))(rs.rings)))
    # the stream made the policy change its mind
    assert len(np.unique(np.stack(raws))) > 1


def test_policy_step_leaves_its_inputs_and_routes_by_backend(rng):
    """The step returns a new state and leaves the old one as it was (later
    slices hold old states); ``backend="ref"`` and a CPU tensor take the
    plain version, bitwise the same."""
    tree = _tree(rng, 2)
    pol = device_tree_policy(tree.feature, tree.threshold, tree.leaf_values)
    feats = _stream(rng, 3, 5)
    cfg = tcl.SwitchConfig(feature_names=ttel.SELECTED_KPMS, window_slots=WINDOW)
    state = tcl.init_device_switch(5, F, cfg, "cpu")
    for s in range(3):
        before = [t.clone() for t in (*state.rings, *state[1:])]
        new, raw = policy_step(state, torch.as_tensor(feats[s]), pol, cfg)
        for t, b in zip((*state.rings, *state[1:]), before):
            assert torch.equal(t, b)
        ref, ref_raw = policy_step_ref(state, torch.as_tensor(feats[s]), pol,
                                       tcl.SwitchConfig(**dict(vars(cfg), backend="ref")))
        assert torch.equal(raw, ref_raw)
        for a, b in zip((*new.rings, *new[1:]), (*ref.rings, *ref[1:])):
            assert torch.equal(a, b)
        state = new
    with pytest.raises(ValueError, match="backend"):
        policy_step(state, torch.as_tensor(feats[0]), pol,
                    tcl.SwitchConfig(**dict(vars(cfg), backend="nope")))


#: the masks, TTL, breaker and detached lanes one at a time, then all at once
LADDER_CASES = {
    "telemetry": dict(tv=0.6),
    "decision": dict(dv=0.6),
    "ttl": dict(dv=0.5, ttl=True),
    "breaker": dict(trip=0.4),
    "active": dict(act=0.7),
    "all": dict(tv=0.7, dv=0.7, ttl=True, trip=0.3, act=0.8),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
@pytest.mark.parametrize("period", [1, 2])
def test_policy_step_ladder_matches_reference(case, period):
    """``policy_step`` (its plain version on the CPU) with the fault masks,
    the TTL decay, the breaker and the detached lanes' freeze, bitwise
    against ``repro``'s ``switch_update`` -> ``switch_boundary(ttl)`` ->
    ``breaker_update`` -> the streaming freeze, slot by slot on random masks:
    every state leaf, the raw decisions and the register."""
    from repro.core import faults as rfaults
    from repro_torch.core import faults as tfaults

    arm = LADDER_CASES[case]
    rng = np.random.default_rng(period * 31 + len(case))
    n_slots, n_ues = 24, 6
    feats = _stream(rng, n_slots, n_ues)
    tree = _tree(rng, 3)
    rdev = rpol.DecisionTreePolicy(tree, ttel.SELECTED_KPMS).to_device()
    tdev = device_tree_policy(tree.feature, tree.threshold, tree.leaf_values)
    fs_kw = dict(breaker_trips=2, breaker_window=3, breaker_cooldown=2)
    armed = any(k in arm for k in ("tv", "dv", "ttl", "trip"))
    rfs = rfaults.FaultSpec(**fs_kw) if armed else None
    tfs = tfaults.FaultSpec(**fs_kw) if armed else None
    kw = dict(feature_names=ttel.SELECTED_KPMS, window_slots=4, hysteresis_slots=2,
              period_slots=period, ttl_slots=3 if arm.get("ttl") else 16)
    rcfg = rcl.SwitchConfig(**kw, backend="ref")
    tcfg = tcl.SwitchConfig(**kw)
    rs = rcl.init_device_switch(n_ues, F, rcfg, rfs)
    ts = tcl.init_device_switch(n_ues, F, tcfg, "cpu", faults=tfs)

    def draw(key):
        p = arm.get(key)
        return None if p is None else rng.random((n_slots, n_ues)) < p

    tv, dv, trip, act = draw("tv"), draw("dv"), draw("trip"), draw("act")
    if armed:  # under a FaultSpec both masks ride along, as the slot loop passes them
        tv = np.ones((n_slots, n_ues), bool) if tv is None else tv
        dv = np.ones((n_slots, n_ues), bool) if dv is None else dv
        trip = np.zeros((n_slots, n_ues), bool) if trip is None else trip

    def at(m, s, lib):
        return None if m is None else (jnp.asarray(m[s]) if lib == "jax"
                                       else torch.as_tensor(m[s]))

    stale = entered = 0
    for s in range(n_slots):
        decide = s % period == 0
        new_r, rraw = rcl.switch_update(
            rs, jnp.asarray(feats[s]), rdev, rcfg,
            decide=True if period == 1 else jnp.asarray(decide),
            decision_valid=at(dv, s, "jax"), telemetry_valid=at(tv, s, "jax"))
        rreg = new_r.pending_mode
        if armed:
            new_r = rcl.switch_boundary(new_r, ttl_slots=rcfg.ttl_slots,
                                        fail_safe_mode=rcfg.default_mode)
            new_r = rcl.breaker_update(new_r, jnp.asarray(trip[s]), jnp.int32(s), rfs)
        else:
            new_r = rcl.switch_boundary(new_r)
        if act is not None:
            a = jnp.asarray(act[s])
            new_r = jax.tree.map(
                lambda n, o: jnp.where(a.reshape(a.shape + (1,) * (n.ndim - 1)), n, o),
                new_r, rs)
            rraw, rreg = jnp.where(a, rraw, 0), jnp.where(a, rreg, 0)
        rs = new_r
        ts, traw, treg = policy_step(
            ts, torch.as_tensor(feats[s]), tdev, tcfg, decide=decide,
            decision_valid=at(dv, s, "torch"), telemetry_valid=at(tv, s, "torch"),
            trip=at(trip, s, "torch"), active=at(act, s, "torch"), slot_idx=s, faults=tfs,
            return_register=True)
        np.testing.assert_array_equal(traw.numpy(), np.asarray(rraw), err_msg=f"raw {s}")
        np.testing.assert_array_equal(treg.numpy(), np.asarray(rreg), err_msg=f"reg {s}")
        for name in ("active_mode", "pending_mode", "streak", "n_switches", "decision_age",
                     "trip_ring", "quarantine"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(rs, name)), err_msg=f"{name} {s}")
        for name in ("buf", "idx", "count"):
            np.testing.assert_array_equal(getattr(ts.rings, name).numpy(),
                                          np.asarray(getattr(rs.rings, name)), err_msg=name)
        stale += int((ts.decision_age > 3).sum())
        entered += int((ts.quarantine == 2).sum())
    # non-vacuous: the TTL aged some UE out, the breaker quarantined some UE
    assert stale > 0 or not arm.get("ttl")
    assert entered > 0 or "trip" not in arm
