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
    ts = tcl.init_device_switch(n_ues, F, tcfg)
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
    state = tcl.init_device_switch(5, F, cfg)
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
