"""Policy, telemetry window, switch register and campaign spec against ``repro``.

Everything here is integer logic, copied numpy, or elementwise float32 on
identical inputs, so it compares bitwise.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import closed_loop as rcl
from repro.core import policy as rpol
from repro.core import session as rses
from repro.core import telemetry as rtel
from repro_torch.convert import device_tree_policy, tree_policy_from_reference
from repro_torch.core import closed_loop as tcl
from repro_torch.core import policy as tpol
from repro_torch.core import session as tses
from repro_torch.core import telemetry as ttel

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

BENCH_SPEC = json.loads(
    (Path(__file__).resolve().parents[1] / "BENCH_pr10.json").read_text())["campaign_spec"]
F = len(ttel.SELECTED_KPMS)


def _dataset(rng, n, f):
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, 2] = np.round(x[:, 2] * 2) / 2  # ties between samples, as integer KPMs give
    y = (x[:, 1] - 0.7 * x[:, 2] + 0.3 * rng.normal(size=n) > 0).astype(np.int32)
    return x, y


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_decision_tree_bitwise(depth, seed):
    rng = np.random.default_rng(seed)
    x, y = _dataset(rng, 120 + 40 * seed, F)
    if seed == 2:
        y[:] = 1  # a pure node: pass-through splits all the way down
    want = rpol.fit_decision_tree(x, y, depth=depth)
    got = tpol.fit_decision_tree(x, y, depth=depth)
    for f in ("feature", "threshold", "leaf_values", "importances"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.depth, got.n_features) == (want.depth, want.n_features)
    # the host policies built on it decide alike
    names = ttel.SELECTED_KPMS
    tp = tpol.DecisionTreePolicy(got, names)
    rp = rpol.DecisionTreePolicy(want, names)
    for row in x[:25]:
        assert tp(row) == int(rp(row))
    np.testing.assert_array_equal(tp.batch(torch.as_tensor(x)).numpy(),
                                  np.asarray(rp.batch(jnp.asarray(x))))


def test_threshold_policy_bitwise(rng):
    x = rng.normal(18.0, 1.0, size=(200, F)).astype(np.float32)
    for hyst in (0.0, 0.5):
        tp = tpol.ThresholdPolicy(feature_idx=5, threshold=18.0, hysteresis=hyst)
        rp = rpol.ThresholdPolicy(feature_idx=5, threshold=18.0, hysteresis=hyst)
        for row in x[:40]:
            for prev in (0, 1):
                assert tp(row, prev_mode=prev) == int(rp(row, prev_mode=prev))


@pytest.mark.parametrize("window", [1, 2, 8])
def test_kpm_ring_bitwise(window, rng):
    n_ues, cap = 3, window
    feats = rng.normal(100.0, 50.0, size=(11, n_ues, F)).astype(np.float32)
    tr = ttel.ring_init(n_ues, cap, F, "cpu")
    rr = jax.vmap(lambda _: rtel.ring_init(cap, F))(jnp.arange(n_ues))
    for s in range(feats.shape[0]):
        tr = ttel.ring_push(tr, torch.as_tensor(feats[s]))
        rr = jax.vmap(rtel.ring_push)(rr, jnp.asarray(feats[s]))
        np.testing.assert_array_equal(tr.buf.numpy(), np.asarray(rr.buf))
        np.testing.assert_array_equal(
            ttel.ring_window_mean(tr, window).numpy(),
            np.asarray(jax.vmap(lambda r: rtel.ring_window_mean(r, window))(rr)))


def test_trajectory_kpm_matrix(rng):
    kpms = {"aerial": {n: rng.normal(size=(4, 3)).astype(np.float32)
                       for n in ttel.SELECTED_KPMS[:5]},
            "oai": {n: rng.normal(size=(4, 3)).astype(np.float32)
                    for n in ttel.SELECTED_KPMS[5:]}}
    assert ttel.SELECTED_KPMS == rtel.SELECTED_KPMS
    got = ttel.trajectory_kpm_matrix(
        {s: {k: torch.as_tensor(v) for k, v in d.items()} for s, d in kpms.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(rtel.trajectory_kpm_matrix(kpms)))


def _tree(rng):
    x, y = _dataset(rng, 200, F)
    return rpol.fit_decision_tree(x, y, depth=2), x


@pytest.mark.parametrize("kind", ["tree", "threshold", "per_ue"])
@pytest.mark.parametrize("hyst,period", [(1, 1), (2, 1), (1, 3)])
def test_switch_register_and_host_replay_bitwise(kind, hyst, period, rng):
    """Device switch register (window -> policy -> hysteresis -> boundary)
    and the host replay oracle, both against ``repro``'s, on one KPM stream."""
    n_slots, n_ues = 14, 4
    tree, x = _tree(rng)
    feats = x[rng.integers(0, len(x), size=n_slots * n_ues)].reshape(n_slots, n_ues, F)
    thr = dict(feature_idx=1, threshold=0.0, hysteresis=0.2)
    if kind == "tree":
        rpolicy = rpol.DecisionTreePolicy(tree, ttel.SELECTED_KPMS)
        tpolicy = tree_policy_from_reference(tree.feature, tree.threshold,
                                             tree.leaf_values, ttel.SELECTED_KPMS)
        rdev, tdev = rpolicy.to_device(), device_tree_policy(
            tree.feature, tree.threshold, tree.leaf_values)
        extra_r, extra_t = {}, {}
    elif kind == "threshold":
        rpolicy, tpolicy = rpol.ThresholdPolicy(**thr), tpol.ThresholdPolicy(**thr)
        rdev, tdev = rpolicy.to_device(), tpolicy.to_device("cpu")
        extra_r, extra_t = {}, {}
    else:
        rp = [rpol.DecisionTreePolicy(tree, ttel.SELECTED_KPMS), rpol.ThresholdPolicy(**thr)]
        tp = [tree_policy_from_reference(tree.feature, tree.threshold, tree.leaf_values,
                                         ttel.SELECTED_KPMS), tpol.ThresholdPolicy(**thr)]
        assign = [0, 1, 1, 0]
        rpolicy, tpolicy = rp, tp
        rdev = rcl.per_ue_policy([p.to_device() for p in rp], assign)
        tdev = tcl.per_ue_policy([p.to_device("cpu") for p in tp], assign, "cpu")
        extra_r = extra_t = {"policy_idx": assign}

    kw = dict(window_slots=3, hysteresis_slots=hyst, period_slots=period, backend="ref")
    rcfg = rcl.SwitchConfig(feature_names=ttel.SELECTED_KPMS, **kw)
    tcfg = tcl.SwitchConfig(feature_names=ttel.SELECTED_KPMS, **kw)
    rs = rcl.init_device_switch(n_ues, F, rcfg)
    ts = tcl.init_device_switch(n_ues, F, tcfg, "cpu")
    t_active = []
    for s in range(n_slots):
        decide = s % period == 0
        rs, rraw = rcl.switch_update(rs, jnp.asarray(feats[s]), rdev, rcfg,
                                     decide=True if period == 1 else jnp.asarray(decide))
        ts, traw = tcl.switch_update(ts, torch.as_tensor(feats[s]), tdev,
                                     tcl.SwitchConfig(feature_names=ttel.SELECTED_KPMS,
                                                      **dict(kw, backend="auto")),
                                     decide=decide)
        np.testing.assert_array_equal(traw.numpy(), np.asarray(rraw))
        np.testing.assert_array_equal(ts.pending_mode.numpy(), np.asarray(rs.pending_mode))
        np.testing.assert_array_equal(ts.streak.numpy(), np.asarray(rs.streak))
        t_active.append(ts.active_mode.numpy())
        rs, ts = rcl.switch_boundary(rs), tcl.switch_boundary(ts)
        np.testing.assert_array_equal(ts.active_mode.numpy(), np.asarray(rs.active_mode))
    np.testing.assert_array_equal(ts.n_switches.numpy(), np.asarray(rs.n_switches))

    want = rcl.host_replay_closed_loop(rpolicy, feats, rcfg, **extra_r)
    got = tcl.host_replay_closed_loop(tpolicy, feats, tcfg, **extra_t)
    for k in ("active_mode", "raw_decision", "pending_mode", "n_switches"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the device register and its host replay agree inside the port too
    np.testing.assert_array_equal(np.stack(t_active), got["active_mode"])


def test_spec_hash_matches_reference():
    ts = tses.CampaignSpec.from_dict(BENCH_SPEC)
    rs = rses.CampaignSpec.from_dict(BENCH_SPEC)
    assert tses.spec_hash(ts) == rses.spec_hash(rs) == "330438eecf513f4e"
    assert ts.to_json() == rs.to_json()
    assert tses.CampaignSpec.from_json(ts.to_json()) == ts
    for kw in (dict(), dict(path="closed_loop", n_ues=32, n_prb=106, seed=7,
                            scenario_args=(("poor_start", 13), ("poor_end", 27)))):
        t = tses.CampaignSpec(policies=(tses.PolicySpec(kind="tree"),),
                              bank=tses.ExpertBankSpec(channels=32, n_res_blocks=4), **kw)
        r = rses.CampaignSpec(policies=(rses.PolicySpec(kind="tree"),),
                              bank=rses.ExpertBankSpec(channels=32, n_res_blocks=4), **kw)
        assert tses.spec_hash(t) == rses.spec_hash(r)
    # arrays and tensors normalize to the same JSON
    t = tses.CampaignSpec(modes=torch.tensor([0, 1, 1]), n_slots=3)
    r = rses.CampaignSpec(modes=np.array([0, 1, 1]), n_slots=3)
    assert tses.spec_hash(t) == rses.spec_hash(r)


def test_unported_paths_raise():
    """Every campaign option of the reference's spec builds: an unknown
    ``FaultSpec`` field raises the error type the reference raises; a
    topology spec builds a ``TopologySpec`` and its session a one-shard
    layout, and the ``multi_cell`` and ``churn_cell`` scenarios build one
    schedule per UE (they run in tests/test_torch_topology.py and
    tests/test_torch_streaming.py); the host and perturbed paths and
    SELECTED_ONLY banks build (they run in tests/test_torch_host_path.py and
    tests/test_torch_methodology.py)."""
    with pytest.raises(Exception) as ref_err:
        rses.CampaignSpec(faults={"decision_loss": 0.1})
    with pytest.raises(type(ref_err.value), match="decision_loss"):
        tses.CampaignSpec(faults={"decision_loss": 0.1})
    from repro_torch.core.topology import TopologySpec
    from repro_torch.phy.scenario import get_scenario

    spec = tses.CampaignSpec(topology={"n_cells": 2}, scenario="multi_cell")
    assert spec.topology == TopologySpec(n_cells=2)
    assert tses.ArchesSession(spec, device="cpu").cell_topology.n_shards == 1
    assert len(get_scenario("multi_cell").schedule(n_ues=4)) == 4
    assert len(get_scenario("churn_cell").schedule(n_ues=5)) == 5
    for spec in (
            tses.CampaignSpec(path="host", n_ues=1, policies=(tses.PolicySpec(),)),
            tses.CampaignSpec(path="perturbed", n_ues=2, rho=(0.0, 1.0)),
            tses.CampaignSpec(bank=tses.ExpertBankSpec(execution_mode="selected_only"))):
        sess = tses.ArchesSession(spec, device="cpu")
        assert sess.path is tses.ExecutionPath.coerce(spec.path)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        tses.ArchesSession(tses.CampaignSpec())
