"""The fault ladder through both packages.

``FaultSpec`` (validation, JSON, ``spec_hash``, resolved masks) against
``repro``'s; closed- and open-loop campaigns under NaN, Inf and scale
corruption, telemetry loss and decision loss, run by both packages from one
spec: modes, decisions, switch counts, MCS, TB outcomes, ``health_tripped``
and ``quarantined`` equal, KPMs within 1e-4 relative (as in
``test_torch_campaign``); the port's device loop equal to its host replay;
``FaultSpec()`` bitwise ``faults=None``; and the breaker and the TTL decay
unit by unit against ``repro``'s.  The shapes are the reference's fault tests'
(n_prb 6, 4 UEs, 16 slots).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import closed_loop as rcl
from repro.core import faults as rfaults
from repro.core import policy as rpol
from repro.core import session as rses
from repro_torch.convert import tree_policy_from_reference
from repro_torch.core import closed_loop as tcl
from repro_torch.core import faults as tfaults
from repro_torch.core import policy as tpol
from repro_torch.core import session as tses
from repro_torch.core.telemetry import SELECTED_KPMS

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

KPM_RTOL, KPM_ATOL = 1e-4, 1e-4
N_PRB, N_SLOTS, N_UES = 6, 16, 4

#: every failure class armed, the breaker included (the reference's own)
FULL = dict(seed=3, decision_outages=((10, 14),), decision_drop_prob=0.1,
            corruption_spans=((2, 8),), corruption_kind="nan", telemetry_spans=((4, 6),),
            telemetry_drop_prob=0.1, breaker_trips=2, breaker_window=4, breaker_cooldown=3)
#: always decides the AI expert: the modes follow the fault schedule alone
AI_POLICY = dict(kind="threshold", feature="snr", threshold=1e9)


def _tree(seed=11):
    """A depth-2 tree fitted on labelled KPMs, as both packages' host objects."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, len(SELECTED_KPMS))).astype(np.float32)
    x[:, 5] = 6.0 + 6.0 * x[:, 5]  # snr-like
    y = (x[:, 5] < 7.0).astype(np.int32)
    t = rpol.fit_decision_tree(x, y, depth=2)
    ref = rpol.DecisionTreePolicy(t, SELECTED_KPMS)
    return ref, tree_policy_from_reference(t.feature, t.threshold, t.leaf_values, SELECTED_KPMS)


def _spec(path="closed_loop", faults=None, policy=AI_POLICY, **kw):
    d = dict(path=path, scenario="good_poor_good", n_ues=N_UES, n_slots=N_SLOTS, n_prb=N_PRB,
             seed=5, faults=faults)
    if path == "closed_loop":
        d["policies"] = [dict(policy)]
        d["switch"] = dict(window_slots=2, backend="ref", ttl_slots=3)
    d.update(kw)
    return d


CAMPAIGNS = {
    "closed_nan_full": _spec(faults=FULL),
    "closed_tree_inf": _spec(faults=dict(FULL, corruption_kind="inf", seed=4),
                             policy=dict(kind="tree")),
    "closed_fused_gated": _spec(faults=FULL, bank=dict(execution_mode="gated", fused=True,
                                                       gated_capacity=2)),
    "open_nan": _spec("batched", faults=dict(corruption_spans=((3, 8),), seed=1), modes=0),
    "open_scale": _spec("batched", faults=dict(corruption_spans=((3, 8),),
                                               corruption_kind="scale"), modes=0),
}


@pytest.fixture(scope="module")
def runs():
    ref_tree, port_tree = _tree()
    out = {}
    for name, d in CAMPAIGNS.items():
        tree = d.get("policies", [{}])[0].get("kind") == "tree"
        rspec, tspec = rses.CampaignSpec.from_dict(d), tses.CampaignSpec.from_dict(d)
        rhist = rses.ArchesSession(rspec, host_policies=(ref_tree,) if tree else None).run()
        tsess = tses.ArchesSession(tspec, device="cpu", host_policies=(port_tree,) if tree
                                   else None)
        out[name] = (rspec, rhist, tspec, tsess, tsess.run())
    return out


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_fault_campaign_matches_reference(runs, name):
    rspec, rhist, tspec, _, thist = runs[name]
    assert tses.spec_hash(tspec) == rses.spec_hash(rspec)
    np.testing.assert_array_equal(thist.modes, rhist.modes)
    for k in ("mcs", "tb_ok", "tbs", "health_tripped", "gated_overflow", "audit_tripped",
              "quarantined", "executed_flops"):
        if k in rhist.outputs:
            np.testing.assert_array_equal(thist.outputs[k], rhist.outputs[k], err_msg=k)
    assert set(thist.outputs) == set(rhist.outputs)
    if rhist.decisions is not None:
        np.testing.assert_array_equal(thist.decisions, rhist.decisions)
        np.testing.assert_array_equal(thist.n_switches, rhist.n_switches)
    assert set(thist.kpms) == set(rhist.kpms)
    for k, want in rhist.kpms.items():
        assert np.isfinite(thist.kpms[k]).all(), k
        np.testing.assert_allclose(thist.kpms[k], want, rtol=KPM_RTOL, atol=KPM_ATOL,
                                   err_msg=k)


def test_fault_campaigns_fire_the_ladder(runs):
    """Non-vacuous: the screen trips in the corruption span only, UEs enter
    quarantine and leave it, the TTL decays the outage to MMSE, and a scaled
    corruption stays finite (the screen's blind spot)."""
    hist = runs["closed_nan_full"][4]
    ht, q = hist.outputs["health_tripped"], hist.outputs["quarantined"]
    assert ht[2:8].sum() > 0 and ht[:2].sum() == 0 and ht[8:].sum() == 0
    assert hist.quarantined_slot_ues > 0 and (q[-2:] == 0).all()
    assert (hist.modes[13:14] == 1).all()  # ttl 3: outage slots 10-12 decay into 13
    assert runs["closed_tree_inf"][4].health_tripped_slot_ues > 0
    assert runs["closed_fused_gated"][4].quarantined_slot_ues > 0
    assert runs["open_nan"][4].health_tripped_slot_ues > 0
    assert runs["open_scale"][4].health_tripped_slot_ues == 0


@pytest.mark.parametrize("name", ["closed_nan_full", "closed_tree_inf", "closed_fused_gated"])
def test_device_loop_equals_host_replay(runs, name):
    _, _, _, tsess, thist = runs[name]
    rep = tsess.host_replay(thist)
    np.testing.assert_array_equal(thist.modes, rep["active_mode"])
    np.testing.assert_array_equal(thist.decisions, rep["raw_decision"])
    np.testing.assert_array_equal(thist.n_switches, rep["n_switches"])
    np.testing.assert_array_equal(thist.outputs["quarantined"] > 0, rep["quarantined"] > 0)


@pytest.mark.parametrize("path", ["batched", "gated", "closed_loop"])
def test_zero_fault_spec_is_bitwise_identity(path):
    """``FaultSpec()`` arms the ladder and changes no bit of any leaf."""
    d = _spec(path, n_slots=6)
    hists = [tses.ArchesSession(tses.CampaignSpec.from_dict(dict(d, faults=f)),
                                device="cpu").run() for f in (None, {})]
    a, b = hists
    np.testing.assert_array_equal(a.modes, b.modes)
    assert set(a.kpms) == set(b.kpms) and set(a.outputs) == set(b.outputs)
    for k in a.kpms:
        np.testing.assert_array_equal(a.kpms[k], b.kpms[k], err_msg=k)
    for k in a.outputs:
        np.testing.assert_array_equal(a.outputs[k], b.outputs[k], err_msg=k)
    if path == "closed_loop":
        np.testing.assert_array_equal(a.decisions, b.decisions)
        np.testing.assert_array_equal(a.n_switches, b.n_switches)


@pytest.mark.parametrize("bad", [
    dict(decision_outages=((5, 3),)), dict(decision_drop_prob=1.5),
    dict(corruption_kind="zero"), dict(corruption_scale=0.0), dict(breaker_window=0),
    dict(telemetry_spans=((-1, 2),)), dict(decision_loss=0.1)])
def test_fault_spec_validation_matches_reference(bad):
    with pytest.raises(Exception) as rerr:
        rfaults.FaultSpec(**bad)
    with pytest.raises(type(rerr.value)):
        tfaults.FaultSpec(**bad)
    with pytest.raises(type(rerr.value)):
        tses.CampaignSpec(faults=bad)


def test_fault_spec_json_round_trip_hash_and_masks():
    fs = tfaults.FaultSpec(**FULL)
    assert tfaults.FaultSpec.from_dict(dataclasses.asdict(fs)) == fs
    assert tfaults.FaultSpec().injects_nothing and not fs.injects_nothing
    d = _spec(faults=FULL, churn=dict(n_ue_ids=6, segment_slots=4, initial=(0, 1, 2),
                                      events=((4, 3, "attach"), (9, 1, "detach"))))
    tspec = tses.CampaignSpec.from_dict(d)
    assert tses.CampaignSpec.from_json(tspec.to_json()) == tspec
    assert tses.spec_hash(tspec) == rses.spec_hash(rses.CampaignSpec.from_dict(d))
    assert isinstance(tspec.faults, tfaults.FaultSpec)
    for shape in ((16, 4), (7, 33)):
        got = fs.resolve(*shape)
        want = rfaults.FaultSpec(**FULL).resolve(*shape)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="fault injection"):
        tses.CampaignSpec(path="host", n_ues=1, faults=FULL,
                          policies=(tses.PolicySpec(),))


def test_breaker_unit_matches_reference():
    """The breaker state machine on random trip streams, slot by slot."""
    fs_kw = dict(breaker_trips=2, breaker_window=4, breaker_cooldown=3)
    rfs, tfs = rfaults.FaultSpec(**fs_kw), tfaults.FaultSpec(**fs_kw)
    rcfg = rcl.SwitchConfig(feature_names=("snr",), window_slots=2, backend="ref")
    tcfg = tcl.SwitchConfig(feature_names=("snr",), window_slots=2)
    rs = rcl.init_device_switch(6, 1, rcfg, rfs)
    ts = tcl.init_device_switch(6, 1, tcfg, "cpu", faults=tfs)
    trips = np.random.default_rng(2).random((30, 6)) < 0.4
    entered = 0
    for s in range(30):
        rs = rcl.breaker_update(rs, jnp.asarray(trips[s]), jnp.int32(s), rfs)
        ts = tcl.breaker_update(ts, torch.as_tensor(trips[s]), s, tfs)
        np.testing.assert_array_equal(ts.trip_ring.numpy(), np.asarray(rs.trip_ring))
        np.testing.assert_array_equal(ts.quarantine.numpy(), np.asarray(rs.quarantine))
        entered += int((ts.quarantine == 3).sum())
    assert entered > 0


def test_ttl_boundary_matches_reference():
    """The TTL decay at the boundary: ages, registers and modes slot by slot
    on a random heard/lost stream."""
    rcfg = rcl.SwitchConfig(feature_names=("snr",), window_slots=2, backend="ref", ttl_slots=3)
    tcfg = tcl.SwitchConfig(feature_names=("snr",), window_slots=2, ttl_slots=3)
    rpolicy = rpol.ThresholdPolicy(feature_idx=0, threshold=18.0).to_device()
    tpolicy = tpol.ThresholdPolicy(feature_idx=0, threshold=18.0).to_device("cpu")
    rs = rcl.init_device_switch(5, 1, rcfg, rfaults.FaultSpec())
    ts = tcl.init_device_switch(5, 1, tcfg, "cpu", faults=tfaults.FaultSpec())
    rng = np.random.default_rng(4)
    heard = rng.random((40, 5)) < 0.5
    kpm = (10.0 + 15.0 * rng.random((40, 5, 1))).astype(np.float32)
    stale = 0
    for s in range(40):
        rs, rraw = rcl.switch_update(rs, jnp.asarray(kpm[s]), rpolicy, rcfg,
                                     decision_valid=jnp.asarray(heard[s]),
                                     telemetry_valid=jnp.ones(5, bool))
        rs = rcl.switch_boundary(rs, ttl_slots=3, fail_safe_mode=1)
        ts, traw = tcl.switch_update(ts, torch.as_tensor(kpm[s]), tpolicy, tcfg,
                                     decision_valid=torch.as_tensor(heard[s]),
                                     telemetry_valid=torch.ones(5, dtype=torch.bool))
        ts = tcl.switch_boundary(ts, ttl_slots=3, fail_safe_mode=1)
        np.testing.assert_array_equal(traw.numpy(), np.asarray(rraw))
        for name in ("active_mode", "pending_mode", "decision_age", "n_switches", "streak"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(rs, name)), err_msg=name)
        stale += int((ts.decision_age > 3).sum())
    assert stale > 0
