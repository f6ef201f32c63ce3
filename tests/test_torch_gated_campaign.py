"""GATED campaigns through both packages: the open-loop ``gated`` path and
the GATED closed loop, fused and unfused, float32 and bf16 with the NMSE
audit, and ``run(auto_capacity=True)``.

The committed benchmark snapshot's campaign spec is the base, widened to 3
UEs so that a capacity of 1 overflows.  ``repro`` fits its switching tree
once; the fitted tree is carried into every other session of both packages.
Discrete leaves must agree everywhere; continuous KPMs within 1e-4
relative, as in ``test_torch_campaign``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import runtime as rrt
from repro.core import session as rses
from repro_torch.convert import tree_policy_from_reference
from repro_torch.core import runtime as trt
from repro_torch.core import session as tses

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

BENCH = json.loads(
    (Path(__file__).resolve().parents[1] / "BENCH_pr10.json").read_text())["campaign_spec"]
KPM_RTOL, KPM_ATOL = 1e-4, 1e-4


def _spec(path, **bank):
    d = dict(BENCH, path=path, n_ues=3, bank=dict(BENCH["bank"], **bank))
    if path == "gated":
        # AI-heavy plan: two of three UEs select AI in most slots
        d["modes"] = [[0, 0, 1], [0, 1, 0], [1, 1, 1], [0, 0, 0]] * 3
    return d


CAMPAIGNS = {
    # name: (spec, auto_capacity)
    "closed_fused_cap1": (_spec("closed_loop", execution_mode="gated", gated_capacity=1,
                                fused=True), False),
    "closed_unfused_full": (_spec("closed_loop", execution_mode="gated"), False),
    "closed_fused_auto": (_spec("closed_loop", execution_mode="gated", gated_capacity=1,
                                fused=True), True),
    "open_unfused_cap1": (_spec("gated", gated_capacity=1), False),
    "open_fused_bf16_audit": (_spec("gated", execution_mode="gated", fused=True,
                                    dtype="bfloat16", audit_nmse_threshold=0.05), False),
    "open_unfused_auto": (_spec("gated", gated_capacity=1), True),
}


@pytest.fixture(scope="module")
def runs():
    first = rses.ArchesSession(rses.CampaignSpec.from_dict(CAMPAIGNS["closed_fused_cap1"][0]))
    ref_policies = first.host_policies
    tree = ref_policies[0].tree
    port_policies = (tree_policy_from_reference(tree.feature, tree.threshold,
                                                tree.leaf_values, first.spec.feature_names),)
    out = {}
    for name, (d, auto) in CAMPAIGNS.items():
        closed = d["path"] == "closed_loop"
        rspec, tspec = rses.CampaignSpec.from_dict(d), tses.CampaignSpec.from_dict(d)
        rsess = rses.ArchesSession(rspec, host_policies=ref_policies if closed else None)
        tsess = tses.ArchesSession(tspec, device="cpu",
                                   host_policies=port_policies if closed else None)
        out[name] = (rspec, rsess.run(auto_capacity=auto), tspec, tsess,
                     tsess.run(auto_capacity=auto))
    return out


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_spec_hash_equal(runs, name):
    rspec, _, tspec, tsess, _ = runs[name]
    assert tses.spec_hash(tspec) == rses.spec_hash(rspec)
    assert tsess.bank_spec.execution_mode == "gated"  # path "gated" normalizes


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_discrete_leaves_agree(runs, name):
    _, rhist, _, _, thist = runs[name]
    assert thist.modes.shape == rhist.modes.shape == (12, 3)
    np.testing.assert_array_equal(thist.modes, rhist.modes)
    for k in ("mcs", "tb_ok", "tbs", "gated_overflow", "audit_tripped"):
        np.testing.assert_array_equal(thist.outputs[k], rhist.outputs[k], err_msg=k)
    if rhist.decisions is not None:
        np.testing.assert_array_equal(thist.decisions, rhist.decisions)
    assert thist.overflow_slot_ues == rhist.overflow_slot_ues
    assert thist.audit_tripped_slot_ues == rhist.audit_tripped_slot_ues
    assert thist.ai_share == rhist.ai_share
    assert (thist.modes == 0).any()  # the campaign really ran the gated expert


def test_campaigns_exercise_overflow_and_audit(runs):
    assert runs["closed_fused_cap1"][4].overflow_slot_ues > 0
    assert runs["open_unfused_cap1"][4].overflow_slot_ues > 0
    assert runs["open_fused_bf16_audit"][4].audit_tripped_slot_ues > 0
    assert runs["closed_unfused_full"][4].overflow_slot_ues == 0


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_continuous_leaves_within_tolerance(runs, name):
    _, rhist, _, _, thist = runs[name]
    assert set(thist.kpms) == set(rhist.kpms)
    for k, want in rhist.kpms.items():
        assert np.isfinite(thist.kpms[k]).all(), k
        np.testing.assert_allclose(thist.kpms[k], want, rtol=KPM_RTOL, atol=KPM_ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(thist.outputs["executed_flops"],
                                  rhist.outputs["executed_flops"])
    np.testing.assert_array_equal(thist.executed_flops_per_slot(),
                                  rhist.executed_flops_per_slot())


@pytest.mark.parametrize("name", ["closed_fused_auto", "open_unfused_auto"])
def test_auto_capacity_provisions_the_same(runs, name):
    _, rhist, _, tsess, thist = runs[name]
    assert thist.provisioned_capacity == rhist.provisioned_capacity
    assert tsess.engine.bank.gated_capacity == thist.provisioned_capacity
    assert thist.overflow_slot_ues == 0  # sized from the peak demand


@pytest.mark.parametrize("kw", [{}, {"quantile": 0.5}, {"headroom": 2},
                                {"quantile": 0.9, "headroom": 1}, {"n_shards": 3}])
def test_suggest_gated_capacity_equal(runs, kw):
    for name in ("closed_fused_cap1", "open_unfused_cap1"):
        rhist = runs[name][1]
        thist = trt.BatchedRunHistory(modes=rhist.modes, kpms={}, outputs={})
        assert (trt.suggest_gated_capacity(thist, **kw)
                == rrt.suggest_gated_capacity(rhist, **kw)), (name, kw)
    with pytest.raises(ValueError):
        trt.suggest_gated_capacity(thist, quantile=1.5)
    with pytest.raises(ValueError):
        trt.suggest_gated_capacity(thist, n_shards=2)


def test_device_loop_equals_host_replay(runs):
    for name in ("closed_fused_cap1", "closed_unfused_full"):
        _, _, _, tsess, thist = runs[name]
        np.testing.assert_array_equal(thist.modes, tsess.host_replay(thist)["active_mode"])


def test_spec_checks():
    with pytest.raises(ValueError):  # would run un-gated at the concurrent cost
        tses.CampaignSpec.from_dict(_spec("gated", execution_mode="selected_only"))
    for path, bank in (("perturbed", "gated"), ("host", "gated")):
        d = dict(_spec(path, execution_mode=bank), n_ues=1)
        with pytest.raises(ValueError):
            tses.CampaignSpec.from_dict(d)
        with pytest.raises(ValueError):
            rses.CampaignSpec.from_dict(d)
    sess = tses.ArchesSession(tses.CampaignSpec.from_dict(dict(BENCH)), device="cpu")
    with pytest.raises(ValueError):  # auto_capacity sizes a gated bank
        sess.run(auto_capacity=True)
