"""The reference's public surface that the port gained last, against ``repro``
at ``repro``'s own test shapes: the switches over pytrees (bitwise ``repro``'s
Pallas kernels in interpret mode), both forms of ``mmse_interp``, the public
one-slot step, the tree policy's ``predict_from_kpms`` and five-argument
export, ``dmrs_sequence`` at any slot and cell, the serving bank's oracle
switch, and the closed-loop runtime's agent, ``ue_keys`` and telemetry replay.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import closed_loop as rcl
from repro.core import e3 as re3
from repro.core import policy as rpol
from repro.core import runtime as rrt
from repro.core.telemetry import SELECTED_KPMS
from repro.kernels import mmse_interp as rmmse
from repro.kernels.switch_select import ops as rsw
from repro.kernels.switch_select import ref as rswref
from repro.phy import ai_estimator as rai
from repro.phy import dmrs as rdmrs
from repro.phy import pipeline as rpipe
from repro.phy.estimators import WienerInterpolator as RWiener
from repro.phy.nr import SlotConfig as RSlotConfig
from repro.phy.scenario import good_poor_good_schedule as rsched
from repro_torch import random as jr
from repro_torch.convert import tree_policy_from_reference
from repro_torch.core import closed_loop as tcl
from repro_torch.core import e3 as te3
from repro_torch.core import runtime as trt
from repro_torch.core.session import CampaignSpec, PolicySpec
from repro_torch.kernels import mmse_interp as tmmse
from repro_torch.kernels import switch_select as tsw
from repro_torch.phy import ai_estimator as tai
from repro_torch.phy import dmrs as tdmrs
from repro_torch.phy import pipeline as tpipe
from repro_torch.phy.nr import SlotConfig
from repro_torch.phy.scenario import good_poor_good_schedule as tsched
from test_torch_kernels import MMSE_TOL
from test_torch_open_loop import KPM_ATOL, KPM_RTOL

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

N_UES = 3


# -- the switches over pytrees --------------------------------------------------


def _expert(rng, n_ues: int) -> dict:
    """One expert's output as the reference's tests shape it: a channel
    estimate and a noise variance a UE."""
    h = rng.normal(size=(n_ues, 4, 3, 72, 2)).astype(np.float32)
    return {"h": (h[..., 0] + 1j * h[..., 1]).astype(np.complex64),
            "nv": rng.normal(size=(n_ues,)).astype(np.float32)}


def _experts(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [_expert(rng, N_UES) for _ in range(n)]


def _t(tree: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _j(tree: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _same(got: dict, want) -> None:
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("n_experts,mode", [(2, 0), (2, 1), (3, 0), (3, 2)])
def test_switch_select_scalar_over_a_pytree(n_experts, mode):
    outs = _experts(n_experts)
    want = rsw.switch_select(jnp.int32(mode), [_j(o) for o in outs], interpret=True)
    _same(tsw.switch_select(mode, [_t(o) for o in outs]), want)
    _same(tsw.switch_select_tree_ref(mode, [_t(o) for o in outs]),
          rswref.switch_select_tree_ref(jnp.int32(mode), [_j(o) for o in outs]))


@pytest.mark.parametrize("n_experts", [2, 3])
def test_switch_select_per_ue_over_a_pytree(n_experts):
    outs = _experts(n_experts, seed=1)
    modes = np.array([1, 0, n_experts - 1], np.int32)
    want = rsw.switch_select(jnp.asarray(modes), [_j(o) for o in outs], interpret=True)
    got = tsw.switch_select(torch.as_tensor(modes), [_t(o) for o in outs])
    _same(got, want)
    _same(tsw.switch_select_batched_tree_ref(torch.as_tensor(modes), [_t(o) for o in outs]),
          rswref.switch_select_batched_tree_ref(jnp.asarray(modes), [_j(o) for o in outs]))


@pytest.mark.parametrize("src", [[1, -1, 0], [-1, -1, -1], [0, 1, -3]])
def test_switch_scatter_over_a_pytree(src):
    rng = np.random.default_rng(2)
    designated, compact = _expert(rng, N_UES), _expert(rng, 2)
    src = np.asarray(src, np.int32)
    want = jax.tree.map(
        lambda c, d: rsw.switch_gather_batched_leaf(jnp.asarray(src), c, d, interpret=True),
        _j(compact), _j(designated))
    _same(tsw.switch_scatter(torch.as_tensor(src), _t(compact), _t(designated)), want)
    _same(tsw.switch_scatter(torch.as_tensor(src), _t(compact), _t(designated),
                             backend="ref"), want)
    _same(tsw.switch_gather_batched_tree_ref(torch.as_tensor(src), _t(compact),
                                             _t(designated)),
          rswref.switch_gather_batched_tree_ref(jnp.asarray(src), _j(compact),
                                                _j(designated)))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_switch_select_leaf(mode):
    des, *alts = (o["h"] for o in _experts(3, seed=3))
    want = rsw.switch_select_leaf(jnp.int32(mode), [jnp.asarray(a) for a in alts],
                                  jnp.asarray(des), interpret=True)
    got = tsw.switch_select_leaf(mode, [torch.as_tensor(a) for a in alts],
                                 torch.as_tensor(des))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _Pair(NamedTuple):
    h: torch.Tensor
    nv: torch.Tensor


def test_switch_over_lists_tuples_and_namedtuples():
    """Every node kind the reference's pytrees use keeps its type."""
    a, b = (_t(o) for o in _experts(2, seed=4))
    modes = torch.tensor([1, 0, 1], dtype=torch.int32)
    for make in (list, tuple, lambda xs: _Pair(*xs)):
        got = tsw.switch_select(modes, [make([a["h"], a["nv"]]), make([b["h"], b["nv"]])])
        assert type(got) is type(make([a["h"], a["nv"]]))
        assert torch.equal(got[0], tsw.switch_select_batched_ref(modes, [a["h"], b["h"]]))
        assert torch.equal(got[1], tsw.switch_select_batched_ref(modes, [a["nv"], b["nv"]]))


def test_switch_rejects_mismatched_trees_and_a_designated_index():
    a, b = (_t(o) for o in _experts(2, seed=5))
    with pytest.raises(ValueError, match="designated expert first"):
        tsw.switch_select(0, [a, b], designated_idx=1)
    with pytest.raises(ValueError, match="structures differ"):
        tsw.switch_select(1, [a, {"h": b["h"]}])
    with pytest.raises(ValueError, match="structures differ"):
        tsw.switch_select(torch.zeros(N_UES, dtype=torch.int32), [[a["h"], a["nv"]],
                                                                   (b["h"], b["nv"])])
    with pytest.raises(ValueError, match="structures differ"):
        tsw.switch_scatter(torch.zeros(N_UES, dtype=torch.int32), {"h": a["h"]}, a)


# -- mmse_interp, both forms ----------------------------------------------------


@pytest.mark.parametrize("use_gauss", [True, False])
def test_mmse_interp_forms_against_reference(use_gauss):
    n_prb = 24
    w = np.asarray(RWiener.build(RSlotConfig(n_prb=n_prb)).w)
    rng = np.random.default_rng(n_prb)
    h = (rng.normal(size=(N_UES, 4, 3, w.shape[0]))
         + 1j * rng.normal(size=(N_UES, 4, 3, w.shape[0]))).astype(np.complex64)
    want = np.asarray(rmmse.mmse_interp(jnp.asarray(h), jnp.asarray(w), use_gauss=use_gauss,
                                        interpret=True))
    got = tmmse.mmse_interp(torch.as_tensor(h), torch.as_tensor(w), use_gauss=use_gauss)
    np.testing.assert_allclose(got.numpy(), want, **MMSE_TOL)
    plain = tmmse.mmse_interp_ref(torch.as_tensor(h), torch.as_tensor(w), use_gauss=use_gauss)
    assert torch.equal(got, plain)
    # the forms differ in their arithmetic, not in their value
    np.testing.assert_allclose(got.numpy(), h @ w, **MMSE_TOL)


# -- the engine: slot_step and the closed-loop runtime ---------------------------

CFG, RCFG = SlotConfig(n_prb=24), RSlotConfig(n_prb=24)
NET = dict(channels=8, n_res_blocks=1)
N_SLOTS = 12
KEY = 7
#: a depth-2 tree on the SNR (feature 5): the AI expert (mode 0) below 15 dB
TREE = (np.array([5, 5, 5], np.int32), np.array([15.0, 10.0, 20.0], np.float32),
        np.array([0.0, 0.0, 1.0, 1.0], np.float32))


@pytest.fixture(scope="module")
def engines():
    # the port's initializer draws the reference's weights (test_torch_ai_estimator)
    # without the reference's per-shape PRNG compiles
    params = tai.init_params(jr.PRNGKey(0), CFG, tai.AiEstimatorConfig(**NET))
    reng = rpipe.BatchedPuschPipeline(RCFG, jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                                         params),
                                      net=rai.AiEstimatorConfig(**NET))
    teng = tpipe.BatchedPuschPipeline(CFG, params, net=tai.AiEstimatorConfig(**NET),
                                      device="cpu")
    return reng, teng


def test_slot_step_loop_is_run_without_scan(engines):
    """Four slots of the public one-slot step == ``run(use_scan=False)``,
    bitwise, and ``repro``'s slot_step loop within the KPM tolerance."""
    reng, teng = engines
    n_slots, modes = 4, np.array([[0, 1, 0], [1, 1, 0], [0, 0, 1], [1, 0, 1]], np.int32)
    sched_t, sched_r = tsched(poor_start=1, poor_end=3), rsched(poor_start=1, poor_end=3)
    _, whole = teng.run(sched_t, modes, n_slots=n_slots, n_ues=N_UES,
                        key=jr.PRNGKey(KEY), use_scan=False)
    profile, params = tpipe.resolve_schedule(CFG, sched_t, n_slots, N_UES, teng.device)
    ue_keys = jr.fold_in(jr.PRNGKey(KEY), torch.arange(N_UES))
    link = tpipe.init_device_link(N_UES)
    rprofile, rparams = rpipe.resolve_schedule(RCFG, sched_r, n_slots, N_UES)
    rkeys = jax.vmap(lambda u: jax.random.fold_in(jax.random.PRNGKey(KEY), u))(
        jnp.arange(N_UES))
    rlink = rpipe.init_device_link(N_UES)
    for s in range(n_slots):
        link, out = teng.slot_step(profile, link, torch.as_tensor(modes[s]),
                                   jr.fold_in(ue_keys, s), params.at(s))
        rlink, rout = reng.slot_step(
            rprofile, rlink, jnp.asarray(modes[s]),
            jax.vmap(lambda k, s=s: jax.random.fold_in(k, s))(rkeys),
            jax.tree.map(lambda x, s=s: x[s], rparams))
        for k in ("mcs", "tb_ok", "tbs", "executed_flops"):
            assert torch.equal(out[k], whole[k][s]), k
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(rout[k]), err_msg=k)
        for src, kpms in out["kpms"].items():
            for k, v in kpms.items():
                assert torch.equal(v, whole["kpms"][src][k][s]), (src, k)
                np.testing.assert_allclose(v.numpy(), np.asarray(rout["kpms"][src][k]),
                                           rtol=KPM_RTOL, atol=KPM_ATOL, err_msg=f"{src}.{k}")


def _agent(mod):
    agent, seen = mod.E3Agent(), []
    agent.subscribe(mod.E3Subscription(callback=seen.append))
    return agent, seen


@pytest.fixture(scope="module")
def runtimes(engines):
    """``repro``'s closed-loop runtime with telemetry replay (the setup of its
    ``test_runtime_closed_loop_records_device_modes``) and the port's."""
    reng, teng = engines
    rtree = rpol.DecisionTreePolicy(rpol.FittedTree(*TREE, depth=2, n_features=10,
                                                    importances=np.zeros(10, np.float32)),
                                    SELECTED_KPMS)
    ragent, rseen = _agent(re3)
    rrun = rrt.ArchesRuntime(agent=ragent, closed_loop=True, engine=reng,
                             device_policy=rtree.to_device(),
                             switch_config=rcl.SwitchConfig(feature_names=SELECTED_KPMS,
                                                            window_slots=4))
    rhist = rrun.run_batched(rsched(poor_start=3, poor_end=7), n_slots=N_SLOTS, n_ues=N_UES,
                             key=jax.random.PRNGKey(KEY), replay_telemetry=True)
    ttree = tree_policy_from_reference(*TREE, SELECTED_KPMS)
    tagent, tseen = _agent(te3)
    trun = trt.ArchesRuntime(agent=tagent, closed_loop=True, engine=teng,
                             device_policy=ttree.to_device("cpu"),
                             switch_config=tcl.SwitchConfig(feature_names=SELECTED_KPMS,
                                                            window_slots=4))
    thist = trun.run_batched(tsched(poor_start=3, poor_end=7), n_slots=N_SLOTS, n_ues=N_UES,
                             key=jr.PRNGKey(KEY), replay_telemetry=True)
    return rhist, rseen, trun, thist, tseen


def test_run_batched_with_replay_matches_reference(runtimes):
    rhist, _, _, thist, _ = runtimes
    np.testing.assert_array_equal(thist.modes, rhist.modes)
    np.testing.assert_array_equal(thist.decisions, rhist.decisions)
    np.testing.assert_array_equal(thist.n_switches, rhist.n_switches)
    assert thist.n_switches.sum() >= 2  # into the AI expert and back


def test_replayed_indications_match_reference(runtimes):
    _, rseen, _, _, tseen = runtimes
    assert len(tseen) == len(rseen) == N_SLOTS * 2  # aerial + oai, one a slot
    for src in ("aerial", "oai"):
        assert sum(m.source == src for m in tseen) == sum(m.source == src for m in rseen)
    for t, r in zip(tseen, rseen):
        assert (t.slot, t.source, set(t.kpms)) == (r.slot, r.source, set(r.kpms))
        for k, v in t.kpms.items():
            np.testing.assert_allclose(v, r.kpms[k], rtol=1e-4, atol=KPM_ATOL, err_msg=k)


def test_run_batched_explicit_ue_keys_and_no_replay(runtimes):
    """``ue_keys = fold_in(key, u)`` give the ``key=`` run bitwise; without
    replay the agent hears nothing and the history is the same."""
    _, _, trun, thist, tseen = runtimes
    n_before = len(tseen)
    ue_keys = jr.fold_in(jr.PRNGKey(KEY), torch.arange(N_UES))
    again = trun.run_batched(tsched(poor_start=3, poor_end=7), n_slots=N_SLOTS,
                             n_ues=N_UES, ue_keys=ue_keys)
    assert len(tseen) == n_before
    np.testing.assert_array_equal(again.modes, thist.modes)
    np.testing.assert_array_equal(again.decisions, thist.decisions)
    for k, v in thist.kpms.items():
        np.testing.assert_array_equal(again.kpms[k], v, err_msg=k)


def test_from_spec_keeps_its_agent(engines):
    _, teng = engines
    agent, _ = _agent(te3)
    spec = CampaignSpec(path="closed_loop", n_ues=N_UES, n_slots=N_SLOTS,
                        policies=(PolicySpec(kind="tree"),))
    pol = tree_policy_from_reference(*TREE, spec.feature_names).to_device("cpu")
    run = trt.ArchesRuntime.from_spec(spec, engine=teng, device_policy=pol, agent=agent,
                                      device="cpu")
    assert run.agent is agent and run.closed_loop


# -- the policy, the DMRS, the serving bank ----------------------------------------


def test_predict_from_kpms_and_five_argument_export():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(64, 10)).astype(np.float32)
    y = ((x[:, 5] > 0.2) ^ (x[:, 1] < -0.5)).astype(np.int32)
    tree = rpol.fit_decision_tree(x, y, depth=2)
    rpolicy = rpol.DecisionTreePolicy(tree, SELECTED_KPMS)
    tpolicy = tree_policy_from_reference(tree.feature, tree.threshold, tree.leaf_values,
                                         SELECTED_KPMS)
    for row in x[:12]:
        kpms = dict(zip(SELECTED_KPMS, row.tolist()))
        assert tpolicy.predict_from_kpms(kpms) == rpolicy.predict_from_kpms(kpms)
    args = (tree.feature, tree.threshold, tree.leaf_values, tree.n_features, tree.depth)
    want, got = rcl.export_tree_tables(*args), tcl.export_tree_tables(*args, device="cpu")
    for k in ("feature", "threshold", "leaf_modes"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    with pytest.raises(ValueError, match="depth-3"):
        tcl.export_tree_tables(*args[:4], 3, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tcl.export_tree_tables(*args[:3], 1, 2, device="cpu")


@pytest.mark.parametrize("slot,cell_id", [(0, 42), (7, 0), (19, 1007)])
def test_dmrs_sequence_at_any_slot_and_cell(slot, cell_id):
    got = tdmrs.dmrs_sequence(CFG, slot=slot, cell_id=cell_id, device="cpu")
    want = np.asarray(rdmrs.dmrs_sequence(RCFG, slot=slot, cell_id=cell_id))
    assert got.dtype is torch.complex64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_default_to_the_card(monkeypatch):
    """``dmrs_sequence`` and ``spawn_ranks`` take the card unless asked for
    the CPU: without one they raise before any work."""
    from repro_torch.core import topology

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdmrs.dmrs_sequence(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topology.spawn_ranks(print, 2)


def test_switched_decode_oracle_switch_equals_the_kernel_route():
    from repro_torch.models import Model, get_config
    from repro_torch.serving import SwitchedDecodeConfig, SwitchedDecoder

    model = Model(get_config("granite-20b", reduced=True))
    params = model.init(jr.PRNGKey(0))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, model.cfg.vocab, (3, 9)))
    _, cache = model.prefill(params, tokens, model.init_cache(3, 32, dtype=torch.bfloat16,
                                                              device="cpu"))
    nxt = tokens[:, -1:]
    for mode in (1, torch.tensor([1, 0, 1], dtype=torch.int32)):
        outs = [SwitchedDecoder(model, SwitchedDecodeConfig(window=4, use_pallas_switch=u))
                .step(mode, params, nxt, cache) for u in (True, False)]
        assert torch.equal(outs[0][0], outs[1][0])
        assert outs[0][2] == outs[1][2]
