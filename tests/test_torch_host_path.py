"""The host E3/dApp loop of the port against ``repro``: the scalar switch, the
host PHY functions, the single-UE pipeline, SELECTED_ONLY banks, the E3
agent, the dApp and the switch register, and whole ``path="host"`` sessions.

Inputs are numpy arrays or the same PRNG keys on both sides.  Data movement,
integer and host-float logic compare bitwise; float32 stages carry the
tolerance stated beside them.  One ``repro`` pipeline serves the module: its
jitted stages recompile for every new MCS.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dapp as rdapp
from repro.core import e3 as re3
from repro.core import expert_bank as rbank
from repro.core import runtime as rrt
from repro.core import session as rses
from repro.core import switch as rsw
from repro.core.policy import DecisionTreePolicy as RTreePolicy
from repro.core.policy import FittedTree as RFittedTree
from repro.kernels.switch_select.ops import switch_select_leaf
from repro.kernels.switch_select.ref import switch_select_ref as r_switch_ref
from repro.phy import ai_estimator as rai
from repro.phy import channel as rch
from repro.phy import link as rlink
from repro.phy import mcs as rmcs
from repro.phy import pipeline as rpipe
from repro.phy import qam as rqam
from repro.phy import scenario as rscn
from repro.phy.nr import SlotConfig as RSlotConfig
from repro_torch import random as jr
from repro_torch.convert import ai_params_from_reference, tree_policy_from_reference
from repro_torch.core import dapp as tdapp
from repro_torch.core import e3 as te3
from repro_torch.core import expert_bank as tbank
from repro_torch.core import runtime as trt
from repro_torch.core import session as tses
from repro_torch.core import switch as tsw
from repro_torch.kernels.switch_select import switch_select, switch_select_ref
from repro_torch.phy import ai_estimator as tai
from repro_torch.phy import channel as tch
from repro_torch.phy import link as tlink
from repro_torch.phy import mcs as tmcs
from repro_torch.phy import pipeline as tpipe
from repro_torch.phy import qam as tqam
from repro_torch.phy import scenario as tscn
from repro_torch.phy.nr import SlotConfig

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

N_PRB = 24
CFG, RCFG = SlotConfig(n_prb=N_PRB), RSlotConfig(n_prb=N_PRB)
NET, RNET = tai.AiEstimatorConfig(channels=8, n_res_blocks=1), \
    rai.AiEstimatorConfig(channels=8, n_res_blocks=1)

#: float32 stages computed with the same formula on both sides: a few ulp of
#: reassociation (XLA fuses and reorders elementwise chains and reductions)
F32_TOL = dict(rtol=2e-5, atol=2e-6)
#: the channel: sin/cos of the steering phase and the einsum's reduction
#: order differ by a few ulp (as in tests/test_torch_phy.py)
CH_TOL = dict(rtol=1e-4, atol=2e-5)
#: the AI expert: four 3x3 convolution layers whose sums run in another
#: order (oneDNN vs XLA:CPU's conv) on O(1) activations
AI_TOL = dict(rtol=1e-4, atol=1e-5)
#: continuous KPMs of a run whose discrete path (mode, MCS, TB outcome)
#: agrees: the float32 stages above compound through the equalizer and the
#: SINR, which feeds link adaptation; 1e-4 relative is far below 0.01 dB
KPM_RTOL, KPM_ATOL = 1e-4, 1e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def params():
    return rai.init_params(jax.random.PRNGKey(0), RCFG, RNET)


@pytest.fixture(scope="module")
def pipes(params):
    """One reference pipeline for the module (its jitted stages stay warm)
    and the port's on the CPU with the same weights."""
    rp = rpipe.PuschPipeline(RCFG, params, net=RNET)
    tp = tpipe.PuschPipeline(CFG, ai_params_from_reference(params), net=NET, device="cpu")
    return rp, tp


# -- the scalar switch ---------------------------------------------------------


@pytest.mark.parametrize("n_experts", [2, 3, 4])
@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (4, 1, 13, 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_scalar_switch_bitwise_against_reference(n_experts, shape, dtype):
    """Every mode, odd leaf sizes: the plain version and the wrapper on the
    CPU equal ``repro``'s ``switch_select_ref`` and its Pallas kernel in
    interpret mode bitwise (the switch only moves data)."""
    rng = np.random.default_rng(n_experts * 100 + len(shape))
    if dtype is np.complex64:
        outs = [_cplx(rng, shape) for _ in range(n_experts)]
    else:
        outs = [rng.normal(size=shape).astype(np.float32) for _ in range(n_experts)]
    j_outs = [jnp.asarray(o) for o in outs]
    t_outs = [torch.as_tensor(o) for o in outs]
    for mode in range(n_experts):
        want = np.asarray(r_switch_ref(jnp.int32(mode), jnp.stack(j_outs[1:]), j_outs[0]))
        kernel = np.asarray(switch_select_leaf(jnp.int32(mode), j_outs[1:], j_outs[0],
                                               interpret=True))
        np.testing.assert_array_equal(kernel, want)
        for m in (mode, torch.tensor(mode, dtype=torch.int32)):
            np.testing.assert_array_equal(switch_select_ref(int(m), t_outs).numpy(), want)
            np.testing.assert_array_equal(switch_select(m, t_outs).numpy(), want)
        # on the CPU the plain version leaves every input untouched
        for o, t in zip(outs, t_outs):
            np.testing.assert_array_equal(t.numpy(), o)


def test_scalar_switch_out_of_range_mode():
    """What each side does with a mode that names no expert.  ``repro``'s
    Pallas kernel (interpret mode) clamps the block index and copies the
    last alternative; its ``switch_select_ref`` fills NaN (``jnp.take``'s
    default).  The port's wrapper raises on an int mode outside
    ``[0, n_experts)``; on the card a device mode that names no alternative
    keeps the designated buffer (``tests/test_torch_cuda_kernels.py``)."""
    rng = np.random.default_rng(5)
    outs = [rng.normal(size=(9,)).astype(np.float32) for _ in range(3)]
    j_outs = [jnp.asarray(o) for o in outs]
    kernel = np.asarray(switch_select_leaf(jnp.int32(3), j_outs[1:], j_outs[0],
                                           interpret=True))
    np.testing.assert_array_equal(kernel, outs[-1])
    assert np.isnan(np.asarray(r_switch_ref(jnp.int32(3), jnp.stack(j_outs[1:]),
                                            j_outs[0]))).all()
    t_outs = [torch.as_tensor(o) for o in outs]
    for mode in (3, -1, torch.tensor(7, dtype=torch.int32)):
        with pytest.raises(ValueError, match="outside"):
            switch_select(mode, t_outs)


# -- host PHY functions ----------------------------------------------------------


@pytest.mark.parametrize("interference,duty,collision", [
    (False, 1.0, False), (True, 1.0, False), (True, 0.5, False), (True, 0.4, True)])
def test_host_channel_equals_reference_host_form(interference, duty, collision):
    """``simulate_slot_channel`` (one UE, a static config) against the
    reference's jitted host form: with interference on the port runs its
    traced simulation for one UE, with it off it draws nothing and returns
    zeros, as the reference does."""
    kw = dict(snr_db=13.0, interference=interference, interference_symbol_duty=duty,
              dmrs_collision=collision)
    rcfg = rch.ChannelConfig(profile=rch.INDOOR_NLOS, **kw)
    tcfg = tch.ChannelConfig(profile=tch.INDOOR_NLOS, **kw)
    for seed in (3, 2**31 - 7):
        want = rch.simulate_slot_channel(jax.random.PRNGKey(seed), RCFG, rcfg)
        got = tch.simulate_slot_channel(jr.PRNGKey(seed), CFG, tcfg)
        assert got["h"].shape == want["h"].shape
        assert got["interference"].shape == want["interference"].shape
        np.testing.assert_allclose(_np(got["h"]), np.asarray(want["h"]), **CH_TOL)
        np.testing.assert_array_equal(_np(got["noise_var"]), np.asarray(want["noise_var"]))
        np.testing.assert_allclose(_np(got["interference"]),
                                   np.asarray(want["interference"]), **CH_TOL)
        # occupancy (a thresholded uniform draw) matches exactly
        np.testing.assert_array_equal(_np(got["interference"]) != 0,
                                      np.asarray(want["interference"]) != 0)
        if not interference:
            assert not _np(got["interference"]).any()


def test_host_link_mcs_and_demapper_against_reference():
    rng = np.random.default_rng(2)
    for snr in (-5.0, 3.3, 11.0, 17.25, 40.0):
        assert tmcs.select_mcs(snr) == tmcs.mcs_entry(rmcs.select_mcs(snr).index)
        assert dataclasses.astuple(tmcs.select_mcs(snr)) == dataclasses.astuple(
            rmcs.select_mcs(snr))
    sinr = np.abs(rng.normal(3.0, 2.0, size=(300,))).astype(np.float32)
    for qm in (2, 4, 6, 8):
        np.testing.assert_allclose(_np(tlink.qam_mutual_information(torch.as_tensor(sinr), qm)),
                                   np.asarray(rlink.qam_mutual_information(sinr, qm)),
                                   **F32_TOL)
        np.testing.assert_allclose(float(tlink.effective_mi(torch.as_tensor(sinr), qm)),
                                   float(rlink.effective_mi(jnp.asarray(sinr), qm)),
                                   **F32_TOL)
    for idx in (0, 9, 17, 27):
        mcs_t, mcs_r = tmcs.mcs_entry(idx), rmcs.mcs_entry(idx)
        for seed in range(6):
            got = tlink.tb_success(torch.as_tensor(sinr), mcs_t, key=jr.PRNGKey(seed))
            want = rlink.tb_success(jnp.asarray(sinr), mcs_r, key=jax.random.PRNGKey(seed))
            assert bool(got) == bool(want)
        assert bool(tlink.tb_success(torch.as_tensor(sinr), mcs_t)) == bool(
            rlink.tb_success(jnp.asarray(sinr), mcs_r))
        for ok in (True, False):
            np.testing.assert_array_equal(
                _np(tlink.throughput_bits(5000 + idx, torch.tensor(ok), 5e-4)),
                np.asarray(rlink.throughput_bits(5000 + idx, jnp.asarray(ok), 5e-4)))
    # max-log demapper (with its -inf masks), hard decisions, bit errors, CRC
    y = _cplx(rng, (2, 37)) * 0.6
    for qm in (2, 4, 6, 8):
        for nv in (np.float32(0.05), rng.uniform(0.01, 0.3, size=(2, 37)).astype(np.float32)):
            want = np.asarray(rqam.demap_llr(jnp.asarray(y), jnp.asarray(nv), qm))
            got = _np(tqam.demap_llr(torch.as_tensor(y), torch.as_tensor(nv), qm))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
            np.testing.assert_array_equal(_np(tqam.hard_bits(torch.as_tensor(want.copy()))),
                                          np.asarray(rqam.hard_bits(jnp.asarray(want))))
    bits = rng.integers(0, 2, size=(333,)).astype(np.uint8)
    llr = rng.normal(size=(333,)).astype(np.float32)
    assert int(tlink.count_bit_errors(torch.as_tensor(bits), torch.as_tensor(llr))) == int(
        rlink.count_bit_errors(jnp.asarray(bits), jnp.asarray(llr)))
    assert tlink.crc24(bits) == rlink.crc24(bits)


def test_eager_ai_estimate_against_reference(params):
    """The host loop's eager convolution path on one UE's LS input."""
    rng = np.random.default_rng(4)
    h_ls = _cplx(rng, (CFG.n_ant, CFG.n_dmrs_sym, CFG.n_pilot_sc))
    want = np.asarray(rai.ai_estimate_from_ls(params, jnp.asarray(h_ls)))
    got = tai.ai_estimate_from_ls(ai_params_from_reference(params), torch.as_tensor(h_ls))
    assert got.shape == want.shape == (CFG.n_ant, 1, CFG.n_sc, CFG.n_dmrs_sym)
    assert got.dtype == torch.complex64 and got.is_contiguous()
    np.testing.assert_allclose(_np(got), want, **AI_TOL)
    # the baseline interpolation alone is elementwise: a few ulp at most
    x = rng.normal(size=(3, 2, 11, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tai._baseline_interp(torch.as_tensor(x))),
                               np.asarray(rai._baseline_interp(jnp.asarray(x))), **F32_TOL)


# -- the single-UE pipeline -----------------------------------------------------

#: (mode, condition, perturb_rho): both modes under both conditions, then the
#: methodology's perturbation at two intensities
SLOTS = [(1, "good", None), (0, "good", None), (0, "poor", None), (1, "poor", None),
         (0, "poor", None), (1, "good", 0.5), (1, "good", 1.5)]


def test_run_slot_against_reference(pipes):
    rp, tp = pipes
    conds = {"good": (rscn.GOOD, tscn.GOOD), "poor": (rscn.POOR, tscn.POOR)}
    rlink_, tlink_ = rpipe.LinkState(), tpipe.LinkState()
    switched = set()
    for i, (mode, cond, rho) in enumerate(SLOTS):
        seed = 40 + i
        rlink_, rout, rk = rp.run_slot(jax.random.PRNGKey(seed), mode, rlink_, conds[cond][0],
                                       perturb_rho=rho)
        tlink_, tout, tk = tp.run_slot(jr.PRNGKey(seed), mode, tlink_, conds[cond][1],
                                       perturb_rho=rho)
        for k in ("mcs", "tbs", "tb_ok"):
            assert tout[k] == rout[k], (i, k)
        np.testing.assert_array_equal(_np(tout["bits"]), np.asarray(rout["bits"]))
        np.testing.assert_allclose(tout["phy_bits_per_s"], rout["phy_bits_per_s"], rtol=0)
        assert tlink_.ndi == rlink_.ndi and tlink_.slots == rlink_.slots
        assert tlink_.olla_offset_db == rlink_.olla_offset_db
        np.testing.assert_allclose(tlink_.reported_snr_db, rlink_.reported_snr_db,
                                   rtol=KPM_RTOL, atol=KPM_ATOL)
        for src in ("aerial", "oai"):
            assert set(tk[src]) == set(rk[src])
            for name, want in rk[src].items():
                np.testing.assert_allclose(tk[src][name], float(want), rtol=KPM_RTOL,
                                           atol=KPM_ATOL, err_msg=f"slot {i} {name}")
        trx, rrx = tout["rx"], rout["rx"]
        np.testing.assert_allclose(_np(trx["h_selected"]), np.asarray(rrx["h_selected"]),
                                   **AI_TOL)
        if rho is not None:
            assert trx["all_outputs"] is None and rrx["all_outputs"] is None
            continue
        ai, mmse = trx["all_outputs"]
        # all_outputs[0] is the unswitched AI estimate, as in the reference
        np.testing.assert_allclose(_np(ai), np.asarray(rrx["all_outputs"][0]), **AI_TOL)
        np.testing.assert_allclose(_np(mmse), np.asarray(rrx["all_outputs"][1]), **F32_TOL)
        np.testing.assert_array_equal(_np(trx["h_selected"]), _np(trx["all_outputs"][mode]))
        if mode == 1:
            assert not torch.equal(ai, trx["h_selected"])  # the AI estimate survived
        switched.add(mode)
        assert tout["llr"].shape == rout["llr"].shape
    assert switched == {0, 1}


def test_make_slot_fn_key_ignores_campaign_seed(pipes):
    """Slot ``s`` runs on ``PRNGKey(s * 2654435761 % 2**31)``, whatever the
    campaign: the slot function of two schedules draws the same bits."""
    rp, tp = pipes
    for s in (0, 5, 1234567):
        _, rout, _ = rp.make_slot_fn(lambda _s: rscn.GOOD)(1, None, s)
        _, tout, _ = tp.make_slot_fn(lambda _s: tscn.GOOD)(1, None, s)
        np.testing.assert_array_equal(_np(tout["bits"]), np.asarray(rout["bits"]))
        assert tout["mcs"] == rout["mcs"] and tout["tb_ok"] == rout["tb_ok"]


# -- SELECTED_ONLY and the scalar CONCURRENT bank ---------------------------------


def _banks(mode, use_pallas_switch=True):
    """A toy three-expert bank in both packages: expert e scales its input."""
    scales = (1.0, -2.0, 0.5)

    def experts(pkg, wrap):
        return [pkg.Expert(name=f"e{i}", fn=(lambda s: lambda p, x: x * s)(wrap(s)),
                           flops=10.0 * (i + 1))
                for i, s in enumerate(scales)]

    rb = rbank.ExpertBank(experts(rbank, jnp.float32), execution_mode=mode, default_mode=1,
                          use_pallas_switch=use_pallas_switch)
    tb = tbank.ExpertBank(experts(tbank, float), execution_mode=mode.value, default_mode=1,
                          use_pallas_switch=use_pallas_switch)
    return rb, tb


@pytest.mark.parametrize("mode", [0, 1, 2, 5, -1])
def test_selected_only_scalar_against_reference(mode):
    """Only the selected expert runs; an out-of-range mode is clamped as
    ``jax.lax.switch`` clamps it, while ``executed_ue`` compares the raw mode."""
    rb, tb = _banks(rbank.ExecutionMode.SELECTED_ONLY)
    x = np.random.default_rng(1).normal(size=(4, 6)).astype(np.float32)
    ro = rb(jnp.int32(mode), jnp.asarray(x))
    for m in (mode, torch.tensor(mode)):
        to = tb(m, torch.as_tensor(x))
        np.testing.assert_array_equal(_np(to.selected), np.asarray(ro.selected))
        np.testing.assert_array_equal(_np(to.executed_ue), np.asarray(ro.executed_ue))
        assert to.all_outputs is None and to.served_by is None
        assert float(tb.executed_flops(to)) == float(rb.executed_flops(ro))
    if 0 <= mode < 3:
        assert tb.flops_for(mode) == rb.flops_for(mode)


def test_selected_only_vector_against_reference():
    """Per-UE modes: every expert runs and the plain gather selects."""
    rb, tb = _banks(rbank.ExecutionMode.SELECTED_ONLY)
    x = np.random.default_rng(2).normal(size=(5, 3, 4)).astype(np.float32)
    modes = np.asarray([0, 2, 1, 1, 0], np.int32)
    ro = rb(jnp.asarray(modes), jnp.asarray(x))
    to = tb(torch.as_tensor(modes), torch.as_tensor(x))
    np.testing.assert_array_equal(_np(to.selected), np.asarray(ro.selected))
    np.testing.assert_array_equal(_np(to.served_by), np.asarray(ro.served_by))
    np.testing.assert_array_equal(_np(to.executed_ue), np.asarray(ro.executed_ue))
    np.testing.assert_array_equal(_np(to.baseline), np.asarray(ro.baseline))
    assert to.all_outputs is None
    np.testing.assert_array_equal(_np(tb.executed_flops_per_ue(to)),
                                  np.asarray(rb.executed_flops_per_ue(ro)))
    with pytest.raises(ValueError):
        tb.provisioned_flops(5)


@pytest.mark.parametrize("use_pallas_switch", [True, False])
def test_concurrent_scalar_bank_against_reference(use_pallas_switch):
    rb, tb = _banks(rbank.ExecutionMode.CONCURRENT, use_pallas_switch)
    x = np.random.default_rng(3).normal(size=(2, 7)).astype(np.float32)
    for mode in range(3):
        ro = rb(jnp.int32(mode), jnp.asarray(x))
        to = tb(mode, torch.as_tensor(x))
        np.testing.assert_array_equal(_np(to.selected), np.asarray(ro.selected))
        for a, b in zip(to.all_outputs, ro.all_outputs):  # unswitched, every one
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        np.testing.assert_array_equal(_np(to.executed_ue), np.asarray(ro.executed_ue))
        assert tb.flops_for() == rb.flops_for()
    gated = tbank.ExpertBank(_banks(rbank.ExecutionMode.CONCURRENT)[1].experts,
                             execution_mode="gated")
    with pytest.raises(ValueError, match="batched path"):
        gated(0, torch.as_tensor(x))


# -- E3, the dApp and the switch register -------------------------------------


def test_switch_register_against_reference():
    """The host register (Python ints) against the reference's jnp one on
    one stream of commits, invalid commits and silent slots."""
    rng = np.random.default_rng(6)
    r, t = rsw.init_switch_state(1), tsw.init_switch_state(1)
    for slot in range(60):
        event = rng.integers(0, 4)
        if event < 2:
            mode, valid = int(rng.integers(0, 3)), bool(event == 0)
            r = rsw.commit_decision(r, mode, valid)
            t = tsw.commit_decision(t, mode, valid)
        r = rsw.slot_boundary(r, fail_safe_mode=1, ttl_slots=4)
        t = tsw.slot_boundary(t, fail_safe_mode=1, ttl_slots=4)
        assert tuple(int(v) for v in r) == tuple(t), slot
    assert t.n_switches > 3
    assert isinstance(t.active_mode, int)


def _threshold(x):
    """mode 0 (AI) when KPM 'q' < 5 (and 'r' agrees), else 1 (MMSE)."""
    return 0 if x[0] < 5.0 and x[-1] < 50.0 else 1


def _run_loop(pkg_rt, pkg_dapp, pkg_e3, series, *, window, period, ttl, fail_at,
              recover_at, two_sources):
    agent = pkg_e3.E3Agent()
    names = ["q", "r"] if two_sources else ["q"]
    dapp = pkg_dapp.DApp(_threshold, names, window_slots=window, period_slots=period)
    pkg_dapp.connect_dapp(agent, dapp)

    def slot_fn(active_mode, carry, slot):
        if slot == fail_at:
            dapp.fail()
        if slot == recover_at:
            dapp.recover()
        q = series[slot]
        kpms = {"aerial": {"q": q}}
        if two_sources:  # the oai half arrives as its own indication
            kpms["oai"] = {"r": 10.0 * q}
        return carry, {"q": q}, kpms

    runtime = pkg_rt.ArchesRuntime(slot_fn, agent, default_mode=1, fail_safe_mode=1,
                                   ttl_slots=ttl)
    hist = runtime.run(range(len(series)))
    return hist, dapp, agent


@pytest.mark.parametrize("window,period,ttl,fail_at,recover_at,two_sources", [
    (1, 1, 8, None, None, False),
    (3, 1, 8, None, None, True),   # window smoothing, multi-source join
    (1, 3, 8, None, None, False),  # decision period
    (1, 1, 4, 6, None, False),     # dApp failure -> fail-safe decay after the TTL
    (2, 1, 3, 5, 14, True),        # failure, decay, recovery
])
def test_host_control_loop_against_reference(window, period, ttl, fail_at, recover_at,
                                             two_sources):
    series = [10.0] * 4 + [0.0] * 6 + [10.0] * 3 + [0.0] * 7
    kw = dict(window=window, period=period, ttl=ttl, fail_at=fail_at,
              recover_at=recover_at, two_sources=two_sources)
    rh, rd, ra = _run_loop(rrt, rdapp, re3, series, **kw)
    th, td, ta = _run_loop(trt, tdapp, te3, series, **kw)
    np.testing.assert_array_equal(th.modes, rh.modes)
    assert [(d.slot, d.mode) for d in td.decisions] == [
        (d.slot, d.mode) for d in rd.decisions]
    assert tuple(th.final_state) == tuple(int(v) for v in rh.final_state)
    assert (ta.indications_sent, ta.controls_received) == (
        ra.indications_sent, ra.controls_received)
    np.testing.assert_array_equal(th.kpm_series("q"), rh.kpm_series("q"))
    assert th.final_state.n_switches >= 1  # the loop really switched
    for d in td.decisions:  # the paper's latency model, the same constants
        assert d.end_to_end_us == rdapp.ControlLoopLatency().end_to_end_us(d.mode, d.policy_us)
    if fail_at is not None and recover_at is None:
        assert (th.modes[fail_at + ttl + 1:] == 1).all()  # decayed to the fail-safe


def test_latency_model_and_e3_filtering_match_reference():
    r, t = rdapp.ControlLoopLatency(), tdapp.ControlLoopLatency()
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    for mode in (0, 1, 2):
        assert t.end_to_end_us(mode) == r.end_to_end_us(mode)
        assert t.end_to_end_us(mode, 3.5) == r.end_to_end_us(mode, 3.5)
    seen = {"r": [], "t": []}
    for tag, pkg in (("r", re3), ("t", te3)):
        agent = pkg.E3Agent()
        agent.subscribe(pkg.E3Subscription(callback=seen[tag].append, period_slots=2,
                                           sources=("oai",)))
        for slot in range(5):
            for src in ("aerial", "oai"):
                agent.indicate(pkg.E3IndicationMessage(slot=slot, source=src, kpms={"a": 1.0}))
        for m in (1, 0, 2):
            agent.send_control(pkg.E3ControlMessage(slot=0, mode=m))
        seen[tag + "_ctrl"] = agent.poll_control().mode
    assert [(m.slot, m.source) for m in seen["t"]] == [(m.slot, m.source) for m in seen["r"]]
    assert seen["t_ctrl"] == seen["r_ctrl"] == 2


def test_batched_history_views_and_telemetry_replay():
    """``from_host``, the per-UE views and the E3 replay of a batched
    trajectory, against the reference on the same arrays."""
    rng = np.random.default_rng(8)
    kpms = {"aerial": {"sinr": rng.normal(size=(4, 3)).astype(np.float32)},
            "oai": {"snr": rng.normal(size=(4, 3)).astype(np.float32)}}
    modes = rng.integers(0, 2, size=(4, 3)).astype(np.int32)
    traj = {"kpms": kpms, "tb_ok": np.ones((4, 3), np.float32)}
    rh = rrt.BatchedRunHistory.from_trajectory(modes, traj)
    th = trt.BatchedRunHistory.from_trajectory(
        torch.as_tensor(modes),
        {"kpms": {s: {k: torch.as_tensor(v) for k, v in d.items()} for s, d in kpms.items()},
         "tb_ok": torch.ones(4, 3)})
    assert (th.n_slots, th.n_ues) == (rh.n_slots, rh.n_ues)
    np.testing.assert_array_equal(th.modes_for(2), rh.modes_for(2))
    np.testing.assert_array_equal(th.kpm_series("snr", 1), rh.kpm_series("snr", 1))
    np.testing.assert_array_equal(th.cell_kpm_series("sinr"), rh.cell_kpm_series("sinr"))
    assert [(r.slot, r.active_mode, r.kpms) for r in th.per_ue(1)] == [
        (r.slot, r.active_mode, r.kpms) for r in rh.per_ue(1)]
    got, want = [], []
    for store, pkg, tr in ((got, te3, th), (want, re3, rh)):
        agent = pkg.E3Agent()
        agent.subscribe(pkg.E3Subscription(callback=store.append))
        mod = trt if pkg is te3 else rrt
        assert mod.replay_batched_telemetry(agent, traj) == 4
    assert [(m.slot, m.source, dict(m.kpms)) for m in got] == [
        (m.slot, m.source, dict(m.kpms)) for m in want]


# -- whole host sessions -------------------------------------------------------

THRESHOLD = dict(kind="threshold", feature="snr", threshold=18.0, hysteresis=2.0)
#: a depth-2 tree over (snr, mcs_index), carried into both packages
TREE = dict(feature=[5, 1, 5], threshold=[16.0, 14.0, 24.0], leaf_values=[0.0, 0.0, 1.0, 1.0])


def _host_spec(pkg, policy_kind):
    kw = dict(path="host", scenario="good_poor_good",
              scenario_args=(("poor_start", 3), ("poor_end", 7)), n_ues=1, n_slots=11,
              seed=3, switch=pkg.SwitchSpec(window_slots=2, ttl_slots=8))
    if policy_kind == "threshold":
        return pkg.CampaignSpec(policies=(pkg.PolicySpec(**THRESHOLD),), **kw)
    return pkg.CampaignSpec(policies=(pkg.PolicySpec(kind="tree"),), **kw)


def _ref_host_decisions(rsess):
    """The reference session's ``_run_host``, rebuilt to keep its dApp."""
    agent = re3.E3Agent()
    spec = rsess.spec
    dapp = rdapp.DApp(rsess.host_policies[0], spec.feature_names,
                      window_slots=spec.switch.window_slots)
    rdapp.connect_dapp(agent, dapp)
    runtime = rrt.ArchesRuntime(rsess.pipeline.make_slot_fn(rsess.schedule), agent,
                                default_mode=1, fail_safe_mode=1,
                                ttl_slots=spec.switch.ttl_slots, keep_outputs=True)
    hist = runtime.run(range(spec.n_slots))
    return hist, [(d.slot, d.mode) for d in dapp.decisions]


@pytest.mark.parametrize("policy_kind", ["threshold", "tree"])
def test_host_session_against_reference(policy_kind):
    rspec, tspec = _host_spec(rses, policy_kind), _host_spec(tses, policy_kind)
    assert tses.spec_hash(tspec) == rses.spec_hash(rspec)
    assert tspec.to_json() == rspec.to_json()
    rkw, tkw = {}, {}
    if policy_kind == "tree":
        tree = RFittedTree(feature=np.asarray(TREE["feature"], np.int32),
                           threshold=np.asarray(TREE["threshold"], np.float32),
                           leaf_values=np.asarray(TREE["leaf_values"], np.float32),
                           depth=2, n_features=10, importances=np.zeros(10, np.float32))
        rkw["host_policies"] = (RTreePolicy(tree, rspec.feature_names),)
        tkw["host_policies"] = (tree_policy_from_reference(
            TREE["feature"], TREE["threshold"], TREE["leaf_values"], tspec.feature_names),)
    rsess = rses.ArchesSession(rspec, **rkw)
    rhist = rsess.run()
    tsess = tses.ArchesSession(tspec, device="cpu", **tkw)
    thist = tsess.run()
    assert thist.modes.shape == rhist.modes.shape == (11, 1)
    np.testing.assert_array_equal(thist.modes, rhist.modes)
    assert set(np.unique(thist.modes)) == {0, 1}  # both experts served
    for k in ("mcs", "tb_ok", "tbs"):
        np.testing.assert_array_equal(thist.outputs[k], rhist.outputs[k], err_msg=k)
    np.testing.assert_allclose(thist.outputs["phy_bits_per_s"],
                               rhist.outputs["phy_bits_per_s"], rtol=0)
    assert set(thist.kpms) == set(rhist.kpms)
    for k, want in rhist.kpms.items():
        np.testing.assert_allclose(thist.kpms[k], want, rtol=KPM_RTOL, atol=KPM_ATOL,
                                   err_msg=k)
    legacy, decisions = _ref_host_decisions(rsess)
    np.testing.assert_array_equal(legacy.modes, rhist.modes[:, 0])
    assert [(d.slot, d.mode) for d in tsess.dapp.decisions] == decisions


def test_host_session_validation():
    base = _host_spec(tses, "threshold")
    for bad in (dict(n_ues=2), dict(policies=()),
                dict(switch=tses.SwitchSpec(hysteresis_slots=2)),
                dict(scenario="mixed_cell")):
        with pytest.raises(ValueError):
            tses.ArchesSession(dataclasses.replace(base, **bad), device="cpu")
    with pytest.raises(ValueError, match="gated"):
        dataclasses.replace(base, bank=tses.ExpertBankSpec(execution_mode="gated"))


def test_runtime_from_spec_run_batched_equals_session_closed_loop():
    """The session's closed loop runs through ``ArchesRuntime``: a runtime
    that ``from_spec`` builds with its own exported policy (only the engine
    passed in) gives the same campaign."""
    spec = tses.CampaignSpec(path="closed_loop", scenario="good_poor_good",
                             scenario_args=(("poor_start", 2), ("poor_end", 5)), n_ues=2,
                             n_slots=7, seed=4, policies=(tses.PolicySpec(**THRESHOLD),))
    sess = tses.ArchesSession(spec, device="cpu")
    want = sess.run()
    runtime = trt.ArchesRuntime.from_spec(spec, engine=sess.engine)
    got = runtime.run_batched(sess.schedule, n_slots=7, n_ues=2, key=jr.PRNGKey(4),
                              provisioned_capacity=3)
    np.testing.assert_array_equal(got.modes, want.modes)
    np.testing.assert_array_equal(got.decisions, want.decisions)
    np.testing.assert_array_equal(got.n_switches, want.n_switches)
    for name, v in want.kpms.items():
        np.testing.assert_array_equal(got.kpms[name], v)
    assert got.provisioned_capacity == 3 and want.provisioned_capacity is None
    with pytest.raises(RuntimeError):
        trt.ArchesRuntime().run_batched(sess.schedule, n_slots=1, n_ues=1)
    with pytest.raises(ValueError):
        trt.ArchesRuntime(closed_loop=True)
