"""The policy-design methodology of the port against ``repro`` (paper 4): the
stage-1 perturbation, the batched sweep and the ``perturbed`` session path,
and the stage-2/3 filters on one sweep.

Same keys and numpy inputs on both sides; each tolerance is stated beside
it.  The sweep campaigns run at the reference tests' small shape.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import methodology as rm
from repro.core import session as rses
from repro.phy import pipeline as rpipe
from repro.phy.ai_estimator import AiEstimatorConfig as RNet
from repro.phy.ai_estimator import init_params
from repro.phy.nr import SlotConfig as RSlotConfig
from repro.phy.scenario import make_schedule as r_make_schedule
from repro_torch import random as jr
from repro_torch.convert import ai_params_from_reference
from repro_torch.core import methodology as tm
from repro_torch.core import session as tses
from repro_torch.phy import pipeline as tpipe
from repro_torch.phy.ai_estimator import AiEstimatorConfig
from repro_torch.phy.nr import SlotConfig
from repro_torch.phy.scenario import get_scenario

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

CFG, RCFG = SlotConfig(n_prb=24), RSlotConfig(n_prb=24)
NET, RNET = AiEstimatorConfig(channels=8, n_res_blocks=1), RNet(channels=8, n_res_blocks=1)

#: error allowed on a perturbed estimate, in ulp of the larger addend of
#: ``h + noise``: the normals are within NORMAL_MAX_ULP = 4 ulp of jax's (XLA's
#: erf_inv polynomial, tests/test_torch_random.py); the scale E[|h|] is a
#: float32 mean summed in another order (2 ulp apart on these inputs); the
#: division by sqrt(2), the two products and the final sum round once each.
#: Measured on the inputs below: at most 5.
PERTURB_MAX_ULP = 8
#: sweep KPMs of campaigns whose discrete path (MCS, TB outcome) agrees, as in
#: tests/test_torch_campaign.py: float32 stages compound through link adaptation
KPM_RTOL, KPM_ATOL = 1e-4, 1e-4

RHOS = (0.0, 0.8, 1.6)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _perturb_ulp(got: np.ndarray, want: np.ndarray, h: np.ndarray) -> float:
    """Largest error of ``got`` against ``want``, in ulp of the larger addend
    of ``h + noise`` (a near-cancelling sum has tiny ulps of its own)."""
    worst = 0.0
    for part in (np.real, np.imag):
        mag = np.maximum(np.abs(part(h)), np.abs(part(want) - part(h))).astype(np.float32)
        err = np.abs(part(got).astype(np.float64) - part(want))
        worst = max(worst, float((err / np.spacing(mag)).max()))
    return worst


@pytest.mark.parametrize("rho", [0.0, 0.3, 1.0, 2.0])
def test_perturb_estimate_within_ulp(rho):
    rng = np.random.default_rng(int(rho * 10))
    h = ((rng.normal(size=(4, 1, 36, 3)) + 1j * rng.normal(size=(4, 1, 36, 3))) * 3.0
         ).astype(np.complex64)
    for seed in (0, 7, 2**31 - 1):
        want = np.asarray(rm.perturb_estimate(jnp.asarray(h), rho, jax.random.PRNGKey(seed)))
        got = _np(tm.perturb_estimate(torch.as_tensor(h), rho, jr.PRNGKey(seed)))
        ulp = _perturb_ulp(got, want, h)
        print(f"rho {rho} seed {seed}: max ulp {ulp:.2f}")
        assert ulp <= PERTURB_MAX_ULP
        if rho == 0.0:
            np.testing.assert_array_equal(got, h)


def test_perturb_estimate_per_ue_keys_match_mapped_reference():
    """Leading key axes: one perturbation per UE, each with its own E[|h|]
    and rho, as the reference's batched engine maps it."""
    rng = np.random.default_rng(3)
    h = (rng.normal(size=(3, 2, 1, 12, 3)) + 1j * rng.normal(size=(3, 2, 1, 12, 3))
         ).astype(np.complex64)
    rho = np.asarray([0.0, 0.5, 1.9], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    want = np.asarray(jax.vmap(rm.perturb_estimate)(jnp.asarray(h), jnp.asarray(rho), keys))
    got = _np(tm.perturb_estimate(torch.as_tensor(h), torch.as_tensor(rho),
                                  jr.as_key(np.asarray(keys))))
    assert _perturb_ulp(got, want, h) <= PERTURB_MAX_ULP
    np.testing.assert_array_equal(got[0], h[0])
    with pytest.raises(ValueError):
        tm.perturb_estimate(torch.as_tensor(h), 1.0, jr.as_key(np.asarray(keys[:2])))


def test_sensitivity_sweep_host_harness_keys_and_stats():
    """The host harness hands ``eval_fn`` the same key stream and reduces the
    same statistics."""
    seen = {"r": [], "t": []}

    def make(tag):
        def eval_fn(rho, key):
            k = np.asarray(key).astype(np.uint32) if tag == "r" else \
                key.numpy().astype(np.uint32)
            seen[tag].append(k)
            return {"a": 10.0 - rho + float(k[1] % 7), "b": rho * float(k[0] % 5)}
        return eval_fn

    r = rm.sensitivity_sweep(make("r"), rhos=(0.0, 0.5, 1.0), n_trials=3,
                             key=jax.random.PRNGKey(4))
    t = tm.sensitivity_sweep(make("t"), rhos=(0.0, 0.5, 1.0), n_trials=3,
                             key=jr.PRNGKey(4))
    np.testing.assert_array_equal(np.stack(seen["t"]), np.stack(seen["r"]))
    assert t.kpm_names == r.kpm_names
    for f in ("rhos", "means", "ci95", "samples"):
        np.testing.assert_array_equal(getattr(t, f), getattr(r, f), err_msg=f)
    assert tm.DEFAULT_RHOS == rm.DEFAULT_RHOS and len(tm.DEFAULT_RHOS) == 21


@pytest.fixture(scope="module")
def sweeps():
    """``sensitivity_sweep_batched`` on both packages' engines: 3 rhos x 2
    trials = 6 UEs, 3 slots each."""
    params = init_params(jax.random.PRNGKey(0), RCFG, RNET)
    r_engine = rpipe.BatchedPuschPipeline(RCFG, params, net=RNET)
    t_engine = tpipe.BatchedPuschPipeline(CFG, ai_params_from_reference(params), net=NET,
                                          device="cpu")
    kw = dict(rhos=RHOS, n_trials=2, slots_per_trial=3)
    r = rm.sensitivity_sweep_batched(r_engine, r_make_schedule("good"),
                                     key=jax.random.PRNGKey(9), **kw)
    t = tm.sensitivity_sweep_batched(t_engine, get_scenario("good").schedule(),
                                     key=jr.PRNGKey(9), **kw)
    return r, t


def test_sensitivity_sweep_batched_against_reference(sweeps):
    r, t = sweeps
    assert t.kpm_names == r.kpm_names
    np.testing.assert_array_equal(t.rhos, r.rhos)
    assert t.samples.shape == r.samples.shape == (len(RHOS), 2, len(r.kpm_names))
    for name in ("mcs_index", "qam_order", "ndi", "tb_size", "n_code_blocks"):
        k = r.kpm_names.index(name)
        np.testing.assert_array_equal(t.samples[..., k], r.samples[..., k], err_msg=name)
    np.testing.assert_allclose(t.samples, r.samples, rtol=KPM_RTOL, atol=KPM_ATOL)
    np.testing.assert_allclose(t.means, r.means, rtol=KPM_RTOL, atol=KPM_ATOL)
    # the perturbation bites: SNR falls with rho on both sides
    k = r.kpm_names.index("snr")
    assert t.means[-1, k] < t.means[0, k] - 3.0


def test_stage2_and_stage3_equal_reference(sweeps):
    """Monotonicity filter, redundancy reduction and the paper's stage-3
    split, on one ``SweepResult`` (the reference's, so both see the same
    numbers): the same scipy calls give the same answers."""
    r, _ = sweeps
    t = tm.SweepResult(**dataclasses.asdict(r))
    for thr in (0.5, 0.8):
        assert tm.monotonicity_filter(t, min_abs_spearman=thr) == \
            rm.monotonicity_filter(r, min_abs_spearman=thr)
    flat = {n: r.samples[:, :, k].reshape(-1) for k, n in enumerate(r.kpm_names)}
    aerial_names = ("code_rate", "sinr", "qam_order", "mcs_index", "tb_size",
                    "n_code_blocks", "pdu_length", "ndi", "rsrp")
    aerial = {n: v for n, v in flat.items() if n in aerial_names}
    oai = {n: v for n, v in flat.items() if n not in aerial_names}
    tc, rc = tm.redundancy_reduction(aerial), rm.redundancy_reduction(aerial)
    assert tc.names == rc.names and tc.representatives == rc.representatives
    np.testing.assert_array_equal(tc.corr, rc.corr)
    np.testing.assert_array_equal(tc.labels, rc.labels)
    np.testing.assert_array_equal(tc.order, rc.order)
    t_sel, t_a, t_o = tm.design_policy_inputs(aerial, oai)
    r_sel, r_a, r_o = rm.design_policy_inputs(aerial, oai)
    assert t_sel == r_sel
    assert t_a.representatives == r_a.representatives
    assert t_o.representatives == r_o.representatives


@pytest.mark.parametrize("scenario", ["good", "good_poor_good"])
def test_perturbed_session_against_reference(scenario):
    rho = (0.0, 0.7, 1.6)
    kw = dict(path="perturbed", scenario=scenario, n_ues=3, n_slots=5, seed=5, rho=rho)
    if scenario == "good_poor_good":
        kw["scenario_args"] = (("poor_start", 2), ("poor_end", 4))
    rspec, tspec = rses.CampaignSpec(**kw), tses.CampaignSpec(**kw)
    assert tses.spec_hash(tspec) == rses.spec_hash(rspec)
    rhist = rses.ArchesSession(rspec).run()
    thist = tses.ArchesSession(tspec, device="cpu").run()
    np.testing.assert_array_equal(thist.modes, rhist.modes)
    assert (thist.modes == 1).all()  # stage 1 is MMSE-only
    for k in ("mcs", "tb_ok", "tbs", "executed_flops", "gated_overflow"):
        np.testing.assert_array_equal(thist.outputs[k], rhist.outputs[k], err_msg=k)
    for k, want in rhist.kpms.items():
        np.testing.assert_allclose(thist.kpms[k], want, rtol=KPM_RTOL, atol=KPM_ATOL,
                                   err_msg=k)


def test_perturbed_session_validation():
    with pytest.raises(ValueError, match="rho grid"):
        tses.ArchesSession(tses.CampaignSpec(path="perturbed", n_ues=2), device="cpu")
    with pytest.raises(ValueError, match="UE axis"):
        tses.ArchesSession(tses.CampaignSpec(path="perturbed", n_ues=2, rho=(0.1,)),
                           device="cpu")
    with pytest.raises(ValueError, match="ignores the expert bank"):
        tses.CampaignSpec(path="perturbed", rho=(0.0,) * 4,
                          bank=tses.ExpertBankSpec(execution_mode="gated"))
