"""PHY stages of the port against ``repro`` on the same inputs.

Each stage gets numpy inputs (or the same PRNG key) on both sides; the
reference's per-UE functions are vmapped over the port's leading UE axis.
Integer, table and data-movement stages compare bitwise; float stages
carry a tolerance stated beside them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.phy import channel as rch
from repro.phy import dmrs as rdmrs
from repro.phy import equalizer as req
from repro.phy import estimators as rest
from repro.phy import link as rlink
from repro.phy import mcs as rmcs
from repro.phy import qam as rqam
from repro.phy.nr import SlotConfig as RSlotConfig
from repro_torch import random as jr
from repro_torch.phy import channel as tch
from repro_torch.phy import dmrs as tdmrs
from repro_torch.phy import equalizer as teq
from repro_torch.phy import estimators as test_
from repro_torch.phy import link as tlink
from repro_torch.phy import mcs as tmcs
from repro_torch.phy import qam as tqam
from repro_torch.phy.nr import SlotConfig

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

N_PRB = 24
CFG, RCFG = SlotConfig(n_prb=N_PRB), RSlotConfig(n_prb=N_PRB)

#: float32 stages computed with the same formula: a few ulp of reassociation
#: (XLA fuses and reorders elementwise chains, complex products use another
#: expansion) on O(1) values
F32_TOL = dict(rtol=2e-5, atol=2e-6)


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_slot_config_and_dmrs_bitwise():
    for f in ("n_sc", "n_sym", "n_dmrs_sym", "n_pilot_sc", "slot_duration_s"):
        assert getattr(CFG, f) == getattr(RCFG, f)
    assert CFG.n_data_re() == RCFG.n_data_re()
    np.testing.assert_array_equal(CFG.pilot_sc_indices, RCFG.pilot_sc_indices)
    np.testing.assert_array_equal(tdmrs.dmrs_sequence(CFG).numpy(),
                                  np.asarray(rdmrs.dmrs_sequence(RCFG)))


def test_grid_map_and_extract_bitwise(rng):
    pilots = rdmrs.dmrs_sequence(RCFG)
    data = _cplx(rng, (3, CFG.n_data_re()))
    want = jax.vmap(lambda d: rdmrs.map_slot_grid(RCFG, d, pilots))(jnp.asarray(data))
    got = tdmrs.map_slot_grid(CFG, _t(data), tdmrs.dmrs_sequence(CFG))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    grid = _cplx(rng, (3, 4, CFG.n_sc, CFG.n_sym))
    np.testing.assert_array_equal(tdmrs.extract_data_re(CFG, _t(grid)).numpy(),
                                  np.asarray(rdmrs.extract_data_re(RCFG, jnp.asarray(grid))))
    np.testing.assert_array_equal(tdmrs.extract_pilot_re(CFG, _t(grid)).numpy(),
                                  np.asarray(rdmrs.extract_pilot_re(RCFG, jnp.asarray(grid))))


@pytest.mark.parametrize("qm", [2, 4, 6, 8])
def test_qam_modulate_and_nearest_bitwise(qm, rng):
    np.testing.assert_array_equal(tqam.constellation(qm).numpy(),
                                  np.asarray(rqam.constellation(qm)))
    bits = rng.integers(0, 2, size=(3, 60 * qm)).astype(np.uint8)
    np.testing.assert_array_equal(tqam.modulate(_t(bits), qm).numpy(),
                                  np.asarray(rqam.modulate(jnp.asarray(bits), qm)))
    y = (1.3 * _cplx(rng, (3, 500))).astype(np.complex64)
    np.testing.assert_array_equal(tqam.nearest_point(_t(y), qm).numpy(),
                                  np.asarray(rqam.nearest_point(jnp.asarray(y), qm)))


def test_mcs_tables_and_selection_bitwise(rng):
    n_re = CFG.n_data_re()
    np.testing.assert_array_equal(tmcs.tbs_table(n_re), rmcs.tbs_table(n_re))
    np.testing.assert_array_equal(tmcs.n_code_blocks_table(n_re),
                                  rmcs.n_code_blocks_table(n_re))
    for name in ("QM_BY_MCS", "QM_INDEX_BY_MCS", "RATE_BY_MCS", "QM_VALUES",
                 "SNR_THRESHOLDS_DB"):
        np.testing.assert_array_equal(np.asarray(getattr(tmcs, name)),
                                      np.asarray(getattr(rmcs, name)), err_msg=name)
    snr = rng.uniform(-10, 40, size=400).astype(np.float32)
    snr[:len(tmcs.SNR_THRESHOLDS_DB)] = tmcs.SNR_THRESHOLDS_DB + 1.0  # on the edges
    np.testing.assert_array_equal(
        tmcs.select_mcs_index(_t(snr)).numpy(),
        np.asarray(jax.vmap(rmcs.select_mcs_index)(jnp.asarray(snr))))


def _ref_fields(keys, profile, params_j, n):
    return jax.vmap(lambda k, p: rch.simulate_slot_channel_traced(k, RCFG, profile, p))(
        keys, jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), params_j))


@pytest.mark.parametrize("interference,duty,collision", [
    (False, 1.0, False), (True, 1.0, False), (True, 0.5, False), (True, 0.4, True),
])
def test_channel_fields_and_apply_channel(interference, duty, collision, rng):
    """Same keys -> same fields.  Tolerance: the fading and steering run the
    reference's float32 formulas, but sin/cos of the steering phase and the
    einsum's reduction order differ by a few ulp; the interference symbol
    mask is a uniform draw against a threshold and must agree exactly."""
    ch = rch.ChannelConfig(profile=rch.INDOOR_NLOS, snr_db=13.0, interference=interference,
                           interference_symbol_duty=duty, dmrs_collision=collision)
    tch_cfg = tch.ChannelConfig(profile=tch.INDOOR_NLOS, snr_db=13.0,
                                interference=interference,
                                interference_symbol_duty=duty, dmrs_collision=collision)
    n = 3
    root = jax.random.PRNGKey(int(rng.integers(0, 2**31)))
    keys_j = jax.random.split(root, n)
    keys_t = jr.as_key(np.asarray(keys_j))
    pj = rch.channel_params(RCFG, ch)
    pt = tch.channel_params(CFG, tch_cfg)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = _ref_fields(keys_j, rch.INDOOR_NLOS, pj, n)
    got = tch.simulate_slot_channel_traced(keys_t, CFG, tch.INDOOR_NLOS,
                                           tch.per_ue_params(pt, n))
    np.testing.assert_allclose(got["h"].numpy(), np.asarray(want["h"]), rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(got["noise_var"].numpy(), np.asarray(want["noise_var"]))
    np.testing.assert_allclose(got["interference"].numpy(), np.asarray(want["interference"]),
                               rtol=1e-4, atol=2e-5)
    # the interference symbol occupancy (a thresholded uniform) matches exactly
    on_t = got["interference"].abs().sum(dim=(1, 2)).numpy() > 0
    on_j = np.abs(np.asarray(want["interference"])).sum(axis=(1, 2)) > 0
    np.testing.assert_array_equal(on_t, on_j)

    # apply_channel on identical fields and TX grid
    tx = _cplx(rng, (n, 1, CFG.n_sc, CFG.n_sym))
    kn_j = jax.random.split(jax.random.PRNGKey(99), n)
    fields_np = {k: np.asarray(v) for k, v in want.items()}
    y_j = jax.vmap(rch.apply_channel)(kn_j, jnp.asarray(tx),
                                      {k: jnp.asarray(v) for k, v in fields_np.items()})
    y_t = tch.apply_channel(jr.as_key(np.asarray(kn_j)), _t(tx),
                            {k: _t(v) for k, v in fields_np.items()})
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32_TOL)


def test_schedules_lower_identically():
    from repro.phy.scenario import get_scenario as rget
    from repro_torch.phy.scenario import get_scenario as tget

    for name, kw in (("good_poor_good", dict(poor_start=3, poor_end=6)),
                     ("bursty_interference", {}), ("snr_ramp", {})):
        prof_j, pj = rch.channel_params_schedule(RCFG, rget(name).schedule(**kw), 10)
        prof_t, pt = tch.channel_params_schedule(CFG, tget(name).schedule(**kw), 10)
        assert prof_t.delays_s == prof_j.delays_s and prof_t.powers_db == prof_j.powers_db
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    sj = rget("mixed_cell").schedule(n_ues=5)
    st = tget("mixed_cell").schedule(n_ues=5)
    _, pj = rch.channel_params_ue_schedule(RCFG, sj, 8)
    _, pt = tch.channel_params_ue_schedule(CFG, st, 8)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ls_estimate_and_wiener_w(rng):
    pilots = rdmrs.dmrs_sequence(RCFG)
    rx = _cplx(rng, (3, 4, CFG.n_sc, CFG.n_sym))
    want = jax.vmap(lambda g: rest.ls_estimate(RCFG, g, pilots))(jnp.asarray(rx))
    got = test_.ls_estimate(CFG, _t(rx), tdmrs.dmrs_sequence(CFG))
    # |pilot|^2 = 1 (+1e-12): complex-by-real division, a 1-ulp rounding at most
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7, atol=1e-7)
    for spread in (30e-9, 100e-9):
        np.testing.assert_array_equal(
            test_.WienerInterpolator.build(CFG, rms_delay_spread_s=spread, device="cpu").w.numpy(),
            np.asarray(rest.WienerInterpolator.build(RCFG, rms_delay_spread_s=spread).w))
    assert test_.estimator_flops(CFG) == rest.estimator_flops(RCFG)


def test_mmse_equalize(rng):
    rx = _cplx(rng, (3, 4, CFG.n_sc, CFG.n_sym))
    h = _cplx(rng, (3, 4, 1, CFG.n_sc, CFG.n_dmrs_sym))
    nv = rng.uniform(0.01, 0.5, size=3).astype(np.float32)
    xj, sj = jax.vmap(lambda a, b, c: req.mmse_equalize(RCFG, a, b, c))(
        jnp.asarray(rx), jnp.asarray(h), jnp.asarray(nv))
    xt, st = teq.mmse_equalize(CFG, _t(rx), _t(h), _t(nv))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **F32_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **F32_TOL)


def test_tb_success_dynamic(rng):
    """The MI is a float32 mean (tolerance); the outcome compares one uniform
    per UE with a sigmoid of it, so it is compared where the draw is not
    within rounding of the success probability."""
    n = 64
    sinr = rng.gamma(2.0, 8.0, size=(n, 96)).astype(np.float32)
    qm = rng.choice([2, 4, 6, 8], size=n).astype(np.float32)
    rate = rng.uniform(0.1, 0.9, size=n).astype(np.float32)
    mi_j = jax.vmap(rlink.effective_mi_dynamic)(jnp.asarray(sinr), jnp.asarray(qm))
    mi_t = tlink.effective_mi_dynamic(_t(sinr), _t(qm))
    np.testing.assert_allclose(mi_t.numpy(), np.asarray(mi_j), rtol=1e-5, atol=1e-6)
    keys_j = jax.random.split(jax.random.PRNGKey(3), n)
    ok_j = np.asarray(jax.vmap(lambda s, q, r, k: rlink.tb_success_dynamic(s, q, r, key=k))(
        jnp.asarray(sinr), jnp.asarray(qm), jnp.asarray(rate), keys_j))
    ok_t = tlink.tb_success_dynamic(_t(sinr), _t(qm), _t(rate),
                                    key=jr.as_key(np.asarray(keys_j))).numpy()
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys_j))
    p = 1.0 / (1.0 + np.exp(-(np.asarray(mi_j) - (rate + 0.05)) * 80.0))
    clear = np.abs(u - p) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ok_t[clear], ok_j[clear])
    # the deterministic (keyless) outcome
    np.testing.assert_array_equal(
        tlink.tb_success_dynamic(_t(sinr), _t(qm), _t(rate)).numpy(),
        np.asarray(jax.vmap(rlink.tb_success_dynamic)(
            jnp.asarray(sinr), jnp.asarray(qm), jnp.asarray(rate))))
