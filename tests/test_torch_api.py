"""The port's public ARCHES API against ``repro``'s: the names the package
``__init__``s re-export, and each name this slice ported, on the same inputs
(numpy, from a seed)."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
import repro.phy
import repro_torch.core
import repro_torch.phy
from repro.core import policy as rpolicy
from repro.core import telemetry as rtel
from repro.phy import channel as rch
from repro.phy import equalizer as req
from repro.phy import estimators as rest
from repro.phy import nr as rnr
from repro.phy import scenario as rsc
from repro_torch.core import policy as tpolicy
from repro_torch.core import telemetry as ttel
from repro_torch.kernels import build
from repro_torch.phy import channel as tch
from repro_torch.phy import dmrs as tdmrs
from repro_torch.phy import equalizer as teq
from repro_torch.phy import estimators as test_
from repro_torch.phy import nr as tnr
from repro_torch.phy import scenario as tsc

torch.set_num_threads(1)

#: the reference's JAX mesh factory that has no counterpart of the same name:
#: ``CellTopology.build`` over a process group stands in for the UE mesh
#: (``core/topology.py``); the training meshes are ported as descriptors
MESH_FACTORIES = {"make_ue_mesh"}
#: LS + Wiener at n_prb 24: 144 complex products a subcarrier summed in
#: another order (the plain Gauss form against XLA's einsum, or the Pallas
#: kernel in interpret mode); outputs are O(1)
MMSE_TOL = dict(rtol=1e-5, atol=1e-5)
#: MMSE-IRC: per-subband 4x4 complex covariances, a batched complex solve
#: (LAPACK in both packages, through different wrappers) and the combiner's
#: sums; symbol estimates are O(1), the SINR's relative error is read alone
IRC_X_ATOL, IRC_SINR_RTOL = 1e-5, 1e-5


def _public(module) -> set[str]:
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in dir(module) if not n.startswith("_")
                 and not inspect.ismodule(getattr(module, n))]
    return set(names)


@pytest.mark.parametrize("ref,port", [(repro.phy, repro_torch.phy),
                                      (repro.core, repro_torch.core)], ids=["phy", "core"])
def test_init_exports_mirror_reference(ref, port):
    assert _public(port) == _public(ref) - MESH_FACTORIES
    for name in _public(port):
        obj = getattr(port, name)
        if callable(obj):
            assert obj.__module__.startswith("repro_torch"), name


def test_core_import_starts_no_cuda_and_no_service():
    import subprocess
    import sys

    probe = ("import sys, torch, repro_torch.core, repro_torch.phy; "
             "assert not torch.cuda.is_initialized(); "
             "assert not [m for m in sys.modules if m.startswith('repro_torch.service')]")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_slot():
    t, r = tnr.DEFAULT_SLOT, rnr.DEFAULT_SLOT
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    for prop in ("n_sc", "n_sym", "n_dmrs_sym", "n_pilot_sc", "slot_duration_s"):
        assert getattr(t, prop) == getattr(r, prop)
    for prop in ("pilot_sc_indices", "data_sc_indices", "data_symbols"):
        np.testing.assert_array_equal(getattr(t, prop), getattr(r, prop))
    assert t.n_data_re() == r.n_data_re()


@pytest.mark.parametrize("kw", [{}, dict(poor_start=3, poor_end=7)])
def test_condition_label(kw):
    assert [tsc.condition_label(s, **kw) for s in range(0, 260, 3)] == \
        [rsc.condition_label(s, **kw) for s in range(0, 260, 3)]


def _cfg_dict(c) -> dict:
    return dataclasses.asdict(c)


@pytest.mark.parametrize("name", rsc.scenario_names())
def test_make_schedule_every_registered_scenario(name):
    assert tsc.scenario_names() == rsc.scenario_names()
    per_ue = rsc.get_scenario(name).per_ue
    kw = dict(n_ues=4) if per_ue else {}
    want, got = rsc.make_schedule(name, **kw), tsc.make_schedule(name, **kw)
    if per_ue:
        assert len(got) == len(want) == 4
    else:
        want, got = [want], [got]
    for w, g in zip(want, got):
        for s in range(0, 40, 3):
            assert _cfg_dict(g(s)) == _cfg_dict(w(s)), (name, s)


@pytest.mark.parametrize("name,kw", [("good_poor_good", dict(poor_start=2, poor_end=5)),
                                     ("mixed_cell", dict(n_ues=3)),
                                     ("bursty_interference", dict(period=4, burst_slots=1))])
def test_scenario_params(name, kw):
    cfg_t, cfg_r = tnr.SlotConfig(n_prb=6), rnr.SlotConfig(n_prb=6)
    prof_r, want = rsc.scenario_params(cfg_r, name, n_slots=7, **kw)
    prof_t, got = tsc.scenario_params(cfg_t, name, n_slots=7, device="cpu", **kw)
    assert dataclasses.asdict(prof_t) == dataclasses.asdict(prof_r)
    assert got._fields == want._fields
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def _slot(seed, n_prb=24):
    cfg_t, cfg_r = tnr.SlotConfig(n_prb=n_prb), rnr.SlotConfig(n_prb=n_prb)
    rng = np.random.default_rng(seed)
    shape = (cfg_t.n_ant, cfg_t.n_sc, cfg_t.n_sym)
    rx = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    return cfg_t, cfg_r, rx, tdmrs.dmrs_sequence_np(cfg_t)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_mmse_estimate(use_kernel):
    cfg_t, cfg_r, rx, pilots = _slot(0)
    w_r, w_t = rest.WienerInterpolator.build(cfg_r), test_.WienerInterpolator.build(cfg_t, device="cpu")
    np.testing.assert_array_equal(w_t.w.numpy(), np.asarray(w_r.w))
    want = np.asarray(rest.mmse_estimate(cfg_r, jnp.asarray(rx), jnp.asarray(pilots), w_r,
                                         use_kernel=use_kernel))
    build.reset_launch_counts()
    got = test_.mmse_estimate(cfg_t, torch.as_tensor(rx), torch.as_tensor(pilots), w_t,
                              use_kernel=use_kernel)
    assert build.launch_counts["mmse_interp"] == 0  # a CPU tensor takes the plain version
    assert got.dtype is torch.complex64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **MMSE_TOL)


def test_mmse_estimate_batched_is_per_ue():
    """A leading UE axis gives each UE's single-slot estimate, bitwise."""
    cfg_t, _, rx0, pilots = _slot(1)
    rx1 = _slot(2)[2]
    w = test_.WienerInterpolator.build(cfg_t, device="cpu")
    p = torch.as_tensor(pilots)
    both = test_.mmse_estimate(cfg_t, torch.as_tensor(np.stack([rx0, rx1])), p, w)
    for u, rx in enumerate((rx0, rx1)):
        assert torch.equal(both[u], test_.mmse_estimate(cfg_t, torch.as_tensor(rx), p, w))


def test_effective_noise_var():
    sinr = np.concatenate([np.random.default_rng(3).exponential(10.0, 64),
                           [0.0, 1e-12, 1e-9, 3.0]]).astype(np.float32)
    want = np.asarray(req.effective_noise_var(jnp.asarray(sinr)))
    got = teq.effective_noise_var(torch.as_tensor(sinr)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prb_per_subband", [2, 4])
def test_mmse_irc_equalize(prb_per_subband):
    cfg_t, cfg_r, rx, pilots = _slot(4)
    rng = np.random.default_rng(5)
    shape = (cfg_t.n_ant, 1, cfg_t.n_sc, cfg_t.n_dmrs_sym)
    h = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    x_r, s_r = req.mmse_irc_equalize(cfg_r, jnp.asarray(rx), jnp.asarray(h),
                                     jnp.asarray(pilots), jnp.float32(0.1),
                                     prb_per_subband=prb_per_subband)
    x_t, s_t = teq.mmse_irc_equalize(cfg_t, torch.as_tensor(rx), torch.as_tensor(h),
                                     torch.as_tensor(pilots), 0.1,
                                     prb_per_subband=prb_per_subband)
    assert x_t.dtype is torch.complex64 and s_t.dtype is torch.float32
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_r), rtol=0, atol=IRC_X_ATOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), rtol=IRC_SINR_RTOL)


def test_broadcast_params_to_ues():
    cfg_t, cfg_r = tnr.SlotConfig(n_prb=6), rnr.SlotConfig(n_prb=6)
    sched_r, sched_t = rsc.make_schedule("good_poor_good", poor_start=1, poor_end=3), \
        tsc.make_schedule("good_poor_good", poor_start=1, poor_end=3)
    _, p_r = rch.channel_params_schedule(cfg_r, sched_r, 5)
    _, p_t = tch.channel_params_schedule(cfg_t, sched_t, 5)
    want, got = rch.broadcast_params_to_ues(p_r, 3), tch.broadcast_params_to_ues(p_t, 3)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert tch.broadcast_params_to_ues(got, 3) is got  # per-UE params pass through


def test_candidate_kpm_sets_and_physical_trajectory():
    for name in ("AERIAL_CANDIDATE_KPMS", "AERIAL_CUMULATIVE_KPMS", "OAI_CANDIDATE_KPMS",
                 "ALL_CANDIDATE_KPMS", "SELECTED_KPMS", "EXECUTION_COST_KPMS"):
        assert getattr(ttel, name) == getattr(rtel, name), name
    traj = {k: np.zeros(2) for k in ttel.ALL_CANDIDATE_KPMS + ttel.EXECUTION_COST_KPMS}
    assert ttel.physical_trajectory(traj).keys() == rtel.physical_trajectory(traj).keys()


def test_kpm_vector():
    rng = np.random.default_rng(6)
    names = ttel.SELECTED_KPMS
    kpms = {n: float(v) for n, v in zip(names, rng.normal(size=len(names)) * 1e6)}
    kpms["snr"] = np.float32(3.25)
    want = np.asarray(rtel.kpm_vector(kpms, names))
    got = ttel.kpm_vector(kpms, names)
    assert got.dtype is torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    as_t = ttel.kpm_vector({n: torch.tensor(v) for n, v in kpms.items()}, names)
    np.testing.assert_array_equal(as_t.numpy(), want)


@pytest.mark.parametrize("n_push", [0, 2, 7])
def test_ring_matrix(n_push):
    cap, n_kpms, n_ues = 4, 3, 2
    vecs = np.random.default_rng(n_push).normal(size=(n_push, n_ues, n_kpms)).astype(np.float32)
    ring = ttel.ring_init(n_ues, cap, n_kpms, "cpu")
    for v in vecs:
        ring = ttel.ring_push(ring, torch.as_tensor(v))
    buf, valid = ttel.ring_matrix(ring)
    for u in range(n_ues):
        r = rtel.ring_init(cap, n_kpms)
        for v in vecs:
            r = rtel.ring_push(r, jnp.asarray(v[u]))
        want_buf, want_valid = rtel.ring_matrix(r)
        np.testing.assert_array_equal(buf[u].numpy(), np.asarray(want_buf))
        np.testing.assert_array_equal(valid[u].numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("case", ["random", "all_ai", "all_mmse", "empty"])
def test_classification_metrics(case):
    rng = np.random.default_rng(7)
    y_true, y_pred = {
        "random": (rng.integers(0, 2, 50), rng.integers(0, 2, 50)),
        "all_ai": (np.zeros(9, int), np.zeros(9, int)),
        "all_mmse": (np.ones(9, int), rng.integers(0, 2, 9)),
        "empty": (np.zeros(0, int), np.zeros(0, int)),
    }[case]
    assert tpolicy.classification_metrics(y_true, y_pred) == \
        rpolicy.classification_metrics(y_true, y_pred)


def _tree():
    return tpolicy.DecisionTreePolicy(
        tpolicy.FittedTree(feature=np.array([0], np.int32),
                           threshold=np.array([0.5], np.float32),
                           leaf_values=np.array([0.0, 1.0], np.float32), depth=1,
                           n_features=1, importances=np.zeros(1, np.float32)), ["sinr"])


#: every tensor builder the package ``__init__``s export, called without
#: ``device``; each takes the card by default, as ``repro`` builds on its
#: default device
DEFAULT_DEVICE_BUILDERS = {
    "scenario_params": lambda: repro_torch.phy.scenario_params(
        tnr.SlotConfig(n_prb=6), "good", n_slots=2),
    "WienerInterpolator.build": lambda: repro_torch.phy.WienerInterpolator.build(
        tnr.SlotConfig(n_prb=6)),
    "per_ue_policy": lambda: repro_torch.core.per_ue_policy(
        [_tree().to_device("cpu")], [0, 0]),
    "export_tree_tables": lambda: repro_torch.core.export_tree_tables([0], [0.5], [0.0, 1.0]),
    "init_device_switch": lambda: repro_torch.core.init_device_switch(
        2, 1, repro_torch.core.SwitchConfig(feature_names=("sinr",))),
    "ring_init": lambda: repro_torch.core.ring_init(2, 4, 3),
    "DecisionTreePolicy.to_device": lambda: _tree().to_device(),
    "ThresholdPolicy.to_device": lambda: repro_torch.core.ThresholdPolicy(
        feature_idx=0, threshold=1.0).to_device(),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_BUILDERS))
def test_builders_default_to_the_card(name, monkeypatch):
    """Without ``device`` each builder asks for CUDA: where there is none it
    raises ``resolve_device``'s error, which names ``device='cpu'``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        DEFAULT_DEVICE_BUILDERS[name]()
