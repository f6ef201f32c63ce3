"""The fault ladder, streaming and the fused GATED kernel's global-weight
variant on the card.

Marked ``cuda``: each skips where there is no NVIDIA GPU, because a CUDA
kernel has no CPU mode.  This file imports no JAX, so it runs on the card's
machine as it is:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_faults.py``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.phy.nr import SlotConfig

#: fused kernel vs plain version and vs float64, as in test_torch_cuda_kernels
GATED_F32_TOL = dict(rtol=1e-4, atol=1e-5)
GATED_BF16_TOL = dict(rtol=2e-3, atol=2e-3)
GATED_EXACT_RATIO = 4.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _state_leaves(state):
    return (*state.rings, *state[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("hyst,period,ttl", [(1, 1, 3), (2, 2, 5)])
def test_cuda_policy_step_armed_vs_plain(cuda, hyst, period, ttl):
    """Every mask, the TTL decay, the breaker and detached lanes armed over 200
    slots of random masks and trips: the one launch a slot is bitwise its
    plain version (``switch_update`` -> ``switch_boundary`` ->
    ``breaker_update`` -> freeze) on every state leaf, the raw decisions and
    the register, and leaves its input state as it was."""
    from repro_torch.core import closed_loop as tcl
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.telemetry import SELECTED_KPMS
    from repro_torch.kernels.tree_infer import policy_step, policy_step_ref

    rng = np.random.default_rng(10 * hyst + ttl)
    n_ues, n_feat, n_slots = 32, len(SELECTED_KPMS), 200
    faults = FaultSpec(breaker_trips=2, breaker_window=4, breaker_cooldown=3)
    pol = tcl.export_tree_tables([5, 1, 3], [0.1, -0.2, 0.3], [1.0, 0.0, 0.0, 1.0], device=cuda)
    cfg = tcl.SwitchConfig(feature_names=SELECTED_KPMS, window_slots=8,
                           hysteresis_slots=hyst, period_slots=period, ttl_slots=ttl)
    shift = np.where((np.arange(n_slots) // 7) % 2 == 0, -1.0, 1.0)[:, None, None]
    feats = torch.as_tensor(
        (shift + rng.normal(size=(n_slots, n_ues, n_feat))).astype(np.float32), device=cuda)

    def mask(p):
        return torch.as_tensor(rng.random((n_slots, n_ues)) < p, device=cuda)

    dv, tv, trip, act = mask(0.8), mask(0.8), mask(0.3), mask(0.9)
    state = ref = tcl.init_device_switch(n_ues, n_feat, cfg, cuda, faults=faults)
    seen = {"quarantine": 0, "stale": 0, "frozen": 0}
    for s in range(n_slots):
        kw = dict(decide=s % period == 0, decision_valid=dv[s], telemetry_valid=tv[s],
                  trip=trip[s], active=act[s], slot_idx=s, faults=faults,
                  return_register=True)
        old = [t.clone() for t in _state_leaves(state)]
        before = build.launch_counts["tree_infer"]
        new, raw, reg = policy_step(state, feats[s], pol, cfg, **kw)
        assert build.launch_counts["tree_infer"] == before + 1
        ref, ref_raw, ref_reg = policy_step_ref(ref, feats[s], pol, cfg, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(t, o) for t, o in zip(_state_leaves(state), old))
        assert torch.equal(raw, ref_raw) and torch.equal(reg, ref_reg), s
        for a, b in zip(_state_leaves(new), _state_leaves(ref)):
            assert torch.equal(a, b), s
        seen["quarantine"] += int((new.quarantine > 0).sum())
        seen["stale"] += int((new.decision_age > ttl).sum())
        seen["frozen"] += int((~act[s]).sum())
        state = new
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.cuda
def test_cuda_policy_step_null_masks_is_the_fault_free_step(cuda):
    """With every mask null and the TTL off the launch computes what the
    fault-free step computes: bitwise the plain ``switch_update`` +
    ``switch_boundary``, with the fault leaves copied through."""
    from repro_torch.core import closed_loop as tcl
    from repro_torch.core.telemetry import SELECTED_KPMS
    from repro_torch.kernels.tree_infer import policy_step

    g = torch.Generator(device=cuda).manual_seed(3)
    n_ues, n_feat = 32, len(SELECTED_KPMS)
    pol = tcl.export_tree_tables([5, 1, 3], [0.1, -0.2, 0.3], [1.0, 0.0, 0.0, 1.0], device=cuda)
    cfg = tcl.SwitchConfig(feature_names=SELECTED_KPMS, window_slots=8)
    state = ref = tcl.init_device_switch(n_ues, n_feat, cfg, cuda)
    for s in range(40):
        kpm = torch.randn(n_ues, n_feat, generator=g, device=cuda) + (1.0 if s % 10 < 5 else -1.0)
        state, raw = policy_step(state, kpm, pol, cfg)
        ref, ref_raw = tcl.switch_update(ref, kpm, pol, cfg)
        ref = tcl.switch_boundary(ref)
        torch.cuda.synchronize()
        assert torch.equal(raw, ref_raw)
        for a, b in zip(_state_leaves(state), _state_leaves(ref)):
            assert torch.equal(a, b), s
    assert int(state.n_switches.sum()) > 0
    assert not state.decision_age.any() and not state.quarantine.any()


def _wide_setup(cuda, n_prb, channels, n_ues, compute_dtype, seed):
    """An AI expert of ``channels`` drawn on the card (biases drawn too) and
    random LS and designated inputs."""
    from repro_torch import random as jr
    from repro_torch.phy import ai_estimator as tai

    cfg = SlotConfig(n_prb=n_prb)
    net = tai.AiEstimatorConfig(channels=channels, n_res_blocks=1)
    params = tai.init_params(jr.PRNGKey(seed, cuda), cfg, net)
    gb = torch.Generator(device=cuda).manual_seed(seed)
    for layer in [params] + params["res"]:
        for k in [k for k in layer if k.endswith("_b") or k in ("b1", "b2")]:
            layer[k] = 0.1 * torch.randn(layer[k].shape, generator=gb, device=cuda)
    ai = tai.AiEstimator(params, cfg.n_dmrs_sym, compute_dtype).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)

    def cplx(shape):
        return torch.complex(torch.randn(shape, generator=g, device=cuda),
                             torch.randn(shape, generator=g, device=cuda))

    return (ai, cplx((n_ues, cfg.n_ant, cfg.n_dmrs_sym, cfg.n_pilot_sc)),
            cplx((n_ues, cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym)))


def _pick(mode, capacity):
    is_gated = mode == 0
    pos = torch.cumsum(is_gated.to(torch.int32), 0, dtype=torch.int32) - 1
    src = torch.where(is_gated & (pos < capacity), pos, torch.full_like(pos, -1))
    idx = torch.argsort((~is_gated).to(torch.int32), stable=True)[:capacity]
    return idx.to(torch.int32), src


@pytest.mark.cuda
@pytest.mark.parametrize("n_prb,channels", [(273, 1472), (24, 1472), (106, 1536)])
def test_cuda_gated_expert_past_the_shared_memory_width(cuda, n_prb, channels):
    """Past the width whose stem and head weights fit a block (1,408 float32
    channels at n_prb 273), the wide form's global-weight variant: float32
    within ``GATED_F32_TOL`` of the plain version and within
    ``GATED_EXACT_RATIO`` of its error against a float64 plain version; bf16
    within ``GATED_BF16_TOL`` (at n_prb 24); untouched UEs bitwise."""
    from repro_torch.kernels.gated_expert import gated_expert_apply, gated_expert_apply_ref

    n_ues = 3
    mode = torch.tensor([0, 1, 0], dtype=torch.int32, device=cuda)
    idx, src = _pick(mode, 2)
    dtypes = ((None, GATED_F32_TOL), (torch.bfloat16, GATED_BF16_TOL))
    for cd, tol in dtypes[: 2 if n_prb == 24 else 1]:
        ai, h_ls, des0 = _wide_setup(cuda, n_prb, channels, n_ues, cd, seed=channels + n_prb)
        before = build.launch_counts["gated_expert"]
        got = gated_expert_apply(idx, src, h_ls, des0, ai, compute_dtype=cd)
        torch.cuda.synchronize()
        assert build.launch_counts["gated_expert"] == before + 1
        want = gated_expert_apply_ref(idx, src, h_ls, des0, ai, compute_dtype=cd)
        assert torch.equal(got[1], des0[1])
        torch.testing.assert_close(got, want, **tol)
        if cd is None:
            exact = gated_expert_apply_ref(idx, src, h_ls.to(torch.complex128),
                                           des0.to(torch.complex128),
                                           copy.deepcopy(ai).to(torch.float64))
            e_kernel, e_plain = ((x - exact).abs().max().item() for x in (got, want))
            assert e_kernel <= GATED_EXACT_RATIO * e_plain, (e_kernel, e_plain)
        del ai, h_ls, des0, got, want
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n_prb,channels", [(24, 96), (273, 128)])
def test_cuda_gated_expert_global_weights_equal_staged(cuda, n_prb, channels, bf16):
    """Where both fit, the global-weight variant gives the staged wide form's
    bits: every output is summed in the same order."""
    from repro_torch.kernels.gated_expert.ops import _launch

    cd = torch.bfloat16 if bf16 else None
    ai, h_ls, des0 = _wide_setup(cuda, n_prb, channels, 4, cd, seed=channels)
    idx, src = _pick(torch.tensor([0, 0, 1, 0], dtype=torch.int32, device=cuda), 3)
    staged = _launch(idx, src, h_ls, des0, ai, cd, global_weights=False)
    direct = _launch(idx, src, h_ls, des0, ai, cd, global_weights=True)
    torch.cuda.synchronize()
    assert torch.equal(staged, direct)


def _churn_session(cuda, path="closed_loop", **kw):
    from repro_torch.convert import tree_policy_from_reference
    from repro_torch.core.session import ArchesSession, CampaignSpec, PolicySpec
    from repro_torch.core.streaming import ChurnSchedule
    from repro_torch.core.telemetry import SELECTED_KPMS

    churn = ChurnSchedule(n_ue_ids=6, segment_slots=4, initial=(0, 1, 2, 3),
                          events=((4, 4, "attach"), (5, 1, "detach"), (8, 1, "attach"),
                                  (8, 2, "detach")))
    spec = CampaignSpec(path=path, scenario="churn_cell", n_ues=5, n_slots=12, n_prb=24,
                        seed=4, churn=churn, modes=0, policies=(PolicySpec(kind="tree"),),
                        **kw)
    tree = tree_policy_from_reference([5, 1, 3], [14.0, 9.0, 18.0], [1.0, 0.0, 0.0, 1.0],
                                      SELECTED_KPMS)
    return ArchesSession(spec, device=cuda, host_policies=(tree,))


@pytest.mark.cuda
@pytest.mark.parametrize("bank", ["concurrent", "fused"])
def test_cuda_streaming_pipelined_equals_serial(cuda, tmp_path, bank):
    """A closed-loop churn campaign under faults on the card: the pipelined
    executor (CUDA-stream copies) equals the serial one bitwise on every
    leaf, a run killed after two segments and resumed from its delta chain
    equals the uninterrupted one, the device loop equals its host replay,
    and the decision phase is one ``tree_infer`` launch a slot."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.session import ExpertBankSpec

    torch.use_deterministic_algorithms(True)
    kw = dict(faults=FaultSpec(seed=2, corruption_spans=((2, 6),), decision_outages=((7, 9),),
                               telemetry_drop_prob=0.1, breaker_trips=2, breaker_window=4,
                               breaker_cooldown=3))
    if bank == "fused":
        kw["bank"] = ExpertBankSpec(execution_mode="gated", fused=True, gated_capacity=3)
    sess = _churn_session(cuda, **kw)
    build.reset_launch_counts()
    serial = sess.run_streaming(pipeline=False)
    assert build.launch_counts["tree_infer"] == sess.spec.n_slots
    piped = sess.run_streaming()
    d = str(tmp_path / "ck")
    sess.run_streaming(checkpoint_dir=d, max_segments=2)
    resumed = sess.run_streaming(resume_from=d)
    for other in (piped, resumed):
        np.testing.assert_array_equal(other.modes, serial.modes)
        np.testing.assert_array_equal(other.decisions, serial.decisions)
        np.testing.assert_array_equal(other.n_switches, serial.n_switches)
        for k in serial.kpms:
            np.testing.assert_array_equal(other.kpms[k], serial.kpms[k], err_msg=k)
        for k in serial.outputs:
            np.testing.assert_array_equal(other.outputs[k], serial.outputs[k], err_msg=k)
    replay = sess.host_replay(serial)
    np.testing.assert_array_equal(serial.modes, replay["active_mode"])
    assert serial.health_tripped_slot_ues > 0


@pytest.mark.cuda
def test_cuda_zero_fault_spec_and_zero_churn_are_identities(cuda):
    """``FaultSpec()`` is bitwise ``faults=None``, and a full-residency
    streaming run bitwise the monolithic run, on the card."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.session import ArchesSession, as_streaming_spec

    torch.use_deterministic_algorithms(True)
    sess = _churn_session(cuda)
    base = dataclasses.replace(sess.spec, churn=None, n_ues=6)
    runs = [ArchesSession(spec, device=cuda, host_policies=sess.host_policies).run()
            for spec in (base, dataclasses.replace(base, faults=FaultSpec()),
                         as_streaming_spec(base, max_segment_slots=4))]
    for other in runs[1:]:
        np.testing.assert_array_equal(other.modes, runs[0].modes)
        for k in runs[0].kpms:
            np.testing.assert_array_equal(other.kpms[k], runs[0].kpms[k], err_msg=k)
        for k in runs[0].outputs:
            np.testing.assert_array_equal(other.outputs[k], runs[0].outputs[k], err_msg=k)
