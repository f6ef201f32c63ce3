"""The hand-written kernels against their plain versions on the card, and small
CONCURRENT and GATED campaigns through them.

Marked ``cuda``: each skips where there is no NVIDIA GPU, because a CUDA
kernel has no CPU mode.  This file imports no JAX, so it runs on the card's
machine as it is: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.mmse_interp import mmse_interp, mmse_interp_ref
from repro_torch.kernels.switch_select import switch_select, switch_select_batched_ref
from repro_torch.kernels.tree_infer import tree_infer, tree_infer_ref
from repro_torch.phy.estimators import WienerInterpolator
from repro_torch.phy.nr import SlotConfig

#: kernel vs plain Gauss-form product: Np float32 products per output summed
#: in another order, on unit-variance inputs whose outputs are O(10)
MMSE_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _random_tree(rng, depth, n_feat):
    n_nodes = 2**depth - 1
    feature = rng.integers(0, n_feat, size=n_nodes).astype(np.int32)
    threshold = rng.normal(size=n_nodes).astype(np.float32)
    threshold[rng.random(n_nodes) < 0.3] = np.inf
    leaves = rng.integers(0, 3, size=2**depth).astype(np.float32)
    return feature, threshold, leaves


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 12, 384, 2016])
@pytest.mark.parametrize("n_prb", [4, 24, 106, 273])
def test_cuda_mmse_interp_vs_plain(cuda, n_prb, batch):
    """Ragged in every dimension (rows against the 16- and 64-row tiles,
    pilots against the 16-pilot k-tile, subcarriers against the 32-wide
    block), up to NR's widest 30 kHz carrier; two calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(n_prb)
    w = WienerInterpolator.build(SlotConfig(n_prb=n_prb), device=cuda).w
    h = torch.complex(torch.randn(batch, w.shape[0], generator=g, device=cuda),
                      torch.randn(batch, w.shape[0], generator=g, device=cuda))
    before = build.launch_counts["mmse_interp_gauss"]
    got = mmse_interp(h, w)
    torch.cuda.synchronize()
    assert build.launch_counts["mmse_interp_gauss"] == before + 1
    torch.testing.assert_close(got, mmse_interp_ref(h, w), rtol=0, atol=MMSE_ATOL)
    assert torch.equal(mmse_interp(h, w), got)


@pytest.mark.cuda
def test_cuda_mmse_interp_rows_do_not_depend_on_the_batch(cuda):
    """One UE's 12 rows give the same bits alone (16-row tile) and at the head
    of 384 rows (64-row tiles): every output is summed in one order."""
    g = torch.Generator(device=cuda).manual_seed(5)
    w = WienerInterpolator.build(SlotConfig(n_prb=106), device=cuda).w
    h = torch.complex(torch.randn(384, w.shape[0], generator=g, device=cuda),
                      torch.randn(384, w.shape[0], generator=g, device=cuda))
    assert torch.equal(mmse_interp(h[:12], w), mmse_interp(h, w)[:12])


@pytest.mark.cuda
@pytest.mark.parametrize("n_experts", [2, 3])
@pytest.mark.parametrize("shape", [(1, 4, 1, 1272, 3), (32, 4, 1, 1272, 3),
                                   (168, 4, 1, 1272, 3), (5, 3), (7, 1, 1, 13, 3)])
def test_cuda_switch_vs_plain(cuda, shape, n_experts):
    """One launch for every expert, out of place: bitwise the plain version,
    and no expert output is written (the designated one stays unswitched, as
    in the reference).  (5, 3) and (7, 1, 1, 13, 3) complex payloads are not
    whole float4 vectors a UE: the scalar path."""
    g = torch.Generator(device=cuda).manual_seed(1)
    outs = [torch.complex(torch.randn(shape, generator=g, device=cuda),
                          torch.randn(shape, generator=g, device=cuda))
            for _ in range(n_experts)]
    kept = [o.clone() for o in outs]
    n_ues = shape[0]
    for modes in (torch.arange(n_ues, device=cuda) % n_experts,
                  torch.zeros(n_ues, device=cuda), torch.full((n_ues,), n_experts - 1,
                                                              device=cuda)):
        modes = modes.to(torch.int32)
        want = switch_select_batched_ref(modes, outs)
        before = build.launch_counts["switch_select_batched"]
        got = switch_select(modes, outs)
        torch.cuda.synchronize()
        assert build.launch_counts["switch_select_batched"] == before + 1
        assert all(got.data_ptr() != o.data_ptr() for o in outs)
        assert torch.equal(got, want)
        assert all(torch.equal(o, k) for o, k in zip(outs, kept))
    # a mode that names no expert keeps the designated slice
    bad = torch.full((n_ues,), n_experts, dtype=torch.int32, device=cuda)
    bad[::2] = -1
    assert torch.equal(switch_select(bad, outs), outs[0])


@pytest.mark.cuda
def test_cuda_switch_checks_every_call(cuda):
    """The per-UE switch validates a signature once, but each call's tensors
    still have to match it: a mismatch raises before any launch."""
    outs = [torch.zeros(4, 6, dtype=torch.complex64, device=cuda) for _ in range(2)]
    modes = torch.zeros(4, dtype=torch.int32, device=cuda)
    switch_select(modes, outs)
    before = build.launch_counts["switch_select_batched"]
    with pytest.raises(ValueError):  # a non-contiguous alternative
        switch_select(modes, [outs[0], torch.zeros(6, 4, dtype=torch.complex64,
                                                   device=cuda).t()])
    with pytest.raises(ValueError):  # another shape
        switch_select(modes, [outs[0], outs[1][:, :3].contiguous()])
    with pytest.raises(TypeError):  # a lazily conjugated alternative
        switch_select(modes, [outs[0], outs[1].conj()])
    with pytest.raises(TypeError):  # int64 modes
        switch_select(modes.long(), outs)
    with pytest.raises(ValueError):  # more experts than the kernel's table
        switch_select(modes, outs * 5)
    assert build.launch_counts["switch_select_batched"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_bank_outputs_stay_unswitched(cuda, fused):
    """On the card a batched CONCURRENT call's ``all_outputs[0]`` is the AI
    estimate computed alone, and a GATED bank's ``baseline`` (no audit) is the
    MMSE estimate computed alone; neither shares storage with ``selected``."""
    from repro_torch import random as jr
    from repro_torch.core.expert_bank import ExecutionMode
    from repro_torch.phy import ai_estimator as tai
    from repro_torch.phy.pipeline import BatchedPuschPipeline

    torch.use_deterministic_algorithms(True)
    cfg = SlotConfig(n_prb=24)
    net = tai.AiEstimatorConfig(channels=8, n_res_blocks=1)
    params = tai.init_params(jr.PRNGKey(0), cfg, net)
    g = torch.Generator(device=cuda).manual_seed(2)
    h_ls = _cplx(g, (6, cfg.n_ant, cfg.n_dmrs_sym, cfg.n_pilot_sc), cuda)
    mode = torch.tensor([0, 1, 0, 0, 1, 0], dtype=torch.int32, device=cuda)
    conc = BatchedPuschPipeline(cfg, params, net=net, device=cuda)
    out = conc.bank(mode, h_ls)
    # the AI expert computed alone, by the bank's own route on the card
    # (one gated_expert launch with every UE selected)
    assert torch.equal(out.all_outputs[0], conc.bank.experts[0].fn(None, h_ls))
    assert out.all_outputs[0].data_ptr() != out.selected.data_ptr()
    assert out.baseline.data_ptr() != out.selected.data_ptr()
    gated = BatchedPuschPipeline(cfg, params, net=net, execution_mode=ExecutionMode.GATED,
                                 gated_capacity=3, fused_gated=fused, device=cuda)
    out = gated.bank(mode, h_ls)
    assert torch.equal(out.baseline, gated._mmse_from_ls_batched(h_ls))
    assert out.baseline.data_ptr() != out.selected.data_ptr()
    ai_ues = torch.nonzero(mode == 0).flatten()[:3]
    assert not torch.equal(out.selected[ai_ues], out.baseline[ai_ues])


@pytest.mark.cuda
@pytest.mark.parametrize("hyst,period,depth", [(1, 1, 2), (3, 2, 3), (2, 3, 5)])
def test_cuda_policy_step_vs_plain(cuda, hyst, period, depth):
    """The fused decision phase against ``switch_update`` then
    ``switch_boundary`` on the card, slot by slot over 200 slots (hold slots
    included): ring, window, register, streak, modes and switch counts
    bitwise, one launch a slot, and the input state left as it was."""
    from repro_torch.core import closed_loop as tcl
    from repro_torch.core.telemetry import SELECTED_KPMS, ring_window_mean
    from repro_torch.kernels.tree_infer import policy_step, policy_step_ref

    rng = np.random.default_rng(depth)
    n_ues, n_feat, window = 32, len(SELECTED_KPMS), 8
    feature, threshold, leaves = _random_tree(rng, depth, n_feat)
    leaves = leaves % 2
    pol = tcl.export_tree_tables(feature, threshold * 0.3, leaves, device=cuda)
    cfg = tcl.SwitchConfig(feature_names=SELECTED_KPMS, window_slots=window,
                           hysteresis_slots=hyst, period_slots=period)
    shift = np.where((np.arange(200) // 7) % 2 == 0, -1.0, 1.0)[:, None, None]
    feats = torch.as_tensor((shift + rng.normal(size=(200, n_ues, n_feat))).astype(np.float32),
                            device=cuda)
    feats[5, 3, 2] = float("inf")  # a non-finite KPM travels through the window alike
    state = ref = tcl.init_device_switch(n_ues, n_feat, cfg, cuda)
    flips = 0
    for s in range(200):
        decide = s % period == 0
        old = [t.clone() for t in (*state.rings, *state[1:])]
        before = build.launch_counts["tree_infer"]
        state_next, raw = policy_step(state, feats[s], pol, cfg, decide=decide)
        assert build.launch_counts["tree_infer"] == before + 1
        ref, ref_raw = policy_step_ref(ref, feats[s], pol, cfg, decide=decide)
        torch.cuda.synchronize()
        assert all(torch.equal(t, o) for t, o in zip((*state.rings, *state[1:]), old))
        state = state_next
        assert torch.equal(raw, ref_raw), s
        for a, b in zip((*state.rings, *state[1:]), (*ref.rings, *ref[1:])):
            assert torch.equal(a, b), s
        assert torch.equal(ring_window_mean(state.rings, window),
                           ring_window_mean(ref.rings, window))
        flips += int((state.active_mode != old[3]).sum())
    assert flips > 0


@pytest.mark.cuda
def test_cuda_fused_gated_pipeline_at_64_channels(cuda):
    """A fused GATED pipeline twice the paper's width builds on the card and
    runs two slots through the kernel; so does a fused GATED session at 72
    channels, the kernel's wide form."""
    from repro_torch import random as jr
    from repro_torch.core.expert_bank import ExecutionMode
    from repro_torch.core.session import ArchesSession, CampaignSpec, ExpertBankSpec, PolicySpec
    from repro_torch.phy import ai_estimator as tai
    from repro_torch.phy.pipeline import BatchedPuschPipeline
    from repro_torch.phy.scenario import get_scenario

    torch.use_deterministic_algorithms(True)
    cfg = SlotConfig(n_prb=106)
    net = tai.AiEstimatorConfig(channels=64, n_res_blocks=4)
    pipe = BatchedPuschPipeline(cfg, tai.init_params(jr.PRNGKey(0), cfg, net), net=net,
                                execution_mode=ExecutionMode.GATED, gated_capacity=4,
                                fused_gated=True, device=cuda)
    build.reset_launch_counts()
    modes = np.zeros((2, 8), np.int32)
    modes[:, ::2] = 1
    _, traj = pipe.run(get_scenario("good").schedule(), modes, n_slots=2, n_ues=8)
    assert build.launch_counts["gated_expert"] == 2, build.launch_counts
    for name in ("tb_ok", "executed_flops"):
        assert torch.isfinite(traj[name]).all()
    for v in traj["kpms"]["aerial"].values():
        assert torch.isfinite(v).all()
    spec = CampaignSpec(path="closed_loop", n_ues=2, n_slots=2,
                        policies=(PolicySpec(kind="threshold", threshold=18.0),),
                        bank=ExpertBankSpec(execution_mode="gated", fused=True, channels=72,
                                            gated_capacity=2))
    sess = ArchesSession(spec, device=cuda)
    build.reset_launch_counts()
    hist = sess.run()
    assert build.launch_counts["gated_expert"] == 2, build.launch_counts
    assert hist.modes.shape == (2, 2)
    for v in list(hist.kpms.values()) + list(hist.outputs.values()):
        assert np.isfinite(np.asarray(v, np.float64)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_cuda_tree_vs_plain(cuda, depth):
    rng = np.random.default_rng(depth)
    feature, threshold, leaves = _random_tree(rng, depth, 10)
    x = torch.randn(300, 10, device=cuda)
    args = [torch.as_tensor(a, device=cuda) for a in (feature, threshold, leaves)]
    assert torch.equal(tree_infer(x, *args, depth), tree_infer_ref(x, *args, depth))


@pytest.mark.cuda
def test_cuda_closed_loop_equals_host_replay(cuda):
    """A small closed-loop session on the card: every kernel launches and the
    device loop equals its host replay."""
    from repro_torch.core.session import ArchesSession, CampaignSpec, PolicySpec

    torch.use_deterministic_algorithms(True)
    spec = CampaignSpec(path="closed_loop", scenario="good_poor_good", n_ues=3, n_slots=9,
                        scenario_args=(("poor_start", 3), ("poor_end", 6)),
                        policies=(PolicySpec(kind="tree"),))
    sess = ArchesSession(spec, device=cuda)
    build.reset_launch_counts()
    hist = sess.run()
    for name in ("mmse_interp_gauss", "switch_select_batched", "tree_infer"):
        assert build.launch_counts[name] > 0, build.launch_counts
    np.testing.assert_array_equal(hist.modes, sess.host_replay(hist)["active_mode"])


# -- the GATED slice: the scatter and the fused gated expert -------------------

#: fused kernel vs plain version on the card, float32: the same convolutions
#: summed in another order (direct taps vs cuBLAS's folded GEMMs) through
#: 2R + 3 layers; the same bound as the CPU tests against the reference
GATED_F32_TOL = dict(rtol=1e-4, atol=1e-5)
#: bf16 operands: an activation that differs in its last float32 bit can
#: round to the neighbouring bf16 value and carry (see test_torch_ai_estimator)
GATED_BF16_TOL = dict(rtol=2e-3, atol=2e-3)
#: float32 kernel vs a float64 plain version: at most this multiple of the
#: float32 plain version's error (3xTF32 with one accumulator per tap errs
#: like a float32 conv; one truncating accumulator across taps errs far more)
GATED_EXACT_RATIO = 4.0


def _cplx(g, shape, dev):
    return torch.complex(torch.randn(shape, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev))


def _compaction(mode, capacity):
    """The bank's cumsum partition: ``(idx, src)`` for a mode vector."""
    is_gated = mode == 0
    pos = torch.cumsum(is_gated.to(torch.int32), 0, dtype=torch.int32) - 1
    src = torch.where(is_gated & (pos < capacity), pos, torch.full_like(pos, -1))
    idx = torch.argsort((~is_gated).to(torch.int32), stable=True)[:capacity]
    return idx.to(torch.int32), src


@pytest.mark.cuda
@pytest.mark.parametrize("n_ues,capacity,shape", [
    (32, 16, (4, 1, 1272, 3)), (6, 3, (5, 2)), (1, 1, (7,)), (5, 5, (3, 3))])
def test_cuda_switch_gather_vs_plain(cuda, n_ues, capacity, shape):
    from repro_torch.kernels.switch_select import switch_gather_batched_ref, switch_scatter

    g = torch.Generator(device=cuda).manual_seed(n_ues)
    des0 = _cplx(g, (n_ues,) + shape, cuda)
    compact = _cplx(g, (capacity,) + shape, cuda)
    some = (torch.arange(n_ues, device=cuda) % 3 != 1).to(torch.int32) - 1  # 0 or -1
    for picked in (some, -torch.ones(n_ues, dtype=torch.int32, device=cuda),
                   torch.zeros(n_ues, dtype=torch.int32, device=cuda)):
        mode = (picked < 0).to(torch.int32)
        _, src = _compaction(mode, capacity)
        want = switch_gather_batched_ref(src, compact, des0)
        des, comp = des0.clone(), compact.clone()
        for _ in range(2):  # the second call finds its signature validated
            before = build.launch_counts["switch_gather_batched"]
            got = switch_scatter(src, compact, des)
            torch.cuda.synchronize()
            assert build.launch_counts["switch_gather_batched"] == before + 1
            assert got.data_ptr() != des.data_ptr()  # out of place: the inputs stay
            assert torch.equal(got, want)
            assert torch.equal(des, des0) and torch.equal(compact, comp)


@pytest.mark.cuda
def test_cuda_scatter_checks_every_call(cuda):
    """The scatter validates a signature once, but each call's tensors still
    have to match it: a wrong dtype, a non-contiguous tensor, a tensor on
    another device or a lazy conjugate raises before any launch."""
    from repro_torch.kernels.switch_select import switch_scatter

    src = torch.tensor([0, -1, 1, -1], dtype=torch.int32, device=cuda)
    des = torch.zeros(4, 6, dtype=torch.complex64, device=cuda)
    compact = torch.ones(2, 6, dtype=torch.complex64, device=cuda)
    switch_scatter(src, compact, des)
    before = build.launch_counts["switch_gather_batched"]
    with pytest.raises(TypeError):  # int64 src
        switch_scatter(src.long(), compact, des)
    with pytest.raises(ValueError):  # compact in another dtype
        switch_scatter(src, compact.to(torch.complex128), des)
    with pytest.raises(ValueError):  # a non-contiguous compact
        switch_scatter(src, torch.ones(6, 2, dtype=torch.complex64, device=cuda).t(), des)
    with pytest.raises(ValueError):  # src on the host
        switch_scatter(src.cpu(), compact, des)
    with pytest.raises(TypeError):  # a lazily conjugated compact
        switch_scatter(src, compact.conj(), des)
    assert build.launch_counts["switch_gather_batched"] == before


def _gated_setup(cuda, n_prb, channels, n_res, n_ues, compute_dtype, seed=0, biases=False):
    """An AI expert on the card and random LS and designated inputs; with
    ``biases`` every bias of the expert is drawn too (``init_params`` zeroes
    them), so a bias read from a wrong column shows."""
    from repro_torch import random as jr
    from repro_torch.phy import ai_estimator as tai

    cfg = SlotConfig(n_prb=n_prb)
    net = tai.AiEstimatorConfig(channels=channels, n_res_blocks=n_res)
    params = tai.init_params(jr.PRNGKey(seed), cfg, net)
    if biases:
        gb = torch.Generator().manual_seed(seed)
        for layer in [params] + params["res"]:
            for k in [k for k in layer if k.endswith("_b") or k in ("b1", "b2")]:
                layer[k] = 0.1 * torch.randn(layer[k].shape, generator=gb)
    ai = tai.AiEstimator(params, cfg.n_dmrs_sym, compute_dtype).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    h_ls = _cplx(g, (n_ues, cfg.n_ant, cfg.n_dmrs_sym, cfg.n_pilot_sc), cuda)
    des = _cplx(g, (n_ues, cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym), cuda)
    return ai, h_ls, des


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("capacity", [1, 16, 32])
@pytest.mark.parametrize("n_prb", [4, 24, 106, 273])
@pytest.mark.parametrize("channels,n_res", [(32, 4), (8, 1), (40, 1), (48, 2), (64, 4)])
def test_cuda_gated_expert_vs_plain(cuda, bf16, n_prb, channels, n_res, capacity):
    """From NR's narrowest carrier to its widest at 30 kHz (one to eight blocks a
    cluster), at the paper's width, a narrow one (channels padded to 16) and the
    wide ones (40 and 48 padded to 48, and 64), K = 1 (UEs overflow), 16 and 32
    (padding rows); two calls give the same bits, and the designated input is
    left as it was (the result is a new tensor).  In float32 the kernel errs
    against a float64 plain version at most ``GATED_EXACT_RATIO`` times as much
    as the float32 plain version does."""
    import copy

    from repro_torch.kernels.gated_expert import gated_expert_apply, gated_expert_apply_ref

    n_ues = 32
    cd = torch.bfloat16 if bf16 else None
    ai, h_ls, des0 = _gated_setup(cuda, n_prb, channels, n_res, n_ues, cd)
    mode = (torch.arange(n_ues, device=cuda) % 3 != 1).to(torch.int32)  # 1 of 3 selects AI
    idx, src = _compaction(mode, capacity)
    n_sel = int((src >= 0).sum())
    assert n_sel == min(capacity, 11)  # K = 16 and 32 have padding rows, K = 1 overflows
    want = gated_expert_apply_ref(idx, src, h_ls, des0, ai, compute_dtype=cd)
    des = des0.clone()
    before = build.launch_counts["gated_expert"]
    got = gated_expert_apply(idx, src, h_ls, des, ai, compute_dtype=cd)
    torch.cuda.synchronize()
    assert build.launch_counts["gated_expert"] == before + 1
    assert got.data_ptr() != des.data_ptr() and torch.equal(des, des0)
    kept = src < 0  # padding rows' UEs and unselected UEs: bitwise untouched
    assert torch.equal(got[kept], des0[kept])
    torch.testing.assert_close(got, want, **(GATED_BF16_TOL if bf16 else GATED_F32_TOL))
    again = gated_expert_apply(idx, src, h_ls, des0.clone(), ai, compute_dtype=cd)
    assert torch.equal(again, got)
    if not bf16:
        exact = gated_expert_apply_ref(idx, src, h_ls.to(torch.complex128),
                                       des0.to(torch.complex128),
                                       copy.deepcopy(ai).to(torch.float64))
        e_kernel, e_plain = ((x - exact).abs().max().item() for x in (got, want))
        assert e_kernel <= GATED_EXACT_RATIO * e_plain, (e_kernel, e_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n_prb", [24, 106, 273])
@pytest.mark.parametrize("channels,n_res", [(72, 1), (96, 2), (128, 4)])
def test_cuda_gated_expert_past_64_channels(cuda, channels, n_res, n_prb):
    """Past 64 channels the kernel's wide form (channels in chunks of 32, 72
    padded to 96), with every bias drawn: at K = 1 (one UE selected), 16 (12
    selected, padding rows) and 32 (all selected) within
    ``GATED_F32_TOL`` / ``GATED_BF16_TOL`` of the plain version, the untouched
    UEs bitwise and the designated input left as it was; in float32 its error
    against a float64 plain version at most ``GATED_EXACT_RATIO`` times the
    plain version's; and one UE's estimate the same bits at K = 1, 16 and 32."""
    import copy

    from repro_torch.kernels.gated_expert import gated_expert_apply, gated_expert_apply_ref

    n_ues, ue = 32, 9
    alone = torch.ones(n_ues, dtype=torch.int32, device=cuda)  # only UE ``ue`` selects AI
    alone[ue] = 0
    some = (torch.arange(n_ues, device=cuda) % 3 != 1).to(torch.int32)  # 1 of 3, and ``ue``
    some[ue] = 0
    cases = ((alone, 1), (some, 16), (torch.zeros_like(some), 32))
    for cd, tol in ((None, GATED_F32_TOL), (torch.bfloat16, GATED_BF16_TOL)):
        ai, h_ls, des0 = _gated_setup(cuda, n_prb, channels, n_res, n_ues, cd, seed=channels,
                                      biases=True)
        ai64 = copy.deepcopy(ai).to(torch.float64) if cd is None else None
        outs = []
        for mode, capacity in cases:
            idx, src = _compaction(mode, capacity)
            assert int(src[ue]) >= 0
            want = gated_expert_apply_ref(idx, src, h_ls, des0, ai, compute_dtype=cd)
            des = des0.clone()
            before = build.launch_counts["gated_expert"]
            got = gated_expert_apply(idx, src, h_ls, des, ai, compute_dtype=cd)
            torch.cuda.synchronize()
            assert build.launch_counts["gated_expert"] == before + 1
            assert torch.equal(des, des0)
            kept = src < 0
            assert torch.equal(got[kept], des0[kept])
            torch.testing.assert_close(got, want, **tol)
            if ai64 is not None:
                exact = gated_expert_apply_ref(idx, src, h_ls.to(torch.complex128),
                                               des0.to(torch.complex128), ai64)
                e_kernel, e_plain = ((x - exact).abs().max().item() for x in (got, want))
                assert e_kernel <= GATED_EXACT_RATIO * e_plain, (e_kernel, e_plain)
            outs.append(got[ue])
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [32, 64])
@pytest.mark.parametrize("n_prb", [24, 106, 273])
def test_cuda_gated_expert_batch_composition_bitwise(cuda, n_prb, channels):
    """One UE's estimate is the same bits at K = 1, at K = 16 and at another
    row of ``idx``: every row runs the same code in the same order.  At these
    widths the UE's subcarriers span two, eight and eight blocks of a cluster
    (72, 80 and 205 pilots a block), so the halos between blocks are in it."""
    from repro_torch.kernels.gated_expert import gated_expert_apply
    from repro_torch.kernels.gated_expert.ops import cluster_size

    ai, h_ls, des0 = _gated_setup(cuda, n_prb, channels, 4, 32, None, seed=3)
    assert cluster_size(h_ls.shape[-1]) > 1
    ue = 9
    alone = torch.ones(32, dtype=torch.int32, device=cuda)
    alone[ue] = 0
    many = (torch.arange(32, device=cuda) % 2 == 1).to(torch.int32)
    many[ue] = 0
    outs = []
    for mode, capacity in ((alone, 1), (many, 16), (torch.zeros_like(many), 32)):
        idx, src = _compaction(mode, capacity)
        outs.append(gated_expert_apply(idx, src, h_ls, des0.clone(), ai)[ue])
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_gated_closed_loop_equals_host_replay(cuda, fused):
    """A small GATED closed loop on the card: its kernels launch, the device
    loop equals its host replay, and the cost leaf matches the served share."""
    from repro_torch.core.session import (
        ArchesSession,
        CampaignSpec,
        ExpertBankSpec,
        PolicySpec,
    )

    torch.use_deterministic_algorithms(True)
    spec = CampaignSpec(path="closed_loop", scenario="good_poor_good", n_ues=3, n_slots=9,
                        scenario_args=(("poor_start", 3), ("poor_end", 6)),
                        bank=ExpertBankSpec(execution_mode="gated", gated_capacity=2,
                                            fused=fused),
                        policies=(PolicySpec(kind="tree"),))
    sess = ArchesSession(spec, device=cuda)
    sess.host_policies  # profile on the CONCURRENT engine first
    build.reset_launch_counts()
    hist = sess.run()
    kernel = "gated_expert" if fused else "switch_gather_batched"
    assert build.launch_counts["mmse_interp_gauss"] == 9, build.launch_counts
    assert build.launch_counts["switch_select_batched"] == 0, build.launch_counts
    # the compact sub-batch has a static capacity: one launch every slot
    assert build.launch_counts[kernel] == 9, build.launch_counts
    np.testing.assert_array_equal(hist.modes, sess.host_replay(hist)["active_mode"])
    served = (hist.modes == 0) & (hist.outputs["gated_overflow"] == 0)
    engine = sess.engine
    want = (engine.bank.experts[1].flops + engine.bank.experts[0].flops * served)
    np.testing.assert_allclose(hist.outputs["executed_flops"], want, rtol=1e-6)


# -- the host-loop slice: the scalar switch -------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_experts", [2, 3, 4])
@pytest.mark.parametrize("shape,complex_", [((4, 1, 1272, 3), True), ((1001,), False),
                                            ((3, 5, 7), True), ((2,), False)])
def test_cuda_scalar_switch_vs_plain(cuda, n_experts, shape, complex_):
    """Every mode, by value and from an int32 on the card: bitwise the plain
    version, in place, one launch per alternative; mode 0 leaves the
    designated bytes as they were."""
    from repro_torch.kernels.switch_select import switch_select_ref

    g = torch.Generator(device=cuda).manual_seed(n_experts)
    make = (lambda: _cplx(g, shape, cuda)) if complex_ else (
        lambda: torch.randn(shape, generator=g, device=cuda))
    outs = [make() for _ in range(n_experts)]
    for mode in range(n_experts):
        want = switch_select_ref(mode, outs)
        for m in (mode, torch.tensor(mode, dtype=torch.int32, device=cuda)):
            des = outs[0].clone()
            before = build.launch_counts["switch_select"]
            got = switch_select(m, [des, *outs[1:]])
            torch.cuda.synchronize()
            assert build.launch_counts["switch_select"] == before + n_experts - 1
            assert got.data_ptr() == des.data_ptr()
            assert torch.equal(got, want)
            if mode == 0:
                assert torch.equal(des, outs[0])


@pytest.mark.cuda
def test_cuda_scalar_switch_scalar_tail_and_unaligned(cuda):
    """Payloads that are not a multiple of four floats, and views that start
    off the 16-byte grid, take the scalar path of the copy."""
    base = torch.randn(4 * 1000 + 7, device=cuda)
    alt = torch.randn_like(base)
    for lo, hi in ((0, 4003), (1, 4003), (3, 4006)):  # aligned + tail, unaligned
        des = base.clone()
        got = switch_select(1, [des[lo:hi], alt[lo:hi]])
        torch.cuda.synchronize()
        assert torch.equal(got, alt[lo:hi])
        assert torch.equal(des[:lo], base[:lo]) and torch.equal(des[hi:], base[hi:])


@pytest.mark.cuda
def test_cuda_scalar_switch_out_of_range_device_mode_keeps_buffer(cuda):
    outs = [torch.randn(333, device=cuda) for _ in range(3)]
    for bad in (3, 17, -1):
        des = outs[0].clone()
        got = switch_select(torch.tensor(bad, dtype=torch.int32, device=cuda),
                            [des, *outs[1:]])
        torch.cuda.synchronize()
        assert torch.equal(got, outs[0])
    with pytest.raises(ValueError, match="outside"):
        switch_select(3, [outs[0].clone(), *outs[1:]])


@pytest.mark.cuda
def test_cuda_scalar_switch_lean_path_raises(cuda):
    """The lean launch path keeps every check the kernel needs, with the same
    exception types: a dtype it does not move (complex128, a 1-byte int8),
    a non-contiguous view and mixed devices raise before any launch, and so
    does a tensor with a lazy conjugate or negative bit, whose ``data_ptr()``
    holds the values before it."""
    before = build.launch_counts["switch_select"]
    for dt in (torch.complex128, torch.int8):
        outs = [torch.zeros(4, 6, dtype=dt, device=cuda) for _ in range(2)]
        with pytest.raises(TypeError):
            switch_select(1, outs)
    base = [torch.zeros(4, 6, dtype=torch.complex64, device=cuda) for _ in range(2)]
    with pytest.raises(ValueError):  # a non-contiguous designated buffer
        switch_select(1, [base[0].t(), base[1].t().contiguous()])
    with pytest.raises(ValueError):  # a non-contiguous alternative
        switch_select(1, [base[0][:, :3].contiguous(), base[1][:, ::2]])
    with pytest.raises(ValueError):  # mixed devices
        switch_select(1, [base[0], base[1].cpu()])
    with pytest.raises(ValueError):  # a device mode beside CPU outputs
        switch_select(torch.tensor(1, dtype=torch.int32, device=cuda),
                      [b.cpu() for b in base])
    with pytest.raises(TypeError):  # a lazily conjugated designated buffer
        switch_select(1, [base[0].conj(), base[1]])
    with pytest.raises(TypeError):  # a lazily conjugated alternative
        switch_select(0, [base[0], base[1].conj()])
    real = [torch.zeros(4, 6, device=cuda) for _ in range(2)]
    with pytest.raises(TypeError):  # a lazily negated alternative
        switch_select(1, [real[0], torch._neg_view(real[1])])
    assert build.launch_counts["switch_select"] == before


@pytest.mark.cuda
def test_cuda_scalar_switch_never_takes_the_plain_version(cuda, monkeypatch):
    from repro_torch.kernels.switch_select import ops

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ops, "switch_select_ref", refuse)
    outs = [torch.randn(5, 7, device=cuda) for _ in range(2)]
    got = ops.switch_select(1, [outs[0].clone(), outs[1]])
    torch.cuda.synchronize()
    assert torch.equal(got, outs[1])
    with pytest.raises(TypeError):  # a device mode must be int32: raise, never fall back
        ops.switch_select(torch.tensor(1, device=cuda), [outs[0].clone(), outs[1]])


@pytest.mark.cuda
def test_cuda_host_slot_keeps_ai_estimate_unswitched(cuda):
    """A mode-1 host slot on the card: the kernel switches a copy of the AI
    estimate, so ``all_outputs[0]`` is still the AI estimate while the
    selected buffer holds the MMSE one.  A mode-0 slot launches the kernel
    too, on the AI estimate itself: it writes nothing, so no copy is made."""
    from repro_torch import random as jr
    from repro_torch.phy import ai_estimator as tai
    from repro_torch.phy.pipeline import LinkState, PuschPipeline
    from repro_torch.phy.scenario import GOOD

    torch.use_deterministic_algorithms(True)
    cfg = SlotConfig(n_prb=24)
    net = tai.AiEstimatorConfig(channels=8, n_res_blocks=1)
    pipe = PuschPipeline(cfg, tai.init_params(jr.PRNGKey(0), cfg, net), net=net,
                         device=cuda)
    for mode in (1, 0):
        build.reset_launch_counts()
        _, out, kpms = pipe.run_slot(jr.PRNGKey(3, cuda), mode, LinkState(), GOOD)
        torch.cuda.synchronize()
        assert build.launch_counts["switch_select"] == 1, build.launch_counts
        assert build.launch_counts["mmse_interp_gauss"] == 1, build.launch_counts
        ai, mmse = out["rx"]["all_outputs"]
        sel = out["rx"]["h_selected"]
        assert torch.equal(sel, (ai, mmse)[mode])
        assert (sel.data_ptr() == ai.data_ptr()) == (mode == 0)
        if mode == 1:
            assert not torch.equal(ai, sel)
        assert np.isfinite(kpms["aerial"]["sinr"])


@pytest.mark.cuda
def test_cuda_host_session_launches_the_scalar_switch_every_slot(cuda):
    from repro_torch.core.session import ArchesSession, CampaignSpec, PolicySpec

    torch.use_deterministic_algorithms(True)
    spec = CampaignSpec(path="host", scenario="good_poor_good", n_ues=1, n_slots=9,
                        scenario_args=(("poor_start", 3), ("poor_end", 6)),
                        policies=(PolicySpec(kind="threshold", threshold=18.0),))
    sess = ArchesSession(spec, device=cuda)
    build.reset_launch_counts()
    hist = sess.run()
    assert build.launch_counts["switch_select"] == 9, build.launch_counts
    assert hist.modes.shape == (9, 1)
    for v in hist.kpms.values():
        assert np.isfinite(v).all()
