"""The GATED expert bank against ``repro``'s.

Toy banks (elementwise experts on float tensors) compare every leaf: the
experts' arithmetic is the same IEEE operation in both packages, so
``selected`` is bitwise too.  The engine's own bank (the AI estimator and
MMSE) compares the integer leaves bitwise and ``selected`` within the AI
expert's tolerance.  The audit tests show the baseline the audit compares
against is the unswitched fail-safe output, apart from ``selected``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expert_bank as rbank
from repro.phy import ai_estimator as rai
from repro.phy.nr import SlotConfig as RSlotConfig
from repro.phy.pipeline import BatchedPuschPipeline as RPipeline
from repro_torch.convert import ai_params_from_reference
from repro_torch.core import expert_bank as tbank
from repro_torch.phy.nr import SlotConfig
from repro_torch.phy.pipeline import BatchedPuschPipeline

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

#: the AI expert's float32 and bf16 tolerances (test_torch_ai_estimator)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-3, atol=2e-3)


def _toy(pkg, fns=None, **kw):
    """``ai: 2x + 1`` (100 FLOPs) and ``mmse: -x`` (7 FLOPs), or ``fns``."""
    fns = fns or [("ai", lambda p, x: 2.0 * x + 1.0, 100.0), ("mmse", lambda p, x: -x, 7.0)]
    experts = [pkg.Expert(name=n, fn=f, flops=c) for n, f, c in fns]
    if "execution_mode" in kw:  # the reference compares enum members
        kw["execution_mode"] = pkg.ExecutionMode.coerce(kw["execution_mode"])
    return pkg.ExpertBank(experts, default_mode=1, **kw)


def _both(mode, x, fns=None, **kw):
    """Run one toy configuration through both banks."""
    rb, tb = _toy(rbank, fns, **kw), _toy(tbank, fns, **kw)
    return rb, rb(jnp.asarray(mode), jnp.asarray(x)), tb, tb(torch.as_tensor(mode),
                                                             torch.as_tensor(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_leaves(ro, to, selected_bitwise=True):
    for k in ("overflow", "served_by", "executed_ue", "audit_tripped"):
        r, t = getattr(ro, k), getattr(to, k)
        assert (r is None) == (t is None), k
        if r is not None:
            np.testing.assert_array_equal(_np(t), _np(r), err_msg=k)
    if selected_bitwise:
        np.testing.assert_array_equal(_np(to.selected), _np(ro.selected))


@pytest.mark.parametrize("n_ues", [1, 3, 16])
@pytest.mark.parametrize("capacity", [None, 0, 1, 2])
def test_toy_gated_bank_vs_reference(n_ues, capacity, rng):
    x = rng.normal(size=(n_ues, 4, 6)).astype(np.float32)
    for _ in range(4):
        mode = rng.integers(0, 2, n_ues).astype(np.int32)
        rb, ro, tb, to = _both(mode, x, execution_mode="gated", gated_capacity=capacity)
        _same_leaves(ro, to)
        assert float(tb.executed_flops(to)) == float(rb.executed_flops(ro))
        np.testing.assert_array_equal(_np(tb.executed_flops_per_ue(to)),
                                      _np(rb.executed_flops_per_ue(ro)))
        np.testing.assert_allclose(float(tb.executed_flops_per_ue(to).sum()),
                                   float(tb.executed_flops(to)))


def test_toy_gated_bank_three_experts(rng):
    fns = [("ai", lambda p, x: 2.0 * x, 100.0), ("mmse", lambda p, x: -x, 7.0),
           ("ls", lambda p, x: x + 3.0, 1.0)]
    x = rng.normal(size=(6, 9)).astype(np.float32)
    mode = np.asarray([0, 2, 1, 0, 2, 1], np.int32)
    _, ro, _, to = _both(mode, x, fns, execution_mode="gated", gated_capacity=1)
    _same_leaves(ro, to)
    np.testing.assert_array_equal(_np(to.served_by), [0, 2, 1, 1, 2, 1])


def test_exact_capacity_boundary(rng):
    """As many selecting UEs as the capacity: none overflows and the last one
    is served by the gated expert; one more selection overflows exactly one."""
    x = rng.normal(size=(9, 5)).astype(np.float32)
    mode = np.asarray([1, 0, 1, 0, 0, 1, 1, 1, 1], np.int32)
    rb, ro, tb, to = _both(mode, x, execution_mode="gated", gated_capacity=3)
    _same_leaves(ro, to)
    assert not _np(to.overflow).any()
    np.testing.assert_array_equal(_np(to.served_by)[[1, 3, 4]], 0)
    np.testing.assert_array_equal(_np(to.executed_ue), [3, 9])
    assert float(tb.executed_flops(to)) == 3 * 100.0 + 9 * 7.0
    mode[0] = 0
    _, ro, _, to = _both(mode, x, execution_mode="gated", gated_capacity=3)
    _same_leaves(ro, to)
    assert int(_np(to.overflow).sum()) == 1 and bool(_np(to.overflow)[4])


def test_audit_trips_on_divergent_expert(rng):
    """A divergent expert trips the audit: the UE gets the unswitched
    baseline back bitwise, is served by the fail-safe, and still pays."""
    fns = [("ai", lambda p, x: 1e6 * x, 100.0), ("mmse", lambda p, x: -x, 7.0)]
    x = rng.normal(size=(4, 8)).astype(np.float32)
    mode = np.asarray([0, 1, 0, 1], np.int32)
    rb, ro, tb, to = _both(mode, x, fns, execution_mode="gated", gated_capacity=2,
                           audit_threshold=1.0)
    _same_leaves(ro, to)
    np.testing.assert_array_equal(_np(to.audit_tripped), [True, False, True, False])
    np.testing.assert_array_equal(_np(to.selected), -x)
    np.testing.assert_array_equal(_np(to.baseline), -x)
    np.testing.assert_array_equal(_np(to.served_by), [1, 1, 1, 1])
    assert float(tb.executed_flops(to)) == 2 * 100.0 + 4 * 7.0
    np.testing.assert_array_equal(_np(tb.executed_flops_per_ue(to)), [107.0, 7.0, 107.0, 7.0])


@pytest.mark.parametrize("fused", [False, True])
def test_audit_trips_on_nan_expert(fused):
    """A NaN forward trips whatever the threshold; with a fused hook that
    returns a new tensor, as the card's wrapper does (it writes a copy of the
    baseline), the audit sees the unswitched baseline, which the bank
    returns untouched and apart from ``selected``."""
    fns = [("ai", lambda p, x: x * float("nan"), 1.0), ("mmse", lambda p, x: -x, 1.0)]
    x = np.ones((3, 4), np.float32)
    mode = np.zeros(3, np.int32)

    def out_of_place(idx, src, base, x):
        keep = (src < 0)[:, None]
        return torch.where(keep, base, x * float("nan"))

    kw = dict(execution_mode="gated", audit_threshold=1e6)
    ro = _toy(rbank, fns, **kw)(jnp.asarray(mode), jnp.asarray(x))
    tb = _toy(tbank, fns, gated_fused_apply=out_of_place if fused else None, **kw)
    to = tb(torch.as_tensor(mode), torch.as_tensor(x))
    _same_leaves(ro, to)
    np.testing.assert_array_equal(_np(to.audit_tripped), [True] * 3)
    np.testing.assert_array_equal(_np(to.selected), -x)
    assert np.isfinite(_np(to.selected)).all()
    np.testing.assert_array_equal(_np(to.baseline), -x)
    assert to.baseline.data_ptr() != to.selected.data_ptr()


def test_audit_quiet_on_faithful_expert(rng):
    x = rng.normal(size=(5, 6)).astype(np.float32)
    mode = np.asarray([0, 1, 0, 0, 1], np.int32)
    _, ro, _, to = _both(mode, x, execution_mode="gated", audit_threshold=1e9)
    _same_leaves(ro, to)
    assert not _np(to.audit_tripped).any()
    np.testing.assert_array_equal(_np(to.selected)[[0, 2, 3]], 2 * x[[0, 2, 3]] + 1)


def test_cost_queries():
    for pkg in (rbank, tbank):
        gated = _toy(pkg, execution_mode=pkg.ExecutionMode.GATED, gated_capacity=2)
        with pytest.raises(ValueError):
            gated.flops_for()
        assert gated.provisioned_flops(8) == 2 * 100.0 + 8 * 7.0
        assert _toy(pkg, execution_mode=pkg.ExecutionMode.GATED).provisioned_flops(8) == (
            8 * 107.0)
        assert _toy(pkg).provisioned_flops(8) == 8 * 107.0
        assert _toy(pkg).flops_for() == 107.0
    out = tbank.BankOutput(selected=None, all_outputs=None, mode=torch.zeros(1))
    with pytest.raises(ValueError):
        _toy(tbank).executed_flops(out)


def test_constructor_errors():
    with pytest.raises(ValueError):
        _toy(tbank, execution_mode="gated", gated_capacity=-1)
    same = [tbank.Expert(name="a", fn=lambda p, x: x), tbank.Expert(name="b", fn=lambda p, x: x)]
    with pytest.raises(ValueError):
        tbank.ExpertBank(same, default_mode=0, execution_mode="gated")
    with pytest.raises(ValueError):
        _toy(tbank, gated_fused_apply=lambda *a: None)  # needs GATED
    with pytest.raises(ValueError):
        _toy(tbank, audit_threshold=1.0)  # needs GATED
    with pytest.raises(ValueError):
        _toy(tbank, execution_mode="gated", audit_threshold=0.0)
    # SELECTED_ONLY builds now (tests/test_torch_host_path.py); its static
    # cost needs the selected mode
    with pytest.raises(ValueError):
        _toy(tbank, execution_mode="selected_only").flops_for()
    with pytest.raises(ValueError):
        _toy(tbank, execution_mode="gated")(torch.tensor(0), torch.zeros(4, 4))


# -- the engine's bank: AI estimator + MMSE -----------------------------------------

N_PRB = 24


@pytest.fixture(scope="module")
def ref_params():
    net = rai.AiEstimatorConfig(channels=8, n_res_blocks=1)
    return rai.init_params(jax.random.PRNGKey(0), RSlotConfig(n_prb=N_PRB), net)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype,capacity,audit", [
    ("float32", 3, None), ("bfloat16", None, 1e3), ("float32", 0, None)])
def test_engine_bank_vs_reference(ref_params, fused, dtype, capacity, audit, rng):
    cfg = SlotConfig(n_prb=N_PRB)
    kw = dict(execution_mode="gated", gated_capacity=capacity, fused_gated=fused,
              expert_dtype=dtype, audit_nmse_threshold=audit)
    rbank_ = RPipeline(RSlotConfig(n_prb=N_PRB), ref_params,
                       **dict(kw, execution_mode=rbank.ExecutionMode.GATED)).bank
    tbank_ = BatchedPuschPipeline(cfg, ai_params_from_reference(ref_params), device="cpu",
                                  **kw).bank
    shape = (6, cfg.n_ant, cfg.n_dmrs_sym, cfg.n_pilot_sc)
    h_ls = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    mode = np.asarray([0, 1, 0, 0, 1, 0], np.int32)
    ro = rbank_(jnp.asarray(mode), jnp.asarray(h_ls))
    to = tbank_(torch.as_tensor(mode), torch.as_tensor(h_ls))
    _same_leaves(ro, to, selected_bitwise=False)
    np.testing.assert_allclose(_np(to.selected), _np(ro.selected),
                               **(BF16_TOL if dtype == "bfloat16" else F32_TOL))
    if audit is not None:  # the baseline is the unswitched MMSE estimate
        np.testing.assert_allclose(_np(to.baseline), _np(ro.baseline), rtol=3e-5, atol=3e-5)
    np.testing.assert_array_equal(_np(tbank_.executed_flops_per_ue(to)),
                                  _np(rbank_.executed_flops_per_ue(ro)))
