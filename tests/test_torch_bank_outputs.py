"""What a batched bank call hands back, against ``repro``'s ``BankOutput``.

The per-UE switch, the scatter and the fused expert write ``selected`` out of
place, so ``all_outputs[0]`` stays the designated (AI) expert's own output and
``baseline`` the fail-safe's, as in the reference, and neither shares storage
with ``selected``.  Toy banks compare bitwise; the engine's bank (the AI
estimator and MMSE) within the experts' tolerances.  The same contract on the
card is held by ``test_torch_cuda_kernels.py``.
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

#: the AI expert's float32 tolerance (test_torch_ai_estimator); MMSE's as in
#: test_torch_gated_bank
F32_TOL = dict(rtol=1e-4, atol=1e-5)
MMSE_TOL = dict(rtol=3e-5, atol=3e-5)
N_PRB = 24


def _apart(out):
    """``selected`` shares storage with neither unswitched output."""
    ptr = out.selected.data_ptr()
    assert out.baseline.data_ptr() != ptr
    if out.all_outputs is not None:
        assert out.all_outputs[0].data_ptr() != ptr


@pytest.mark.parametrize("kw", [dict(), dict(execution_mode="gated", gated_capacity=2)],
                         ids=["concurrent", "gated"])
def test_toy_bank_keeps_unswitched_outputs(kw, rng):
    fns = [("ai", lambda p, x: 2.0 * x + 1.0, 100.0), ("mmse", lambda p, x: -x, 7.0)]
    x = rng.normal(size=(5, 6)).astype(np.float32)
    mode = np.asarray([0, 1, 0, 0, 1], np.int32)
    banks = []
    for pkg in (rbank, tbank):
        kwp = dict(kw)
        if "execution_mode" in kwp:
            kwp["execution_mode"] = pkg.ExecutionMode.coerce(kwp["execution_mode"])
        banks.append(pkg.ExpertBank([pkg.Expert(name=n, fn=f, flops=c) for n, f, c in fns],
                                    default_mode=1, **kwp))
    ro = banks[0](jnp.asarray(mode), jnp.asarray(x))
    to = banks[1](torch.as_tensor(mode), torch.as_tensor(x))
    np.testing.assert_array_equal(to.selected.numpy(), np.asarray(ro.selected))
    np.testing.assert_array_equal(to.baseline.numpy(), np.asarray(ro.baseline))
    np.testing.assert_array_equal(to.baseline.numpy(), -x)
    if ro.all_outputs is not None:
        np.testing.assert_array_equal(to.all_outputs[0].numpy(), np.asarray(ro.all_outputs[0]))
        np.testing.assert_array_equal(to.all_outputs[0].numpy(), 2.0 * x + 1.0)
    _apart(to)


@pytest.fixture(scope="module")
def ref_params():
    net = rai.AiEstimatorConfig(channels=8, n_res_blocks=1)
    return rai.init_params(jax.random.PRNGKey(0), RSlotConfig(n_prb=N_PRB), net)


@pytest.mark.parametrize("kw", [
    dict(), dict(execution_mode="gated", gated_capacity=3),
    dict(execution_mode="gated", gated_capacity=3, fused_gated=True)],
    ids=["concurrent", "gated", "gated-fused"])
def test_engine_bank_keeps_unswitched_outputs(ref_params, kw, rng):
    cfg = SlotConfig(n_prb=N_PRB)
    rkw = dict(kw)
    if "execution_mode" in rkw:
        rkw["execution_mode"] = rbank.ExecutionMode.GATED
    rb = RPipeline(RSlotConfig(n_prb=N_PRB), ref_params, **rkw).bank
    tb = BatchedPuschPipeline(cfg, ai_params_from_reference(ref_params), device="cpu",
                              **kw).bank
    shape = (6, cfg.n_ant, cfg.n_dmrs_sym, cfg.n_pilot_sc)
    h_ls = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    mode = np.asarray([0, 1, 0, 0, 1, 0], np.int32)
    ro = rb(jnp.asarray(mode), jnp.asarray(h_ls))
    to = tb(torch.as_tensor(mode), torch.as_tensor(h_ls))
    np.testing.assert_allclose(to.baseline.numpy(), np.asarray(ro.baseline), **MMSE_TOL)
    if ro.all_outputs is not None:
        np.testing.assert_allclose(to.all_outputs[0].numpy(), np.asarray(ro.all_outputs[0]),
                                   **F32_TOL)
    # the UEs that kept the fail-safe read it, the others the AI estimate
    mmse = np.asarray(mode) == 1
    np.testing.assert_array_equal(to.selected.numpy()[mmse], to.baseline.numpy()[mmse])
    _apart(to)
