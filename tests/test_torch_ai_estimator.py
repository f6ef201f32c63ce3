"""The AI expert (residual CNN, folded-GEMM form) against ``repro``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.phy import ai_estimator as rai
from repro.phy.nr import SlotConfig as RSlotConfig
from repro_torch import random as jr
from repro_torch.convert import ai_params_from_reference
from repro_torch.phy import ai_estimator as tai
from repro_torch.phy.nr import SlotConfig

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

N_PRB = 24
CFG, RCFG = SlotConfig(n_prb=N_PRB), RSlotConfig(n_prb=N_PRB)

#: float32 forward on identical weights: the same folded GEMMs summed in
#: another order (oneDNN vs Eigen), through 2 + 2R layers; outputs are O(1)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
#: bf16 operands, f32 accumulation: both sides round the same operands to
#: bf16, but an f32 activation that differs in its last bit can round to the
#: neighbouring bf16 value (a 2**-8 relative step) and carry into the next
#: layers.  Seen: up to 1.8e-3 absolute on outputs up to 28; the bf16
#: rounding itself moves the outputs by about 0.1, which this bound still sees
BF16_TOL = dict(rtol=2e-3, atol=2e-3)
#: He-init weights from the same key: the normals differ by at most a few ulp
#: (see test_torch_random), and one float32 scale multiply follows
INIT_TOL = dict(rtol=1e-6, atol=1e-7)


def _leaves(p):
    out = [p[k] for k in ("stem_w", "stem_b", "up_w", "up_b", "head_w", "head_b")]
    for blk in p["res"]:
        out += [blk[k] for k in ("w1", "b1", "w2", "b2")]
    return [np.asarray(x) for x in out]


def _h_ls(rng, n_ues):
    shape = (n_ues, CFG.n_ant, CFG.n_dmrs_sym, CFG.n_pilot_sc)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


NETS = [tai.AiEstimatorConfig(channels=8, n_res_blocks=1),
        tai.AiEstimatorConfig(channels=4, n_res_blocks=2)]


@pytest.mark.parametrize("net", NETS[:1])
def test_init_params_from_same_seed(net):
    rnet = rai.AiEstimatorConfig(channels=net.channels, n_res_blocks=net.n_res_blocks)
    want = rai.init_params(jax.random.PRNGKey(3), RCFG, rnet)
    got = tai.init_params(jr.PRNGKey(3), CFG, net)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **INIT_TOL)
    assert net.flops(CFG) == rnet.flops(RCFG)


@pytest.mark.parametrize("net", NETS)
def test_folded_weights_bitwise(net):
    rnet = rai.AiEstimatorConfig(channels=net.channels, n_res_blocks=net.n_res_blocks)
    ref = rai.init_params(jax.random.PRNGKey(0), RCFG, rnet)
    mine = ai_params_from_reference(ref)
    fr = rai.fold_ai_params(ref, CFG.n_dmrs_sym)
    ft = tai.fold_ai_params(mine, CFG.n_dmrs_sym)
    for a, b in zip(_leaves(ft), _leaves(fr)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("carried", [True, False])
def test_forward_f32(net, carried, rng):
    """From carried-across weights, and from the port's own ``params_seed``
    weights (which add the init tolerance above)."""
    rnet = rai.AiEstimatorConfig(channels=net.channels, n_res_blocks=net.n_res_blocks)
    ref = rai.init_params(jax.random.PRNGKey(1), RCFG, rnet)
    # a head at the init scale hides the body: scale it up so the CNN's
    # correction is O(1) against the baseline and the comparison sees it
    ref = dict(ref, head_w=ref["head_w"] * 300.0)
    mine = (ai_params_from_reference(ref) if carried
            else dict(tai.init_params(jr.PRNGKey(1), CFG, net),
                      head_w=torch.as_tensor(np.asarray(ref["head_w"]))))
    h = _h_ls(rng, 3)
    want = np.asarray(rai.ai_estimate_folded(rai.fold_ai_params(ref, CFG.n_dmrs_sym),
                                             jnp.asarray(h)))
    module = tai.AiEstimator(mine, CFG.n_dmrs_sym)
    got = module(torch.as_tensor(h)).numpy()
    assert got.shape == want.shape == (3, CFG.n_ant, 1, CFG.n_sc, CFG.n_dmrs_sym)
    corr = want - np.asarray(rai.ai_estimate_folded(
        rai.fold_ai_params(dict(ref, head_w=ref["head_w"] * 0), CFG.n_dmrs_sym),
        jnp.asarray(h)))
    assert np.abs(corr).mean() > 0.1  # the network's correction is really compared
    np.testing.assert_allclose(got, want, **F32_TOL)
    # the eager conv form of the reference agrees too
    eager = np.asarray(jax.vmap(rai.ai_estimate_from_ls, (None, 0))(ref, jnp.asarray(h)))
    np.testing.assert_allclose(got, eager, **F32_TOL)


@pytest.mark.parametrize("n_ues", [1, 3])
def test_from_ls_batched(n_ues, rng):
    """``ai_estimate_from_ls_batched`` (fold for the LS width, then the folded
    forward) against ``repro``'s jitted one, at its tests' shapes."""
    net = NETS[0]
    rnet = rai.AiEstimatorConfig(channels=net.channels, n_res_blocks=net.n_res_blocks)
    ref = rai.init_params(jax.random.PRNGKey(4), RCFG, rnet)
    ref = dict(ref, head_w=ref["head_w"] * 300.0)
    h = _h_ls(rng, n_ues)
    want = np.asarray(rai.ai_estimate_from_ls_batched(ref, jnp.asarray(h)))
    got = tai.ai_estimate_from_ls_batched(ai_params_from_reference(ref), torch.as_tensor(h))
    assert got.shape == want.shape == (n_ues, CFG.n_ant, 1, CFG.n_sc, CFG.n_dmrs_sym)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_forward_bf16_operands(rng):
    net = NETS[0]
    rnet = rai.AiEstimatorConfig(channels=net.channels, n_res_blocks=net.n_res_blocks)
    ref = rai.init_params(jax.random.PRNGKey(2), RCFG, rnet)
    ref = dict(ref, head_w=ref["head_w"] * 300.0)
    h = _h_ls(rng, 2)
    folded = rai.fold_ai_params(ref, CFG.n_dmrs_sym)
    want = np.asarray(rai.ai_estimate_folded(folded, jnp.asarray(h),
                                             compute_dtype=jnp.bfloat16))
    module = tai.AiEstimator(ai_params_from_reference(ref), CFG.n_dmrs_sym,
                             compute_dtype=torch.bfloat16)
    got = module(torch.as_tensor(h)).numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)
    f32 = tai.AiEstimator(ai_params_from_reference(ref), CFG.n_dmrs_sym)(torch.as_tensor(h))
    assert not np.array_equal(got, f32.numpy())  # the operands really were rounded
