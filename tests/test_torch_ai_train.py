"""AI-expert training against ``repro``: the task-aligned loss and its gradient,
and ``train_ai_estimator`` over the same preset samples (channels 8, one
residual block, n_prb 6)."""

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

torch.set_num_threads(1)

N_PRB = 6
CFG, RCFG = SlotConfig(n_prb=N_PRB), RSlotConfig(n_prb=N_PRB)
NET = tai.AiEstimatorConfig(channels=8, n_res_blocks=1)
RNET = rai.AiEstimatorConfig(channels=8, n_res_blocks=1)
_KEYS = ("stem_w", "stem_b", "up_w", "up_b", "head_w", "head_b")

#: the loss on identical weights: float32 convolutions summed in another order
#: (XLA against oneDNN) through 4 layers, then float32 means of O(1) terms
LOSS_RTOL = 1e-5
#: its gradient: the same convolutions' transposes, reduced in another order
#: over 36 x 3 pixels; components near zero get the absolute floor
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)
#: 5 AdamW steps at lr 1e-3 from the same init: each step moves a weight by at
#: most ~lr, and a gradient that differs in its last bits moves it by far less
TRAIN_TOL = dict(rtol=1e-4, atol=2e-6)
#: He-init weights from one key: normals within 3 ulp (test_torch_random)
INIT_TOL = dict(rtol=1e-6, atol=1e-7)


def _leaves(p):
    return [p[k] for k in _KEYS] + [blk[k] for blk in p["res"] for k in ("w1", "b1", "w2", "b2")]


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _sample(rng, zero_re: bool = False):
    """LS at the pilots and the true channel at the DMRS symbols; with
    ``zero_re`` one subcarrier's channel is 0 on every antenna, so the MRC
    term's antenna sum is 0 exactly there."""
    ls = (CFG.n_ant, CFG.n_dmrs_sym, CFG.n_pilot_sc)
    true = (CFG.n_ant, 1, CFG.n_sc, CFG.n_dmrs_sym)
    h_ls = (rng.normal(size=ls) + 1j * rng.normal(size=ls)).astype(np.complex64)
    h_true = (rng.normal(size=true) + 1j * rng.normal(size=true)).astype(np.complex64)
    if zero_re:
        h_true[:, :, 5, :] = 0
    return h_ls, h_true


def _ref_params(seed=0):
    ref = rai.init_params(jax.random.PRNGKey(seed), RCFG, RNET)
    # a head at the init scale hides the body from the loss: scale it up
    return dict(ref, head_w=ref["head_w"] * 300.0)


@pytest.mark.parametrize("zero_re", [False, True], ids=["generic", "zero_antenna_sum"])
def test_loss_and_gradient(zero_re):
    rng = np.random.default_rng(11)
    h_ls, h_true = _sample(rng, zero_re)
    ref = _ref_params()
    want_loss, want_g = jax.value_and_grad(rai._loss)(ref, jnp.asarray(h_ls),
                                                      jnp.asarray(h_true))
    mine = {k: v.requires_grad_(True) if isinstance(v, torch.Tensor) else v
            for k, v in ai_params_from_reference(ref).items()}
    for blk in mine["res"]:
        for v in blk.values():
            v.requires_grad_(True)
    loss = tai._loss(mine, torch.as_tensor(h_ls), torch.as_tensor(h_true))
    got_g = torch.autograd.grad(loss, _leaves(mine))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    for a, b in zip(got_g, _leaves(want_g)):
        assert np.isfinite(_np(a)).all()
        np.testing.assert_allclose(_np(a), np.asarray(b), **GRAD_TOL)


def test_train_ai_estimator_five_steps():
    """A sampler that replays preset numpy samples and records the keys it is
    given: the key sequence bitwise, the losses and the trained weights
    within ``TRAIN_TOL``; the trained weights feed ``AiEstimator`` as they are."""
    rng = np.random.default_rng(5)
    samples = [_sample(rng) for _ in range(5)]
    r_keys, t_keys = [], []

    def r_sample(key):
        r_keys.append(np.asarray(key))
        h_ls, h_true = samples[len(r_keys) - 1]
        return jnp.asarray(h_ls), jnp.asarray(h_true)

    def t_sample(key):
        t_keys.append(_np(key))
        h_ls, h_true = samples[len(t_keys) - 1]
        return torch.as_tensor(h_ls, device=key.device), torch.as_tensor(h_true,
                                                                          device=key.device)

    want_p, want_l = rai.train_ai_estimator(jax.random.PRNGKey(4), RCFG, r_sample, net=RNET,
                                            steps=5, lr=1e-3)
    got_p, got_l = tai.train_ai_estimator(jr.PRNGKey(4), CFG, t_sample, net=NET, steps=5,
                                          lr=1e-3, device="cpu")
    assert len(t_keys) == len(r_keys) == 5
    for a, b in zip(t_keys, r_keys):
        np.testing.assert_array_equal(a.astype(np.uint32), b)
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL)
    # the init alone: within the normal contract; the steps add TRAIN_TOL
    init = tai.init_params(jr.split(jr.PRNGKey(4))[0], CFG, NET)
    r_init = rai.init_params(jax.random.split(jax.random.PRNGKey(4))[0], RCFG, RNET)
    for a, b in zip(_leaves(init), _leaves(r_init)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **INIT_TOL)
    for a, b in zip(_leaves(got_p), _leaves(want_p)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TRAIN_TOL)
    assert not np.allclose(_np(got_p["stem_w"]), _np(init["stem_w"]))
    h = torch.as_tensor(samples[0][0])[None]
    folded = tai.AiEstimator(got_p, CFG.n_dmrs_sym)(h)
    eager = tai.ai_estimate_from_ls(got_p, h[0])
    np.testing.assert_allclose(_np(folded[0]), _np(eager), rtol=1e-4, atol=1e-5)
