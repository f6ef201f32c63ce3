"""The side LM stack's MoE family against ``repro``: dbrx-132b (16 experts,
top-4) and kimi-k2-1t-a32b (top-8, one shared expert, its first layer
dense), on their reduced configs with ``repro``'s weights converted.
``moe_ffn``'s output, aux loss, expert assignment and kept mask; forward,
prefill and decode with every cache leaf (prefill and decode each have
their own capacity, so each is held against ``repro``'s own prefill and
decode); ``train_step``; the parameter counts; remat at 0 ulp."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as rtok
from repro.models import moe as rmoe
from repro.models.config import get_config as r_get_config
from repro.models.model import Model as RModel
from repro.models.params import count_params as r_count_params
from repro.train import step as rstep
from repro_torch import random as jr
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import tokens as ttok
from repro_torch.models import Model, get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import layer
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving import SwitchedDecodeConfig, SwitchedDecoder
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b"]
#: float32 logits on identical weights: the same einsums summed in another
#: order (XLA against oneDNN) through the layers and the head; logits are O(1)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-6)
#: a float32 mean of log-softmax terms; the aux loss, a float32 sum over E
LOSS_RTOL = 1e-6
#: the global gradient norm after a float32 backward summed in another order
GNORM_RTOL = 1e-5
#: init from one seed: normals within 3 ulp (test_torch_random), one scale
INIT_TOL = dict(rtol=1e-6, atol=1e-9)


def _ref_params(arch, seed=0):
    """``repro``'s weights with every zero-initialised leaf (the norms) drawn
    too, so those paths are compared and not just their zeros."""
    params = RModel(r_get_config(arch, reduced=True)).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) if np.asarray(x).any()
        else rng.normal(scale=0.3, size=x.shape).astype(np.float32), params)


def sorted_leaves(tree):
    """A torch tree's leaves in ``jax.tree.leaves``' order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    return [tree]


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _ref_keep(topi, cap):
    """The kept mask of ``repro``'s dispatch from its expert assignment:
    pairs sorted stably by expert, each expert keeping its first ``cap``."""
    e_flat = np.asarray(topi).reshape(-1)
    order = np.argsort(e_flat, kind="stable")
    se = e_flat[order]
    starts = np.searchsorted(se, se, side="left")
    return np.arange(se.size) - starts < cap


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cf1.25", "cf0.5"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_against_reference(arch, capacity_factor, monkeypatch):
    """Output and aux loss within ``LOGIT_TOL``; the expert assignment (the
    reference's ``top_k``, recorded as it runs) and the kept mask equal; at
    capacity factor 0.5 tokens are dropped."""
    rcfg, tcfg = r_get_config(arch, reduced=True), get_config(arch, reduced=True)
    rp = _ref_params(arch, seed=1)["blocks"]["moe"]
    rp0 = jax.tree.map(lambda a: a[0], rp)
    tp0 = layer(lm_params_from_reference(rp), 0)
    x = np.random.default_rng(2).normal(size=(2, 12, rcfg.d_model)).astype(np.float32)
    seen = []
    top_k = jax.lax.top_k
    monkeypatch.setattr(jax.lax, "top_k", lambda v, k: seen.append(top_k(v, k)) or seen[-1])
    want, want_aux = rmoe.moe_ffn(rcfg, jax.tree.map(jnp.asarray, rp0), jnp.asarray(x),
                                  capacity_factor=capacity_factor)
    got, got_aux = tmoe.moe_ffn(tcfg, tp0, torch.as_tensor(x),
                                capacity_factor=capacity_factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=LOSS_RTOL)
    r = tmoe.route(tcfg, tp0, torch.as_tensor(x).reshape(-1, tcfg.d_model))
    dp = tmoe.dispatch(tcfg, r, capacity_factor=capacity_factor)
    (ref_topv, ref_topi), = seen
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(ref_topi))
    ref_topv = np.asarray(ref_topv)
    np.testing.assert_allclose(r.topv.numpy(), ref_topv / ref_topv.sum(-1, keepdims=True),
                               rtol=1e-6)
    n, m = x.shape[0] * x.shape[1], tcfg.moe
    cap = rmoe.expert_capacity(n, m.n_experts, m.top_k, capacity_factor)
    assert dp.cap == cap == tmoe.expert_capacity(n, m.n_experts, m.top_k, capacity_factor)
    keep = _ref_keep(ref_topi, cap)
    np.testing.assert_array_equal(dp.keep.numpy(), keep)
    if capacity_factor < 1:
        assert not keep.all()


@pytest.mark.parametrize("n,e,k,cf", [(1024, 16, 4, 1.25), (8, 16, 4, 1.25),
                                      (1024, 384, 8, 1.25), (24, 4, 2, 0.5), (3, 8, 2, 2.0)])
def test_expert_capacity(n, e, k, cf):
    assert tmoe.expert_capacity(n, e, k, cf) == rmoe.expert_capacity(n, e, k, cf)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_aux_and_n_params(arch):
    rcfg, tcfg = r_get_config(arch, reduced=True), get_config(arch, reduced=True)
    rmodel, tmodel = RModel(rcfg), Model(tcfg)
    rp = _ref_params(arch)
    rpj, tp = jax.tree.map(jnp.asarray, rp), lm_params_from_reference(rp)
    tokens, labels = _tokens(rcfg.vocab, (2, 12)), _tokens(rcfg.vocab, (2, 12), 1)
    want = jax.jit(rmodel.forward)(rpj, jnp.asarray(tokens))
    got = tmodel.forward(tp, torch.as_tensor(tokens))
    assert got.logits.dtype == torch.float32 and tuple(got.logits.shape) == want.logits.shape
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **LOGIT_TOL)
    assert float(got.aux_loss) > 0
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss), rtol=LOSS_RTOL)
    want_loss = float(jax.jit(rmodel.loss)(rpj, jnp.asarray(tokens), jnp.asarray(labels)))
    got_loss = float(tmodel.loss(tp, torch.as_tensor(tokens), torch.as_tensor(labels)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    # the parameter counts: the tree against the reference's, and the config's
    # formula within 2 % of the tree, as the reference's smoke test holds it
    assert tmodel.n_params() == rmodel.n_params() == r_count_params(rmodel.defs())
    assert abs(tmodel.n_params() - tcfg.n_params()) / tmodel.n_params() < 0.02
    full_r, full_t = r_get_config(arch), get_config(arch)
    assert full_t.n_params() == full_r.n_params()
    assert full_t.n_active_params() == full_r.n_active_params()


@pytest.mark.parametrize("arch,window", [("dbrx-132b", None), ("kimi-k2-1t-a32b", None),
                                         ("kimi-k2-1t-a32b", 4)])
def test_prefill_then_decode_against_reference(arch, window):
    """Prefill 6 tokens (its own capacity), then 4 decode steps (capacity at
    n = B): logits and every cache leaf against ``repro``'s, with and without
    a uniform window (the windowed expert of the switched decoder; only
    kimi-k2's dense layer windows)."""
    rcfg = r_get_config(arch, reduced=True).with_(sliding_window=window)
    tcfg = get_config(arch, reduced=True).with_(sliding_window=window)
    rmodel, tmodel = RModel(rcfg), Model(tcfg)
    rp = _ref_params(arch)
    rpj, tp = jax.tree.map(jnp.asarray, rp), lm_params_from_reference(rp)
    tokens = _tokens(rcfg.vocab, (2, 10), 2)
    rc = rmodel.init_cache(2, 16, dtype=jnp.float32)
    tc = tmodel.init_cache(2, 16, dtype=torch.float32, device="cpu")
    assert tc.keys() == rc.keys()
    rl, rc = jax.jit(rmodel.prefill)(rpj, jnp.asarray(tokens[:, :6]), rc)
    tl, tc = tmodel.prefill(tp, torch.as_tensor(tokens[:, :6]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **LOGIT_TOL)
    r_decode = jax.jit(rmodel.decode_step)
    for t in range(6, 10):
        rl, rc = r_decode(rpj, jnp.asarray(tokens[:, t:t + 1]), rc)
        tl, tc = tmodel.decode_step(tp, torch.as_tensor(tokens[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **LOGIT_TOL)
        for name in rc:
            assert tc[name].dtype == getattr(torch, str(rc[name].dtype))
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]), **LOGIT_TOL)
        assert int(tc["index"]) == t + 1


def test_switched_decoder_experts():
    """The MoE block's attention never windows (the reference calls it with
    ``is_local`` left False), so on dbrx the windowed expert gives the exact
    expert's bits; kimi-k2's dense first layer windows, so there they differ."""
    for arch, same in (("dbrx-132b", True), ("kimi-k2-1t-a32b", False)):
        model = Model(get_config(arch, reduced=True))
        params = model.init(jr.PRNGKey(0))
        dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=2))
        prompts = torch.as_tensor(_tokens(model.cfg.vocab, (2, 8), 3))
        _, cache = model.prefill(params, prompts, model.init_cache(2, 16, dtype=torch.float32,
                                                                   device="cpu"))
        outs = [e.fn(None, params, prompts[:, -1:], cache) for e in dec.bank.experts]
        assert torch.equal(outs[0], outs[1]) == same, arch
        logits, new_cache, kpms = dec.step(torch.tensor([0, 1], dtype=torch.int32), params,
                                           prompts[:, -1:], cache)
        assert torch.equal(logits[0], outs[0][0]) and torch.equal(logits[1], outs[1][1])
        assert kpms["cache_occupancy"] == 9 / 16 and int(new_cache["index"]) == 9


@pytest.mark.parametrize("arch", ARCHS)
def test_init_from_one_seed(arch):
    want = RModel(r_get_config(arch, reduced=True)).init(jax.random.PRNGKey(7))
    got = Model(get_config(arch, reduced=True)).init(jr.PRNGKey(7))
    pairs = jax.tree.leaves(jax.tree.map(lambda a, b: (np.asarray(a), b.numpy()), want, got),
                            is_leaf=lambda x: isinstance(x, tuple))
    assert len(pairs) == len(jax.tree.leaves(want))
    for a, b in pairs:
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, **INIT_TOL)


BATCH, SEQ, LR = 4, 8, 1e-3
#: the weights after one AdamW step at lr 1e-3: the step moves a weight by
#: nearly lr * sign(g), and a gradient component within AdamW's eps (1e-8) of
#: 0 may land anywhere in [-lr, lr], so one weight may be 2 lr apart (qwen2-vl
#: read 1.4e-4 on one of 16,384 embedding weights); all the others agree to
#: float32 rounding: at most WEIGHT_OUTLIERS of the weights past WEIGHT_ATOL
WEIGHT_ATOL, WEIGHT_OUTLIERS = 1e-6, 1e-3


def _reference_step(arch):
    """``repro``'s first step under jit: initial weights, metrics, weights after."""
    model = RModel(r_get_config(arch, reduced=True))
    tc = rstep.TrainConfig(learning_rate=LR)
    p0 = model.init(jax.random.PRNGKey(0))
    state = rstep.init_train_state(model, p0, tc)
    batch = rtok.TokenStream(vocab=256, seq_len=SEQ, global_batch=BATCH, seed=0).batch_at(0)
    state, m = jax.jit(functools.partial(rstep.train_step, model, tc))(state, batch)
    return (jax.tree.map(np.asarray, p0), (float(m["loss"]), float(m["grad_norm"])),
            [np.asarray(x) for x in jax.tree.leaves(state.params)])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_against_reference(arch):
    """One AdamW step on the same weights and batch as ``repro``'s jitted step:
    the loss (with the aux loss), the gradient norm and the new weights."""
    p0, (loss, gnorm), want = _reference_step(arch)
    model = Model(get_config(arch, reduced=True))
    tc = tstep.TrainConfig(learning_rate=LR)
    state = tstep.init_train_state(model, lm_params_from_reference(p0), tc)
    batch = ttok.TokenStream(vocab=256, seq_len=SEQ, global_batch=BATCH, seed=0).batch_at(0)
    state, m = tstep.train_step(model, tc, state, batch)
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), gnorm, rtol=GNORM_RTOL)
    got = sorted_leaves(state.params)
    assert len(got) == len(want)
    diff = np.concatenate([np.abs(a.numpy() - b).ravel() for a, b in zip(got, want)])
    assert diff.max() <= 2 * LR and (diff > WEIGHT_ATOL).mean() <= WEIGHT_OUTLIERS


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_same_bits(arch):
    """Rematerialised MoE blocks (and kimi-k2's dense block) give the loss and
    every gradient of ``remat="none"`` at 0 ulp."""
    base = get_config(arch, reduced=True)
    params = Model(base).init(jr.PRNGKey(3))
    batch = ttok.TokenStream(vocab=256, seq_len=SEQ, global_batch=BATCH, seed=1).batch_at(0)
    runs = {}
    for remat in ("none", "block", "full"):
        loss, grads = tstep._grads(Model(base.with_(remat=remat)), params,
                                   {k: torch.as_tensor(v) for k, v in batch.items()})
        runs[remat] = [loss, *tree_leaves(grads)]
    for remat in ("block", "full"):
        assert all(torch.equal(a, b) for a, b in zip(runs["none"], runs[remat])), remat
