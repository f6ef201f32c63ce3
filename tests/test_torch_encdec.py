"""The side LM stack's encoder-decoder (whisper-large-v3) and local/global
(gemma2-9b) families against ``repro``, on their reduced configs with
``repro``'s weights converted: whisper's ``encode``; forward logits and
loss, gemma2 past its window of 8 and on the chunked path (2,112 tokens);
prefill with cross K/V of the frames' length (8 frames against
``encoder_seq`` 16) and 4 decode steps with every cache leaf; ``train_step``;
the parameter counts; remat at 0 ulp; ``SwitchedDecoder`` refusing gemma2
and whisper's windowed expert decoding the exact expert's bits, in both
packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as rtok
from repro.models import transformer as rT
from repro.models.config import get_config as r_get_config
from repro.models.model import Model as RModel
from repro.serving import switched as rsw
from repro.train import step as rstep
from repro_torch import random as jr
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import tokens as ttok
from repro_torch.models import Model, get_config
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving import SwitchedDecodeConfig, SwitchedDecoder
from repro_torch.train import step as tstep

torch.set_num_threads(1)

WHISPER, GEMMA2 = "whisper-large-v3", "gemma2-9b"
ARCHS = [WHISPER, GEMMA2]
#: float32 logits on identical weights: the same einsums summed in another
#: order (XLA against oneDNN) through the layers and the head; logits are O(1)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-6)
#: a float32 mean of log-softmax terms
LOSS_RTOL = 1e-6
#: the global gradient norm after a float32 backward summed in another order
GNORM_RTOL = 1e-5
#: the weights after one AdamW step at lr 1e-3 (tests/test_torch_moe.py): at
#: most WEIGHT_OUTLIERS of them past WEIGHT_ATOL, none past 2 lr
LR, WEIGHT_ATOL, WEIGHT_OUTLIERS = 1e-3, 1e-6, 1e-3
#: whisper's stub frames: 8 of them against the config's encoder_seq of 16
N_FRAMES = 8


def _ref_params(arch, seed=0):
    """``repro``'s weights with every zero-initialised leaf (the norms) drawn
    too, so those paths are compared and not just their zeros."""
    params = RModel(r_get_config(arch, reduced=True)).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) if np.asarray(x).any()
        else rng.normal(scale=0.3, size=x.shape).astype(np.float32), params)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _frames(arch, batch, seed=5):
    """Seeded stub frame embeddings (the reference's frontend is a stub)."""
    if arch != WHISPER:
        return None
    d = r_get_config(arch, reduced=True).d_model
    return np.random.default_rng(seed).normal(size=(batch, N_FRAMES, d)).astype(np.float32)


def _kw(frames, to):
    return {} if frames is None else {"encoder_frames": to(frames)}


def sorted_leaves(tree):
    """A torch tree's leaves in ``jax.tree.leaves``' order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    return [tree]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in _paths(v, prefix + (k,)).items()}
    return {prefix: tuple(tree.shape)}


def test_encode_against_reference():
    rcfg, tcfg = r_get_config(WHISPER, reduced=True), get_config(WHISPER, reduced=True)
    rp = _ref_params(WHISPER)
    frames = _frames(WHISPER, 2)
    want = np.asarray(jax.jit(functools.partial(rT.encode, rcfg))(
        jax.tree.map(jnp.asarray, rp), jnp.asarray(frames)))
    got = tT.encode(tcfg, lm_params_from_reference(rp), torch.as_tensor(frames))
    assert tuple(got.shape) == (2, N_FRAMES, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_n_params(arch):
    """Logits and loss (gemma2 at 20 tokens, past its window of 8); the
    converted tree has the port's paths and shapes (the encoder, the cross
    attention and its norm, gemma2's post-norms, no head where it is tied);
    the parameter counts: the tree against the reference's, and against the
    config's formula, which leaves out the norms."""
    rcfg, tcfg = r_get_config(arch, reduced=True), get_config(arch, reduced=True)
    rmodel, tmodel = RModel(rcfg), Model(tcfg)
    rp = _ref_params(arch)
    rpj, tp = jax.tree.map(jnp.asarray, rp), lm_params_from_reference(rp)
    assert _paths(tp) == _paths(tmodel.init(jr.PRNGKey(0)))
    seq = 12 if arch == WHISPER else 20
    tokens, labels = _tokens(rcfg.vocab, (2, seq)), _tokens(rcfg.vocab, (2, seq), 1)
    frames = _frames(arch, 2)
    want = jax.jit(rmodel.forward)(rpj, jnp.asarray(tokens), **_kw(frames, jnp.asarray))
    got = tmodel.forward(tp, torch.as_tensor(tokens), **_kw(frames, torch.as_tensor))
    assert got.logits.dtype == torch.float32 and tuple(got.logits.shape) == want.logits.shape
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **LOGIT_TOL)
    want_loss = float(jax.jit(rmodel.loss)(rpj, jnp.asarray(tokens), jnp.asarray(labels),
                                           **_kw(frames, jnp.asarray)))
    got_loss = float(tmodel.loss(tp, torch.as_tensor(tokens), torch.as_tensor(labels),
                                 **_kw(frames, torch.as_tensor)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert tmodel.n_params() == rmodel.n_params()
    norms = sum(int(np.prod(s)) for p, s in _paths(tp).items() if "norm" in p[-1])
    assert tmodel.n_params() - norms == tcfg.n_params() == rcfg.n_params()


def test_gemma2_chunked_forward(monkeypatch):
    """2,112 tokens take the chunked path (past 2,048 query positions): the
    window reaches the local layers only and the attention softcap every
    layer; logits against the reference's."""
    rcfg, tcfg = r_get_config(GEMMA2, reduced=True), get_config(GEMMA2, reduced=True)
    rp = _ref_params(GEMMA2)
    tokens = _tokens(rcfg.vocab, (1, 2112), 4)
    calls = []
    orig = tL.chunked_attention

    def spy(*args, **kw):
        calls.append((kw["window"], kw["softcap"]))
        return orig(*args, **kw)

    monkeypatch.setattr(tL, "chunked_attention", spy)
    want = np.asarray(jax.jit(RModel(rcfg).forward)(jax.tree.map(jnp.asarray, rp),
                                                    jnp.asarray(tokens)).logits)
    got = Model(tcfg).forward(lm_params_from_reference(rp), torch.as_tensor(tokens)).logits
    assert calls == [(8, 50.0), (None, 50.0)]
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_against_reference(arch):
    """Prefill 6 tokens (whisper with 8 frames: the cross K/V take the frames'
    length, not ``encoder_seq``), then 4 decode steps: logits and every cache
    leaf against ``repro``'s.  whisper's cache holds 8 positions, so its last
    steps clamp the position row and the insert to position 7, as the
    reference's ``dynamic_slice`` / ``dynamic_update_slice`` clamp them;
    gemma2's 12-token prompt and steps run past its window of 8."""
    rcfg, tcfg = r_get_config(arch, reduced=True), get_config(arch, reduced=True)
    rmodel, tmodel = RModel(rcfg), Model(tcfg)
    rp = _ref_params(arch)
    rpj, tp = jax.tree.map(jnp.asarray, rp), lm_params_from_reference(rp)
    prompt, max_seq = (6, 8) if arch == WHISPER else (12, 20)
    tokens = _tokens(rcfg.vocab, (2, prompt + 4), 2)
    frames = _frames(arch, 2)
    rc = rmodel.init_cache(2, max_seq, dtype=jnp.float32)
    tc = tmodel.init_cache(2, max_seq, dtype=torch.float32, device="cpu")
    assert tc.keys() == rc.keys()
    assert all(tuple(tc[k].shape) == rc[k].shape for k in rc)
    rl, rc = jax.jit(rmodel.prefill)(rpj, jnp.asarray(tokens[:, :prompt]), rc,
                                     **_kw(frames, jnp.asarray))
    tl, tc = tmodel.prefill(tp, torch.as_tensor(tokens[:, :prompt]), tc,
                            **_kw(frames, torch.as_tensor))
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **LOGIT_TOL)
    if arch == WHISPER:
        assert tuple(tc["cross_k"].shape) == (tcfg.n_layers, 2, N_FRAMES, 4, 16)
    r_decode = jax.jit(rmodel.decode_step)
    for t in range(prompt, prompt + 4):
        rl, rc = r_decode(rpj, jnp.asarray(tokens[:, t:t + 1]), rc)
        tl, tc = tmodel.decode_step(tp, torch.as_tensor(tokens[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **LOGIT_TOL)
        for name in rc:
            assert tc[name].dtype == getattr(torch, str(rc[name].dtype))
            assert tuple(tc[name].shape) == rc[name].shape
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]), **LOGIT_TOL)
        assert int(tc["index"]) == t + 1


def _reference_step(arch):
    """``repro``'s first step under jit: initial weights, metrics, weights after."""
    model = RModel(r_get_config(arch, reduced=True))
    tc = rstep.TrainConfig(learning_rate=LR)
    p0 = model.init(jax.random.PRNGKey(0))
    state = rstep.init_train_state(model, p0, tc)
    batch = _batch(arch, rtok)
    state, m = jax.jit(functools.partial(rstep.train_step, model, tc))(state, batch)
    return (jax.tree.map(np.asarray, p0), (float(m["loss"]), float(m["grad_norm"])),
            [np.asarray(x) for x in jax.tree.leaves(state.params)])


def _batch(arch, tokens_mod, seed=0):
    """A stream batch of 4 x 12 (past gemma2's window); whisper's with frames."""
    batch = tokens_mod.TokenStream(vocab=256, seq_len=12, global_batch=4, seed=seed).batch_at(0)
    frames = _frames(arch, 4)
    return batch if frames is None else {**batch, "encoder_frames": frames}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_against_reference(arch):
    """One AdamW step on the same weights and batch as ``repro``'s jitted step
    (whisper's frames carried into the loss and the gradients): the loss, the
    gradient norm and the new weights."""
    p0, (loss, gnorm), want = _reference_step(arch)
    model = Model(get_config(arch, reduced=True))
    tc = tstep.TrainConfig(learning_rate=LR)
    state = tstep.init_train_state(model, lm_params_from_reference(p0), tc)
    state, m = tstep.train_step(model, tc, state, _batch(arch, ttok))
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), gnorm, rtol=GNORM_RTOL)
    got = sorted_leaves(state.params)
    assert len(got) == len(want)
    diff = np.concatenate([np.abs(a.numpy() - b).ravel() for a, b in zip(got, want)])
    assert diff.max() <= 2 * LR and (diff > WEIGHT_ATOL).mean() <= WEIGHT_OUTLIERS


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_same_bits(arch):
    """Rematerialised blocks (whisper's encoder and decoder blocks, each of
    gemma2's two layers of a pair) give the loss and every gradient of
    ``remat="none"`` at 0 ulp."""
    base = get_config(arch, reduced=True)
    params = Model(base).init(jr.PRNGKey(3))
    batch = {k: torch.as_tensor(v) for k, v in _batch(arch, ttok, seed=1).items()}
    runs = {}
    for remat in ("none", "block", "full"):
        loss, grads = tstep._grads(Model(base.with_(remat=remat)), params, batch)
        runs[remat] = [loss, *tree_leaves(grads)]
    for remat in ("block", "full"):
        assert all(torch.equal(a, b) for a, b in zip(runs["none"], runs[remat])), remat


def test_switched_decoder_refuses_gemma2():
    """Both packages refuse the local/global pattern: its layers hard-code
    their locality, so there is no windowed expert to switch to."""
    with pytest.raises(ValueError) as ref_err:
        rsw.SwitchedDecoder(RModel(r_get_config(GEMMA2, reduced=True)))
    with pytest.raises(type(ref_err.value), match="uniform attention pattern"):
        SwitchedDecoder(Model(get_config(GEMMA2, reduced=True)))


def test_whisper_windowed_expert_is_exact():
    """whisper's decode body attends over its cache with ``is_local`` left
    False, so the windowed expert (window 2, context 9) decodes the exact
    expert's bits, in the reference and in the port (ROADMAP.md Queue 3)."""
    tokens = _tokens(256, (2, 8), 3)
    frames = _frames(WHISPER, 2)
    rmodel = RModel(r_get_config(WHISPER, reduced=True))
    rp = rmodel.init(jax.random.PRNGKey(0))
    _, rc = rmodel.prefill(rp, jnp.asarray(tokens), rmodel.init_cache(2, 16, jnp.float32),
                           encoder_frames=jnp.asarray(frames))
    rdec = rsw.SwitchedDecoder(rmodel, rsw.SwitchedDecodeConfig(window=2))
    r_outs = [np.asarray(e.fn(None, rp, jnp.asarray(tokens[:, -1:]), rc))
              for e in rdec.bank.experts]
    np.testing.assert_array_equal(r_outs[0], r_outs[1])
    model = Model(get_config(WHISPER, reduced=True))
    params = model.init(jr.PRNGKey(0))
    _, cache = model.prefill(params, torch.as_tensor(tokens),
                             model.init_cache(2, 16, dtype=torch.float32, device="cpu"),
                             encoder_frames=torch.as_tensor(frames))
    dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=2))
    outs = [e.fn(None, params, torch.as_tensor(tokens[:, -1:]), cache) for e in dec.bank.experts]
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), r_outs[0], **LOGIT_TOL)
