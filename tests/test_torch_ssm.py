"""The side LM stack's SSM, hybrid and VLM configs against ``repro``:
mamba2-130m (SSD), zamba2-7b (a mamba2 backbone with two groups and one
shared attention block every ``attn_every`` layers) and qwen2-vl-72b (the
dense blocks with M-RoPE), on their reduced configs with ``repro``'s
weights converted.  ``ssd_chunked`` at 1, 2 and 4 chunks and from an
initial state; ``mamba_block``'s prefill and decode caches, a prompt
shorter than the conv window included; forward, prefill and 4 decode steps
with every cache leaf; ``train_step``; the reference's teacher-forcing
check for mamba2; the parameter counts; a prompt that is no multiple of the
chunk raising; the switched decoder on an SSM cache."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as rtok
from repro.models import mamba2 as rmamba
from repro.models.config import get_config as r_get_config
from repro.models.model import Model as RModel
from repro.models.params import count_params as r_count_params
from repro.train import step as rstep
from repro_torch import random as jr
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import tokens as ttok
from repro_torch.models import Model, get_config
from repro_torch.models import mamba2 as tmamba
from repro_torch.models.transformer import layer
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving import SwitchedDecodeConfig, SwitchedDecoder
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ARCHS = ["mamba2-130m", "zamba2-7b", "qwen2-vl-72b"]
#: float32 logits on identical weights: the same einsums summed in another
#: order (XLA against oneDNN; the SSD's in-chunk prefix sum a product with a
#: triangular mask against XLA's cumsum); logits are O(1)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-6)
#: a float32 mean of log-softmax terms
LOSS_RTOL = 1e-6
#: the global gradient norm after a float32 backward summed in another order
GNORM_RTOL = 1e-5


def _ref_params(arch, seed=0):
    """``repro``'s weights with every zero-initialised leaf (norms, conv bias,
    ``a_log``, ``dt_bias``, QKV biases) drawn too, so those paths are compared
    and not just their zeros."""
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


@pytest.mark.parametrize("chunk,init", [(16, False), (8, False), (4, False), (8, True)],
                         ids=["1chunk", "2chunks", "4chunks", "2chunks_init"])
def test_ssd_chunked_against_reference(chunk, init):
    """The dual form over 16 positions, 4 heads in 2 groups, against
    ``repro``'s scan: the outputs and the final state."""
    rng = np.random.default_rng(5)
    b, s, h, p, g, n = 2, 16, 4, 3, 2, 5
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(scale=0.5, size=h)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, g, n)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    ssd = jax.jit(functools.partial(rmamba.ssd_chunked, chunk=chunk))
    y_r, st_r = ssd(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)),
                    init_state=None if h0 is None else jnp.asarray(h0))
    y_t, st_t = tmamba.ssd_chunked(*(torch.as_tensor(t) for t in (x, dt, a, bm, cm)),
                                   chunk=chunk,
                                   init_state=None if h0 is None else torch.as_tensor(h0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), **LOGIT_TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_r), **LOGIT_TOL)


@pytest.mark.parametrize("s", [16, 8, 2], ids=["2chunks", "1chunk", "short"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_mamba_block_caches_against_reference(arch, s):
    """One mixer over a prompt of ``s`` (2 is shorter than the conv window's
    3 positions: the conv state is left-padded), then one decode step from
    the prompt's caches: outputs and both cache leaves."""
    rcfg, tcfg = r_get_config(arch, reduced=True), get_config(arch, reduced=True)
    rp = _ref_params(arch, seed=4)["blocks"]["mixer"]
    rp0 = jax.tree.map(lambda t: jnp.asarray(t[0]), rp)
    tp0 = layer(lm_params_from_reference(rp), 0)
    u = np.random.default_rng(6).normal(size=(2, s + 1, rcfg.d_model)).astype(np.float32)
    r_block = jax.jit(lambda u, cache: rmamba.mamba_block(rcfg, rp0, u, cache=cache))
    y_r, c_r = r_block(jnp.asarray(u[:, :s]), None)
    y_t, c_t = tmamba.mamba_block(tcfg, tp0, torch.as_tensor(u[:, :s]))
    for got, want in ((y_t, y_r), (c_t.conv, c_r.conv), (c_t.ssm, c_r.ssm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    y_r, c_r = r_block(jnp.asarray(u[:, s:]), c_r)
    y_t, c_t = tmamba.mamba_block(tcfg, tp0, torch.as_tensor(u[:, s:]), cache=c_t)
    for got, want in ((y_t, y_r), (c_t.conv, c_r.conv), (c_t.ssm, c_r.ssm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    empty = tmamba.init_mamba_cache(tcfg, 2, dtype=torch.float32, device="cpu")
    want = rmamba.init_mamba_cache(rcfg, 2, dtype=jnp.float32)
    assert empty.conv.shape == want.conv.shape and empty.ssm.shape == want.ssm.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_n_params(arch):
    rcfg, tcfg = r_get_config(arch, reduced=True), get_config(arch, reduced=True)
    rmodel, tmodel = RModel(rcfg), Model(tcfg)
    rp = _ref_params(arch)
    rpj, tp = jax.tree.map(jnp.asarray, rp), lm_params_from_reference(rp)
    tokens, labels = _tokens(rcfg.vocab, (2, 16)), _tokens(rcfg.vocab, (2, 16), 1)
    want = jax.jit(rmodel.forward)(rpj, jnp.asarray(tokens))
    got = tmodel.forward(tp, torch.as_tensor(tokens))
    assert tuple(got.logits.shape) == want.logits.shape
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **LOGIT_TOL)
    assert float(got.aux_loss) == float(want.aux_loss) == 0.0
    want_loss = float(jax.jit(rmodel.loss)(rpj, jnp.asarray(tokens), jnp.asarray(labels)))
    got_loss = float(tmodel.loss(tp, torch.as_tensor(tokens), torch.as_tensor(labels)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert tmodel.n_params() == rmodel.n_params() == r_count_params(rmodel.defs())
    assert abs(tmodel.n_params() - tcfg.n_params()) / tmodel.n_params() < 0.02
    full_r, full_t = r_get_config(arch), get_config(arch)
    assert full_t.n_params() == full_r.n_params()
    assert full_t.subquadratic == full_r.subquadratic


@pytest.mark.parametrize("arch,window", [("mamba2-130m", None), ("zamba2-7b", None),
                                         ("zamba2-7b", 4), ("qwen2-vl-72b", None)])
def test_prefill_then_decode_against_reference(arch, window):
    """Prefill 8 tokens (one chunk), then 4 decode steps: logits and every
    cache leaf (conv, ssm, the shared block's K/V, index) against
    ``repro``'s; zamba2 also with a window on its shared block (the
    switched decoder's windowed expert)."""
    rcfg = r_get_config(arch, reduced=True).with_(sliding_window=window)
    tcfg = get_config(arch, reduced=True).with_(sliding_window=window)
    rmodel, tmodel = RModel(rcfg), Model(tcfg)
    rp = _ref_params(arch)
    rpj, tp = jax.tree.map(jnp.asarray, rp), lm_params_from_reference(rp)
    tokens = _tokens(rcfg.vocab, (2, 12), 2)
    rc = rmodel.init_cache(2, 16, dtype=jnp.float32)
    tc = tmodel.init_cache(2, 16, dtype=torch.float32, device="cpu")
    assert tc.keys() == rc.keys()
    rl, rc = jax.jit(rmodel.prefill)(rpj, jnp.asarray(tokens[:, :8]), rc)
    tl, tc = tmodel.prefill(tp, torch.as_tensor(tokens[:, :8]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **LOGIT_TOL)
    r_decode = jax.jit(rmodel.decode_step)
    for t in range(8, 12):
        rl, rc = r_decode(rpj, jnp.asarray(tokens[:, t:t + 1]), rc)
        tl, tc = tmodel.decode_step(tp, torch.as_tensor(tokens[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **LOGIT_TOL)
        for name in rc:
            assert tuple(tc[name].shape) == rc[name].shape
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]), **LOGIT_TOL)
        assert int(tc["index"]) == t + 1


def test_bf16_state_rounding_against_reference():
    """bf16 weights and a float32 cache, as the serving engine builds it: the
    block rounds its states to bf16 every step (the reference's casts), so
    the cache holds bf16 values; prefill and 2 decode steps on mamba2."""
    arch = "mamba2-130m"
    rcfg = r_get_config(arch, reduced=True).with_(dtype="bfloat16")
    tcfg = get_config(arch, reduced=True).with_(dtype="bfloat16")
    rmodel, tmodel = RModel(rcfg), Model(tcfg)
    rp = jax.tree.map(lambda t: jnp.asarray(t, jnp.bfloat16), _ref_params(arch))
    tp = lm_params_from_reference(rp)
    tokens = _tokens(rcfg.vocab, (2, 10), 3)
    rc, tc = (rmodel.init_cache(2, 16, dtype=jnp.float32),
              tmodel.init_cache(2, 16, dtype=torch.float32, device="cpu"))
    rl, rc = rmodel.prefill(rp, jnp.asarray(tokens[:, :8]), rc)
    tl, tc = tmodel.prefill(tp, torch.as_tensor(tokens[:, :8]), tc)
    for t in range(8, 10):
        rl, rc = rmodel.decode_step(rp, jnp.asarray(tokens[:, t:t + 1]), rc)
        tl, tc = tmodel.decode_step(tp, torch.as_tensor(tokens[:, t:t + 1]), tc)
    for name in ("conv", "ssm"):
        assert tc[name].dtype is torch.float32
        for c in (tc[name], torch.as_tensor(np.array(rc[name]))):
            assert torch.equal(c, c.to(torch.bfloat16).to(torch.float32))
        _assert_rel_l2(tc[name], rc[name], BF16_REL)
    _assert_rel_l2(tl.to(torch.float32), rl.astype(jnp.float32), BF16_REL)


#: bf16 activations through two mixers and 2 decode steps, rounded op by op in
#: another order (XLA fuses elementwise chains in float32): relative L2 error
#: of the states and logits; read 1.2e-2 at most
BF16_REL = 3e-2


def _assert_rel_l2(got, want, limit):
    want = np.asarray(want, np.float32)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= limit, rel


def test_mamba2_decode_matches_forward():
    """The reference's teacher-forcing check (``tests/test_serving.py``) on
    the port: a bf16 cache, prefill 4 tokens, decode 4, against the full
    forward's logits at its tolerance."""
    cfg = get_config("mamba2-130m", reduced=True)
    model = Model(cfg)
    params = model.init(jr.PRNGKey(2))
    tokens = jr.randint(jr.PRNGKey(3), (1, 8), 0, cfg.vocab)
    full = model.forward(params, tokens).logits.to(torch.float32)
    cache = model.init_cache(1, 16, device="cpu")
    logits, cache = model.prefill(params, tokens[:, :4], cache)
    torch.testing.assert_close(logits, full[:, 3], rtol=3e-2, atol=3e-2)
    for t in range(4, 8):
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
        torch.testing.assert_close(logits, full[:, t], rtol=3e-2, atol=3e-2)


def test_prompt_not_a_multiple_of_the_chunk_raises():
    """A prompt of 130 on the reduced mamba2 (chunk 8): ``repro`` asserts, the
    port raises ``ValueError``; 128 (16 chunks) runs in both."""
    arch = "mamba2-130m"
    rmodel, tmodel = RModel(r_get_config(arch, reduced=True)), Model(get_config(arch, reduced=True))
    rp = _ref_params(arch)
    rpj, tp = jax.tree.map(jnp.asarray, rp), lm_params_from_reference(rp)
    tokens = _tokens(256, (1, 130), 4)
    with pytest.raises(AssertionError):
        rmodel.forward(rpj, jnp.asarray(tokens))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tmodel.forward(tp, torch.as_tensor(tokens))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tmodel.prefill(tp, torch.as_tensor(tokens),
                       tmodel.init_cache(1, 256, dtype=torch.float32, device="cpu"))
    got = tmodel.forward(tp, torch.as_tensor(tokens[:, :128])).logits
    assert bool(torch.isfinite(got).all())


def test_switched_decoder_on_ssm_caches():
    """mamba2 has no attention, so both experts give the same bits (the
    reference's behaviour) and the step reads an SSM cache; zamba2's shared
    block windows in the windowed expert, so there they differ."""
    for arch, same in (("mamba2-130m", True), ("zamba2-7b", False)):
        model = Model(get_config(arch, reduced=True))
        params = model.init(jr.PRNGKey(0))
        dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=2))
        prompts = torch.as_tensor(_tokens(model.cfg.vocab, (2, 8), 3))
        _, cache = model.prefill(params, prompts, model.init_cache(2, 16, dtype=torch.float32,
                                                                   device="cpu"))
        outs = [e.fn(None, params, prompts[:, -1:], cache) for e in dec.bank.experts]
        assert torch.equal(outs[0], outs[1]) == same, arch
        logits, new_cache, kpms = dec.step(torch.tensor([1, 0], dtype=torch.int32), params,
                                           prompts[:, -1:], cache)
        assert torch.equal(logits[0], outs[1][0]) and torch.equal(logits[1], outs[0][1])
        want_occ = 9 / 16 if "k" in cache else 9.0
        assert kpms["cache_occupancy"] == want_occ and int(new_cache["index"]) == 9
        if same:
            assert kpms["expert_kl"] == 0.0 and kpms["expert_agree"] == 1.0


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


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_remat_same_bits(arch):
    """Rematerialised mamba blocks give the loss and every gradient of
    ``remat="none"`` at 0 ulp (zamba2's shared block runs outside the remat,
    as in the reference)."""
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
