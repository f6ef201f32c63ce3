"""The side LM stack's dense family against ``repro``: the three reduced
configs (granite-20b's MQA + GELU MLP, command-r-plus's parallel block with
layernorm, qwen1.5's QKV bias) with ``repro``'s weights converted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as rL
from repro.models.config import get_config as r_get_config
from repro.models.model import Model as RModel
from repro_torch import random as jr
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import Family, Model, get_config
from repro_torch.models import layers as tL
from repro_torch.models import params as tparams

torch.set_num_threads(1)

ARCHS = ["granite-20b", "command-r-plus-104b", "qwen1.5-110b"]
#: float32 logits on identical weights: the same einsums summed in another
#: order (XLA against oneDNN) through 2 layers and the head; logits are O(1)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-6)
#: a float32 mean of log-softmax terms
LOSS_RTOL = 1e-6
#: init from one seed: normals within 3 ulp (test_torch_random), one float32
#: scale multiply
INIT_TOL = dict(rtol=1e-6, atol=1e-9)


def _ref_params(arch, seed=0, cfg=None):
    """``repro``'s weights with every zero-initialised leaf (norms, QKV biases)
    drawn too, so those paths are compared and not just their zeros."""
    cfg = cfg or r_get_config(arch, reduced=True)
    params = RModel(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) if np.asarray(x).any()
        else rng.normal(scale=0.3, size=x.shape).astype(np.float32), params)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_n_params(arch):
    rcfg, tcfg = r_get_config(arch, reduced=True), get_config(arch, reduced=True)
    rmodel, tmodel = RModel(rcfg), Model(tcfg)
    rp = _ref_params(arch)
    tp = lm_params_from_reference(rp)
    tokens, labels = _tokens(rcfg.vocab, (2, 12)), _tokens(rcfg.vocab, (2, 12), 1)
    want = np.asarray(rmodel.forward(jax.tree.map(jnp.asarray, rp), jnp.asarray(tokens)).logits)
    got = tmodel.forward(tp, torch.as_tensor(tokens)).logits
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    want_loss = float(rmodel.loss(jax.tree.map(jnp.asarray, rp), jnp.asarray(tokens),
                                  jnp.asarray(labels)))
    got_loss = float(tmodel.loss(tp, torch.as_tensor(tokens), torch.as_tensor(labels)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert tmodel.n_params() == rmodel.n_params()
    full_r, full_t = r_get_config(arch), get_config(arch)
    assert full_t.n_params() == full_r.n_params()
    assert full_t.param_dtype() is torch.bfloat16


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_against_reference(arch, window):
    """Prefill 6 tokens, then decode 5 one at a time: logits and the filled
    cache against ``repro``'s, with and without a uniform sliding window."""
    rcfg = r_get_config(arch, reduced=True).with_(sliding_window=window)
    tcfg = get_config(arch, reduced=True).with_(sliding_window=window)
    rmodel, tmodel = RModel(rcfg), Model(tcfg)
    rp = _ref_params(arch)
    rpj, tp = jax.tree.map(jnp.asarray, rp), lm_params_from_reference(rp)
    tokens = _tokens(rcfg.vocab, (2, 11), 2)
    rc = rmodel.init_cache(2, 16, dtype=jnp.float32)
    tc = tmodel.init_cache(2, 16, dtype=torch.float32, device="cpu")
    rl, rc = rmodel.prefill(rpj, jnp.asarray(tokens[:, :6]), rc)
    tl, tc = tmodel.prefill(tp, torch.as_tensor(tokens[:, :6]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **LOGIT_TOL)
    for t in range(6, 11):
        rl, rc = rmodel.decode_step(rpj, jnp.asarray(tokens[:, t:t + 1]), rc)
        tl, tc = tmodel.decode_step(tp, torch.as_tensor(tokens[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **LOGIT_TOL)
        assert int(tc["index"]) == int(rc["index"]) == t + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode through the cache == the full forward's logits,
    within the port (the reference's own consistency test, at float32)."""
    cfg = get_config(arch, reduced=True)
    model = Model(cfg)
    params = model.init(jr.PRNGKey(0))
    tokens = torch.as_tensor(_tokens(cfg.vocab, (2, 10), 3))
    full = model.forward(params, tokens).logits
    cache = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
    logits, cache = model.prefill(params, tokens[:, :6], cache)
    torch.testing.assert_close(logits, full[:, 5], rtol=1e-5, atol=1e-6)
    for t in range(6, 10):
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
        torch.testing.assert_close(logits, full[:, t], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_from_one_seed(arch):
    want = RModel(r_get_config(arch, reduced=True)).init(jax.random.PRNGKey(7))
    got = Model(get_config(arch, reduced=True)).init(jr.PRNGKey(7))
    pairs = jax.tree.leaves(jax.tree.map(lambda a, b: (np.asarray(a), b.numpy()), want, got),
                            is_leaf=lambda x: isinstance(x, tuple))
    assert len(pairs) == len(jax.tree.leaves(want))
    for a, b in pairs:
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(b, a, **INIT_TOL)


def test_chunked_draw_is_one_draw(monkeypatch):
    """A leaf drawn in chunks of the flat index has the bits of one draw
    (the full-width weights are drawn so on the card)."""
    cfg = get_config("granite-20b", reduced=True)
    whole = Model(cfg).init(jr.PRNGKey(5))
    monkeypatch.setattr(tparams, "DRAW_CHUNK", 1000)
    chunked = Model(cfg).init(jr.PRNGKey(5))
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), whole)),
                    jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), chunked))):
        np.testing.assert_array_equal(a, b)
    bf16 = Model(cfg).init(jr.PRNGKey(5), dtype=torch.bfloat16)
    assert bf16["embed"].dtype is torch.bfloat16
    assert torch.equal(bf16["embed"], whole["embed"].to(torch.bfloat16))


@pytest.mark.parametrize("shape,lo,hi", [((4, 16), 0, 256), ((8, 128), 0, 49152),
                                         ((7,), -5, 1000), ((3, 3), 9, 9)])
def test_randint_bitwise(shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(1), shape, lo, hi))
    got = jr.randint(jr.PRNGKey(1), shape, lo, hi)
    assert got.dtype is torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None)])
def test_chunked_attention(causal, window):
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 12, 3, 8)).astype(np.float32) for _ in range(3))
    want = np.asarray(rL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, window=window, kv_chunk=4))
    got = tL.chunked_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                               causal=causal, window=window, kv_chunk=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_unported_families_raise():
    """The families and configs of the LM stack's training half name the queue."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        get_config("gemma2-9b", reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        Model(get_config("granite-20b", reduced=True).with_(family=Family.MOE)).defs()
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        Model(get_config("granite-20b", reduced=True).with_(local_global_pattern=True)).defs()
    with pytest.raises(ValueError):
        get_config("no-such-arch")


#: attention on float32 operands: the same einsums and softmax in another
#: order (XLA against oneDNN); outputs are O(1)
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
#: bf16 operands: both packages round every op's float32 result to bf16 (the
#: same bits on an x86 CPU); an exp or a sum landing apart may move an
#: O(1) output by one bf16 ulp (2^-8)
ATTN_BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scores_bf16", [False, True], ids=["f32_scores", "bf16_scores"])
def test_dot_attention(scores_bf16, dtype):
    """Both score paths (float32 softmax; ``scores_bf16``, the scores kept in
    the query's dtype with float32 row sums) with a causal mask and a softcap,
    on float32 and on bf16 operands, against ``repro``'s."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(2, 6, 3, 8)).astype(np.float32) for _ in range(3))
    mask = np.tril(np.ones((6, 6), bool))[None, None]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = rL.dot_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(mask),
                            softcap=30.0, scores_bf16=scores_bf16)
    got = tL.dot_attention(*(torch.as_tensor(a).to(tdt) for a in (q, k, v)),
                           torch.as_tensor(mask), softcap=30.0, scores_bf16=scores_bf16)
    assert got.dtype is tdt
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **(ATTN_TOL if dtype == "float32" else ATTN_BF16_TOL))


def test_rope_mrope_and_sinusoidal_positions():
    """RoPE and M-RoPE (three position streams over (4, 2, 2) frequency
    bands) against ``repro``'s, within float32 sin/cos; the sinusoidal table
    bitwise (numpy in both)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (3, 2, 5)).astype(np.int32)
    want = rL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 2, 2), theta=1e4)
    got = tL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), (4, 2, 2), theta=1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    want = rL.apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), theta=1e4)
    got = tL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[0]), theta=1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    with pytest.raises(ValueError):
        tL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), (4, 2, 1))
    np.testing.assert_array_equal(tL.sinusoidal_positions(7, 12),
                                  rL.sinusoidal_positions(7, 12))


@pytest.mark.parametrize("variant", [dict(mrope_sections=(4, 2, 2)),
                                     dict(attn_scores_bf16=True)],
                         ids=["mrope", "scores_bf16"])
def test_config_variants_against_reference(variant):
    """The dense model's M-RoPE branch (text-only positions, t = h = w) and
    its ``attn_scores_bf16`` preset, through forward, prefill and decode on
    the reduced granite-20b (float32 weights), against ``repro``'s."""
    rcfg = r_get_config("granite-20b", reduced=True).with_(**variant)
    tcfg = get_config("granite-20b", reduced=True).with_(**variant)
    rmodel, tmodel = RModel(rcfg), Model(tcfg)
    rp = _ref_params("granite-20b")
    rpj, tp = jax.tree.map(jnp.asarray, rp), lm_params_from_reference(rp)
    tokens = _tokens(rcfg.vocab, (2, 9), 4)
    want = np.asarray(rmodel.forward(rpj, jnp.asarray(tokens)).logits)
    np.testing.assert_allclose(tmodel.forward(tp, torch.as_tensor(tokens)).logits.numpy(),
                               want, **LOGIT_TOL)
    rc = rmodel.init_cache(2, 16, dtype=jnp.float32)
    tc = tmodel.init_cache(2, 16, dtype=torch.float32, device="cpu")
    rl, rc = rmodel.prefill(rpj, jnp.asarray(tokens[:, :5]), rc)
    tl, tc = tmodel.prefill(tp, torch.as_tensor(tokens[:, :5]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **LOGIT_TOL)
    for t in range(5, 9):
        rl, rc = rmodel.decode_step(rpj, jnp.asarray(tokens[:, t:t + 1]), rc)
        tl, tc = tmodel.decode_step(tp, torch.as_tensor(tokens[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **LOGIT_TOL)
