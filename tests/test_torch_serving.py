"""The ARCHES-switched LM decoder and the serving engine against ``repro``
(the port of ``tests/test_serving.py``'s switched tests), the switch at
every element size against ``repro``'s switch, and the bank's byte cost
model against ``repro``'s bank.  Reduced granite-20b, float32, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expert_bank as rbank
from repro.core.dapp import DApp as RDApp
from repro.core.e3 import E3Agent as RAgent
from repro.core.e3 import E3Manager as RManager
from repro.core.runtime import ArchesRuntime as RRuntime
from repro.kernels.switch_select import ops as rsw
from repro.models.config import get_config as r_get_config
from repro.models.model import Model as RModel
from repro.serving.engine import ServingEngine as REngine
from repro.serving.switched import SwitchedDecodeConfig as RConfig
from repro.serving.switched import SwitchedDecoder as RDecoder
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import expert_bank as tbank
from repro_torch.core.dapp import DApp
from repro_torch.core.e3 import E3Agent, E3Manager
from repro_torch.core.runtime import ArchesRuntime
from repro_torch.kernels.switch_select import switch_scatter, switch_select
from repro_torch.models import Model, get_config
from repro_torch.serving import (
    SERVING_KPMS,
    ServingEngine,
    SwitchedDecodeConfig,
    SwitchedDecoder,
)

torch.set_num_threads(1)

RCFG, TCFG = r_get_config("granite-20b", reduced=True), get_config("granite-20b", reduced=True)
#: float32 logits on identical weights, summed in another order (XLA against
#: oneDNN) through 2 layers and the head; logits are O(1)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-6)
#: the KPMs: float32 means over the batch of sums over the vocabulary of
#: those logits' log-softmax; the KL is a difference of nearly equal terms,
#: so it takes an absolute floor
KPM_TOL = {"entropy": dict(rtol=1e-5, atol=1e-6), "expert_kl": dict(rtol=1e-3, atol=1e-6),
           "expert_agree": dict(rtol=0, atol=0), "cache_occupancy": dict(rtol=0, atol=0)}


@pytest.fixture(scope="module")
def models():
    rmodel, tmodel = RModel(RCFG), Model(TCFG)
    rp = rmodel.init(jax.random.PRNGKey(0))
    return rmodel, rp, tmodel, lm_params_from_reference(jax.tree.map(np.asarray, rp))


def _prefilled(models, batch, max_seq, tokens):
    rmodel, rp, tmodel, tp = models
    _, rc = rmodel.prefill(rp, jnp.asarray(tokens), rmodel.init_cache(batch, max_seq))
    _, tc = tmodel.prefill(tp, torch.as_tensor(tokens),
                           tmodel.init_cache(batch, max_seq, dtype=torch.bfloat16,
                                              device="cpu"))
    return rc, tc


def _check_kpms(got, want):
    for k in SERVING_KPMS:
        np.testing.assert_allclose(got[k], want[k], **KPM_TOL[k])
    for k in ("exact_cost_bytes", "windowed_cost_bytes"):
        assert got[k] == want[k]


def test_window_covering_the_context_equals_exact(models):
    """window >= context: both experts see the same KV -> the same logits."""
    rmodel, rp, tmodel, tp = models
    tokens = np.ones((2, 8), np.int32)
    rc, tc = _prefilled(models, 2, 32, tokens)
    dec = SwitchedDecoder(tmodel, SwitchedDecodeConfig(window=64))
    rdec = RDecoder(rmodel, RConfig(window=64))
    tok = np.ones((2, 1), np.int32)
    l0, c0, k0 = dec.step(0, tp, torch.as_tensor(tok), tc)
    l1, _, k1 = dec.step(1, tp, torch.as_tensor(tok), tc)
    torch.testing.assert_close(l0, l1, rtol=0, atol=0)
    assert k0["expert_agree"] == 1.0 and k0["expert_kl"] == 0.0
    rl, _, rk = rdec.step(0, rp, jnp.asarray(tok), rc)
    np.testing.assert_allclose(l0.numpy(), np.asarray(rl), **LOGIT_TOL)
    _check_kpms(k0, rk)
    assert int(c0["index"]) == 9


@pytest.mark.parametrize("mode", [0, 1])
def test_switched_kpms_against_reference(models, mode):
    rmodel, rp, tmodel, tp = models
    tokens = np.random.default_rng(1).integers(0, RCFG.vocab, (3, 9)).astype(np.int32)
    rc, tc = _prefilled(models, 3, 32, tokens)
    dec = SwitchedDecoder(tmodel, SwitchedDecodeConfig(window=4))
    rdec = RDecoder(rmodel, RConfig(window=4))
    nxt = tokens[:, -1:]
    got_l, got_c, got_k = dec.step(mode, tp, torch.as_tensor(nxt), tc)
    want_l, want_c, want_k = rdec.step(mode, rp, jnp.asarray(nxt), rc)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **LOGIT_TOL)
    _check_kpms(got_k, want_k)
    assert 0.0 < got_k["cache_occupancy"] <= 1.0
    assert got_k["exact_cost_bytes"] > got_k["windowed_cost_bytes"]
    np.testing.assert_allclose(got_c["k"].float().numpy(), np.asarray(want_c["k"], np.float32),
                               rtol=1e-2, atol=1e-2)


def test_selected_only(models):
    rmodel, rp, tmodel, tp = models
    tokens = np.ones((2, 8), np.int32)
    rc, tc = _prefilled(models, 2, 32, tokens)
    dec = SwitchedDecoder(tmodel, SwitchedDecodeConfig(
        window=4, execution_mode=tbank.ExecutionMode.SELECTED_ONLY))
    rdec = RDecoder(rmodel, RConfig(window=4,
                                    execution_mode=rbank.ExecutionMode.SELECTED_ONLY))
    tok = np.ones((2, 1), np.int32)
    logits, _, kpms = dec.step(1, tp, torch.as_tensor(tok), tc)
    rl, _, rk = rdec.step(1, rp, jnp.asarray(tok), rc)
    assert tuple(logits.shape) == (2, TCFG.vocab)
    assert kpms["expert_kl"] == 0.0 and kpms["expert_agree"] == 1.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), **LOGIT_TOL)
    _check_kpms(kpms, rk)
    assert dec.bank.bytes_for(1) == kpms["windowed_cost_bytes"]


def test_per_sequence_modes_select_rows_bitwise(models):
    """A (batch,) mode vector routes each sequence's logits row to its
    expert: the rows are the chosen expert's, bitwise."""
    rmodel, rp, tmodel, tp = models
    b = 3
    tokens = np.random.default_rng(5).integers(0, RCFG.vocab, (b, 6)).astype(np.int32)
    rc, tc = _prefilled(models, b, 16, tokens)
    dec = SwitchedDecoder(tmodel, SwitchedDecodeConfig(window=4))
    nxt = torch.as_tensor(tokens[:, -1:])
    l_exact, _, _ = dec.step(0, tp, nxt, tc)
    l_win, _, _ = dec.step(1, tp, nxt, tc)
    lv, _, kv = dec.step(torch.tensor([0, 1, 0], dtype=torch.int32), tp, nxt, tc)
    assert torch.equal(lv[0], l_exact[0]) and torch.equal(lv[2], l_exact[2])
    assert torch.equal(lv[1], l_win[1])
    want, _, rk = RDecoder(rmodel, RConfig(window=4)).step(
        jnp.asarray([0, 1, 0], jnp.int32), rp, jnp.asarray(tokens[:, -1:]), rc)
    np.testing.assert_allclose(lv.numpy(), np.asarray(want), **LOGIT_TOL)
    _check_kpms(kv, rk)


def test_expert_calls_leave_their_cache_alone(models):
    """Three ``decode_step`` calls a switched step: none writes the cache it
    is given (the update is out of place, as the reference's)."""
    _, _, tmodel, tp = models
    tokens = np.ones((2, 8), np.int32)
    _, tc = _prefilled(models, 2, 16, tokens)
    kept = {k: v.clone() for k, v in tc.items()}
    dec = SwitchedDecoder(tmodel, SwitchedDecodeConfig(window=4))
    tok = torch.ones((2, 1), dtype=torch.int32)
    for e in dec.bank.experts:
        e.fn(None, tp, tok, tc)
        assert all(torch.equal(tc[k], kept[k]) for k in kept)
    _, new, _ = dec.step(0, tp, tok, tc)
    assert all(torch.equal(tc[k], kept[k]) for k in kept)
    assert not torch.equal(new["k"], tc["k"]) and int(new["index"]) == 9


def test_rejects_local_global():
    with pytest.raises(ValueError):
        SwitchedDecoder(Model(TCFG.with_(local_global_pattern=True, sliding_window=4)))


def test_generate_against_reference(models):
    rmodel, rp, tmodel, tp = models
    prompts = np.random.default_rng(2).integers(0, RCFG.vocab, (2, 8)).astype(np.int32)
    want = REngine(rmodel, rp, max_seq=64).generate(jnp.asarray(prompts), 6).tokens
    eng = ServingEngine(tmodel, tp, max_seq=64)
    got = eng.generate(torch.as_tensor(prompts), 6).tokens
    again = eng.generate(torch.as_tensor(prompts), 6).tokens
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, again)
    np.testing.assert_array_equal(got, np.asarray(want))
    sampled = eng.generate(torch.as_tensor(prompts), 4,
                           sample=lambda l: torch.argmin(l, dim=-1)).tokens
    assert sampled.shape == (2, 4) and not np.array_equal(sampled, got[:, :4])


def _policy(x):
    # prefer exact attention (mode 0) when the experts disagree
    return 0 if x[0] > 1e-4 else 1


def _wire(agent, dapp, manager_cls):
    """A dApp subscribed to the decoder's ``serving`` KPMs.  (``connect_dapp``
    subscribes to the PHY's ``aerial`` and ``oai`` sources only, in both
    packages, so through it the serving loop never decides and stays on the
    fail-safe expert; ``test_generate_switched_against_reference`` holds that.)"""
    manager = manager_cls(agent)

    def on_indication(msg):
        decision = dapp.on_indication(msg)
        if decision is not None:
            manager.send_mode(decision.slot, decision.mode)

    manager.setup(on_indication, sources=("serving",))


def test_switched_runtime_loop_against_reference(models):
    """The full ARCHES loop over decode slots, the dApp on the serving KPMs:
    the same modes and tokens as ``repro``'s loop, and it really switches."""
    rmodel, rp, tmodel, tp = models
    dec = SwitchedDecoder(tmodel, SwitchedDecodeConfig(window=16))
    rdec = RDecoder(rmodel, RConfig(window=16))
    prompts = np.random.default_rng(3).integers(0, RCFG.vocab, (2, 24)).astype(np.int32)
    rc, tc = _prefilled(models, 2, 64, prompts)

    agent, ragent = E3Agent(), RAgent()
    _wire(agent, DApp(_policy, ["expert_kl"], window_slots=1), E3Manager)
    _wire(ragent, RDApp(_policy, ["expert_kl"], window_slots=1), RManager)
    kw = dict(default_mode=1, fail_safe_mode=1, ttl_slots=8, keep_outputs=True)
    hist = ArchesRuntime(dec.make_slot_fn(tp), agent, **kw).run(
        range(6), carry=(torch.ones((2, 1), dtype=torch.int32), tc))
    rhist = RRuntime(rdec.make_slot_fn(rp), ragent, **kw).run(
        range(6), carry=(jnp.ones((2, 1), jnp.int32), rc))
    assert len(hist.records) == 6 and hist.modes[0] == 1
    np.testing.assert_array_equal(hist.modes, rhist.modes)
    assert set(hist.modes.tolist()) == {0, 1}  # the loop really switched
    for r, w in zip(hist.records, rhist.records):
        np.testing.assert_array_equal(r.output.numpy(), np.asarray(w.output))
        assert "entropy" in r.kpms


def test_generate_switched_against_reference(models):
    """``generate_switched`` over the port's runtime: the same tokens and modes
    as ``repro``'s (through ``connect_dapp``, on the fail-safe expert)."""
    rmodel, rp, tmodel, tp = models
    dec = SwitchedDecoder(tmodel, SwitchedDecodeConfig(window=16))
    rdec = RDecoder(rmodel, RConfig(window=16))
    prompts = np.random.default_rng(3).integers(0, RCFG.vocab, (2, 24)).astype(np.int32)
    gen = ServingEngine(tmodel, tp, max_seq=64).generate_switched(
        torch.as_tensor(prompts), 5, decoder=dec,
        dapp=DApp(_policy, ["expert_kl"], window_slots=1))
    rgen = REngine(rmodel, rp, max_seq=64).generate_switched(
        jnp.asarray(prompts), 5, decoder=rdec,
        dapp=RDApp(_policy, ["expert_kl"], window_slots=1))
    assert gen.tokens.shape == (2, 5)
    np.testing.assert_array_equal(gen.tokens, np.asarray(rgen.tokens))
    np.testing.assert_array_equal(gen.history.modes, rgen.history.modes)
    assert set(gen.history.modes.tolist()) == {1}


# -- the switch at every element size, against repro's ----------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int32", "float32"])
@pytest.mark.parametrize("per_ue", [48, 5])
def test_switch_every_element_size_against_reference(dtype, per_ue):
    """The plain versions (the CPU route) against ``repro``'s switch, scalar,
    per-UE and scatter, bitwise, at 2- and 4-byte elements.  (float64 and
    int64 need JAX's x64 mode, off here; the card's tests hold them against
    the plain versions.)"""
    rng = np.random.default_rng(per_ue)
    outs = [rng.normal(size=(6, per_ue)) * 1000 for _ in range(3)]
    jouts = [jnp.asarray(o, dtype) for o in outs]
    touts = [torch.as_tensor(np.asarray(o.astype(np.float32))).to(getattr(torch, dtype))
             for o in outs]
    for a, b in zip(jouts, touts):  # the same values on both sides
        np.testing.assert_array_equal(np.asarray(a, np.float64), b.double().numpy())
    modes = np.asarray([2, 0, 1, 1, 0, 2], np.int32)

    def same(t, j):
        np.testing.assert_array_equal(t.double().numpy(), np.asarray(j, np.float64))
        assert str(t.dtype).split(".")[-1] == str(j.dtype)

    same(switch_select(torch.as_tensor(modes), touts), rsw.switch_select(
        jnp.asarray(modes), jouts))
    for m in (0, 2):
        same(switch_select(m, [t.clone() for t in touts]),
             rsw.switch_select(jnp.asarray(m, jnp.int32), jouts))
    src = np.asarray([1, -1, 0, -1, 1, 0], np.int32)
    same(switch_scatter(torch.as_tensor(src), touts[1][:2].contiguous(), touts[0]),
         rsw.switch_scatter(jnp.asarray(src), jouts[1][:2], jouts[0]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64])
def test_switch_plain_versions_at_eight_bytes(dtype):
    """8-byte real leaves through the CPU route against a numpy gather."""
    rng = np.random.default_rng(0)
    outs = [torch.as_tensor(rng.integers(-2**40, 2**40, (5, 7))).to(dtype) for _ in range(2)]
    modes = np.asarray([1, 0, 1, 1, 0], np.int32)
    got = switch_select(torch.as_tensor(modes), outs)
    want = np.where(modes[:, None] == 1, outs[1].numpy(), outs[0].numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(switch_select(1, [o.clone() for o in outs]), outs[1])


# -- the byte cost model -------------------------------------------------------------


def _banks(mode_name, **kw):
    experts = [(f"e{i}", float(10 * (i + 1)), float(1000 * (i + 1))) for i in range(3)]
    rb = rbank.ExpertBank([rbank.Expert(name=n, fn=lambda p, x: x, flops=f, bytes_hbm=b)
                           for n, f, b in experts],
                          execution_mode=getattr(rbank.ExecutionMode, mode_name), **kw)
    tb = tbank.ExpertBank([tbank.Expert(name=n, fn=lambda p, x: x, flops=f, bytes_hbm=b)
                           for n, f, b in experts],
                          execution_mode=getattr(tbank.ExecutionMode, mode_name), **kw)
    return rb, tb


def test_bytes_cost_model_against_reference():
    """``bytes_for`` and ``executed_bytes`` with ``repro``'s values and errors."""
    rb, tb = _banks("CONCURRENT")
    assert tb.bytes_for() == rb.bytes_for() == 6000.0
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    modes = np.asarray([0, 2, 1, 0], np.int32)
    rout, tout = rb(jnp.asarray(modes), jnp.asarray(x)), tb(torch.as_tensor(modes),
                                                             torch.as_tensor(x))
    assert float(tb.executed_bytes(tout)) == float(rb.executed_bytes(rout)) == 24000.0
    assert float(tb.executed_flops(tout)) == float(rb.executed_flops(rout))
    rb, tb = _banks("SELECTED_ONLY")
    for m in range(3):
        assert tb.bytes_for(m) == rb.bytes_for(m)
    assert float(tb.executed_bytes(tb(2, torch.as_tensor(x)))) == \
        float(rb.executed_bytes(rb(jnp.asarray(2, jnp.int32), jnp.asarray(x))))
    with pytest.raises(ValueError):
        tb.bytes_for(None)
    with pytest.raises(AssertionError):
        rb.bytes_for(None)
    rb, tb = _banks("GATED", gated_capacity=2)
    for bank in (rb, tb):
        with pytest.raises(ValueError, match="executed_bytes"):
            bank.bytes_for()
    rout, tout = rb(jnp.asarray(modes), jnp.asarray(x)), tb(torch.as_tensor(modes),
                                                             torch.as_tensor(x))
    assert float(tb.executed_bytes(tout)) == float(rb.executed_bytes(rout))
    with pytest.raises(ValueError, match="executed_ue"):
        tb.executed_bytes(tbank.BankOutput(selected=None, all_outputs=None, mode=0))
