"""The port's AdamW, its quantized moments, the global-norm clip and the
warmup-cosine schedule against ``repro.optim`` on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro.optim.schedule import warmup_cosine as r_warmup_cosine
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import warmup_cosine

torch.set_num_threads(1)

#: the same float32 formulas on the same inputs; the two libraries' ``pow``
#: (bias corrections) and fused multiply-adds may differ by an ulp a step
ADAM_RTOL = 1e-6
#: a sum of squares over every leaf, reduced in another order
NORM_RTOL = 1e-6
#: float32 ``cos`` in two libraries: an ulp or two
SCHED_RTOL = 1e-6

SHAPES = {"w": (3, 130), "b": (7,), "res": [(2, 2, 3, 3), (4,)]}


def _tree(rng, scale=1.0):
    return {"w": rng.normal(size=SHAPES["w"]).astype(np.float32) * scale,
            "b": rng.normal(size=SHAPES["b"]).astype(np.float32) * scale,
            "res": [rng.normal(size=s).astype(np.float32) * scale for s in SHAPES["res"]]}


def _to_torch(tree):
    return {"w": torch.as_tensor(tree["w"]), "b": torch.as_tensor(tree["b"]),
            "res": [torch.as_tensor(x) for x in tree["res"]]}


def _to_jax(tree):
    return {"w": jnp.asarray(tree["w"]), "b": jnp.asarray(tree["b"]),
            "res": [jnp.asarray(x) for x in tree["res"]]}


def _nodes(tree):
    return [tree["w"], tree["b"], *tree["res"]]


def _flat(tree):
    leaves = _nodes(tree)
    return [np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                       np.asarray(x, np.float32)) for x in leaves]


def _run(cfg_kw, n_steps=5, lr=None, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, 0.1 * (k + 1)) for k in range(n_steps)]
    rcfg, tcfg = radamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    rp, tp = _to_jax(params), _to_torch(params)
    rs, ts = radamw.adamw_init(rp, rcfg), tadamw.adamw_init(tp, tcfg)
    for g in grads:
        rp, rs = radamw.adamw_update(_to_jax(g), rs, rp, rcfg, learning_rate=lr)
        tp, ts = tadamw.adamw_update(_to_torch(g), ts, tp, tcfg, learning_rate=lr)
    return rp, rs, tp, ts


@pytest.mark.parametrize("cfg_kw", [
    dict(learning_rate=1e-2),
    dict(learning_rate=3e-3, weight_decay=0.1),
    dict(learning_rate=1e-3, b1=0.8, b2=0.99, eps=1e-6),
], ids=["plain", "weight_decay", "betas"])
def test_adamw_fp32_five_steps(cfg_kw):
    rp, rs, tp, ts = _run(cfg_kw)
    assert int(ts.step) == int(rs.step) == 5
    for a, b in zip(_flat(tp), _flat(rp)):
        np.testing.assert_allclose(a, b, rtol=ADAM_RTOL, atol=0)
    for a, b in zip(_flat(ts.m), _flat(rs.m)):
        np.testing.assert_allclose(a, b, rtol=ADAM_RTOL, atol=1e-12)
    for a, b in zip(_flat(ts.v), _flat(rs.v)):
        np.testing.assert_allclose(a, b, rtol=ADAM_RTOL, atol=1e-14)


def test_adamw_learning_rate_override():
    """The per-call learning rate replaces the config's, as the reference's."""
    rp, _, tp, _ = _run(dict(learning_rate=1.0), n_steps=3, lr=2.5e-3)
    for a, b in zip(_flat(tp), _flat(rp)):
        np.testing.assert_allclose(a, b, rtol=ADAM_RTOL, atol=0)
    rp1, _, _, _ = _run(dict(learning_rate=1.0), n_steps=3)
    assert not np.allclose(_flat(rp1)[0], _flat(tp)[0])


def test_adamw_weight_decay_alone():
    """A zero gradient and weight decay: ``p * (1 - lr * wd)`` in float32."""
    cfg = tadamw.AdamWConfig(learning_rate=0.1, weight_decay=0.1)
    p = {"w": torch.tensor([10.0, -3.0])}
    new_p, _ = tadamw.adamw_update({"w": torch.zeros(2)}, tadamw.adamw_init(p, cfg), p, cfg)
    rcfg = radamw.AdamWConfig(learning_rate=0.1, weight_decay=0.1)
    rp = {"w": jnp.asarray([10.0, -3.0])}
    want, _ = radamw.adamw_update({"w": jnp.zeros(2)}, radamw.adamw_init(rp, rcfg), rp, rcfg)
    np.testing.assert_array_equal(new_p["w"].numpy(), np.asarray(want["w"]))


def test_quantized_moments_against_reference():
    """int8 block-absmax ``m`` payload and bf16 ``v`` bitwise, the block
    scales within 1e-6 relative, after 5 steps over leaves that end in a
    partial 128-element block."""
    cfg = dict(learning_rate=1e-2, quantize_moments=True)
    rp, rs, tp, ts = _run(cfg)
    for tq, rq in zip(_nodes(ts.m), _nodes(rs.m)):
        assert tq.q.dtype == torch.int8
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(rq.q))
        np.testing.assert_allclose(tq.scale.numpy(), np.asarray(rq.scale), rtol=1e-6, atol=0)
    for tv, rv in zip(_nodes(ts.v), _nodes(rs.v)):
        assert tv.dtype == torch.bfloat16
        np.testing.assert_array_equal(tv.view(torch.int16).numpy(),
                                      np.asarray(rv).view(np.int16))
    for a, b in zip(_flat(tp), _flat(rp)):
        np.testing.assert_allclose(a, b, rtol=ADAM_RTOL, atol=0)


def test_moments_are_independent_tensors():
    p = {"w": torch.zeros(5)}
    s = tadamw.adamw_init(p, tadamw.AdamWConfig())
    assert s.m["w"].data_ptr() != s.v["w"].data_ptr()


@pytest.mark.parametrize("max_norm", [1.0, 100.0, 1e-3])
def test_global_norm_clip(max_norm):
    rng = np.random.default_rng(3)
    g = _tree(rng, 2.0)
    rc, rn = radamw.global_norm_clip(_to_jax(g), max_norm)
    tc, tn = tadamw.global_norm_clip(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(rn), rtol=NORM_RTOL)
    for a, b in zip(_flat(tc), _flat(rc)):
        np.testing.assert_allclose(a, b, rtol=NORM_RTOL, atol=1e-12)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 37, 55, 99, 100, 150])
def test_warmup_cosine(step):
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=100, final_frac=0.1)
    got = warmup_cosine(step, **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(r_warmup_cosine(step, **kw)),
                               rtol=SCHED_RTOL, atol=0)
