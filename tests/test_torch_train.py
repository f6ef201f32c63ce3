"""The LM stack's training half against ``repro``: the token stream and the
gradient compression bitwise, ``train_step`` over 3 steps (plain,
microbatched, quantized moments, compressed gradients) on
``granite-20b``'s reduced config, rematerialisation at 0 ulp, the
fault-tolerant loop's restart bitwise, and the launcher's CLI: its
``--mesh`` plans, whisper's missing frames, gemma2's training.

``repro``'s step runs under one ``jax.jit`` per configuration, compiled once
for the module; the restart is held against the port's own uninterrupted run.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.data import tokens as rtok
from repro.distributed import compression as rcomp
from repro.models import config as rconfig
from repro.models.model import Model as RModel
from repro.train import step as rstep
from repro_torch import random as jr
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import tokens as ttok
from repro_torch.distributed import compression as tcomp
from repro_torch.launch import train as tlaunch
from repro_torch.models import Family, Model, get_config
from repro_torch.models import config as tconfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import FailureInjector, InjectedFailure, run_training
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-20b"
#: the steps' losses and gradient norms: float32 forward and backward on
#: the same weights and batches, summed in another order (XLA against
#: oneDNN), through 2 layers and the head; read 1.8e-07 relative at most
METRIC_RTOL = 1e-6
#: the weights after 3 AdamW steps at lr 1e-3: a gradient component near 0
#: that lands an ulp apart moves its update by a fraction of lr, and an int8
#: moment or compressed gradient rounded to the neighbouring level moves it
#: by 1/127 of its block's scale; read 5.4e-05 at most
WEIGHT_ATOL = 1e-4
#: microbatches=2 against 1 in the port: the same gradients summed in two
#: halves of the batch
MICRO_RTOL, MICRO_WEIGHT_ATOL = 1e-6, 1e-4
TRAIN_CONFIGS = {
    "plain": dict(),
    "microbatches": dict(microbatches=2),
    "quantize_moments": dict(quantize_moments=True),
    "compress_grads": dict(compress_grads=True),
}
N_STEPS, BATCH, SEQ, LR = 3, 4, 16, 1e-3


def _stream(mod):
    return mod.TokenStream(vocab=256, seq_len=SEQ, global_batch=BATCH, seed=0)


def _walk(tree, prefix=""):
    """(path, numpy) pairs in sorted-key order, for either package's params
    (bf16 leaves exactly as float32)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree.detach().to(torch.float32).numpy()
    else:
        yield prefix, np.asarray(tree).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference_run(name: str):
    """``repro``'s 3 steps under one jit: initial weights, metrics, final weights."""
    model = RModel(rconfig.get_config(ARCH, reduced=True))
    tc = rstep.TrainConfig(learning_rate=LR, **TRAIN_CONFIGS[name])
    p0 = model.init(jax.random.PRNGKey(0))
    state = rstep.init_train_state(model, p0, tc)
    step = jax.jit(functools.partial(rstep.train_step, model, tc))
    stream, metrics = _stream(rtok), []
    for i in range(N_STEPS):
        state, m = step(state, stream.batch_at(i))
        metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["step"])))
    return jax.tree.map(np.asarray, p0), metrics, dict(_walk(state.params))


def _port_run(name: str, params=None, n_steps=N_STEPS):
    model = Model(get_config(ARCH, reduced=True))
    tc = tstep.TrainConfig(learning_rate=LR, **TRAIN_CONFIGS[name])
    if params is None:
        params = lm_params_from_reference(_reference_run("plain")[0])
    state = tstep.init_train_state(model, params, tc)
    stream, metrics = _stream(ttok), []
    for i in range(n_steps):
        state, m = tstep.train_step(model, tc, state, stream.batch_at(i))
        metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["step"])))
    return state, metrics


# -- the token stream ----------------------------------------------------------------


@pytest.mark.parametrize("seed,step,host_index,n_hosts",
                         [(0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 2), (5, 11, 3, 4)])
def test_token_stream_bitwise(seed, step, host_index, n_hosts):
    kw = dict(vocab=300, seq_len=12, global_batch=8, seed=seed, host_index=host_index,
              n_hosts=n_hosts)
    want = rtok.TokenStream(**kw).batch_at(step)
    got = ttok.TokenStream(**kw).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    it = ttok.TokenStream(**kw).iterate(step)
    np.testing.assert_array_equal(next(it)["tokens"], want["tokens"])


def test_token_stream_hosts_from_process_group(monkeypatch):
    """With a group initialised, the host slice is the rank's."""
    monkeypatch.setattr(ttok.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(ttok.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(ttok.dist, "get_world_size", lambda: 2)
    got = ttok.TokenStream(vocab=64, seq_len=5, global_batch=4)
    assert (got.host_index, got.n_hosts) == (1, 2)
    want = rtok.TokenStream(vocab=64, seq_len=5, global_batch=4, host_index=1, n_hosts=2)
    np.testing.assert_array_equal(got.batch_at(3)["labels"], want.batch_at(3)["labels"])
    with pytest.raises(ValueError):
        ttok.TokenStream(vocab=64, seq_len=5, global_batch=3)


@pytest.mark.parametrize("cell", ["TRAIN_4K", "PREFILL_32K", "DECODE_32K"])
@pytest.mark.parametrize("enc_dec", [False, True], ids=["dense", "enc_dec"])
def test_make_batch_specs(cell, enc_dec):
    extra = dict(family=Family.ENC_DEC) if enc_dec else {}
    rcfg = rconfig.get_config(ARCH).with_(
        **({"family": rconfig.Family.ENC_DEC} if enc_dec else {}))
    want = rtok.make_batch_specs(rcfg, getattr(rconfig, cell))
    got = ttok.make_batch_specs(get_config(ARCH).with_(**extra), getattr(tconfig, cell))
    assert got.keys() == want.keys()
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == spec.shape
        assert str(got[k].dtype).removeprefix("torch.") == str(spec.dtype)


# -- gradient compression ----------------------------------------------------------------


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, 300)).astype(np.float32)
    # one block whose scale is exactly 1 (absmax 127): ties at +-0.5 and +-2.5
    a[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    return {"a": a, "b": [rng.normal(size=(5,)).astype(np.float32) * 1e-3,
                          (rng.normal(size=(2, 130)) * 1e-2).astype(np.float32)]}


def test_round_half_to_even_on_a_tie():
    q, scale = tcomp._q8_leaf(torch.as_tensor(_grad_tree(0)["a"]))
    assert float(scale[0, 0]) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_compress_decompress_bitwise(bf16):
    g = _grad_tree(1)
    rg = jax.tree.map(jnp.asarray, g)
    tg = {"a": torch.as_tensor(g["a"]), "b": [torch.as_tensor(x) for x in g["b"]]}
    if bf16:
        rg = jax.tree.map(lambda x: x.astype(jnp.bfloat16), rg)
        tg = {"a": tg["a"].to(torch.bfloat16), "b": [x.to(torch.bfloat16) for x in tg["b"]]}
    q_r, s_r = rcomp._q8_leaf(rg["a"].astype(jnp.float32))
    q_t, s_t = tcomp._q8_leaf(tg["a"].to(torch.float32))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_r))
    ef_r, ef_t = rcomp.init_error_feedback(rg), tcomp.init_error_feedback(tg)
    for _ in range(3):  # the residual feeds back
        out_r, ef_r = rcomp.compress_decompress(rg, ef_r)
        out_t, ef_t = tcomp.compress_decompress(tg, ef_t)
        for (_, a), (_, b) in zip(_walk({"a": out_r["a"], "b0": out_r["b"][0],
                                         "b1": out_r["b"][1]}),
                                  _walk({"a": out_t["a"], "b0": out_t["b"][0],
                                         "b1": out_t["b"][1]})):
            np.testing.assert_array_equal(np.asarray(b, np.float32), np.asarray(a, np.float32))
        for a, b in zip(jax.tree.leaves(ef_r.residual), tree_leaves(ef_t.residual)):
            assert b.dtype is torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert out_t["a"].dtype is tg["a"].dtype


def test_compression_in_spans_is_one_pass(monkeypatch):
    from repro_torch.optim import adamw

    assert adamw.UPDATE_CHUNK % tcomp._QBLOCK == 0
    g = _grad_tree(2)
    tg = {"a": torch.as_tensor(g["a"]), "b": [torch.as_tensor(x) for x in g["b"]]}
    whole = tcomp.compress_decompress(tg, tcomp.init_error_feedback(tg))
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", 512)
    spans = tcomp.compress_decompress(tg, tcomp.init_error_feedback(tg))
    for a, b in zip(tree_leaves(whole), tree_leaves(spans)):
        assert torch.equal(a, b)


# -- the train step ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(TRAIN_CONFIGS))
def test_train_step_against_reference(name):
    _, want_metrics, want_params = _reference_run(name)
    p0 = lm_params_from_reference(_reference_run("plain")[0])
    kept = [t.clone() for t in tree_leaves(p0)]
    state, metrics = _port_run(name, params=p0)
    # the step is functional: the weights it was given are untouched
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p0), kept))
    got, want = np.array(metrics), np.array(want_metrics)
    np.testing.assert_array_equal(got[:, 2], [1, 2, 3])
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=METRIC_RTOL)
    assert state.step.dtype is torch.int32 and state.step.ndim == 0
    got_params = dict(_walk(state.params))
    assert got_params.keys() == want_params.keys()
    for k, w in want_params.items():
        np.testing.assert_allclose(got_params[k], w, rtol=0, atol=WEIGHT_ATOL, err_msg=k)
    assert (state.ef is not None) == (name == "compress_grads")


def test_microbatches_against_one_batch():
    s1, m1 = _port_run("plain")
    s2, m2 = _port_run("microbatches")
    np.testing.assert_allclose(np.array(m2)[:, :2], np.array(m1)[:, :2], rtol=MICRO_RTOL)
    for a, b in zip(tree_leaves(s2.params), tree_leaves(s1.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=MICRO_WEIGHT_ATOL)


class _CountBmm(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.bmm.default
        return func(*args, **(kwargs or {}))


def _loss_and_grads(remat):
    model = Model(get_config(ARCH, reduced=True).with_(remat=remat))
    params = model.init(jr.PRNGKey(3))
    batch = _stream(ttok).batch_at(0)
    live = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = model.loss(params, torch.as_tensor(batch["tokens"]), torch.as_tensor(batch["labels"]))
    with _CountBmm() as count:
        grads = torch.autograd.grad(loss, live)
    return loss, grads, count.n


def test_remat_same_bits_and_recomputes():
    """``block`` and ``full`` give the loss and gradients of ``none`` to 0 ulp;
    the backward pass recomputes the attention products under both and the
    projections under ``full`` only."""
    loss0, g0, bmm0 = _loss_and_grads("none")
    counts = {}
    for remat in ("block", "full"):
        loss, grads, counts[remat] = _loss_and_grads(remat)
        assert torch.equal(loss, loss0), remat
        for a, b in zip(grads, g0):
            assert torch.equal(a, b), remat
    cfg = get_config(ARCH, reduced=True)
    # a layer's forward products: q, k, v, o and the MLP's two (batch 1), and
    # the scores and values (batch x heads); "block" recomputes those two,
    # "full" all but the MLP's last, whose output no backward formula reads
    # (the recompute stops once it has what the backward needs)
    assert counts["block"] == bmm0 + 2 * cfg.n_layers
    assert counts["full"] == bmm0 + 7 * cfg.n_layers
    with pytest.raises(ValueError):
        _loss_and_grads("sometimes")


def test_encoder_frames_raise():
    """The encoder-decoder family's loss without ``encoder_frames`` raises the
    reference's error type (its forward asserts them); the other families
    ignore frames, as the reference's do."""
    model = Model(get_config(ARCH, reduced=True))
    params = model.init(jr.PRNGKey(0))
    tok = torch.zeros((1, 4), dtype=torch.int32)
    assert torch.equal(model.loss(params, tok, tok, encoder_frames=torch.zeros((1, 3, 64))),
                       model.loss(params, tok, tok))
    whisper = Model(get_config("whisper-large-v3", reduced=True))
    with pytest.raises(AssertionError, match="encoder_frames"):
        whisper.loss(whisper.init(jr.PRNGKey(0)), tok, tok)


# -- the fault-tolerant loop ------------------------------------------------------


def _loop(tmp, name, injector=None, total=6, max_restarts=3):
    model = Model(get_config(ARCH, reduced=True))
    tc = tstep.TrainConfig(learning_rate=LR, microbatches=2, quantize_moments=True,
                           compress_grads=True)
    stream = _stream(ttok)
    ckpt = CheckpointManager(str(tmp / name), save_every=2, keep=2)
    report = run_training(
        step_fn=lambda s, b: tstep.train_step(model, tc, s, b),
        init_state=lambda: tstep.init_train_state(model, model.init(jr.PRNGKey(0)), tc),
        data=stream.iterate, ckpt=ckpt, total_steps=total, failure_injector=injector,
        max_restarts=max_restarts, log=lambda _msg: None)
    final = ckpt.restore_latest(tstep.init_train_state(model, model.init(jr.PRNGKey(0)), tc))
    return report, final


def test_killed_and_resumed_equals_uninterrupted(tmp_path):
    """Quantized moments, compressed gradients and microbatches: every leaf
    of the state (weights, int8 moments and their scales, bf16 second
    moments, residuals, step) bitwise."""
    clean, (step_c, state_c) = _loop(tmp_path, "clean")
    hurt, (step_h, state_h) = _loop(tmp_path, "hurt", FailureInjector(fail_at_steps=(3, 5)))
    assert hurt.restarts == 2 and clean.restarts == 0
    assert step_c == step_h == 6
    # the resumed run repeats the steps after its last checkpoint: 3 of them, once each
    assert hurt.steps_run == clean.steps_run + 2
    assert hurt.losses[-2:] == clean.losses[-2:]
    a, b = tree_leaves(state_c), tree_leaves(state_h)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert (x is None and y is None) or (x.dtype == y.dtype and torch.equal(x, y))


def test_restore_keeps_zero_d_leaves_and_key_order(tmp_path):
    """A 0-d step counter restores 0-d, so a restored state saves again as it
    was, and a dict comes back in the template's key order."""
    ckpt = CheckpointManager(str(tmp_path), save_every=1)
    tree = {"w": torch.ones(3, dtype=torch.bfloat16), "step": torch.zeros((), dtype=torch.int32)}
    ckpt.maybe_save(1, tree)
    _, back = ckpt.restore_latest(tree)
    assert back["step"].shape == () and back["w"].dtype is torch.bfloat16
    # the template's key order, which the optimizer's tree walks sum by
    assert list(back) == ["w", "step"]
    ckpt.maybe_save(2, back)
    assert ckpt.restore_latest(tree)[0] == 2


def test_out_of_restarts_raises(tmp_path):
    with pytest.raises(InjectedFailure):
        _loop(tmp_path, "doomed", FailureInjector(fail_at_steps=(0, 1, 2, 3)), max_restarts=2)


# -- the launcher -------------------------------------------------------------------


def test_launcher_cli(tmp_path, capsys):
    """``--device cpu``: the reduced config cut to 1 layer, every option on;
    its first loss is ``repro``'s model's on the same step-0 batch and the
    same key's weights."""
    argv = ["--device", "cpu", "--steps", "3", "--layers", "1", "--batch", "4", "--seq", "16",
            "--microbatches", "2", "--quantize-moments", "--compress-grads",
            "--save-every", "2", "--ckpt-dir", str(tmp_path / "ck")]
    report = tlaunch.main(argv)
    assert report.final_step == 3 and len(report.losses) == 3 and report.restarts == 0
    out = capsys.readouterr().out
    assert "1 layers" in out and "on cpu" in out
    rmodel = RModel(rconfig.get_config(ARCH, reduced=True).with_(n_layers=1))
    batch = rtok.TokenStream(vocab=256, seq_len=16, global_batch=4).batch_at(0)
    want = float(rmodel.loss(rmodel.init(jax.random.PRNGKey(0)), jnp.asarray(batch["tokens"]),
                             jnp.asarray(batch["labels"])))
    np.testing.assert_allclose(report.losses[0], want, rtol=METRIC_RTOL)
    # a second call finds the run's last checkpoint and runs nothing
    assert tlaunch.main(argv).steps_run == 0


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_launcher_mesh_plans_then_needs_the_ranks(mesh, monkeypatch, capsys, tmp_path):
    """``--mesh single|multi`` prints the train state's and the batch's
    placements on the production mesh and the bytes a device holds, then
    raises ``ValueError`` naming the ranks the mesh needs and the group's, as
    ``repro``'s launcher raises building its mesh on a host short of a pod."""
    from repro.launch import train as rlaunch

    monkeypatch.setattr(sys, "argv", ["train", "--mesh", mesh, "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError):
        rlaunch.main()
    n = 256 if mesh == "single" else 512
    with pytest.raises(ValueError, match=f"needs {n} ranks; the default process group has 1"):
        tlaunch.main(["--device", "cpu", "--mesh", mesh])
    out = capsys.readouterr().out
    assert f"({n} devices)" in out and "B a device of" in out
    # the embedding (vocab 256, d_model 64): vocab on "model", d_model on "data"
    assert "params.embed (256, 64): PartitionSpec('model', 'data') -> " in out
    # a batch of 8 divides the pod axis (2), not the data axis (16)
    batch_spec = "PartitionSpec('pod', None)" if mesh == "multi" else "PartitionSpec(None, None)"
    assert f"batch.tokens (8, 64): {batch_spec} -> " in out


def test_launcher_whisper_fails_as_the_reference(monkeypatch, tmp_path):
    """Neither launcher trains whisper-large-v3: the token stream yields no
    encoder frames, and the encoder-decoder forward asserts them
    (``ROADMAP.md`` Queue 3).  The port fails with the reference's error type."""
    from repro.launch import train as rlaunch

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "whisper-large-v3", "--steps", "1",
                                      "--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(Exception) as ref_err:
        rlaunch.main()
    assert type(ref_err.value) is AssertionError
    with pytest.raises(AssertionError, match="encoder_frames"):
        tlaunch.main(["--device", "cpu", "--arch", "whisper-large-v3", "--steps", "1",
                      "--ckpt-dir", str(tmp_path / "port")])


def test_launcher_trains_gemma2(tmp_path):
    """``--arch gemma2-9b`` trains on the CPU, its first loss the reference's on
    sequences longer than the reduced window of 8."""
    report = tlaunch.main(["--device", "cpu", "--arch", "gemma2-9b", "--steps", "2", "--batch",
                           "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert report.final_step == 2 and np.isfinite(report.losses).all()
    rmodel = RModel(rconfig.get_config("gemma2-9b", reduced=True))
    batch = rtok.TokenStream(vocab=256, seq_len=16, global_batch=2).batch_at(0)
    want = float(rmodel.loss(rmodel.init(jax.random.PRNGKey(0)), jnp.asarray(batch["tokens"]),
                             jnp.asarray(batch["labels"])))
    np.testing.assert_allclose(report.losses[0], want, rtol=METRIC_RTOL)


def test_no_not_ported_message_is_left():
    """Every family, config and launcher mode of the reference has its port:
    no source of ``repro_torch`` says that something is not ported."""
    hits = [str(f) for f in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            if "not ported" in f.read_text()]
    assert not hits, hits
