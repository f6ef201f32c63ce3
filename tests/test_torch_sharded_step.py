"""The sharded step: the port's ``train_step``, ``prefill`` and
``decode_step`` on DTensors over a ``DeviceMesh``, on 4 gloo ranks of one
CPU thread each (``spawn_ranks``), on the mesh (data 2, model 2) and on the
multi-pod axes (pod 2, data 1, model 2), one reduced config of each family
at batch (4, 16).

* One sharded ``train_step`` against ``repro``'s ``train_step`` jitted with
  the same pspecs (``in_shardings=(state_ps, batch_ps)``,
  ``out_shardings=(state_ps, P())``) on a forced 4-device CPU mesh, in a
  subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``; the
  mesh's axes ``AxisType.Auto``, since jax 0.9.0's default ``Explicit`` axes
  make the reference's sharding constraints asserts), from the same weights
  and batch: the loss, the gradient norm and the new params.
* The same step against the port's unsharded step, and every leaf of the
  new state on its pspec's placements.
* Quantized moments, compressed gradients and two microbatches together:
  sharded against unsharded, the int8 moments' scales included.
* A sharded ``prefill`` of 8 tokens and two ``decode_step`` calls against
  the unsharded port: the logits and every cache leaf, each leaf on its
  placements.

The reference subprocess starts first and runs beside the spawned ranks.
This file runs the mesh (data 2, model 2); ``test_torch_sharded_step_pods.py``
runs the same cases on the multi-pod axes, so that the two groups run on
two workers.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.core import topology as ttopo

torch.set_num_threads(1)

#: one reduced config of each family: dense (MQA, GELU), local/global with
#: softcaps and tied embeddings, the VLM backbone (M-RoPE), the
#: encoder-decoder, MoE, SSM and the hybrid
ARCHS = ("granite-20b", "gemma2-9b", "qwen2-vl-72b", "whisper-large-v3", "dbrx-132b",
         "mamba2-130m", "zamba2-7b")
MESHES = {"data2_model2": (("data", "model"), (2, 2)),
          "pod2_data1_model2": (("pod", "data", "model"), (2, 1, 2))}
BATCH, SEQ, PROMPT = 4, 16, 8
#: the ranks and the reference subprocess yield the cores to the suite's
#: workers (a group of 4 ranks beside 6 workers oversubscribes the host)
NICE = 5
#: the step's configurations: the default, and int8 moments with compressed
#: gradients over two microbatches (on the dense and local/global families)
QUANTIZED_ARCHS = ("granite-20b", "gemma2-9b")
#: the sharded step against the unsharded one, float32: the same products
#: split over shards and their partial sums reduced in another order; read
#: 1.9e-07 relative on the losses and norms at most
METRIC_RTOL = 2e-6
#: the new weights after one AdamW step at lr 3e-4: the first step moves a
#: weight by lr * g / (|g| + eps), so where |g| is near eps (1e-8) a gradient
#: summed to another rounding moves its weight by up to 2 lr; elsewhere the
#: step is lr times the sign.  Every weight is held to 2 lr, and all but
#: WEIGHT_FEW of them to WEIGHT_ATOL (read: one of 16,384 at 2.3e-06, the
#: rest under 3.3e-07 against the unsharded port)
WEIGHT_BOUND, WEIGHT_ATOL, WEIGHT_FEW = 6e-4, 2e-6, 1e-3
#: against ``repro`` (XLA's sums against oneDNN's, on the same weights and
#: batch): read 1.9e-07 relative on the metrics
REF_METRIC_RTOL = 2e-6
#: quantized moments and compressed gradients (int8 blocks over the whole
#: leaf, as the reference's): a value on a rounding boundary lands on the
#: neighbouring level, 1/127 of its block's absmax
Q_WEIGHT_ATOL, Q_SCALE_RTOL = 1e-5, 1e-5
#: the serving logits and caches, float32 through at most 2 + 2 layers
SERVE_ATOL = 5e-5


def _train_configs():
    from repro_torch.train.step import TrainConfig

    return (("plain", TrainConfig()),
            ("quantized", TrainConfig(quantize_moments=True, compress_grads=True,
                                      microbatches=2)))


def _flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _unflat(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflat(v, flat, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    return torch.as_tensor(flat[prefix])


def _setup(arch):
    """The reduced config, its model, its weights (``PRNGKey(0)``) and the
    batch (numpy, drawn from a seed)."""
    from repro_torch import random as jr
    from repro_torch.models import Model, get_config

    cfg = get_config(arch, reduced=True)
    model = Model(cfg)
    params = model.init(jr.PRNGKey(0, "cpu"))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_encoder_layers:
        batch["encoder_frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return cfg, model, params, batch


def _serve(model, params, batch, cache):
    """A prefill of ``PROMPT`` tokens, then two decode steps; ``batch`` holds
    tensors (DTensors when sharded)."""
    toks = batch["tokens"]
    frames = batch.get("encoder_frames")
    lg0, cache = model.prefill(params, toks[:, :PROMPT], cache, encoder_frames=frames)
    lg1, cache = model.decode_step(params, toks[:, PROMPT:PROMPT + 1], cache)
    lg2, cache = model.decode_step(params, toks[:, PROMPT + 1:PROMPT + 2], cache)
    return [lg0, lg1, lg2], cache


def _np(t):
    """A (DTensor's whole) tensor as numpy, bf16 as float32."""
    from repro_torch.distributed import sharding as S

    t = S.whole(t).detach()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def _rank(rank, mesh_name, quantized=True):
    """Every case on this rank's group (the int8 moments and compressed
    gradients with ``quantized``): rank 0 returns the results."""
    os.nice(NICE)
    from repro_torch.core.topology import MeshSpec
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import specs as SP
    from repro_torch.train.step import init_train_state, train_step

    names, dims = MESHES[mesh_name]
    mesh, rules = MeshSpec(names, dims), S.make_rules()
    device_mesh = mesh.device_mesh("cpu")
    out = {}
    for arch in ARCHS:
        cfg, model, params, batch = _setup(arch)
        res = {}
        for label, tc in _train_configs():
            if label == "quantized" and (not quantized or arch not in QUANTIZED_ARCHS):
                continue
            state = init_train_state(model, params, tc)
            ps = SP.train_state_pspecs(model, state, mesh, rules)
            with S.mesh_context(mesh, rules):
                new, met = train_step(model, tc, S.distribute(state, ps, device_mesh), batch)
            flat_ps = dict(_flat({"s": {"params": ps.params, "m": _q(ps.opt.m), "v": ps.opt.v}}))
            flat_new = dict(_flat({"s": {"params": new.params, "m": _q(new.opt.m),
                                         "v": new.opt.v}}))
            res[label] = {
                "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                "leaves": {k: _np(v) for k, v in flat_new.items()},
                "misplaced": [k for k, v in flat_new.items()
                              if tuple(v.placements) != S.placements(flat_ps[k], mesh)],
            }
        cache = model.init_cache(BATCH, SEQ, torch.float32, device="cpu")
        cps = SP.cache_pspecs(cache, mesh, rules)
        with S.mesh_context(mesh, rules):
            dparams = S.distribute(params, model.param_pspecs(mesh, rules), device_mesh)
            dbatch = S.distribute({k: torch.as_tensor(v) for k, v in batch.items()},
                                  SP.batch_pspecs(batch, mesh, rules), device_mesh)
            logits, new_cache = _serve(model, dparams, dbatch,
                                       S.distribute(cache, cps, device_mesh))
            want = SP.cache_pspecs(new_cache, mesh, rules)
        res["serve"] = {
            "logits": [_np(x) for x in logits],
            "cache": {k: _np(v) for k, v in new_cache.items()},
            "misplaced": [k for k, v in new_cache.items()
                          if tuple(v.placements) != S.placements(want[k], mesh)],
        }
        out[arch] = res
    return out if rank == 0 else None


def _q(moments):
    """A moment tree with each int8 moment as {"q", "scale"} (plain dicts)."""
    if isinstance(moments, dict):
        return {k: _q(v) for k, v in moments.items()}
    if getattr(moments, "_fields", None) == ("q", "scale"):
        return {"q": moments.q, "scale": moments.scale}
    return moments


_REFERENCE = """
import json, sys
import numpy as np
import jax
from jax.sharding import AxisType, PartitionSpec as P
from repro.distributed.sharding import make_rules, mesh_context
from repro.launch import specs as RS
from repro.launch.dryrun import collective_bytes
from repro.models import Model, get_config
from repro.train.step import TrainConfig, init_train_state, train_step

data = np.load(sys.argv[1])
archs, out = sys.argv[2].split(","), {}
assert len(jax.devices()) == 4


def unflat(tree, prefix):
    if isinstance(tree, dict):
        return {k: unflat(v, prefix + "/" + k) for k, v in tree.items()}
    return jax.numpy.asarray(data[prefix])


def flat(tree, prefix, into):
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat(tree[k], prefix + "/" + k, into)
    else:
        into[prefix] = np.asarray(tree)


for mesh_name, (names, dims) in json.loads(sys.argv[4]).items():
    mesh = jax.make_mesh(tuple(dims), tuple(names), axis_types=(AxisType.Auto,) * len(dims))
    rules = make_rules()
    for arch in archs:
        model = Model(get_config(arch, reduced=True))
        params = unflat(model.abstract_params(), arch + "/params")
        batch = {k: jax.numpy.asarray(data[arch + "/batch/" + k])
                 for k in ("tokens", "labels", "encoder_frames") if arch + "/batch/" + k in data}
        tc = TrainConfig()
        state = init_train_state(model, params, tc)
        with mesh_context(mesh, rules):
            state_ps = RS.train_state_pspecs(model, state, mesh, rules)
            batch_ps = RS.batch_pspecs(batch, mesh, rules)
            step = jax.jit(lambda s, b: train_step(model, tc, s, b),
                           in_shardings=(state_ps, batch_ps), out_shardings=(state_ps, P()))
            new, met = step(state, batch)
            hlo = step.lower(state, batch).compile().as_text()
        key = mesh_name + "/" + arch
        for kind, n in collective_bytes(hlo).items():
            out[key + "/collectives/" + kind] = np.asarray(n)
        out[key + "/loss"] = np.asarray(met["loss"])
        out[key + "/grad_norm"] = np.asarray(met["grad_norm"])
        flat(new.params, key + "/params", out)
np.savez(sys.argv[3], **out)
print("REFERENCE-4 OK")
"""


def start_reference(cases, mesh_names, archs=ARCHS):
    """``repro``'s sharded step of ``archs`` on a forced 4-device mesh for each
    mesh, started at once in a subprocess; yields (process, path of its npz)."""
    tmp = tempfile.TemporaryDirectory()
    inputs = {}
    for arch in archs:
        _, _, params, batch = cases[arch]
        inputs.update({f"{arch}/params/{k}": v.numpy() for k, v in _flat(params)})
        inputs.update({f"{arch}/batch/{k}": v for k, v in batch.items()})
    src = os.path.join(tmp.name, "inputs.npz")
    np.savez(src, **inputs)
    # one compile thread: the suite's workers share the cores
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1 "
                        + env.get("XLA_FLAGS", "")).strip()
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "src"))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    path = os.path.join(tmp.name, "reference.npz")
    meshes = json.dumps({m: MESHES[m] for m in mesh_names})
    proc = subprocess.Popen(["nice", "-n", str(NICE), sys.executable, "-c", _REFERENCE, src,
                             ",".join(archs), path, meshes], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()
    tmp.cleanup()


def finish_reference(reference):
    proc, path = reference
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REFERENCE-4 OK" in out, err[-3000:]
    return dict(np.load(path))


def run_unsharded(cases):
    """The port's unsharded step and serving on the same weights and batch."""
    from repro_torch.train.step import init_train_state, train_step

    out = {}
    for arch, (cfg, model, params, batch) in cases.items():
        res = {}
        for label, tc in _train_configs():
            if label == "quantized" and arch not in QUANTIZED_ARCHS:
                continue
            new, met = train_step(model, tc, init_train_state(model, params, tc), batch)
            res[label] = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                          "leaves": {k: _np(v) for k, v in _flat(
                              {"s": {"params": new.params, "m": _q(new.opt.m),
                                     "v": new.opt.v}})}}
        cache = model.init_cache(BATCH, SEQ, torch.float32, device="cpu")
        logits, new_cache = _serve(model, params, {k: torch.as_tensor(v)
                                                   for k, v in batch.items()}, cache)
        res["serve"] = {"logits": [x.numpy() for x in logits],
                        "cache": {k: v.numpy() for k, v in new_cache.items()}}
        out[arch] = res
    return out


MESH = "data2_model2"


@pytest.fixture(scope="module")
def cases():
    """Each arch's config, model, weights and batch."""
    return {arch: _setup(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def reference(cases):
    yield from start_reference(cases, (MESH,))


@pytest.fixture(scope="module")
def sharded(reference):
    return ttopo.spawn_ranks(_rank, 4, (MESH,), device="cpu")[0]


@pytest.fixture(scope="module")
def reference_out(reference, sharded):
    return finish_reference(reference)


@pytest.fixture(scope="module")
def unsharded(cases):
    return run_unsharded(cases)


def _close_weights(got, want, name):
    """Within WEIGHT_BOUND everywhere, WEIGHT_ATOL but for WEIGHT_FEW of them."""
    assert got.shape == want.shape, name
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= WEIGHT_BOUND, (name, diff.max())
    assert np.mean(diff > WEIGHT_ATOL) <= WEIGHT_FEW, (name, np.mean(diff > WEIGHT_ATOL))


def check_reference(got, reference_out, mesh, arch):
    """The sharded step's loss, norm and new params against ``repro``'s."""
    got = got["plain"]
    key = f"{mesh}/{arch}"
    np.testing.assert_allclose(got["loss"], reference_out[key + "/loss"], rtol=REF_METRIC_RTOL)
    np.testing.assert_allclose(got["grad_norm"], reference_out[key + "/grad_norm"],
                               rtol=REF_METRIC_RTOL)
    params = {k[len("s/params/"):]: v for k, v in got["leaves"].items()
              if k.startswith("s/params/")}
    assert params
    for k, v in params.items():
        _close_weights(v, reference_out[f"{key}/params/{k}"], k)


def check_unsharded(got, want):
    got, want = got["plain"], want["plain"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=METRIC_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=METRIC_RTOL)
    assert set(got["leaves"]) == set(want["leaves"])
    for k, v in want["leaves"].items():
        _close_weights(got["leaves"][k], v, k)


def check_placements(got):
    for label, res in got.items():
        assert res["misplaced"] == [], (label, res["misplaced"])


def check_quantized(got, want):
    """int8 first moments (blocks of 128), int8 gradients with error
    feedback (blocks of 256) and two microbatches, sharded == unsharded: the
    blocks run over the whole leaf on both."""
    got, want = got["quantized"], want["quantized"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=METRIC_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=METRIC_RTOL)
    assert set(got["leaves"]) == set(want["leaves"])
    for k, v in want["leaves"].items():
        g = got["leaves"][k]
        assert g.shape == v.shape and g.dtype == v.dtype, k
        if k.endswith("/q"):  # int8 levels: at most one level apart
            assert np.abs(g.astype(np.int32) - v.astype(np.int32)).max() <= 1, k
        elif k.endswith("/scale"):
            np.testing.assert_allclose(g, v, rtol=Q_SCALE_RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(g, v, atol=Q_WEIGHT_ATOL, err_msg=k)


def check_serve(got, want):
    got, want = got["serve"], want["serve"]
    for a, b in zip(got["logits"], want["logits"], strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=SERVE_ATOL)
    assert set(got["cache"]) == set(want["cache"])
    for k, v in want["cache"].items():
        np.testing.assert_allclose(got["cache"][k], v, atol=SERVE_ATOL, err_msg=k)
    assert got["misplaced"] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, sharded, reference_out):
    check_reference(sharded[arch], reference_out, MESH, arch)


def test_collectives_beside_the_reference(reference_out, capsys):
    """The port's collective bytes a device for reduced granite's train step
    on this mesh (its fake-group plan, equal to a real group's:
    ``test_torch_dryrun_collectives.py``) beside ``repro``'s, read from its
    compiled HLO by its own ``collective_bytes``.  Not equal: XLA's
    partitioner picks its own collectives.  Both gather the FSDP weights and
    all-reduce; each kind is printed."""
    from repro_torch.core.topology import MeshSpec
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import dryrun
    from repro_torch.models import Model, get_config
    from repro_torch.models.config import ShapeCell

    names, dims = MESHES[MESH]
    port = dryrun.plan(Model(get_config("granite-20b", reduced=True)),
                       ShapeCell("reduced", SEQ, BATCH, "train"), MeshSpec(names, dims),
                       make_rules())["collective_bytes_per_device"]
    key = f"{MESH}/granite-20b/collectives/"
    ref = {k[len(key):]: int(v) for k, v in reference_out.items() if k.startswith(key)}
    assert set(ref) == set(port)
    with capsys.disabled():
        print(f"\ncollective bytes a device, reduced granite-20b, train step, {MESH}: "
              f"port {port}; repro {ref}")
    for kind in ("all-gather", "all-reduce"):
        assert port[kind] > 0 and ref[kind] > 0, kind


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_unsharded(arch, sharded, unsharded):
    check_unsharded(sharded[arch], unsharded[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_new_state_keeps_its_placements(arch, sharded):
    check_placements(sharded[arch])


@pytest.mark.parametrize("arch", QUANTIZED_ARCHS)
def test_quantized_moments_and_compressed_grads(arch, sharded, unsharded):
    check_quantized(sharded[arch], unsharded[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unsharded(arch, sharded, unsharded):
    check_serve(sharded[arch], unsharded[arch])
