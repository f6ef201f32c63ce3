"""The sharded training half against ``repro``: the logical-axis rules, the
partition specs of every arch's params, train state, cache and batch on both
production meshes, the bytes a device holds, the placements, and the
dry-run planner over ``meta`` tensors (its records, its calibration and a
FLOP count derived by hand).

``repro``'s ``spec`` reads only ``mesh.shape``, so its meshes here are
``SimpleNamespace(shape=...)``; its own rule tests (``tests/test_distributed.py``)
build an ``AbstractMesh`` at import and do not collect on jax 0.9.0, so their
cases run here on the port with the expected values written out.
"""

import socket
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.distributed import sharding as rsh
from repro.launch import specs as RS
from repro.models.config import get_config as r_get_config
from repro.models.model import Model as RModel
from repro.train.step import TrainConfig as RTrainConfig
from repro_torch import random as jr
from repro_torch.core.topology import make_cpu_mesh, make_production_mesh
from repro_torch.distributed.sharding import P, local_shape, make_rules, placements, spec
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.models import ARCH_IDS, Model, get_config, shapes_for
from repro_torch.models.params import shardings
from repro_torch.train.step import TrainConfig

torch.set_num_threads(1)

SINGLE, MULTI = make_production_mesh(), make_production_mesh(multi_pod=True)
RULES = make_rules()
R_RULES = rsh.make_rules()
#: the three train-state layouts: float32 moments; an int8 first moment and a
#: bf16 second with the error-feedback residual of compressed gradients
TRAIN_CONFIGS = [dict(), dict(quantize_moments=True), dict(quantize_moments=True,
                                                          compress_grads=True)]


def _ref_mesh(mesh):
    return types.SimpleNamespace(shape=dict(mesh.shape))


# -- the reference's rule cases, on the port ---------------------------------------


def test_batch_sharded_on_pod_and_data():
    assert spec((256, 4096), ("batch", "seq"), MULTI, RULES) == (("pod", "data"), None)


def test_batch_one_not_sharded():
    """long_500k: global_batch=1 -> the batch axis drops to replicated."""
    assert spec((1, 524288), ("batch", "seq"), MULTI, RULES) == (None, None)


def test_partial_divisibility_picks_prefix():
    assert spec((32, 8), ("batch", "seq"), MULTI, RULES) == (("pod", "data"), None)
    # 16 % 2 == 0 picks pod; 16 % (2 * 16) != 0 stops before data
    assert spec((16, 8), ("batch", "seq"), MULTI, RULES) == ("pod", None)


def test_kv_heads_replicate_when_indivisible():
    """GQA kv=8 on model=16 replicates; 48 heads split."""
    assert spec((8, 128), ("kv_heads", "head_dim"), SINGLE, RULES) == (None, None)
    assert spec((48, 128), ("heads", "head_dim"), SINGLE, RULES) == ("model", None)


def test_mesh_axis_used_once():
    s = spec((256, 256), ("batch", "moe_tokens"), MULTI, RULES)
    assert s == (("pod", "data"), None)


def test_vocab_and_ff_on_model():
    assert spec((256000, 64), ("vocab", "embed_act"), SINGLE, RULES) == ("model", None)
    assert spec((64, 33792), ("embed_act", "ff"), SINGLE, RULES)[1] == "model"


def test_embed_fsdp_on_data():
    assert spec((12288, 96, 128), ("embed", "heads", "head_dim"), SINGLE, RULES) == (
        "data", "model", None)


def test_rules_override():
    s = spec((4, 4096), ("batch", "seq"), SINGLE, RULES)
    s2 = spec((4, 4096), ("batch", "seq"), SINGLE, make_rules({"seq": "model"}))
    assert s[1] is None and s2[1] == "model"


def test_unknown_logical_axis_raises():
    with pytest.raises(KeyError):
        spec((4,), ("nonsense",), SINGLE, RULES)


@pytest.mark.parametrize("arch", ["granite-20b", "dbrx-132b", "mamba2-130m"])
def test_model_param_pspecs_valid(arch):
    """Every sharded dim divides by its mesh extent."""
    model = Model(get_config(arch))
    pairs = list(S.placed(model.abstract_params(), model.param_pspecs(SINGLE, RULES)))
    assert pairs and all(t.device.type == "meta" for t, _ in pairs)
    for t, ps in pairs:
        assert isinstance(ps, P) and len(ps) == t.ndim
        for dim, axes in zip(t.shape, ps):
            axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
            assert dim % int(np.prod([SINGLE.shape[a] for a in axes])) == 0, (arch, ps)


# -- the port's specs equal the reference's, every arch, mesh and cell -------------------


def _same(got, want, where=""):
    """A port tree of specs equals a reference one, node for node: dicts by
    key, NamedTuples by field, a spec by its entries."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif want is None:
        assert got is None, where
    elif hasattr(want, "_fields"):
        assert tuple(type(got)._fields) == tuple(want._fields), where
        for f in want._fields:
            _same(getattr(got, f), getattr(want, f), f"{where}.{f}")
    else:
        assert isinstance(got, P) and tuple(got) == tuple(want), (where, got, want)


def _ref_bytes(abstract, specs, mesh) -> int:
    """A numpy count of the bytes a device holds: every leaf's shard shape
    from the reference's spec and the mesh's axis sizes."""
    import jax

    total = 0
    leaves = jax.tree.leaves(abstract)
    flat_specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, rsh.P))
    assert len(leaves) == len(flat_specs)
    for a, ps in zip(leaves, flat_specs):
        shard = []
        for dim, axes in zip(a.shape, tuple(ps) + (None,) * (len(a.shape) - len(ps))):
            axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
            shard.append(dim // int(np.prod([mesh.shape[x] for x in axes])))
        total += int(np.prod(shard)) * np.dtype(a.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pspecs_equal_the_reference(arch):
    """Params, the train state (float32 moments; quantized moments, with and
    without the error-feedback residual), every eligible cell's cache and
    batch, on both meshes: the port's specs are ``repro``'s, entry for entry,
    and the train state's and the cache's bytes a device are a numpy count
    over ``repro``'s abstract shapes and specs."""
    cfg, rcfg = get_config(arch), r_get_config(arch)
    model, rmodel = Model(cfg), RModel(rcfg)
    for mesh in (SINGLE, MULTI):
        rmesh = _ref_mesh(mesh)
        _same(model.param_pspecs(mesh, RULES), rmodel.param_pspecs(rmesh, R_RULES), "params")
        for kw in TRAIN_CONFIGS:
            state = S.train_state_abstract(model, TrainConfig(**kw))
            rstate = RS.train_state_abstract(rmodel, RTrainConfig(**kw))
            got = S.train_state_pspecs(model, state, mesh, RULES)
            want = RS.train_state_pspecs(rmodel, rstate, rmesh, R_RULES)
            _same(got, want, f"state {kw}")
            assert S.per_device_bytes(state, got, mesh) == _ref_bytes(rstate, want, rmesh)
        for cell in shapes_for(cfg):
            cache, rcache = S.cache_abstract(cfg, cell), RS.cache_abstract(rcfg, cell)
            cps, rcps = S.cache_pspecs(cache, mesh, RULES), RS.cache_pspecs(rcache, rmesh, R_RULES)
            _same(cps, rcps, f"cache {cell.name}")
            assert S.per_device_bytes(cache, cps, mesh) == _ref_bytes(rcache, rcps, rmesh)
            batch, rbatch = S.input_specs(cfg, cell), RS.input_specs(rcfg, cell)
            _same(S.batch_pspecs(batch, mesh, RULES), RS.batch_pspecs(rbatch, rmesh, R_RULES),
                  f"batch {cell.name}")


# -- placements ---------------------------------------------------------------------


def test_placements_follow_the_mesh_axes():
    """One placement per mesh dimension in the mesh's order; a dim split over
    ("pod", "data") is Shard on both, the pod the major split."""
    assert placements(P(("pod", "data"), None, "model"), MULTI) == (Shard(0), Shard(0),
                                                                    Shard(2))
    assert placements(P(None, "data"), MULTI) == (Replicate(), Shard(1), Replicate())
    assert placements(P(), SINGLE) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        placements(P(("data", "pod")), MULTI)
    # the shard of global rows a device (pod p, data d) holds: p * 16 + d
    assert local_shape((256, 8), P(("pod", "data"), None), MULTI) == (8, 8)
    assert local_shape((8, 3), P("pod", None), MULTI) == (4, 3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_device_mesh_needs_exactly_its_ranks():
    """``device_mesh()`` raises naming both counts without a group of the
    mesh's size, and builds the ``DeviceMesh`` with one (a 1-rank gloo group
    for a 1 x 1 mesh); ``shardings`` carries it, or ``None``."""
    with pytest.raises(ValueError, match="needs 256 ranks; the default process group has 1"):
        SINGLE.device_mesh()
    defs = Model(get_config("granite-20b", reduced=True)).defs()
    sh = shardings(defs, SINGLE, RULES)
    assert sh["embed"].device_mesh is None and sh["embed"].spec == ("model", "data")
    assert sh["embed"].placements == (Shard(1), Shard(0))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_cpu_mesh(1, 1)
        dm = mesh.device_mesh("cpu")
        assert dm.mesh_dim_names == ("data", "model") and dm.size() == 1
        assert shardings(defs, mesh, RULES)["embed"].device_mesh is not None
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_cpu_mesh(2, 1).device_mesh("cpu")
    finally:
        dist.destroy_process_group()


# -- the MoE dispatch on meta tensors -------------------------------------------------


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_counts_replace_bincount_bitwise(arch, monkeypatch):
    """The expert counts (a comparison with ``arange(E)`` summed in int64) are
    ``bincount``'s, so ``moe_ffn``'s output, aux loss and kept mask are the
    bits the ``bincount`` form gave; and the FFN runs on ``meta`` tensors,
    where ``bincount`` has no kernel."""
    from repro_torch.models import moe

    cfg = get_config(arch, reduced=True)
    p = Model(cfg).init(jr.PRNGKey(0))["blocks"]
    p = {k: v[-1] for k, v in p["moe"].items()}
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 7, cfg.d_model)),
                        dtype=torch.float32)
    topi = moe.route(cfg, p, x.reshape(-1, cfg.d_model)).topi
    want_counts = torch.bincount(topi.reshape(-1), minlength=cfg.moe.n_experts)
    assert torch.equal(moe.expert_counts(topi, cfg.moe.n_experts), want_counts)
    got = moe.moe_ffn(cfg, p, x, capacity_factor=0.5)
    monkeypatch.setattr(moe, "expert_counts",
                        lambda t, e: torch.bincount(t.reshape(-1), minlength=e))
    want = moe.moe_ffn(cfg, p, x, capacity_factor=0.5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    monkeypatch.undo()
    meta = {k: v.to("meta") for k, v in p.items()}
    y, aux = moe.moe_ffn(cfg, meta, x.to("meta"))
    assert y.device.type == "meta" and tuple(y.shape) == tuple(x.shape)


# -- the planner -------------------------------------------------------------------


#: one arch per family, each on its decode cell (the cheapest step to plan)
FAMILY_ARCHS = ["granite-20b", "gemma2-9b", "qwen2-vl-72b", "dbrx-132b", "mamba2-130m",
                "zamba2-7b", "whisper-large-v3"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_plan_cell_full_config(arch):
    """``plan_cell`` on the full config: status ``ok``, the reference's keys,
    argument bytes a device the numpy count over ``repro``'s abstract params,
    cache and batch with their specs, FLOPs an even split."""
    rec = dryrun.plan_cell(arch, "decode_32k", "multi")
    assert rec["status"] == "ok" and rec["n_chips"] == 512
    for key in ("arch", "shape", "mesh", "n_params", "n_active_params", "flops_per_device",
                "argument_bytes_per_device", "output_bytes_per_device",
                "temp_bytes_per_device", "bytes_accessed_per_device", "peak_hbm_per_device",
                "collective_bytes_per_device", "plan_s", "not_available"):
        assert key in rec, key
    assert rec["temp_bytes_per_device"] is None and rec["collective_bytes_per_device"] is None
    rcfg = r_get_config(arch)
    assert rec["n_params"] == rcfg.n_params()
    assert rec["flops_per_device"] == rec["flops_total"] / 512 > 0
    rmodel, rmesh = RModel(rcfg), _ref_mesh(MULTI)
    cell = {c.name: c for c in shapes_for(get_config(arch))}["decode_32k"]
    rcache, rbatch = RS.cache_abstract(rcfg, cell), RS.input_specs(rcfg, cell)
    want = (_ref_bytes(rmodel.abstract_params(), rmodel.param_pspecs(rmesh, R_RULES), rmesh)
            + _ref_bytes(rbatch, RS.batch_pspecs(rbatch, rmesh, R_RULES), rmesh)
            + _ref_bytes(rcache, RS.cache_pspecs(rcache, rmesh, R_RULES), rmesh))
    assert rec["argument_bytes_per_device"] == want


def test_plan_skips_long_context_for_quadratic_attention():
    rec = dryrun.plan_cell("granite-20b", "long_500k", "single")
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert dryrun.plan_cell("mamba2-130m", "long_500k", "single")["status"] == "ok"


def test_plan_train_cell_with_quantized_moments():
    """A train cell over meta tensors (one layer of granite-20b at full width):
    autograd, the clip and AdamW with int8 moments and compressed gradients
    run on meta; arguments and outputs are the same state layout."""
    rec = dryrun.plan_cell("granite-20b", "train_4k", "single", config_overrides={"n_layers": 1},
                           extra={"quantize_moments": True, "compress_grads": True})
    assert rec["status"] == "ok" and rec["flops_total"] > 0
    assert rec["output_bytes_per_device"] < rec["argument_bytes_per_device"]  # no batch out


def test_calibrated_flops_equal_the_direct_count():
    """Two reduced-layer plans extrapolate to the full plan's count: the
    counter counts every layer (the reference's needs the calibration, its
    cost model counting a scanned layer once)."""
    direct = dryrun.plan_cell("gemma2-9b", "decode_32k", "single")
    calib = dryrun.calibrate_cell("gemma2-9b", "decode_32k", "single")
    assert calib["status"] == "ok" and (calib["k1"], calib["k2"]) == (2, 4)
    np.testing.assert_allclose(calib["flops_per_device"], direct["flops_per_device"], rtol=1e-12)


def test_dense_flops_by_hand():
    """One layer of granite-20b at full width, a decode step at the decode
    cell (batch 128, a cache of 32,768): the FLOPs counted by hand, 2 per
    multiply-add of every product."""
    cfg = get_config("granite-20b")
    b, s, d, h, kv, hd, ff, v = (128, 32768, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.resolved_head_dim, cfg.d_ff, cfg.vocab)
    layer = (2 * b * d * h * hd  # q
             + 2 * 2 * b * d * kv * hd  # k, v
             + 2 * 2 * b * h * s * hd  # scores and values over the cache
             + 2 * b * h * hd * d  # o
             + 2 * 2 * b * d * ff)  # the MLP's up and down
    want = layer + 2 * b * d * v  # the head
    rec = dryrun.plan_cell("granite-20b", "decode_32k", "single",
                           config_overrides={"n_layers": 1})
    assert rec["flops_total"] == want
