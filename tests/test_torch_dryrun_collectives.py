"""The planner's counts against a real group, by hand and against its own
calibration.

* A reduced cell planned on a fake group of 4 ranks (mesh data 2 x model 2,
  ``launch/dryrun.py`` ``plan``) counts the same collective bytes a device,
  kind by kind, as a real group of 4 gloo ranks running the same step on
  real tensors, both through ``distributed/accounting.py``'s counter: the
  dense family's train, prefill and decode steps, and the local/global
  family's train step.
* One term counted by hand: the FSDP all-gather of every weight, the dense
  MLP's among them, in the forward and again in the remat's recompute.
* The calibrated plan (two reduced-layer plans extrapolated) equals the
  direct one for FLOPs and for each collective kind.
* A full-config cell (granite-20b x train_4k x single) has its five
  compiled-program fields set.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import topology as ttopo
from repro_torch.core.topology import make_cpu_mesh
from repro_torch.distributed.accounting import KINDS
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import dryrun
from repro_torch.models import Model, get_config
from repro_torch.models.config import ShapeCell

torch.set_num_threads(1)

ARCHS = ("granite-20b", "gemma2-9b")
#: a reduced cell of each kind: batch 4, 16 tokens (decode: a cache of 16)
CELLS = (ShapeCell("tiny_train", 16, 4, "train"), ShapeCell("tiny_prefill", 16, 4, "prefill"),
         ShapeCell("tiny_decode", 16, 4, "decode"))
#: the calibration's extrapolation of FLOPs, in float64: exact up to rounding
CALIB_RTOL = 1e-12


def _real_run(rank, arch, cell):
    """``cell``'s sharded step of the reduced ``arch`` on real tensors in this
    rank's group, counted; the arguments are built as the planner builds its
    ``meta`` ones (``launch/specs.py``), with real values."""
    from repro_torch import random as jr
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.accounting import StepAccount
    from repro_torch.launch import specs as SP
    from repro_torch.train.step import TrainConfig, init_train_state, train_step

    cfg = get_config(arch, reduced=True)
    model, mesh, rules = Model(cfg), make_cpu_mesh(2, 2), make_rules()
    device_mesh = mesh.device_mesh("cpu")
    params = model.init(jr.PRNGKey(0, "cpu"))
    rng = np.random.default_rng(rank)  # the counts depend on shapes only
    n = cell.seq_len if cell.kind != "decode" else 1
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (cell.global_batch, n), dtype=np.int32))
    batch = {"tokens": tokens, "labels": tokens} if cell.kind == "train" else {"tokens": tokens}
    acct = StepAccount()
    with S.mesh_context(mesh, rules):
        batch = S.distribute(batch, SP.batch_pspecs(batch, mesh, rules), device_mesh)
        if cell.kind == "train":
            tc = TrainConfig()
            state = init_train_state(model, params, tc)
            state = S.distribute(state, SP.train_state_pspecs(model, state, mesh, rules),
                                 device_mesh)
            with acct:
                train_step(model, tc, state, batch)
        else:
            cache = model.init_cache(cell.global_batch, cell.seq_len, torch.bfloat16, "cpu")
            cache = S.distribute(cache, SP.cache_pspecs(cache, mesh, rules), device_mesh)
            params = S.distribute(params, model.param_pspecs(mesh, rules), device_mesh)
            with acct:
                if cell.kind == "prefill":
                    model.prefill(params, batch["tokens"], cache)
                else:
                    model.decode_step(params, batch["tokens"], cache)
    return dict(acct.collectives)


#: (arch, cell) pairs run on the real group
RUNS = [(ARCHS[0], cell) for cell in CELLS] + [(ARCHS[1], CELLS[0])]


def _ranks(rank):
    os.nice(5)  # yield the cores to the suite's workers
    return {(arch, cell.name): _real_run(rank, arch, cell) for arch, cell in RUNS}


@pytest.fixture(scope="module")
def gloo_counts():
    """Every rank's counts: the same on each (SPMD)."""
    return ttopo.spawn_ranks(_ranks, 4, device="cpu")


@pytest.mark.parametrize("arch,cell", RUNS, ids=[f"{a}-{c.kind}" for a, c in RUNS])
def test_fake_group_plan_counts_the_real_collectives(arch, cell, gloo_counts):
    planned = dryrun.plan(Model(get_config(arch, reduced=True)), cell, make_cpu_mesh(2, 2),
                          make_rules())["collective_bytes_per_device"]
    assert set(planned) == set(KINDS)
    for rank_counts in gloo_counts:
        assert rank_counts[(arch, cell.name)] == planned
    # the step communicates: the tensor-parallel all-reduces at least
    assert planned["all-reduce"] > 0 and planned["collective-permute"] == 0


def _gathered_bytes(shape, sharded_dims):
    """Operand bytes of one FSDP all-gather of a float32 weight on the
    (data 2, model 2) mesh: its local shard, every named dim halved."""
    n = 4
    for i, d in enumerate(shape):
        n *= d // 2 if i in sharded_dims else d
    return n


def test_fsdp_all_gather_by_hand():
    """granite-20b reduced (d_model 64, 4 heads of 16, MQA, d_ff 128, vocab
    256, 2 layers) under remat ``block``: every weight whose ``embed`` dim
    is on ``data`` is gathered at its use, once in the forward and, inside a
    block, once more in the backward's recompute; the gradient goes back as
    a reduce-scatter.  The all-gather's operand is the weight's local shard
    (``embed`` on data 2, ``heads``/``ff``/``vocab`` on model 2)."""
    cfg = get_config("granite-20b", reduced=True).with_(remat="block")
    d, h, hd, ff, v = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab
    mlp = _gathered_bytes((d, ff), (0, 1)) + _gathered_bytes((ff, d), (0, 1))  # w_up, w_down
    attn = (_gathered_bytes((d, h, hd), (0, 1))  # wq: heads on model
            + 2 * _gathered_bytes((d, 1, hd), (0,))  # wk, wv: one KV head, replicated
            + _gathered_bytes((h, hd, d), (0, 2)))  # wo
    head = _gathered_bytes((v, d), (0, 1)) + _gathered_bytes((d, v), (0, 1))  # embed, lm_head
    per_pass = 2  # the forward and the recompute
    want = head + cfg.n_layers * per_pass * (attn + mlp)
    cell = CELLS[0]
    rec = dryrun.plan(Model(cfg), cell, make_cpu_mesh(2, 2), make_rules())
    assert rec["collective_bytes_per_device"]["all-gather"] == want
    # the MLP's term alone: doubling d_ff adds the MLP's gathers once more
    wide = dryrun.plan(Model(cfg.with_(d_ff=2 * ff)), cell, make_cpu_mesh(2, 2), make_rules())
    assert (wide["collective_bytes_per_device"]["all-gather"]
            - rec["collective_bytes_per_device"]["all-gather"]) == cfg.n_layers * per_pass * mlp
    # without remat the blocks' weights are gathered once
    plain = dryrun.plan(Model(cfg.with_(remat="none")), cell, make_cpu_mesh(2, 2), make_rules())
    assert plain["collective_bytes_per_device"]["all-gather"] == head + cfg.n_layers * (attn + mlp)


def test_calibration_equals_the_direct_plan():
    """gemma2-9b's decode cell: the two reduced-layer plans (2 and 4 layers,
    its local/global period) extrapolated to 42 layers equal the direct
    42-layer plan's FLOPs and each kind's collective bytes."""
    direct = dryrun.plan_cell("gemma2-9b", "decode_32k", "single")
    calib = dryrun.calibrate_cell("gemma2-9b", "decode_32k", "single")
    assert calib["status"] == "ok" and (calib["k1"], calib["k2"]) == (2, 4)
    np.testing.assert_allclose(calib["flops_per_device"], direct["flops_per_device"],
                               rtol=CALIB_RTOL)
    for kind in KINDS:
        np.testing.assert_allclose(calib["collective_bytes_per_device"][kind],
                                   direct["collective_bytes_per_device"][kind], rtol=CALIB_RTOL,
                                   err_msg=kind)
    assert direct["collective_bytes_total"] > 0


def test_full_config_train_cell_has_every_field():
    rec = dryrun.plan_cell("granite-20b", "train_4k", "single")
    assert rec["status"] == "ok" and rec["n_chips"] == 256 and rec["not_available"] is None
    coll = rec["collective_bytes_per_device"]
    assert set(coll) == set(KINDS) and rec["collective_bytes_total"] == sum(coll.values())
    # FSDP: weights gathered in the forward and the recompute, gradients
    # reduce-scattered; tensor parallelism: activations all-reduced
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0
    for key in ("temp_bytes_per_device", "bytes_accessed_per_device", "peak_hbm_per_device"):
        assert rec[key] > 0, key
    assert rec["peak_hbm_per_device"] >= (rec["temp_bytes_per_device"]
                                          + rec["argument_bytes_per_device"])
