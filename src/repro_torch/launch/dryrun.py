"""The dry-run planner: every (arch x shape x mesh) cell's step run sharded
over a fake process group of the mesh's size (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step against the
production TPU meshes (16 x 16 and 2 x 16 x 16) and reads XLA's
``memory_analysis``, ``cost_analysis`` and the HLO's collectives.  The port
runs the sharded step itself (``train_step``, ``prefill`` or
``decode_step`` on DTensors, the step ``launch/train.py --mesh`` trains
with) as rank 0 of a ``fake`` process group of ``n_chips`` ranks, on the
``(16, 16)`` or ``(2, 16, 16)`` ``DeviceMesh``.  Every argument is a DTensor
over a ``meta`` shard placed by the logical-axis rules
(``distributed/sharding.py``), so nothing is allocated, and the fake group's
collectives move nothing.  ``distributed/accounting.py`` counts what the
device does as it runs.  A record gives, for one device:

* ``argument_bytes_per_device`` / ``output_bytes_per_device``: the local
  shards of the arguments and outputs;
* ``collective_bytes_per_device``: the operand bytes of each collective the
  device issues, by the reference's five kinds, and their sum
  ``collective_bytes_total``;
* ``flops_per_device``: the device's own FLOPs (the products, counted on
  its local shapes; every device's shards have the same shapes, so every
  device's count), ``flops_total`` the step's FLOPs with each product
  counted once (``flops_split`` says so);
* ``peak_hbm_per_device``: the most live local bytes during the step,
  ``temp_bytes_per_device`` that peak less the arguments and outputs;
* ``bytes_accessed_per_device``: every operation's operands and results,
  unfused (``bytes_accessed_kind`` says so; XLA counts a fused program);
* ``plan_s``, in place of the reference's ``compile_s``;
* ``not_available``: ``None``, every field counted.

All of it is computed on the host: no device runs.  ``fake_pg`` lives in
``torch.testing._internal``, a private module of PyTorch.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-20b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --calibrate --arch granite-20b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--jobs 4] [--out dryrun_results.json]

A single cell prints one JSON record on its last line; ``--all`` runs the
cells in subprocesses and writes the records to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from repro_torch.core.topology import make_production_mesh
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.accounting import KINDS, StepAccount
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import make_rules, mesh_context
from repro_torch.launch import specs as S
from repro_torch.models import Model, get_config, shapes_for
from repro_torch.models.config import ALL_SHAPES, ARCH_IDS, Family
from repro_torch.train.step import TrainConfig, train_step

SKIP_REASON = "long_500k requires sub-quadratic attention (DESIGN.md Shape skips)"
FLOPS_SPLIT = ("measured: one device's FLOPs in the sharded step, on its local shapes (every "
               "device's shards have the same shapes); more than flops_total / n_chips where a "
               "product is replicated (KV heads that do not divide the model axis)")
BYTES_ACCESSED_KIND = ("unfused: every operation's local operands plus its results, views "
                       "excluded; XLA's bytes accessed are of a fused program")

# Named perf presets: sharding-rule overrides + config overrides (the reference's).
RULE_PRESETS: dict[str, dict] = {
    "baseline": {"rules": {}, "config": {}},
    # flash-decoding: shard the KV cache (and decode attention) over the
    # model axis along kv_seq instead of replicating indivisible kv_heads
    "seqkv": {"rules": {"kv_seq": "model", "kv_heads": None}, "config": {}},
    # + drop activation checkpointing at inference
    "seqkv_noremat": {"rules": {"kv_seq": "model", "kv_heads": None},
                      "config": {"remat": "none"}},
    "noremat": {"rules": {}, "config": {"remat": "none"}},
    # mixed-precision attention: bf16 score/weight tensors, f32 row sums
    "bf16attn": {"rules": {}, "config": {"attn_scores_bf16": True}},
    # + mixed-precision norms: f32 only for the (...,1) variance statistics
    "bf16stream": {"rules": {},
                   "config": {"attn_scores_bf16": True, "norms_bf16": True}},
}


def calib_layer_counts(cfg) -> tuple[dict, dict, int, int]:
    """Two reduced-layer overrides with identical per-layer math + (k1, k2),
    respecting each family's structural period (gemma2 local/global pairs,
    zamba2 shared-attention groups, MoE dense prefixes, enc-dec stacks).
    The caller extrapolates ``f(k1) + (L - k1) * (f(k2) - f(k1)) / (k2 - k1)``.
    The counter counts every layer, so where the FLOPs are linear in the
    depth the extrapolation equals the full plan's count: a self-check."""
    if cfg.family is Family.ENC_DEC:
        return ({"n_layers": 2, "n_encoder_layers": 2},
                {"n_layers": 4, "n_encoder_layers": 4}, 2, 4)
    if cfg.local_global_pattern:
        return ({"n_layers": 2}, {"n_layers": 4}, 2, 4)
    if cfg.family is Family.HYBRID and cfg.attn_every:
        p = cfg.attn_every
        return ({"n_layers": p}, {"n_layers": 2 * p}, p, 2 * p)
    if cfg.family is Family.MOE and cfg.moe.first_k_dense:
        f = cfg.moe.first_k_dense
        return ({"n_layers": f + 1}, {"n_layers": f + 2}, f + 1, f + 2)
    return ({"n_layers": 1}, {"n_layers": 2}, 1, 2)


def _cell_config(arch: str, rules_preset: str, config_overrides: dict | None):
    cfg = get_config(arch)
    preset = RULE_PRESETS[rules_preset]
    if preset["config"]:
        cfg = cfg.with_(**preset["config"])
    if config_overrides:
        cfg = cfg.with_(**config_overrides)
    return cfg


@contextlib.contextmanager
def fake_device_mesh(mesh):
    """The ``DeviceMesh`` of ``mesh`` over a ``fake`` process group of
    ``mesh.size`` ranks, this process rank 0, destroyed on exit.  The
    process must have no process group of its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the planner runs in a process without a process group")
    dist.init_process_group("fake", rank=0, world_size=mesh.size, store=FakeStore())
    try:
        yield mesh.device_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _run_step(model: Model, cell, mesh, rules, tc: TrainConfig, device_mesh, acct: StepAccount):
    """The cell's sharded step on DTensors over meta shards, counted by
    ``acct``: (arguments, their specs, outputs, their specs)."""
    cfg = model.cfg
    batch = S.input_specs(cfg, cell)
    batch_ps = S.batch_pspecs(batch, mesh, rules)
    dbatch = SH.distribute(batch, batch_ps, device_mesh)
    if cell.kind == "train":
        state = S.train_state_abstract(model, tc)
        state_ps = S.train_state_pspecs(model, state, mesh, rules)
        args = (SH.distribute(state, state_ps, device_mesh), dbatch)
        acct.hold(args)
        with acct:
            new_state, metrics = train_step(model, tc, *args)
        return (args, (state_ps, batch_ps), (new_state, metrics),
                (state_ps, {k: P() for k in metrics}))
    params_ps = model.param_pspecs(mesh, rules)
    cache = S.cache_abstract(cfg, cell)
    cache_ps = S.cache_pspecs(cache, mesh, rules)
    args = (SH.distribute(model.abstract_params(), params_ps, device_mesh), dbatch,
            SH.distribute(cache, cache_ps, device_mesh))
    acct.hold(args)
    params, batch, cache = args
    with acct:
        if cell.kind == "prefill":
            logits, new_cache = model.prefill(params, batch["tokens"], cache,
                                              encoder_frames=batch.get("encoder_frames"))
        else:
            logits, new_cache = model.decode_step(params, batch["tokens"], cache)
    return (args, (params_ps, batch_ps, cache_ps), (logits, new_cache),
            (S.logits_pspec(logits, mesh, rules), S.cache_pspecs(new_cache, mesh, rules)))


def plan(model: Model, cell, mesh, rules, tc: TrainConfig | None = None) -> dict:
    """Run ``cell``'s sharded step of ``model`` as rank 0 of a fake group of
    ``mesh.size`` ranks; returns the counted fields of the record (any mesh
    and cell: the planner's cells, or a reduced config on a small mesh)."""
    acct = StepAccount()
    with fake_device_mesh(mesh) as device_mesh, mesh_context(mesh, rules):
        args, args_ps, outs, outs_ps = _run_step(model, cell, mesh, rules, tc or TrainConfig(),
                                                 device_mesh, acct)
        counted = acct.record(StepAccount.storage_bytes(args), StepAccount.storage_bytes(outs))
        counted["argument_bytes_per_device"] = S.per_device_bytes(args, args_ps, mesh)
        counted["output_bytes_per_device"] = S.per_device_bytes(outs, outs_ps, mesh)
    return counted


def plan_cell(arch: str, shape_name: str, mesh_kind: str, *, extra: dict | None = None,
              config_overrides: dict | None = None, rules_preset: str = "baseline") -> dict:
    """Run one cell's sharded step on a fake group; returns the dry-run record."""
    cfg = _cell_config(arch, rules_preset, config_overrides)
    cell = {c.name: c for c in ALL_SHAPES}[shape_name]
    if cell not in shapes_for(cfg):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "skipped",
                "reason": SKIP_REASON}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.perf_counter()
    counted = plan(Model(cfg), cell, mesh, make_rules(RULE_PRESETS[rules_preset]["rules"]),
                   TrainConfig(**(extra or {})))
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "status": "ok",
        "n_chips": mesh.size,
        "plan_s": round(time.perf_counter() - t0, 1),
        "n_params": int(cfg.n_params()),
        "n_active_params": int(cfg.n_active_params()),
        "flops_per_device": counted["flops_per_device"],
        "flops_total": counted["flops_total"],
        "flops_split": FLOPS_SPLIT,
        "argument_bytes_per_device": counted["argument_bytes_per_device"],
        "output_bytes_per_device": counted["output_bytes_per_device"],
        "temp_bytes_per_device": counted["temp_bytes_per_device"],
        "bytes_accessed_per_device": counted["bytes_accessed_per_device"],
        "bytes_accessed_kind": BYTES_ACCESSED_KIND,
        "peak_hbm_per_device": counted["peak_hbm_per_device"],
        "collective_bytes_per_device": counted["collective_bytes_per_device"],
        "collective_bytes_total": counted["collective_bytes_total"],
        "not_available": None,
    }


#: the record's fields the calibration extrapolates in the depth, as the reference's
_EXTRAPOLATED_KEYS = ("flops_per_device", "bytes_accessed_per_device")


def calibrate_cell(arch: str, shape_name: str, mesh_kind: str,
                   rules_preset: str = "baseline") -> dict:
    """FLOPs, bytes accessed and each kind's collective bytes extrapolated
    from two reduced-layer plans, as the reference calibrates (its cost model
    counts a scanned layer once; the port's plan counts every layer, so on a
    family whose per-layer cost is the same at every depth the extrapolation
    equals the full plan: a self-check)."""
    cfg = get_config(arch)
    ov1, ov2, k1, k2 = calib_layer_counts(cfg)
    r1 = plan_cell(arch, shape_name, mesh_kind, rules_preset=rules_preset,
                   config_overrides={**ov1, "scan_layers": False})
    r2 = plan_cell(arch, shape_name, mesh_kind, rules_preset=rules_preset,
                   config_overrides={**ov2, "scan_layers": False})
    if r1["status"] != "ok" or r2["status"] != "ok":
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "calib_failed"}
    scale = (cfg.n_layers - k1) / (k2 - k1)

    def extrap(a, b):
        return a + scale * (b - a)

    out = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "ok",
           "calibrated": True, "k1": k1, "k2": k2, "n_chips": r1["n_chips"],
           "n_params": int(cfg.n_params()), "n_active_params": int(cfg.n_active_params()),
           "flops_split": FLOPS_SPLIT}
    for key in _EXTRAPOLATED_KEYS:
        out[key] = float(extrap(r1[key], r2[key]))
    coll = {kind: int(max(extrap(r1["collective_bytes_per_device"][kind],
                                 r2["collective_bytes_per_device"][kind]), 0)) for kind in KINDS}
    out["collective_bytes_per_device"] = coll
    out["collective_bytes_total"] = int(sum(coll.values()))
    return out


# -- orchestration --------------------------------------------------------------------


def iter_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for cell in ALL_SHAPES:
            yield arch, cell.name, (cell in shapes_for(cfg))


def _subprocess_record(cmd: list[str], tag: dict) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600, env=env)
    except subprocess.TimeoutExpired:
        return {**tag, "status": "timeout"}
    if proc.returncode != 0:
        return {**tag, "status": "error", "error": proc.stderr.strip().splitlines()[-12:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _cell_cmd(arch: str, shape: str, mesh_kind: str, *flags: str) -> list[str]:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", *flags,
            "--arch", arch, "--shape", shape, "--mesh", mesh_kind]


def _fan_out(tasks, run_one, jobs: int, out_path: str, label) -> list[dict]:
    results = []
    with ThreadPoolExecutor(max_workers=jobs) as ex:
        for rec in ex.map(run_one, tasks):
            results.append(rec)
            print(label(rec), flush=True)
            if out_path:
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
    return results


def run_all(jobs: int, out_path: str, meshes=("single", "multi")) -> list[dict]:
    tasks = [(arch, shape, mesh_kind, eligible) for arch, shape, eligible in iter_cells()
             for mesh_kind in meshes]

    def run_one(task):
        arch, shape, mesh_kind, eligible = task
        tag = {"arch": arch, "shape": shape, "mesh": mesh_kind}
        if not eligible:
            return {**tag, "status": "skipped", "reason": SKIP_REASON}
        return _subprocess_record(_cell_cmd(arch, shape, mesh_kind), tag)

    return _fan_out(tasks, run_one, jobs, out_path, lambda r: (
        f"[dryrun] {r['arch'] + ' x ' + r['shape'] + ' x ' + r['mesh']:60s} {r['status']}"))


def calibrate_all(jobs: int, out_path: str, mesh_kind: str = "single") -> list[dict]:
    """Calibrated FLOPs for every eligible cell (subprocess-isolated)."""
    tasks = [(arch, shape) for arch, shape, eligible in iter_cells() if eligible]

    def run_one(task):
        arch, shape = task
        return _subprocess_record(_cell_cmd(arch, shape, mesh_kind, "--calibrate"),
                                  {"arch": arch, "shape": shape, "mesh": mesh_kind})

    return _fan_out(tasks, run_one, jobs, out_path,
                    lambda r: f"[calib] {r['arch']} x {r['shape']}: {r['status']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[c.name for c in ALL_SHAPES])
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--calibrate", action="store_true",
                    help="FLOPs extrapolated from two reduced-layer plans, for one cell")
    ap.add_argument("--calibrate-all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--rules", default="baseline", choices=sorted(RULE_PRESETS))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    if args.all:
        results = run_all(args.jobs, args.out)
        ok = sum(r["status"] == "ok" for r in results)
        skipped = sum(r["status"] == "skipped" for r in results)
        bad = [r for r in results if r["status"] not in ("ok", "skipped")]
        print(f"[dryrun] ok={ok} skipped={skipped} failed={len(bad)}")
        for r in bad:
            print("  FAILED:", r["arch"], r["shape"], r["mesh"])
        sys.exit(1 if bad else 0)

    if args.calibrate_all:
        results = calibrate_all(args.jobs, args.out, args.mesh)
        sys.exit(1 if any(r["status"] != "ok" for r in results) else 0)

    if args.calibrate:
        record = calibrate_cell(args.arch, args.shape, args.mesh, args.rules)
    else:
        record = plan_cell(args.arch, args.shape, args.mesh, rules_preset=args.rules)
    record["rules"] = args.rules
    print(json.dumps(record))


if __name__ == "__main__":
    main()
