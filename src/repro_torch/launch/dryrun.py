"""The dry-run planner: every (arch x shape x mesh) cell planned over ``meta``
tensors (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step against the
production TPU meshes (16 x 16 and 2 x 16 x 16) and reads XLA's
``memory_analysis``, ``cost_analysis`` and the HLO's collectives.  The port
has no XLA.  It runs the same step (``train_step``, ``prefill`` or
``decode_step``) on ``meta`` tensors, which carry shapes and dtypes and no
storage, under ``torch.utils.flop_counter.FlopCounterMode``, and places
every argument and output by the same logical-axis rules
(``distributed/sharding.py``).  A record gives:

* ``argument_bytes_per_device`` / ``output_bytes_per_device``: exact, from
  the placements, on the device that holds the most;
* ``flops_per_device``: the step's global FLOPs as the counter counts them
  (the products: matmuls, ``bmm``, convolutions, attention kernels) divided
  by ``n_chips``, an even split (``flops_split`` says so);
* ``plan_s``, in place of the reference's ``compile_s``.

``temp_bytes_per_device``, ``bytes_accessed_per_device``,
``peak_hbm_per_device`` and ``collective_bytes_per_device`` are ``null``
(``not_available`` says why): they come from a compiled program's buffer
assignment and from the collectives an SPMD partitioner inserts into its
HLO, and the port has neither a compiler that assigns buffers for a mesh
nor a partitioner.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-20b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --calibrate --arch granite-20b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--jobs 4] [--out dryrun_results.json]

A single cell prints one JSON record on its last line; ``--all`` runs the
cells in subprocesses and writes the records to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.topology import make_production_mesh
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import make_rules, mesh_context
from repro_torch.launch import specs as S
from repro_torch.models import Model, get_config, shapes_for
from repro_torch.models.config import ALL_SHAPES, ARCH_IDS, Family
from repro_torch.train.step import TrainConfig, train_step

SKIP_REASON = "long_500k requires sub-quadratic attention (DESIGN.md Shape skips)"
FLOPS_SPLIT = "even: the step's global FLOPs (FlopCounterMode over meta tensors) / n_chips"
NOT_AVAILABLE = ("temp, accessed and peak bytes come from a compiled buffer assignment and "
                 "collective bytes from an SPMD-partitioned HLO; the port has neither")

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


def _run_step(model: Model, cell, mesh, rules, tc: TrainConfig):
    """The cell's step on meta tensors: (arguments, their specs, outputs,
    their specs)."""
    cfg = model.cfg
    batch = S.input_specs(cfg, cell)
    batch_ps = S.batch_pspecs(batch, mesh, rules)
    if cell.kind == "train":
        state = S.train_state_abstract(model, tc)
        state_ps = S.train_state_pspecs(model, state, mesh, rules)
        new_state, metrics = train_step(model, tc, state, batch)
        return ((state, batch), (state_ps, batch_ps),
                (new_state, metrics), (state_ps, {k: P() for k in metrics}))
    params = model.abstract_params()
    params_ps = model.param_pspecs(mesh, rules)
    cache = S.cache_abstract(cfg, cell)
    cache_ps = S.cache_pspecs(cache, mesh, rules)
    if cell.kind == "prefill":
        logits, new_cache = model.prefill(params, batch["tokens"], cache,
                                          encoder_frames=batch.get("encoder_frames"))
    else:
        logits, new_cache = model.decode_step(params, batch["tokens"], cache)
    return ((params, batch, cache), (params_ps, batch_ps, cache_ps),
            (logits, new_cache), (P(), S.cache_pspecs(new_cache, mesh, rules)))


def plan_cell(arch: str, shape_name: str, mesh_kind: str, *, extra: dict | None = None,
              config_overrides: dict | None = None, rules_preset: str = "baseline") -> dict:
    """Plan one cell over meta tensors; returns the dry-run record."""
    cfg = _cell_config(arch, rules_preset, config_overrides)
    cell = {c.name: c for c in ALL_SHAPES}[shape_name]
    if cell not in shapes_for(cfg):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "skipped",
                "reason": SKIP_REASON}
    model = Model(cfg)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rules = make_rules(RULE_PRESETS[rules_preset]["rules"])
    t0 = time.perf_counter()
    with mesh_context(mesh, rules), FlopCounterMode(display=False) as counter:
        args, args_ps, outs, outs_ps = _run_step(model, cell, mesh, rules,
                                                 TrainConfig(**(extra or {})))
    flops = counter.get_total_flops()
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "status": "ok",
        "n_chips": mesh.size,
        "plan_s": round(time.perf_counter() - t0, 1),
        "n_params": int(cfg.n_params()),
        "n_active_params": int(cfg.n_active_params()),
        "flops_per_device": flops / mesh.size,
        "flops_total": int(flops),
        "flops_split": FLOPS_SPLIT,
        "argument_bytes_per_device": S.per_device_bytes(args, args_ps, mesh),
        "output_bytes_per_device": S.per_device_bytes(outs, outs_ps, mesh),
        "temp_bytes_per_device": None,
        "bytes_accessed_per_device": None,
        "peak_hbm_per_device": None,
        "collective_bytes_per_device": None,
        "collective_bytes_total": None,
        "not_available": NOT_AVAILABLE,
    }


def calibrate_cell(arch: str, shape_name: str, mesh_kind: str,
                   rules_preset: str = "baseline") -> dict:
    """FLOPs per device extrapolated from two reduced-layer plans, as the
    reference calibrates (its cost model counts a scanned layer once)."""
    cfg = get_config(arch)
    ov1, ov2, k1, k2 = calib_layer_counts(cfg)
    r1 = plan_cell(arch, shape_name, mesh_kind, rules_preset=rules_preset,
                   config_overrides={**ov1, "scan_layers": False})
    r2 = plan_cell(arch, shape_name, mesh_kind, rules_preset=rules_preset,
                   config_overrides={**ov2, "scan_layers": False})
    if r1["status"] != "ok" or r2["status"] != "ok":
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "calib_failed"}
    scale = (cfg.n_layers - k1) / (k2 - k1)
    a, b = r1["flops_per_device"], r2["flops_per_device"]
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "ok",
            "calibrated": True, "k1": k1, "k2": k2, "n_chips": r1["n_chips"],
            "n_params": int(cfg.n_params()), "n_active_params": int(cfg.n_active_params()),
            "flops_per_device": float(a + scale * (b - a)), "flops_split": FLOPS_SPLIT}


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
