"""One benchmark run of one cell: set-up, the window, the traced campaign,
the check against the reference, and the result line.

The cell's configuration names its program (``programs/<program>.py``,
``load_program``); the harness drives it and knows nothing of what it
computes.  ``Run`` carries what a run measured; the readers in
``metrics/<name>.py`` (one per metric of ``BENCHMARK.json``, each a
``read(run)`` that returns a number or ``None``) turn it into the line's
metrics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import os
import sys
import time
from typing import Any, Callable

import numpy as np

from arches_bench import cells, judge

#: top-level module names that may not be loaded in a run: JAX and the JAX
#: package the port was made from (compared whole: ``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the programs a configuration's ``"program"`` key names, one file each
PROGRAMS = cells.BENCH / "programs"


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, clock-tick resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    cell: cells.Cell
    setup_s: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)
    campaigns: list = dataclasses.field(default_factory=list)  # each ``program.campaign``'s
    campaign_seeds: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    energy_j: float | None = None
    trace: Any = None  # trace.Trace of the profiled campaign
    traced: dict | None = None  # that campaign's leaves

    @functools.cached_property
    def program(self):
        """The cell's program module (``programs/<program>.py``)."""
        return load_program(self.cell.program)

    @property
    def slot_ues(self) -> int:
        """The window's work: each campaign serves ``program.units(cell)``."""
        return len(self.campaigns) * self.program.units(self.cell)


def _load(path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name: str) -> Callable[[Run], float | None]:
    return _load(cells.BENCH / "metrics" / f"{name}.py", f"arches_bench_metric_{name}").read


@functools.cache
def _program_at(path):
    return _load(path, f"arches_bench_program_{path.stem}")


def load_program(name: str):
    """``programs/<name>.py``, loaded once a process: ``Program(cell,
    params_seed, device)`` with ``load_kernels()``, ``fit_policy(seed)`` and
    ``campaign(seed) -> dict``; ``reference(cell, seed, params_seed,
    device) -> dict``; ``compare(got, want) -> dict``; ``units(cell) ->
    int``; ``HOME``, the kernels that run in one span alone."""
    return _program_at(PROGRAMS / f"{name}.py")


def metric_entries(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a ``--trace 0`` (end to end) or ``--trace 1`` (per
    layer) run of ``workload`` reports."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def limits(workload: str) -> dict:
    return json.loads((cells.BENCH / "limits" / f"{workload}.json").read_text())


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, *, bench: dict,
        check_limits: dict, device: str = "cuda", log=print) -> dict:
    """One run of ``cell``; returns the result line's object (``checks``
    last).  ``bench`` is ``BENCHMARK.json``; ``check_limits`` the cell's
    limits."""
    import torch

    from arches_bench import power
    from arches_bench import trace as trace_mod

    r = Run(cell=cell)
    prog = r.program.Program(cell, cells.derive_seed(seed, "params"), device)
    gpu = device == "cuda"
    if gpu:
        t = time.perf_counter()
        prog.load_kernels()
        r.spans["kernel_load"] = time.perf_counter() - t
    t = time.perf_counter()
    prog.fit_policy(cells.derive_seed(seed, "warmup"))
    r.spans["policy_fit"] = time.perf_counter() - t
    # the card's power is sampled over the window of an end-to-end run
    sampler = power.PowerSampler(0) if gpu and not trace else contextlib.nullcontext()
    with sampler:
        prog.campaign(cells.derive_seed(seed, "warmup"))  # every shape of the cell, once
        sync(device)
        r.setup_s = process_age_s()
        t0_epoch, t0 = time.time(), time.perf_counter()
        ends = []
        while True:
            r.campaign_seeds.append(cells.derive_seed(seed, f"campaign{len(r.campaigns)}"))
            r.campaigns.append(prog.campaign(r.campaign_seeds[-1]))
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        sync(device)
        r.window_s = time.perf_counter() - t0
    log(f"window: {len(ends)} campaigns, each {np.diff([0.0] + ends).round(3).tolist()} s; "
        f"set-up {r.setup_s:.2f} s, spans {r.spans}")
    if isinstance(sampler, power.PowerSampler):
        r.energy_j = sampler.energy_j(t0_epoch, t0_epoch + r.window_s)
    dev_info = {"platform": "gpu" if gpu else "cpu",
                "kind": torch.cuda.get_device_name(0) if gpu else "cpu", "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)) if gpu else 0}
    extra = {}
    if trace:
        r.traced, r.trace = trace_mod.profile_campaign(
            lambda: prog.campaign(cells.derive_seed(seed, "traced")), lambda: sync(device))
        dev_info.update(busy_s=r.trace.busy_s(), window_s=r.trace.wall_s)
        extra["breakdown"] = {"device_ops": r.trace.top_ops(), "idle_gaps": r.trace.idle_gaps()}
    metrics = {}
    for m in metric_entries(bench, cell.name, trace):
        value = load_reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: one campaign of the window, drawn from the seed, against the reference
    del prog
    if gpu:
        torch.cuda.empty_cache()
    pick = cells.derive_seed(seed, "check") % len(r.campaigns)
    t = time.perf_counter()
    want = r.program.reference(cell, r.campaign_seeds[pick], cells.derive_seed(seed, "params"),
                               device)
    numbers = r.program.compare(r.campaigns[pick], want)
    correct, rows = judge.verdict(numbers, check_limits)
    log(f"reference: campaign {pick} of {len(r.campaigns)} (seed {r.campaign_seeds[pick]}) "
        f"in {time.perf_counter() - t:.2f} s; readings {numbers}")
    failed = sum(not all(np.isfinite(np.asarray(v, np.float64)).all() for v in c.values())
                 for c in r.campaigns)
    return {"correct": bool(correct and failed == 0), "attempted": len(r.campaigns),
            "failed": int(failed), "metrics": metrics, "device": dev_info, **extra,
            "checks": {k: {"value": v, "limit": lim} for k, v, lim in rows}}


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card and "
                                             "print its result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = cells.load_cell(args.workload)
    cache = cells.ROOT / ".bench_cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "repro_torch_build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(cells.ROOT / "src"))
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"arches_bench: needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"arches_bench: the program under test is missing: {exc}", file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    result = run(cell, args.seed, args.seconds, bool(args.trace), bench=cells.benchmark(),
                 check_limits=limits(cell.name), log=log)
    found = forbidden_modules()
    if found:
        log(f"arches_bench: the run loaded {found}, which the benchmark may not load")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
