"""Drive the PyTorch/CUDA port on one GPU: build, check and time every kernel,
run the closed-loop campaign at full width, and print a JSON verdict.

Usage (from the repository root, on a machine with an H100):

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for ``sm_90a``,
   one process per source, all started together;
3. kernels: each kernel at the main path's shapes against its plain
   PyTorch version (switch and tree bitwise, ``mmse_interp`` within
   ``MMSE_TOL``), with kernel, plain-version and library times and the
   card's lower bound for the same work;
4. main path: ``ArchesSession(...).run()`` of the closed-loop campaign at
   the paper's 106-PRB slot with 32 UEs and the estimator's default width;
   every kernel's launch counter must rise during the run, every trajectory
   leaf must be finite, and the device loop must equal its host replay;
5. reference: a small campaign on the card against the same campaign run
   by the plain versions on the CPU;
6. profile: one more closed-loop run under ``torch.profiler``: the
   device's busy share and its kernel time by name.

The last three lines are ``{"kernels": [...]}``, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Nothing is printed as a
result when CUDA is unavailable or the package cannot be imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

#: mmse_interp kernel vs its plain version: both accumulate 636 fp32 products
#: per output in different orders, and the Gauss form's p3 - p1 - p2
#: cancellation doubles the error of the largest partial product; with
#: unit-variance inputs the outputs are O(10), so 1e-4 absolute is ~1e-5
#: relative -- a few hundred ulp of accumulated rounding, far below any
#: physical effect.
MMSE_TOL = 1e-4
#: card vs CPU on the small reference campaign: float32 stages that round
#: differently (cuBLAS and the kernel vs the CPU's GEMMs) compound through
#: the slot loop's link adaptation; 1e-3 relative is well under 0.01 dB
REF_KPM_RTOL = 1e-3

N_UES, N_PRB, N_SLOTS = 32, 106, 40


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"build: {len(reports)} kernels compiled in "
        f"{time.perf_counter() - t0:.1f} s into {build.build_dir()}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_kernels() -> list[dict]:
    from repro_torch.kernels.mmse_interp import mmse_interp, mmse_interp_ref
    from repro_torch.kernels.switch_select import (
        switch_select,
        switch_select_batched_ref,
    )
    from repro_torch.kernels.tree_infer import tree_infer, tree_infer_ref
    from repro_torch.phy.estimators import WienerInterpolator
    from repro_torch.phy.nr import SlotConfig

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    cfg = SlotConfig(n_prb=N_PRB)
    rows = []

    # -- mmse_interp: (U*ant*dmrs, Np) @ (Np, Nsc) ------------------------------
    w = WienerInterpolator.build(cfg, device=dev).w
    b = N_UES * cfg.n_ant * cfg.n_dmrs_sym
    h = torch.complex(torch.randn(b, cfg.n_pilot_sc, generator=gen, device=dev),
                      torch.randn(b, cfg.n_pilot_sc, generator=gen, device=dev))
    got = mmse_interp(h, w)
    want = mmse_interp_ref(h, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= MMSE_TOL:
        raise AssertionError(f"mmse_interp max |err| {err} > {MMSE_TOL}")
    ms = time_ms(lambda: mmse_interp(h, w))
    plain = time_ms(lambda: mmse_interp_ref(h, w))
    lib = time_ms(lambda: torch.matmul(h, w))
    np_, nsc = cfg.n_pilot_sc, cfg.n_sc
    bms, by = bound_ms(8.0 * (b * np_ + np_ * nsc + b * nsc), 6.0 * b * np_ * nsc)
    rows.append(dict(
        name="mmse_interp", route="cuda", source="src/repro_torch/csrc/mmse_interp.cu",
        replaces="src/repro/kernels/mmse_interp/mmse_interp.py:54",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"H ({b}, {np_}) @ W ({np_}, {nsc}) complex64",
    ))

    # -- switch_select: (U, ant, 1, Nsc, dmrs) complex64, mixed modes -----------
    shape = (N_UES, cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym)
    des0 = torch.complex(torch.randn(shape, generator=gen, device=dev),
                         torch.randn(shape, generator=gen, device=dev))
    alt = torch.complex(torch.randn(shape, generator=gen, device=dev),
                        torch.randn(shape, generator=gen, device=dev))
    modes = (torch.arange(N_UES, device=dev) % 3 == 0).to(torch.int32)
    want = switch_select_batched_ref(modes, [des0, alt])
    des = des0.clone()
    got = switch_select(modes, [des, alt])
    torch.cuda.synchronize()
    if got.data_ptr() != des.data_ptr() or not torch.equal(got, want):
        raise AssertionError("switch_select kernel differs from its plain version")
    for m in (torch.zeros_like(modes), torch.ones_like(modes)):
        d = des0.clone()
        if not torch.equal(switch_select(m, [d, alt]),
                           switch_select_batched_ref(m, [des0, alt])):
            raise AssertionError("switch_select differs on a uniform mode vector")
    ms = time_ms(lambda: switch_select(modes, [des, alt]))
    plain = time_ms(lambda: switch_select_batched_ref(modes, [des0, alt]))
    mask = (modes != 0).reshape(-1, 1, 1, 1, 1)
    lib = time_ms(lambda: torch.where(mask, alt, des0))
    per_ue = des0[0].numel() * 8
    n_sw = int((modes != 0).sum())
    bms, by = bound_ms(2.0 * per_ue * n_sw + 4 * N_UES, 0.0)
    rows.append(dict(
        name="switch_select_batched", route="cuda",
        source="src/repro_torch/csrc/switch_select.cu",
        replaces="src/repro/kernels/switch_select/switch_select.py:156",
        launches=0, max_abs_err=0.0, ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"{shape} complex64, {n_sw}/{N_UES} UEs switched",
    ))

    # -- tree_infer: (U, F=10) against random level-order trees ----------------
    n_feat = 10
    x = torch.randn(N_UES, n_feat, generator=gen, device=dev)
    for depth in (2, 3, 5):
        for _ in range(20):
            n_nodes = 2**depth - 1
            feat = torch.randint(0, n_feat, (n_nodes,), generator=gen, device=dev,
                                 dtype=torch.int32)
            thr = torch.randn(n_nodes, generator=gen, device=dev)
            leaves = torch.randint(0, 2, (2**depth,), generator=gen,
                                   device=dev).to(torch.float32)
            if not torch.equal(tree_infer(x, feat, thr, leaves, depth),
                               tree_infer_ref(x, feat, thr, leaves, depth)):
                raise AssertionError(f"tree_infer differs at depth {depth}")
    feat = torch.tensor([5, 1, 3], dtype=torch.int32, device=dev)
    thr = torch.tensor([0.1, -0.2, 0.3], device=dev)
    leaves = torch.tensor([1.0, 0.0, 0.0, 1.0], device=dev)
    ms = time_ms(lambda: tree_infer(x, feat, thr, leaves, 2))
    plain = time_ms(lambda: tree_infer_ref(x, feat, thr, leaves, 2))
    bms, by = bound_ms(4.0 * N_UES * n_feat + 4 * N_UES + 4 * 3 * 2 + 4 * 4,
                       2.0 * N_UES)
    rows.append(dict(
        name="tree_infer", route="cuda", source="src/repro_torch/csrc/tree_infer.cu",
        replaces="src/repro/kernels/tree_infer/tree_infer.py:43",
        launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"x ({N_UES}, {n_feat}) float32, depth 2",
    ))
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        log(f"kernel {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
            f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}), "
            f"max|err| {r['max_abs_err']:.3g}, {r['shape']}")
    return rows


def _main_spec():
    from repro_torch.core.session import CampaignSpec, ExpertBankSpec, PolicySpec

    return CampaignSpec(
        path="closed_loop", scenario="good_poor_good",
        scenario_args=(("poor_start", 13), ("poor_end", 27)), n_prb=N_PRB,
        n_ues=N_UES, n_slots=N_SLOTS, seed=7,
        bank=ExpertBankSpec(channels=32, n_res_blocks=4),
        policies=(PolicySpec(kind="tree"),),
    )


def phase_main_path() -> tuple[dict[str, int], object]:
    """The closed-loop campaign through ``ArchesSession.run`` on the card.

    The counts are zeroed just before ``run()`` (policy profiling, tree fit
    and the closed loop) and read just after it; every kernel must have
    launched.  A second ``run()`` on the same session (tree already fitted)
    times the closed loop alone.
    """
    from repro_torch.core.session import ArchesSession
    from repro_torch.kernels import build

    spec = _main_spec()
    sess = ArchesSession(spec, device="cuda")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    hist = sess.run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}: {launches}")
    if hist.modes.shape != (N_SLOTS, N_UES):
        raise AssertionError(f"modes shape {hist.modes.shape}")
    for name, v in list(hist.kpms.items()) + list(hist.outputs.items()):
        if not np.isfinite(np.asarray(v, np.float64)).all():
            raise AssertionError(f"trajectory leaf {name} is not finite")
    replay = sess.host_replay(hist)
    if not np.array_equal(hist.modes, replay["active_mode"]):
        bad = np.argwhere(hist.modes != replay["active_mode"])[0]
        raise AssertionError(f"device loop != host replay at (slot, UE) {tuple(bad)}")
    if not np.array_equal(hist.decisions, replay["raw_decision"]):
        raise AssertionError("device decisions != host replay decisions")

    t0 = time.perf_counter()
    sess.run()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    rate = N_SLOTS * N_UES / loop_s
    log(f"main path: closed loop {N_SLOTS} slots x {N_UES} UEs, n_prb {N_PRB}, "
        f"AI channels 32 x 4 blocks; first run (policy profiling + fit + loop) {first_s:.2f} s; "
        f"closed loop {loop_s:.3f} s = {rate:.1f} slot-UEs/s "
        f"({loop_s / N_SLOTS * 1e3:.2f} ms/slot); AI share {hist.ai_share:.4f}; "
        f"switches {int(hist.n_switches.sum())}; launches {launches}; "
        f"device loop == host replay on {hist.modes.size} slot-UEs")
    return launches, sess


def phase_reference() -> None:
    """A small campaign on the card against the plain versions on the CPU.

    The CPU session fits the tree; the card's session gets that tree, so
    both run one policy.  Kernels, cuBLAS and the CPU's GEMMs round
    differently, so discrete leaves are compared as agreement rates and
    continuous KPMs within ``REF_KPM_RTOL`` while the UE's discrete path
    (mode, MCS, TB outcome) still agrees.
    """
    from repro_torch.core.session import ArchesSession, CampaignSpec, PolicySpec

    spec = CampaignSpec(
        path="closed_loop", scenario="good_poor_good",
        scenario_args=(("poor_start", 4), ("poor_end", 8)), n_prb=24, n_ues=2,
        n_slots=12, seed=7, policies=(PolicySpec(kind="tree"),),
    )
    cpu_sess = ArchesSession(spec, device="cpu")
    want = cpu_sess.run()
    got = ArchesSession(spec, device="cuda", host_policies=cpu_sess.host_policies).run()
    agree = {k: float(np.mean(a == b)) for k, (a, b) in {
        "active_mode": (got.modes, want.modes),
        "mcs": (got.outputs["mcs"], want.outputs["mcs"]),
        "tb_ok": (got.outputs["tb_ok"], want.outputs["tb_ok"]),
    }.items()}
    same = np.cumprod((got.modes == want.modes)
                      & (got.outputs["mcs"] == want.outputs["mcs"])
                      & (got.outputs["tb_ok"] == want.outputs["tb_ok"]), axis=0) > 0
    worst = 0.0
    for name, w in want.kpms.items():
        g = got.kpms[name]
        rel = np.abs(g - w) / (np.abs(w) + 1e-3)
        worst = max(worst, float(rel[same].max(initial=0.0)))
    log(f"reference: card vs CPU plain versions, n_prb 24, 2 UEs x 12 slots: "
        f"agreement {agree}, max relative KPM difference {worst:.3g} over "
        f"{int(same.sum())} slot-UEs on an agreeing path")
    if agree["active_mode"] < 0.95 or worst > REF_KPM_RTOL:
        raise AssertionError(f"card and CPU disagree: {agree}, KPM {worst}")


def phase_profile(sess) -> None:
    """One closed-loop run under ``torch.profiler``: device busy share, the
    launches per slot, and kernel time by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    launches = sum(e.count for e in events)
    log(f"profile: closed loop wall {wall:.3f} s (under the profiler), device kernel "
        f"time {busy:.3f} s, device busy share {busy / wall:.4f}, "
        f"{launches / N_SLOTS:.0f} kernel launches per slot")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:15]:
        log(f"  {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d} calls  "
            f"{e.key[:90]}")


def main() -> int:
    import repro_torch  # noqa: F401  (fails here when run outside the repository)

    t0 = time.perf_counter()
    smi = phase_device()
    torch.use_deterministic_algorithms(True)
    phase_build()
    rows = phase_kernels()
    launches, sess = phase_main_path()
    for r in rows:
        r["launches"] = launches[r["name"]]
        r.pop("shape")
    log(f"kernels held against their plain versions: {[r['name'] for r in rows]}")
    phase_reference()
    phase_profile(sess)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
