"""The device trace of one campaign and its reductions.

``profile_campaign`` runs one campaign under ``torch.profiler`` (CUDA
activity only) and keeps every device operation, kernels, copies and
fills alike, as ``(name, start_us, end_us)`` from the trace's start, and
beside each the host start of the runtime call that launched it (matched
by the profiler's correlation id, on ``time.time_ns()``'s clock, the
program's spans' clock).  The per-layer readers in ``arches_bench/metrics``
read it through ``Trace``.
"""

from __future__ import annotations

import dataclasses
import re
import time
from collections import defaultdict
from typing import Callable, Iterable


@dataclasses.dataclass
class Trace:
    ops: list[tuple[str, float, float]]  # (name, start us, end us), in start order
    wall_s: float  # the profiled campaign on the host clock, under the profiler
    #: per operation: the host start (ns) of the call that launched it, or
    #: ``None`` where the trace holds no such call
    launch_ns: list[int | None]

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran (the union)."""
        total, cur_lo, cur_hi = 0.0, None, None
        for _, lo, hi in self.ops:
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    total += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            total += cur_hi - cur_lo
        return total / 1e6

    def device_s(self, patterns: Iterable[str] = (), *, exclude: Iterable[str] = ()) -> float:
        """Summed device seconds of the operations whose name matches one of
        ``patterns`` (all, where none is given) and none of ``exclude``."""
        inc = re.compile("|".join(patterns)) if patterns else None
        exc = re.compile("|".join(exclude)) if exclude else None
        return sum(hi - lo for name, lo, hi in self.ops
                   if (inc is None or inc.search(name))
                   and (exc is None or not exc.search(name))) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        by_name: dict[str, float] = defaultdict(float)
        for name, lo, hi in self.ops:
            by_name[name] += (hi - lo) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device time summed by the operation that ended it: the gap
        before each operation is the host's time to issue that operation."""
        by_next: dict[str, float] = defaultdict(float)
        hi_so_far = None
        for name, lo, hi in self.ops:
            if hi_so_far is not None and lo > hi_so_far:
                by_next[f"before {name[:120]}"] += (lo - hi_so_far) / 1e6
            hi_so_far = hi if hi_so_far is None else max(hi_so_far, hi)
        return [[k, v] for k, v in sorted(by_next.items(), key=lambda kv: -kv[1])[:n]]


def profile_campaign(run_campaign: Callable[[], object], sync: Callable[[], None]):
    """``(result, Trace)`` of ``run_campaign()`` under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run_campaign()
        sync()
        wall = time.perf_counter() - t0
    results = prof.profiler.kineto_results
    events = [e for e in results.events() if not e.is_hidden_event()]
    # a call's correlation id is the launch's, and an overhead record the
    # profiler files under it (a full command buffer) starts inside the call
    launch: dict[int, int] = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.correlation_id():
            t = launch.get(e.correlation_id())
            launch[e.correlation_id()] = e.start_ns() if t is None else min(t, e.start_ns())
    base = results.trace_start_ns()
    device = sorted((e for e in events if e.device_type() == DeviceType.CUDA),
                    key=lambda e: e.start_ns())
    ops = [(e.name(), (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3) for e in device]
    return result, Trace(ops=ops, wall_s=wall,
                         launch_ns=[launch.get(e.correlation_id()) for e in device])
