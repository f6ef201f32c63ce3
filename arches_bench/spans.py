"""The program's own spans (``repro_torch.tracing``) on the traced
campaign's device timeline, for the per-layer readers in ``metrics/``.

``timeline(run)`` takes the spans of the traced campaign once a run (the
last root span and everything under it) and gives each device operation
the innermost span that was open on the host when the runtime call that
launched it started (``Trace.launch_ns``, matched by the profiler's
correlation id; the spans' host times are on the same clock).  A span's
device interval runs from the start of its first operation, its own or a
descendant's, to the end of its last.  Where fewer than ``COVERAGE`` of the
operations, or of their device time, fall inside a span below the root,
where a kernel of the program's ``HOME`` lands outside its span, or where
the program records no spans (a program without ``repro_torch.tracing``),
it returns ``None``, and so does every reader: no number is better than a
wrong one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Mapping

import numpy as np

#: the least share of the traced campaign's operations, and of their
#: device time, that has to fall inside a span below the root
COVERAGE = 0.999


@dataclasses.dataclass
class Timeline:
    names: list[str]  # per span
    parent: np.ndarray  # per span: index of its parent, -1 at the root
    start_us: np.ndarray  # per span: device interval on the trace's clock (nan: no operation)
    end_us: np.ndarray
    host_ms: np.ndarray  # per span: host duration
    op_span: np.ndarray  # per operation: index of its innermost span, -1 outside
    op_start_us: np.ndarray
    op_dur_us: np.ndarray
    busy: np.ndarray  # (k, 2) the union of the operations' intervals
    wall_us: float
    #: share of operations, of device time, in a span below the root
    coverage: tuple[float, float]
    misplaced: int  # kernels of ``HOME`` outside their span
    unlinked: int  # operations whose launch the trace does not hold
    counters: dict  # the root's counter growth

    def named(self, name: str) -> np.ndarray:
        """Indices of the spans called ``name``, in entry order."""
        return np.asarray([i for i, n in enumerate(self.names) if n == name], np.int64)

    def busy_in(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Busy microseconds of the device inside each ``[lo, hi]``."""
        b = self.busy
        cum = np.concatenate([[0.0], np.cumsum(b[:, 1] - b[:, 0])])

        def upto(t):
            k = np.searchsorted(b[:, 0], t, side="right")  # blocks starting at or before t
            last = np.clip(k - 1, 0, None)
            part = np.where(k > 0, np.clip(t - b[last, 0], 0.0, b[last, 1] - b[last, 0]), 0.0)
            return cum[last] * (k > 0) + part

        return upto(np.asarray(hi, np.float64)) - upto(np.asarray(lo, np.float64))

    def device_us(self, mask: np.ndarray) -> float:
        return float(self.op_dur_us[mask].sum())


def union(intervals: np.ndarray) -> np.ndarray:
    """The union of ``(n, 2)`` intervals sorted by start, as disjoint blocks."""
    if len(intervals) == 0:
        return np.zeros((0, 2))
    ends = np.maximum.accumulate(intervals[:, 1])
    new = np.ones(len(intervals), bool)
    new[1:] = intervals[1:, 0] > ends[:-1]
    starts = intervals[new, 0]
    last = np.flatnonzero(np.r_[new[1:], True])
    return np.stack([starts, ends[last]], axis=1)


def _spans_of_last_root(spans: list) -> list:
    roots = [s for s in spans if s.parent is None]
    if not roots:
        return []
    keep, out = {roots[-1].id}, []
    for s in spans:  # entry order: a parent precedes its children
        if s.id == roots[-1].id or s.parent in keep:
            keep.add(s.id)
            out.append(s)
    return out


def _innermost(h0: np.ndarray, h1: np.ndarray, depth: np.ndarray,
               launch: np.ndarray) -> np.ndarray:
    """Per launch time, the deepest span whose host interval ``[h0, h1]``
    holds it (spans nest, as one thread opens them), -1 where none does."""
    order = np.argsort(launch, kind="stable")
    t = launch[order]
    out = np.full(len(t), -1, np.int64)
    for i in np.argsort(depth, kind="stable"):  # parents first, children overwrite
        out[np.searchsorted(t, h0[i], side="left"):np.searchsorted(t, h1[i], side="right")] = i
    op_span = np.empty_like(out)
    op_span[order] = out
    return op_span


def build(spans: list, trace, home: Mapping[str, str]) -> Timeline | None:
    """The timeline of ``spans`` (``repro_torch.tracing.Span``s) on ``trace``
    (``trace.Trace``); ``home`` maps a part of a kernel's name to the span
    it has to run in."""
    spans = _spans_of_last_root(spans)
    if not spans or not trace.ops:
        return None
    index = {s.id: i for i, s in enumerate(spans)}
    parent = np.asarray([index.get(s.parent, -1) for s in spans], np.int64)
    depth = np.zeros(len(spans), np.int64)
    for i in range(len(spans)):  # entry order: a parent precedes its children
        depth[i] = 0 if parent[i] < 0 else depth[parent[i]] + 1
    h0 = np.asarray([s.host_start_ns for s in spans], np.int64)
    h1 = np.asarray([s.host_end_ns for s in spans], np.int64)
    launch = np.asarray([-1 if t is None else t for t in trace.launch_ns], np.int64)
    arr = np.asarray([(lo, hi) for _, lo, hi in trace.ops], np.float64)
    linked = launch >= 0
    op_span = np.full(len(arr), -1, np.int64)
    op_span[linked] = _innermost(h0, h1, depth, launch[linked])

    # each span's device interval: its own operations, then its children's
    start = np.full(len(spans), np.inf)
    end = np.full(len(spans), -np.inf)
    held = op_span >= 0
    np.minimum.at(start, op_span[held], arr[held, 0])
    np.maximum.at(end, op_span[held], arr[held, 1])
    for i in np.argsort(-depth, kind="stable"):
        if parent[i] >= 0:
            start[parent[i]] = min(start[parent[i]], start[i])
            end[parent[i]] = max(end[parent[i]], end[i])
    empty = ~np.isfinite(start)
    start[empty], end[empty] = np.nan, np.nan

    dur = arr[:, 1] - arr[:, 0]
    inside = op_span > 0  # the root's own operations count as outside
    cov = (float(inside.mean()), float(dur[inside].sum() / max(dur.sum(), 1e-12)))
    span_names = np.asarray([s.name for s in spans] + ["(outside)"], dtype=object)
    op_names = [n for n, _, _ in trace.ops]
    misplaced = sum(int((span_names[op_span[[k for k, n in enumerate(op_names) if key in n]]]
                         != want).sum()) for key, want in home.items())
    return Timeline(
        names=[s.name for s in spans], parent=parent, start_us=start, end_us=end,
        host_ms=(h1 - h0) / 1e6, op_span=op_span, op_start_us=arr[:, 0], op_dur_us=dur,
        busy=union(arr), wall_us=trace.wall_s * 1e6, coverage=cov, misplaced=misplaced,
        unlinked=int((~linked).sum()), counters=dict(spans[0].counters or {}))


def timeline(run) -> Timeline | None:
    """The run's timeline, built once (the spans are taken from the program
    once), or ``None`` below ``COVERAGE`` or without the program's spans."""
    cache = run.__dict__
    if "_program_timeline" not in cache:
        cache["_program_timeline"] = _timeline(run)
    return cache["_program_timeline"]


def _timeline(run) -> Timeline | None:
    if run.trace is None or not run.trace.ops:
        return None
    try:
        from repro_torch import tracing
    except ImportError:  # a program without spans
        return None
    tl = build(tracing.take().spans, run.trace, run.program.HOME)
    if tl is None:
        return None
    report(tl, run)
    if min(tl.coverage) < COVERAGE or tl.misplaced:
        return None
    return tl


def in_spans(tl: Timeline, idx) -> np.ndarray:
    """Mask of the operations whose innermost span is one of ``idx``."""
    return np.isin(tl.op_span, np.asarray(idx, np.int64))


def under(tl: Timeline, names, skip=()) -> np.ndarray:
    """Mask of the operations inside a span called one of ``names`` (their
    innermost span or an ancestor of it) whose innermost span is not called
    one of ``skip``."""
    found = np.zeros(len(tl.names) + 1, bool)  # the last entry: outside every span
    for i, n in enumerate(tl.names):  # entry order: a parent precedes its children
        found[i] = n in names or (tl.parent[i] >= 0 and found[tl.parent[i]])
    keep = np.asarray([n not in skip for n in tl.names] + [False])
    return (found & keep)[tl.op_span]


def device_ms(tl: Timeline, name: str) -> np.ndarray:
    """The device interval, in ms, of each span called ``name`` that ran an
    operation."""
    s = tl.named(name)
    d = (tl.end_us[s] - tl.start_us[s]) / 1e3
    return d[np.isfinite(d)]


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile by nearest rank: ``ceil(q n)``-th smallest."""
    v = sorted(values)
    return float(v[max(math.ceil(q * len(v)) - 1, 0)])


def idle_us(tl: Timeline, name: str) -> tuple[float, float]:
    """Idle device microseconds inside the device intervals of the spans
    called ``name``, and outside them over the traced wall (the wall beyond
    the root's interval counted as outside)."""
    s = tl.named(name)
    s = s[np.isfinite(tl.start_us[s])]
    lo, hi = tl.start_us[s], tl.end_us[s]
    inside = float(((hi - lo) - tl.busy_in(lo, hi)).sum())
    c0, c1 = tl.start_us[0], tl.end_us[0]  # the root
    order = np.argsort(lo)
    olo = np.concatenate([[c0], hi[order]])
    ohi = np.concatenate([lo[order], [c1]])
    ohi = np.maximum(ohi, olo)
    between = float(((ohi - olo) - tl.busy_in(olo, ohi)).sum())
    busy_total = float((tl.busy[:, 1] - tl.busy[:, 0]).sum())
    beyond = (tl.wall_us - (c1 - c0)) - (busy_total - float(tl.busy_in(np.array([c0]),
                                                                        np.array([c1]))[0]))
    return inside, between + beyond


def device_by_span(tl: Timeline, keep: np.ndarray | None = None) -> dict[str, float]:
    """Device ms of the operations (those of the mask ``keep``, where given)
    by their innermost span's name."""
    if keep is None:
        keep = np.ones(len(tl.op_span), bool)
    out: dict[str, float] = {}
    names = np.asarray(tl.names + ["(outside)"], dtype=object)
    for name in set(names[tl.op_span]):
        m = keep & (names[tl.op_span] == name)
        out[name] = tl.device_us(m) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_by_span(tl: Timeline) -> dict[str, float]:
    """Idle device ms by the innermost span of the operation that ends each
    gap: what the host was doing while the device waited."""
    b = tl.busy
    if len(b) < 2:
        return {}
    gap_ms = (b[1:, 0] - b[:-1, 1]) / 1e3
    first_op = np.searchsorted(tl.op_start_us, b[1:, 0], side="left")  # ends each gap
    names = np.asarray(tl.names + ["(outside)"], dtype=object)
    owner = names[tl.op_span[first_op]]
    out: dict[str, float] = {}
    for n, g in zip(owner, gap_ms):
        out[n] = out.get(n, 0.0) + float(g)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def report(tl: Timeline, run) -> None:
    """One line on standard error: the coverage, the check of ``HOME``, the
    breakdowns and each span name's device intervals."""
    claimed = getattr(run.program, "CLAIMED", ())
    unclaimed = np.asarray([not any(c in n for c in claimed) for n, _, _ in run.trace.ops])
    intervals = {}
    for name in sorted(set(tl.names)):
        d = device_ms(tl, name)
        if len(d):
            intervals[name] = {"n": int(len(d)), "median": float(np.median(d)),
                               "p75": nearest_rank(d, 0.75)}
    line = {
        "coverage_ops": tl.coverage[0], "coverage_time": tl.coverage[1],
        "misplaced": tl.misplaced, "unlinked": tl.unlinked,
        "device_ms_by_span": device_by_span(tl),
        "device_ms_by_span_unclaimed": device_by_span(tl, unclaimed),
        "idle_ms_by_span": idle_by_span(tl),
        "interval_ms_by_span": intervals,
        "counters": tl.counters,
    }
    print("program spans: " + json.dumps(line), file=sys.stderr, flush=True)
