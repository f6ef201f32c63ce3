"""The program's own spans (``repro_torch.tracing``) on the traced
campaign's device timeline, for the per-layer readers in ``metrics/``.

``timeline(run)`` takes the spans of the traced campaign once a run (the
last ``campaign`` span and everything under it) and puts their CUDA events
on the clock of ``run.trace.ops`` (``place``): the kernels that run in one
span alone (``HOME``: the experts', the switch's, the decision's) anchor
the offset a few times a slot, and each stage of a slot then moves a
little, to where its events land in the device's idle gaps (a span's start
event precedes every operation it launched, in stream order, and its end
event follows them).  Each operation belongs to the innermost span whose
device interval holds its midpoint.  Where fewer than ``COVERAGE`` of the
operations, or of their device time, fall inside a span below the
campaign, where a kernel of ``HOME`` lands outside its span, where fewer
than ``FIT_SHARE`` of the events land in a gap, or where the program
records no spans (a program without ``repro_torch.tracing``), it returns
``None``, and so does every reader: no number is better than a wrong one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np

#: the least share of the traced campaign's operations, and of their
#: device time, that has to fall inside a span
COVERAGE = 0.999
#: how far (us) an event may sit inside an operation and still count as in
#: a gap: the events' timer resolution
TOL_US = 1.0
#: how far (us) a stage's events may move from where the anchors put them
#: (a stage's children then move a third of it again)
WINDOW_US = 30.0
#: the least share of events that have to land in an idle gap
FIT_SHARE = 0.98
#: the kernels that run in one span alone, by a part of their name: each
#: has to land in its span, or the placement is wrong
HOME = {"mmse_interp": "bank.mmse", "gated_expert": "bank.ai",
        "copy_rows_kernel": "bank.switch", "policy_step": "slot.decision"}


def _rest_reader():
    path = Path(__file__).resolve().parent / "metrics" / "device_ms_per_slot.rest.py"
    spec = importlib.util.spec_from_file_location("arches_bench_spans_rest", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: the kernels the rooflines and ``device_us_per_slot.switch_policy`` claim,
#: as ``device_ms_per_slot.rest`` leaves them out
CLAIMED = _rest_reader().CLAIMED
#: the slot's stages that each reader sums (the innermost ``rng`` span aside)
STAGES = {"channel": ("slot.tx", "slot.channel"), "receiver": ("slot.ls", "slot.receiver")}


@dataclasses.dataclass
class Timeline:
    names: list[str]  # per span
    parent: np.ndarray  # per span: index of its parent, -1 at the root
    start_us: np.ndarray  # per span: device interval on the trace's clock
    end_us: np.ndarray
    event_ms: np.ndarray  # per span: (start, end) on the events' own clock
    host_ms: np.ndarray  # per span: host duration
    op_span: np.ndarray  # per operation: index of its innermost span, -1 outside
    op_start_us: np.ndarray
    op_dur_us: np.ndarray
    busy: np.ndarray  # (k, 2) the union of the operations' intervals
    wall_us: float
    offset_us: float
    fit_share: float  # events that land in an idle gap
    anchors: int  # kernels of ``HOME`` that placed the spans
    #: share of operations, of device time, in a span below the campaign
    coverage: tuple[float, float]
    misplaced: int  # kernels of ``HOME`` outside their span
    counters: dict  # the campaign's counter growth

    def ancestors(self, i: int):
        while i >= 0:
            yield i
            i = int(self.parent[i])

    def stage_of(self) -> np.ndarray:
        """Per span: the name of its nearest ancestor (itself included)
        that is a slot stage, or of its own when none is."""
        out = []
        stage_names = {n for v in STAGES.values() for n in v}
        for i in range(len(self.names)):
            found = next((self.names[j] for j in self.ancestors(i)
                          if self.names[j] in stage_names), self.names[i])
            out.append(found)
        return np.asarray(out, dtype=object)

    def slot_idx(self) -> np.ndarray:
        return np.asarray([i for i, n in enumerate(self.names) if n == "slot"], np.int64)

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


def _intervals(points: np.ndarray, lo: float, hi: float, gaps: np.ndarray):
    """For each point, the offsets in ``[lo, hi]`` that put it in one of the
    disjoint ``gaps``: ``(starts, ends)``, at most one interval a gap."""
    glo, ghi = gaps[:, 0], gaps[:, 1]
    a = np.searchsorted(ghi, points + lo, side="left")
    b = np.searchsorted(glo, points + hi, side="right")
    n = np.maximum(b - a, 0)
    which = np.repeat(np.arange(len(points)), n)
    idx = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n) + np.repeat(a, n)
    s = np.maximum(glo[idx] - points[which], lo)
    e = np.minimum(ghi[idx] - points[which], hi)
    keep = s <= e
    return s[keep], e[keep]


def _depths(points: np.ndarray, lo: float, hi: float, gaps: np.ndarray):
    """The offsets in ``[lo, hi]`` by how many of ``points`` each puts in a
    gap: ``(positions, depth from each position to the next)``."""
    s, e = _intervals(points, lo, hi, gaps)
    pos = np.concatenate([s, e])
    step = np.concatenate([np.ones(len(s)), -np.ones(len(e))])
    order = np.lexsort((-step, pos))  # at one position, starts before ends
    return pos[order], np.cumsum(step[order])


def _deepest(points: np.ndarray, lo: float, hi: float, gaps: np.ndarray,
             prefer: float | None = None) -> tuple[float, float, int]:
    """The range of offsets in ``[lo, hi]`` that puts the most of
    ``points`` inside one of the disjoint ``gaps``, and how many it puts
    there; of several such ranges, the one nearest ``prefer``."""
    pos, depth = _depths(points, lo, hi, gaps)
    if len(pos) == 0:
        return lo, hi, 0
    tops = np.flatnonzero(depth == depth.max())
    ranges = np.stack([pos[tops], pos[np.minimum(tops + 1, len(pos) - 1)]], 1)
    k = 0
    if prefer is not None and len(tops) > 1:
        k = int(np.argmin(np.maximum(ranges[:, 0] - prefer, prefer - ranges[:, 1])))
    return float(ranges[k, 0]), float(ranges[k, 1]), int(depth.max())


def _anchors(names: list[str], d0: np.ndarray, d1: np.ndarray, op_names: list[str],
             arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The offsets of the trace's clock from the events' that the kernels of
    ``HOME`` pin: each kernel's launches, in trace order, matched with the
    spans of its name, in stream order, where they are as many.  A pair
    gives, at its span's middle, the offset that centres the kernel in the
    span (a pair whose kernel cannot fit inside the span is left out).
    ``(event times, offsets)`` in time order."""
    t, off = [np.zeros(0)], [np.zeros(0)]
    for key, home in HOME.items():
        ks = np.asarray([k for k, n in enumerate(op_names) if key in n], np.int64)
        ss = np.asarray(sorted((i for i, n in enumerate(names) if n == home),
                               key=lambda i: d0[i]), np.int64)
        if len(ks) == 0 or len(ks) != len(ss):
            continue
        lo, hi = arr[ks, 1] - d1[ss], arr[ks, 0] - d0[ss]
        ok = lo <= hi + TOL_US
        t.append((d0[ss] + d1[ss])[ok] / 2)
        off.append((lo + hi)[ok] / 2)
    t, off = np.concatenate(t), np.concatenate(off)
    order = np.argsort(t, kind="stable")
    return t[order], off[order]


def _refine(x: np.ndarray, window: float, fine: np.ndarray) -> tuple[float, float]:
    """The shift (at ``x[0]``) within ``window`` and the stretch within
    ``window`` at ``x[-1]`` that put the most of the events ``x`` (sorted)
    in the ``fine`` gaps: of ties, the least stretch and the least shift."""
    span = max(float(x[-1] - x[0]), 1.0)
    reach = 2 * window / span
    rates = np.arange(-reach, reach + TOL_US / span / 2, TOL_US / span)
    best = (0.0, 0.0, -1)
    for r in rates[np.argsort(np.abs(rates), kind="stable")]:
        lo, hi, n = _deepest(x + r * (x - x[0]), -window, window, fine, prefer=0.0)
        if n > best[2]:
            best = (min(max(0.0, lo), hi), float(r), n)
            if n == len(x):
                break
    return best[0], best[1]


def place(names: list[str], parent: np.ndarray, d0: np.ndarray, d1: np.ndarray,
          host: np.ndarray, op_names: list[str], arr: np.ndarray, busy: np.ndarray):
    """Each span's start and end on the trace's clock (``None`` without an
    anchor), the share of events that land in an idle gap, and how many
    anchors placed them.  ``host`` holds each event's host time, the
    starts' and then the ends'.

    The profiler's clock drifts from the events' by up to a few parts in a
    hundred and jumps by up to milliseconds, unevenly within a slot, so the
    offset follows the anchors (``_anchors``, a few a slot), linearly
    between them and at their mean rate beyond them.  Each stage of a slot
    (a child of a slot, with everything under it) and each other child of
    the campaign then moves, within ``WINDOW_US`` at either end, to where
    the most of its events land in idle gaps, and each of its children
    within a third of that.  Last, an event recorded later (on the host's
    clock, where the events' own clock ties) lands no earlier on the
    trace."""
    n = len(names)
    t_a, off_a = _anchors(names, d0, d1, op_names, arr)
    if len(t_a) == 0:
        return None, 0.0, 0
    first, last = float(arr[:, 0].min()), float(arr[:, 1].max())
    gaps = np.concatenate([[[-np.inf, first]], np.stack([busy[:-1, 1], busy[1:, 0]], 1),
                           [[last, np.inf]]])
    fine = union(gaps + [-TOL_US, TOL_US])
    pos = np.concatenate([d0, d1])
    # linear between anchors, and beyond them at the anchors' mean rate
    rate = (off_a[-1] - off_a[0]) / max(t_a[-1] - t_a[0], 1.0)
    pos = pos + np.interp(pos, t_a, off_a) + rate * (np.minimum(pos - t_a[0], 0.0)
                                                   + np.maximum(pos - t_a[-1], 0.0))
    # each stage (a child of a slot, or another child of the campaign), then
    # each of its children, with everything under it
    stage, sub = np.arange(n), np.arange(n)
    for i in range(n):
        p = parent[i]
        if p > 0 and names[p] != "slot":
            stage[i] = stage[p]
            sub[i] = sub[p] if stage[p] != p else i
    for blocks, window in ((stage, WINDOW_US), (sub, WINDOW_US / 3)):
        for h in np.unique(blocks):
            if names[h] in ("campaign", "slot"):
                continue
            m = np.tile(blocks == h, 2)
            x = np.sort(pos[m])
            shift, stretch = _refine(x, window, fine)
            pos[m] += shift + stretch * (pos[m] - x[0])
    mapped = pos
    order = np.lexsort((host, np.concatenate([d0, d1])))
    mapped[order] = np.maximum.accumulate(mapped[order])
    k = np.clip(np.searchsorted(fine[:, 0], mapped, side="right") - 1, 0, None)
    share = float(np.mean(mapped <= fine[k, 1]))
    return (mapped[:n], mapped[n:]), share, len(t_a)


def _spans_of_last_campaign(spans: list) -> list:
    roots = [s for s in spans if s.name == "campaign" and s.parent is None]
    if not roots:
        return []
    root = roots[-1]
    keep, out = {root.id}, []
    for s in spans:  # entry order: a parent precedes its children
        if s.id == root.id or s.parent in keep:
            keep.add(s.id)
            out.append(s)
    return out


def build(spans: list, ops: list, wall_s: float) -> Timeline | None:
    """The timeline of ``spans`` (``repro_torch.tracing.Span``s) on the
    trace ``ops`` (``(name, start us, end us)`` in start order)."""
    spans = [s for s in _spans_of_last_campaign(spans) if s.device_start_ms is not None]
    if not spans or not ops:
        return None
    index = {s.id: i for i, s in enumerate(spans)}
    parent = np.asarray([index.get(s.parent, -1) for s in spans], np.int64)
    d0 = np.asarray([s.device_start_ms for s in spans]) * 1e3
    d1 = np.asarray([s.device_end_ms for s in spans]) * 1e3
    arr = np.asarray([(lo, hi) for _, lo, hi in ops], np.float64)
    busy = union(arr)
    host = np.asarray([s.host_start_ns for s in spans] + [s.host_end_ns for s in spans])
    names = [s.name for s in spans]
    op_names = [n for n, _, _ in ops]
    placed, share, n_anchors = place(names, parent, d0, d1, host, op_names, arr, busy)
    if placed is None:
        return None
    start, end = placed
    offset = float(start[0] - d0[0])

    # each operation's innermost span: parents first, children overwrite
    mid = (arr[:, 0] + arr[:, 1]) / 2
    by_mid = np.argsort(mid, kind="stable")
    depth = np.zeros(len(spans), np.int64)
    for i in range(len(spans)):
        depth[i] = 0 if parent[i] < 0 else depth[parent[i]] + 1
    sorted_span = np.full(len(arr), -1, np.int64)
    for i in np.argsort(depth, kind="stable"):
        a, b = np.searchsorted(mid[by_mid], [start[i], end[i]], side="left")
        sorted_span[a:b] = i
    op_span = np.empty_like(sorted_span)
    op_span[by_mid] = sorted_span
    dur = arr[:, 1] - arr[:, 0]
    inside = op_span > 0  # the campaign's own span holds every operation
    cov = (float(inside.mean()), float(dur[inside].sum() / max(dur.sum(), 1e-12)))
    span_names = np.asarray(names + ["(outside)"], dtype=object)
    misplaced = sum(int((span_names[op_span[[k for k, n in enumerate(op_names) if key in n]]]
                         != home).sum()) for key, home in HOME.items())
    return Timeline(
        names=names, parent=parent, start_us=start, end_us=end,
        event_ms=np.stack([d0, d1], 1) / 1e3,
        host_ms=np.asarray([(s.host_end_ns - s.host_start_ns) / 1e6 for s in spans]),
        op_span=op_span, op_start_us=arr[:, 0], op_dur_us=dur, busy=busy,
        wall_us=wall_s * 1e6, offset_us=offset, fit_share=share, anchors=n_anchors,
        coverage=cov, misplaced=misplaced,
        counters=dict(spans[0].counters or {}))


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
    tl = build(tracing.take().spans, run.trace.ops, run.trace.wall_s)
    if tl is None:
        return None
    report(tl, run)
    if min(tl.coverage) < COVERAGE or tl.misplaced or tl.fit_share < FIT_SHARE:
        return None
    return tl


def in_spans(tl: Timeline, idx) -> np.ndarray:
    """Mask of the operations whose innermost span is one of ``idx``."""
    return np.isin(tl.op_span, np.asarray(idx, np.int64))


def stage_ops(tl: Timeline, stage: str) -> np.ndarray:
    """Mask of the operations of ``STAGES[stage]``: inside one of its spans,
    and not inside an ``rng`` span."""
    of = tl.stage_of()
    idx = [i for i, n in enumerate(tl.names)
           if n != "rng" and of[i] in STAGES[stage]]
    return in_spans(tl, idx)


def slot_device_ms(tl: Timeline) -> np.ndarray:
    """Each slot's device interval, on the events' own clock."""
    s = tl.slot_idx()
    return tl.event_ms[s, 1] - tl.event_ms[s, 0]


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile by nearest rank: ``ceil(q n)``-th smallest."""
    v = sorted(values)
    return float(v[max(math.ceil(q * len(v)) - 1, 0)])


def idle_us(tl: Timeline) -> tuple[float, float]:
    """Idle device microseconds inside the slots' intervals, and outside
    them over the traced wall (the wall beyond the campaign's interval
    counted as outside)."""
    s = tl.slot_idx()
    lo, hi = tl.start_us[s], tl.end_us[s]
    inside = float(((hi - lo) - tl.busy_in(lo, hi)).sum())
    c0, c1 = tl.start_us[0], tl.end_us[0]  # the campaign
    order = np.argsort(lo)
    olo = np.concatenate([[c0], hi[order]])
    ohi = np.concatenate([lo[order], [c1]])
    olo, ohi = olo, np.maximum(ohi, olo)
    between = float(((ohi - olo) - tl.busy_in(olo, ohi)).sum())
    busy_total = float((tl.busy[:, 1] - tl.busy[:, 0]).sum())
    beyond = (tl.wall_us - (c1 - c0)) - (busy_total - float(tl.busy_in(np.array([c0]),
                                                                        np.array([c1]))[0]))
    return inside, between + beyond


def device_by_span(tl: Timeline, ops_names: list[str] | None = None) -> dict[str, float]:
    """Device ms of the operations by their innermost span's name (the
    claimed kernels left out where ``ops_names`` is given)."""
    keep = np.ones(len(tl.op_span), bool)
    if ops_names is not None:
        keep = np.asarray([not any(c in n for c in CLAIMED) for n in ops_names])
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
    """One line on standard error: the fit, the coverage and the breakdowns."""
    names = [n for n, _, _ in run.trace.ops]
    slots = slot_device_ms(tl)
    inside, outside = idle_us(tl)
    line = {
        "offset_us": tl.offset_us, "events_in_gaps": tl.fit_share, "anchors": tl.anchors,
        "coverage_ops": tl.coverage[0], "coverage_time": tl.coverage[1],
        "misplaced": tl.misplaced,
        "device_ms_by_span": device_by_span(tl),
        "device_ms_by_span_unclaimed": device_by_span(tl, names),
        "idle_ms_by_span": idle_by_span(tl),
        "idle_ms": {"slots": inside / 1e3, "outside": outside / 1e3},
        "slot_ms": {"median": float(np.median(slots)) if len(slots) else None,
                    "p75": nearest_rank(slots, 0.75) if len(slots) else None,
                    "n": int(len(slots))},
        "counters": tl.counters,
    }
    print("program spans: " + json.dumps(line), file=sys.stderr, flush=True)
