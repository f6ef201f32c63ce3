"""Spans and counters of the port's own code paths, kept in memory.

    with tracing.span("slot.tx"):
        ...
    taken = tracing.take()   # spans and counters since the last take

A span records where the program spends its time: its name, its id and
its parent's, the slot index where there is one (a child inherits its
parent's), host start and end on ``time.time_ns()`` (the clock of a
``torch.profiler`` trace's CPU events) and, on a CUDA path, a pair of
timing events recorded at entry and exit on the stream that was current
when its outermost span on that device opened (looked up once there, and
handed down), so its place on the device timeline follows stream order.
A span nested in a span of the same name records nothing: ``rng`` is the
outermost random draw.

Recording is on while a ``torch.profiler`` session is active in the
process, or inside ``recording()``; ``recording(False)`` forces it off,
profiler or not.  With recording off a span is one check and a shared
no-op: it allocates nothing, records no event and calls no
``record_function``.  Spans go to a buffer of at most ``MAX_SPANS``;
past it they are dropped and counted under ``tracing.dropped``.

Counters are plain ints that only grow: ``counters`` (``rng.words``, the
32-bit words that ``random``'s draws hash, on the kernel's path or the
plain one) and ``launch_counts``, each hand-written kernel's launches
(reported as ``kernel.launches.<name>``; ``kernels.build.launch_counts`` is
this same dict, and ``build.reset_launch_counts`` zeroes it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

import torch

#: spans kept between two ``take()`` calls
MAX_SPANS = 200_000

#: counters: plain ints that only grow
counters: dict[str, int] = {"rng.words": 0, "tracing.dropped": 0}

#: launches per kernel since the last ``build.reset_launch_counts``; each
#: wrapper adds one where it launches its kernel, and nowhere else
launch_counts: dict[str, int] = {
    "mmse_interp": 0, "mmse_interp_gauss": 0, "switch_select_batched": 0, "tree_infer": 0,
    "switch_gather_batched": 0, "gated_expert": 0, "switch_select": 0, "threefry": 0,
}

_profiler_enabled = torch._C._autograd._profiler_enabled
#: the one check a span makes: the profiler's state, or ``recording()``'s
_recording = _profiler_enabled


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    id: int
    parent: int | None
    slot: int | None
    host_start_ns: int
    host_end_ns: int
    #: the device interval in ms from the buffer's first event (None off CUDA)
    device_start_ms: float | None
    device_end_ms: float | None
    #: a root span's counter growth over its extent (None below the root)
    counters: dict | None


@dataclasses.dataclass(frozen=True)
class Taken:
    spans: list[Span]  # in entry order
    #: every counter as it stands, launches as ``kernel.launches.<name>``
    counters: dict[str, int]


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_ids = itertools.count()
_local = threading.local()
_lock = threading.Lock()
_buffer: list[list] = []  # [name, id, parent, slot, t0, t1, ev0, ev1, counters, device]
_events: dict[int, list] = {}  # free timing events by device index


def _event(device: int):
    free = _events.get(device)
    if free:
        return free.pop()
    with torch.cuda.device(device):
        return torch.cuda.Event(enable_timing=True)


def _counter_values() -> dict[str, int]:
    out = dict(counters)
    out.update((f"kernel.launches.{k}", v) for k, v in launch_counts.items())
    return out


class _Span:
    __slots__ = ("name", "on", "slot", "rec", "device", "stream", "start_counts")

    def __init__(self, name, on, slot):
        self.name, self.on, self.slot = name, on, slot

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        on = self.on
        if on is None:
            device = parent.device if parent is not None else None
        else:
            if isinstance(on, torch.Tensor):
                on = on.device
            on = torch.device(on)
            device = (on.index if on.index is not None else torch.cuda.current_device()) \
                if on.type == "cuda" else None
        self.device = device
        self.stream = None
        slot = self.slot if self.slot is not None else (
            parent.rec[3] if parent is not None else None)
        self.start_counts = _counter_values() if parent is None else None
        ev0 = None
        if device is not None:
            self.stream = parent.stream if parent is not None and parent.device == device \
                else torch.cuda.current_stream(device)
            ev0 = _event(device)
            ev0.record(self.stream)
        self.rec = [self.name, next(_ids), parent.rec[1] if parent is not None else None,
                    slot, time.time_ns(), None, ev0, None, None, device]
        stack.append(self)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.device is not None:
            rec[7] = _event(self.device)
            rec[7].record(self.stream)
        rec[5] = time.time_ns()
        if self.start_counts is not None:
            now = _counter_values()
            rec[8] = {k: v - self.start_counts.get(k, 0) for k, v in now.items()
                      if v != self.start_counts.get(k, 0)}
        _local.stack.pop()
        with _lock:
            if len(_buffer) < MAX_SPANS:
                _buffer.append(rec)
            else:
                counters["tracing.dropped"] += 1
                _release(rec)
        return False


def _release(rec: list) -> None:
    """Return a record's events to the pool."""
    for ev in (rec[6], rec[7]):
        if ev is not None:
            _events.setdefault(rec[9], []).append(ev)


def span(name: str, on=None, *, slot: int | None = None):
    """A context manager recording ``name`` while recording is on.

    ``on`` (a tensor or a device) says where the span's work runs: on a
    CUDA device the span records its device interval; ``None`` takes the
    parent's.  ``slot`` marks a slot loop's iteration."""
    if not _recording():
        return _OFF
    stack = getattr(_local, "stack", None)
    if stack and stack[-1].name == name:
        return _OFF
    return _Span(name, on, slot)


@contextlib.contextmanager
def recording(on: bool = True):
    """Turn recording on (or, with ``on=False``, off even under a profiler)
    for the extent of the block."""
    global _recording
    before = _recording
    _recording = (lambda: True) if on else (lambda: False)
    try:
        yield
    finally:
        _recording = before


def take() -> Taken:
    """The spans finished since the last ``take()`` (the buffer empties) and
    every counter.  Synchronises each device the spans ran on once, then
    reads every event's time from that device's first event."""
    with _lock:
        recs = sorted(_buffer, key=lambda r: r[1])
        _buffer.clear()
    first: dict = {}
    for r in recs:
        if r[6] is not None and r[9] not in first:
            torch.cuda.synchronize(r[9])
            first[r[9]] = r[6]
    spans = []
    for name, sid, parent, slot, t0, t1, ev0, ev1, cnt, dev in recs:
        d0 = d1 = None
        if ev0 is not None:
            d0, d1 = first[dev].elapsed_time(ev0), first[dev].elapsed_time(ev1)
        spans.append(Span(name, sid, parent, slot, t0, t1, d0, d1, cnt))
    for r in recs:
        _release(r)
    return Taken(spans=spans, counters=_counter_values())
