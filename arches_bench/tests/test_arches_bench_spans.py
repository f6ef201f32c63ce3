"""The span helper (``arches_bench.spans``) and its eight readers on a
synthetic trace with synthetic spans: each operation takes the innermost
span open on the host at its launch (nested spans; operations that run on
the device long after their span has closed on the host), each span's
device interval, the idle split, the slot's percentile, and ``None`` where
operations were launched outside every span, the spans cover too little,
or a kernel leaves its span."""

import dataclasses

import numpy as np
import pytest

from arches_bench import cells, harness, spans
from arches_bench.trace import Trace

READERS = ("device_ms_per_slot.rng", "device_ms_per_slot.channel",
           "device_ms_per_slot.receiver", "rng_ns_per_word",
           "device_idle_ms_per_slot.slot_loop", "device_idle_share.outside_slots",
           "slot_ms.p75", "host_ms_per_campaign.session_build")
WORDS = 1_000_000
N_SLOTS = 40
HOST0 = 1_700_000_000_000_000_000  # ns, the spans' and the launches' clock
LATENCY_US = 7.0  # a launch to the earliest start of its operation
HOME = harness.load_program("arches_campaign").HOME


@dataclasses.dataclass
class Synthetic:
    spans: list  # repro_torch.tracing.Span
    ops: list  # (name, start us, end us) on the trace's clock, in start order
    launch_ns: list  # per op: its launch's host start
    truth: list  # per op: the name of the innermost span open at its launch
    truth_id: list  # per op: that span's id, None outside every span
    wall_s: float

    def trace(self, ops=None, launch_ns=None) -> Trace:
        return Trace(ops=self.ops if ops is None else ops, wall_s=self.wall_s,
                     launch_ns=self.launch_ns if launch_ns is None else launch_ns)


def synthetic(seed: int = 0, *, before: int = 0, campaign_ops: int = 0) -> Synthetic:
    """One campaign of ``N_SLOTS`` slots: the host opens spans and launches
    operations a few us apart, and the device runs them in launch order, no
    earlier than ``LATENCY_US`` after each launch.  The AI expert's 300 us
    queue what follows, so the operations after it run long after their
    spans have closed on the host, until a host stall before each slot's
    receiver lets the device drain.  ``before`` operations are launched
    before the campaign (the first inside an earlier root span),
    ``campaign_ops`` in the campaign outside its children."""
    from repro_torch.tracing import Span

    rng = np.random.default_rng(seed)
    host, free = [HOST0], [0.0]
    ops, recs, stack = [], [], []

    def advance(lo_us, hi_us):
        host[0] += int(rng.uniform(lo_us, hi_us) * 1e3)

    def op(name, dur):
        advance(2.0, 6.0)  # the host's work before the call
        start = max((host[0] - HOST0) / 1e3 + LATENCY_US, free[0])
        owner = stack[-1] if stack else None
        ops.append((name, start, start + dur, host[0], owner))
        free[0] = start + dur
        advance(3.0, 5.0)  # the call itself

    def enter(name, slot=None):
        advance(0.5, 2.0)
        parent = stack[-1] if stack else None
        rec = [name, len(recs), None if parent is None else parent[1],
               slot if slot is not None else (None if parent is None else parent[3]),
               host[0], None]
        recs.append(rec)
        stack.append(rec)

    def leave():
        advance(0.5, 2.0)
        stack.pop()[5] = host[0]

    if before:
        enter("rng")
        op("stray", 2.0)
        leave()
    for _ in range(before - 1):
        op("stray", 2.0)
    enter("campaign")
    enter("session.build")
    op("Memcpy HtoD (Pageable -> Device)", 40.0)
    leave()
    for _ in range(campaign_ops):
        op("fill", 2.0)
    for s in range(N_SLOTS):
        enter("slot", s)
        enter("rng")
        for _ in range(5):
            op("threefry draw", rng.uniform(1.0, 4.0))
        leave()
        enter("slot.tx")
        enter("rng")
        for _ in range(30):
            op("threefry draw", rng.uniform(1.0, 40.0))
        leave()
        op("qam modulate", rng.uniform(1.0, 5.0))
        leave()
        enter("slot.channel")
        op("fading", 20.0)
        enter("rng")
        op("noise", 30.0)
        leave()
        leave()
        enter("slot.ls")
        op("ls divide", 3.0)
        leave()
        enter("slot.bank")
        enter("bank.mmse")
        op("mmse_interp_gauss_kernel", 25.0)
        leave()
        enter("bank.ai")
        op("gated_expert_kernel", 300.0)
        leave()
        enter("bank.switch")
        op("copy_rows_kernel", 3.0)
        leave()
        leave()
        advance(600.0, 900.0)  # the host stalls: the device drains, then idles
        enter("slot.receiver")
        for _ in range(8):
            op("equalize", rng.uniform(1.0, 8.0))
        leave()
        enter("slot.decision")
        op("policy_step_kernel", 4.0)
        leave()
        leave()
    enter("campaign.history")
    op("Memcpy DtoH (Device -> Pageable)", 60.0)
    leave()
    leave()

    out = [Span(name, sid, parent, slot, a, b, None, None,
                {"rng.words": WORDS} if name == "campaign" else None)
           for name, sid, parent, slot, a, b in recs]
    ops.sort(key=lambda o: o[1])
    # the profiled wall runs a little past the device's last operation
    wall_s = (max(free[0], (host[0] - HOST0) / 1e3) + 250.0) / 1e6
    return Synthetic(spans=out, ops=[o[:3] for o in ops], launch_ns=[o[3] for o in ops],
                     truth=[o[4][0] if o[4] else "(outside)" for o in ops],
                     truth_id=[o[4][1] if o[4] else None for o in ops], wall_s=wall_s)


def run_of(syn: Synthetic, monkeypatch, trace=None) -> harness.Run:
    """A traced run of the CONCURRENT cell whose program hands out ``syn``."""
    from repro_torch import tracing

    taken = tracing.Taken(spans=list(syn.spans), counters={"rng.words": WORDS})
    calls = []
    monkeypatch.setattr(tracing, "take", lambda: calls.append(1) or taken)
    run = harness.Run(cell=cells.load_cell("arches-106-concurrent.gpg-256ue"))
    run.trace = syn.trace() if trace is None else trace
    run.calls = calls
    return run


def owners(tl: spans.Timeline) -> list[str]:
    return [tl.names[i] if i >= 0 else "(outside)" for i in tl.op_span]


def test_each_operation_takes_the_span_open_at_its_launch():
    syn = synthetic()
    tl = spans.build(syn.spans, syn.trace(), HOME)
    assert tl.coverage == (1.0, 1.0) and tl.misplaced == 0 and tl.unlinked == 0
    assert owners(tl) == syn.truth
    # nested spans: the innermost one wins (an ``rng`` inside ``slot.channel``)
    assert {"rng", "slot.channel", "slot.tx"} <= set(syn.truth)


def test_an_operation_that_runs_after_its_span_closed():
    """The device runs the expert's queue long after the host left its
    spans: by the device clock those operations would sit in later spans,
    by their launch they sit in their own."""
    syn = synthetic(1)
    tl = spans.build(syn.spans, syn.trace(), HOME)
    span_end = {s.id: s.host_end_ns for s in syn.spans}
    # device start on the host's clock: the trace's clock starts at HOST0 here
    late = [k for k, (_, a, _) in enumerate(syn.ops)
            if syn.truth_id[k] is not None and HOST0 + a * 1e3 > span_end[syn.truth_id[k]]]
    assert len(late) > 5 * N_SLOTS
    assert [owners(tl)[k] for k in late] == [syn.truth[k] for k in late]


def test_each_span_s_device_interval():
    """From its first operation's start to its last's end, its descendants'
    included; a span that launched nothing has none."""
    syn = synthetic(2)
    tl = spans.build(syn.spans, syn.trace(), HOME)
    for i, s in enumerate(syn.spans):
        sub = {s.id}
        for t in syn.spans:  # entry order: a parent precedes its children
            if t.parent in sub:
                sub.add(t.id)
        mine = [(a, b) for (_, a, b), who in zip(syn.ops, syn.truth_id) if who in sub]
        if mine:
            assert tl.start_us[i] == min(a for a, _ in mine)
            assert tl.end_us[i] == max(b for _, b in mine)
        else:
            assert np.isnan(tl.start_us[i]) and np.isnan(tl.end_us[i])


def test_operations_launched_outside_every_span(monkeypatch):
    """Operations launched before the campaign (one in an earlier root span,
    which is not the campaign's), or whose launch the trace does not hold,
    are outside: a few are fine, more than ``1 - COVERAGE`` of them silence
    the readers."""
    few = synthetic(3, before=1)
    tl = spans.build(few.spans, few.trace(), HOME)
    assert owners(tl)[few.truth.index("rng")] == "(outside)"
    assert tl.names[0] == "campaign" and spans.COVERAGE <= tl.coverage[0] < 1.0
    assert harness.load_reader("device_ms_per_slot.rng")(run_of(few, monkeypatch)) is not None
    many = synthetic(3, before=40)
    tl = spans.build(many.spans, many.trace(), HOME)
    assert tl.coverage[0] < spans.COVERAGE
    assert all(harness.load_reader(name)(run_of(many, monkeypatch)) is None for name in READERS)
    syn = synthetic(3)
    launch = [None if k % 100 == 0 else t for k, t in enumerate(syn.launch_ns)]
    tl = spans.build(syn.spans, syn.trace(launch_ns=launch), HOME)
    assert tl.unlinked == len(syn.ops[::100]) and tl.coverage[0] < spans.COVERAGE
    run = run_of(syn, monkeypatch, trace=syn.trace(launch_ns=launch))
    assert all(harness.load_reader(name)(run) is None for name in READERS)


def test_coverage_leaves_out_the_campaign_s_own_span(monkeypatch):
    """Operations in the campaign outside its children count as outside."""
    few = synthetic(4, campaign_ops=1)
    tl = spans.build(few.spans, few.trace(), HOME)
    assert owners(tl)[few.truth.index("campaign")] == "campaign"
    assert spans.COVERAGE <= min(tl.coverage) < 1.0
    many = synthetic(4, campaign_ops=5)
    assert spans.build(many.spans, many.trace(), HOME).coverage[0] < spans.COVERAGE
    assert all(harness.load_reader(name)(run_of(many, monkeypatch)) is None
               for name in READERS)


def test_none_below_coverage_by_device_time(monkeypatch):
    """One stray operation is few enough by count, but not by device time."""
    syn = synthetic(5)
    busy = sum(b - a for _, a, b in syn.ops)
    ops = [("stray", -busy, -busy + busy / 100)] + syn.ops
    trace = syn.trace(ops=ops, launch_ns=[HOST0 - 10**9] + syn.launch_ns)
    tl = spans.build(syn.spans, trace, HOME)
    assert tl.coverage[0] >= spans.COVERAGE > tl.coverage[1]
    assert all(harness.load_reader(name)(run_of(syn, monkeypatch, trace)) is None
               for name in READERS)


@pytest.mark.parametrize("kernel", sorted(HOME))
def test_none_where_a_kernel_leaves_its_span(monkeypatch, kernel):
    """A kernel that runs in one span alone, found in another (here one of a
    slot's receiver operations renamed): the spans are not trusted."""
    syn = synthetic(6)
    k = syn.truth.index("slot.receiver")
    ops = list(syn.ops)
    ops[k] = (f"{kernel}_kernel", *ops[k][1:])
    tl = spans.build(syn.spans, syn.trace(ops=ops), HOME)
    assert tl.misplaced == 1 and min(tl.coverage) == 1.0
    run = run_of(syn, monkeypatch, trace=syn.trace(ops=ops))
    assert all(harness.load_reader(name)(run) is None for name in READERS)


def test_idle_split_adds_up_to_the_wall():
    syn = synthetic(7)
    tl = spans.build(syn.spans, syn.trace(), HOME)
    inside, outside = spans.idle_us(tl, "slot")
    busy = sum(b - a for _, a, b in syn.ops)
    assert inside + outside == pytest.approx(syn.wall_s * 1e6 - busy, rel=1e-9)
    idle = spans.idle_by_span(tl)
    assert max(idle, key=idle.get) == "slot.receiver"  # the host's stall before it
    starts = np.asarray([a for _, a, _ in syn.ops])
    ends = np.asarray([b for _, _, b in syn.ops])
    assert sum(idle.values()) == pytest.approx(np.clip(starts[1:] - ends[:-1], 0, None).sum()
                                               / 1e3)


def test_under_finds_a_stage_s_operations():
    syn = synthetic(8)
    tl = spans.build(syn.spans, syn.trace(), HOME)
    got = spans.under(tl, ("slot.tx", "slot.channel"), skip=("rng",))
    want = np.isin(syn.truth, ["slot.tx", "slot.channel"])
    assert (got == want).all()
    both = spans.under(tl, ("slot.tx",))
    assert both.sum() == 31 * N_SLOTS  # the modulation and the draws inside ``rng``


def test_the_eight_readers(monkeypatch):
    syn = synthetic(9)
    run = run_of(syn, monkeypatch)
    got = {name: harness.load_reader(name)(run) for name in READERS}
    assert run.calls == [1]  # the spans are taken once a run
    by = {}
    for (name, a, b), owner in zip(syn.ops, syn.truth):
        by[owner] = by.get(owner, 0.0) + (b - a)
    assert got["device_ms_per_slot.rng"] == pytest.approx(by["rng"] / 1e3 / N_SLOTS)
    assert got["device_ms_per_slot.channel"] == pytest.approx(
        (by["slot.tx"] + by["slot.channel"]) / 1e3 / N_SLOTS)
    assert got["device_ms_per_slot.receiver"] == pytest.approx(
        (by["slot.ls"] + by["slot.receiver"]) / 1e3 / N_SLOTS)
    assert got["rng_ns_per_word"] == pytest.approx(by["rng"] * 1e3 / WORDS)
    # each slot's interval and its idle, from the operations its spans launched
    slot_of = {s.id: s.slot for s in syn.spans}
    per = {}
    for (_, a, b), who in zip(syn.ops, syn.truth_id):
        if who is not None and slot_of[who] is not None:
            lo, hi, dur = per.get(slot_of[who], (np.inf, -np.inf, 0.0))
            per[slot_of[who]] = (min(lo, a), max(hi, b), dur + b - a)
    assert len(per) == N_SLOTS
    slot_us = [hi - lo for lo, hi, _ in per.values()]
    slot_idle = sum(hi - lo - dur for lo, hi, dur in per.values())
    assert got["device_idle_ms_per_slot.slot_loop"] == pytest.approx(slot_idle / 1e3 / N_SLOTS)
    busy = sum(b - a for _, a, b in syn.ops)
    share = 1 - busy / (syn.wall_s * 1e6)
    assert got["device_idle_ms_per_slot.slot_loop"] * N_SLOTS / 1e3 / syn.wall_s + \
        got["device_idle_share.outside_slots"] == pytest.approx(share, abs=1e-9)
    assert got["slot_ms.p75"] == pytest.approx(sorted(slot_us)[29] / 1e3)
    build = next(s for s in syn.spans if s.name == "session.build")
    assert got["host_ms_per_campaign.session_build"] == pytest.approx(
        (build.host_end_ns - build.host_start_ns) / 1e6)


def test_none_without_the_program_s_spans(monkeypatch):
    import sys

    syn = synthetic(10)
    run = harness.Run(cell=cells.load_cell("arches-106-concurrent.gpg-256ue"))
    run.trace = syn.trace()
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)  # the parent: no module
    assert all(harness.load_reader(name)(run) is None for name in READERS)
    run = harness.Run(cell=cells.load_cell("arches-106-concurrent.gpg-256ue"))  # no trace
    assert all(harness.load_reader(name)(run) is None for name in READERS)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["arches-106-concurrent.gpg-256ue",
                                      "arches-106-gated-fused.poor-256ue"])
def test_card_spans_hold_the_traced_campaign(card, workload):
    """A cell's campaign under the profiler, on the card: every device
    operation's launch is in the trace and on the spans' clock (inside the
    traced wall), the spans below the campaign hold the operations, each
    kernel of the program's ``HOME`` sits in its span, and each slot's
    decision kernel in that slot's ``slot.decision``."""
    import time

    import torch

    from arches_bench.trace import profile_campaign
    from repro_torch import tracing

    cell = cells.load_cell(workload)
    prog = harness.load_program(cell.program).Program(cell, 3_400_000_012, card)
    prog.fit_policy(3_400_000_011)
    prog.campaign(3_400_000_011)  # every shape once
    tracing.take()
    t0 = time.time_ns()
    _, trace = profile_campaign(lambda: prog.campaign(3_400_000_011), torch.cuda.synchronize)
    t1 = time.time_ns()
    launch = np.asarray([-1 if t is None else t for t in trace.launch_ns])
    assert (launch >= t0).all() and (launch <= t1).all()
    tl = spans.build(tracing.take().spans, trace, HOME)
    assert min(tl.coverage) >= spans.COVERAGE, (tl.coverage, spans.device_by_span(tl))
    assert tl.misplaced == 0 and tl.unlinked == 0
    slots = tl.named("slot")
    assert len(slots) == cell.n_slots
    decisions = [i for i, (name, _, _) in zip(tl.op_span, trace.ops) if "policy_step" in name]
    assert [tl.names[i] for i in decisions] == ["slot.decision"] * cell.n_slots
    assert [tl.parent[i] for i in decisions] == list(slots)
