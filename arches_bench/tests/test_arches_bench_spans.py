"""The span helper (``arches_bench.spans``) and its eight readers on a
synthetic trace with synthetic spans: the placement through a drifting
clock and where the device idles, each operation's span, the idle split,
the slot's percentile, and ``None`` where the spans cover too little, a
kernel leaves its span or nothing anchors them."""

import dataclasses

import numpy as np
import pytest

from arches_bench import cells, harness, spans
from arches_bench.trace import Trace

READERS = ("device_ms_per_slot.rng", "device_ms_per_slot.channel",
           "device_ms_per_slot.receiver", "rng_ns_per_word",
           "device_idle_ms_per_slot.slot_loop", "device_idle_share.outside_slots",
           "slot_ms.p75", "host_ms_per_campaign.session_build")
OFFSET_US = 987_654.321  # the events' clock against the trace's
WORDS = 1_000_000
N_SLOTS = 40


@dataclasses.dataclass
class Synthetic:
    spans: list  # repro_torch.tracing.Span
    ops: list  # (name, start us, end us) on the trace's clock
    truth: list  # per op: the name of the span that launched it
    truth_slot: list  # per op: that span's slot index
    wall_s: float
    slot_idle_us: float  # device idle inside the slots
    slot_us: list  # each slot's device interval


def synthetic(seed: int = 0, rho: float = 0.0, jump_slot: int | None = None,
              jump_us: float = 0.0, campaign_ops: int = 0) -> Synthetic:
    """One campaign of ``N_SLOTS`` slots as a stream: each span's events sit
    in the gaps between its operations (recorded in stream order), with a
    host stall before each slot's receiver.  The trace's clock runs ``rho``
    fast against the events', and from slot ``jump_slot``'s receiver on it
    runs true again and ``jump_us`` back, as a profiler's can.
    ``campaign_ops`` operations run in the campaign outside its children."""
    from repro_torch.tracing import Span

    rng = np.random.default_rng(seed)
    t = [0.0]
    ops, truth, recs, stack = [], [], [], []
    slot_idle = [0.0]

    def gap(lo=0.3, hi=2.5):
        g = rng.uniform(lo, hi)
        t[0] += g
        if any(r[0] == "slot" for r in stack):
            slot_idle[0] += g

    def op(name, dur):
        gap()
        ops.append((name, t[0], t[0] + dur))
        truth.append((stack[-1][0], stack[-1][3]))
        t[0] += dur

    def enter(name, slot=None):
        gap(0.1, 0.4)
        parent = stack[-1] if stack else None
        rec = [name, len(recs), None if parent is None else parent[1],
               slot if slot is not None else (None if parent is None else parent[3]), t[0], None]
        recs.append(rec)
        stack.append(rec)

    def leave():
        gap(0.1, 0.4)
        stack.pop()[5] = t[0]

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
            op("vectorized_elementwise_kernel xor", rng.uniform(1.0, 4.0))
        leave()
        enter("slot.tx")
        enter("rng")
        for _ in range(30):
            op("vectorized_elementwise_kernel and", rng.uniform(1.0, 40.0))
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
        gap(50.0, 150.0)  # the host stalls: the slot idles
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

    origin = recs[0][4]
    jump_t = next((a for name, _, _, slot, a, _ in recs
                   if name == "slot.receiver" and slot == jump_slot), np.inf)

    def clock(x):  # the trace's clock at event time x (from the campaign's start)
        x = x - origin
        return x + rho * min(x, jump_t - origin) - (jump_us if x >= jump_t - origin else 0.0)

    host0 = 1_700_000_000_000_000_000
    out = [Span(name, sid, parent, slot, host0 + int(a * 1e3), host0 + int(b * 1e3),
                (a - origin) / 1e3, (b - origin) / 1e3,
                {"rng.words": WORDS} if parent is None else None)
           for name, sid, parent, slot, a, b in recs]
    slot_us = [b - a for name, _, _, _, a, b in recs if name == "slot"]
    # the profiled wall runs a little past the campaign's interval
    wall_s = (recs[0][5] - recs[0][4] + 250.0) / 1e6
    traced = sorted(((n, clock(a) + OFFSET_US, clock(b) + OFFSET_US, who)
                     for (n, a, b), who in zip(ops, truth)), key=lambda op: op[1])
    return Synthetic(spans=out, ops=[op[:3] for op in traced],
                     truth=[op[3][0] for op in traced], truth_slot=[op[3][1] for op in traced],
                     wall_s=wall_s, slot_idle_us=slot_idle[0], slot_us=slot_us)


def run_of(syn: Synthetic, monkeypatch, ops=None) -> harness.Run:
    """A traced run of the CONCURRENT cell whose program hands out ``syn``."""
    from repro_torch import tracing

    taken = tracing.Taken(spans=list(syn.spans), counters={"rng.words": WORDS})
    calls = []
    monkeypatch.setattr(tracing, "take", lambda: calls.append(1) or taken)
    run = harness.Run(cell=cells.load_cell("arches-106-concurrent.gpg-256ue"))
    run.trace = Trace(ops=ops if ops is not None else syn.ops, wall_s=syn.wall_s)
    run.calls = calls
    return run


def test_fit_and_each_operation_s_span():
    syn = synthetic()
    tl = spans.build(syn.spans, syn.ops, syn.wall_s)
    assert tl.fit_share == 1.0 and tl.coverage == (1.0, 1.0) and tl.misplaced == 0
    assert [tl.names[i] for i in tl.op_span] == syn.truth
    origin = syn.spans[0].device_start_ms * 1e3
    # an event sits 0.1-0.4 us after an operation; the fit places it in that
    # gap, give or take the gaps' tolerance
    bound = 0.4 + spans.TOL_US
    for i, s in enumerate(syn.spans):
        assert abs(tl.start_us[i] - (s.device_start_ms * 1e3 - origin + OFFSET_US)) < bound
        assert abs(tl.end_us[i] - (s.device_end_ms * 1e3 - origin + OFFSET_US)) < bound


@pytest.mark.parametrize("rho", [1.5e-2, -1.6e-2])
def test_placement_through_a_drifting_trace_clock(monkeypatch, rho):
    """The trace runs 1.5 % fast (or 1.6 % slow) against the events, as far
    as a profiler's clock has been seen to: the anchors follow it, and every
    operation finds its span."""
    syn = synthetic(3, rho=rho)
    tl = spans.build(syn.spans, syn.ops, syn.wall_s)
    assert tl.coverage == (1.0, 1.0) and tl.fit_share == 1.0 and tl.misplaced == 0
    assert [tl.names[i] for i in tl.op_span] == syn.truth
    assert harness.load_reader("device_ms_per_slot.rng")(run_of(syn, monkeypatch)) is not None


def test_none_where_the_trace_clock_jumps_mid_slot(monkeypatch):
    """The trace runs 0.5 % fast for 25 slots, then 150 us back mid-slot,
    laying two slots' operations over each other: nearly every operation
    still finds its span, the events keep their stream order on the trace,
    and the kernels the jump moves out of their spans leave the readers
    silent."""
    syn = synthetic(5, rho=5e-3, jump_slot=25, jump_us=150.0)
    tl = spans.build(syn.spans, syn.ops, syn.wall_s)
    assert tl.coverage == (1.0, 1.0) and tl.fit_share > 0.99
    right = np.asarray([tl.names[i] for i in tl.op_span]) == np.asarray(syn.truth)
    dur = np.asarray([b - a for _, a, b in syn.ops])
    assert right.mean() > 0.98 and dur[right].sum() > 0.99 * dur.sum()
    d0 = np.asarray([s.device_start_ms for s in syn.spans])
    d1 = np.asarray([s.device_end_ms for s in syn.spans])
    order = np.argsort(np.concatenate([d0, d1]), kind="stable")
    assert np.all(np.diff(np.concatenate([tl.start_us, tl.end_us])[order]) >= 0)
    assert tl.misplaced > 0
    assert all(harness.load_reader(name)(run_of(syn, monkeypatch)) is None for name in READERS)


@pytest.mark.parametrize("kernel", sorted(spans.HOME))
def test_none_where_a_kernel_leaves_its_span(monkeypatch, kernel):
    """A kernel that runs in one span alone, found in another (here one of a
    slot's receiver operations renamed): the placement is not trusted."""
    syn = synthetic(7)
    k = next(k for k, owner in enumerate(syn.truth) if owner == "slot.receiver")
    ops = list(syn.ops)
    ops[k] = (f"{kernel}_kernel", *ops[k][1:])
    tl = spans.build(syn.spans, ops, syn.wall_s)
    assert tl.misplaced == 1 and min(tl.coverage) == 1.0
    run = run_of(syn, monkeypatch, ops=ops)
    assert all(harness.load_reader(name)(run) is None for name in READERS)


def test_coverage_leaves_out_the_campaign_s_own_span(monkeypatch):
    """Operations in the campaign outside its children count as outside:
    a few are fine, more than ``1 - COVERAGE`` of them silence the readers."""
    few = synthetic(8, campaign_ops=1)
    tl = spans.build(few.spans, few.ops, few.wall_s)
    assert tl.names[tl.op_span[few.truth.index("campaign")]] == "campaign"
    assert spans.COVERAGE <= min(tl.coverage) < 1.0
    assert harness.load_reader("device_ms_per_slot.rng")(run_of(few, monkeypatch)) is not None
    many = synthetic(8, campaign_ops=5)
    tl = spans.build(many.spans, many.ops, many.wall_s)
    assert tl.coverage[0] < spans.COVERAGE
    assert all(harness.load_reader(name)(run_of(many, monkeypatch)) is None
               for name in READERS)


def test_idle_split_adds_up_to_the_wall():
    syn = synthetic(1)
    tl = spans.build(syn.spans, syn.ops, syn.wall_s)
    inside, outside = spans.idle_us(tl)
    # each slot's two events sit in gaps, up to 0.4 us from where they were
    assert inside == pytest.approx(syn.slot_idle_us, abs=2 * 0.4 * N_SLOTS)
    busy = sum(b - a for _, a, b in syn.ops)
    assert inside + outside == pytest.approx(syn.wall_s * 1e6 - busy, rel=1e-9)
    idle = spans.idle_by_span(tl)
    assert max(idle, key=idle.get) == "slot.receiver"  # the host's stall before it
    starts = np.asarray([a for _, a, _ in syn.ops])
    ends = np.asarray([b for _, _, b in syn.ops])
    assert sum(idle.values()) == pytest.approx((starts[1:] - ends[:-1]).sum() / 1e3)


def test_the_eight_readers(monkeypatch):
    syn = synthetic(2)
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
    assert got["device_idle_ms_per_slot.slot_loop"] == pytest.approx(
        syn.slot_idle_us / 1e3 / N_SLOTS, abs=2 * 0.4e-3)
    busy = sum(b - a for _, a, b in syn.ops)
    share = 1 - busy / (syn.wall_s * 1e6)
    assert got["device_idle_ms_per_slot.slot_loop"] * N_SLOTS / 1e3 / syn.wall_s + \
        got["device_idle_share.outside_slots"] == pytest.approx(share, abs=1e-9)
    assert got["slot_ms.p75"] == pytest.approx(sorted(syn.slot_us)[29] / 1e3)  # events alone
    build = next(s for s in syn.spans if s.name == "session.build")
    assert got["host_ms_per_campaign.session_build"] == pytest.approx(
        (build.host_end_ns - build.host_start_ns) / 1e6)


def test_none_below_full_coverage(monkeypatch):
    syn = synthetic(3)
    n = len(syn.ops)
    # a few operations before the campaign opened: under 99.9 % inside a span
    early = syn.ops[0][1] - 1e4
    extra = [("stray", early + 10 * k, early + 10 * k + 1) for k in range(n // 500)]
    run = run_of(syn, monkeypatch, ops=extra + syn.ops)
    assert all(harness.load_reader(name)(run) is None for name in READERS)
    # one stray operation is few enough by count, but not by device time
    busy = sum(b - a for _, a, b in syn.ops)
    ops = [("stray", early, early + busy / 100)] + syn.ops
    run = run_of(syn, monkeypatch, ops=ops)
    tl = spans.build(syn.spans, ops, syn.wall_s)
    assert tl.coverage[0] >= spans.COVERAGE > tl.coverage[1]
    assert all(harness.load_reader(name)(run) is None for name in READERS)


def test_placement_where_the_device_idles_between_operations(monkeypatch):
    """75 us more before every operation (a slot loop the host paces): the
    events fit gaps at many placements, and the anchors still place every
    operation in its span."""
    syn = synthetic(6)
    stretch = [(name, a + 75.0 * (k + 1), b + 75.0 * (k + 1))
               for k, (name, a, b) in enumerate(syn.ops)]
    starts = np.asarray([a for _, a, _ in syn.ops])

    def later(ms):  # an event's time on its clock, moved as the operations before it
        return ms + 75e-3 * np.searchsorted(starts, ms * 1e3 + OFFSET_US, side="right")

    moved = [dataclasses.replace(s, device_start_ms=later(s.device_start_ms),
                                 device_end_ms=later(s.device_end_ms)) for s in syn.spans]
    tl = spans.build(moved, stretch, syn.wall_s * 2)
    assert tl.misplaced == 0 and [tl.names[i] for i in tl.op_span] == syn.truth
    run = run_of(dataclasses.replace(syn, spans=moved, ops=stretch, wall_s=syn.wall_s * 2),
                 monkeypatch)
    assert all(harness.load_reader(name)(run) is not None for name in READERS)


def test_none_without_anchors(monkeypatch):
    """A trace without the kernels of ``HOME`` (or with as many launches as
    spans of none of them): nothing places the spans."""
    syn = synthetic(9)
    ops = [("other" if any(key in name for key in spans.HOME) else name, a, b)
           for name, a, b in syn.ops]
    assert spans.build(syn.spans, ops, syn.wall_s) is None
    assert all(harness.load_reader(name)(run_of(syn, monkeypatch, ops=ops)) is None
               for name in READERS)


def test_none_without_the_program_s_spans(monkeypatch):
    import sys

    syn = synthetic(4)
    run = harness.Run(cell=cells.load_cell("arches-106-concurrent.gpg-256ue"))
    run.trace = Trace(ops=syn.ops, wall_s=syn.wall_s)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)  # the parent: no module
    assert all(harness.load_reader(name)(run) is None for name in READERS)
    run = harness.Run(cell=cells.load_cell("arches-106-concurrent.gpg-256ue"))  # no trace
    assert all(harness.load_reader(name)(run) is None for name in READERS)
