"""The port's spans and counters (``repro_torch.tracing``) on the CPU: the
span tree of a closed-loop campaign, recording's switches, the counters,
and that recording changes nothing the campaign computes."""

import collections
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch import tracing
from repro_torch.kernels import build

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.take()
    yield
    tracing.take()


def _tree(taken):
    by_id = {s.id: s for s in taken.spans}
    return collections.Counter(
        (s.name, by_id[s.parent].name if s.parent is not None else None) for s in taken.spans)


def test_spans_nest_with_their_parents():
    with tracing.recording():
        with tracing.span("a", slot=3):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("b"):
                pass
        with tracing.span("d"):
            pass
    taken = tracing.take()
    assert [s.name for s in taken.spans] == ["a", "b", "c", "b", "d"]
    a, b1, c, b2, d = taken.spans
    assert a.parent is None and d.parent is None
    assert b1.parent == a.id and b2.parent == a.id and c.parent == b1.id
    assert [s.slot for s in taken.spans] == [3, 3, 3, 3, None]  # a child inherits it
    for s in taken.spans:
        assert s.host_start_ns <= s.host_end_ns
        assert s.device_start_ms is None and s.device_end_ms is None  # no CUDA path
    assert a.host_start_ns <= b1.host_start_ns <= c.host_end_ns <= b1.host_end_ns
    assert b2.host_end_ns <= a.host_end_ns <= d.host_start_ns
    assert a.counters == {} and b1.counters is None  # a root's counter growth
    assert tracing.take().spans == []  # take empties the buffer


def test_a_span_inside_one_of_its_name_records_nothing():
    key = jr.PRNGKey(7)
    with tracing.recording():
        jr.normal(key, (4,))  # normal -> uniform -> bits: one rng span
        with tracing.span("outer"):
            jr.randint(key, (3,), 0, 5)  # randint -> split, bits: one
    names = [s.name for s in tracing.take().spans]
    assert names == ["rng", "outer", "rng"]


def test_nothing_recorded_or_allocated_with_recording_off(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with recording off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    span = tracing.span
    for _ in range(10):  # warm every code path first
        with span("slot", "cpu", slot=1):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for i in range(2000):
            with span("slot", "cpu", slot=i):
                with span("slot.tx"):
                    pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, tracing.__file__)]
    grown = [d for d in after.filter_traces(mine).compare_to(before.filter_traces(mine), "lineno")
             if d.size_diff > 0 or d.count_diff > 0]
    assert grown == []
    assert tracing.span("x") is tracing.span("y")  # the one shared no-op
    assert tracing.take().spans == []


def test_recording_and_a_cpu_profiler_each_turn_it_on():
    from torch.profiler import ProfilerActivity, profile

    with tracing.span("before"):
        pass
    with tracing.recording():
        with tracing.span("forced"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("profiled"):
            pass
        with tracing.recording(False):  # off even under the profiler
            with tracing.span("silenced"):
                pass
    with tracing.span("after"):
        pass
    assert [s.name for s in tracing.take().spans] == ["forced", "profiled"]


def test_rng_words_counts_the_elements_drawn():
    key = jr.PRNGKey(3)
    keys = jr.split(key, 5)
    before = tracing.counters["rng.words"]
    jr.bits(key, (7, 3))
    jr.uniform(keys, (11,))
    jr.normal(key, (2, 2))
    jr.bernoulli(key, 0.5, (13,))
    jr.randint(key, (6,), 0, 9)  # two draws of its shape
    jr.fold_in(key, 4)
    jr.split(key, 3)
    assert tracing.counters["rng.words"] - before == 21 + 5 * 11 + 4 + 13 + 2 * 6
    with tracing.recording():
        with tracing.span("root"):
            jr.bits(key, (10,))
    (root, rng) = tracing.take().spans
    assert root.counters == {"rng.words": 10} and rng.counters is None


def test_launch_counts_are_the_tracing_counters():
    assert build.launch_counts is tracing.launch_counts
    build.launch_counts["gated_expert"] += 2
    assert tracing.take().counters["kernel.launches.gated_expert"] == \
        build.launch_counts["gated_expert"]
    build.reset_launch_counts()
    assert set(tracing.launch_counts.values()) == {0}


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    before = tracing.counters["tracing.dropped"]
    with tracing.recording():
        for _ in range(5):
            with tracing.span("s"):
                pass
    assert len(tracing.take().spans) == 3
    assert tracing.counters["tracing.dropped"] - before == 2


def _campaign(spec, policies):
    from repro_torch.core.session import ArchesSession

    return ArchesSession(spec, device="cpu", host_policies=policies).run()


@pytest.mark.parametrize("bank", ["concurrent", "gated"])
def test_closed_loop_campaign_span_tree_and_same_bits(bank):
    from repro_torch.core.session import ArchesSession, CampaignSpec, ExpertBankSpec, PolicySpec

    bank_spec = (ExpertBankSpec(channels=8, n_res_blocks=1) if bank == "concurrent" else
                 ExpertBankSpec(channels=8, n_res_blocks=1, execution_mode="gated", fused=True,
                                gated_capacity=2))
    spec = CampaignSpec(path="closed_loop", scenario="good_poor_good", n_ues=3, n_slots=4,
                        n_prb=6, scenario_args=(("poor_start", 1), ("poor_end", 3)),
                        policies=(PolicySpec(kind="tree", train_slots=4),), bank=bank_spec)
    policies = ArchesSession(spec, device="cpu").host_policies
    tracing.take()
    plain = _campaign(spec, policies)
    with tracing.recording():
        traced = _campaign(spec, policies)
    taken = tracing.take()
    for name in ("modes", "decisions"):
        np.testing.assert_array_equal(getattr(plain, name), getattr(traced, name))
    for group in ("kpms", "outputs"):
        a, b = getattr(plain, group), getattr(traced, group)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    tree = _tree(taken)
    n = spec.n_slots
    assert tree[("campaign", None)] == 1
    assert tree[("session.build", "campaign")] == 1
    assert tree[("campaign.init", "campaign")] == 1
    assert tree[("slot", "campaign")] == n
    assert tree[("campaign.history", "campaign")] == 2  # the stack, the host copies
    for stage in ("slot.tx", "slot.channel", "slot.ls", "slot.bank", "slot.receiver",
                  "slot.decision"):
        assert tree[(stage, "slot")] == n, stage
    for part in ("bank.mmse", "bank.ai", "bank.switch"):
        assert tree[(part, "slot.bank")] >= n, part
    # the random draws are the innermost spans, under the stages that call them
    assert {parent for (name, parent) in tree if name == "rng"} >= {
        "slot", "slot.tx", "slot.channel", "slot.receiver"}
    assert not any(parent == "rng" for (_, parent) in tree)
    slots = [s for s in taken.spans if s.name == "slot"]
    assert [s.slot for s in slots] == list(range(n))
    by_id = {s.id: s for s in taken.spans}
    for s in taken.spans:  # every stage inherits its slot's index
        if s.parent is not None and by_id[s.parent].name == "slot":
            assert s.slot == by_id[s.parent].slot
    (root,) = [s for s in taken.spans if s.parent is None]
    assert root.counters["rng.words"] > 0
