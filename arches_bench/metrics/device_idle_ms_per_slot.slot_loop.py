"""Idle device milliseconds a slot inside the ``slot`` spans' device
intervals (its first operation's start to its last's end): each slot's
interval less the union of the operations in it (``arches_bench.spans``)."""

from arches_bench import spans


def read(run):
    tl = spans.timeline(run)
    if tl is None:
        return None
    return spans.idle_us(tl, "slot")[0] / 1e3 / run.cell.n_slots
