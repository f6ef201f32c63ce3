"""The slot's device time: each ``slot`` span's device interval (from its
start event to its end event), the 75th percentile by nearest rank over the
traced campaign's slots (10 beyond it at 40 slots); the median is logged
(``arches_bench.spans``)."""

from arches_bench import spans


def read(run):
    tl = spans.timeline(run)
    if tl is None:
        return None
    slots = spans.slot_device_ms(tl)
    return spans.nearest_rank(slots, 0.75) if len(slots) else None
