"""The slot's device time: each ``slot`` span's device interval (from the
start of its first operation to the end of its last), the 75th percentile
by nearest rank over the traced campaign's slots (10 beyond it at 40
slots); the median is logged (``arches_bench.spans``)."""

from arches_bench import spans


def read(run):
    tl = spans.timeline(run)
    if tl is None:
        return None
    slots = spans.device_ms(tl, "slot")
    return spans.nearest_rank(slots, 0.75) if len(slots) else None
