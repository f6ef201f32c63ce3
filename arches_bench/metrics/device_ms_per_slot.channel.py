"""Device milliseconds a slot of link adaptation, TX and the channel: the
operations inside the ``slot.tx`` and ``slot.channel`` spans that no
``rng`` span holds (``arches_bench.spans``)."""

from arches_bench import spans


def read(run):
    tl = spans.timeline(run)
    if tl is None:
        return None
    return tl.device_us(spans.stage_ops(tl, "channel")) / 1e3 / run.cell.n_slots
