"""Device milliseconds a slot of link adaptation, TX and the channel: the
operations inside the ``slot.tx`` and ``slot.channel`` spans that no
``rng`` span holds (``arches_bench.spans``)."""

from arches_bench import spans

STAGES = ("slot.tx", "slot.channel")


def read(run):
    tl = spans.timeline(run)
    if tl is None:
        return None
    return tl.device_us(spans.under(tl, STAGES, skip=("rng",))) / 1e3 / run.cell.n_slots
