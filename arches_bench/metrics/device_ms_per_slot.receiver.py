"""Device milliseconds a slot of the LS estimate and the receiver (the
equalizer, the KPMs, the TB outcome and OLLA): the operations inside the
``slot.ls`` and ``slot.receiver`` spans that no ``rng`` span holds
(``arches_bench.spans``)."""

from arches_bench import spans

STAGES = ("slot.ls", "slot.receiver")


def read(run):
    tl = spans.timeline(run)
    if tl is None:
        return None
    return tl.device_us(spans.under(tl, STAGES, skip=("rng",))) / 1e3 / run.cell.n_slots
