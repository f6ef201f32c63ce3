"""Device milliseconds a slot of the random draws: the operations whose
innermost span is ``rng`` (``repro_torch.random``'s public draws), whatever
stage called them (``arches_bench.spans``)."""

from arches_bench import spans


def read(run):
    tl = spans.timeline(run)
    if tl is None:
        return None
    rng = [i for i, n in enumerate(tl.names) if n == "rng"]
    return tl.device_us(spans.in_spans(tl, rng)) / 1e3 / run.cell.n_slots
