"""Device nanoseconds of the random draws (the ``rng`` spans' operations)
per 32-bit word that ``repro_torch.random.bits`` drew in the traced
campaign (its ``rng.words`` counter)."""

from arches_bench import spans


def read(run):
    tl = spans.timeline(run)
    if tl is None or not tl.counters.get("rng.words"):
        return None
    rng = [i for i, n in enumerate(tl.names) if n == "rng"]
    return tl.device_us(spans.in_spans(tl, rng)) * 1e3 / tl.counters["rng.words"]
