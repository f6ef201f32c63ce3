"""Host milliseconds of the traced campaign's ``session.build`` span: the
engine (the Wiener matrix, the AI expert's weights) and the device policy
built for a fresh ``ArchesSession`` (``arches_bench.spans``)."""

from arches_bench import spans


def read(run):
    tl = spans.timeline(run)
    if tl is None:
        return None
    build = [i for i, n in enumerate(tl.names) if n == "session.build"]
    return float(tl.host_ms[build].sum()) if build else None
