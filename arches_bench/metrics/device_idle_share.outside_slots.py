"""Share of the traced campaign's host time (the wall of
``device_idle_share``) in which the device is idle outside every ``slot``
span's device interval: the session's build, the history and the wall
beyond the campaign's interval (``arches_bench.spans``)."""

from arches_bench import spans


def read(run):
    tl = spans.timeline(run)
    if tl is None:
        return None
    return spans.idle_us(tl, "slot")[1] / tl.wall_us
