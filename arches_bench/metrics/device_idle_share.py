"""Share of the traced campaign's host time (under the profiler) in which no
device operation ran: 1 - the union of the operations' intervals / the wall."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 1.0 - run.trace.busy_s() / run.trace.wall_s
