"""Device operations (kernels, copies, fills) of the traced campaign, a slot."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return len(run.trace.ops) / run.cell.n_slots
