"""The MMSE expert's kernels against their roofline, in the traced
campaign: the least time for the Wiener interpolation of every UE's pilot
rows each slot (``arches_bench.counts.mmse_interp``) over the device time
of the kernels whose name holds ``mmse_interp``."""

from arches_bench import counts

PATTERNS = ("mmse_interp",)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_s(PATTERNS)
    if t <= 0:
        return None
    cfg = run.cell.config
    rows = run.cell.n_ues * run.cell.n_ant * run.cell.n_dmrs_sym
    bound = run.cell.n_slots * counts.bound_s(*counts.mmse_interp(cfg["n_prb"], rows))
    return 100.0 * bound / t
