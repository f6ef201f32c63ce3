"""The AI expert's kernels against their roofline, in the traced campaign:
the least time for the residual CNN on the UEs the trajectory says it ran
on each slot (``arches_bench.counts.ai_expert``) over the device time of
the kernels whose name holds ``gated_expert``."""

from arches_bench import counts

PATTERNS = ("gated_expert",)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_s(PATTERNS)
    if t <= 0:
        return None
    bank, n_prb = run.cell.config["bank"], run.cell.config["n_prb"]
    bound = sum(counts.bound_s(*counts.ai_expert(n_prb, run.cell.n_ant, run.cell.n_dmrs_sym,
                                                  bank["channels"],
                                                  bank["n_res_blocks"], int(n)))
                for n in run.program.ai_rows(run.cell, run.traced) if n > 0)
    return 100.0 * bound / t if bound > 0 else None
