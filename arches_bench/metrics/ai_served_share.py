"""Share of the window's slot-UEs that the AI expert served: selected by
the policy and within the GATED capacity (``(modes == 0) & (gated_overflow
== 0)``)."""

import numpy as np


def read(run):
    served = [((c["modes"] == 0) & (c["gated_overflow"] == 0)).mean() for c in run.campaigns]
    return float(np.mean(served))
