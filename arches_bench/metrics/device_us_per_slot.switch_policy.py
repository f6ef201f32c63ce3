"""Device microseconds a slot of the switch, gather and scatter kernels
(``copy_rows_kernel``, ``switch_select``) and of the decision phase
(``policy_step``, ``tree_infer``)."""

PATTERNS = ("copy_rows_kernel", "switch_select", "policy_step", "tree_infer")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_s(PATTERNS)
    return t * 1e6 / run.cell.n_slots if t > 0 else None
