"""Device milliseconds a slot of every operation that neither the experts'
kernels nor the switch and policy kernels claim: the slot loop's threefry
draws, channel, LS, equalizer and link arithmetic, copies and fills."""

#: the kernels ``mmse_interp_roofline``, ``ai_expert_roofline`` and
#: ``device_us_per_slot.switch_policy`` claim
CLAIMED = ("mmse_interp", "gated_expert", "copy_rows_kernel", "switch_select",
           "policy_step", "tree_infer")


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return run.trace.device_s(exclude=CLAIMED) * 1e3 / run.cell.n_slots
