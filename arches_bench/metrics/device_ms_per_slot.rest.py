"""Device milliseconds a slot of every operation that neither the experts'
kernels nor the switch and policy kernels claim: the slot loop's threefry
draws, channel, LS, equalizer and link arithmetic, copies and fills
(``CLAIMED`` of ``programs/arches_campaign.py`` names the claimed ones)."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return run.trace.device_s(exclude=run.program.CLAIMED) * 1e3 / run.cell.n_slots
