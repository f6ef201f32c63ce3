"""The card's energy over the window (``nvidia-smi`` power draw sampled
every 100 ms and integrated), in millijoules a slot-UE of the window."""


def read(run):
    if run.energy_j is None:
        return None
    return run.energy_j * 1e3 / run.slot_ues
