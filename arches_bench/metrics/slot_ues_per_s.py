"""Slot-UEs of the window's campaigns over the window's host time (ends at
the ``torch.cuda.synchronize()`` after the last campaign)."""


def read(run):
    return run.slot_ues / run.window_s
