"""The verdict that decides ``correct``: the numbers a program's
``compare`` gives (``arches_bench/programs/<program>.py``), each held to
its limit in the cell's ``arches_bench/limits/<cell>.json``."""

from __future__ import annotations

from typing import Mapping

import numpy as np


def verdict(numbers: Mapping[str, float], limits: Mapping[str, Mapping]) -> tuple[bool, list]:
    """``(correct, [(name, value, limit), ...])``: correct where every
    number the limits name is finite and at or under its limit."""
    rows = [(k, float(numbers[k]), float(limits[k]["limit"])) for k in sorted(limits)]
    return all(np.isfinite(v) and v <= lim for _, v, lim in rows), rows
