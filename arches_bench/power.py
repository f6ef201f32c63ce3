"""The card's energy over a window: ``nvidia-smi`` sampling its power draw
every 100 ms into a file under ``TMPDIR``, integrated over the window."""

from __future__ import annotations

import datetime
import os
import subprocess
import tempfile

#: the fields tried in order: the instantaneous reading where the driver
#: has it, else the driver's own power reading
FIELDS = ("power.draw.instant", "power.draw")
PERIOD_MS = 100


def _query(field: str, index: int) -> float | None:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits",
                          f"--id={index}"], capture_output=True, text=True)
    try:
        return float(res.stdout.strip()) if res.returncode == 0 else None
    except ValueError:
        return None


def _stamp(s: str) -> float:
    return datetime.datetime.strptime(s.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp()


def integrate(samples: list[tuple[float, float]], t0: float, t1: float) -> float:
    """Joules over ``[t0, t1]`` from ``(epoch s, W)`` samples, the draw taken
    as linear between samples and flat past the first and last."""
    pts = sorted(samples)
    inside = [p for p in pts if t0 <= p[0] <= t1]
    if len(inside) < 2 or inside[0][0] - t0 > 1.0 or t1 - inside[-1][0] > 1.0:
        raise RuntimeError(f"power samples do not cover the window: {len(inside)} inside "
                           f"[{t0:.3f}, {t1:.3f}]")

    def at(t):
        before = [p for p in pts if p[0] <= t]
        after = [p for p in pts if p[0] >= t]
        if not before:
            return after[0][1]
        if not after:
            return before[-1][1]
        (ta, wa), (tb, wb) = before[-1], after[0]
        return wa if tb == ta else wa + (wb - wa) * (t - ta) / (tb - ta)

    knots = [(t0, at(t0))] + inside + [(t1, at(t1))]
    return sum((tb - ta) * (wa + wb) / 2 for (ta, wa), (tb, wb) in zip(knots, knots[1:]))


class PowerSampler:
    """``with PowerSampler(0) as p: ...`` samples card 0; after the block,
    ``p.energy_j(t0, t1)`` for epoch times inside it.  Raises on entry
    where no field of ``FIELDS`` reads a power."""

    def __init__(self, index: int = 0):
        self.index = index
        self.field = next((f for f in FIELDS if _query(f, index) is not None), None)
        if self.field is None:
            raise RuntimeError(f"nvidia-smi reads no power on card {index} ({FIELDS})")
        self.samples: list[tuple[float, float]] = []

    def __enter__(self) -> "PowerSampler":
        fd, self.path = tempfile.mkstemp(prefix="arches_power_", suffix=".csv",
                                         dir=os.environ.get("TMPDIR") or None)
        os.close(fd)
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu=timestamp,{self.field}", "--format=csv,noheader,nounits",
             f"-lms={PERIOD_MS}", f"--id={self.index}", "-f", self.path],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        return self

    def __exit__(self, *exc) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        try:
            with open(self.path) as f:
                for line in f:
                    parts = line.split(",")
                    try:
                        self.samples.append((_stamp(parts[0]), float(parts[1])))
                    except (IndexError, ValueError):
                        continue
        finally:
            os.remove(self.path)

    def energy_j(self, t0: float, t1: float) -> float:
        return integrate(self.samples, t0, t1)
