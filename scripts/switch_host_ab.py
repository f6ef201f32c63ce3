"""Host time per call of the switch wrappers: another commit's
``kernels/switch_select/ops.py`` against this tree's, on one card.

    git archive <commit> src/repro_torch/kernels/switch_select/ops.py | tar -x -C build/parent
    python3 scripts/switch_host_ab.py build/parent/src/repro_torch/kernels/switch_select/ops.py

Both wrappers launch this tree's kernels.  For the scalar switch (one UE's
(4, 1, 1272, 3) complex64 estimate), the per-UE switch (32 UEs) and the
scatter (capacity 16), it takes six readings a side of 2,000 calls back to
back each, in turns (other, this, this, other) three times over, and prints
every reading, each side's median and their ratio, beside the card's name
and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels.switch_select import ops as this  # noqa: E402


def host_us(fn, iters: int = 2000) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    us = (time.perf_counter_ns() - t0) / iters / 1e3
    torch.cuda.synchronize()
    return us


def main(other_path: str) -> int:
    spec = importlib.util.spec_from_file_location("other_switch_ops", other_path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def cplx(shape):
        return torch.complex(torch.randn(shape, generator=g, device=dev),
                             torch.randn(shape, generator=g, device=dev))

    one = [cplx((4, 1, 1272, 3)) for _ in range(2)]
    outs = [cplx((32, 4, 1, 1272, 3)) for _ in range(2)]
    modes = (torch.arange(32, device=dev) % 3 == 0).to(torch.int32)
    compact = cplx((16, 4, 1, 1272, 3))
    ues = torch.arange(32, device=dev)
    src = torch.where(ues % 2 == 0, ues // 2, -1).to(torch.int32)
    cases = {"scalar copy": lambda m: m.switch_select(1, one),
             "per-UE": lambda m: m.switch_select(modes, outs),
             "scatter": lambda m: m.switch_scatter(src, compact, outs[0])}
    for name, call in cases.items():
        readings: dict[str, list[float]] = {"other": [], "this": []}
        for label, mod in (("other", other), ("this", this), ("this", this),
                           ("other", other)) * 3:
            readings[label].append(host_us(lambda: call(mod)))
        med = {k: sorted(v)[len(v) // 2] for k, v in readings.items()}
        print(f"{name}: other {['%.2f' % x for x in readings['other']]} this "
              f"{['%.2f' % x for x in readings['this']]} median other {med['other']:.2f} us "
              f"this {med['this']:.2f} us ratio {med['this'] / med['other']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
