"""Both forms of ``mmse_interp`` on one card: build, check and time them.

    python3 scripts/mmse_forms_probe.py

Builds ``csrc/mmse_interp.cu`` (printing ``ptxas``' registers and spills),
then at n_prb 4, 24, 106 and 273 and 1 to 2,016 rows holds each form (Gauss
and 4-multiply) against its plain version and a complex128 product (OK when
within 4x the plain float32 version's error and 1e-4 of it, bitwise the same
twice), checks one UE's 12 rows alone against the head of 384, and times both
forms and ``torch.matmul`` in turns at n_prb 106 (12, 384 and 2,016 rows).
Prints the card's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mmse_interp import mmse_interp, mmse_interp_ref  # noqa: E402
from repro_torch.phy.estimators import WienerInterpolator  # noqa: E402
from repro_torch.phy.nr import SlotConfig  # noqa: E402


def time_us(fn, iters: int = 100) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters * 1e3


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    t0 = time.time()
    report = build.build_all(("mmse_interp",))
    print(f"build {time.time() - t0:.1f} s")
    for line in report.get("mmse_interp", "").splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ", line.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def pilots(rows: int, w: torch.Tensor) -> torch.Tensor:
        return torch.complex(torch.randn(rows, w.shape[0], generator=g, device=dev),
                             torch.randn(rows, w.shape[0], generator=g, device=dev))

    bad = 0
    for n_prb in (4, 24, 106, 273):
        w = WienerInterpolator.build(SlotConfig(n_prb=n_prb), device=dev).w
        for rows in (1, 7, 12, 100, 384, 2016):
            h = pilots(rows, w)
            exact = h.to(torch.complex128) @ w.to(torch.complex128)
            msg = [f"n_prb {n_prb} rows {rows}:"]
            for gauss in (True, False):
                got = mmse_interp(h, w, use_gauss=gauss)
                plain = mmse_interp_ref(h, w, use_gauss=gauss)
                same = torch.equal(got, mmse_interp(h, w, use_gauss=gauss))
                e_plain = float((got - plain).abs().max())
                e64, p64 = (float((x - exact).abs().max()) for x in (got, plain))
                ok = same and e_plain <= 1e-4 and e64 <= 4 * p64
                bad += not ok
                msg.append(f"{'gauss' if gauss else '4m'} vs plain {e_plain:.3g}, vs c128 "
                           f"{e64:.3g} (plain {p64:.3g}) same {same} {'OK' if ok else 'BAD'}")
            print(" | ".join(msg))
        h = pilots(384, w)
        print(f"  n_prb {n_prb}: 12 rows alone == head of 384: "
              f"{torch.equal(mmse_interp(h[:12], w), mmse_interp(h, w)[:12])}")
    w = WienerInterpolator.build(SlotConfig(n_prb=106), device=dev).w
    for rows in (12, 384, 2016):
        h = pilots(rows, w)
        fns = {"gauss": lambda: mmse_interp(h, w),
               "4m": lambda: mmse_interp(h, w, use_gauss=False),
               "matmul": lambda: torch.matmul(h, w)}
        first = {k: time_us(f) for k, f in fns.items()}
        second = {k: time_us(f) for k, f in reversed(list(fns.items()))}
        print(f"rows {rows}: " + "; ".join(f"{k} {first[k]:.2f} / {second[k]:.2f} us"
                                          for k in fns))
    print("BAD" if bad else "ALL OK", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
