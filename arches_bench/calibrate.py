"""The readings that a cell's limits are set from, in one process on the card.

    python -m arches_bench.calibrate --workload <name> --seeds 12 \
        --control-seeds 3 --first-seed <n>

For each of ``--seeds`` seeds: the program's policy fit and one campaign
(the first window campaign a run of that seed would time), against the
reference; for each of ``--control-seeds`` seeds: the control, the
reference itself computed with TF32 on in the program's place, against the
reference.  One JSON line a reading on standard output, and the same lines
in ``chiprun_out/calibrate/<workload>.jsonl`` under the checkout.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from arches_bench import cells, harness


def readings(cell: cells.Cell, seeds: list[int], control_seeds: list[int], device: str,
             emit=print) -> list[dict]:
    program = harness.load_program(cell.program)
    out = []
    for kind, seed in [("program", s) for s in seeds] + [("control", s) for s in control_seeds]:
        t = time.perf_counter()
        params_seed = cells.derive_seed(seed, "params")
        campaign_seed = cells.derive_seed(seed, "campaign0")
        if kind == "program":
            prog = program.Program(cell, params_seed, device)
            prog.fit_policy(cells.derive_seed(seed, "warmup"))
            got = prog.campaign(campaign_seed)
            del prog
        else:
            got = program.reference(cell, campaign_seed, params_seed, device, tf32=True)
        want = program.reference(cell, campaign_seed, params_seed, device)
        row = {"workload": cell.name, "kind": kind, "seed": seed, **program.compare(got, want),
               "ai_served_share": float(((got["modes"] == 0)
                                         & (got["gated_overflow"] == 0)).mean()),
               "seconds": time.perf_counter() - t}
        emit(json.dumps(row))
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    args = ap.parse_args()
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cells.ROOT / ".bench_cache" / "repro_torch_build")
    sys.path.insert(0, str(cells.ROOT / "src"))
    cell = cells.load_cell(args.workload)
    seeds = [args.first_seed + i for i in range(args.seeds)]
    control = [args.first_seed + 1000 + i for i in range(args.control_seeds)]
    out_dir = cells.ROOT / "chiprun_out" / "calibrate"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{args.workload}.jsonl", "a") as f:
        def emit(line):
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()

        readings(cell, seeds, control, "cuda", emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
