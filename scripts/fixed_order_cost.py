"""What the fixed-order per-UE sums cost the CONCURRENT main path, on one card.

    python3 scripts/fixed_order_cost.py [--pairs 3]

Runs ``chip_smoke.py``'s CONCURRENT main-path campaign (closed loop, 32 UEs,
n_prb 106, 40 slots) once to fit its tree, then times the closed loop in
turns, fixed, plain, plain, fixed, ``--pairs`` times over:

- fixed: the port as it ships (``ue_reduce.ue_sum`` / ``ue_mean`` as
  pairwise trees, the tap and DMRS-symbol contractions term by term);
- plain: the same loop with those sums as ``Tensor.sum`` / ``Tensor.mean``
  and the two contractions as ``torch.einsum`` (PyTorch's reductions, whose
  bits follow the batch).

Prints each run's ms per slot, the mean of each form and their ratio, one
profiled run of each form (kernel launches and device time per slot), and
the card's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def plain_reductions():
    """The slot's fixed-order sums swapped for PyTorch's own, while inside."""
    from repro_torch.core import expert_bank, methodology
    from repro_torch.phy import channel, equalizer, link, pipeline

    def ue_sum(x, dim, keepdim=False):
        return x.sum(dim=dim, keepdim=keepdim)

    def ue_mean(x, dim, keepdim=False):
        return x.mean(dim=dim, keepdim=keepdim)

    swaps = [(m, "ue_sum", ue_sum) for m in (channel, equalizer, expert_bank)]
    swaps += [(m, "ue_mean", ue_mean) for m in (channel, link, pipeline, methodology)]
    swaps += [(channel, "_tap_sum", lambda s, g: torch.einsum("st,ualtm->ualsm", s, g)),
              (equalizer, "_symbol_sum", lambda h, w: torch.einsum("...sd,md->...sm", h, w))]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, fn in swaps:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def loop_ms(sess, plain: bool) -> float:
    ctx = plain_reductions() if plain else contextlib.nullcontext()
    with ctx:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / sess.spec.n_slots * 1e3


def profiled(sess, plain: bool) -> tuple[float, float]:
    """(kernel launches, device ms) per slot of one profiled run."""
    from torch.profiler import ProfilerActivity, profile

    ctx = plain_reductions() if plain else contextlib.nullcontext()
    with ctx, profile(activities=[ProfilerActivity.CUDA]) as prof:
        sess.run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    n = sess.spec.n_slots
    return (sum(e.count for e in events) / n,
            sum(e.self_device_time_total for e in events) / 1e3 / n)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=3)
    args = parser.parse_args()
    smi = cs.phase_device()
    torch.use_deterministic_algorithms(True)
    cs.phase_build()
    from repro_torch.core.session import ArchesSession

    sess = ArchesSession(cs._main_spec(), device="cuda")
    sess.run()  # profiles the experts and fits the tree
    for plain in (False, True):  # warm both forms
        loop_ms(sess, plain)
    times = {False: [], True: []}
    for _ in range(args.pairs):
        for plain in (False, True, True, False):
            times[plain].append(loop_ms(sess, plain))
    fixed = sum(times[False]) / len(times[False])
    plain = sum(times[True]) / len(times[True])
    for label, key in (("fixed", False), ("plain", True)):
        cs.log(f"{label}: " + ", ".join(f"{t:.2f}" for t in times[key]) + " ms/slot")
    cs.log(f"fixed-order sums: {fixed:.2f} ms/slot, plain {plain:.2f}, ratio "
           f"{fixed / plain:.4f} ({args.pairs} pairs in turns, {cs.N_UES} UEs, "
           f"n_prb {cs.N_PRB}, {cs.N_SLOTS} slots)")
    for label, key in (("fixed", False), ("plain", True)):
        launches, dev_ms = profiled(sess, key)
        cs.log(f"profiled {label}: {launches:.0f} launches a slot, {dev_ms:.3f} ms "
               "device time a slot")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
