"""Example on the PyTorch/CUDA port: the reusable 3-stage policy-design
methodology (paper 4), the port of ``examples/methodology_walkthrough.py``.

Walks the whole pipeline on the channel-estimation case study:
  stage 1: controlled AWGN perturbation of the MMSE estimates (Eq. 3),
  stage 2: monotonicity filtering of the KPM responses,
  stage 3: correlation clustering and representative selection.

    PYTHONPATH=src python examples_torch/methodology_walkthrough.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from repro_torch import random as jr
from repro_torch.core.methodology import (
    design_policy_inputs,
    monotonicity_filter,
    sensitivity_sweep,
)
from repro_torch.phy.ai_estimator import AiEstimatorConfig, init_params
from repro_torch.phy.nr import SlotConfig
from repro_torch.phy.pipeline import LinkState, PuschPipeline
from repro_torch.phy.scenario import GOOD


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args()

    cfg = SlotConfig(n_prb=24)
    net = AiEstimatorConfig(channels=8, n_res_blocks=1)
    pipe = PuschPipeline(cfg, init_params(jr.PRNGKey(0), cfg, net), net=net,
                         device=args.device)

    state = {"link": LinkState(), "i": 0}

    def eval_fn(rho, key):
        state["i"] += 1
        link, out, kpms = pipe.run_slot(
            jr.fold_in(key, state["i"]), 1, state["link"], GOOD, perturb_rho=rho)
        state["link"] = link
        return {**kpms["aerial"], **kpms["oai"]}

    print(f"stage 1: perturbation sweep (rho 0 -> 2) on {pipe.device} ...")
    sweep = sensitivity_sweep(eval_fn, rhos=np.arange(0, 2.01, 0.25), n_trials=3,
                              key=jr.PRNGKey(0, pipe.device))
    for k, name in enumerate(sweep.kpm_names):
        m = sweep.means[:, k]
        print(f"  {name:20s} rho=0: {m[0]:10.3g}   rho=2: {m[-1]:10.3g}")

    print("\nstage 2: monotonicity filter (|spearman| >= 0.8)")
    kept = monotonicity_filter(sweep)
    for name, r in kept.items():
        print(f"  keep {name:20s} r={r:+.2f}")

    print("\nstage 3: redundancy reduction at 0.8")
    flat = {n: sweep.samples[:, :, k].reshape(-1) for k, n in enumerate(sweep.kpm_names)}
    aerial = {n: v for n, v in flat.items()
              if n in ("code_rate", "sinr", "qam_order", "mcs_index",
                       "tb_size", "n_code_blocks", "pdu_length", "ndi", "rsrp")}
    oai = {n: v for n, v in flat.items() if n not in aerial}
    selected, a_res, o_res = design_policy_inputs(aerial, oai)
    print("  selected policy inputs:", ", ".join(selected))


if __name__ == "__main__":
    main()
