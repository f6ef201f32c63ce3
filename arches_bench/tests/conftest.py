"""Shared pieces of the benchmark's own tests: the checkout on ``sys.path``
and a tiny CPU form of a cell (n_prb 6, 8 channels x 1 block, 6 UEs x 12
slots) that the harness's control flow runs on in seconds."""

import copy
import sys

import pytest

from arches_bench import cells

for p in (str(cells.ROOT / "src"), str(cells.ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny(workload: str) -> cells.Cell:
    base = cells.load_cell(workload)
    config, traffic = copy.deepcopy(base.config), copy.deepcopy(base.traffic)
    config["n_prb"] = 6
    config["bank"].update(channels=8, n_res_blocks=1)
    if config["bank"]["gated_capacity"] is not None:
        config["bank"]["gated_capacity"] = 3
    config["policy"].update(train_slots=12, train_scenario_args={"poor_start": 4, "poor_end": 8})
    traffic.update(n_ues=6, n_slots=12)
    if "poor_start" in traffic["scenario_args"]:
        traffic["scenario_args"] = {"poor_start": 3, "poor_end": 9}
    return cells.Cell(workload=base.workload, config=config, traffic=traffic)


@pytest.fixture
def card():
    """The CUDA device, or a skip where this host has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
