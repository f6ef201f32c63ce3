"""On the card: the control (the reference itself, computed with TF32 on,
in the program's place) comes out not correct under each cell's limits,
and the program comes out correct, at the cell's widths with 16 UEs.

    PYTHONPATH=src python -m pytest -m cuda arches_bench/tests
"""

import dataclasses

import pytest

from arches_bench import cells, harness, judge

PROGRAM = harness.load_program("arches_campaign")

WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]


def _small(workload: str) -> cells.Cell:
    cell = cells.load_cell(workload)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, n_ues=16))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_program_passes(workload, card):
    cell, lim = _small(workload), harness.limits(workload)
    seed, params_seed = 2**31 + 5, 77
    want = PROGRAM.reference(cell, seed, params_seed, card)
    control = PROGRAM.reference(cell, seed, params_seed, card, tf32=True)
    assert judge.verdict(PROGRAM.compare(control, want), lim)[0] is False
    prog = PROGRAM.Program(cell, params_seed, card)
    prog.fit_policy(seed)
    assert judge.verdict(PROGRAM.compare(prog.campaign(seed), want), lim)[0] is True
