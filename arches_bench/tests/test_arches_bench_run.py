"""The harness's control flow on a tiny CPU form of each cell: the result
line's schema, the check against the reference, the refusals (no card, no
program), and the program a configuration names."""

import itertools
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from arches_bench import cells, harness
from arches_bench.tests.conftest import tiny

BENCH = cells.benchmark()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_result_line_schema_on_the_cpu(workload):
    cell = tiny(workload)
    res = harness.run(cell, 2**31 + 99, 0.5, False, bench=BENCH,
                      check_limits=harness.limits(workload), device="cpu", log=lambda m: None)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # the card's energy is not measured on the CPU, so that metric is left out
    assert set(res["metrics"]) == {"slot_ues_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["checks"]) == set(harness.limits(workload))
    json.dumps(res)


def test_main_refuses_without_a_card(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("this host has a card")
    rc = harness.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_command_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, the command exits non-zero and prints no result."""
    (tmp_path / "BENCHMARK.json").write_text((cells.ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(cells.BENCH), str(tmp_path / "arches_bench")], check=True)
    res = subprocess.run([sys.executable, "-m", "arches_bench.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.phy", object())
    assert "repro" in harness.forbidden_modules()


def test_a_configuration_without_a_program_runs_the_arches_campaign():
    cell = cells.load_cell(BENCH["workloads"][0]["name"])
    assert "program" not in cell.config and cell.program == "arches_campaign"
    program = harness.load_program(cell.program)
    assert Path(program.__file__) == cells.BENCH / "programs" / "arches_campaign.py"
    assert harness.Run(cell=cell).program is program
    assert program.units(cell) == cell.n_slots * cell.n_ues


#: a program of its own: a decode of ``steps`` tokens for ``sequences``
#: sequences, drawn from the seed, that its reference draws alike
STANDIN = '''
import numpy as np

HOME = {}


def units(cell):
    return cell.traffic["steps"] * cell.traffic["sequences"]


def _tokens(cell, seed, params_seed):
    rng = np.random.default_rng([seed, params_seed])
    return rng.integers(0, 163_840, (cell.traffic["steps"], cell.traffic["sequences"]))


class Program:
    def __init__(self, cell, params_seed, device):
        self.cell, self.params_seed = cell, params_seed

    def load_kernels(self):
        pass

    def fit_policy(self, seed):
        pass

    def campaign(self, seed):
        return {"tokens": _tokens(self.cell, seed, self.params_seed)}


def reference(cell, seed, params_seed, device):
    return {"tokens": _tokens(cell, seed, params_seed)}


def compare(got, want):
    return {"tokens_differ": float((got["tokens"] != want["tokens"]).sum())}
'''


def test_a_configuration_names_its_program(tmp_path, monkeypatch):
    """A configuration with ``"program": "standin"`` runs
    ``programs/standin.py`` through the harness, and the window's rate
    counts that program's ``units`` a campaign."""
    (tmp_path / "standin.py").write_text(STANDIN)
    monkeypatch.setattr(harness, "PROGRAMS", tmp_path)
    clock = itertools.count()  # each reading of the harness's clock 1 s later
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(clock)), time=time.time))
    cell = cells.Cell(workload={"name": "standin.short", "config": "standin",
                                "traffic": "short", "chips": 1},
                      config={"program": "standin"},
                      traffic={"n_slots": 4, "n_ues": 2, "steps": 4, "sequences": 3})
    res = harness.run(cell, 2**31 + 3, 2.5, False, bench=BENCH,
                      check_limits={"tokens_differ": {"limit": 0}}, device="cpu",
                      log=lambda m: None)
    assert res["correct"] is True and res["checks"] == {"tokens_differ": {"value": 0.0,
                                                                          "limit": 0.0}}
    # campaigns end 1, 2 and 3 s into the window, which closes at 4 s
    assert res["attempted"] == 3
    assert res["metrics"]["slot_ues_per_s"]["value"] == 3 * 12 / 4.0
