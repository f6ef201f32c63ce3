"""The harness's control flow on a tiny CPU form of each cell: the result
line's schema, the check against the reference, and the refusals (no card,
no program)."""

import json
import subprocess
import sys

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
