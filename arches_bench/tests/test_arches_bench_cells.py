"""``BENCHMARK.json`` against the contract's shape, and every cell, traffic
mix, configuration and metric found by its name."""

import json
import re

import pytest

from arches_bench import cells, harness

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names_units_and_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert (cells.BENCH / "metrics" / f"{m['name']}.py").exists()
    assert callable(harness.load_reader(m["name"]))
    for w in m.get("workloads", []):
        assert w in WORKLOADS
    if "moves" in m:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_assembles_into_the_spec_the_session_receives(workload):
    cell = cells.load_cell(workload)
    assert NAME.match(workload) and cell.workload["chips"] == 1
    spec = cells.campaign_spec(cell, seed=123, params_seed=456)
    assert (spec.path, spec.n_prb, spec.n_ues, spec.n_slots, spec.seed) == (
        "closed_loop", 106, cell.traffic["n_ues"], cell.traffic["n_slots"], 123)
    assert spec.scenario == cell.traffic["scenario"]
    assert dict(spec.scenario_args) == cell.traffic["scenario_args"]
    assert spec.bank.params_seed == 456
    assert spec.bank.execution_mode == cell.config["bank"]["execution_mode"]
    assert spec.bank.gated_capacity == cell.config["bank"]["gated_capacity"]
    (policy,) = spec.policies
    assert policy.train_scenario == "good_poor_good"
    assert dict(policy.train_scenario_args) == {"poor_start": 13, "poor_end": 27}
    assert spec.switch.window_slots == cell.config["switch"]["window_slots"]
    assert (cells.BENCH / "limits" / f"{workload}.json").exists()


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_what_runs(c):
    config = json.loads((cells.ROOT / c["file"]).read_text())
    assert config["reduced"] == c["reduced"] == []
    assert c["source"] == config["source"]


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        cells.load_cell("no-such-cell")


def test_derived_seeds_are_31_bit_and_take_large_seeds():
    s = cells.derive_seed(2**31 + 12345, "campaign0")
    assert 0 <= s < 2**31
    assert s == cells.derive_seed(2**31 + 12345, "campaign0")
    assert s != cells.derive_seed(2**31 + 12345, "campaign1")
