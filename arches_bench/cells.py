"""Cells by name: ``BENCHMARK.json`` names each workload's configuration and
traffic, and the files ``configs/<configuration>.json`` and
``traffic/<traffic>.json`` hold them.  A configuration's ``"program"`` key
names the program that runs it (``programs/<program>.py``), by default
``arches_campaign``, whose configurations hold the ``CampaignSpec`` fields
that are not traffic (the slot, the expert bank, the switch and the
policy) and whose traffic files hold the scenario and its arguments and
the campaign's UEs and slots.  Seeds: ``--seed`` gives the program's
``params_seed`` and one campaign seed per window campaign.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: the program of a configuration without a ``"program"`` key
DEFAULT_PROGRAM = "arches_campaign"


@dataclasses.dataclass(frozen=True)
class Cell:
    workload: dict
    config: dict
    traffic: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def program(self) -> str:
        return self.config.get("program", DEFAULT_PROGRAM)

    @property
    def n_ues(self) -> int:
        return int(self.traffic["n_ues"])

    @property
    def n_slots(self) -> int:
        return int(self.traffic["n_slots"])

    @property
    def n_ant(self) -> int:
        return int(self.config["slot"]["n_ant"])

    @property
    def n_dmrs_sym(self) -> int:
        return len(self.config["slot"]["dmrs_symbols"])

    @property
    def gated(self) -> bool:
        return self.config["bank"]["execution_mode"] == "gated"


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The workload ``workload`` of ``BENCHMARK.json`` with its two files."""
    entries = {w["name"]: w for w in benchmark(root)["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; one of {sorted(entries)}")
    w = entries[workload]
    config = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(workload=w, config=config, traffic=traffic)


def derive_seed(seed: int, what: str) -> int:
    """A 31-bit seed for ``what`` (``"params"``, ``"warmup"``, a campaign
    index), drawn from ``--seed`` by hashing: any whole number works."""
    digest = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def campaign_spec(cell: Cell, seed: int, params_seed: int) -> Any:
    """The program's ``CampaignSpec`` for one campaign of ``cell``."""
    from repro_torch.core.session import CampaignSpec, ExpertBankSpec, PolicySpec, SwitchSpec

    cfg, tr = cell.config, cell.traffic
    policy = dict(cfg["policy"])
    policy["train_scenario_args"] = tuple(policy["train_scenario_args"].items())
    return CampaignSpec(
        path="closed_loop", scenario=tr["scenario"],
        scenario_args=tuple(tr.get("scenario_args", {}).items()), n_prb=cfg["n_prb"],
        n_ues=cell.n_ues, n_slots=cell.n_slots, seed=seed,
        bank=ExpertBankSpec(params_seed=params_seed, **cfg["bank"]),
        policies=(PolicySpec(**policy),), switch=SwitchSpec(**cfg["switch"]),
    )
