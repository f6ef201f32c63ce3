"""The quickstart's other demos on the port, on the CPU (``--device cpu``) at
their smallest size: GATED execution with the fused kernel's path and bf16
operands, the multi-cell topology and the campaign service over HTTP.  Each
demo checks its own contracts and exits non-zero when one fails."""

import runpy
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

QUICKSTART = Path(__file__).resolve().parents[1] / "examples_torch" / "quickstart.py"


def _quickstart(monkeypatch, capsys, *args: str) -> str:
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "--device", "cpu", "--n-ues", "2", *args])
    runpy.run_path(str(QUICKSTART), run_name="__main__")
    return capsys.readouterr().out


def test_quickstart_gated(monkeypatch, capsys):
    out = _quickstart(monkeypatch, capsys, "--gated")
    assert "fused GATED == CONCURRENT" in out and "audit tripped" in out
    # the closed loop's replay, fused == CONCURRENT, and on the CPU unfused too
    assert out.count("yes (bitwise)") == 3


def test_quickstart_multi_cell_and_service(monkeypatch, capsys):
    out = _quickstart(monkeypatch, capsys, "--multi-cell", "--service")
    assert out.count("AI share") >= 4 and "POST /drain -> graceful exit" in out
    assert out.count("yes (bitwise)") == 3
