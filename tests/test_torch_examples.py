"""The port's examples (``examples_torch/``) run at their smallest size on the
CPU (``--device cpu``), in this process: the methodology walkthrough, the
switched-serving demo, the LM trainer, and the quickstart's closed loop with
its host, streaming, fault and heterogeneity demos (the rest of its demos:
``test_torch_examples_demos.py``).  Each script checks its own contracts
(device == host replay, killed-and-resumed == uninterrupted, ...) and exits
non-zero when one fails."""

import runpy
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"


def run_example(monkeypatch, capsys, script: str, *args: str) -> str:
    """Run ``examples_torch/<script>`` as ``__main__`` with ``args``; its stdout."""
    monkeypatch.setattr(sys, "argv", [script, *args])
    runpy.run_path(str(EXAMPLES / script), run_name="__main__")
    return capsys.readouterr().out


def test_methodology_walkthrough(monkeypatch, capsys):
    out = run_example(monkeypatch, capsys, "methodology_walkthrough.py", "--device", "cpu")
    assert "stage 2: monotonicity filter" in out
    selected = out.split("selected policy inputs:")[1].split(", ")
    assert len(selected) >= 2


def test_serve_switched(monkeypatch, capsys):
    out = run_example(monkeypatch, capsys, "serve_switched.py", "--device", "cpu")
    assert out.count("experts=") == 4
    assert "completed segment 3/3" in out and "graceful exit" in out


def test_train_lm_with_a_failure(monkeypatch, capsys, tmp_path):
    out = run_example(monkeypatch, capsys, "train_lm.py", "--device", "cpu", "--steps", "6",
                      "--batch", "2", "--seq", "8", "--inject-failure", "3",
                      "--ckpt-dir", str(tmp_path))
    assert "injected node failure at step 3" in out
    assert "done: 6 steps" in out and "restarts 1" in out


def test_train_lm_whisper_fails_as_the_reference(monkeypatch, capsys, tmp_path):
    """``--arch whisper-large-v3`` fails in both examples with one error type:
    the token stream yields no encoder frames, and the encoder-decoder
    forward asserts them."""
    ref = Path(__file__).resolve().parents[1] / "examples" / "train_lm.py"
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--arch", "whisper-large-v3", "--steps", "1",
                                      "--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(Exception) as ref_err:
        runpy.run_path(str(ref), run_name="__main__")
    assert type(ref_err.value) is AssertionError
    with pytest.raises(AssertionError, match="encoder_frames"):
        run_example(monkeypatch, capsys, "train_lm.py", "--device", "cpu", "--arch",
                    "whisper-large-v3", "--steps", "1", "--ckpt-dir", str(tmp_path / "port"))


@pytest.mark.parametrize("switched", [False, True], ids=["generate", "switched"])
def test_serve_launcher_whisper(capsys, switched):
    """``python -m repro_torch.launch.serve --arch whisper-large-v3`` on the
    reduced config with the launcher's zero frames, plain and ARCHES-switched."""
    from repro_torch.launch import serve

    serve.main(["--arch", "whisper-large-v3", "--device", "cpu", "--steps", "4", "--batch", "2",
                "--prompt-len", "8", "--max-seq", "32"] + (["--switched"] if switched else []))
    out = capsys.readouterr().out
    assert "whisper-large-v3-smoke" in out and "on cpu" in out
    assert ("switched decode:" in out) == switched and ("tokens in" in out) != switched


@pytest.mark.parametrize("switched", [False, True], ids=["generate", "switched"])
def test_serve_launcher_moe(capsys, switched):
    """``python -m repro_torch.launch.serve --arch dbrx-132b`` on the reduced
    config, plain and ARCHES-switched."""
    from repro_torch.launch import serve

    serve.main(["--arch", "dbrx-132b", "--device", "cpu", "--steps", "4", "--batch", "2",
                "--prompt-len", "8", "--max-seq", "32"] + (["--switched"] if switched else []))
    out = capsys.readouterr().out
    assert "dbrx-132b-smoke" in out and "on cpu" in out
    assert ("switched decode:" in out) == switched and ("tokens in" in out) != switched


def test_quickstart_closed_loop_host_streaming_faults(monkeypatch, capsys):
    out = run_example(monkeypatch, capsys, "quickstart.py", "--device", "cpu", "--n-ues", "2",
                      "--host", "--streaming", "--faults")
    assert out.count("yes (bitwise)") == 4
    for heading in ("== closed loop", "== host loop", "== streaming churn",
                    "== fault injection"):
        assert heading in out


def test_quickstart_heterogeneous(monkeypatch, capsys):
    out = run_example(monkeypatch, capsys, "quickstart.py", "--device", "cpu", "--n-ues", "2",
                      "--heterogeneous")
    assert "== per-UE heterogeneity" in out and out.count("yes (bitwise)") == 2
