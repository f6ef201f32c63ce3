"""The port's spans on the card: closed-loop campaigns traced by the
benchmark's profiler, with the program's spans on and off.

Marked ``cuda``: it skips where there is no NVIDIA GPU.  This file imports
no JAX: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_tracing.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing

ROOT = Path(__file__).resolve().parents[1]

#: one traced campaign in a fresh process, its spans forced on or off
#: (``sys.argv[1]``): the operations a process's campaigns launch drift by a
#: few with the campaigns before them, so each side starts from the same state
CAMPAIGN = """
import hashlib, json, sys
import numpy as np, torch
from arches_bench.trace import profile_campaign
from repro_torch import tracing
from repro_torch.core.session import ArchesSession, CampaignSpec, ExpertBankSpec, PolicySpec

spec = CampaignSpec(path="closed_loop", scenario="good_poor_good", n_ues=8, n_slots=9,
                    scenario_args=(("poor_start", 3), ("poor_end", 6)),
                    policies=(PolicySpec(kind="tree"),),
                    bank=ExpertBankSpec(execution_mode="gated", fused=True, gated_capacity=4))
policies = ArchesSession(spec, device="cuda").host_policies
campaign = lambda: ArchesSession(spec, device="cuda", host_policies=policies).run()
campaign()
with tracing.recording(sys.argv[1] == "on"):
    hist, trace = profile_campaign(campaign, torch.cuda.synchronize)
bits = hashlib.sha256()
for name in ("modes", "decisions"):
    bits.update(np.ascontiguousarray(getattr(hist, name)).tobytes())
for group in (hist.kpms, hist.outputs):
    for k in sorted(group):
        bits.update(np.ascontiguousarray(group[k]).tobytes())
print(json.dumps({"ops": len(trace.ops), "spans": len(tracing.take().spans),
                  "bits": bits.hexdigest()}))
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans' device intervals are CUDA events")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["arches-106-concurrent.gpg-256ue",
                                      "arches-106-gated-fused.poor-256ue"])
def test_cuda_spans_cover_the_traced_campaign(cuda, workload):
    """A benchmark cell's campaign under the profiler: the spans below the
    campaign hold its device operations, each kernel that runs in one span
    alone (``spans.HOME``) sits inside it, and the spans change no bit of
    the trajectory."""
    from arches_bench import cells, spans
    from arches_bench.trace import profile_campaign
    from repro_torch.core.session import ArchesSession

    cell = cells.load_cell(workload)
    spec = cells.campaign_spec(cell, 3_400_000_011, params_seed=3_400_000_012)
    policies = ArchesSession(spec, device=cuda).host_policies

    def campaign():
        return ArchesSession(spec, device=cuda, host_policies=policies).run()

    campaign()  # every shape once
    tracing.take()
    with tracing.recording(False):
        off, _ = profile_campaign(campaign, torch.cuda.synchronize)
    assert tracing.take().spans == []
    on, on_trace = profile_campaign(campaign, torch.cuda.synchronize)
    taken = tracing.take()
    for name in ("modes", "decisions"):
        np.testing.assert_array_equal(getattr(off, name), getattr(on, name))
    for group in ("kpms", "outputs"):
        for k, v in getattr(off, group).items():
            np.testing.assert_array_equal(v, getattr(on, group)[k], err_msg=k)

    tl = spans.build(taken.spans, on_trace.ops, on_trace.wall_s)
    assert tl is not None
    assert min(tl.coverage) >= spans.COVERAGE and tl.fit_share >= spans.FIT_SHARE, \
        (tl.coverage, tl.fit_share, spans.device_by_span(tl))
    assert sum(n == "slot" for n in tl.names) == spec.n_slots
    assert tl.misplaced == 0, tl.misplaced
    owners = [tl.names[k] for k, (name, _, _) in zip(tl.op_span, on_trace.ops)
              if "policy_step" in name]
    assert owners == ["slot.decision"] * spec.n_slots, owners


@pytest.mark.cuda
def test_cuda_spans_launch_nothing(cuda):
    """Two fresh processes run the same traced campaign, one with the spans
    on: the same device operations, the same bits."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    runs = {}
    for side in ("off", "on"):
        out = subprocess.run([sys.executable, "-c", CAMPAIGN, side], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-4000:]
        runs[side] = json.loads(out.stdout.strip().splitlines()[-1])
    assert runs["off"]["spans"] == 0 and runs["on"]["spans"] > 0
    assert runs["on"]["ops"] == runs["off"]["ops"]
    assert runs["on"]["bits"] == runs["off"]["bits"]
