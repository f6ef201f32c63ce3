"""Each fault a cell can have, planted under the timed path: the run's
``correct`` comes out false.  The look for a card is skipped (the tiny CPU
form of the cell); the rest of a run is driven as the command drives it.
A cell runs on one card, so there is no exchange between chips to leave out."""

import pytest

from arches_bench import cells, harness
from arches_bench.tests.conftest import tiny

WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]
PROGRAM = harness.load_program("arches_campaign")


def _state_unchanged(monkeypatch):
    """The slot returns its link state unchanged."""
    from repro_torch.phy import pipeline

    orig = pipeline.BatchedPuschPipeline._ue_post

    def post(self, link, pre, h_sel):
        return link, orig(self, link, pre, h_sel)[1]

    monkeypatch.setattr(pipeline.BatchedPuschPipeline, "_ue_post", post)


def _half_the_batch(monkeypatch):
    """Each per-UE mean over the REs left out half of them, the mean
    taken over the rest."""
    from repro_torch.phy import pipeline

    orig = pipeline.ue_mean

    def half(x, dim, keepdim=False):
        if dim == -1:
            x = x[..., : max(x.shape[-1] // 2, 1)]
        return orig(x, dim, keepdim)

    monkeypatch.setattr(pipeline, "ue_mean", half)


def _answer_altered(monkeypatch):
    """One TB outcome (UE 0, slot 2 of each campaign) flipped where it is
    produced."""
    from repro_torch.phy import pipeline

    orig = pipeline.tb_success_dynamic
    calls = {"n": 0}

    def flipped(*args, **kwargs):
        ok = orig(*args, **kwargs)
        calls["n"] += 1
        if calls["n"] == 3:
            ok = ok.clone()
            ok[0] = ~ok[0]
        return ok

    monkeypatch.setattr(pipeline, "tb_success_dynamic", flipped)
    return calls


class Broken(PROGRAM.Program):
    plant = None
    monkeypatch = None

    def campaign(self, seed):
        with self.monkeypatch.context() as m:
            type(self).plant(m)
            return super().campaign(seed)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
    Broken.plant, Broken.monkeypatch = staticmethod(fault), monkeypatch
    monkeypatch.setattr(PROGRAM, "Program", Broken)  # the module the run loads
    res = harness.run(tiny(workload), 2**31 + 7, 0.0, False, bench=cells.benchmark(),
                      check_limits=harness.limits(workload), device="cpu",
                      log=lambda m: None)
    assert res["correct"] is False, res["checks"]
