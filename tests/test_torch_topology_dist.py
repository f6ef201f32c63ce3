"""The multi-cell topology across ranks, on the CPU (gloo).

Spawned groups of 2 and 4 ranks run the port's multi-cell campaigns and are
held against the port's one-shard run in this process: the per-cell loads
every slot and every trajectory leaf bitwise (the loads are exact {0, 1}
counts and each UE's stages run on its own), exactly one ``all_reduce`` a
slot on every rank and none with one shard; a 2-rank streaming run under
churn equals the one-shard streaming run, and so does a 2-rank run stopped
after its first segment and resumed from the checkpoint rank 0 wrote.  On 3
ranks the 8 UEs resolve to 2 shards: the third rank holds no UEs, joins no
per-slot collective and receives the same closed-loop and streaming
campaigns.  One 2-rank closed-loop fused GATED run whose
capacity overflows on each shard is held against ``repro``'s
``run_closed_loop_sharded`` on a forced 2-device CPU mesh in a subprocess
(``XLA_FLAGS`` must precede jax's start, as ``tests/test_faults.py`` runs
one): discrete leaves and ``gated_overflow`` equal, KPMs within 1e-4
relative.  The reference subprocess starts first and runs beside the spawned
ranks; each rank uses one CPU thread.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.core import session as tses
from repro_torch.core import topology as ttopo

torch.set_num_threads(1)

KPM_RTOL, KPM_ATOL = 1e-4, 1e-4
N_UES, N_CELLS, N_SLOTS = 8, 4, 6
CELLS = ("good", "poor", "good_poor_good", "bursty_interference")


def _spec(**kw):
    d = dict(path="closed_loop", scenario="multi_cell",
             scenario_args=(("n_cells", N_CELLS), ("per_cell_scenario", CELLS)),
             n_ues=N_UES, n_slots=N_SLOTS, n_prb=6, seed=4,
             topology=dict(n_cells=N_CELLS, coupling=0.3,
                           cell_noise_offsets_db=(0.0, 3.0, 0.0, -3.0)),
             policies=(dict(kind="threshold", feature="snr", threshold=10.0, hysteresis=1.0),),
             switch=dict(window_slots=2), bank=dict(channels=8, n_res_blocks=1))
    d.update(kw)
    return d


# the AI expert selected almost everywhere, one compact row a shard: overflow
OVERFLOW = _spec(policies=(dict(kind="threshold", feature="snr", threshold=30.0),),
                 bank=dict(channels=8, n_res_blocks=1, execution_mode="gated", fused=True,
                           gated_capacity=2))
CAMPAIGNS = {"closed": _spec(), "open": _spec(path="batched", policies=(), switch={},
                                              modes=((0, 1, 1, 0, 1, 0, 0, 1),))}
# 12 ids in 4 home cells over the 8-slot bank: each shard holds two cell blocks
STREAM = _spec(scenario="churn_cell", scenario_args=(),
               churn=dict(n_ue_ids=12, segment_slots=2, initial=(0, 3, 6, 9, 10),
                          events=((2, 1, "attach"), (2, 0, "detach"), (4, 9, "detach"),
                                  (4, 11, "attach"), (4, 2, "attach"))))


def _leaves(hist) -> dict:
    return {"modes": hist.modes, "decisions": hist.decisions, "kpms": hist.kpms,
            "outputs": hist.outputs, "cell_of_ue": hist.cell_of_ue}


def _run(d, loads=None):
    """One session run of spec dict ``d``; with ``loads`` (a list) the slot
    loop's per-cell loads, after the cross-shard sum, are appended to it."""
    if loads is not None:
        from repro_torch.phy import pipeline

        couple = pipeline.apply_cell_coupling

        def recording(p, cell_of_ue, cells, *, reduce=None):
            def rec(load):
                load = load if reduce is None else reduce(load)
                loads.append(load.clone().numpy())
                return load

            return couple(p, cell_of_ue, cells, reduce=rec)

        pipeline.apply_cell_coupling = recording
    try:
        ttopo.reset_collective_counts()
        hist = tses.ArchesSession(tses.CampaignSpec.from_dict(d), device="cpu").run()
        return _leaves(hist), dict(ttopo.collective_counts)
    finally:
        if loads is not None:
            pipeline.apply_cell_coupling = couple


def _resumed(ckpt_dir):
    """A streaming run stopped after its first segment, then resumed."""
    sess = tses.ArchesSession(tses.CampaignSpec.from_dict(STREAM), device="cpu")
    sess.run_streaming(checkpoint_dir=ckpt_dir, max_segments=1)
    return _leaves(sess.run_streaming(resume_from=ckpt_dir))


def _rank(rank, names, ckpt_dir=None):
    out = {}
    for name in names:
        if name == "stream_resumed":
            out[name] = {"leaves": _resumed(ckpt_dir)}
            continue
        d = {"closed": CAMPAIGNS["closed"], "open": CAMPAIGNS["open"], "stream": STREAM,
             "overflow": OVERFLOW}[name]
        loads = [] if name in CAMPAIGNS else None
        leaves, counts = _run(d, loads)
        out[name] = {"leaves": leaves, "counts": counts, "loads": loads}
    return out


def _same(a: dict, b: dict):
    np.testing.assert_array_equal(a["modes"], b["modes"])
    if a["decisions"] is not None or b["decisions"] is not None:
        np.testing.assert_array_equal(a["decisions"], b["decisions"])
    np.testing.assert_array_equal(a["cell_of_ue"], b["cell_of_ue"])
    for group in ("kpms", "outputs"):
        assert set(a[group]) == set(b[group])
        for k in a[group]:
            np.testing.assert_array_equal(a[group][k], b[group][k], err_msg=k)


_REFERENCE = """
import json, sys
import numpy as np
import jax
from repro.core import session as rses

sess = rses.ArchesSession(rses.CampaignSpec.from_dict(json.loads(sys.argv[1])))
assert len(jax.devices()) == 2 and sess.cell_topology.n_shards == 2
h = sess.run()
np.savez(sys.argv[2], modes=h.modes, decisions=h.decisions,
         **{"kpm_" + k: v for k, v in h.kpms.items()},
         **{"out_" + k: v for k, v in h.outputs.items()})
print("REFERENCE-2 OK")
"""


@pytest.fixture(scope="module")
def reference():
    """``repro``'s overflowing run on a forced 2-device mesh, started at once
    in a subprocess: (process, path of its npz)."""
    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                        + env.get("XLA_FLAGS", "")).strip()
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    path = os.path.join(tmp.name, "reference.npz")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, json.dumps(OVERFLOW), path],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()
    tmp.cleanup()


@pytest.fixture(scope="module")
def one_shard(reference):
    out = {}
    for name, d in CAMPAIGNS.items():
        loads = []
        leaves, counts = _run(d, loads)
        out[name] = {"leaves": leaves, "counts": counts, "loads": loads}
    out["stream"] = {"leaves": _run(STREAM)[0]}
    return out


@pytest.fixture(scope="module")
def two_ranks(reference):
    with tempfile.TemporaryDirectory() as d:
        return ttopo.spawn_ranks(
            _rank, 2, (("closed", "open", "stream", "stream_resumed", "overflow"), d),
            device="cpu")


@pytest.fixture(scope="module")
def four_ranks(reference):
    return ttopo.spawn_ranks(_rank, 4, (("closed",),), device="cpu")


@pytest.fixture(scope="module")
def three_ranks(reference):
    # 8 UEs resolve to 2 shards on 3 ranks: rank 2 holds no UEs
    return ttopo.spawn_ranks(_rank, 3, (("closed", "stream"),), device="cpu")


def test_one_shard_issues_no_collective(one_shard):
    for name in CAMPAIGNS:
        assert one_shard[name]["counts"] == {"all_reduce": 0, "all_gather": 0}
        assert len(one_shard[name]["loads"]) == N_SLOTS


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_ranks_equal_one_shard(one_shard, two_ranks, four_ranks, n_ranks):
    ranks = {2: two_ranks, 4: four_ranks}[n_ranks]
    names = ("closed", "open") if n_ranks == 2 else ("closed",)
    for rank, out in enumerate(ranks):
        for name in names:
            got, want = out[name], one_shard[name]
            # one all_reduce of the cell loads a slot, one gather after the loop
            assert got["counts"] == {"all_reduce": N_SLOTS, "all_gather": 1}, (rank, name)
            np.testing.assert_array_equal(np.stack(got["loads"]), np.stack(want["loads"]))
            _same(got["leaves"], want["leaves"])


def test_rank_past_the_shards_only_receives(one_shard, three_ranks):
    for rank, out in enumerate(three_ranks):
        member = rank < 2
        reduces = N_SLOTS if member else 0  # the extra rank joins no per-slot collective
        got = out["closed"]
        assert got["counts"] == {"all_reduce": reduces, "all_gather": 1}, rank
        if member:
            np.testing.assert_array_equal(np.stack(got["loads"]),
                                          np.stack(one_shard["closed"]["loads"]))
        else:
            assert got["loads"] == []
        _same(got["leaves"], one_shard["closed"]["leaves"])
        assert out["stream"]["counts"] == {"all_reduce": reduces, "all_gather": 3}, rank
        _same(out["stream"]["leaves"], one_shard["stream"]["leaves"])


def test_loads_are_not_vacuous(one_shard):
    loads = np.stack(one_shard["closed"]["loads"])
    assert loads.shape == (N_SLOTS, N_CELLS) and loads.sum() > 0
    assert (loads[:, 0] == 0).all() and (loads[:, 1] == N_UES // N_CELLS).all()


def test_streaming_on_two_ranks_equals_one_shard(one_shard, two_ranks):
    want = one_shard["stream"]["leaves"]
    assert (want["modes"] == -1).any()  # churn: some ids detached some slots
    for out in two_ranks:
        # one gather a segment
        assert out["stream"]["counts"] == {"all_reduce": N_SLOTS, "all_gather": 3}
        _same(out["stream"]["leaves"], want)
        _same(out["stream_resumed"]["leaves"], want)


def test_overflowing_gated_ranks_match_reference_mesh(reference, two_ranks):
    proc, path = reference
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REFERENCE-2 OK" in stdout, stderr[-4000:]
    want = np.load(path)
    for out in two_ranks:
        got = out["overflow"]["leaves"]
        assert out["overflow"]["counts"]["all_reduce"] == N_SLOTS
        np.testing.assert_array_equal(got["modes"], want["modes"])
        np.testing.assert_array_equal(got["decisions"], want["decisions"])
        for k in ("mcs", "tb_ok", "tbs", "gated_overflow", "executed_flops"):
            np.testing.assert_array_equal(got["outputs"][k], want["out_" + k], err_msg=k)
        for k, v in got["kpms"].items():
            np.testing.assert_allclose(v, want["kpm_" + k], rtol=KPM_RTOL, atol=KPM_ATOL,
                                       err_msg=k)
        # each shard overflows on its own: more AI demand than its one row
        assert got["outputs"]["gated_overflow"][:, :N_UES // 2].sum() > 0
        assert got["outputs"]["gated_overflow"][:, N_UES // 2:].sum() > 0
