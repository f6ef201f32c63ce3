"""The multi-cell topology through both packages, on one shard.

``TopologySpec`` (validation, JSON, ``spec_hash``), ``per_shard_capacity``,
the cell layout and ``apply_cell_coupling`` unit by unit against ``repro``'s
(the coupling bitwise); the ``multi_cell`` scenario's schedules equal to
``repro``'s; the port's one-shard multi-cell campaigns (open-loop GATED
unfused, closed-loop CONCURRENT and fused GATED, the perturbed sweep) against
``repro``'s sharded entries on its one-device mesh through the session
(discrete leaves equal, KPMs within 1e-4 relative, as in
``test_torch_campaign``); the per-cell reductions equal to ``repro``'s on
the same history.  Streaming under a topology fails in ``repro`` on this
jax (``ROADMAP.md``, Queue 3), so the port's is held to its own contracts,
bitwise: zero churn == the monolithic topology run, pipelined == serial,
the unsharded program == the one-shard one.  Shapes are the reference's
topology tests' (n_prb 6, 8 channels, one residual block, 8 UEs in 4 cells,
a few slots).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import runtime as rrt
from repro.core import session as rses
from repro.core import topology as rtopo
from repro.phy import channel as rch
from repro.phy import scenario as rscen
from repro_torch.core import runtime as trt
from repro_torch.core import session as tses
from repro_torch.core import topology as ttopo
from repro_torch.phy import channel as tch
from repro_torch.phy import scenario as tscen

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

KPM_RTOL, KPM_ATOL = 1e-4, 1e-4
N_UES, N_CELLS, N_SLOTS, N_PRB = 8, 4, 6, 6
CELLS = ("good", "poor", "good_poor_good", "bursty_interference")
TOPO = dict(n_cells=N_CELLS, coupling=0.3, cell_noise_offsets_db=(0.0, 3.0, 0.0, -3.0),
            cell_inr_offsets_db=(1.0, 0.0, -1.0, 2.0))
BANK = dict(channels=8, n_res_blocks=1)
THRESHOLD = (dict(kind="threshold", feature="snr", threshold=10.0, hysteresis=1.0),)


def _spec(**kw):
    d = dict(path="closed_loop", scenario="multi_cell",
             scenario_args=(("n_cells", N_CELLS), ("per_cell_scenario", CELLS)),
             n_ues=N_UES, n_slots=N_SLOTS, n_prb=N_PRB, seed=4, topology=TOPO,
             policies=THRESHOLD, switch=dict(window_slots=2), bank=BANK)
    d.update(kw)
    return d


def _modes():
    return tuple(tuple((s + u) % 3 == 0 for u in range(N_UES)) for s in range(N_SLOTS))


CAMPAIGNS = {
    "open_gated_unfused": _spec(path="gated", policies=(), switch={},
                                modes=tuple(tuple(int(not m) for m in row) for row in _modes()),
                                bank=dict(BANK, gated_capacity=2)),
    "closed_concurrent": _spec(),
    "closed_gated_fused": _spec(bank=dict(BANK, execution_mode="gated", fused=True,
                                          gated_capacity=4)),
    "perturbed": _spec(path="perturbed", policies=(), switch={},
                       rho=tuple(0.25 * u for u in range(N_UES))),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, d in CAMPAIGNS.items():
        rspec, tspec = rses.CampaignSpec.from_dict(d), tses.CampaignSpec.from_dict(d)
        tsess = tses.ArchesSession(tspec, device="cpu")
        out[name] = (rspec, rses.ArchesSession(rspec).run(), tspec, tsess, tsess.run())
    return out


# -- the declarative layer -----------------------------------------------------------


BAD_TOPOLOGIES = [
    dict(n_cells=0),
    dict(n_cells=2, n_shards=0),
    dict(n_cells=2, cell_noise_offsets_db=(1.0,)),
    dict(n_cells=3, cell_inr_offsets_db=(1.0, 2.0)),
]


@pytest.mark.parametrize("bad", BAD_TOPOLOGIES)
def test_topology_spec_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as ref_err:
        rtopo.TopologySpec(**bad)
    with pytest.raises(ValueError) as port_err:
        ttopo.TopologySpec(**bad)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_spec_json_round_trip_and_hash(name):
    d = CAMPAIGNS[name]
    rspec, tspec = rses.CampaignSpec.from_dict(d), tses.CampaignSpec.from_dict(d)
    assert isinstance(tspec.topology, ttopo.TopologySpec)
    assert tses.CampaignSpec.from_json(tspec.to_json()) == tspec
    assert tspec.to_json() == rspec.to_json()
    assert tses.spec_hash(tspec) == rses.spec_hash(rspec)


def test_spec_validation_follows_the_reference():
    for bad in (dict(path="host", n_ues=1, topology=dict(n_cells=1), policies=THRESHOLD,
                     scenario="good", scenario_args=()),
                dict(n_ues=6, topology=dict(n_cells=4))):
        with pytest.raises(ValueError) as ref_err:
            rses.CampaignSpec.from_dict(_spec(**bad))
        with pytest.raises(ValueError, match=str(ref_err.value)[:20]):
            tses.CampaignSpec.from_dict(_spec(**bad))
    # the scenario's cell count must be the topology's
    spec = tses.CampaignSpec.from_dict(_spec(scenario_args=(("n_cells", 2),)))
    with pytest.raises(ValueError, match="one cell count per campaign"):
        tses.ArchesSession(spec, device="cpu")


@pytest.mark.parametrize("capacity,n_shards", [(8, 1), (8, 2), (8, 4), (6, 4), (2, 4)])
def test_per_shard_capacity_matches_reference(capacity, n_shards):
    try:
        want = rtopo.per_shard_capacity(capacity, n_shards)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:30]):
            ttopo.per_shard_capacity(capacity, n_shards)
        return
    assert ttopo.per_shard_capacity(capacity, n_shards) == want


@pytest.mark.parametrize("n_cells,n_ues", [(1, 4), (2, 8), (4, 8), (4, 32)])
def test_cell_layout_and_params_match_reference(n_cells, n_ues):
    spec = dict(n_cells=n_cells, coupling=0.25,
                cell_noise_offsets_db=tuple(np.linspace(-3, 3, n_cells)))
    want = rtopo.CellTopology.build(rtopo.TopologySpec(**spec), n_ues)
    got = ttopo.CellTopology.build(ttopo.TopologySpec(**spec), n_ues)
    assert got.n_shards == want.n_shards == 1 and got.ues_per_shard == n_ues
    np.testing.assert_array_equal(got.cell_of_ue, want.cell_of_ue)
    for a, b in zip(got.cell_params, want.cell_params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.block() == (0, n_ues) and got.slot_cells("cpu").reduce is None


def test_shard_count_without_a_group():
    assert ttopo.make_ue_shards() == 1 and ttopo.make_ue_shards(4, n_ues=8) == 1
    with pytest.raises(ValueError, match="does not divide"):
        ttopo.CellTopology.build(ttopo.TopologySpec(n_cells=2, n_shards=3), 8)


@pytest.mark.parametrize("n_cells,n_ues,seed", [(1, 4, 0), (2, 8, 1), (3, 12, 2), (4, 8, 3),
                                                (4, 32, 4), (5, 20, 5)])
def test_apply_cell_coupling_bitwise(n_cells, n_ues, seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        leaves = dict(
            noise_var=rng.uniform(1e-3, 1.0, n_ues).astype(np.float32),
            interf_on=(rng.random(n_ues) < 0.5).astype(np.float32),
            inr_lin=rng.uniform(1.0, 30.0, n_ues).astype(np.float32),
            sc_mask=np.zeros((n_ues, 12), np.float32), duty_full=np.zeros(n_ues, np.float32),
            base_sym_mask=np.zeros((n_ues, 14), np.float32), p_rest=np.zeros(n_ues, np.float32))
        cell = (np.arange(n_ues) // (n_ues // n_cells)).astype(np.int32)
        kw = dict(noise_offsets_db=tuple(rng.uniform(-3, 3, n_cells)),
                  inr_offsets_db=tuple(rng.uniform(-3, 3, n_cells)),
                  coupling=float(rng.uniform(0, 1)))
        want = rch.apply_cell_coupling(rch.ChannelParams(**leaves), cell,
                                       rch.cell_params(n_cells, n_ues // n_cells, **kw))
        got = tch.apply_cell_coupling(
            tch.ChannelParams(**{k: torch.as_tensor(v) for k, v in leaves.items()}),
            torch.as_tensor(cell), tch.cell_params(n_cells, n_ues // n_cells, **kw))
        for name, a, b in zip(tch.ChannelParams._fields, got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("kw", [dict(), dict(n_cells=4, per_cell_scenario=CELLS),
                                dict(n_cells=3, per_cell_scenario=("poor",)),
                                dict(n_cells=1, per_cell_scenario=("snr_ramp",))])
def test_multi_cell_schedules_match_reference(kw):
    n_ues = 12
    want = rscen.get_scenario("multi_cell").schedule(n_ues=n_ues, **kw)
    got = tscen.get_scenario("multi_cell").schedule(n_ues=n_ues, **kw)
    assert len(got) == len(want) == n_ues
    for g, w in zip(got, want):
        for slot in (0, 5, 13, 40, 150):
            assert dataclasses.asdict(g(slot)) == dataclasses.asdict(w(slot))


@pytest.mark.parametrize("kw", [dict(n_cells=5), dict(n_cells=2, per_cell_scenario=()),
                                dict(n_cells=2, per_cell_scenario=("mixed_cell",)),
                                dict(n_cells=2, per_cell_scenario=("nope",))])
def test_multi_cell_rejects_what_the_reference_rejects(kw):
    with pytest.raises((ValueError, KeyError)) as ref_err:
        rscen.get_scenario("multi_cell").schedule(n_ues=8, **kw)
    with pytest.raises(type(ref_err.value)):
        tscen.get_scenario("multi_cell").schedule(n_ues=8, **kw)


# -- campaigns ---------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_topology_campaign_matches_reference(runs, name):
    rspec, rhist, tspec, tsess, thist = runs[name]
    assert tsess.cell_topology.n_shards == 1
    assert thist.modes.shape == rhist.modes.shape == (N_SLOTS, N_UES)
    np.testing.assert_array_equal(thist.modes, rhist.modes)
    np.testing.assert_array_equal(thist.cell_of_ue, rhist.cell_of_ue)
    assert set(thist.outputs) == set(rhist.outputs)
    for k in ("mcs", "tb_ok", "tbs", "gated_overflow", "executed_flops"):
        np.testing.assert_array_equal(thist.outputs[k], rhist.outputs[k], err_msg=k)
    if rhist.decisions is not None:
        np.testing.assert_array_equal(thist.decisions, rhist.decisions)
        np.testing.assert_array_equal(thist.n_switches, rhist.n_switches)
    for k, want in rhist.kpms.items():
        np.testing.assert_allclose(thist.kpms[k], want, rtol=KPM_RTOL, atol=KPM_ATOL, err_msg=k)


def test_topology_campaigns_are_not_vacuous(runs):
    """The cells differ (offsets and scenarios reach the KPMs), the closed
    loops switch, the GATED banks serve the AI expert and overflow."""
    closed = runs["closed_concurrent"][4]
    assert len(set(np.round(closed.per_cell_kpm("snr").mean(axis=0), 4))) == N_CELLS
    assert int(closed.n_switches.sum()) > 0 and 0 < closed.ai_share < 1
    assert runs["closed_gated_fused"][4].ai_share > 0
    assert runs["open_gated_unfused"][4].overflow_slot_ues > 0
    # coupling: the same campaign without it is another campaign
    d = dict(CAMPAIGNS["closed_concurrent"], topology=dict(TOPO, coupling=0.0))
    other = tses.ArchesSession(tses.CampaignSpec.from_dict(d), device="cpu").run()
    assert not np.array_equal(other.kpms["snr"], closed.kpms["snr"])


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_per_cell_reductions_match_reference(runs, name):
    _, rhist, _, _, thist = runs[name]
    # the reference's reductions over the port's history
    mirror = rrt.BatchedRunHistory(modes=thist.modes, kpms=thist.kpms, outputs=thist.outputs,
                                   cell_of_ue=thist.cell_of_ue)
    assert thist.n_cells == mirror.n_cells == N_CELLS
    np.testing.assert_array_equal(thist.per_cell_ai_share, mirror.per_cell_ai_share)
    np.testing.assert_array_equal(thist.per_cell_throughput, mirror.per_cell_throughput)
    for k in ("snr", "rsrp", "mcs_index"):
        np.testing.assert_array_equal(thist.per_cell_kpm(k), mirror.per_cell_kpm(k))
    np.testing.assert_allclose(thist.per_cell_throughput, rhist.per_cell_throughput,
                               rtol=KPM_RTOL)


def test_per_cell_reductions_need_a_layout():
    hist = trt.BatchedRunHistory(modes=np.zeros((2, 2), np.int32), kpms={}, outputs={})
    with pytest.raises(ValueError, match="TopologySpec"):
        hist.per_cell_ai_share


def test_unsharded_program_equals_one_shard(runs):
    """``sharded=False`` runs the same cell-coupled program over the whole
    axis: bitwise the one-shard run."""
    _, _, tspec, tsess, thist = runs["closed_concurrent"]
    sw_cfg = tspec.switch.to_config(tspec.feature_names)
    from repro_torch import random as jr

    _, _, traj = ttopo.run_closed_loop_sharded(
        tsess.engine, tsess.cell_topology, tsess.schedule, tsess.device_policy, sw_cfg,
        n_slots=N_SLOTS, key=jr.PRNGKey(tspec.seed), sharded=False)
    unsharded = trt.BatchedRunHistory.from_closed_loop(traj)
    np.testing.assert_array_equal(unsharded.modes, thist.modes)
    for k in thist.kpms:
        np.testing.assert_array_equal(unsharded.kpms[k], thist.kpms[k], err_msg=k)


# -- streaming under a topology ------------------------------------------------------


def _hist_equal(a, b, *, streaming_leaves=True):
    np.testing.assert_array_equal(a.modes, b.modes)
    assert set(a.kpms) == set(b.kpms) and set(a.outputs) == set(b.outputs)
    for k in a.kpms:
        np.testing.assert_array_equal(a.kpms[k], b.kpms[k], err_msg=k)
    for k in a.outputs:
        np.testing.assert_array_equal(a.outputs[k], b.outputs[k], err_msg=k)
    names = ("decisions", "n_switches", "cell_of_ue")
    if streaming_leaves:
        names += ("attached", "bank_slot")
    for k in names:
        if getattr(a, k) is not None or getattr(b, k) is not None:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.mark.parametrize("name", ["closed_concurrent", "closed_gated_fused"])
def test_zero_churn_streaming_equals_monolithic_topology_run(runs, name):
    _, _, tspec, _, thist = runs[name]
    zero = tses.ArchesSession(tses.as_streaming_spec(tspec, max_segment_slots=3),
                              device="cpu").run()
    assert zero.attached.all()
    _hist_equal(zero, thist, streaming_leaves=False)


# 12 ids in 4 home cells over an 8-slot bank (2 a cell): re-packs stay in a cell block
CHURN = dict(n_ue_ids=12, segment_slots=2, initial=(0, 3, 6, 9, 10),
             events=((2, 1, "attach"), (2, 0, "detach"), (3, 7, "attach"), (4, 9, "detach"),
                     (4, 11, "attach"), (4, 2, "attach")))


def test_streaming_under_topology_pipelined_equals_serial():
    spec = tses.CampaignSpec.from_dict(_spec(scenario="churn_cell", scenario_args=(),
                                             churn=CHURN))
    sess = tses.ArchesSession(spec, device="cpu")
    serial = sess.run_streaming(pipeline=False)
    piped = sess.run_streaming()
    _hist_equal(piped, serial)
    home = np.arange(12) // 3
    np.testing.assert_array_equal(serial.cell_of_ue, home)
    # every resident id sits in its home cell's block of bank slots
    att = serial.attached
    np.testing.assert_array_equal(serial.bank_slot[att] // 2, np.broadcast_to(home, att.shape)[att])
    assert int(serial.n_switches.sum()) > 0
    assert serial.per_cell_ai_share.shape == (N_CELLS,)
    replay = sess.host_replay(serial)
    np.testing.assert_array_equal(serial.modes, replay["active_mode"])


def test_streaming_under_topology_validates_cell_residency():
    churn = dict(CHURN, initial=(0, 1, 2))  # three ids of cell 0 for its 2-slot block
    with pytest.raises(ValueError) as ref_err:
        rses.CampaignSpec.from_dict(_spec(scenario="churn_cell", scenario_args=(), churn=churn))
    with pytest.raises(ValueError, match=str(ref_err.value)[:20]):
        tses.CampaignSpec.from_dict(_spec(scenario="churn_cell", scenario_args=(), churn=churn))
