"""Streaming under churn through both packages.

``ChurnSchedule`` and the admission re-pack unit by unit against ``repro``'s;
churn campaigns (closed loop under faults, open-loop GATED with
``auto_capacity`` on the id axis) run by both packages from one spec and
compared on the stable-id axis (discrete leaves equal, KPMs within 1e-4
relative, as in ``test_torch_campaign``); and the port's own contracts,
bitwise: pipelined == serial, resume == uninterrupted from a delta and from a
monolithic chain, an ``on_segment`` stop, zero churn == monolithic, and the
device loop == its host replay through re-packs.  The shapes are the
reference's streaming tests' (n_prb 6, 4 bank slots, 5 ids, 12 slots in
segments of 4).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import session as rses
from repro.core import streaming as rstream
from repro_torch.checkpoint.store import STREAMING_DELTA_KIND, checkpoint_kind, list_steps
from repro_torch.core import session as tses
from repro_torch.core import streaming as tstream

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

KPM_RTOL, KPM_ATOL = 1e-4, 1e-4
N_PRB, SEG, N_SLOTS, N_IDS, CAPACITY = 6, 4, 12, 5, 4

CHURN = dict(n_ue_ids=N_IDS, segment_slots=SEG, initial=(0, 1, 2),
             events=((SEG, 3, "attach"), (SEG + 2, 2, "detach"), (2 * SEG + 1, 2, "attach"),
                     (2 * SEG, 4, "attach")))
FAULTS = dict(decision_outages=((5, 9),), corruption_spans=((2, 8),), corruption_kind="nan",
              telemetry_drop_prob=0.15, seed=3, breaker_trips=2, breaker_window=4,
              breaker_cooldown=4)


def _closed(**kw):
    d = dict(path="closed_loop", scenario="churn_cell", n_ues=CAPACITY, n_slots=N_SLOTS,
             n_prb=N_PRB, seed=5, churn=CHURN,
             policies=[dict(kind="threshold", feature="snr", threshold=18.0, hysteresis=2.0)],
             switch=dict(window_slots=2, backend="ref"))
    d.update(kw)
    return d


def _modes(n_slots, n_ids):
    return tuple(tuple((s + u) % 2 for u in range(n_ids)) for s in range(n_slots))


CAMPAIGNS = {
    "closed_faults": (_closed(faults=FAULTS), False),
    "open_gated_auto": (_closed(path="gated", modes=_modes(N_SLOTS, N_IDS), policies=(),
                                switch={}, bank=dict(gated_capacity=1)), True),
}


def _hist_equal(a, b):
    np.testing.assert_array_equal(a.modes, b.modes)
    assert set(a.kpms) == set(b.kpms) and set(a.outputs) == set(b.outputs)
    for k in a.kpms:
        np.testing.assert_array_equal(a.kpms[k], b.kpms[k], err_msg=k)
    for k in a.outputs:
        np.testing.assert_array_equal(a.outputs[k], b.outputs[k], err_msg=k)
    for k in ("decisions", "n_switches", "attached", "bank_slot"):
        if getattr(a, k) is not None or getattr(b, k) is not None:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (d, auto) in CAMPAIGNS.items():
        rspec, tspec = rses.CampaignSpec.from_dict(d), tses.CampaignSpec.from_dict(d)
        tsess = tses.ArchesSession(tspec, device="cpu")
        out[name] = (rspec, rses.ArchesSession(rspec).run(auto_capacity=auto), tspec, tsess,
                     tsess.run(auto_capacity=auto))
    return out


@pytest.fixture(scope="module")
def closed_session(runs):
    """The port's closed-loop churn session under faults (shared)."""
    return runs["closed_faults"][3]


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_churn_campaign_matches_reference(runs, name):
    rspec, rhist, tspec, _, thist = runs[name]
    assert tses.spec_hash(tspec) == rses.spec_hash(rspec)
    assert thist.modes.shape == rhist.modes.shape == (N_SLOTS, N_IDS)
    np.testing.assert_array_equal(thist.modes, rhist.modes)
    np.testing.assert_array_equal(thist.attached, rhist.attached)
    np.testing.assert_array_equal(thist.bank_slot, rhist.bank_slot)
    assert thist.provisioned_capacity == rhist.provisioned_capacity
    assert set(thist.outputs) == set(rhist.outputs)
    for k in ("mcs", "tb_ok", "tbs", "health_tripped", "quarantined", "gated_overflow",
              "executed_flops"):
        if k in rhist.outputs:
            np.testing.assert_array_equal(thist.outputs[k], rhist.outputs[k], err_msg=k)
    if rhist.decisions is not None:
        np.testing.assert_array_equal(thist.decisions, rhist.decisions)
        np.testing.assert_array_equal(thist.n_switches, rhist.n_switches)
    for k, want in rhist.kpms.items():
        np.testing.assert_allclose(thist.kpms[k], want, rtol=KPM_RTOL, atol=KPM_ATOL, err_msg=k)
    assert thist.ai_share == rhist.ai_share


def test_churn_campaigns_are_not_vacuous(runs):
    closed = runs["closed_faults"][4]
    assert closed.health_tripped_slot_ues > 0 and int(closed.n_switches.sum()) > 0
    assert (closed.modes[~closed.attached] == -1).all()
    assert runs["open_gated_auto"][4].provisioned_capacity >= 1
    assert (runs["open_gated_auto"][4].resident_ues_per_slot() <= CAPACITY).all()


def test_device_loop_equals_host_replay_through_repacks(closed_session, runs):
    hist = runs["closed_faults"][4]
    rep = closed_session.host_replay(hist)
    np.testing.assert_array_equal(hist.modes, rep["active_mode"])
    np.testing.assert_array_equal(hist.decisions, rep["raw_decision"])
    np.testing.assert_array_equal(hist.n_switches, rep["n_switches"])
    att = hist.attached
    np.testing.assert_array_equal((hist.outputs["quarantined"] > 0)[att],
                                  (rep["quarantined"] > 0)[att])


@pytest.mark.parametrize("case", ["closed", "open"])
def test_pipelined_equals_serial(closed_session, runs, case):
    sess = closed_session if case == "closed" else runs["open_gated_auto"][3]
    events = {True: [], False: []}
    for pipeline in (True, False):
        def on_segment(ev, pipeline=pipeline):
            events[pipeline].append((ev.seg_idx, ev.t0, ev.t1, tuple(ev.occupant),
                                     ev.segment_history.modes.copy()))
        stats = {}
        hist = sess.run_streaming(pipeline=pipeline, on_segment=on_segment, stats=stats)
        assert stats["pipeline"] is pipeline and stats["segments"] == N_SLOTS // SEG
        events[pipeline].append(hist)
    _hist_equal(events[True][-1], events[False][-1])
    for a, b in zip(events[True][:-1], events[False][:-1]):
        assert a[:4] == b[:4]
        np.testing.assert_array_equal(a[4], b[4])


@pytest.mark.parametrize("fmt,kill_after", [("delta", 1), ("delta", 2), ("monolithic", 2)])
def test_resume_equals_uninterrupted(closed_session, runs, tmp_path, fmt, kill_after):
    ref = runs["closed_faults"][4]
    d = str(tmp_path / "ck")
    stats = {}
    part = closed_session.run_streaming(checkpoint_dir=d, max_segments=kill_after,
                                        checkpoint_format=fmt, stats=stats)
    np.testing.assert_array_equal(part.modes[:kill_after * SEG], ref.modes[:kill_after * SEG])
    assert stats["checkpoint_format"] == fmt and len(stats["checkpoint_bytes"]) == kill_after
    assert list_steps(d) == list(range(1, kill_after + 1))
    kind = checkpoint_kind(f"{d}/step_{kill_after:08d}")
    assert kind == (STREAMING_DELTA_KIND if fmt == "delta" else None)
    _hist_equal(closed_session.run_streaming(resume_from=d), ref)


def test_resume_into_fresh_dir_anchors_and_refuses_other_specs(closed_session, runs,
                                                               tmp_path):
    from repro_torch.checkpoint.store import CheckpointMismatchError

    ref = runs["closed_faults"][4]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    closed_session.run_streaming(checkpoint_dir=a, max_segments=1)
    _hist_equal(closed_session.run_streaming(resume_from=a, checkpoint_dir=b), ref)
    assert checkpoint_kind(f"{b}/step_00000002") is None  # monolithic anchor
    assert checkpoint_kind(f"{b}/step_00000003") == STREAMING_DELTA_KIND
    other = tses.ArchesSession(dataclasses.replace(closed_session.spec, seed=6), device="cpu",
                               ai_params=closed_session.ai_params)
    with pytest.raises(CheckpointMismatchError, match="different"):
        other.run_streaming(resume_from=a)
    with pytest.raises(FileNotFoundError):
        closed_session.run_streaming(resume_from=str(tmp_path / "nope"))
    with pytest.raises(ValueError, match="checkpoint_format"):
        closed_session.run_streaming(checkpoint_format="zip")


@pytest.mark.parametrize("pipeline", [True, False])
def test_on_segment_stop_discards_later_segments(closed_session, runs, tmp_path, pipeline):
    ref = runs["closed_faults"][4]
    d = str(tmp_path / "ck")
    seen = []
    part = closed_session.run_streaming(
        checkpoint_dir=d, pipeline=pipeline,
        on_segment=lambda ev: seen.append(ev.seg_idx) or ev.seg_idx == 0)
    assert seen == [0] and list_steps(d) == [1]
    np.testing.assert_array_equal(part.modes[:SEG], ref.modes[:SEG])
    assert (part.modes[SEG:] == -1).all()
    _hist_equal(closed_session.run_streaming(resume_from=d), ref)


@pytest.mark.parametrize("path", ["closed_loop", "batched"])
def test_zero_churn_equals_monolithic(closed_session, path, monkeypatch):
    """A full-residency streaming run is bitwise the monolithic run, with the
    identity fast path and with the gather forced."""
    d = _closed(path=path, churn=None, faults=None)
    if path == "batched":
        d.update(policies=(), switch={}, modes=_modes(N_SLOTS, CAPACITY))
    mono_spec = tses.CampaignSpec.from_dict(d)
    mono = tses.ArchesSession(mono_spec, device="cpu", ai_params=closed_session.ai_params)
    want = mono.run()
    stream_spec = tses.as_streaming_spec(mono_spec, max_segment_slots=SEG)
    assert stream_spec.churn.segment_slots == SEG
    sess = tses.ArchesSession(stream_spec, device="cpu", ai_params=closed_session.ai_params,
                              engine=mono.engine)
    got = sess.run()
    assert got.attached.all() and (got.bank_slot == np.arange(CAPACITY)).all()
    got.attached = got.bank_slot = None
    _hist_equal(got, want)
    monkeypatch.setattr(tstream, "_FORCE_GATHER", True)
    forced = sess.run()
    forced.attached = forced.bank_slot = None
    _hist_equal(forced, want)


def test_churn_schedule_matches_reference():
    rng = np.random.default_rng(0)
    kw = dict(CHURN)
    for t in (tstream.ChurnSchedule(**kw), tses.CampaignSpec.from_dict(_closed()).churn):
        r = rstream.ChurnSchedule(**kw)
        np.testing.assert_array_equal(t.residency(N_SLOTS), r.residency(N_SLOTS))
        np.testing.assert_array_equal(t.validate(N_SLOTS, CAPACITY),
                                      r.validate(N_SLOTS, CAPACITY))
    bad = [dict(n_ue_ids=0, segment_slots=4), dict(n_ue_ids=3, segment_slots=0),
           dict(n_ue_ids=3, segment_slots=2, initial=(1, 1)),
           dict(n_ue_ids=3, segment_slots=2, events=((0, 1, "wander"),)),
           dict(n_ue_ids=3, segment_slots=2, events=((0, 5, "attach"),))]
    for b in bad:
        with pytest.raises(Exception) as rerr:
            rstream.ChurnSchedule(**b)
        with pytest.raises(type(rerr.value)):
            tstream.ChurnSchedule(**b)
    for b, args in ((dict(kw, initial=(0, 1, 2, 3)), (N_SLOTS, CAPACITY)),
                    (kw, (10, CAPACITY)),
                    (dict(kw, events=((4, 0, "attach"),)), (N_SLOTS, CAPACITY))):
        with pytest.raises(ValueError):
            rstream.ChurnSchedule(**b).validate(*args)
        with pytest.raises(ValueError):
            tstream.ChurnSchedule(**b).validate(*args)
    for _ in range(20):  # the admission pass and its permutation
        prev = rng.permutation(np.r_[np.arange(6), -np.ones(2, int)])
        resident = rng.random(6) < 0.6
        resident[:2] = False
        resident[prev[prev >= 0][:1]] = True
        if resident.sum() > 8:
            continue
        occ = tstream.repack_bank(prev, resident)
        np.testing.assert_array_equal(occ, rstream.repack_bank(prev, resident))
        perm = tstream.gather_permutation(prev, occ)
        np.testing.assert_array_equal(perm, rstream.gather_permutation(prev, occ))
        assert tstream.is_identity_permutation(perm) == rstream.is_identity_permutation(perm)
    assert tstream.is_identity_permutation(np.arange(4))
    assert not tstream.is_identity_permutation(np.array([0, -1, 2]))


def test_gather_state_rows_and_spec_rules():
    from repro_torch.core import closed_loop as tcl

    cfg = tcl.SwitchConfig(feature_names=("snr",), window_slots=2)
    state = tcl.init_device_switch(3, 1, cfg)
    state = state._replace(streak=torch.tensor([5, 6, 7], dtype=torch.int32))
    cold = tcl.init_device_switch(3, 1, cfg)
    assert tstream.gather_state_rows(state, np.arange(3), cold) is state
    moved = tstream.gather_state_rows(state, np.array([2, -1, 0]), cold)
    assert moved.streak.tolist() == [7, 0, 5]
    assert moved.rings.buf.shape == state.rings.buf.shape
    spec = tses.CampaignSpec.from_dict(_closed())
    assert isinstance(spec.churn, tstream.ChurnSchedule)
    with pytest.raises(ValueError, match="churn"):
        tses.CampaignSpec.from_dict(_closed(path="perturbed", n_ues=CAPACITY,
                                            rho=(0.0,) * CAPACITY, policies=()))
    with pytest.raises(ValueError, match="policy_assignment"):
        tses.CampaignSpec.from_dict(_closed(policy_assignment=(0,) * CAPACITY))
    with pytest.raises(ValueError, match="residency"):
        tses.CampaignSpec.from_dict(_closed(n_ues=2))
    assert tses.as_streaming_spec(spec) is spec
