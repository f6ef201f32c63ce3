"""The port's campaign service and ``segment_telemetry``.

``segment_telemetry`` against ``repro``'s on the same histories (a
multi-cell one with its per-cell throughput, a churn one with residency and
fall-backs; global and span-local views); the service end to end on the
CPU: a multi-cell and a single-cell campaign equal direct ``run_streaming``
calls bitwise, a cancel at a boundary keeps its checkpoint and a resume
from it completes bitwise, a drain and a restart resume bitwise, the HTTP
API answers, ``python -m repro_torch.service`` starts, answers and drains on
SIGTERM, and concurrent ``status.json`` writers (two services on one
campaign directory) never collide.  Every case has a temporary directory of
its own; shapes are the reference's service tests' (n_prb 6, 4 UEs, 12
slots in segments of 4).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from repro.core import runtime as rrt
from repro.core import telemetry as rtel
from repro_torch.core import runtime as trt
from repro_torch.core import session as tses
from repro_torch.core import telemetry as ttel
from repro_torch.service import CampaignService, CampaignState, ServiceAPI
from repro_torch.service.service import _atomic_write_json

torch.set_num_threads(1)

N_PRB, N_UES, N_SLOTS, SEG = 6, 4, 12, 4
THRESHOLD = (dict(kind="threshold", feature="snr", threshold=10.0, hysteresis=1.0),)
MULTI_CELL = dict(path="closed_loop", scenario="multi_cell",
                  scenario_args=(("n_cells", 2), ("per_cell_scenario", ("good", "poor"))),
                  n_ues=N_UES, n_slots=N_SLOTS, n_prb=N_PRB, seed=3,
                  topology=dict(n_cells=2, coupling=0.3, cell_noise_offsets_db=(0.0, 2.0)),
                  policies=THRESHOLD, bank=dict(channels=8, n_res_blocks=1))
SINGLE_CELL = dict(path="batched", scenario="churn_cell", n_ues=N_UES, n_slots=N_SLOTS,
                   n_prb=N_PRB, seed=7, bank=dict(channels=8, n_res_blocks=1),
                   modes=tuple(tuple((s + u) % 2 for u in range(N_UES + 1))
                               for s in range(N_SLOTS)),
                   churn=dict(n_ue_ids=N_UES + 1, segment_slots=SEG, initial=(0, 1, 2, 3),
                              events=((SEG + 1, 0, "detach"), (2 * SEG, 4, "attach"))))


def _spec(d):
    return tses.CampaignSpec.from_dict(d)


def _direct(d):
    """The uninterrupted ``run_streaming`` of a campaign's streaming form."""
    spec = tses.as_streaming_spec(_spec(d), max_segment_slots=SEG)
    return tses.ArchesSession(spec, device="cpu").run_streaming()


def _same(a, b):
    np.testing.assert_array_equal(a.modes, b.modes)
    assert set(a.kpms) == set(b.kpms) and set(a.outputs) == set(b.outputs)
    for k in a.kpms:
        np.testing.assert_array_equal(a.kpms[k], b.kpms[k], err_msg=k)
    for k in a.outputs:
        np.testing.assert_array_equal(a.outputs[k], b.outputs[k], err_msg=k)
    for k in ("decisions", "n_switches", "cell_of_ue", "attached", "bank_slot"):
        if getattr(a, k) is not None or getattr(b, k) is not None:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.fixture(scope="module")
def direct():
    return {"multi_cell": _direct(MULTI_CELL), "single_cell": _direct(SINGLE_CELL)}


def _service(path, **kw):
    return CampaignService(str(path), max_segment_slots=SEG, device="cpu", **kw).start()


# -- segment_telemetry ----------------------------------------------------------------


def _mirror(h):
    return rrt.BatchedRunHistory(modes=h.modes, kpms=h.kpms, outputs=h.outputs,
                                 decisions=h.decisions, n_switches=h.n_switches,
                                 cell_of_ue=h.cell_of_ue, attached=h.attached,
                                 bank_slot=h.bank_slot)


@pytest.mark.parametrize("name", ["multi_cell", "single_cell"])
@pytest.mark.parametrize("t0,t1", [(0, 4), (4, 8), (8, 12), (0, 12), (3, 7)])
def test_segment_telemetry_matches_reference(direct, name, t0, t1):
    hist = direct[name]
    want = rtel.segment_telemetry(_mirror(hist), t0, t1)
    assert ttel.segment_telemetry(hist, t0, t1) == want
    local = trt.BatchedRunHistory(
        modes=hist.modes[t0:t1], kpms={k: v[t0:t1] for k, v in hist.kpms.items()},
        outputs={k: v[t0:t1] for k, v in hist.outputs.items()}, cell_of_ue=hist.cell_of_ue,
        attached=None if hist.attached is None else hist.attached[t0:t1])
    assert ttel.segment_telemetry(local, t0, t1, local=True) == want
    assert ("per_cell_throughput_bps" in want) == (name == "multi_cell")


@pytest.mark.parametrize("t0,t1,local", [(4, 4, False), (-1, 2, False), (8, 13, False),
                                         (0, 3, True)])
def test_segment_telemetry_rejects_what_the_reference_rejects(direct, t0, t1, local):
    hist = direct["single_cell"]
    with pytest.raises(ValueError) as ref_err:
        rtel.segment_telemetry(_mirror(hist), t0, t1, local=local)
    with pytest.raises(ValueError) as port_err:
        ttel.segment_telemetry(hist, t0, t1, local=local)
    assert str(port_err.value) == str(ref_err.value)


# -- the service ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["multi_cell", "single_cell"])
def test_service_campaign_equals_run_streaming(direct, tmp_path, name):
    svc = _service(tmp_path / "svc")
    cid = svc.submit(_spec({"multi_cell": MULTI_CELL, "single_cell": SINGLE_CELL}[name]))
    assert svc.wait(cid, timeout=120) == CampaignState.COMPLETED
    _same(svc.result(cid), direct[name])
    st = svc.status(cid)
    assert st["segments_done"] == st["n_segments"] == N_SLOTS // SEG
    assert st["checkpoint_steps"] == [1, 2, 3]
    samples = svc.ring.snapshot()
    assert [s["seg_idx"] for s in samples] == [0, 1, 2]
    for s in samples:
        assert s == {**s, **ttel.segment_telemetry(direct[name], s["t0"], s["t1"])}
    assert svc.drain(timeout=30)


def test_cancel_keeps_checkpoint_and_resume_is_bitwise(direct, tmp_path):
    def cancel_after_first_segment(service, rec, ev):
        if ev.seg_idx == 0:
            rec.cancel_event.set()

    svc = _service(tmp_path / "svc", segment_callback=cancel_after_first_segment)
    cid = svc.submit(_spec(MULTI_CELL))
    assert svc.wait(cid, timeout=120) == CampaignState.CANCELLED
    st = svc.status(cid)
    assert st["segments_done"] == 1 and st["checkpoint_steps"] == [1]
    assert svc.drain(timeout=30)
    # cancelled is terminal: a restart does not resurrect it
    again = CampaignService(str(tmp_path / "svc"), device="cpu")
    again._recover()
    assert again.status(cid)["state"] == CampaignState.CANCELLED
    assert again._queue.qsize() == 0
    # the kept checkpoint resumes to the uninterrupted history
    spec = tses.as_streaming_spec(_spec(MULTI_CELL), max_segment_slots=SEG)
    resumed = tses.ArchesSession(spec, device="cpu").run_streaming(
        resume_from=svc.ckpt_dir(cid))
    _same(resumed, direct["multi_cell"])


def test_drain_then_restart_resumes_bitwise(direct, tmp_path):
    state = tmp_path / "svc"

    def drain_after_first_segment(service, rec, ev):
        if ev.seg_idx == 0:
            service.request_drain()

    svc = _service(state, segment_callback=drain_after_first_segment)
    cid = svc.submit(_spec(SINGLE_CELL))
    deadline = time.monotonic() + 120
    while not svc.draining:
        assert time.monotonic() < deadline, "segment callback never fired"
        time.sleep(0.02)
    assert svc.drain(timeout=120)
    assert svc.status(cid)["state"] == CampaignState.INTERRUPTED
    svc2 = _service(state)
    assert svc2.wait(cid, timeout=120) == CampaignState.COMPLETED
    _same(svc2.result(cid), direct["single_cell"])
    assert [s["seg_idx"] for s in svc2.ring.snapshot()] == [1, 2]
    assert svc2.drain(timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read().decode())


def _post(url, body=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode() if body else b"",
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_http_api(tmp_path):
    svc = _service(tmp_path / "svc")
    api = ServiceAPI(svc).start()
    try:
        code, body = _post(api.url + "/campaigns", _spec(MULTI_CELL).to_dict())
        assert code == 201
        cid = body["campaign_id"]
        assert svc.wait(cid, timeout=120) == CampaignState.COMPLETED
        code, st = _get(api.url + f"/campaigns/{cid}")
        assert code == 200 and st["state"] == "completed"
        assert st["spec_hash"] == tses.spec_hash(_spec(MULTI_CELL))
        assert _get(api.url + "/campaigns")[1][0]["campaign_id"] == cid
        code, tele = _get(api.url + "/telemetry?n=2")
        assert code == 200 and [s["seg_idx"] for s in tele] == [1, 2]
        assert len(tele[0]["per_cell_throughput_bps"]) == 2
        code, health = _get(api.url + "/health")
        assert code == 200 and health["campaign_states"] == {"completed": 1}
        assert _post(api.url + "/campaigns", {"path": "nope"})[0] == 400
        assert _post(api.url + "/campaigns/c9999-deadbeef/cancel")[0] == 404
        assert _post(api.url + "/drain")[0] == 202
    finally:
        api.stop()
        assert svc.drain(timeout=30)


def test_cli_serves_and_drains_on_sigterm(tmp_path):
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "--state-dir", str(tmp_path / "svc"),
         "--port", "0", "--device", "cpu"], stdout=subprocess.PIPE, text=True, env=env)
    try:
        hello = json.loads(child.stdout.readline())
        assert hello["state_dir"] == str(tmp_path / "svc")
        code, health = _get(hello["url"] + "/health")
        assert code == 200 and health["status"] == "ok"
        child.send_signal(signal.SIGTERM)
        assert child.wait(timeout=60) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def test_concurrent_status_writers_never_collide(tmp_path):
    """Writers of one ``status.json`` (threads of two services on one state
    directory) each rename a temporary file of their own: no write fails,
    the file is always whole JSON, and no temporary file is left behind."""
    state = tmp_path / "svc"
    svcs = [CampaignService(str(state), device="cpu") for _ in range(2)]
    cid = svcs[0].submit(_spec(MULTI_CELL))
    svcs[1]._recover()
    path = os.path.join(svcs[0]._dir_for(cid), "status.json")
    errors = []

    def writer(svc, k):
        rec = svc._get(cid)
        try:
            for i in range(200):
                rec.segments_done = i
                svc._persist(rec)
                _atomic_write_json(path + f".{k}.json", {"i": i})
        except Exception as e:  # noqa: BLE001 -- any failure is the finding
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(svcs[k % 2], k)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    with open(path) as f:
        assert json.load(f)["campaign_id"] == cid
    assert not [n for n in os.listdir(os.path.dirname(path)) if n.endswith(".tmp")]
