"""CampaignService — the async dispatch loop over streaming campaigns.

Port of ``repro.service.service`` over the port's session, streaming driver
and checkpoints.  Campaigns run on the card unless the service is built
with ``device="cpu"``; a campaign with a multi-cell topology runs its cells
as the port's session does.  Turns the one-shot ``ArchesSession.run_streaming()`` into a resident
service: ``submit()`` queues ``CampaignSpec``s (bounded queue, explicit
saturation), a configurable worker pool executes them through the
segment-boundary streaming driver with checkpointing on by default, and
every segment boundary publishes a reduced telemetry sample into the
export ring and persists the campaign's progress.

The operability contract (``tests/test_torch_service.py``):

* **graceful drain** — ``request_drain()`` makes every worker stop at its
  campaign's next segment boundary, *after* that segment's checkpoint has
  been durably written (the ``on_segment`` hook fires post-checkpoint),
  then exit.  Queued campaigns stay queued on disk.
* **bitwise restart** — a restarted service (same ``state_dir``) recovers
  every non-terminal campaign and resumes in-flight ones from their
  latest checkpoint via ``resume_from=``; the completed history is
  bitwise-equal to an uninterrupted ``run_streaming()`` of the same spec.
* **zero-churn lift** — churn-free specs are lifted by
  ``as_streaming_spec`` into a full-residency segmented form, so *every*
  submitted campaign is crash-resumable while staying bitwise-equal to
  the monolithic ``ArchesSession.run()`` on every leaf.

State layout under ``state_dir``::

    campaigns/<campaign_id>/spec.json      # submitted spec (provenance)
    campaigns/<campaign_id>/run_spec.json  # streaming form actually run
    campaigns/<campaign_id>/status.json    # state machine + progress
    campaigns/<campaign_id>/ckpt/          # per-segment atomic checkpoints

``status.json`` is written to a temporary file of its own in the same
directory, then renamed over the old one, so two writers (a worker and a
cancel, or two services) never share a temporary name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import tempfile
import threading
import time
import traceback

from repro_torch.checkpoint.store import latest_step, list_steps
from repro_torch.core.session import (
    ArchesSession,
    CampaignSpec,
    as_streaming_spec,
    spec_hash,
)
from repro_torch.core.telemetry import segment_telemetry
from repro_torch.service.exporters import ExportPump
from repro_torch.service.ring import TelemetryRing


class CampaignState:
    """Campaign state machine (string constants; JSON-stable).

    ``queued -> running -> {completed, failed, cancelled, interrupted}``;
    ``interrupted`` (drained mid-campaign) and non-terminal states are
    recovered and re-enqueued by the next ``start()`` on the same
    ``state_dir``.
    """

    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"
    INTERRUPTED = "interrupted"

    #: states a restarted service re-enqueues (``running`` means the
    #: previous process died without draining — e.g. SIGKILL — and the
    #: latest checkpoint is still the bitwise resume point)
    RECOVERABLE = (QUEUED, RUNNING, INTERRUPTED)
    TERMINAL = (COMPLETED, FAILED, CANCELLED)


class ServiceSaturatedError(RuntimeError):
    """The bounded submission queue is full — back off and resubmit."""


class ServiceDrainingError(RuntimeError):
    """The service is draining and accepts no new campaigns."""


class UnknownCampaignError(KeyError):
    """No campaign with that id in this service's state dir."""


@dataclasses.dataclass
class CampaignRecord:
    """One campaign's full service-side state (persisted as status.json)."""

    campaign_id: str
    spec: CampaignSpec  # as submitted (provenance)
    run_spec: CampaignSpec  # streaming form actually executed
    submitted_seq: int
    state: str = CampaignState.QUEUED
    segments_done: int = 0
    n_segments: int = 0
    error: str | None = None
    # in-memory only: completed history (service-path bitwise contract),
    # cancel latch, record lock
    result: object = None
    cancel_event: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )

    @property
    def spec_hash(self) -> str:
        return spec_hash(self.spec)

    @property
    def run_spec_hash(self) -> str:
        return spec_hash(self.run_spec)


def _atomic_write_json(path: str, payload: dict) -> None:
    """Write ``path`` whole or not at all: a temporary file unique to this
    write, in the same directory, then ``os.replace``."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


class CampaignService:
    """Async dispatch loop + telemetry export + campaign state store.

    ``segment_callback(service, record, event)`` is an observability hook
    fired after each segment's telemetry sample is published and progress
    persisted, before the drain/cancel decision — tests use it to request
    a drain at a deterministic segment boundary.

    ``ai_params`` (optional) is threaded into every ``ArchesSession`` so
    a fleet of campaigns shares one trained estimator instead of each
    retraining it.  ``device`` is where every campaign runs (the card by
    default).
    """

    def __init__(
        self,
        state_dir: str,
        *,
        n_workers: int = 1,
        queue_size: int = 16,
        ring_capacity: int = 256,
        exporters: list | None = None,
        max_segment_slots: int = 8,
        checkpointing: bool = True,
        ai_params=None,
        segment_callback=None,
        device="cuda",
    ):
        if n_workers < 1:
            raise ValueError(f"n_workers {n_workers} must be >= 1")
        self.state_dir = state_dir
        self.campaigns_dir = os.path.join(state_dir, "campaigns")
        os.makedirs(self.campaigns_dir, exist_ok=True)
        self.n_workers = n_workers
        self.max_segment_slots = max_segment_slots
        self.checkpointing = checkpointing
        self.ring = TelemetryRing(ring_capacity)
        self.pump = ExportPump(self.ring, exporters or [])
        self._ai_params = ai_params
        self._segment_callback = segment_callback
        self.device = device
        # The dispatch queue itself is unbounded: recovery must be able to
        # re-enqueue arbitrarily many non-terminal campaigns (a saturated
        # service that crashed can have > queue_size of them) without
        # blocking start().  The submission cap is enforced in submit() by
        # counting queued records instead.
        self.queue_size = queue_size
        self._queue: queue.Queue = queue.Queue()
        self._records: dict[str, CampaignRecord] = {}
        self._lock = threading.Lock()
        self._draining = threading.Event()
        self._workers: list[threading.Thread] = []
        self._started = False
        self._started_at = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "CampaignService":
        """Recover persisted campaigns, then start workers and the pump."""
        if self._started:
            raise RuntimeError("service already started")
        self._recover()
        self.pump.start()
        for i in range(self.n_workers):
            t = threading.Thread(
                target=self._worker_loop, name=f"campaign-worker-{i}",
                daemon=True,
            )
            t.start()
            self._workers.append(t)
        self._started = True
        self._started_at = time.monotonic()
        return self

    def request_drain(self) -> None:
        """Begin graceful drain: no new submissions; every running campaign
        stops at its next segment boundary (checkpoint already durable) and
        is marked ``interrupted``; workers then exit."""
        self._draining.set()

    def drain(self, timeout: float | None = 30.0) -> bool:
        """``request_drain`` + wait for the workers to exit and the pump to
        flush.  Returns True when every worker finished in time."""
        self.request_drain()
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        for t in self._workers:
            left = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            t.join(left)
            ok = ok and not t.is_alive()
        self.pump.stop()
        return ok

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    # -- persistence -----------------------------------------------------------

    def _dir_for(self, campaign_id: str) -> str:
        return os.path.join(self.campaigns_dir, campaign_id)

    def ckpt_dir(self, campaign_id: str) -> str:
        return os.path.join(self._dir_for(campaign_id), "ckpt")

    def _persist(self, rec: CampaignRecord) -> None:
        _atomic_write_json(
            os.path.join(self._dir_for(rec.campaign_id), "status.json"),
            {
                "campaign_id": rec.campaign_id,
                "state": rec.state,
                "submitted_seq": rec.submitted_seq,
                "segments_done": rec.segments_done,
                "n_segments": rec.n_segments,
                "spec_hash": rec.spec_hash,
                "run_spec_hash": rec.run_spec_hash,
                "error": rec.error,
            },
        )

    def _recover(self) -> None:
        """Rebuild records from disk; re-enqueue non-terminal campaigns in
        original submission order (the bitwise-restart half of the drain
        contract — ``resume_from`` picks up each one's latest checkpoint)."""
        recs = []
        for cid in os.listdir(self.campaigns_dir):
            d = self._dir_for(cid)
            try:
                with open(os.path.join(d, "spec.json")) as f:
                    spec = CampaignSpec.from_json(f.read())
                with open(os.path.join(d, "run_spec.json")) as f:
                    run_spec = CampaignSpec.from_json(f.read())
                with open(os.path.join(d, "status.json")) as f:
                    st = json.load(f)
            except (OSError, ValueError, KeyError):
                continue  # torn submit (crash mid-persist): not recoverable
            rec = CampaignRecord(
                campaign_id=cid,
                spec=spec,
                run_spec=run_spec,
                submitted_seq=int(st["submitted_seq"]),
                state=st["state"],
                segments_done=int(st["segments_done"]),
                n_segments=int(st["n_segments"]),
                error=st.get("error"),
            )
            recs.append(rec)
        recs.sort(key=lambda r: r.submitted_seq)
        for rec in recs:
            self._records[rec.campaign_id] = rec
            if rec.state in CampaignState.RECOVERABLE:
                if rec.state != CampaignState.QUEUED:
                    rec.state = CampaignState.QUEUED
                    self._persist(rec)
                self._queue.put_nowait(rec.campaign_id)

    # -- submission / control --------------------------------------------------

    def submit(self, spec: CampaignSpec | str | dict) -> str:
        """Queue a campaign; returns its id.

        Accepts a ``CampaignSpec``, its JSON string, or its dict form.
        Raises ``ServiceDrainingError`` when draining,
        ``ServiceSaturatedError`` when the bounded queue is full, and
        ``ValueError`` for specs with no streaming form.
        """
        if isinstance(spec, str):
            spec = CampaignSpec.from_json(spec)
        elif isinstance(spec, dict):
            spec = CampaignSpec.from_dict(spec)
        if self._draining.is_set():
            raise ServiceDrainingError(
                "service is draining; resubmit after restart"
            )
        run_spec = as_streaming_spec(
            spec, max_segment_slots=self.max_segment_slots
        )
        # Everything from saturation check to enqueue happens under the
        # lock so the dispatch queue's order always matches submitted_seq
        # (what recovery reconstructs after a restart) and a rejected
        # submit leaves no record or state-dir litter.
        with self._lock:
            pending = sum(
                1 for r in self._records.values()
                if r.state == CampaignState.QUEUED
            )
            if pending >= self.queue_size:
                raise ServiceSaturatedError(
                    f"submission queue is full ({pending} pending)"
                )
            seq = 1 + max(
                (r.submitted_seq for r in self._records.values()), default=0
            )
            cid = f"c{seq:04d}-{spec_hash(spec)[:8]}"
            rec = CampaignRecord(
                campaign_id=cid,
                spec=spec,
                run_spec=run_spec,
                submitted_seq=seq,
                n_segments=(
                    run_spec.n_slots // run_spec.churn.segment_slots
                ),
            )
            self._records[cid] = rec
            d = self._dir_for(cid)
            try:
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, "spec.json"), "w") as f:
                    f.write(spec.to_json())
                with open(os.path.join(d, "run_spec.json"), "w") as f:
                    f.write(run_spec.to_json())
                self._persist(rec)
            except BaseException:
                del self._records[cid]
                shutil.rmtree(d, ignore_errors=True)
                raise
            self._queue.put_nowait(cid)
        return cid

    def cancel(self, campaign_id: str) -> str:
        """Cancel a campaign; returns its state after the request.

        Queued campaigns cancel immediately; running ones stop at the next
        segment boundary (their checkpoint is retained).  Terminal states
        are left untouched.
        """
        rec = self._get(campaign_id)
        with self._lock:
            if rec.state == CampaignState.QUEUED:
                rec.state = CampaignState.CANCELLED
                self._persist(rec)
                return rec.state
        rec.cancel_event.set()
        return rec.state

    def _get(self, campaign_id: str) -> CampaignRecord:
        try:
            return self._records[campaign_id]
        except KeyError:
            raise UnknownCampaignError(campaign_id) from None

    # -- introspection ---------------------------------------------------------

    def status(self, campaign_id: str) -> dict:
        """Full status of one campaign, including checkpoint lineage."""
        rec = self._get(campaign_id)
        return {
            "campaign_id": rec.campaign_id,
            "state": rec.state,
            "submitted_seq": rec.submitted_seq,
            "segments_done": rec.segments_done,
            "n_segments": rec.n_segments,
            "spec_hash": rec.spec_hash,
            "run_spec_hash": rec.run_spec_hash,
            "checkpoint_steps": list_steps(self.ckpt_dir(rec.campaign_id)),
            "error": rec.error,
        }

    def list_campaigns(self) -> list[dict]:
        with self._lock:
            recs = sorted(
                self._records.values(), key=lambda r: r.submitted_seq
            )
        return [
            {
                "campaign_id": r.campaign_id,
                "state": r.state,
                "segments_done": r.segments_done,
                "n_segments": r.n_segments,
                "spec_hash": r.spec_hash,
            }
            for r in recs
        ]

    def health(self) -> dict:
        with self._lock:
            states: dict[str, int] = {}
            for r in self._records.values():
                states[r.state] = states.get(r.state, 0) + 1
        return {
            "status": "draining" if self.draining else "ok",
            "uptime_s": (
                0.0 if self._started_at is None
                else time.monotonic() - self._started_at
            ),
            "workers": sum(t.is_alive() for t in self._workers),
            "queue_depth": self._queue.qsize(),
            "campaign_states": states,
            "telemetry": {
                "ring_capacity": self.ring.capacity,
                "samples_published": self.ring.head,
                **self.pump.counters(),
            },
        }

    def result(self, campaign_id: str):
        """The completed ``BatchedRunHistory`` (in-memory; None otherwise)."""
        return self._get(campaign_id).result

    def wait(self, campaign_id: str, timeout: float = 60.0) -> str:
        """Poll until the campaign reaches a terminal state; returns it."""
        rec = self._get(campaign_id)
        deadline = time.monotonic() + timeout
        while rec.state not in CampaignState.TERMINAL:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{campaign_id} still {rec.state!r} after {timeout}s"
                )
            time.sleep(0.02)
        return rec.state

    # -- the dispatch loop -----------------------------------------------------

    def _worker_loop(self) -> None:
        while not self._draining.is_set():
            try:
                cid = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._draining.is_set():
                return  # still queued on disk; the next start() resumes it
            rec = self._records[cid]
            with self._lock:
                if rec.state != CampaignState.QUEUED:
                    continue  # cancelled while queued
                rec.state = CampaignState.RUNNING
            self._persist(rec)
            self._run_campaign(rec)

    def _run_campaign(self, rec: CampaignRecord) -> None:
        try:
            session = ArchesSession(rec.run_spec, device=self.device,
                                    ai_params=self._ai_params)
            ckpt = self.ckpt_dir(rec.campaign_id) if self.checkpointing else None
            resume = (
                ckpt
                if ckpt is not None and latest_step(ckpt) is not None
                else None
            )

            def on_segment(ev) -> bool:
                # reduce the O(segment) span view, not the full-campaign
                # accumulators — per-boundary telemetry cost stays flat as
                # the campaign ages
                local = ev.segment_history is not None
                sample = {
                    "campaign_id": rec.campaign_id,
                    "spec_hash": rec.spec_hash,
                    "seg_idx": ev.seg_idx,
                    "n_segments": ev.n_segments,
                    **segment_telemetry(
                        ev.segment_history if local else ev.history,
                        ev.t0, ev.t1, local=local,
                    ),
                }
                self.ring.push(sample)
                rec.segments_done = ev.seg_idx + 1
                rec.n_segments = ev.n_segments
                self._persist(rec)
                if self._segment_callback is not None:
                    self._segment_callback(self, rec, ev)
                return (
                    self._draining.is_set() or rec.cancel_event.is_set()
                )

            hist = session.run_streaming(
                checkpoint_dir=ckpt, resume_from=resume, on_segment=on_segment
            )
            finished = rec.segments_done >= rec.n_segments
            if finished:
                rec.result = hist
                rec.state = CampaignState.COMPLETED
            elif rec.cancel_event.is_set():
                rec.state = CampaignState.CANCELLED
            else:
                rec.state = CampaignState.INTERRUPTED
        except Exception:
            rec.error = traceback.format_exc(limit=20)
            rec.state = CampaignState.FAILED
        self._persist(rec)
