"""Epoch-chunked streaming campaigns: UE attach and detach under churn.

Port of ``repro.core.streaming``.  The slot loop runs in fixed-length
**segments** over a bank of ``CampaignSpec.n_ues`` UE slots; an **active
mask** rides the loop so detached bank slots are masked out of KPM windows,
throughput, executed FLOPs and GATED compaction demand; and an **admission
pass** at each segment boundary re-packs the resident UEs into bank slots
(a stable partition, as the GATED compaction does).

What holds, as in the reference:

* **identity is the stable UE id, not the bank slot** -- per-UE keys are
  ``fold_in(key, ue_id)`` and every slot folds the *global* slot index, so
  a resident UE's key stream, channel and fault masks follow it through any
  re-pack.  Its trajectory is bitwise the same whatever its bank slot where
  every stage computes each UE on its own (the fused GATED kernel); a
  cuBLAS GEMM (the CONCURRENT AI expert) does not promise one row the same
  bits at another batch position;
* **a zero-churn segmented run is bitwise the monolithic run** -- with every
  bank slot attached the mask selects are identities and the boundary
  re-pack is skipped;
* **detach discards, attach cold-starts** -- a reattached UE gets fresh link
  and switch state at the boundary.

**Pipelined execution** (the default) takes the place of JAX's async
dispatch and buffer donation: the main thread enqueues segment k+1's slots
on the compute stream while one worker thread assembles segment k, strictly
in order.  At the end of each segment the main thread records a CUDA event
on the compute stream; the worker makes a copy stream wait on that event,
copies the segment's trajectory and carry to pinned host buffers with
``non_blocking=True`` (each tensor read there ``record_stream``'d so the
caching allocator does not reuse it early) and synchronizes on that copy
alone -- a plain ``.cpu()`` would also wait for segment k+1's work.  Every
batched wrapper writes new tensors, so a segment's carry stays valid while
the next segment runs; nothing is copied on the device.  A stop
(``on_segment`` truthy, or the worker raising) discards the segments
launched ahead, un-assembled and un-checkpointed, so the pipelined executor is
bitwise the serial one (``pipeline=False``) on every history leaf,
checkpoint and event.  On CPU tensors the copy is a plain conversion.

**Incremental checkpoints** (``checkpoint_format="delta"``, the default):
each segment persists its own ``[t0, t1)`` history rows and the
O(capacity) carry, manifest-chained through
``repro_torch.checkpoint.store.STREAMING_DELTA_KIND``; ``resume_from``
replays the chain (anchored on a monolithic checkpoint where one starts
it), bitwise the uninterrupted run.

**Under a multi-cell topology** the bank is laid out in the topology's
cells (the admission re-pack keeps each id in its home cell's block), each
slot couples the cells through the channel, and the history carries each
id's home cell.  With more than one shard each rank runs its block of bank
slots; a shard's block must hold whole cell blocks, so no re-pack moves a
UE across ranks.  After each segment the shards' trajectories and carries
are gathered (one collective), and the segment is assembled on the main
thread in order on every rank (``pipeline`` has no effect there), with
every rank taking the same stop decision; only rank 0 writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time

import numpy as np
import torch

_EVENT_KINDS = ("attach", "detach")

#: closed-loop trajectory leaves that are not campaign outputs
_CLOSED_EXTRAS = ("active_mode", "raw_decision", "pending_mode", "kpms")


@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """Declarative attach/detach schedule over a stable UE-id universe.

    ``n_ue_ids`` sizes the id universe (ids ``0..n_ue_ids-1`` -- history and
    PRNG identity live on this axis; it may exceed the bank capacity as
    long as concurrent residency never does).  ``segment_slots`` is the
    epoch length: the slot loop runs in segments of this many slots and
    churn takes effect only at segment boundaries -- an event at slot ``t``
    becomes effective at the first segment start ``>= t`` (events whose
    boundary lies past the campaign horizon never take effect).

    ``initial`` lists the ids attached at slot 0; ``events`` is a tuple of
    ``(slot, ue_id, "attach" | "detach")`` triples.  Attaching an attached
    id or detaching an absent one is a validation error (the admission pass
    is declarative, not idempotent), as is residency exceeding the bank
    capacity -- all surfaced at spec time, never mid-campaign.
    """

    n_ue_ids: int
    segment_slots: int
    initial: tuple = ()
    events: tuple = ()

    def __post_init__(self):
        if self.n_ue_ids < 1:
            raise ValueError(f"n_ue_ids {self.n_ue_ids} must be >= 1")
        if self.segment_slots < 1:
            raise ValueError(
                f"segment_slots {self.segment_slots} must be >= 1"
            )
        initial = tuple(int(u) for u in self.initial)
        if len(set(initial)) != len(initial):
            raise ValueError(f"initial {initial} repeats UE ids")
        object.__setattr__(self, "initial", initial)
        events = []
        for ev in self.events:
            slot, ue, kind = ev
            if str(kind) not in _EVENT_KINDS:
                raise ValueError(
                    f"event kind {kind!r}; one of {_EVENT_KINDS}"
                )
            if int(slot) < 0:
                raise ValueError(f"event slot {slot} must be >= 0")
            events.append((int(slot), int(ue), str(kind)))
        object.__setattr__(self, "events", tuple(events))
        for u in self.initial + tuple(u for _, u, _ in self.events):
            if not 0 <= u < self.n_ue_ids:
                raise ValueError(
                    f"UE id {u} outside [0, {self.n_ue_ids})"
                )

    def residency(self, n_slots: int) -> np.ndarray:
        """Per-slot attachment matrix ``(n_slots, n_ue_ids)`` (bool).

        Piecewise constant per segment by construction.  Raises on an
        inconsistent event stream (attach-while-attached /
        detach-while-absent among the events that take effect within the
        horizon).
        """
        seg = self.segment_slots
        if n_slots < 1:
            raise ValueError(f"n_slots {n_slots} must be >= 1")
        if n_slots % seg:
            raise ValueError(
                f"segment_slots={seg} does not divide n_slots={n_slots}: "
                "the streaming executor runs one fixed segment length"
            )
        attached = np.zeros(self.n_ue_ids, bool)
        attached[list(self.initial)] = True
        by_boundary: dict[int, list] = {}
        for slot, ue, kind in self.events:
            eff = ((slot + seg - 1) // seg) * seg
            if eff >= n_slots:
                continue  # boundary past the horizon: never effective
            by_boundary.setdefault(eff, []).append((slot, ue, kind))
        out = np.zeros((n_slots, self.n_ue_ids), bool)
        for t0 in range(0, n_slots, seg):
            for slot, ue, kind in by_boundary.get(t0, ()):
                if kind == "attach":
                    if attached[ue]:
                        raise ValueError(
                            f"attach of UE {ue} at slot {slot}: already "
                            "attached at its effective boundary "
                            f"(segment start {t0})"
                        )
                    attached[ue] = True
                else:
                    if not attached[ue]:
                        raise ValueError(
                            f"detach of UE {ue} at slot {slot}: not "
                            "attached at its effective boundary "
                            f"(segment start {t0})"
                        )
                    attached[ue] = False
            out[t0:t0 + seg] = attached
        return out

    def validate(
        self, n_slots: int, capacity: int, *, n_cells: int = 1
    ) -> np.ndarray:
        """Check the schedule against a campaign shape; return residency.

        ``capacity`` is the bank width (``CampaignSpec.n_ues``).  Under a
        multi-cell topology the bank is partitioned into ``n_cells`` equal
        contiguous blocks and each id's home cell is
        ``ue_id // (n_ue_ids / n_cells)`` -- per-cell residency must fit the
        cell's block so the admission pass can stay cell-block-aligned
        (which is what keeps re-packing free of cross-shard movement).
        """
        res = self.residency(n_slots)
        if n_cells < 1:
            raise ValueError(f"n_cells {n_cells} must be >= 1")
        if n_cells == 1:
            worst = int(res.sum(axis=1).max(initial=0))
            if worst > capacity:
                raise ValueError(
                    f"churn residency peaks at {worst} UEs but the bank "
                    f"holds {capacity}: raise n_ues or thin the schedule"
                )
            return res
        if self.n_ue_ids % n_cells:
            raise ValueError(
                f"n_cells={n_cells} does not divide n_ue_ids="
                f"{self.n_ue_ids}: ids map to home cells in equal blocks"
            )
        if capacity % n_cells:
            raise ValueError(
                f"n_cells={n_cells} does not divide the bank capacity "
                f"{capacity}"
            )
        block = capacity // n_cells
        cells = home_cells(self.n_ue_ids, n_cells)
        for c in range(n_cells):
            worst = int(res[:, cells == c].sum(axis=1).max(initial=0))
            if worst > block:
                raise ValueError(
                    f"cell {c} residency peaks at {worst} UEs but its "
                    f"bank block holds {block}"
                )
        return res


def home_cells(n_ue_ids: int, n_cells: int) -> np.ndarray:
    """Stable-id -> home-cell map ((n_ue_ids,) int32, contiguous blocks)."""
    return (np.arange(n_ue_ids) // (n_ue_ids // n_cells)).astype(np.int32)


def repack_bank(
    prev_occupant: np.ndarray,
    resident: np.ndarray,
    *,
    n_cells: int = 1,
) -> np.ndarray:
    """Admission pass: stable-partition the resident set into bank slots.

    ``prev_occupant (B,)`` holds the previous segment's occupant id per
    bank slot (-1 empty); ``resident (n_ue_ids,)`` is the new segment's
    attachment vector.  Surviving occupants compact to the front of their
    (cell-block) slot range *preserving pack order* -- the same stable
    partition the gated compaction path uses -- and newly attached ids
    append in ascending id order; remaining slots are empty (-1).

    Deterministic, so the whole occupancy timeline is a pure function of
    the ``ChurnSchedule``.
    """
    prev_occupant = np.asarray(prev_occupant)
    resident = np.asarray(resident, bool)
    capacity = prev_occupant.shape[0]
    if capacity % n_cells:
        raise ValueError(
            f"n_cells={n_cells} does not divide capacity={capacity}"
        )
    cells = home_cells(resident.shape[0], n_cells)
    block = capacity // n_cells
    occ = np.full(capacity, -1, prev_occupant.dtype)
    for c in range(n_cells):
        lo = c * block
        prev_block = [int(u) for u in prev_occupant[lo:lo + block] if u >= 0]
        survivors = [u for u in prev_block if resident[u]]
        newcomers = sorted(
            int(u) for u in np.nonzero(resident & (cells == c))[0]
            if u not in set(prev_block)
        )
        packed = survivors + newcomers
        if len(packed) > block:
            raise ValueError(
                f"cell {c}: {len(packed)} resident UEs for a {block}-slot "
                "bank block (validate the churn schedule first)"
            )
        occ[lo:lo + len(packed)] = packed
    return occ


def gather_permutation(
    prev_occupant: np.ndarray, new_occupant: np.ndarray
) -> np.ndarray:
    """Per-bank-slot source index into the previous bank (-1 == cold start).

    Slot ``b``'s new occupant either survived from previous slot
    ``perm[b]`` (its device state rows are gathered from there) or is a
    fresh attach / empty slot (``perm[b] == -1`` -- cold-init rows).
    """
    prev_pos = {int(u): j for j, u in enumerate(prev_occupant) if u >= 0}
    return np.asarray(
        [
            prev_pos.get(int(u), -1) if u >= 0 else -1
            for u in new_occupant
        ],
        np.int64,
    )


#: test hook -- set True to disable the identity fast path so the gathered
#: path can be asserted bitwise-equal to it (the streaming tests)
_FORCE_GATHER = False


def is_identity_permutation(perm: np.ndarray) -> bool:
    """True iff every bank slot keeps its occupant (no cold rows, no moves).

    This is the zero-churn boundary: ``gather_state_rows`` is then the
    identity and can be skipped entirely.
    """
    perm = np.asarray(perm)
    return perm.size > 0 and bool(
        np.array_equal(perm, np.arange(perm.shape[0]))
    )


def gather_state_rows(state, perm: np.ndarray, cold_state):
    """Re-pack a per-UE state (a NamedTuple of tensors, nested) along its
    leading bank axis.

    Survivor rows gather from their previous slot; ``perm < 0`` rows take
    the cold-start value from ``cold_state``.  An identity permutation is
    detected up front and returns ``state`` itself, so a zero-churn
    boundary does no work and changes no bit.
    """
    if not _FORCE_GATHER and is_identity_permutation(perm):
        return state
    dev = state[0].device if isinstance(state[0], torch.Tensor) else state[0][0].device
    take = torch.as_tensor(np.maximum(perm, 0), dtype=torch.int64, device=dev)
    cold = torch.as_tensor(perm < 0, device=dev)

    def one(prev, cold_leaf):
        if isinstance(prev, tuple):
            return type(prev)(*(one(p, c) for p, c in zip(prev, cold_leaf)))
        g = prev.index_select(0, take)
        return torch.where(cold.reshape(cold.shape + (1,) * (g.ndim - 1)), cold_leaf, g)

    return one(state, cold_state)


def _scatter_segment(full, seg_arr, t0, ids, slots):
    """full[t0:t0+seg, ids] = seg_arr[:, slots] (host-side assembly)."""
    full[t0:t0 + seg_arr.shape[0], ids] = np.asarray(seg_arr)[:, slots]


def _state_dict(state) -> dict:
    """A NamedTuple state as nested dicts (a checkpoint-stable tree)."""
    return {k: _state_dict(v) if isinstance(v, tuple) else v
            for k, v in state._asdict().items()}


def _meta(next_seg: int, spec_fp: int, **extra) -> dict:
    # the 64-bit fingerprint ships as two uint32 halves, as in the reference
    return {"next_seg": np.int32(next_seg), "spec_fp_hi": np.uint32(spec_fp >> 32),
            "spec_fp_lo": np.uint32(spec_fp & 0xFFFFFFFF),
            **{k: np.int32(v) for k, v in extra.items()}}


def _streaming_ckpt_state(*, next_seg, spec_fp, occupant, link, sw, modes_full,
                          bank_slot_full, decisions_full, n_switches_id, kpms_full,
                          outputs_full):
    """The monolithic crash-resume snapshot as an all-dict tree: the loop's
    carry (link and switch state, host copies), the bank occupancy and the
    whole-campaign accumulators."""
    state = {
        "meta": _meta(next_seg, spec_fp),
        "occupant": np.asarray(occupant),
        "link": link,
        "modes_full": modes_full,
        "bank_slot_full": bank_slot_full,
        "kpms_full": dict(kpms_full),
        "outputs_full": dict(outputs_full),
    }
    if sw is not None:
        state["sw"] = sw
        state["decisions_full"] = decisions_full
        state["n_switches_id"] = n_switches_id
    return state


def _delta_ckpt_state(*, next_seg, spec_fp, t0, t1, occupant, link, sw, modes_full,
                      bank_slot_full, decisions_full, n_switches_id, kpms_full,
                      outputs_full):
    """One segment's incremental snapshot: its own ``[t0, t1)`` history rows,
    the O(capacity) carry and occupancy, and the per-id switch counter,
    whatever the campaign's length so far."""
    state = {
        "meta": _meta(next_seg, spec_fp, t0=t0, t1=t1),
        "occupant": np.asarray(occupant),
        "link": link,
        "rows": {
            "modes": modes_full[t0:t1],
            "bank_slot": bank_slot_full[t0:t1],
            "kpms": {k: v[t0:t1] for k, v in kpms_full.items()},
            "outputs": {k: v[t0:t1] for k, v in outputs_full.items()},
        },
    }
    if sw is not None:
        state["sw"] = sw
        state["rows"]["decisions"] = decisions_full[t0:t1]
        state["n_switches_id"] = n_switches_id
    return state


def _concat_host(parts: list, axis: int):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat_host([p[k] for p in parts], axis) for k in first}
    return np.concatenate(parts, axis=axis)


def _gather_bank(topo, local: dict | None) -> dict:
    """The shards' host copies of a segment (``traj`` leaves ``(S, U_shard)``,
    carry leaves ``(U_shard, ...)``), gathered into the whole bank's."""
    from repro_torch.core.topology import all_gather_parts

    parts = all_gather_parts(topo, local)
    return {k: _concat_host([p[k] for p in parts], 1 if k == "traj" else 0)
            for k in parts[0]}


def _dir_bytes(directory: str) -> int:
    """Total payload bytes of one checkpoint directory."""
    return sum(os.path.getsize(os.path.join(directory, n)) for n in os.listdir(directory)
               if os.path.isfile(os.path.join(directory, n)))


def _spec_fingerprint(spec) -> int:
    """64-bit view of ``spec_hash``."""
    from repro_torch.core.session import spec_hash

    return int(spec_hash(spec), 16) & 0xFFFFFFFFFFFFFFFF


def _tensors(tree) -> list:
    """The tensors of a nested dict, in its order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def _replace_tensors(tree, it):
    """The nested dict with its tensors taken from ``it``, in ``_tensors``' order."""
    if isinstance(tree, dict):
        return {k: _replace_tensors(v, it) for k, v in tree.items()}
    return next(it)


class _HostCopy:
    """Copies a segment's tensors (a nested dict) to host numpy arrays.

    On the card: a copy stream waits on the event the compute stream
    recorded at the segment's end, every tensor is ``record_stream``'d on it
    and copied into pinned memory with ``non_blocking=True``, and the worker
    waits for that copy alone.  On the CPU the tensors are converted as they
    are.
    """

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device=device) if self.cuda else None

    def mark(self):
        """An event at the current end of the compute stream (None on CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def __call__(self, tree, ready):
        ts = _tensors(tree)
        if not self.cuda:
            return _replace_tensors(tree, iter([t.numpy() for t in ts]))
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            hosts = []
            for t in ts:
                t.record_stream(self.stream)
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                hosts.append(h)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return _replace_tensors(tree, iter([h.numpy() for h in hosts]))


@dataclasses.dataclass(frozen=True)
class SegmentEvent:
    """What ``run_streaming`` hands to ``on_segment`` after each segment.

    Fired once per completed segment, after its checkpoint (when one is
    armed) is durably written; under the pipelined executor on the worker
    thread, still in segment order.  ``history`` views the executor's live
    whole-campaign accumulators (slots ``[0, t1)`` filled, later slots still
    at their detached fill); ``segment_history`` views the same accumulators
    over this segment's ``[t0, t1)`` rows.  Both are views into reused
    arrays: copy what must outlive the callback.
    """

    seg_idx: int  # 0-based index of the segment that just completed
    n_segments: int  # total segments in the campaign horizon
    t0: int  # first slot of the segment
    t1: int  # one past the segment's last slot
    occupant: np.ndarray  # (capacity,) bank occupancy after this segment
    history: "object"  # whole-campaign BatchedRunHistory view
    segment_history: "object" = None  # [t0, t1) view


def run_streaming(session, *, checkpoint_dir: str | None = None,
                  resume_from: str | None = None, max_segments: int | None = None,
                  on_segment=None, pipeline: bool = True, checkpoint_format: str = "delta",
                  stats: dict | None = None) -> "object":
    """Run an epoch-chunked streaming campaign.

    Validate the churn, resolve the scenario over the stable-id axis, then
    loop over segments: the admission re-pack, the carry's gather and cold
    rows (skipped at a zero-churn boundary), the occupants' keys, channel
    params, modes and fault masks, one segment of the slot loop with the
    active mask from global slot ``t0``; and assemble the
    ``BatchedRunHistory`` on the id axis (a detached slot-UE carries mode
    ``-1``, zeroed KPMs and outputs, ``attached`` False and ``bank_slot``
    -1).

    ``pipeline=True`` overlaps segment k's assembly and checkpoint with
    segment k+1 on the device (see the module docstring); ``pipeline=False``
    is the serial reference, bitwise the same.  ``checkpoint_dir`` writes an
    atomic checkpoint after every completed segment, a delta by default or
    the whole state with ``checkpoint_format="monolithic"``; ``resume_from``
    restarts from the latest complete checkpoint there, bitwise the
    uninterrupted run.  ``max_segments`` stops after that many segments this
    call (the returned history covers only those).  ``on_segment`` gets a
    ``SegmentEvent`` after each segment; a truthy return stops the loop at
    that boundary.  ``stats`` (a dict) receives ``dispatch_s`` (the main
    thread's launch work), ``wait_s`` (assembly waiting for the device),
    ``assembly_s``, ``checkpoint_s``, ``checkpoint_bytes`` (per segment),
    ``segments``, ``pipeline`` and ``checkpoint_format``.
    """
    from repro_torch import random as jr
    from repro_torch.core.closed_loop import init_device_switch
    from repro_torch.core.runtime import BatchedRunHistory
    from repro_torch.core.session import ExecutionPath
    from repro_torch.core.telemetry import flatten_kpm_sources
    from repro_torch.core.topology import agree_any
    from repro_torch.phy.pipeline import init_device_link, normalize_modes, resolve_schedule

    if checkpoint_format not in ("delta", "monolithic"):
        raise ValueError(f"checkpoint_format {checkpoint_format!r}: expected 'delta' or "
                         "'monolithic'")
    spec = session.spec
    churn = spec.churn
    if churn is None:
        raise ValueError("run_streaming needs spec.churn (a ChurnSchedule)")
    path = spec.execution_path
    if path not in (ExecutionPath.BATCHED, ExecutionPath.GATED, ExecutionPath.CLOSED_LOOP):
        raise ValueError(f"streaming supports batched/gated/closed_loop, not {spec.path!r}")
    closed = path is ExecutionPath.CLOSED_LOOP
    capacity = spec.n_ues  # the bank's width
    n_ids, n_slots, seg = churn.n_ue_ids, spec.n_slots, churn.segment_slots
    topo = session.cell_topology
    n_cells = 1 if topo is None else topo.n_cells
    res = churn.validate(n_slots, capacity, n_cells=n_cells)
    home = None if topo is None else home_cells(n_ids, n_cells)
    # more than one shard: this rank runs bank slots [lo, hi), whole cell blocks
    multi = topo is not None and topo.n_shards > 1
    if multi and n_cells % topo.n_shards:
        raise ValueError(f"streaming over {topo.n_shards} shards needs whole cell blocks a "
                         f"shard: n_cells={n_cells} is not a multiple of it")
    runs = topo is None or topo.holds_ues
    lo, hi = (0, capacity) if topo is None else topo.block() if runs else (0, 0)
    writes = topo is None or topo.rank == 0

    engine = session.engine
    dev = engine.device
    cells = topo.slot_cells(dev) if topo is not None and runs else None
    # fault masks live on the stable-id axis and follow their UE into slots
    faults = spec.faults
    rf = None if faults is None else faults.resolve(n_slots, n_ids)
    profile, params = resolve_schedule(engine.cfg, session.schedule, n_slots, n_ids, dev)
    per_ue = params.noise_var.ndim == 2
    id_keys = jr.fold_in(jr.PRNGKey(spec.seed, dev), torch.arange(n_ids, device=dev))

    modes_grid = sw_cfg = policy = None
    if closed:
        sw_cfg = spec.switch.to_config(spec.feature_names)
        policy = session.device_policy
    else:
        modes_grid = normalize_modes(np.asarray(spec.modes, np.int32), n_slots, n_ids).numpy()

    def cold_switch():
        return init_device_switch(hi - lo, len(sw_cfg.feature_names), sw_cfg, dev,
                                  faults=faults)

    occupant = np.full(capacity, -1, np.int64)
    link = init_device_link(hi - lo, dev)
    sw = cold_switch() if closed else None

    # whole-campaign accumulators on the stable-id axis
    modes_full = np.full((n_slots, n_ids), -1, np.int32)
    bank_slot_full = np.full((n_slots, n_ids), -1, np.int32)
    decisions_full = np.full((n_slots, n_ids), -1, np.int32) if closed else None
    n_switches_id = np.zeros(n_ids, np.int32) if closed else None
    kpms_full: dict[str, np.ndarray] = {}
    outputs_full: dict[str, np.ndarray] = {}

    spec_fp = _spec_fingerprint(spec)
    start_seg = 0
    mgr = None
    if checkpoint_dir is not None or resume_from is not None:
        from repro_torch.checkpoint.store import (
            STREAMING_DELTA_KIND,
            CheckpointManager,
            CheckpointMismatchError,
            load_pytree,
            resume_chain,
        )

    def restore_carry(saved):
        nonlocal occupant, link, sw
        occupant = np.asarray(saved["occupant"])

        def mine(v):  # the checkpoint holds the whole bank: this rank's block
            return v[lo:hi].to(dev)

        link = type(link)(**{k: mine(v) for k, v in saved["link"].items()})
        if closed:
            sw_saved = dict(saved["sw"])
            rings = type(sw.rings)(**{k: mine(v) for k, v in sw_saved.pop("rings").items()})
            sw = type(sw)(rings=rings, **{k: mine(v) for k, v in sw_saved.items()})

    def check_fp(saved, step):
        saved_fp = (int(saved["meta"]["spec_fp_hi"]) << 32) | int(saved["meta"]["spec_fp_lo"])
        if saved_fp != spec_fp:
            raise CheckpointMismatchError(
                f"checkpoint step {step} in {resume_from!r} was written by a different "
                "campaign spec -- refusing to resume")

    if resume_from is not None:
        anchor, delta_steps = resume_chain(resume_from)
        if anchor is None and not delta_steps:
            raise FileNotFoundError(f"resume_from={resume_from!r} holds no complete "
                                    "checkpoint")
        rmgr = CheckpointManager(resume_from, save_every=1, keep=None)
        if anchor is not None:
            saved = load_pytree(rmgr.dir_for(anchor))
            check_fp(saved, anchor)
            start_seg = int(saved["meta"]["next_seg"])
            restore_carry(saved)
            if closed:
                decisions_full = saved["decisions_full"].numpy().copy()
                n_switches_id = saved["n_switches_id"].numpy().copy()
            modes_full = saved["modes_full"].numpy().copy()
            bank_slot_full = saved["bank_slot_full"].numpy().copy()
            kpms_full = {k: v.numpy().copy() for k, v in saved["kpms_full"].items()}
            outputs_full = {k: v.numpy().copy() for k, v in saved["outputs_full"].items()}
        for dstep in delta_steps:
            d = load_pytree(rmgr.dir_for(dstep))
            check_fp(d, dstep)
            td0, td1 = int(d["meta"]["t0"]), int(d["meta"]["t1"])
            rows = d["rows"]
            if not kpms_full:
                kpms_full.update({k: np.zeros((n_slots, n_ids), v.numpy().dtype)
                                  for k, v in rows["kpms"].items()})
                outputs_full.update({k: np.zeros((n_slots, n_ids), v.numpy().dtype)
                                     for k, v in rows["outputs"].items()})
            modes_full[td0:td1] = rows["modes"].numpy()
            bank_slot_full[td0:td1] = rows["bank_slot"].numpy()
            for k in kpms_full:
                kpms_full[k][td0:td1] = rows["kpms"][k].numpy()
            for k in outputs_full:
                outputs_full[k][td0:td1] = rows["outputs"][k].numpy()
            if closed:
                decisions_full[td0:td1] = rows["decisions"].numpy()
        if delta_steps:  # the last delta holds the live loop state
            start_seg = int(d["meta"]["next_seg"])
            restore_carry(d)
            if closed:
                n_switches_id = d["n_switches_id"].numpy().copy()
    if checkpoint_dir is not None and writes:
        # delta chains need every predecessor on disk; monolithic keeps 3
        mgr = CheckpointManager(checkpoint_dir, save_every=1,
                                keep=None if checkpoint_format == "delta" else 3)

    n_segments = n_slots // seg
    st = {"dispatch_s": 0.0, "wait_s": 0.0, "assembly_s": 0.0, "checkpoint_s": 0.0,
          "checkpoint_bytes": []}
    n_assembled = [0]  # the worker's; read after the join
    # a delta must chain to its predecessor on disk: resuming into a directory
    # without step ``start_seg`` writes its first checkpoint monolithic
    need_anchor = (mgr is not None and checkpoint_format == "delta" and start_seg > 0
                   and start_seg not in set(mgr.steps()))
    host_copy = _HostCopy(dev)

    def full_history(attached):
        return BatchedRunHistory(modes=modes_full, kpms=kpms_full, outputs=outputs_full,
                                 decisions=decisions_full, n_switches=n_switches_id,
                                 cell_of_ue=home, attached=attached, bank_slot=bank_slot_full)

    def assemble_segment(item) -> bool:
        """Wait for one segment's copy, scatter it, checkpoint it, notify."""
        seg_idx, t0 = item["seg_idx"], item["t0"]
        t1 = t0 + seg
        ids_b, slots_b = item["ids_b"], item["slots_b"]
        t_a = time.perf_counter()
        h = item["host"] if "host" in item else host_copy(item["device"], item["ready"])
        t_b = time.perf_counter()
        st["wait_s"] += t_b - t_a
        traj = h["traj"]
        flat_kpms = flatten_kpm_sources(traj["kpms"])
        if not kpms_full:
            kpms_full.update({k: np.zeros((n_slots, n_ids), v.dtype)
                              for k, v in flat_kpms.items()})
            outputs_full.update({k: np.zeros((n_slots, n_ids), v.dtype)
                                 for k, v in traj.items() if k not in _CLOSED_EXTRAS})
        for k, v in flat_kpms.items():
            _scatter_segment(kpms_full[k], v, t0, ids_b, slots_b)
        for k in outputs_full:
            _scatter_segment(outputs_full[k], traj[k], t0, ids_b, slots_b)
        if closed:
            _scatter_segment(modes_full, traj["active_mode"], t0, ids_b, slots_b)
            _scatter_segment(decisions_full, traj["raw_decision"], t0, ids_b, slots_b)
            delta = h["nsw_after"] - h["nsw_base"]
            n_switches_id[ids_b] += delta[slots_b]
        else:
            _scatter_segment(modes_full, item["modes_seg"], t0, ids_b, slots_b)
        bank_slot_full[t0:t1, ids_b] = slots_b[None, :]
        t_c = time.perf_counter()
        st["assembly_s"] += t_c - t_b

        if mgr is not None:
            step = seg_idx + 1
            common = dict(next_seg=step, spec_fp=spec_fp, occupant=item["occupant"],
                          link=h["link"], sw=h.get("sw"), modes_full=modes_full,
                          bank_slot_full=bank_slot_full, decisions_full=decisions_full,
                          n_switches_id=n_switches_id, kpms_full=kpms_full,
                          outputs_full=outputs_full)
            if checkpoint_format == "delta" and not (need_anchor and seg_idx == start_seg):
                mgr.maybe_save(step, _delta_ckpt_state(t0=t0, t1=t1, **common), force=True,
                               manifest_extra={"kind": STREAMING_DELTA_KIND,
                                               "prev_step": step - 1})
            else:
                mgr.maybe_save(step, _streaming_ckpt_state(**common), force=True)
            st["checkpoint_s"] += time.perf_counter() - t_c
            st["checkpoint_bytes"].append(_dir_bytes(mgr.dir_for(step)))
        n_assembled[0] += 1

        if on_segment is not None:
            return bool(on_segment(SegmentEvent(
                seg_idx=seg_idx, n_segments=n_segments, t0=t0, t1=t1,
                occupant=item["occupant"].copy(), history=full_history(res),
                segment_history=BatchedRunHistory(
                    modes=modes_full[t0:t1],
                    kpms={k: v[t0:t1] for k, v in kpms_full.items()},
                    outputs={k: v[t0:t1] for k, v in outputs_full.items()},
                    decisions=None if decisions_full is None else decisions_full[t0:t1],
                    n_switches=n_switches_id, cell_of_ue=home, attached=res[t0:t1],
                    bank_slot=bank_slot_full[t0:t1]),
            )))
        return False

    done_marker = object()
    stop_event = threading.Event()
    worker_error: list = [None]
    work_q: queue.Queue = queue.Queue(maxsize=2)

    def assembly_worker():
        while True:
            item = work_q.get()
            if item is done_marker:
                return
            if stop_event.is_set():
                continue  # launched ahead of a stop: never assembled
            try:
                if assemble_segment(item):
                    stop_event.set()
            except BaseException as e:  # raised again in the caller after the join
                worker_error[0] = e
                stop_event.set()

    pipeline = pipeline and not multi
    worker = None
    if pipeline:
        worker = threading.Thread(target=assembly_worker, name="arches-streaming-assembly",
                                  daemon=True)
        worker.start()

    dispatched = 0
    try:
        for t0 in range(start_seg * seg, n_slots, seg):
            if stop_event.is_set():
                break
            t_d = time.perf_counter()
            new_occupant = repack_bank(occupant, res[t0], n_cells=n_cells)
            perm = gather_permutation(occupant, new_occupant)
            # this rank's slots: a survivor's source slot lies in the same block
            mine = perm[lo:hi]
            mine = np.where(mine >= 0, mine - lo, -1)
            if runs:
                link = gather_state_rows(link, mine, init_device_link(hi - lo, dev))
                if closed:
                    sw = gather_state_rows(sw, mine, cold_switch())
                    nsw_base = sw.n_switches
            occupant = new_occupant
            occ_c = np.maximum(occupant, 0)
            occupied = occupant >= 0
            slots_b = np.nonzero(occupied)[0]
            ids_b = occupant[slots_b]
            modes_seg = None
            if not closed:
                modes_seg = np.ascontiguousarray(modes_grid[t0:t0 + seg][:, occ_c])

            device = None
            if runs:
                occ_l = occ_c[lo:hi]
                occ_t = torch.as_tensor(occ_l, dtype=torch.int64, device=dev)
                keys_seg = id_keys.index_select(0, occ_t)
                params_seg = type(params)(*(
                    x[t0:t0 + seg].index_select(1, occ_t) if per_ue else x[t0:t0 + seg]
                    for x in params))
                active = torch.as_tensor(occupied[lo:hi], device=dev)
                fault_seg = None
                if rf is not None:
                    # the kernels take contiguous rows; a column gather is Fortran-ordered
                    fault_seg = tuple(
                        torch.as_tensor(np.ascontiguousarray(m[t0:t0 + seg][:, occ_l]),
                                        device=dev)
                        for m in (rf.decision_valid, rf.corrupt, rf.telemetry_valid))
                if closed:
                    link, sw, traj = engine._run_closed(
                        profile, sw_cfg, link, sw, keys_seg, params_seg, policy, seg,
                        slot0=t0, active=active, faults=faults, fault_masks=fault_seg,
                        cells=cells)
                else:
                    link, traj = engine._run_open(
                        profile, link, keys_seg,
                        torch.as_tensor(np.ascontiguousarray(modes_seg[:, lo:hi]), device=dev),
                        params_seg, slot0=t0, active=active, faults=faults,
                        corrupt=None if fault_seg is None else fault_seg[1], cells=cells)
                device = {"traj": traj}
                if closed:
                    device.update(nsw_base=nsw_base, nsw_after=sw.n_switches)
                if mgr is not None or multi:  # the carry, for the checkpoint
                    device["link"] = dict(link._asdict())
                    if closed:
                        device["sw"] = _state_dict(sw)
            item = {"seg_idx": t0 // seg, "t0": t0, "device": device,
                    "ready": host_copy.mark(), "ids_b": ids_b, "slots_b": slots_b,
                    "occupant": occupant, "modes_seg": modes_seg}
            if multi:
                # the whole bank's segment on every rank, in one collective
                local = None if device is None else host_copy(device, item["ready"])
                item["host"] = _gather_bank(topo, local)
            st["dispatch_s"] += time.perf_counter() - t_d
            dispatched += 1

            if multi:
                if agree_any(topo, assemble_segment(item)):
                    break
            elif pipeline:
                while True:
                    try:
                        work_q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        if stop_event.is_set():
                            break  # a stop landed while waiting: discard this launch
            elif assemble_segment(item):
                break
            if max_segments is not None and dispatched >= max_segments:
                break
    finally:
        if pipeline:
            work_q.put(done_marker)
            worker.join()
    if worker_error[0] is not None:
        raise worker_error[0]

    if stats is not None:
        stats.update(st)
        stats["segments"] = n_assembled[0]
        stats["pipeline"] = pipeline
        stats["checkpoint_format"] = checkpoint_format if mgr is not None else None
    return full_history(res.copy())
