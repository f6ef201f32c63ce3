"""Multi-cell campaign topology: the UE axis split across the ranks of a process group.

Port of ``repro.core.topology``.  A ``(n_slots, n_ues)`` campaign is laid
out as ``n_cells`` equal contiguous cells, and its UE axis as ``n_shards``
equal contiguous blocks, one per rank of the default ``torch.distributed``
group (the reference's 1-D ``ues`` device mesh):

* **Layout** -- ``TopologySpec`` is the declarative form (the reference's
  fields, validation and JSON, so a spec hashes the same in both packages);
  ``CellTopology.build`` resolves it against a UE count and the group.
  ``make_ue_shards`` takes the group's world size (1 without a group), caps
  it at the request and reduces it to a divisor of the UE count.
* **Ranks** -- rank ``r < n_shards`` owns UE block ``r`` and keeps the global
  UE ids, so its keys are ``fold_in(fold_in(key, u), s)`` with the global
  ``u``; its per-UE policy rows, fault masks and cell ids are that block's.
  Ranks past the shard count hold no UEs and join no per-slot collective
  (the shards' subgroup is made once).  Each shard's trajectory is
  all-gathered once, after its loop, so every rank returns the whole
  campaign.
* **Per-shard compaction** -- GATED compaction, the scatter and the fused
  kernel see only the shard's UEs, so the engine's ``gated_capacity`` is
  the per-shard capacity (``per_shard_capacity``).
* **Cell coupling** -- per-cell offsets and inter-cell leakage enter the
  channel through ``repro_torch.phy.channel.CellParams``; the per-cell
  count vector is the slot's one collective (one ``all_reduce``, none with
  one shard), exact {0, 1} counts, so the trajectory does not depend on
  the split.

The port initialises no process group behind its caller: a caller that
wants ranks creates them (``spawn_ranks`` does so for tests and scripts).
NCCL serves ranks that each have a card; gloo serves the CPU and ranks that
share one card (NCCL takes no two ranks of one communicator on one device).
Both reduce the count vector where it lies, on the card or the CPU.

The reference's mesh factories (``make_cpu_mesh``, ``make_production_mesh``,
``make_ue_mesh``) build JAX device meshes and have no counterpart here by
name: ``CellTopology.build`` over the process group the caller made is
their counterpart (the group is the mesh's ``ues`` axis).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.phy.channel import CellParams, cell_params

#: collectives this module issued since the last ``reset_collective_counts``:
#: the per-slot ``all_reduce`` of the cell loads and the ``all_gather`` of
#: the shards' results
collective_counts: dict[str, int] = {"all_reduce": 0, "all_gather": 0}


def reset_collective_counts() -> None:
    for k in collective_counts:
        collective_counts[k] = 0


def _world() -> tuple[int, int]:
    """(world size, rank) of the default group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_device(device: torch.device) -> torch.device:
    """A rank's card: ``cuda:LOCAL_RANK % device_count`` (LOCAL_RANK, else the
    rank) when ``device`` names CUDA without an index inside a group of more
    than one rank; ``device`` itself otherwise."""
    world, rank = _world()
    if device.type != "cuda" or device.index is not None or world == 1:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_ue_shards(n_shards: int | None = None, *, n_ues: int | None = None) -> int:
    """The shard count: the default group's world size (1 without a group),
    capped at ``n_shards`` when given and reduced to a divisor of ``n_ues``."""
    world, _ = _world()
    n = world if n_shards is None else max(1, min(n_shards, world))
    if n_ues is not None:
        while n_ues % n:
            n -= 1
    return n


# -- the training meshes ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named device mesh as a descriptor: its axis names and sizes.  The
    sharding rules read only ``shape``; ``device_mesh()`` builds the
    ``torch.distributed`` ``DeviceMesh`` when the process group has exactly
    ``size`` ranks."""

    axis_names: tuple[str, ...]
    dims: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return int(np.prod(self.dims))

    def device_mesh(self, device_type: str = "cuda"):
        """``init_device_mesh`` over the default group, one rank a device.
        Raises ``ValueError`` naming both counts when the group (1 process
        without one) has another number of ranks, as ``jax.make_mesh`` raises
        on a host with too few devices."""
        world, _ = _world()
        if world != self.size:
            raise ValueError(f"the mesh {self.shape} needs {self.size} ranks; the default "
                             f"process group has {world}")
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, self.dims, mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production training meshes:

      single-pod: (16, 16)    = 256 devices, axes ("data", "model")
      multi-pod:  (2, 16, 16) = 512 devices, axes ("pod", "data", "model")
    """
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_cpu_mesh(n_data: int = 1, n_model: int = 1) -> MeshSpec:
    """A small ("data", "model") mesh for tests."""
    return MeshSpec(("data", "model"), (n_data, n_model))


# -- declarative topology -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """A campaign's cell and shard layout as data (JSON-stable, hashed).

    ``n_cells`` partitions the UE axis into equal contiguous cells; ``n_shards``
    is the rank request (None: every rank of the group; always reduced to
    what the group offers and to a divisor of ``n_ues``).
    ``cell_noise_offsets_db`` / ``cell_inr_offsets_db`` shift each cell's
    thermal noise / interference power (empty: none; else one entry a
    cell), and ``coupling`` is the inter-cell leakage coefficient.
    """

    n_cells: int = 1
    n_shards: int | None = None
    coupling: float = 0.0
    cell_noise_offsets_db: tuple = ()
    cell_inr_offsets_db: tuple = ()

    def __post_init__(self):
        for name in ("cell_noise_offsets_db", "cell_inr_offsets_db"):
            object.__setattr__(self, name, tuple(float(x) for x in getattr(self, name)))
            v = getattr(self, name)
            if v and len(v) != self.n_cells:
                raise ValueError(f"{name} has {len(v)} entries for n_cells={self.n_cells}")
        if self.n_cells < 1:
            raise ValueError(f"n_cells {self.n_cells} must be >= 1")
        if self.n_shards is not None and self.n_shards < 1:
            raise ValueError(f"n_shards {self.n_shards} must be >= 1")


#: the shards' subgroups, made once per shard count (every rank of the
#: default group takes part in making one, in the same order)
_SUBGROUPS: dict = {}


def _shard_group(n_shards: int):
    world, _ = _world()
    if n_shards == world:
        return dist.group.WORLD
    if n_shards not in _SUBGROUPS:
        _SUBGROUPS[n_shards] = dist.new_group(ranks=list(range(n_shards)))
    return _SUBGROUPS[n_shards]


@dataclasses.dataclass(frozen=True)
class CellTopology:
    """A ``TopologySpec`` resolved against a UE count and the process group."""

    spec: TopologySpec
    n_ues: int
    n_shards: int
    rank: int
    world_size: int
    cell_of_ue: np.ndarray  # (n_ues,) int32 global cell ids
    cell_params: CellParams  # on the CPU; moved to the engine's device per run
    group: Any = dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def build(cls, spec: TopologySpec, n_ues: int) -> "CellTopology":
        if n_ues % spec.n_cells:
            raise ValueError(f"n_cells={spec.n_cells} does not divide n_ues={n_ues}: cells "
                             "partition the UE axis into equal sub-batches")
        if spec.n_shards is not None and n_ues % spec.n_shards:
            raise ValueError(f"n_shards={spec.n_shards} does not divide n_ues={n_ues}: every "
                             "shard must carry the same number of UEs")
        world, rank = _world()
        n_shards = make_ue_shards(spec.n_shards, n_ues=n_ues)
        if world > 1 and n_shards == 1 and spec.n_shards != 1:
            raise ValueError(f"a group of {world} ranks resolves to one shard for {n_ues} UEs: "
                             "pass n_shards=1 to run one shard on purpose")
        ues_per_cell = n_ues // spec.n_cells
        return cls(
            spec=spec, n_ues=n_ues, n_shards=n_shards, rank=rank, world_size=world,
            cell_of_ue=(np.arange(n_ues) // ues_per_cell).astype(np.int32),
            cell_params=cell_params(spec.n_cells, ues_per_cell,
                                    noise_offsets_db=spec.cell_noise_offsets_db,
                                    inr_offsets_db=spec.cell_inr_offsets_db,
                                    coupling=spec.coupling),
            group=_shard_group(n_shards) if n_shards > 1 else None,
        )

    @property
    def n_cells(self) -> int:
        return self.spec.n_cells

    @property
    def ues_per_shard(self) -> int:
        return self.n_ues // self.n_shards

    @property
    def holds_ues(self) -> bool:
        """This rank runs a shard (ranks past the shard count only receive)."""
        return self.rank < self.n_shards

    def block(self, sharded: bool = True) -> tuple[int, int]:
        """This rank's UE range ``[lo, hi)`` (the whole axis unsharded)."""
        if not sharded or self.n_shards == 1:
            return 0, self.n_ues
        per = self.ues_per_shard
        return self.rank * per, (self.rank + 1) * per

    def gathers(self, sharded: bool = True) -> bool:
        """Whether a run ends in an all-gather: sharded over more than one rank."""
        return sharded and self.world_size > 1

    def slot_cells(self, device, sharded: bool = True) -> "SlotCells":
        """The slot loop's view: this rank's cell ids, the cell params on
        ``device`` and the cross-shard reduce of the cell loads (None with
        one shard)."""
        lo, hi = self.block(sharded)
        reduce = None
        if sharded and self.n_shards > 1:
            reduce = _count_reducer(self.group)
        return SlotCells(torch.as_tensor(self.cell_of_ue[lo:hi], dtype=torch.int64,
                                         device=device),
                         self.cell_params.to(device), reduce)


class SlotCells(NamedTuple):
    """What a slot needs of the topology: the shard's ``(U,)`` cell ids, the
    ``CellParams`` and the reduce of the ``(n_cells,)`` counts across shards
    (None: one shard, no collective)."""

    cell_of_ue: torch.Tensor
    params: CellParams
    reduce: Callable | None = None


def _count_reducer(group) -> Callable:
    """One ``all_reduce`` of the per-cell counts over the shards' group."""

    def reduce(load: torch.Tensor) -> torch.Tensor:
        collective_counts["all_reduce"] += 1
        dist.all_reduce(load, group=group)
        return load

    return reduce


def per_shard_capacity(capacity: int, n_shards: int) -> int:
    """Split a campaign-wide GATED capacity across shards (an equal share of
    at least one UE each, or raise)."""
    if capacity % n_shards:
        raise ValueError(f"gated_capacity={capacity} does not divide across n_shards="
                         f"{n_shards}: per-shard compaction needs an equal capacity-K "
                         "sub-batch on every shard")
    per_shard = capacity // n_shards
    if per_shard < 1:
        raise ValueError(f"gated_capacity={capacity} is < 1 per shard on n_shards={n_shards}: "
                         "every shard needs capacity for at least one UE (raise the capacity "
                         "or lower the shard count)")
    return per_shard


# -- gathering the shards' results ------------------------------------------------


def _rebuild(like: tuple, items) -> tuple:
    """A tuple (or NamedTuple) of ``like``'s type holding ``items``."""
    items = list(items)
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return _rebuild(tree, (_to_host(v) for v in tree))
    return tree


def _concat(parts: list, axis: int, device):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts], axis, device) for k in first}
    if isinstance(first, tuple):
        return _rebuild(first, (_concat([p[i] for p in parts], axis, device)
                                for i in range(len(first))))
    return torch.as_tensor(np.concatenate(parts, axis=axis)).to(device)


def all_gather_parts(topo: CellTopology, local) -> list:
    """Every shard's ``local`` (host data; None on a rank holding no UEs), in
    shard order, on every rank of the group: one collective."""
    collective_counts["all_gather"] += 1
    objs = [None] * topo.world_size
    dist.all_gather_object(objs, local)
    return objs[:topo.n_shards]


def agree_any(topo: CellTopology, flag: bool) -> bool:
    """Whether any rank's ``flag`` is set, on every rank (a stop decision the
    ranks must share)."""
    objs = [None] * topo.world_size
    dist.all_gather_object(objs, bool(flag))
    return any(objs)


def gather_shards(topo: CellTopology, local, axes: tuple[int, ...], device) -> tuple:
    """All-gather each shard's result (a tuple of trees whose UE axis is
    ``axes[i]``) in one collective over every rank of the group; ranks
    holding no UEs pass ``local=None`` and receive the whole campaign."""
    parts = all_gather_parts(topo, None if local is None else _to_host(local))
    return tuple(_concat([p[i] for p in parts], axis, device) for i, axis in enumerate(axes))


# -- sharded execution entries ----------------------------------------------------
#
# Each mirrors the corresponding ``BatchedPuschPipeline`` method: the schedule,
# the keys, the modes and the fault masks are resolved over the whole UE axis
# (the same on every rank), then each shard runs its block of the slot loop.
# With ``sharded=False`` the same cell-coupled program runs over the whole axis
# on this rank, with no collective.


def _prepare(engine, topo: CellTopology, schedule, n_slots: int, key, ue_keys, sharded):
    from repro_torch.phy.pipeline import resolve_schedule

    dev = engine.device
    profile, params = resolve_schedule(engine.cfg, schedule, n_slots, topo.n_ues, dev)
    keys = engine._ue_keys(key, ue_keys, topo.n_ues)
    lo, hi = topo.block(sharded)
    if params.noise_var.ndim == 2:  # per-UE schedules: the block's columns
        params = type(params)(*(x[:, lo:hi].contiguous() for x in params))
    return profile, params, keys[lo:hi].contiguous(), (lo, hi)


def _runs_here(topo: CellTopology, sharded: bool) -> bool:
    return not sharded or topo.holds_ues


def run_sharded(engine, topo: CellTopology, schedule, modes, *, n_slots: int, key=None,
                ue_keys=None, sharded: bool = True, faults=None):
    """Open-loop campaign over the topology: ``BatchedPuschPipeline.run``'s
    semantics, ``(final_link, trajectory)`` over the whole UE axis."""
    from repro_torch.phy.pipeline import init_device_link, normalize_modes

    dev = engine.device
    profile, params, keys, (lo, hi) = _prepare(engine, topo, schedule, n_slots, key,
                                               ue_keys, sharded)
    modes = normalize_modes(modes, n_slots, topo.n_ues, dev)
    local = None
    if _runs_here(topo, sharded):
        corrupt = None
        if faults is not None:
            corrupt = torch.as_tensor(
                np.ascontiguousarray(faults.resolve(n_slots, topo.n_ues).corrupt[:, lo:hi]),
                device=dev)
        local = engine._run_open(profile, init_device_link(hi - lo, dev), keys,
                                 modes[:, lo:hi].contiguous(), params, faults=faults,
                                 corrupt=corrupt, cells=topo.slot_cells(dev, sharded))
    if topo.gathers(sharded):
        return gather_shards(topo, local, (0, 1), dev)
    return local


def _policy_block(policy, lo: int, hi: int):
    """Exported tables are replicated; a per-UE assignment takes its block."""
    from repro_torch.core.closed_loop import PerUEPolicy

    if isinstance(policy, PerUEPolicy):
        return PerUEPolicy(tables=policy.tables, policy_idx=policy.policy_idx[lo:hi])
    return policy


def run_closed_loop_sharded(engine, topo: CellTopology, schedule, policy, sw_cfg, *,
                            n_slots: int, key=None, ue_keys=None, sharded: bool = True,
                            faults=None):
    """Closed-loop campaign over the topology: ``BatchedPuschPipeline.
    run_closed_loop``'s semantics, ``(final_link, final_switch_state,
    trajectory)`` over the whole UE axis."""
    from repro_torch.core.closed_loop import init_device_switch
    from repro_torch.phy.pipeline import init_device_link

    dev = engine.device
    profile, params, keys, (lo, hi) = _prepare(engine, topo, schedule, n_slots, key,
                                               ue_keys, sharded)
    local = None
    if _runs_here(topo, sharded):
        fault_masks = None
        if faults is not None:
            rf = faults.resolve(n_slots, topo.n_ues)
            fault_masks = tuple(torch.as_tensor(np.ascontiguousarray(m[:, lo:hi]), device=dev)
                                for m in (rf.decision_valid, rf.corrupt, rf.telemetry_valid))
        n = hi - lo
        sw0 = init_device_switch(n, len(sw_cfg.feature_names), sw_cfg, dev, faults=faults)
        local = engine._run_closed(profile, sw_cfg, init_device_link(n, dev), sw0, keys,
                                   params, _policy_block(policy, lo, hi), n_slots,
                                   faults=faults, fault_masks=fault_masks,
                                   cells=topo.slot_cells(dev, sharded))
    if topo.gathers(sharded):
        return gather_shards(topo, local, (0, 0, 1), dev)
    return local


def run_perturbed_sharded(engine, topo: CellTopology, schedule, rho, *, n_slots: int,
                          key=None, ue_keys=None, sharded: bool = True):
    """Methodology stage 1 over the topology: the rho grid rides the UE axis,
    so it shards with the UEs.  ``(final_link, trajectory)``."""
    dev = engine.device
    rho = torch.as_tensor(np.asarray(rho, np.float32)).to(dev)
    if rho.shape[0] != topo.n_ues:
        raise ValueError(f"rho {tuple(rho.shape)} vs topology n_ues {topo.n_ues}")
    profile, params, keys, (lo, hi) = _prepare(engine, topo, schedule, n_slots, key,
                                               ue_keys, sharded)
    local = None
    if _runs_here(topo, sharded):
        local = engine._run_perturbed(profile, keys, rho[lo:hi].contiguous(), params,
                                      n_slots, cells=topo.slot_cells(dev, sharded))
    if topo.gathers(sharded):
        return gather_shards(topo, local, (0, 1), dev)
    return local


# -- ranks for tests and scripts ---------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(n_ranks: int, device: str) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device == "cuda" and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, args, n_ranks, backend, port, device, results):
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n_ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        results.put((rank, fn(rank, *args)))
    finally:
        dist.destroy_process_group()


#: seconds ``spawn_ranks`` waits for every rank's result
SPAWN_TIMEOUT_S = 600.0


def spawn_ranks(fn, n_ranks: int, args: tuple = (), *, device: str = "cpu",
                backend: str | None = None) -> list:
    """Run ``fn(rank, *args)`` in ``n_ranks`` spawned processes joined in one
    group (``tcp://127.0.0.1``, a free port; gloo or NCCL per
    ``default_backend``), each with one CPU thread and, on the card, device
    ``rank % device_count``; return each rank's result, in rank order.
    ``fn`` must be importable by name (a module-level function).  Every
    process is joined before this returns or raises (at the latest after
    ``SPAWN_TIMEOUT_S``)."""
    import torch.multiprocessing as mp

    backend = backend or default_backend(n_ranks, device)
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(fn, args, n_ranks, backend, free_port(), device, results),
        nprocs=n_ranks, join=False, start_method="spawn")
    out: dict[int, Any] = {}
    try:
        import time

        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while len(out) < n_ranks:
            if not results.empty():
                rank, value = results.get()
                out[rank] = value
                continue
            if procs.join(timeout=0.1):  # every process exited
                while not results.empty():
                    rank, value = results.get()
                    out[rank] = value
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n_ranks} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join()
    if len(out) < n_ranks:
        raise RuntimeError(f"ranks {sorted(set(range(n_ranks)) - set(out))} returned nothing")
    return [out[r] for r in range(n_ranks)]
