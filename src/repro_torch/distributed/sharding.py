"""Logical-axis sharding rules (DP/FSDP/TP/EP) for the model zoo (port of
``repro.distributed.sharding``).

Weights, caches and inputs are annotated with *logical* axis names; a rules
table maps them to mesh axes.  The production meshes (``core/topology.py``):

  single-pod  (16, 16)      axes ("data", "model")
  multi-pod   (2, 16, 16)   axes ("pod", "data", "model")

Default placement (MaxText-style 2-D sharding), as the reference's:
  * "batch"    -> ("pod", "data")   pure DP across pods, DP within pod
  * "embed"    -> "data"            FSDP: weight d_model dim sharded on data
  * "heads"/"ff"/"experts"/"vocab" -> "model"   tensor/expert parallelism
  * "kv_heads" -> "model" when divisible (GQA kv=8 < model=16 replicates)

``spec`` drops any mapping that does not divide the dimension (batch=1
long-context cells, kv_heads=8 on model=16), uses each mesh axis at most
once and takes a prefix of a tuple of mesh axes, so every (arch x shape x
mesh) cell gets a valid ``PartitionSpec`` with no per-arch special case.
It reads only ``mesh.shape``, a mapping from axis name to size.

``placements`` turns a spec into ``torch.distributed.tensor`` placements,
one per mesh dimension; ``local_shape`` is the shard a device holds.  The
port has no SPMD partitioner: ``constrain`` is the identity, and the
placements serve the planner (``launch/dryrun.py``) and
``DTensor.from_local`` / ``distribute_tensor`` where a mesh of that many
ranks exists.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping, Sequence

import torch

MeshAxes = tuple[str, ...] | str | None

DEFAULT_RULES: dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": "data",  # FSDP on weight d_model dims
    "embed_act": None,  # activation d_model stays unsharded (TP on heads/ff)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "vocab": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
    "layers": None,
    "frames": None,
    "moe_tokens": ("pod", "data"),
    "moe_cap": ("pod", "data"),
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of mesh axis names (split over their product, the first
    the major one).  A tuple: it compares equal to a tuple of its entries."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    table: Mapping[str, MeshAxes]

    def mesh_axes_for(self, logical: str | None) -> MeshAxes:
        if logical is None:
            return None
        if logical not in self.table:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.table[logical]


def make_rules(overrides: Mapping[str, MeshAxes] | None = None) -> ShardingRules:
    table = dict(DEFAULT_RULES)
    if overrides:
        table.update(overrides)
    return ShardingRules(table=table)


def spec(shape: Sequence[int], logical_axes: Sequence[str | None], mesh: Any,
         rules: ShardingRules) -> PartitionSpec:
    """Build a PartitionSpec, dropping non-divisible / absent mesh axes."""
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {shape} vs axes {logical_axes}")
    used: set[str] = set()
    out = []
    for dim, logical in zip(shape, logical_axes):
        mesh_axes = rules.mesh_axes_for(logical)
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        picked = []
        prod = 1
        for ax in mesh_axes:
            if ax not in mesh.shape or ax in used:
                continue
            n = mesh.shape[ax]
            if dim % (prod * n) == 0:
                picked.append(ax)
                prod *= n
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return P(*out)


def _axes(entry: MeshAxes) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(pspec: Sequence[MeshAxes], mesh: Any) -> tuple:
    """``torch.distributed.tensor`` placements of ``pspec`` on ``mesh``: one per
    mesh dimension, in the mesh's axis order, ``Shard(d)`` where tensor dim
    ``d`` names that mesh axis and ``Replicate()`` elsewhere.  A dim split
    over ``("pod", "data")`` is ``Shard(d)`` on both mesh dims; DTensor
    splits a dim sharded on several mesh dims in mesh-dim order, the first
    mesh dim the major one, which is JAX's major-to-minor order for a tuple
    of mesh axes when the tuple follows the mesh's order, as the rules'
    tuples do."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.axis_names)
    where: dict[str, int] = {}
    for d, entry in enumerate(pspec):
        dims = [names.index(ax) for ax in _axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"{pspec}: dim {d}'s mesh axes are not in the mesh's order {names}")
        where.update((ax, d) for ax in _axes(entry))
    return tuple(Shard(where[ax]) if ax in where else Replicate() for ax in names)


def local_shape(shape: Sequence[int], pspec: Sequence[MeshAxes], mesh: Any) -> tuple[int, ...]:
    """The largest shard a device holds of a tensor of ``shape`` placed by
    ``pspec`` (every device's, when the spec divides, as ``spec`` makes it)."""
    out = []
    for dim, entry in zip(shape, tuple(pspec) + (None,) * (len(shape) - len(pspec))):
        n = math.prod(mesh.shape[ax] for ax in _axes(entry))
        out.append(-(-dim // n))
    return tuple(out)


def local_bytes(t: torch.Tensor, pspec: Sequence[MeshAxes], mesh: Any) -> int:
    """Bytes of the largest shard of ``t`` (any device, ``meta`` included)."""
    return math.prod(local_shape(t.shape, pspec, mesh)) * t.element_size()


# -- mesh context so model code can ask for the rules without plumbing -------

_ctx = threading.local()


@contextlib.contextmanager
def mesh_context(mesh: Any, rules: ShardingRules):
    prev = getattr(_ctx, "value", None)
    _ctx.value = (mesh, rules)
    try:
        yield
    finally:
        _ctx.value = prev


def current_mesh_rules() -> tuple[Any, ShardingRules] | None:
    return getattr(_ctx, "value", None)


def constrain(x: torch.Tensor, logical_axes: Sequence[str | None]) -> torch.Tensor:
    """The identity.  The reference applies ``with_sharding_constraint`` here
    under a mesh context, a hint to XLA's SPMD partitioner; the port has no
    SPMD partitioner, so there is nothing to hint."""
    return x
