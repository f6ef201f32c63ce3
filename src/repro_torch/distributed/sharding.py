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
one per mesh dimension; ``local_shape`` is the shard a device holds.

The sharded step runs on ``torch.distributed.tensor`` (DTensor) over a
``DeviceMesh`` whose dimension names are the mesh's axis names.  Where the
reference hints XLA's SPMD partitioner with ``with_sharding_constraint``,
``constrain`` redistributes a DTensor to the spec's placements under
``mesh_context`` (the collective the partitioner would insert: an
all-reduce of a partial sum, a reduce-scatter, an all-gather); on a plain
tensor it is the identity, so every one-device path is unchanged.
``distribute`` places a tree by its specs, ``gather_fsdp`` gathers a
weight's ``pod``/``data`` shards at its use and keeps its ``model`` shard
(under autograd its gradient leaves as a reduce-scatter), and ``local``
runs a function on the local shards where the work is local (attention
per batch and head shard, the vocabulary-parallel cross-entropy).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping, NamedTuple, Sequence

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
    tuples do.  An axis of size 1 is ``Replicate()``: a split over one device
    is its whole (and DTensor refuses a view that merges a dim it calls
    sharded)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.axis_names)
    where: dict[str, int] = {}
    for d, entry in enumerate(pspec):
        dims = [names.index(ax) for ax in _axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"{pspec}: dim {d}'s mesh axes are not in the mesh's order {names}")
        where.update((ax, d) for ax in _axes(entry))
    sizes = mesh.shape
    return tuple(Shard(where[ax]) if ax in where and sizes[ax] > 1 else Replicate()
                 for ax in names)


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


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (the sharded step's tensors)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _Axes(NamedTuple):
    """A mesh as the rules read one: axis names and sizes."""

    axis_names: tuple[str, ...]
    dims: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))


def mesh_axes(device_mesh: Any) -> _Axes:
    """A ``DeviceMesh`` as the rules read a mesh (its dimension names are
    the axis names)."""
    return _Axes(tuple(device_mesh.mesh_dim_names), tuple(device_mesh.shape))


class _Constrain(torch.autograd.Function):
    """Redistribute to ``want`` and constrain the gradient to ``want`` too, as
    the transpose of ``with_sharding_constraint`` constrains the cotangent
    (a partial-sum gradient is reduced there, where the reference's
    partitioner reduces it)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def constrain(x: torch.Tensor, logical_axes: Sequence[str | None]) -> torch.Tensor:
    """Redistribute a DTensor to the placements of ``logical_axes`` under the
    mesh context, and its gradient to the same placements (the reference's
    ``with_sharding_constraint`` and its transpose); the identity on a plain
    tensor or without a mesh context."""
    ctx = current_mesh_rules()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    want = placements(spec(x.shape, logical_axes, mesh, rules), mesh)
    if tuple(x.placements) == want and not x.requires_grad:
        return x
    return _Constrain.apply(x, want)


def map_tree(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of a tree of dicts, lists, tuples and
    NamedTuples and the matching nodes of ``rest`` (``None`` kept)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def distribute(tree: Any, specs: Any, device_mesh: Any) -> Any:
    """Each leaf of ``tree`` as a DTensor placed by its spec on
    ``device_mesh``.  A plain leaf is one every rank holds whole: each rank
    keeps a copy of its shard, with no collective.  A ``meta`` leaf becomes
    a DTensor over a ``meta`` shard (the planner's arguments).  A DTensor
    leaf is redistributed to its spec."""
    from torch.distributed.tensor import DTensor

    mesh = mesh_axes(device_mesh)

    def one(t: torch.Tensor, s: Sequence[MeshAxes]) -> Any:
        pl = placements(s, mesh)
        if is_dtensor(t):
            return t if tuple(t.placements) == pl else t.redistribute(device_mesh, pl)
        if t.is_meta:
            shard = torch.empty(local_shape(t.shape, s, mesh), dtype=t.dtype, device="meta")
            return DTensor.from_local(shard, device_mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return _keep_shard(t, device_mesh, pl)

    return map_tree(one, tree, specs)


def _keep_shard(t: torch.Tensor, device_mesh: Any, pl: tuple) -> Any:
    """``t`` (whole on every rank) as a DTensor of placements ``pl``, each
    rank keeping a copy of its own shard, so ``t`` can be freed."""
    from torch.distributed.tensor import distribute_tensor

    out = distribute_tensor(t.detach(), device_mesh, pl, src_data_rank=None)
    if not t.is_meta and out.to_local().untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        out = from_local_like(out.to_local().clone(), out)
    return out


#: the mesh axes a weight is sharded on FSDP-style (gathered at use)
FSDP_AXES = ("pod", "data")


def gather_fsdp(tree: Any) -> Any:
    """Every DTensor leaf with its ``pod``/``data`` shards gathered and its
    ``model`` shard kept: a weight at its use, as the partitioner gathers
    an FSDP-sharded weight.  Under autograd the gradient goes back through
    the same redistribute, a reduce-scatter onto the shards.  Plain tensors
    pass through."""
    from torch.distributed.tensor import Replicate

    def one(w: Any) -> Any:
        if not is_dtensor(w):
            return w
        names = w.device_mesh.mesh_dim_names
        want = tuple(Replicate() if n in FSDP_AXES else p for n, p in zip(names, w.placements))
        return w if want == tuple(w.placements) else w.redistribute(w.device_mesh, want)

    return map_tree(one, tree)


def _grad_placements(arg: Any, outs: Sequence[tuple]) -> tuple:
    """The placements of ``arg``'s gradient out of a local function: its own,
    but ``Partial`` on a mesh dim where ``arg`` is replicated and an output
    is not (each rank then used only its part of the replica)."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(
        Partial() if isinstance(p, Replicate) and any(not isinstance(o[i], Replicate)
                                                      for o in outs) else p
        for i, p in enumerate(arg.placements))


def local(fn, *args: Any, out: Any):
    """``fn`` over the local shards of its DTensor arguments (plain
    arguments pass as they are); each tensor it returns becomes a DTensor
    on the arguments' mesh with the placements ``out`` gives for it (one
    tuple of placements, or one per output, ``None`` for a ``None``
    output).  Without a DTensor argument, ``fn(*args)``.  ``to_local`` and
    ``from_local`` carry gradients: an argument replicated on a mesh dim
    along which an output is split gets a ``Partial`` gradient there, the
    sum of what each rank's part used."""
    from torch.distributed.tensor import DTensor, Replicate

    meshes = [a.device_mesh for a in args if is_dtensor(a)]
    if not meshes:
        return fn(*args)
    from repro_torch.distributed.accounting import local_scope

    single = not isinstance(out[0], (tuple, type(None)))
    outs = [out] if single else [o for o in out if o is not None]
    mesh = meshes[0]
    n_splits = math.prod(mesh.size(i) for i in range(mesh.ndim)
                         if any(not isinstance(o[i], Replicate) for o in outs))
    with local_scope(n_splits):
        res = fn(*(a.to_local(grad_placements=_grad_placements(a, outs)) if is_dtensor(a) else a
                   for a in args))
    if single:
        return DTensor.from_local(res, mesh, out, run_check=False)
    return type(res)(None if r is None else DTensor.from_local(r, mesh, pl, run_check=False)
                     for r, pl in zip(res, out, strict=True))


def _extent(size: int, dim: int, pl: Sequence, device_mesh: Any) -> tuple[int, int]:
    """``(offset, size)`` of this rank's part of a dim of ``size`` placed by
    ``pl``: a dim split over several mesh dims is split in mesh-dim order,
    the first the major one."""
    from torch.distributed.tensor import Shard

    off = 0
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            size //= device_mesh.size(i)
            off += device_mesh.get_local_rank(i) * size
    return off, size


def shard_offset(x: Any, dim: int) -> int:
    """The global index of the first element of this rank's shard of
    DTensor ``x`` along ``dim`` (0 for a plain tensor)."""
    if not is_dtensor(x):
        return 0
    return _extent(x.shape[dim], dim, x.placements, x.device_mesh)[0]


def place(t: torch.Tensor, logical_axes: Sequence[str | None], like: Any) -> Any:
    """A tensor every rank holds whole (positions, a constant table) placed
    by ``logical_axes`` on ``like``'s mesh, each rank keeping its shard (no
    collective); ``t`` itself when ``like`` is a plain tensor or ``t`` is a
    DTensor already."""
    from torch.distributed.tensor import distribute_tensor

    ctx = current_mesh_rules()
    if ctx is None or not is_dtensor(like) or is_dtensor(t):
        return t
    mesh, rules = ctx
    pl = placements(spec(t.shape, logical_axes, mesh, rules), mesh)
    return distribute_tensor(t.detach(), like.device_mesh, pl, src_data_rank=None)


def replicated(x: Any) -> Any:
    """A DTensor redistributed to ``Replicate`` on every mesh dim (a partial
    sum all-reduced, shards all-gathered); a plain tensor as it is."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(x):
        return x
    want = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def local_value(x: Any) -> Any:
    """A DTensor's local shard (the whole value of a replicated one); a
    plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def from_local_like(t: torch.Tensor, like: Any) -> Any:
    """``t``, a local shard shaped as ``like``'s, as a DTensor placed as ``like``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def whole(x: Any) -> Any:
    """A DTensor's full value on every rank (an all-gather of its shards); a
    plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def shard_like(t: torch.Tensor, like: Any) -> Any:
    """The full value ``t``, which every rank holds, placed as DTensor
    ``like``: each rank keeps a copy of its shard (no collective)."""
    return _keep_shard(t, like.device_mesh, tuple(like.placements))


def block(shape: Sequence[int], logical_axes: Sequence[str | None], like: Any):
    """The placements of a tensor of ``shape`` placed by ``logical_axes`` on
    DTensor ``like``'s mesh (under the mesh context), and this rank's block
    of it: ``(offset, size)`` along each dim."""
    mesh, rules = current_mesh_rules()
    pl = placements(spec(shape, logical_axes, mesh, rules), mesh)
    return pl, [_extent(size, dim, pl, like.device_mesh) for dim, size in enumerate(shape)]
