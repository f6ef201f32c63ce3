"""Parameter definition trees (port of ``repro.models.params``): one source
of truth for shapes, logical axes and initialization.

Every model module builds a nested dict of ``ParamDef`` leaves; from that
one tree come (a) real weights (``materialize``), (b) tensors on the
``meta`` device with the shapes and dtype and no storage (``abstract``),
the planner's stand-in for the reference's ``ShapeDtypeStruct`` trees, and
(c) the partition specs and placements of every leaf on a mesh
(``pspecs``, ``shardings``), structurally consistent by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.distributed.sharding import PartitionSpec, ShardingRules, placements
from repro_torch.distributed.sharding import spec as _spec

#: elements drawn at once by ``materialize``: the threefry draw holds a few
#: int64 temporaries of a chunk's size, so a 300M-element leaf would need
#: gigabytes at once; a chunk is 128 MiB of int64
DRAW_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axes, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | small
    scale: float | None = None  # overrides fan-in scale

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def tree_map_defs(fn: Callable[[ParamDef], Any], tree: Any) -> Any:
    """Map over ParamDef leaves of a nested dict/list tree."""
    if is_def(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_defs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_defs(fn, v) for v in tree)
    raise TypeError(f"unexpected node {type(tree)}")


def _normal(key: torch.Tensor, shape: tuple[int, ...], scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """``(normal(key, shape) * scale).astype(dtype)``, drawn in chunks of the
    flat index: an element's bits depend only on the key and its index, so
    the chunks give the bits one draw would."""
    n = int(np.prod(shape)) if shape else 1
    out = torch.empty(n, dtype=dtype, device=key.device)
    for start in range(0, n, DRAW_CHUNK):
        count = min(DRAW_CHUNK, n - start)
        out[start:start + count] = (jr.normal(key, (count,), offset=start) * scale).to(dtype)
    return out.reshape(shape)


def materialize(key: torch.Tensor, defs: Any, dtype: torch.dtype = torch.float32) -> Any:
    """Real params on ``key``'s device, drawn as the reference draws them: one
    ``split`` over the leaves in tree order, float32 normals times the
    fan-in scale, then a cast to ``dtype``."""
    leaves: list[ParamDef] = []
    tree_map_defs(leaves.append, defs)
    keys = jr.split(key, max(len(leaves), 1))
    it = iter(range(len(leaves)))
    dev = key.device

    def init_one(d: ParamDef) -> torch.Tensor:
        i = next(it)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        fan_in = d.shape[0] if d.shape else 1
        if len(d.shape) >= 2:
            fan_in = int(np.prod(d.shape[:-1]))
        s = d.scale if d.scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
        if d.init == "small":
            s = 0.02
        return _normal(keys[i], d.shape, float(s), dtype)

    return tree_map_defs(init_one, defs)


def abstract(defs: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """The params as ``meta`` tensors: shapes and dtype, no storage."""
    return tree_map_defs(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def pspecs(defs: Any, mesh: Any, rules: ShardingRules) -> Any:
    """PartitionSpec tree matching the params tree."""
    return tree_map_defs(lambda d: _spec(d.shape, d.axes, mesh, rules), defs)


class NamedSharding(NamedTuple):
    """A leaf's layout on a mesh: its spec, its ``torch.distributed.tensor``
    placements (one per mesh dimension) and the ``DeviceMesh`` they apply
    to, or ``None`` where the process group cannot build one."""

    mesh: Any
    spec: PartitionSpec
    placements: tuple
    device_mesh: Any


def shardings(defs: Any, mesh: Any, rules: ShardingRules) -> Any:
    """``NamedSharding`` tree matching the params tree; the ``DeviceMesh``
    comes from ``mesh.device_mesh()`` when the default process group has
    ``mesh.size`` ranks."""
    try:
        device_mesh = mesh.device_mesh()
    except ValueError:
        device_mesh = None

    def one(d: ParamDef) -> NamedSharding:
        s = _spec(d.shape, d.axes, mesh, rules)
        return NamedSharding(mesh, s, placements(s, mesh), device_mesh)

    return tree_map_defs(one, defs)


def count_params(defs: Any) -> int:
    total = 0

    def add(d: ParamDef):
        nonlocal total
        total += int(np.prod(d.shape)) if d.shape else 1

    tree_map_defs(add, defs)
    return total
