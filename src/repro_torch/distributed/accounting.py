"""What one device does in a sharded step: its collectives, FLOPs, bytes
accessed and live memory, counted as the step runs.

``StepAccount`` is a ``TorchDispatchMode``.  It lets DTensor's dispatch run
first (it returns ``NotImplemented`` on a DTensor operation), so it sees the
local operations each rank runs on its shards, and among them the
collectives DTensor issues (``_c10d_functional``).  The same counter runs
in a real process group (gloo on the CPU or beside the card) and in the
planner's fake group over ``meta`` shards (``launch/dryrun.py``), so the two
count the same things:

* ``collectives``: operand bytes by the reference's five HLO kinds
  (``repro/launch/dryrun.py`` ``_COLLECTIVES``): ``all_gather_into_tensor``
  is an all-gather, ``all_reduce`` an all-reduce, ``reduce_scatter_tensor``
  a reduce-scatter, ``all_to_all_single`` (and DTensor's
  ``shard_dim_alltoall``) an all-to-all; the port issues no point-to-point
  transfer, so collective-permute stays 0.  Any other collective raises.
* ``flops``: the products' FLOPs (``torch.utils.flop_counter``'s formulas,
  as ``FlopCounterMode`` counts them) on local shapes.  ``global_flops`` is
  the step's FLOPs over all devices, each product once: a DTensor product
  counted on its global shapes, and a product inside a local function
  (``sharding.local``) counted on its local shapes times the number of
  devices over which that function's outputs are split (``local_scope``).
* ``bytes_accessed``: every operation's local operands plus its results,
  views excluded, unfused: each operation reads its inputs from memory and
  writes its outputs back (XLA's count is of a fused program).
* DTensor's sharding propagation runs each new operation once on global
  fake tensors to learn its output's shape; those runs are not the
  device's work and are not counted.
* ``peak_bytes``: the most bytes of live local storage at any point, the
  arguments registered with ``hold`` included.  A storage is live from the
  operation that makes it until its last tensor is freed (a finalizer on
  the storage).
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: the reference's collective kinds, in its order
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")
#: functional-collective ops that move no data
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


_scope = threading.local()


@contextlib.contextmanager
def local_scope(n_splits: int):
    """Mark the operations run inside as a local function's, whose outputs
    are split over ``n_splits`` devices (``sharding.local`` enters it)."""
    prev = getattr(_scope, "n", None)
    _scope.n = n_splits
    try:
        yield
    finally:
        _scope.n = prev


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepAccount(TorchDispatchMode):
    """Counts a device's collectives, FLOPs, bytes accessed and live bytes
    while it is entered (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.collectives = dict.fromkeys(KINDS, 0)
        self.flops = 0
        self.global_flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak_bytes = 0
        self._storages: dict[int, int] = {}

    # -- live storage --------------------------------------------------------------
    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        size = st.nbytes()
        self._storages[key] = size
        self.live += size
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def hold(self, tree: Any) -> int:
        """Register the local storages of a tree's tensors (DTensors' shards)
        as live; returns their bytes (each storage once)."""
        before = self.live
        for t in _tensors(tree):
            self._add(_local(t))
        return self.live - before

    @staticmethod
    def storage_bytes(tree: Any) -> dict[int, int]:
        """``{storage: bytes}`` of a tree's local storages."""
        out = {}
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            out[st._cdata] = st.nbytes()
        return out

    # -- dispatch --------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if func._overloadpacket in flop_registry:  # on the global shapes
                self.global_flops += int(flop_registry[func._overloadpacket](*args, **kwargs))
            return NotImplemented  # let DTensor run; its local operations come back here
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in _tensors(out)):
            return out  # DTensor's shape propagation on global fake tensors: no device work
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NS and name not in _NOT_COLLECTIVES:
            kind = _KIND_OF.get(name)
            if kind is None:
                raise NotImplementedError(f"no collective kind for {func}")
            self.collectives[kind] += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        if func._overloadpacket in flop_registry:
            f = int(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
            self.flops += f
            n_splits = getattr(_scope, "n", None)
            if n_splits is not None:
                self.global_flops += f * n_splits
        if not func.is_view and name not in _NOT_COLLECTIVES:
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._add(t)
        return out

    def record(self, arg_storages: dict[int, int], out_storages: dict[int, int]) -> dict:
        """The planner's fields: collective bytes by kind and their sum, FLOPs,
        bytes accessed, the peak, and the peak less the arguments' and the
        outputs' storages (each storage once)."""
        held = {**arg_storages, **out_storages}
        return {
            "collective_bytes_per_device": dict(self.collectives),
            "collective_bytes_total": int(sum(self.collectives.values())),
            "flops_per_device": float(self.flops),
            "flops_total": int(self.global_flops),
            "bytes_accessed_per_device": float(self.bytes_accessed),
            "peak_hbm_per_device": int(self.peak_bytes),
            "temp_bytes_per_device": int(max(self.peak_bytes - sum(held.values()), 0)),
        }
