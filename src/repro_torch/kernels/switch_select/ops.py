"""The expert switch: the wrappers of the hand-written kernels and their plain
PyTorch versions.

``switch_select(mode, outputs, designated_idx=0)`` replaces
``repro.kernels.switch_select.ops.switch_select``: ``outputs`` lists one
output per expert, designated expert first, each a tensor or a pytree of
tensors (dicts, lists, tuples, NamedTuples) of one structure.  With a
scalar ``mode`` (a Python int or a 0-d tensor) the designated buffer ends
up holding expert ``mode``'s whole output (the single-UE host loop); with
an ``(U,)`` vector every tensor carries a leading UE axis and UE ``u``
receives expert ``modes[u]``'s slice (the batched engine).  A pytree is
switched leaf by leaf, one launch a leaf, as the reference maps its
``pallas_call`` over the leaves: ``switch_select_leaf`` (scalar),
``switch_select_batched_leaf`` (per UE) and ``switch_gather_batched_leaf``
(the scatter) are the one-leaf entries, and ``*_tree_ref`` their plain
versions over pytrees.

The per-UE switch is out of place on every device: on a CUDA tensor one
launch of ``csrc/switch_select.cu`` writes a new tensor and leaves every
expert output as it was, as ``repro`` does; a mode that names no expert
keeps the designated slice.  The scalar switch works **in place in the
designated tensor** and returns it: mode 0 costs a launch whose blocks
return at once, the others copy their alternative.  It takes an int mode
by value (nothing is uploaded) or a 0-d int32 mode on the card by pointer;
an int mode outside ``[0, n_experts)`` raises, and a mode on the card that
names no alternative keeps the designated buffer (the host bank hands it a
copy, so its ``all_outputs[0]`` stays unswitched).  On a CPU tensor the
plain versions ``switch_select_ref`` (scalar) and
``switch_select_batched_ref`` gather into a new tensor.

``switch_scatter(src, compact, designated)`` (tensors or pytrees) replaces
``repro.kernels.switch_select.ops.switch_scatter``, the GATED bank's
un-compaction: UE ``u`` takes row ``src[u]`` of the capacity-``K`` compact
sub-batch when ``src[u] >= 0`` and keeps its designated (fail-safe) slice
otherwise.  On a CUDA tensor the kernel's second entry point writes a new
tensor; on a CPU tensor, or with ``backend="ref"``, the plain version
``switch_gather_batched_ref`` does.  Neither touches its inputs.

The kernels only move bytes, so, like the reference's switch, they take any
real element type of 2, 4 or 8 bytes (bfloat16 and float16 logits of the LM
decoder, float32, int32, float64, int64) and complex64; a wrapper passes
byte counts, always even.  The plain versions are dtype-generic PyTorch and
return the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.kernels import build


def switch_select_ref(mode: int, outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of the scalar switch: stack the experts, take row ``mode``."""
    return torch.stack(list(outputs), dim=0)[mode]


def switch_select_batched_ref(modes: torch.Tensor,
                              outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: stack the experts and gather each UE's selection."""
    stacked = torch.stack(list(outputs), dim=0)  # (E, U, ...)
    idx = modes.to(torch.int64).reshape((1, -1) + (1,) * (stacked.ndim - 2))
    idx = idx.expand((1,) + tuple(stacked.shape[1:]))
    return torch.gather(stacked, 0, idx)[0]


def switch_gather_batched_ref(src: torch.Tensor, compact: torch.Tensor,
                              designated: torch.Tensor) -> torch.Tensor:
    """Plain version: gather each UE's compact row (``src`` clamped into
    range, as the reference does) and keep the designated buffer where
    ``src < 0``."""
    safe = src.to(torch.int64).clamp(0, compact.shape[0] - 1)
    taken = compact.index_select(0, safe)
    keep = (src < 0).reshape((-1,) + (1,) * (designated.ndim - 1))
    return torch.where(keep, designated, taken)


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of ``tree`` and the same leaves of
    ``rest``: nested dicts, lists, tuples and NamedTuples of tensors, or a
    bare tensor.  Structures that differ raise ``ValueError``, as
    ``jax.tree.map`` does."""
    if isinstance(tree, torch.Tensor):
        if not all(isinstance(r, torch.Tensor) for r in rest):
            raise ValueError("pytree structures differ: a tensor against a node")
        return fn(tree, *rest)
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or r.keys() != tree.keys() for r in rest):
            raise ValueError(f"pytree structures differ at a dict of keys {sorted(tree)}")
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if any(type(r) is not type(tree) or len(r) != len(tree) for r in rest):
            raise ValueError(f"pytree structures differ at a {type(tree).__name__} "
                             f"of {len(tree)}")
        leaves = [_tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else type(tree)(leaves)
    raise TypeError(f"switch outputs take tensors, dicts, lists and tuples, "
                    f"not {type(tree).__name__}")


def switch_select_tree_ref(mode, outputs: Sequence[Any]) -> Any:
    """Plain version over per-expert pytrees: expert ``mode``'s output."""
    return _tree_map(lambda *leaves: switch_select_ref(mode, leaves), *outputs)


def switch_select_batched_tree_ref(modes: torch.Tensor, outputs: Sequence[Any]) -> Any:
    """Per-UE plain version over per-expert pytrees with a leading UE axis."""
    return _tree_map(lambda *leaves: switch_select_batched_ref(modes, leaves), *outputs)


def switch_gather_batched_tree_ref(src: torch.Tensor, compact: Any, designated: Any) -> Any:
    """``switch_gather_batched_ref`` over per-expert pytrees, leaf by leaf."""
    return _tree_map(lambda c, d: switch_gather_batched_ref(src, c, d), compact, designated)


def _nbytes(x: torch.Tensor) -> int:
    """Bytes of a switch leaf: any real dtype of 2, 4 or 8 bytes (bfloat16,
    float16, float32, int32, float64, int64, ...), as the reference's switch
    passes every real dtype through, or complex64, which the kernels read
    through its own ``data_ptr()`` (no real view is made)."""
    dt = x.dtype
    if x.is_complex():
        if dt is not torch.complex64:
            raise TypeError(f"complex leaves must be complex64, got {dt}")
    elif dt is torch.bool or x.element_size() not in (2, 4, 8):
        raise TypeError(f"switch leaves take 2-, 4- or 8-byte real elements or "
                        f"complex64, got {dt}")
    _check_resolved(x)
    return x.numel() * x.element_size()


def _check_resolved(x: torch.Tensor) -> None:
    """A lazily conjugated or negated tensor's ``data_ptr()`` holds the values
    before the conjugation or negation: the kernels would read or write those."""
    if x.is_conj() or x.is_neg():
        raise TypeError("switch kernel needs resolved tensors: call resolve_conj() "
                        "and resolve_neg() first")


def _check_like(designated: torch.Tensor, alternatives: Sequence[torch.Tensor]) -> None:
    dtype, shape, device = designated.dtype, designated.shape, designated.get_device()
    for a in alternatives:
        if a.dtype is not dtype or a.shape != shape:
            raise ValueError("expert outputs must share shape and dtype")
        if a.get_device() != device:
            raise ValueError("expert outputs must share one device")


def _check_contiguous(alternatives: Sequence[torch.Tensor]) -> None:
    for a in alternatives:
        if not a.is_contiguous():
            raise ValueError("switch kernel needs contiguous alternatives")
        _check_resolved(a)


#: the most experts one launch of the per-UE switch takes (the kernel's table)
MAX_EXPERTS = 8
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (modes, expert pointer array, experts, out, n_ues, bytes per UE, stream)
_SELECT_ARGS = (_P, ctypes.POINTER(_P), _I, _P, _I, _L, _P)
#: (src, compact, designated, out, n_ues, bytes per UE, capacity, stream)
_GATHER_ARGS = (_P, _P, _P, _P, _I, _L, _I, _P)
#: (mode pointer or None, mode value, alternative, designated, bytes, wanted
#: mode, stream)
_SCALAR_ARGS = (_P, _I, _P, _P, _L, _I, _P)
#: per-UE switch signatures already validated: (experts, shape, dtype, device
#: index) -> (bytes per UE, the ctypes pointer-array type)
_SIGNATURES: dict[tuple, tuple[int, type]] = {}


def _scalar_mode(mode, designated: torch.Tensor) -> int | torch.Tensor:
    """A scalar mode as a Python int, or as a 0-d int32 tensor on the card."""
    if isinstance(mode, torch.Tensor):
        if mode.ndim != 0:
            raise ValueError(f"mode must be a scalar or (n_ues,), got {tuple(mode.shape)}")
        if mode.device.type == "cpu":
            return int(mode)
        if mode.device != designated.device:
            raise ValueError("mode and expert outputs must share one device")
        return mode
    if isinstance(mode, (int, np.integer)):
        return int(mode)
    raise TypeError(f"mode must be an int or a tensor, got {type(mode).__name__}")


def switch_select(mode: int | torch.Tensor, outputs: Sequence[Any],
                  designated_idx: int = 0) -> Any:
    """Zero-gap switch over a designated-first list of expert outputs.

    ``mode`` is a scalar (Python int, or a 0-d tensor) selecting one whole
    output, or an ``(U,)`` int32 vector selecting per UE along the leading
    axis.  A scalar mode returns the designated tensor, switched in place,
    on the card, and a new tensor on the CPU; a mode vector returns a new
    tensor on every device.  Pytree outputs are switched leaf by leaf, one
    launch a leaf.  ``designated_idx`` must be 0, as in the reference (the
    bank puts the designated expert first).

    The host loop calls this once a slot with an int mode and the batched
    engine once a slot with a mode vector, so both card paths are kept
    lean: each tensor is checked once, cheapest check first, and the launch
    passes ``data_ptr()`` ints and the raw stream.
    """
    if designated_idx != 0:
        raise ValueError("bank must place the designated expert first")
    batched = isinstance(mode, torch.Tensor) and mode.ndim == 1
    if not isinstance(outputs[0], torch.Tensor):
        leaf = switch_select_batched_leaf if batched else switch_select_leaf
        return _tree_map(lambda d, *alts: leaf(mode, alts, d), *outputs)
    if batched:
        return _switch_batched(mode, outputs)
    return _switch_scalar(mode, outputs)


def switch_select_leaf(mode: int | torch.Tensor, alternatives: Sequence[torch.Tensor],
                       designated: torch.Tensor) -> torch.Tensor:
    """The scalar switch of one leaf: ``mode`` 0 keeps ``designated``, ``k``
    takes ``alternatives[k - 1]``; in place in ``designated`` on the card."""
    return _switch_scalar(mode, [designated, *alternatives])


def switch_select_batched_leaf(modes: torch.Tensor, alternatives: Sequence[torch.Tensor],
                               designated: torch.Tensor) -> torch.Tensor:
    """The per-UE switch of one leaf with a leading UE axis, out of place."""
    return _switch_batched(modes, [designated, *alternatives])


def _switch_scalar(mode: int | torch.Tensor, outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The scalar switch of one tensor, in place in the designated one on the card."""
    designated, *alternatives = outputs
    if not alternatives:
        raise ValueError("the switch needs at least two expert outputs")
    _check_like(designated, alternatives)
    if type(mode) is not int:
        mode = _scalar_mode(mode, designated)
    on_card = isinstance(mode, torch.Tensor)
    if not on_card and not 0 <= mode < len(outputs):
        raise ValueError(f"mode {mode} outside [0, {len(outputs)})")
    if not designated.is_cuda:
        return switch_select_ref(mode, outputs)
    if on_card and mode.dtype is not torch.int32:
        raise TypeError(f"a mode on the card must be int32, got {mode.dtype}")
    n_bytes = _nbytes(designated)
    if not designated.is_contiguous():
        raise ValueError("switch kernel needs a contiguous designated buffer")
    _check_contiguous(alternatives)
    fn = build.function("switch_select", "switch_select_scalar_launch", _SCALAR_ARGS)
    mode_ptr, mode_value = (mode.data_ptr(), 0) if on_card else (None, mode)
    des, stream = designated.data_ptr(), build.stream(designated)
    for k, a in enumerate(alternatives, 1):
        build.check(fn(mode_ptr, mode_value, a.data_ptr(), des, n_bytes, k, stream),
                    "switch_select_scalar")
        build.launch_counts["switch_select"] += 1
    return designated


def _switch_batched(modes: torch.Tensor, outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-UE switch, out of place: UE ``u`` receives expert ``modes[u]``'s slice."""
    des = outputs[0]
    if len(outputs) < 2:
        raise ValueError("the switch needs at least two expert outputs")
    if modes.shape[0] != des.shape[0]:
        raise ValueError(f"modes {tuple(modes.shape)} vs UE axis {des.shape[0]}")
    dev = des.get_device()
    if modes.get_device() != dev:
        raise ValueError("modes and expert outputs must share one device")
    if dev < 0:
        _check_like(des, outputs[1:])
        return switch_select_batched_ref(modes, outputs)
    shape, dtype = des.shape, des.dtype
    sig = (len(outputs), shape, dtype, dev)
    known = _SIGNATURES.get(sig)
    if known is None:  # what the signature alone decides, checked once
        if len(outputs) > MAX_EXPERTS:
            raise ValueError(f"the per-UE switch takes at most {MAX_EXPERTS} experts, "
                             f"not {len(outputs)}")
        known = _SIGNATURES[sig] = (_nbytes(des) // max(shape[0], 1), _P * len(outputs))
    row_bytes, table = known
    if modes.dtype is not torch.int32 or not modes.is_contiguous():
        raise TypeError(f"modes must be contiguous int32, got {modes.dtype}")
    for a in outputs:  # what each call's tensors must match
        if a.dtype is not dtype or a.shape != shape:
            raise ValueError("expert outputs must share shape and dtype")
        if a.get_device() != dev:
            raise ValueError("expert outputs must share one device")
        if not a.is_contiguous():
            raise ValueError("switch kernel needs contiguous expert outputs")
        if a.is_conj() or a.is_neg():
            _check_resolved(a)
    out = build.unfilled(torch.empty_like, des)
    fn = build.function("switch_select", "switch_select_launch", _SELECT_ARGS)
    build.check(fn(modes.data_ptr(), table(*[a.data_ptr() for a in outputs]), len(outputs),
                   out.data_ptr(), shape[0], row_bytes, build.stream(des)), "switch_select")
    build.launch_counts["switch_select_batched"] += 1
    return out


_BACKENDS = ("auto", "pallas", "cuda", "ref")
#: scatter signatures already validated: (src shape, compact shape, designated
#: shape, dtype, device) -> (bytes per UE, the kernel's ctypes function)
_SCATTER_SIGNATURES: dict[tuple, tuple[int, ctypes._CFuncPtr]] = {}


def _check_scatter(src: torch.Tensor, compact: torch.Tensor, designated: torch.Tensor) -> None:
    """What every scatter needs, on any device: shapes, capacity, devices."""
    if src.ndim != 1 or src.shape[0] != designated.shape[0]:
        raise ValueError(f"src {tuple(src.shape)} vs UE axis {designated.shape[0]}")
    if compact.shape[1:] != designated.shape[1:] or compact.dtype != designated.dtype:
        raise ValueError(f"compact {tuple(compact.shape)} {compact.dtype} vs designated "
                         f"{tuple(designated.shape)} {designated.dtype}")
    if compact.shape[0] < 1:
        raise ValueError("capacity must be >= 1 (skip the scatter when it is 0)")
    if src.device != designated.device or compact.device != designated.device:
        raise ValueError("src, compact and designated must share one device")


def _scatter_plan(src: torch.Tensor, compact: torch.Tensor, designated: torch.Tensor,
                  resolve=None) -> tuple[int, ctypes._CFuncPtr]:
    """The kernel's bytes per UE and function, for tensors it may take.

    What the signature alone decides (shapes, capacity, dtype, device) is
    checked once, when the signature is first seen, and ``resolve()`` then
    looks the kernel's function up; what each call's tensors can change
    under one signature (``src``'s dtype, ``compact``'s dtype, every
    tensor's device and contiguity, a lazy conjugate or negative bit) is
    checked on every call, cheapest first.
    """
    dtype, dev = designated.dtype, designated.device
    sig = (src.shape, compact.shape, designated.shape, dtype, dev)
    known = _SCATTER_SIGNATURES.get(sig)
    if known is None:
        _check_scatter(src, compact, designated)
        known = _SCATTER_SIGNATURES[sig] = (_nbytes(designated) // max(designated.shape[0], 1),
                                            resolve() if resolve else None)
    if src.dtype is not torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    if compact.dtype is not dtype:
        raise ValueError(f"compact {compact.dtype} vs designated {dtype}")
    if src.device != dev or compact.device != dev:
        raise ValueError("src, compact and designated must share one device")
    if not (designated.is_contiguous() and compact.is_contiguous() and src.is_contiguous()):
        raise ValueError("scatter kernel needs contiguous src, compact and designated")
    if compact.is_conj() or compact.is_neg() or designated.is_conj() or designated.is_neg():
        _check_resolved(compact)
        _check_resolved(designated)
    return known


def switch_scatter(src: torch.Tensor, compact: Any, designated: Any, *,
                   backend: str = "auto") -> Any:
    """Scatter a dense capacity-``K`` sub-batch back over the full UE batch.

    ``src (U,)`` int32 names each UE's compact row (negative keeps the
    designated buffer); ``compact (K, ...)`` and ``designated (U, ...)``
    share their trailing shape, dtype and device, with ``K >= 1``; both may
    be pytrees of one structure, scattered leaf by leaf, one launch a leaf.
    ``backend`` takes the reference's values: ``"ref"`` is the plain version
    on any device; ``"auto"``, ``"pallas"`` and ``"cuda"`` launch the kernel
    on a CUDA tensor and take the plain version on a CPU tensor.  Either way
    the result is new and the inputs are left as they were.

    The unfused GATED bank calls this once a slot, so the card path is lean,
    as the per-UE switch's is: a signature is validated once
    (``_scatter_plan``), and the launch passes ``data_ptr()`` ints and the
    raw stream.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown switch_scatter backend {backend!r}; one of {_BACKENDS}")
    if not isinstance(designated, torch.Tensor):
        if backend == "ref":
            return switch_gather_batched_tree_ref(src, compact, designated)
        return _tree_map(lambda c, d: switch_gather_batched_leaf(src, c, d),
                         compact, designated)
    if backend == "ref" or not designated.is_cuda:
        _check_scatter(src, compact, designated)
        return switch_gather_batched_ref(src, compact, designated)
    return _scatter_launch(src, compact, designated)


def switch_gather_batched_leaf(src: torch.Tensor, compact: torch.Tensor,
                               designated: torch.Tensor) -> torch.Tensor:
    """The scatter of one leaf: the kernel on a CUDA tensor, the plain
    version on a CPU tensor; a new tensor either way."""
    if not designated.is_cuda:
        _check_scatter(src, compact, designated)
        return switch_gather_batched_ref(src, compact, designated)
    return _scatter_launch(src, compact, designated)


def _scatter_launch(src: torch.Tensor, compact: torch.Tensor,
                    designated: torch.Tensor) -> torch.Tensor:
    row_bytes, fn = _scatter_plan(src, compact, designated, lambda: build.function(
        "switch_select", "switch_gather_launch", _GATHER_ARGS))
    out = build.unfilled(torch.empty_like, designated)
    build.check(fn(src.data_ptr(), compact.data_ptr(), designated.data_ptr(), out.data_ptr(),
                   designated.shape[0], row_bytes, compact.shape[0],
                   build.stream(designated)),
                "switch_gather")
    build.launch_counts["switch_gather_batched"] += 1
    return out
