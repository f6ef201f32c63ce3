"""Key-based threefry2x32 generator, bit-compatible with ``jax.random``.

The reference package draws every random number through ``jax.random``
with ``jax_threefry_partitionable=True``.  This module rebuilds that
generator so a campaign run through the port consumes exactly the same
bits as the reference from the same seed:

* a key is an ``int64`` tensor whose last axis holds the two 32-bit words
  (``(..., 2)``); every function is vectorised over the leading key axes, so
  one call draws for all UEs of a slot at once;
* ``split``/``fold_in``/``bits``/``uniform``/``bernoulli`` are bitwise equal
  to ``jax.random``; ``normal`` applies XLA's float32 ``erf_inv``
  polynomial and matches to within a few ulp (``log1p`` and the final
  multiply round differently across libraries);
* raw key arithmetic (``key + 1`` on a ``uint32`` key in the reference) is
  ``add(key, 1)`` here.

Two paths, by the key's device.  A CUDA key takes the hand-written kernel
``csrc/threefry.cu``: each public draw (``split``, ``fold_in``, ``bits``,
``uniform``, ``normal``, ``bernoulli``) is one launch that hashes in 32-bit
registers, converts and writes its final dtype, counted under
``build.launch_counts["threefry"]``; its float steps are the plain form's,
one rounding each in the same order, so on the card it gives the plain
form's bits, ``normal`` included.  A CPU key takes the plain form below, in
torch integer ops, which the CPU tests hold to ``jax.random`` and the card
tests hold the kernel to: 32-bit words live in ``int64`` so additions,
shifts and rotations never hit signed overflow, and every result is masked
back to 32 bits.  ``randint`` composes ``split`` and ``bits`` on either.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import cached_const
from repro_torch.kernels import build

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
#: (key, key stride, word stride, elements a key, offset, total, out, mode, lo, hi, p,
#: stream)
_DRAW_ARGS = (_P, _LL, _LL, _LL, ctypes.c_ulonglong, _LL, _P, _I, _F, _F, _F, _P)
#: (key, word stride, data, scalar, data mode, axes, (size, key stride, data stride)
#: an axis, total, out, stream)
_KEYS_ARGS = (_P, _LL, _P, _LL, _I, _I, ctypes.POINTER(_LL), _LL, _P, _P)
#: the draw launch's output kinds, and their dtypes
_BITS, _UNIFORM, _NORMAL, _BERNOULLI = range(4)
_DRAW_DTYPES = (torch.int64, torch.float32, torch.float32, torch.bool)
#: the key launch's data: a scalar, a tensor, the index along the last axis
_SCALAR, _TENSOR, _IOTA = range(3)
#: axes the key launch indexes (the kernel's MAX_DIMS)
_MAX_KEY_DIMS = 8


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) on broadcastable ``int64`` words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def PRNGKey(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off, as the reference
    runs: the seed is taken as a 32-bit integer, so the words are
    ``(0, seed mod 2**32)``.  Built on ``device`` as a cached ``(0, 1)``
    times the seed, so a key made every slot uploads nothing."""
    basis = cached_const(("key_basis",), device, lambda: np.asarray([0, 1], np.int64))
    return basis * (int(seed) & MASK)


def as_key(key, device: torch.device | str | None = None) -> torch.Tensor:
    """Accept a reference ``uint32`` key (numpy/jax array) or a port key."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device or key.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(key, np.int64), device=device)


def add(key: torch.Tensor, n: int) -> torch.Tensor:
    """Raw ``uint32`` key arithmetic: the reference's ``key + n``."""
    return (key + n) & MASK


def _words(key: torch.Tensor, ndim: int):
    """Split ``key (..., 2)`` into its words, broadcastable over ``ndim``
    trailing sample axes."""
    shape = key.shape[:-1] + (1,) * ndim
    return key[..., 0].reshape(shape), key[..., 1].reshape(shape)


def _as_int64(key: torch.Tensor) -> torch.Tensor:
    return key if key.dtype is torch.int64 else key.to(torch.int64)


def _counted(out: torch.Tensor) -> torch.Tensor:
    """A draw's words, counted under ``rng.words`` on either path."""
    tracing.counters["rng.words"] += out.numel()
    return out


# -- the kernel's launches (CUDA keys) ---------------------------------------


def _keys_launch(keys: torch.Tensor, data_mode: int, data: torch.Tensor | None = None,
                 scalar: int = 0) -> torch.Tensor:
    """One launch of new key pairs: ``keys (..., 2)`` int64 and ``data`` (of
    ``keys``' leading shape) are views whose strides are 0 where they
    broadcast; the new keys are ``(..., 2)``, written in full."""
    shape = tuple(keys.shape[:-1])
    if len(shape) > _MAX_KEY_DIMS:
        raise ValueError(f"threefry: new keys of {len(shape)} leading axes on a CUDA key; "
                         f"the kernel indexes at most {_MAX_KEY_DIMS}")
    total = math.prod(shape)
    out = build.unfilled(torch.empty, (*shape, 2), dtype=torch.int64, device=keys.device)
    if total == 0:
        return out
    data_strides = (0,) * len(shape) if data is None else data.stride()
    dims = (_LL * (3 * len(shape)))(*(v for axis in zip(shape, keys.stride()[:-1], data_strides)
                                      for v in axis))
    fn = build.function("threefry", "threefry_keys_launch", _KEYS_ARGS)
    build.check(fn(keys.data_ptr(), keys.stride(-1), None if data is None else data.data_ptr(),
                   scalar, data_mode, len(shape), dims, total, out.data_ptr(),
                   build.stream(keys)), "threefry")
    build.launch_counts["threefry"] += 1
    return out


def _split_launch(key: torch.Tensor, num: int) -> torch.Tensor:
    key = _as_int64(key)
    keys = key.unsqueeze(-2).expand(*key.shape[:-1], num, 2)
    return _keys_launch(keys, _IOTA)


def _fold_in_launch(key: torch.Tensor, data) -> torch.Tensor:
    key = _as_int64(key)
    if isinstance(data, (int, np.integer)):
        data_mode, scalar, data = _SCALAR, int(data) & MASK, None
        shape = tuple(key.shape[:-1])
    else:
        data_mode, scalar = _TENSOR, 0
        data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
        shape = tuple(torch.broadcast_shapes(key.shape[:-1], data.shape))
        data = data.expand(shape)
    return _keys_launch(key.expand(*shape, 2), data_mode, data, scalar)


def _draw_launch(key: torch.Tensor, shape: tuple[int, ...], mode: int, offset: int = 0,
                 lo: float = 0.0, hi: float = 1.0, p: float = 0.0) -> torch.Tensor:
    """One launch of a draw: ``(..., 2)`` keys -> ``(..., *shape)`` of the
    mode's dtype (``lo``, ``hi`` in float32 as the plain form rounds them)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    lead = tuple(key.shape[:-1])
    rows = _as_int64(key).reshape(-1, 2)  # a view wherever the key's axes allow one
    total = rows.shape[0] * n
    out = build.unfilled(torch.empty, total, dtype=_DRAW_DTYPES[mode], device=key.device)
    if total:
        fn = build.function("threefry", "threefry_draw_launch", _DRAW_ARGS)
        build.check(fn(rows.data_ptr(), rows.stride(0), rows.stride(1), n, offset, total,
                       out.data_ptr(), mode, lo, hi, p, build.stream(key)), "threefry")
        build.launch_counts["threefry"] += 1
    return out.view(lead + shape)


# -- the plain forms (CPU keys; the kernel's oracle on any device) -----------


def split_ref(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """Plain form of ``split``."""
    k1, k2 = _words(key, 1)
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return torch.stack([b1, b2], dim=-1)


def fold_in_ref(key: torch.Tensor, data) -> torch.Tensor:
    """Plain form of ``fold_in``."""
    if isinstance(data, int):
        data = torch.full((), data, dtype=torch.int64, device=key.device)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    k1, k2 = key[..., 0], key[..., 1]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def bits_ref(key: torch.Tensor, shape: tuple[int, ...], *, offset: int = 0) -> torch.Tensor:
    """Plain form of ``bits``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64,
                       device=key.device).reshape(shape)
    k1, k2 = _words(key, len(shape))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return b1 ^ b2


def uniform_ref(key: torch.Tensor, shape: tuple[int, ...] = (), minval: float = 0.0,
                maxval: float = 1.0, *, offset: int = 0) -> torch.Tensor:
    """Plain form of ``uniform``."""
    b = bits_ref(key, shape, offset=offset)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


# XLA's single-precision erf_inv (Giles' approximation), coefficients in the
# order the Horner recurrence consumes them.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's polynomial (not ``torch.erfinv``)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for c_lt, c_ge in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, c_lt, c_ge)  # Python floats: float32, no upload
        p = c if p is None else c + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def normal_ref(key: torch.Tensor, shape: tuple[int, ...] = (), *,
               offset: int = 0) -> torch.Tensor:
    """Plain form of ``normal``."""
    u = uniform_ref(key, shape, _NORMAL_LO, 1.0, offset=offset)
    return _SQRT2_F32 * erf_inv(u)


def bernoulli_ref(key: torch.Tensor, p: float, shape: tuple[int, ...]) -> torch.Tensor:
    """Plain form of ``bernoulli``."""
    return uniform_ref(key, shape) < torch.full((), p, dtype=torch.float32,
                                                device=key.device)


# -- the public draws --------------------------------------------------------


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` -> ``(..., num, 2)``."""
    with tracing.span("rng", key):
        return _split_launch(key, num) if key.is_cuda else split_ref(key, num)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` broadcasts against the key's
    leading axes (a single key folded with an ``(n,)`` vector gives
    ``(n, 2)`` keys, as ``vmap(fold_in, (None, 0))`` does)."""
    with tracing.span("rng", key):
        return _fold_in_launch(key, data) if key.is_cuda else fold_in_ref(key, data)


def bits(key: torch.Tensor, shape: tuple[int, ...], *, offset: int = 0) -> torch.Tensor:
    """32 random bits per element: ``(..., 2)`` keys -> ``(..., *shape)``
    ``int64`` values in ``[0, 2**32)`` (``jax.random.bits``).

    An element's bits depend only on the key and its flat index, so
    ``offset`` draws the flat elements ``[offset, offset + prod(shape))`` of
    a larger draw: a big tensor can be drawn in chunks with its bits."""
    with tracing.span("rng", key):
        return _counted(_draw_launch(key, shape, _BITS, offset) if key.is_cuda
                        else bits_ref(key, shape, offset=offset))


def uniform(
    key: torch.Tensor,
    shape: tuple[int, ...] = (),
    minval: float = 0.0,
    maxval: float = 1.0,
    *,
    offset: int = 0,
) -> torch.Tensor:
    """float32 uniforms on ``[minval, maxval)`` (``jax.random.uniform``);
    ``offset`` as in ``bits``."""
    with tracing.span("rng", key):
        return _counted(_draw_launch(key, shape, _UNIFORM, offset, minval, maxval)
                        if key.is_cuda else uniform_ref(key, shape, minval, maxval,
                                                        offset=offset))


def normal(key: torch.Tensor, shape: tuple[int, ...] = (), *,
           offset: int = 0) -> torch.Tensor:
    """float32 standard normals (``jax.random.normal``); ``offset`` as in
    ``bits``."""
    with tracing.span("rng", key):
        return _counted(_draw_launch(key, shape, _NORMAL, offset, _NORMAL_LO, 1.0)
                        if key.is_cuda else normal_ref(key, shape, offset=offset))


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 integers in ``[minval, maxval)`` (``jax.random.randint`` for
    int32): two 32-bit draws folded into the span by uint32 modular
    arithmetic, as the reference folds them (biased where the span is not
    a power of 2, as there)."""
    if not -2**31 <= minval <= maxval <= 2**31 - 1:
        raise ValueError(f"randint takes int32 bounds, got [{minval}, {maxval})")
    with tracing.span("rng", key):
        ks = split(key)
        hi, lo = bits(ks[..., 0, :], shape), bits(ks[..., 1, :], shape)
        span = (maxval - minval) & MASK if maxval > minval else 1
        mult = (2**16) % span
        mult = ((mult * mult) & MASK) % span
        off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
        return (minval + off % span).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float, shape: tuple[int, ...]) -> torch.Tensor:
    """Boolean draws with mean ``p`` (``jax.random.bernoulli``, mode 'low')."""
    with tracing.span("rng", key):
        return _counted(_draw_launch(key, shape, _BERNOULLI, 0, 0.0, 1.0, p)
                        if key.is_cuda else bernoulli_ref(key, p, shape))
