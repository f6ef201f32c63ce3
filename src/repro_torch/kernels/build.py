"""Build the hand-written Hopper kernels and bind them with ctypes.

Five kernels (``KERNELS``): ``mmse_interp``, ``switch_select`` (the scalar
and per-UE switches and the GATED scatter), ``tree_infer`` (and the fused
decision phase), ``gated_expert`` and ``threefry`` (``repro_torch.random``'s
draws on the card).  Each ``csrc/<name>.cu`` exposes a plain C interface
and is compiled by ``nvcc`` for ``sm_90a`` into its own shared library, at
first use, into
``build/repro_torch/`` at the repository root (override with
``REPRO_TORCH_BUILD_DIR``).  Libraries are named by a hash of their source,
so an edited kernel rebuilds and an unchanged one loads from the cache.
The first request builds every kernel that is not cached yet, one ``nvcc``
per source, all started together.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code, so a refused launch never passes
silently.  A launch takes its pointers as ``data_ptr()`` ints (a complex64
tensor's as it is: the kernels read it as float pairs) and the current
stream from ``stream``, an int read afresh at every launch.  Nothing here
builds at import: this module is imported on hosts with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
KERNELS = ("mmse_interp", "switch_select", "tree_infer", "gated_expert", "threefry")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per kernel since the last ``reset_launch_counts``: the tracing
#: module's launch counters (``kernel.launches.<name>``), the same dict
launch_counts = tracing.launch_counts

_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()
_fill_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"{name}-{digest}.so"


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every listed kernel that is not cached, in parallel.

    Returns ``{name: ptxas report}`` for the kernels compiled by this call
    (the ``-Xptxas -v`` register/shared-memory lines).  Raises on the first
    failed build, with the compiler's output.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (target, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports, failed = {}, []
    for name, (target, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """C entry point ``symbol`` of kernel library ``name``, typed once and
    cached, so a launch pays no ctypes set-up."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        _functions[(name, symbol)] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


_deterministic = torch._C._get_deterministic_algorithms
_get_fill = torch._C._get_deterministic_fill_uninitialized_memory
_set_fill = torch._C._set_deterministic_fill_uninitialized_memory


def unfilled(make, *args, **kwargs) -> torch.Tensor:
    """``make(*args, **kwargs)``: a new tensor that a kernel (or a copy)
    then writes in full, e.g. ``unfilled(torch.empty_like, t)``.

    Under ``torch.use_deterministic_algorithms(True)`` PyTorch fills every
    new tensor with NaN, a launch and several microseconds of host time a
    call; a kernel that writes every element makes that fill dead work, so
    it is turned off for this one allocation (under a lock, so two wrappers
    never race on the flag).
    """
    if not (_deterministic() and _get_fill()):
        return make(*args, **kwargs)
    with _fill_lock:
        _set_fill(False)
        try:
            return make(*args, **kwargs)
        finally:
            _set_fill(True)


#: ``torch._C._cuda_getCurrentRawStream(device_index) -> int`` (None on a
#: PyTorch built without CUDA)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(tensor: torch.Tensor) -> int:
    """Raw handle of the current CUDA stream on ``tensor``'s device.

    Read afresh at every launch (a caller may switch streams) with the
    int-returning binding, which builds no ``torch.cuda.Stream`` object.
    """
    return _raw_stream(tensor.get_device())
