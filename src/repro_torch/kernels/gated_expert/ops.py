"""The fused GATED hot path: the wrapper of the hand-written kernel and its
plain PyTorch version.

``gated_expert_apply(idx, src, h_ls, designated, ai)`` replaces
``repro.kernels.gated_expert.ops.gated_expert_apply``: the AI expert runs on
the UEs named by the compact rows ``idx`` whose ``src`` entry is
non-negative, and its estimates land in those UEs' slices of the
designated (fail-safe) buffer.  On a CUDA tensor the wrapper copies
``designated`` into a new tensor and one launch of ``csrc/gated_expert.cu``
does gather, estimator and scatter into that copy, reading the complex64 LS
input and writing complex64 (no sub-batch, no transposes, no real/imaginary
split).  On a CPU tensor, or with ``backend="ref"``, the plain version
``gated_expert_apply_ref`` composes the gather, the folded-GEMM estimator and
the plain scatter.  Either way the result is a new tensor and ``designated``
keeps the fail-safe estimate.  ``ai_expert_dense`` is the same launch with
every UE selected (``idx = src = arange(U)``): the CONCURRENT bank's AI
expert, whose every UE's estimate is then the same bits at any batch size
and row, as a cuBLAS GEMM does not promise.  The kernel takes any width: past the
channels whose stem and head weights fit a block's shared memory beside the
staged slice (1,408 float32 channels at NR's widest carrier) the wide form's
global-weight variant reads them from global memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any

import torch

from repro_torch.kernels import build
from repro_torch.kernels.switch_select.ops import switch_scatter
from repro_torch.phy.ai_estimator import AiEstimator, ai_estimate_folded, kernel_operands

_BACKENDS = ("auto", "pallas", "cuda", "ref")


def _folded(ai: AiEstimator | dict[str, Any]) -> dict[str, Any]:
    return ai.folded() if isinstance(ai, AiEstimator) else ai


def gated_expert_apply_ref(idx: torch.Tensor, src: torch.Tensor, h_ls: torch.Tensor,
                           designated: torch.Tensor, ai: AiEstimator | dict[str, Any], *,
                           compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: gather the compact rows' LS inputs, run the folded-GEMM
    estimator on that sub-batch, scatter the results over ``designated``."""
    compact_in = h_ls.index_select(0, idx.to(torch.int64))
    compact_out = ai_estimate_folded(_folded(ai), compact_in, compute_dtype=compute_dtype)
    return switch_scatter(src, compact_out, designated, backend="ref")


def _operands(ai: AiEstimator | dict[str, Any], compute_dtype):
    if isinstance(ai, AiEstimator) and ai.compute_dtype == compute_dtype and hasattr(
            ai, "kernel_w"):
        return ai.kernel_w, ai.kernel_b
    return kernel_operands(_folded(ai), compute_dtype)


@functools.lru_cache(maxsize=None)
def _smem_optin(device_index: int) -> int:
    """Shared memory a block may opt in to on a card (read once per device)."""
    return torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin


def cluster_size(n_pilot_sc: int) -> int:
    """Blocks in the cluster that runs one (row, antenna) chain at ``n_pilot_sc``
    pilots (builds the kernel library on first use)."""
    fn = build.function("gated_expert", "gated_expert_cluster_size", [ctypes.c_int])
    return fn(n_pilot_sc)


#: widths up to this run the kernel's CP forms; past it the wide form
WIDEST_CP = 64


def _launch(idx, src, h_ls, designated, ai, compute_dtype,
            global_weights: bool | None = None) -> torch.Tensor:
    """One launch.  ``global_weights`` picks the wide form's variant: None
    takes the staged one where its block fits the card, else the
    global-weight one.  ``designated`` None: every UE is selected and the
    kernel writes a new tensor in full."""
    folded = _folded(ai)
    n_ues, n_ant, n_sym, n_p = h_ls.shape
    channels = folded["stem_w"].shape[0] // folded["width"]
    n_res = len(folded["res"])
    bf16 = int(compute_dtype == torch.bfloat16)
    w, b = _operands(ai, compute_dtype)
    if w.device != h_ls.device:
        raise ValueError(f"estimator operands on {w.device}, LS input on {h_ls.device}")
    smem_of = build.function("gated_expert", "gated_expert_smem_bytes",
                             [ctypes.c_int] * 5, ctypes.c_longlong)
    limit = _smem_optin(h_ls.device.index)
    if global_weights is None:
        global_weights = (channels > WIDEST_CP
                          and smem_of(n_sym, n_p, channels, bf16, 0) > limit)
    smem = smem_of(n_sym, n_p, channels, bf16, int(global_weights))
    if smem > limit:  # no width of NR's carriers comes near it
        raise ValueError(f"{channels} channels at {n_p} pilots x {n_sym} symbols need {smem} B "
                         f"of shared memory per block; the card grants {limit}")
    ws_floats = build.function("gated_expert", "gated_expert_workspace_floats",
                               [ctypes.c_int] * 3, ctypes.c_longlong)
    capacity = idx.shape[0]
    workspace = torch.empty(capacity * n_ant * ws_floats(n_sym, n_p, channels),
                            dtype=torch.float32, device=h_ls.device)
    if designated is None:
        out = build.unfilled(torch.empty, (n_ues, n_ant, 1, 2 * n_p, n_sym),
                             dtype=torch.complex64, device=h_ls.device)
    else:
        out = build.unfilled(torch.clone, designated)  # the kernel writes selected UEs over it
    fn = build.function("gated_expert", "gated_expert_launch",
                        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    build.check(fn(idx.data_ptr(), src.data_ptr(), h_ls.data_ptr(), out.data_ptr(),
                   w.data_ptr(), b.data_ptr(), workspace.data_ptr(), capacity, n_ant, n_sym,
                   n_p, channels, n_res, bf16, int(global_weights), build.stream(out)),
                "gated_expert")
    build.launch_counts["gated_expert"] += 1
    return out


def gated_expert_apply(idx: torch.Tensor, src: torch.Tensor, h_ls: torch.Tensor,
                       designated: torch.Tensor, ai: AiEstimator | dict[str, Any], *,
                       compute_dtype: torch.dtype | None = None,
                       backend: str = "auto") -> torch.Tensor:
    """Run the gated AI expert fused: compact -> estimator -> scatter.

    ``idx (K,)`` int32 names each compact row's UE (a slice of a
    permutation; a row whose UE has ``src < 0`` is padding); ``src (U,)``
    int32 is the UE -> compact-row map; ``h_ls (U, ant, S, Np)`` complex64;
    ``designated (U, ant, 1, 2 Np, S)`` complex64; ``ai`` an ``AiEstimator``
    (whose kernel pack is reused) or a folded weight dict.
    ``compute_dtype`` is ``None`` (float32) or ``torch.bfloat16`` (bf16
    operands, float32 accumulation).  ``backend`` takes the reference's
    values: ``"ref"`` is the plain version on any device; ``"auto"``,
    ``"pallas"`` and ``"cuda"`` launch the kernel on CUDA tensors and take
    the plain version on CPU tensors.  Returns a new tensor.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown gated_expert_apply backend {backend!r}; one of {_BACKENDS}")
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype}; None (float32) or torch.bfloat16")
    n_ues, n_ant, n_sym, n_p = h_ls.shape
    if designated.shape != (n_ues, n_ant, 1, 2 * n_p, n_sym):
        raise ValueError(f"designated {tuple(designated.shape)} vs LS {tuple(h_ls.shape)}")
    if idx.ndim != 1 or src.shape != (n_ues,) or not 1 <= idx.shape[0] <= n_ues:
        raise ValueError(f"idx {tuple(idx.shape)}, src {tuple(src.shape)} vs {n_ues} UEs "
                         "(capacity must be >= 1: skip the call when it is 0)")
    if len({t.device for t in (idx, src, h_ls, designated)}) != 1:
        raise ValueError("idx, src, h_ls and designated must share one device")
    if backend == "ref" or designated.device.type != "cuda":
        return gated_expert_apply_ref(idx, src, h_ls, designated, ai,
                                      compute_dtype=compute_dtype)
    if h_ls.dtype != torch.complex64 or designated.dtype != torch.complex64:
        raise TypeError(f"complex64 LS and designated required, got {h_ls.dtype}, "
                        f"{designated.dtype}")
    if idx.dtype != torch.int32 or src.dtype != torch.int32:
        raise TypeError(f"idx and src must be int32, got {idx.dtype}, {src.dtype}")
    if not all(t.is_contiguous() for t in (idx, src, h_ls, designated)):
        raise ValueError("gated_expert kernel needs contiguous operands")
    return _launch(idx, src, h_ls, designated, ai, compute_dtype)


_ALL_ROWS: dict = {}


def _all_rows(n_ues: int, device: torch.device) -> torch.Tensor:
    """``arange(n_ues)`` as int32 on ``device``, made once."""
    key = (n_ues, device)
    if key not in _ALL_ROWS:
        _ALL_ROWS[key] = torch.arange(n_ues, dtype=torch.int32, device=device)
    return _ALL_ROWS[key]


def ai_expert_dense(h_ls: torch.Tensor, ai: AiEstimator | dict[str, Any], *,
                    compute_dtype: torch.dtype | None = None,
                    backend: str = "auto") -> torch.Tensor:
    """The AI expert on every UE: ``(U, ant, S, Np)`` LS -> ``(U, ant, 1, 2 Np, S)``.

    On a CUDA tensor one launch of the fused kernel with every UE selected
    (``idx = src = arange(U)``), written into a new tensor in full.  Each
    (row, antenna) chain runs on its own cluster in one fixed order, so a
    UE's estimate is the same bits whatever the batch and its row.  On a CPU
    tensor, or with ``backend="ref"``, the plain folded-GEMM form
    (``ai_estimate_folded``).  ``compute_dtype`` as in ``gated_expert_apply``.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown ai_expert_dense backend {backend!r}; one of {_BACKENDS}")
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype}; None (float32) or torch.bfloat16")
    if backend == "ref" or h_ls.device.type != "cuda":
        return ai_estimate_folded(_folded(ai), h_ls, compute_dtype=compute_dtype)
    if h_ls.dtype != torch.complex64 or not h_ls.is_contiguous():
        raise ValueError(f"the kernel needs a contiguous complex64 LS input, got {h_ls.dtype}")
    rows = _all_rows(h_ls.shape[0], h_ls.device)
    return _launch(rows, rows, h_ls, None, ai, compute_dtype)
