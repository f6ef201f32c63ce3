"""The switches over pytrees and both forms of ``mmse_interp`` on the card.

Marked ``cuda``: each skips where there is no NVIDIA GPU, because a CUDA
kernel has no CPU mode.  This file imports no JAX, so it runs on the card's
machine as it is: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_surface.py``.
"""

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.mmse_interp import mmse_interp, mmse_interp_ref
from repro_torch.kernels.switch_select import (
    switch_gather_batched_tree_ref,
    switch_scatter,
    switch_select,
    switch_select_batched_tree_ref,
    switch_select_tree_ref,
)
from repro_torch.phy.estimators import WienerInterpolator
from repro_torch.phy.nr import SlotConfig

#: every element type the switch kernels take (the LM decoder's bf16 and fp16
#: logits, float32, int32, float64, int64, complex64)
DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.int32, torch.float64,
          torch.int64, torch.complex64)
N_UES = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _leaf(g: torch.Generator, dtype: torch.dtype, shape: tuple, device) -> torch.Tensor:
    if dtype.is_complex:
        return torch.complex(torch.randn(shape, generator=g, device=device),
                             torch.randn(shape, generator=g, device=device))
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, device=device).to(dtype)
    return torch.randint(-2**30, 2**30, shape, generator=g, device=device).to(dtype)


def _tree(g, n_rows: int, device) -> dict:
    """A channel estimate, a noise variance, and a leaf of every dtype."""
    tree = {f"x_{str(d).split('.')[-1]}": _leaf(g, d, (n_rows, 3, 17), device) for d in DTYPES}
    tree["h"] = _leaf(g, torch.complex64, (n_rows, 4, 3, 72), device)
    tree["nv"] = _leaf(g, torch.float32, (n_rows,), device)
    return tree


def _bits(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.cuda
@pytest.mark.parametrize("n_experts", [2, 3])
def test_cuda_pytree_switches_bitwise(cuda, n_experts):
    """Scalar and per-UE switches and the scatter over a pytree of every
    dtype: bitwise the plain versions, one launch a leaf (the scalar switch
    one a leaf and alternative)."""
    g = torch.Generator(device=cuda).manual_seed(n_experts)
    outs = [_tree(g, N_UES, cuda) for _ in range(n_experts)]
    n_leaves = len(outs[0])
    for mode in range(n_experts):
        want = switch_select_tree_ref(mode, [{k: v.cpu() for k, v in o.items()} for o in outs])
        des = {k: v.clone() for k, v in outs[0].items()}  # switched in place
        build.reset_launch_counts()
        got = switch_select(mode, [des, *outs[1:]])
        assert build.launch_counts["switch_select"] == n_leaves * (n_experts - 1)
        _same({k: v.cpu() for k, v in got.items()}, want)
    modes = (torch.arange(N_UES, device=cuda) % n_experts).to(torch.int32)
    build.reset_launch_counts()
    got = switch_select(modes, outs)
    assert build.launch_counts["switch_select_batched"] == n_leaves
    _same(got, switch_select_batched_tree_ref(modes, outs))
    compact = _tree(g, 2, cuda)
    src = torch.tensor([1, -1, 0, -1, 1], dtype=torch.int32, device=cuda)
    build.reset_launch_counts()
    got = switch_scatter(src, compact, outs[0])
    assert build.launch_counts["switch_gather_batched"] == n_leaves
    _same(got, switch_gather_batched_tree_ref(src, compact, outs[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [12, 384])
@pytest.mark.parametrize("n_prb", [24, 106, 273])
@pytest.mark.parametrize("use_gauss", [True, False])
def test_cuda_mmse_interp_forms_against_complex128(cuda, use_gauss, n_prb, rows):
    """Each form against a complex128 product: within 4x its plain float32
    version's error, from its own launch counter."""
    g = torch.Generator(device=cuda).manual_seed(n_prb + rows)
    w = WienerInterpolator.build(SlotConfig(n_prb=n_prb), device=cuda).w
    h = torch.complex(torch.randn(rows, w.shape[0], generator=g, device=cuda),
                      torch.randn(rows, w.shape[0], generator=g, device=cuda))
    counter = "mmse_interp_gauss" if use_gauss else "mmse_interp"
    build.reset_launch_counts()
    got = mmse_interp(h, w, use_gauss=use_gauss)
    assert build.launch_counts[counter] == 1 and sum(build.launch_counts.values()) == 1
    exact = h.to(torch.complex128) @ w.to(torch.complex128)
    err = float((got - exact).abs().max())
    plain = float((mmse_interp_ref(h, w, use_gauss=use_gauss) - exact).abs().max())
    assert err <= 4 * plain, (err, plain)
    assert torch.equal(mmse_interp(h, w, use_gauss=use_gauss), got)
