"""The hand-written kernels against their plain versions on the card.

Marked ``cuda``: each skips where there is no NVIDIA GPU, because a CUDA
kernel has no CPU mode.  This file imports no JAX, so it runs on the card's
machine as it is: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.mmse_interp import mmse_interp, mmse_interp_ref
from repro_torch.kernels.switch_select import switch_select, switch_select_batched_ref
from repro_torch.kernels.tree_infer import tree_infer, tree_infer_ref
from repro_torch.phy.estimators import WienerInterpolator
from repro_torch.phy.nr import SlotConfig

#: kernel vs plain Gauss-form product: Np float32 products per output summed
#: in another order, on unit-variance inputs whose outputs are O(10)
MMSE_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _random_tree(rng, depth, n_feat):
    n_nodes = 2**depth - 1
    feature = rng.integers(0, n_feat, size=n_nodes).astype(np.int32)
    threshold = rng.normal(size=n_nodes).astype(np.float32)
    threshold[rng.random(n_nodes) < 0.3] = np.inf
    leaves = rng.integers(0, 3, size=2**depth).astype(np.float32)
    return feature, threshold, leaves


@pytest.mark.cuda
@pytest.mark.parametrize("n_prb,batch", [(4, 7), (24, 24), (106, 384)])
def test_cuda_mmse_interp_vs_plain(cuda, n_prb, batch):
    g = torch.Generator(device=cuda).manual_seed(n_prb)
    w = WienerInterpolator.build(SlotConfig(n_prb=n_prb), device=cuda).w
    h = torch.complex(torch.randn(batch, w.shape[0], generator=g, device=cuda),
                      torch.randn(batch, w.shape[0], generator=g, device=cuda))
    before = build.launch_counts["mmse_interp"]
    got = mmse_interp(h, w)
    torch.cuda.synchronize()
    assert build.launch_counts["mmse_interp"] == before + 1
    torch.testing.assert_close(got, mmse_interp_ref(h, w), rtol=0, atol=MMSE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 4, 1, 1272, 3), (5, 3), (7, 1, 1, 13, 3)])
def test_cuda_switch_vs_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(1)
    des = torch.complex(torch.randn(shape, generator=g, device=cuda),
                        torch.randn(shape, generator=g, device=cuda))
    alt = torch.randn_like(des)
    for modes in (torch.arange(shape[0], device=cuda) % 2,
                  torch.zeros(shape[0], device=cuda), torch.ones(shape[0], device=cuda)):
        modes = modes.to(torch.int32)
        want = switch_select_batched_ref(modes, [des, alt])
        d = des.clone()
        got = switch_select(modes, [d, alt])
        torch.cuda.synchronize()
        assert got.data_ptr() == d.data_ptr()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_cuda_tree_vs_plain(cuda, depth):
    rng = np.random.default_rng(depth)
    feature, threshold, leaves = _random_tree(rng, depth, 10)
    x = torch.randn(300, 10, device=cuda)
    args = [torch.as_tensor(a, device=cuda) for a in (feature, threshold, leaves)]
    assert torch.equal(tree_infer(x, *args, depth), tree_infer_ref(x, *args, depth))


@pytest.mark.cuda
def test_cuda_closed_loop_equals_host_replay(cuda):
    """A small closed-loop session on the card: every kernel launches and the
    device loop equals its host replay."""
    from repro_torch.core.session import ArchesSession, CampaignSpec, PolicySpec

    torch.use_deterministic_algorithms(True)
    spec = CampaignSpec(path="closed_loop", scenario="good_poor_good", n_ues=3, n_slots=9,
                        scenario_args=(("poor_start", 3), ("poor_end", 6)),
                        policies=(PolicySpec(kind="tree"),))
    sess = ArchesSession(spec, device=cuda)
    build.reset_launch_counts()
    hist = sess.run()
    assert all(n > 0 for n in build.launch_counts.values()), build.launch_counts
    np.testing.assert_array_equal(hist.modes, sess.host_replay(hist)["active_mode"])
