"""On the card: the CONCURRENT AI expert at any bank slot, and ranks sharing it.

Marked ``cuda``: each skips where there is no NVIDIA GPU, because a CUDA
kernel has no interpret mode.  Imports no JAX, so the card's machine runs it:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_topology.py``.

* The CONCURRENT bank's AI expert is one ``gated_expert`` launch with every
  UE selected: a UE's estimate is the same bits at any batch size and row,
  and the same bits as ``gated_expert_apply`` with every row selected
  (float32 and bf16).
* Two ranks sharing the card (gloo) run a multi-cell closed loop bitwise
  the same as one rank, on every trajectory leaf, with one ``all_reduce``
  a slot; NCCL refuses two ranks of one communicator on one card, which is
  why ranks sharing a card take gloo.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.core import session as tses
from repro_torch.core import topology as ttopo
from repro_torch.kernels import build
from repro_torch.kernels.gated_expert import ai_expert_dense, gated_expert_apply
from repro_torch.phy.ai_estimator import AiEstimator, AiEstimatorConfig, init_params
from repro_torch.phy.nr import SlotConfig


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.use_deterministic_algorithms(True)
    return torch.device("cuda")


def _estimator(n_prb, channels, n_res, compute_dtype, device):
    cfg = SlotConfig(n_prb=n_prb)
    params = init_params(jr.PRNGKey(3), cfg, AiEstimatorConfig(channels=channels,
                                                               n_res_blocks=n_res))
    return cfg, AiEstimator(params, cfg.n_dmrs_sym, compute_dtype).to(device)


def _ls(cfg, n_ues, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (n_ues, cfg.n_ant, cfg.n_dmrs_sym, cfg.n_sc // 2)
    return torch.complex(torch.randn(shape, generator=g),
                         torch.randn(shape, generator=g)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_prb,channels,n_res,dtype", [
    (24, 8, 1, None), (106, 32, 4, None), (106, 32, 4, torch.bfloat16), (51, 96, 2, None)])
def test_cuda_concurrent_ai_expert_same_bits_at_any_batch_and_row(cuda, n_prb, channels,
                                                                  n_res, dtype):
    cfg, ai = _estimator(n_prb, channels, n_res, dtype, cuda)
    h = _ls(cfg, 32, cuda)
    build.reset_launch_counts()
    full = ai_expert_dense(h, ai, compute_dtype=dtype)
    assert build.launch_counts["gated_expert"] == 1
    rows = torch.arange(32, dtype=torch.int32, device=cuda)
    base = torch.zeros_like(full)
    assert torch.equal(full, gated_expert_apply(rows, rows, h, base, ai, compute_dtype=dtype))
    for n in (1, 3, 16, 31):
        for lo in (0, 32 - n, (32 - n) // 2):
            sub = ai_expert_dense(h[lo:lo + n].contiguous(), ai, compute_dtype=dtype)
            assert torch.equal(sub, full[lo:lo + n]), (n, lo)
    # a UE moved to another row of a re-packed batch keeps its bits
    perm = torch.randperm(32, generator=torch.Generator().manual_seed(1)).to(cuda)
    moved = ai_expert_dense(h[perm].contiguous(), ai, compute_dtype=dtype)
    assert torch.equal(moved, full[perm])
    # and it is the AI expert: within the float32 bound of the plain version
    if dtype is None:
        plain = copy.deepcopy(ai).cpu()(h.cpu()).to(cuda)
        torch.testing.assert_close(full, plain, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_concurrent_bank_routes_the_ai_expert_through_the_kernel(cuda):
    from repro_torch.phy.pipeline import BatchedPuschPipeline

    cfg = SlotConfig(n_prb=24)
    params = init_params(jr.PRNGKey(3), cfg, AiEstimatorConfig(channels=8, n_res_blocks=1))
    engine = BatchedPuschPipeline(cfg, params, net=AiEstimatorConfig(channels=8,
                                                                    n_res_blocks=1),
                                  device=cuda)
    assert engine.ai_route == "gated_expert"
    h = _ls(cfg, 8, cuda)
    build.reset_launch_counts()
    out = engine.bank(torch.zeros(8, dtype=torch.int32, device=cuda), h)
    assert build.launch_counts["gated_expert"] == 1
    assert torch.equal(out.all_outputs[0], ai_expert_dense(h, engine.ai))
    assert torch.equal(out.selected, out.all_outputs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_prb", [6, 24, 51, 106, 273])
@pytest.mark.parametrize("gated", [False, True])
def test_cuda_slot_same_bits_at_any_batch(cuda, n_prb, gated):
    """A closed-loop campaign's first ``k`` UEs are the same bits whether the
    batch holds ``k`` UEs or 16: every per-UE reduction and contraction of
    the slot runs in a fixed order whatever the batch, and the AI expert is
    the fused kernel (CONCURRENT; fused GATED at full capacity)."""
    from repro_torch.core.closed_loop import SwitchConfig
    from repro_torch.core.policy import ThresholdPolicy
    from repro_torch.core.runtime import BatchedRunHistory
    from repro_torch.core.telemetry import SELECTED_KPMS
    from repro_torch.core.expert_bank import ExecutionMode
    from repro_torch.phy.pipeline import BatchedPuschPipeline
    from repro_torch.phy.scenario import get_scenario

    cfg = SlotConfig(n_prb=n_prb)
    net = AiEstimatorConfig(channels=8, n_res_blocks=1)
    engine = BatchedPuschPipeline(
        cfg, init_params(jr.PRNGKey(3), cfg, net), net=net, device=cuda,
        execution_mode=ExecutionMode.GATED if gated else ExecutionMode.CONCURRENT,
        fused_gated=gated)
    policy = ThresholdPolicy(feature_idx=SELECTED_KPMS.index("snr"), threshold=12.0,
                             hysteresis=1.0).to_device(cuda)
    sw_cfg = SwitchConfig(feature_names=SELECTED_KPMS, window_slots=2)
    schedules = get_scenario("mixed_cell").schedule(n_ues=16, poor_start=2, poor_end=5)

    def run(k):
        _, _, traj = engine.run_closed_loop(schedules[:k], policy, sw_cfg, n_slots=6,
                                            n_ues=k, key=jr.PRNGKey(5, cuda))
        return BatchedRunHistory.from_closed_loop(traj)

    full = run(16)
    assert 0 < full.ai_share < 1
    for k in (1, 5, 8):
        part = run(k)
        np.testing.assert_array_equal(part.modes, full.modes[:, :k])
        for name, v in part.kpms.items():
            np.testing.assert_array_equal(v, full.kpms[name][:, :k], err_msg=name)
        for name, v in part.outputs.items():
            np.testing.assert_array_equal(v, full.outputs[name][:, :k], err_msg=name)


CELLS = ("good", "poor", "good_poor_good", "bursty_interference")
SPEC = dict(path="closed_loop", scenario="multi_cell",
            scenario_args=(("n_cells", 4), ("per_cell_scenario", CELLS)), n_ues=16,
            n_slots=8, n_prb=24, seed=2,
            topology=dict(n_cells=4, coupling=0.3, cell_noise_offsets_db=(0.0, 3.0, 0.0, -3.0)),
            policies=(dict(kind="threshold", feature="snr", threshold=12.0, hysteresis=1.0),),
            switch=dict(window_slots=2), bank=dict(channels=8, n_res_blocks=1))


def _leaves(hist):
    return {"modes": hist.modes, "decisions": hist.decisions, "kpms": hist.kpms,
            "outputs": hist.outputs}


def _cuda_rank(rank, bank):
    torch.use_deterministic_algorithms(True)
    ttopo.reset_collective_counts()
    spec = tses.CampaignSpec.from_dict(dict(SPEC, bank=bank))
    hist = tses.ArchesSession(spec, device="cuda").run()
    return _leaves(hist), dict(ttopo.collective_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("bank", [dict(channels=8, n_res_blocks=1),
                                  dict(channels=8, n_res_blocks=1, execution_mode="gated",
                                       fused=True, gated_capacity=16)])
def test_cuda_two_ranks_on_one_card_equal_one_rank(cuda, bank):
    build.build_all()  # the ranks load what the parent built
    want, counts = _cuda_rank(0, bank)
    assert counts == {"all_reduce": 0, "all_gather": 0}
    ranks = ttopo.spawn_ranks(_cuda_rank, 2, (bank,), device="cuda", backend="gloo")
    for got, got_counts in ranks:
        assert got_counts == {"all_reduce": SPEC["n_slots"], "all_gather": 1}
        np.testing.assert_array_equal(got["modes"], want["modes"])
        np.testing.assert_array_equal(got["decisions"], want["decisions"])
        for group in ("kpms", "outputs"):
            for k in want[group]:
                np.testing.assert_array_equal(got[group][k], want[group][k], err_msg=k)


def _all_reduce_rank(rank):
    import torch.distributed as dist

    t = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return t.cpu().tolist()


@pytest.mark.cuda
def test_cuda_ranks_sharing_a_card_need_gloo(cuda):
    if torch.cuda.device_count() != 1:
        pytest.skip("needs exactly one card, so that two ranks share it")
    assert ttopo.default_backend(2, "cuda") == "gloo"
    with pytest.raises(Exception, match="Duplicate GPU"):
        ttopo.spawn_ranks(_all_reduce_rank, 2, device="cuda", backend="nccl")
    assert ttopo.spawn_ranks(_all_reduce_rank, 2, device="cuda",
                             backend="gloo") == [[3.0] * 4] * 2
