"""The public API's kernel path and the LM stack's training half on the card.

Marked ``cuda``: each skips where there is no NVIDIA GPU, because the
hand-written kernels have no CPU mode.  This file imports no JAX, so it runs
on the card's machine as it is:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_train.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.tokens import TokenStream
from repro_torch.distributed.compression import compress_decompress, init_error_feedback
from repro_torch.kernels import build
from repro_torch.models import Model, get_config
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.phy import dmrs
from repro_torch.phy.equalizer import mmse_irc_equalize
from repro_torch.phy.estimators import WienerInterpolator, mmse_estimate
from repro_torch.phy.nr import SlotConfig
from repro_torch.train import FailureInjector, run_training
from repro_torch.train import step as tstep

#: the hand-written mmse_interp against its plain version (chip_smoke.py's
#: MMSE_TOL: 636 float32 products an output in another order)
MMSE_TOL = 1e-4
#: MMSE-IRC on the card against the CPU: 4x4 complex solves (cuSOLVER against
#: LAPACK) and the combiner's sums; symbols O(1), the SINR relative
IRC_X_ATOL, IRC_SINR_RTOL = 1e-4, 1e-4
#: 3 float32 train steps of the reduced config, card against CPU: the same
#: products reduced in another order (cuBLAS against oneDNN); the CPU tests
#: read 1.8e-07 relative on the losses and 5.4e-05 on the weights against
#: the reference
LOSS_RTOL, WEIGHT_ATOL = 1e-5, 1e-4
ARCH = "granite-20b"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _slot(seed, cfg):
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.n_ant, cfg.n_sc, cfg.n_sym)
    return torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g))


@pytest.mark.cuda
@pytest.mark.parametrize("n_prb,n_ues", [(106, 1), (106, 32), (24, 3), (273, 2)])
def test_cuda_mmse_estimate_launches_the_kernel(cuda, n_prb, n_ues):
    cfg = SlotConfig(n_prb=n_prb)
    rx = torch.stack([_slot(u, cfg) for u in range(n_ues)]).to(cuda)
    pilots = dmrs.dmrs_sequence(cfg, cuda)
    w = WienerInterpolator.build(cfg, device=cuda)
    build.reset_launch_counts()
    got = mmse_estimate(cfg, rx, pilots, w)
    assert build.launch_counts["mmse_interp"] == 1
    want = mmse_estimate(cfg, rx, pilots, w, use_kernel=False)
    assert build.launch_counts["mmse_interp"] == 1
    torch.cuda.synchronize()
    assert got.shape == (n_ues, cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym)
    assert float((got - want).abs().max()) <= MMSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("prb_per_subband", [2, 4])
def test_cuda_mmse_irc_equalize_against_cpu(cuda, prb_per_subband):
    cfg = SlotConfig(n_prb=106)
    rx = _slot(0, cfg)
    g = torch.Generator().manual_seed(1)
    shape = (cfg.n_ant, 1, cfg.n_sc, cfg.n_dmrs_sym)
    h = torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g))
    pilots = dmrs.dmrs_sequence(cfg)
    x_c, s_c = mmse_irc_equalize(cfg, rx, h, pilots, 0.1, prb_per_subband=prb_per_subband)
    x_g, s_g = mmse_irc_equalize(cfg, rx.to(cuda), h.to(cuda), pilots.to(cuda), 0.1,
                                 prb_per_subband=prb_per_subband)
    assert float((x_g.cpu() - x_c).abs().max()) <= IRC_X_ATOL
    torch.testing.assert_close(s_g.cpu(), s_c, rtol=IRC_SINR_RTOL, atol=0.0)


@pytest.mark.cuda
def test_cuda_compression_bitwise_against_cpu(cuda):
    g = torch.Generator().manual_seed(2)
    grads = {"a": torch.randn(3, 300, generator=g), "b": [torch.randn(130, generator=g) * 1e-3]}
    ef_c = init_error_feedback(grads)
    on = {"a": grads["a"].to(cuda), "b": [grads["b"][0].to(cuda)]}
    ef_g = init_error_feedback(on)
    for _ in range(3):
        out_c, ef_c = compress_decompress(grads, ef_c)
        out_g, ef_g = compress_decompress(on, ef_g)
        for a, b in zip(tree_leaves(out_g) + tree_leaves(ef_g.residual),
                        tree_leaves(out_c) + tree_leaves(ef_c.residual)):
            assert torch.equal(a.cpu(), b)


def _steps(dev, n=3, **kw):
    model = Model(get_config(ARCH, reduced=True))
    tc = tstep.TrainConfig(learning_rate=1e-3, **kw)
    params = tree_map(lambda p: p.to(dev), model.init(jr.PRNGKey(0)))  # one draw for both
    state = tstep.init_train_state(model, params, tc)
    stream = TokenStream(vocab=256, seq_len=16, global_batch=4)
    losses = []
    for i in range(n):
        state, m = tstep.train_step(model, tc, state, stream.batch_at(i))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(microbatches=2), dict(quantize_moments=True),
                                dict(compress_grads=True)],
                         ids=["plain", "microbatches", "quantize_moments", "compress_grads"])
def test_cuda_train_steps_against_cpu(cuda, kw):
    s_g, l_g = _steps(cuda, **kw)
    s_c, l_c = _steps(torch.device("cpu"), **kw)
    np.testing.assert_allclose(l_g, l_c, rtol=LOSS_RTOL)
    for a, b in zip(tree_leaves(s_g.params), tree_leaves(s_c.params)):
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max()) <= WEIGHT_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["block", "full"])
def test_cuda_remat_same_bits(cuda, remat):
    batch = TokenStream(vocab=256, seq_len=16, global_batch=4).batch_at(0)
    out = {}
    for r in ("none", remat):
        model = Model(get_config(ARCH, reduced=True).with_(remat=r))
        params = model.init(jr.PRNGKey(3, cuda))
        live = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = model.loss(params, torch.as_tensor(batch["tokens"], device=cuda),
                          torch.as_tensor(batch["labels"], device=cuda))
        out[r] = (loss, torch.autograd.grad(loss, live))
    assert torch.equal(out[remat][0], out["none"][0])
    assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1]))


@pytest.mark.cuda
def test_cuda_killed_and_resumed_equals_uninterrupted(cuda, tmp_path):
    model = Model(get_config(ARCH, reduced=True))
    tc = tstep.TrainConfig(learning_rate=1e-3, microbatches=2, quantize_moments=True,
                           compress_grads=True)
    stream = TokenStream(vocab=256, seq_len=16, global_batch=4)

    def init():
        return tstep.init_train_state(model, model.init(jr.PRNGKey(0, cuda)), tc)

    finals = []
    for name, inj in (("clean", None), ("hurt", FailureInjector(fail_at_steps=(3, 5)))):
        ckpt = CheckpointManager(str(tmp_path / name), save_every=2, keep=2)
        run_training(step_fn=lambda s, b: tstep.train_step(model, tc, s, b), init_state=init,
                     data=stream.iterate, ckpt=ckpt, total_steps=6, failure_injector=inj,
                     log=lambda _msg: None)
        finals.append(ckpt.restore_latest(init())[1])
    for a, b in zip(tree_leaves(finals[0]), tree_leaves(finals[1])):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_open_loop_session_with_modes(cuda):
    """An open-loop campaign with a fixed mode grid runs on the card (the grid
    reaches the engine as a CUDA tensor), and the fused GATED bank equals the
    CONCURRENT one bitwise, as ``examples_torch/quickstart.py --gated`` holds."""
    from repro_torch.core.session import ArchesSession, CampaignSpec, ExpertBankSpec

    modes = np.ones((6, 4), np.int32)
    modes[:, 0] = 0
    base = dict(scenario="good_poor_good", scenario_args=(("poor_start", 2), ("poor_end", 4)),
                n_ues=4, n_slots=6, modes=tuple(map(tuple, modes)))
    conc = ArchesSession(CampaignSpec(path="batched", **base), device="cuda").run()
    fused = ArchesSession(CampaignSpec(path="gated", bank=ExpertBankSpec(
        execution_mode="gated", gated_capacity=1, fused=True), **base), device="cuda").run()
    np.testing.assert_array_equal(conc.modes, modes)
    np.testing.assert_array_equal(fused.modes, modes)
    for k in conc.kpms:
        np.testing.assert_array_equal(fused.kpms[k], conc.kpms[k], err_msg=k)
