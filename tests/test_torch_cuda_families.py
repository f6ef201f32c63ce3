"""The LM stack's MoE, SSM, hybrid, VLM, encoder-decoder and local/global
families on the card, against the same reduced configs on the CPU, under
deterministic algorithms; the MoE expert counts (no ``bincount``) on the
card.

Marked ``cuda``: each skips where there is no NVIDIA GPU.  This file imports
no JAX, so it runs on the card's machine as it is:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_families.py``.
"""

import os

import pytest
import torch

from repro_torch import random as jr
from repro_torch.data.tokens import TokenStream
from repro_torch.kernels import build
from repro_torch.models import Model, get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import layer
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serving import SwitchedDecodeConfig, SwitchedDecoder
from repro_torch.train import step as tstep

# deterministic cuBLAS; read when the first handle is made, after collection
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b", "mamba2-130m", "zamba2-7b", "qwen2-vl-72b"]
#: float32 logits of the reduced configs, card against CPU: the CPU tests'
#: tolerance against the reference (tests/test_torch_moe.py, test_torch_ssm.py)
LM_LOGIT_TOL = dict(rtol=1e-5, atol=2e-6)
#: one float32 train step, card against CPU: the same products reduced in
#: another order (cuBLAS against oneDNN); AdamW's first step moves a weight by
#: nearly lr * sign(g), so a gradient within eps of 0 may land up to 2 lr
#: apart: at most WEIGHT_OUTLIERS of the weights past WEIGHT_ATOL
LOSS_RTOL, WEIGHT_ATOL, WEIGHT_OUTLIERS, LR = 1e-5, 1e-4, 1e-3, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(was)


def _on(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_prefill_and_switched_steps_match_cpu(cuda, arch):
    """Prefill, then switched steps at modes 0, 1 and a vector: the logits on
    the card against the CPU's; both switch kernels launch on the card."""
    model = Model(get_config(arch, reduced=True))
    params = model.init(jr.PRNGKey(0))
    prompts = jr.randint(jr.PRNGKey(1), (4, 8), 0, model.cfg.vocab)
    dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=4))
    seqs = {}
    before = dict(build.launch_counts)
    for dev in (torch.device("cpu"), cuda):
        p = _on(params, dev)
        logits, cache = model.prefill(p, prompts.to(dev), model.init_cache(
            4, 16, dtype=torch.float32, device=dev))
        seq, tok = [logits.cpu()], prompts[:, -1:].to(dev)
        for mode in (0, 1, torch.tensor([0, 1, 1, 0], dtype=torch.int32)):
            logits, cache, _ = dec.step(mode, p, tok, cache)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            seq.append(logits.cpu())
        seqs[dev.type] = seq
    torch.cuda.synchronize()
    for a, b in zip(seqs["cuda"], seqs["cpu"]):
        torch.testing.assert_close(a, b, **LM_LOGIT_TOL)
    assert build.launch_counts["switch_select"] >= before["switch_select"] + 2
    assert build.launch_counts["switch_select_batched"] == before["switch_select_batched"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_train_step_matches_cpu(cuda, arch):
    """One AdamW step of the reduced config: loss (the MoE aux loss in it),
    gradient norm and new weights, card against CPU."""
    model = Model(get_config(arch, reduced=True))
    params = model.init(jr.PRNGKey(0))
    batch = TokenStream(vocab=model.cfg.vocab, seq_len=8, global_batch=4).batch_at(0)
    tc = tstep.TrainConfig(learning_rate=LR)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        state = tstep.init_train_state(model, _on(params, dev), tc)
        state, m = tstep.train_step(model, tc, state, batch)
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         [t.cpu() for t in tree_leaves(state.params)])
    (lc, gc, wc), (lg, gg, wg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= LOSS_RTOL * abs(lc) and abs(gg - gc) <= LOSS_RTOL * abs(gc)
    diff = torch.cat([(a - b).abs().ravel() for a, b in zip(wg, wc)])
    assert float(diff.max()) <= 2 * LR
    assert float((diff > WEIGHT_ATOL).float().mean()) <= WEIGHT_OUTLIERS


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_cuda_moe_assignment_and_kept_mask_match_cpu(cuda, arch, capacity_factor):
    """The router's expert assignment and the dispatch's kept mask on the card
    equal the CPU's; ``moe_ffn`` within the logits' tolerance."""
    cfg = get_config(arch, reduced=True)
    p = layer(Model(cfg).init(jr.PRNGKey(2))["blocks"]["moe"], 0)
    x = jr.normal(jr.PRNGKey(3), (2, 16, cfg.d_model))
    got = {}
    for dev in (torch.device("cpu"), cuda):
        pd, xd = _on(p, dev), x.to(dev)
        r = tmoe.route(cfg, pd, xd.reshape(-1, cfg.d_model))
        dp = tmoe.dispatch(cfg, r, capacity_factor=capacity_factor)
        y, aux = tmoe.moe_ffn(cfg, pd, xd, capacity_factor=capacity_factor)
        got[dev.type] = (r.topi.cpu(), dp.keep.cpu(), y.cpu(), aux.cpu())
    (ti_c, k_c, y_c, a_c), (ti_g, k_g, y_g, a_g) = got["cpu"], got["cuda"]
    assert torch.equal(ti_g, ti_c) and torch.equal(k_g, k_c)
    torch.testing.assert_close(y_g, y_c, **LM_LOGIT_TOL)
    torch.testing.assert_close(a_g, a_c, rtol=LOSS_RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "zamba2-7b"])
def test_cuda_remat_same_bits(cuda, arch):
    """On the card too, remat "block" and "full" give remat "none"'s loss and
    gradients bitwise (the dispatch's scatters are deterministic)."""
    base = get_config(arch, reduced=True)
    params = _on(Model(base).init(jr.PRNGKey(3)), cuda)
    batch = TokenStream(vocab=base.vocab, seq_len=8, global_batch=4, seed=1).batch_at(0)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()}
    runs = {}
    for remat in ("none", "block", "full"):
        loss, grads = tstep._grads(Model(base.with_(remat=remat)), params, batch)
        runs[remat] = [loss, *tree_leaves(grads)]
    for remat in ("block", "full"):
        assert all(torch.equal(a, b) for a, b in zip(runs["none"], runs[remat])), remat


def _frames(cfg, batch: int, n_frames: int = 8) -> torch.Tensor | None:
    """Seeded stub frame embeddings for the encoder-decoder family."""
    if cfg.family.value != "enc_dec":
        return None
    return jr.normal(jr.PRNGKey(5), (batch, n_frames, cfg.d_model))


def _moved(x, dev):
    return None if x is None else x.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-large-v3", "gemma2-9b"])
def test_cuda_enc_dec_and_local_global_match_cpu(cuda, arch):
    """The reduced whisper (8 stub frames) and gemma2 (a 12-token prompt and
    steps past its window of 8): prefill and 4 decode steps, logits and every
    cache leaf, card against CPU; whisper's switched steps at modes 0, 1 and a
    vector launch both switch kernels, its windowed expert the exact expert's
    bits; gemma2's switched decoder is refused as in the reference."""
    model = Model(get_config(arch, reduced=True))
    params = model.init(jr.PRNGKey(0))
    prompts = jr.randint(jr.PRNGKey(1), (4, 12), 0, model.cfg.vocab)
    frames = _frames(model.cfg, 4)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = _on(params, dev)
        logits, cache = model.prefill(p, prompts.to(dev), model.init_cache(
            4, 20, dtype=torch.float32, device=dev), encoder_frames=_moved(frames, dev))
        seq, tok = [logits.cpu()], prompts[:, -1:].to(dev)
        for _ in range(4):
            logits, cache = model.decode_step(p, tok, cache)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            seq.append(logits.cpu())
        out[dev.type] = (seq, {k: v.cpu() for k, v in cache.items()}, p, cache, tok)
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(a, b, **LM_LOGIT_TOL)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, **LM_LOGIT_TOL)
    if model.cfg.local_global_pattern:
        with pytest.raises(ValueError, match="uniform attention pattern"):
            SwitchedDecoder(model)
        return
    _, _, p, cache, tok = out["cuda"]
    dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=4))
    before = dict(build.launch_counts)
    for mode in (0, 1, torch.tensor([0, 1, 1, 0], dtype=torch.int32)):
        dec.step(mode, p, tok, cache)
    torch.cuda.synchronize()
    assert build.launch_counts["switch_select"] >= before["switch_select"] + 2
    assert build.launch_counts["switch_select_batched"] == before["switch_select_batched"] + 1
    outs = [e.fn(None, p, tok, cache) for e in dec.bank.experts]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-large-v3", "gemma2-9b"])
def test_cuda_enc_dec_and_local_global_train_step_matches_cpu(cuda, arch):
    """One AdamW step (whisper's frames in the batch), card against CPU."""
    model = Model(get_config(arch, reduced=True))
    params = model.init(jr.PRNGKey(0))
    batch = TokenStream(vocab=model.cfg.vocab, seq_len=12, global_batch=4).batch_at(0)
    frames = _frames(model.cfg, 4)
    if frames is not None:
        batch["encoder_frames"] = frames
    tc = tstep.TrainConfig(learning_rate=LR)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        state = tstep.init_train_state(model, _on(params, dev), tc)
        state, m = tstep.train_step(model, tc, state, batch)
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         [t.cpu() for t in tree_leaves(state.params)])
    (lc, gc, wc), (lg, gg, wg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= LOSS_RTOL * abs(lc) and abs(gg - gc) <= LOSS_RTOL * abs(gc)
    diff = torch.cat([(a - b).abs().ravel() for a, b in zip(wg, wc)])
    assert float(diff.max()) <= 2 * LR
    assert float((diff > WEIGHT_ATOL).float().mean()) <= WEIGHT_OUTLIERS


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_cuda_moe_counts_are_bincounts(cuda, arch, capacity_factor, monkeypatch):
    """On the card the expert counts equal ``bincount``'s, and ``moe_ffn``'s
    output, aux loss and kept mask are the bits the ``bincount`` form gives;
    the kept mask and assignment equal the CPU's."""
    cfg = get_config(arch, reduced=True)
    p = _on(layer(Model(cfg).init(jr.PRNGKey(2))["blocks"]["moe"], 0), cuda)
    x = jr.normal(jr.PRNGKey(3), (2, 16, cfg.d_model))
    r = tmoe.route(cfg, p, x.to(cuda).reshape(-1, cfg.d_model))
    counts = tmoe.expert_counts(r.topi, cfg.moe.n_experts)
    assert torch.equal(counts, torch.bincount(r.topi.reshape(-1), minlength=cfg.moe.n_experts))
    keep = tmoe.dispatch(cfg, r, capacity_factor=capacity_factor).keep
    got = tmoe.moe_ffn(cfg, p, x.to(cuda), capacity_factor=capacity_factor)
    r_cpu = tmoe.route(cfg, _on(p, torch.device("cpu")), x.reshape(-1, cfg.d_model))
    assert torch.equal(r.topi.cpu(), r_cpu.topi)
    assert torch.equal(keep.cpu(), tmoe.dispatch(cfg, r_cpu, capacity_factor=capacity_factor).keep)
    monkeypatch.setattr(tmoe, "expert_counts",
                        lambda t, e: torch.bincount(t.reshape(-1), minlength=e))
    want = tmoe.moe_ffn(cfg, p, x.to(cuda), capacity_factor=capacity_factor)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
