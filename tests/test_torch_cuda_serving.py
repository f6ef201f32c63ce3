"""The switch kernels at every element size the reference's switch takes, and
the ARCHES-switched LM decoder on the card.

Marked ``cuda``: each skips where there is no NVIDIA GPU, because a CUDA
kernel has no CPU mode.  This file imports no JAX, so it runs on the card's
machine as it is:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_serving.py``.
"""

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.switch_select import (
    switch_gather_batched_ref,
    switch_scatter,
    switch_select,
    switch_select_batched_ref,
    switch_select_ref,
)

DTYPES = [torch.bfloat16, torch.float16, torch.int32, torch.float32, torch.float64,
          torch.int64, torch.complex64]
#: elements per UE row: whole 16-byte vectors at every size (48), and rows that
#: are not (an odd count of 2-byte elements, 1, 3, 5), so the element-width path
#: runs and must stop at each row's end
ROWS = [48, 1, 3, 5, 49152]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _draw(g, shape, dtype, dev):
    if dtype.is_complex:
        return torch.complex(torch.randn(shape, generator=g, device=dev),
                             torch.randn(shape, generator=g, device=dev))
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    return torch.randint(-2**30, 2**30, shape, generator=g, device=dev, dtype=dtype)


def _bits(x):
    """A tensor's raw bytes, so NaN payloads and signed zeros compare too."""
    return x.contiguous().view(torch.uint8) if not x.is_complex() else \
        torch.view_as_real(x).contiguous().view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("per_ue", ROWS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cuda_switch_kernels_every_element_size(cuda, dtype, per_ue):
    """The per-UE switch, the scatter and the scalar switch against their plain
    versions, bitwise, on aligned rows and on rows that are not whole 16-byte
    vectors; each kernel launches once a call and leaves its inputs alone."""
    g = torch.Generator(device=cuda).manual_seed(per_ue)
    n_ues = 8
    outs = [_draw(g, (n_ues, per_ue), dtype, cuda) for _ in range(3)]
    kept = [o.clone() for o in outs]
    modes = torch.tensor([0, 1, 2, 1, 0, 2, 2, 1], dtype=torch.int32, device=cuda)
    before = dict(build.launch_counts)
    got = switch_select(modes, outs)
    src = torch.tensor([2, -1, 0, -1, 1, -1, 0, 2], dtype=torch.int32, device=cuda)
    scat = switch_scatter(src, outs[1][:3].contiguous(), outs[0])
    des = outs[0].clone()
    scalar = switch_select(2, [des, outs[1], outs[2]])
    torch.cuda.synchronize()
    assert build.launch_counts["switch_select_batched"] == before["switch_select_batched"] + 1
    assert build.launch_counts["switch_gather_batched"] == before["switch_gather_batched"] + 1
    assert build.launch_counts["switch_select"] == before["switch_select"] + 2
    assert torch.equal(_bits(got), _bits(switch_select_batched_ref(modes, outs)))
    assert torch.equal(_bits(scat), _bits(switch_gather_batched_ref(
        src, outs[1][:3].contiguous(), outs[0])))
    assert scalar.data_ptr() == des.data_ptr()
    assert torch.equal(_bits(scalar), _bits(switch_select_ref(2, outs)))
    assert all(torch.equal(_bits(o), _bits(k)) for o, k in zip(outs, kept))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_cuda_switch_unaligned_rows_stop_at_the_end(cuda, dtype):
    """2-byte leaves offset by one element (not 16-byte aligned) and an odd
    total: every path takes the element-width copy; the bytes past the view
    are never written."""
    g = torch.Generator(device=cuda).manual_seed(7)
    base = [_draw(g, (5 * 7 + 2,), dtype, cuda) for _ in range(2)]
    outs = [b[1:36].reshape(5, 7) for b in base]
    modes = torch.tensor([1, 0, 1, 1, 0], dtype=torch.int32, device=cuda)
    got = switch_select(modes, outs)
    assert torch.equal(_bits(got), _bits(switch_select_batched_ref(modes, outs)))
    guard = base[0].clone()
    switch_select(1, outs)  # in place into base[0][1:36]
    torch.cuda.synchronize()
    assert torch.equal(_bits(base[0][1:36]), _bits(base[1][1:36]))
    assert torch.equal(_bits(base[0][:1]), _bits(guard[:1]))
    assert torch.equal(_bits(base[0][36:]), _bits(guard[36:]))


@pytest.mark.cuda
def test_cuda_switch_rejects_what_it_cannot_move(cuda):
    """On the card the wrappers raise, never fall back: a 1-byte leaf, a bool
    leaf and a complex128 leaf."""
    for dtype in (torch.int8, torch.bool, torch.complex128):
        a = torch.zeros((4, 8), dtype=dtype, device=cuda)
        with pytest.raises(TypeError):
            switch_select(torch.zeros(4, dtype=torch.int32, device=cuda), [a, a.clone()])
        with pytest.raises(TypeError):
            switch_select(1, [a, a.clone()])


def _reduced_granite(dev):
    from repro_torch import random as jr
    from repro_torch.models import Model, get_config

    model = Model(get_config("granite-20b", reduced=True))
    return model, model.init(jr.PRNGKey(0, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, "vector"])
def test_cuda_switched_decode_against_cpu(cuda, mode):
    """The reduced granite decoder, float32, on the card against the same
    weights on the CPU (the plain switches): logits within the float32
    tolerance of two GEMM libraries, the same argmax, the KPMs close, and
    the switch kernel the mode asks for launched once."""
    from repro_torch.device import resolve_device
    from repro_torch.serving import SwitchedDecodeConfig, SwitchedDecoder

    resolve_device("cuda")
    out = {}
    for dev in (torch.device("cpu"), cuda):
        model, params = _reduced_granite(dev)
        dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=4))
        g = torch.Generator().manual_seed(3)
        prompts = torch.randint(0, model.cfg.vocab, (4, 12), generator=g).to(dev)
        _, cache = model.prefill(params, prompts,
                                 model.init_cache(4, 32, dtype=torch.float32, device=dev))
        m = torch.tensor([0, 1, 1, 0], dtype=torch.int32) if mode == "vector" else mode
        before = dict(build.launch_counts)
        logits, new_cache, kpms = dec.step(m, params, prompts[:, -1:], cache)
        name = "switch_select_batched" if mode == "vector" else "switch_select"
        launched = build.launch_counts[name] - before[name]
        out[dev.type] = (logits.cpu(), new_cache["k"].cpu(), kpms, launched)
    (lc, kc, pc, nc), (lg, kg, pg, ng) = out["cpu"], out["cuda"]
    assert nc == 0 and ng == 1
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(kg, kc, rtol=1e-4, atol=1e-5)
    assert torch.equal(lg.argmax(-1), lc.argmax(-1))
    for k in ("entropy", "expert_kl"):
        assert abs(pg[k] - pc[k]) <= 1e-4 * abs(pc[k]) + 1e-6, (k, pg[k], pc[k])


@pytest.mark.cuda
def test_cuda_expert_calls_leave_their_cache_alone(cuda):
    """Each expert's ``decode_step`` on the card leaves the cache it was given
    bitwise as it was, bf16 weights and a bf16 cache; a mode vector's rows
    are the chosen expert's logits, bitwise."""
    from repro_torch import random as jr
    from repro_torch.device import resolve_device
    from repro_torch.models import Model, get_config
    from repro_torch.serving import SwitchedDecodeConfig, SwitchedDecoder

    resolve_device("cuda")
    model = Model(get_config("granite-20b", reduced=True).with_(dtype="bfloat16"))
    params = model.init(jr.PRNGKey(0, cuda))
    dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=4))
    prompts = jr.randint(jr.PRNGKey(1, cuda), (4, 12), 0, model.cfg.vocab)
    _, cache = model.prefill(params, prompts, model.init_cache(4, 32, device=cuda))
    kept = {k: v.clone() for k, v in cache.items()}
    tok = prompts[:, -1:]
    outs = [e.fn(None, params, tok, cache) for e in dec.bank.experts]
    torch.cuda.synchronize()
    assert all(torch.equal(cache[k], kept[k]) for k in kept)
    assert outs[0].dtype is torch.bfloat16
    modes = torch.tensor([1, 0, 0, 1], dtype=torch.int32, device=cuda)
    logits, _, _ = dec.step(modes, params, tok, cache)
    torch.cuda.synchronize()
    for b, m in enumerate(modes.tolist()):
        assert torch.equal(logits[b], outs[m][b])
    assert all(torch.equal(cache[k], kept[k]) for k in kept)
