"""The GATED slice's two kernel modules against ``repro``'s.

On the CPU each wrapper runs its plain PyTorch version.  The scatter is
pure data movement, so it is held bitwise against ``repro``'s plain version
and its Pallas kernel in interpret mode.  The fused gated expert is held
within the AI expert's tolerances against ``repro``'s unfused reference and
its Pallas kernel in interpret mode, and the UEs it must not touch are held
bitwise.  The kernels themselves run on the card
(``test_torch_cuda_kernels.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gated_expert import gated_expert_apply as r_gated_expert_apply
from repro.kernels.switch_select.ops import switch_gather_batched_leaf
from repro.kernels.switch_select.ops import switch_scatter as r_switch_scatter
from repro.phy import ai_estimator as rai
from repro.phy.nr import SlotConfig as RSlotConfig
from repro_torch.convert import ai_params_from_reference
from repro_torch.kernels.gated_expert import gated_expert_apply, gated_expert_apply_ref
from repro_torch.kernels.switch_select import switch_gather_batched_ref, switch_scatter
from repro_torch.phy import ai_estimator as tai
from repro_torch.phy.nr import SlotConfig

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

N_PRB = 24
CFG, RCFG = SlotConfig(n_prb=N_PRB), RSlotConfig(n_prb=N_PRB)
#: the AI expert's tolerances against the reference (test_torch_ai_estimator):
#: the same folded GEMMs summed in another order; bf16 operands can round an
#: activation that differs in its last float32 bit to the neighbouring bf16
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-3, atol=2e-3)


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _compaction(mode: np.ndarray, capacity: int):
    """The bank's stable cumsum partition, in numpy: ``(idx, src)``."""
    is_gated = mode == 0
    pos = np.cumsum(is_gated) - 1
    src = np.where(is_gated & (pos < capacity), pos, -1).astype(np.int32)
    idx = np.argsort(~is_gated, kind="stable")[:capacity].astype(np.int32)
    return idx, src


# -- switch_scatter ---------------------------------------------------------------

SRC_CASES = {
    "mixed": [-1, 0, 2, -1, 1, -1],
    "none": [-1] * 6,
    "all": [0, 1, 2, 0, 1, 2],
}


@pytest.mark.parametrize("shape", [(4, 1, 48, 3), (7,), (3, 5, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("case", sorted(SRC_CASES))
def test_scatter_plain_vs_reference(shape, dtype, case, rng):
    def draw(lead):
        x = rng.normal(size=(lead,) + shape)
        if dtype == np.complex64:
            x = x + 1j * rng.normal(size=(lead,) + shape)
        return x.astype(dtype)

    compact, des = draw(3), draw(6)
    src = np.asarray(SRC_CASES[case], np.int32)
    want = np.asarray(r_switch_scatter(jnp.asarray(src), jnp.asarray(compact),
                                       jnp.asarray(des), backend="ref"))
    kern = np.asarray(switch_gather_batched_leaf(jnp.asarray(src), jnp.asarray(compact),
                                                 jnp.asarray(des), interpret=True))
    np.testing.assert_array_equal(kern, want)
    t_des = torch.as_tensor(des)
    got = switch_scatter(torch.as_tensor(src), torch.as_tensor(compact), t_des)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_des.numpy(), des)  # the plain version copies
    np.testing.assert_array_equal(
        switch_scatter(torch.as_tensor(src), torch.as_tensor(compact), t_des,
                       backend="ref").numpy(), want)


@pytest.mark.parametrize("src", [[-1], [0]])
def test_scatter_single_ue_unit_capacity(src, rng):
    des, compact = _cplx(rng, (1, 40)), _cplx(rng, (1, 40))
    src = np.asarray(src, np.int32)
    want = np.asarray(switch_gather_batched_leaf(jnp.asarray(src), jnp.asarray(compact),
                                                 jnp.asarray(des), interpret=True))
    got = switch_gather_batched_ref(torch.as_tensor(src), torch.as_tensor(compact),
                                    torch.as_tensor(des))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_wrapper_checks():
    """The wrapper's checks, and the card path's plan (``_scatter_plan``, run
    here on CPU tensors): a signature it has validated once still lets no
    wrong dtype, non-contiguous tensor, wrong device or lazy conjugate
    through on a later call."""
    from repro_torch.kernels.switch_select import ops

    src = torch.tensor([0, -1], dtype=torch.int32)
    des = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        switch_scatter(src, torch.zeros(1, 3), des, backend="nope")
    with pytest.raises(ValueError):
        switch_scatter(src, torch.zeros(0, 3), des)  # capacity 0: skip the call
    with pytest.raises(ValueError):
        switch_scatter(src, torch.zeros(1, 4), des)
    with pytest.raises(ValueError):
        switch_scatter(src[:1], torch.zeros(1, 3), des)

    des = torch.zeros(2, 4, dtype=torch.complex64)
    compact = torch.zeros(1, 4, dtype=torch.complex64)
    resolved = []
    for _ in range(2):  # the second call finds the signature validated
        row_bytes, _fn = ops._scatter_plan(src, compact, des, lambda: resolved.append(1))
        assert row_bytes == 32  # 4 complex64 elements of 8 bytes a UE
    assert resolved == [1]  # the kernel's function is looked up once per signature
    cases = [
        (TypeError, src.long(), compact, des),  # int64 src
        (ValueError, src, compact.to(torch.complex128), des),  # compact's dtype
        (ValueError, src, torch.zeros(1, 8, dtype=torch.complex64)[:, ::2], des),  # strided
        (ValueError, torch.tensor([0, 0, -1, -1], dtype=torch.int32)[::2], compact, des),
        (ValueError, src.to("meta"), compact, des),  # another device
        (ValueError, src, compact.to("meta"), des),
        (TypeError, src, compact.conj(), des),  # a lazy conjugate
        (TypeError, src, compact, des.conj()),
    ]
    for exc, s_, c_, d_ in cases:
        with pytest.raises(exc):
            ops._scatter_plan(s_, c_, d_, lambda: resolved.append(1))
    assert resolved == [1]
    with pytest.raises(TypeError):  # a dtype the kernel does not take (1-byte), at first sight
        ops._scatter_plan(src, torch.zeros(1, 4, dtype=torch.int8),
                          torch.zeros(2, 4, dtype=torch.int8), lambda: None)


# -- gated_expert_apply ---------------------------------------------------------------


#: ``repro``'s fold, compiled once per width: the same bits as run eagerly,
#: in a third of the time
_fold_ref = jax.jit(rai.fold_ai_params, static_argnums=1)


def _fold(ref):
    """``repro``'s AI-expert pytree, folded, and the port's copy of it."""
    return ref, _fold_ref(ref, RCFG.n_dmrs_sym), ai_params_from_reference(ref)


@functools.lru_cache(maxsize=None)
def _weights(channels: int, head_scale: float = 1e-4):
    """An AI expert ``channels`` wide with one residual block, drawn with numpy
    as ``init_params`` draws it (He-scaled weights, a near-zero head), but with
    biases that are not zero, so that every bias reaches the output too.  A
    ``head_scale`` of 2 makes the head as strong as the other layers, so that
    the convolutions' rounding, and not the baseline, sets the output's."""
    rng = np.random.default_rng(channels)

    def he(o, i, scale=2.0):
        return jnp.asarray(rng.normal(size=(o, i, 3, 3)) * np.sqrt(scale / (9 * i)), jnp.float32)

    def bias(n):
        return jnp.asarray(0.1 * rng.normal(size=n), jnp.float32)

    c = channels
    return _fold({
        "stem_w": he(c, 2), "stem_b": bias(c), "up_w": he(2 * c, c), "up_b": bias(2 * c),
        "head_w": he(2, c, scale=head_scale), "head_b": bias(2),
        "res": [{"w1": he(c, c), "b1": bias(c), "w2": he(c, c, scale=0.2), "b2": bias(c)}],
    })


@pytest.fixture(scope="module")
def weights():
    rnet = rai.AiEstimatorConfig(channels=8, n_res_blocks=1)
    return _fold(rai.init_params(jax.random.PRNGKey(0), RCFG, rnet))


CASES = [  # (n_ues, capacity, mode)
    (5, 3, [0, 1, 0, 1, 1]),  # one padding row
    (4, 4, [0, 0, 0, 0]),  # all selected
    (4, 2, [1, 1, 1, 1]),  # none selected: every row is padding
    (1, 1, [0]),  # one UE
    (6, 1, [1, 0, 1, 0, 0, 1]),  # K = 1, two UEs overflow
    (5, 5, [1, 0, 1, 1, 0]),  # full capacity
]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize(
    "channels,n_ues,capacity,mode",
    [pytest.param(8, *case, id=f"{case[0]}-{case[1]}-mode{i}") for i, case in enumerate(CASES)]
    # past 64 channels, the card kernel's wide form
    + [pytest.param(72, *CASES[0], id="72ch-5-3")])
def test_gated_expert_plain_vs_reference(weights, channels, bf16, n_ues, capacity, mode, rng):
    ref, rfolded, tparams = weights if channels == 8 else _weights(channels)
    h_ls = _cplx(rng, (n_ues, CFG.n_ant, CFG.n_dmrs_sym, CFG.n_pilot_sc))
    des = _cplx(rng, (n_ues, CFG.n_ant, 1, CFG.n_sc, CFG.n_dmrs_sym))
    idx, src = _compaction(np.asarray(mode), capacity)
    rcd, tcd = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    rargs = (jnp.asarray(idx), jnp.asarray(src), jnp.asarray(h_ls), jnp.asarray(des), rfolded)
    want = np.asarray(r_gated_expert_apply(*rargs, compute_dtype=rcd, backend="ref"))
    kern = np.asarray(r_gated_expert_apply(*rargs, compute_dtype=rcd, backend="pallas",
                                           interpret=True))
    module = tai.AiEstimator(tparams, CFG.n_dmrs_sym, tcd)
    targs = (torch.as_tensor(idx), torch.as_tensor(src), torch.as_tensor(h_ls),
             torch.as_tensor(des))
    got = gated_expert_apply(*targs, module, compute_dtype=tcd).numpy()
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, kern, **tol)
    # the folded-dict form and the explicit oracle request give the same bits
    np.testing.assert_array_equal(
        gated_expert_apply_ref(*targs, module.folded(), compute_dtype=tcd).numpy(), got)
    np.testing.assert_array_equal(
        gated_expert_apply(*targs, module, compute_dtype=tcd, backend="ref").numpy(), got)
    # padding rows' UEs and unselected UEs keep the baseline bitwise
    kept = src < 0
    np.testing.assert_array_equal(got[kept], des[kept])


def test_gated_expert_wrapper_checks(weights):
    _, _, tparams = weights
    module = tai.AiEstimator(tparams, CFG.n_dmrs_sym)
    h = torch.zeros(2, CFG.n_ant, CFG.n_dmrs_sym, CFG.n_pilot_sc, dtype=torch.complex64)
    des = torch.zeros(2, CFG.n_ant, 1, CFG.n_sc, CFG.n_dmrs_sym, dtype=torch.complex64)
    idx, src = torch.tensor([0], dtype=torch.int32), torch.tensor([0, -1], dtype=torch.int32)
    with pytest.raises(ValueError):
        gated_expert_apply(idx, src, h, des, module, backend="nope")
    with pytest.raises(ValueError):
        gated_expert_apply(idx[:0], src, h, des, module)  # capacity 0: skip the call
    with pytest.raises(ValueError):
        gated_expert_apply(idx, src, h, des[:, :, :, :-2], module)
    with pytest.raises(ValueError):
        gated_expert_apply(idx, src, h, des, module, compute_dtype=torch.float16)


@pytest.mark.parametrize("channels,n_res", [(8, 1), (6, 2)])
def test_kernel_operands_drive_a_direct_conv(weights, channels, n_res, rng):
    """The pack the fused kernel reads, (C_in, 3, 3, C_out) per layer with
    C_out padded to 4, run as direct 3x3 convolutions (the kernel's
    arithmetic), equals the folded-GEMM estimator; and a bf16 module packs
    its weights already rounded."""
    from repro_torch import random as jr

    net = tai.AiEstimatorConfig(channels=channels, n_res_blocks=n_res)
    params = tai.init_params(jr.PRNGKey(channels), CFG, net)
    folded = tai.fold_ai_params(params, CFG.n_dmrs_sym)
    w, b = tai.kernel_operands(folded)
    cp = -(-channels // 4) * 4
    shapes = ([(2, channels)] + [(channels, channels)] * (2 * n_res)
              + [(channels, 2 * channels), (channels, 2)])
    layers, wo, bo = [], 0, 0
    for cin, cout in shapes:
        cpad = -(-cout // 4) * 4
        wl = w[wo: wo + cin * 9 * cpad].reshape(cin, 3, 3, cpad)[..., :cout]
        layers.append((wl.permute(3, 0, 1, 2), b[bo: bo + cout]))
        wo, bo = wo + cin * 9 * cpad, bo + cpad
    assert wo == w.numel() and bo == b.numel() and cp <= bo

    h_ls = torch.as_tensor(_cplx(rng, (2, CFG.n_ant, CFG.n_dmrs_sym, CFG.n_pilot_sc)))
    # (U*ant, C, H = subcarrier, W = symbol), the kernel's view of one GEMM column
    x = torch.stack([h_ls.real, h_ls.imag], dim=2).permute(0, 1, 2, 4, 3)
    x = x.reshape(-1, 2, CFG.n_pilot_sc, CFG.n_dmrs_sym)

    def conv(a, layer):
        return torch.nn.functional.conv2d(a, layer[0], layer[1], padding=1)

    h = conv(x, layers[0])
    for r in range(n_res):
        h = h + conv(torch.relu(conv(h, layers[1 + 2 * r])), layers[2 + 2 * r])
    u = conv(h, layers[-2])  # (B, 2C, Np, S) -> channel r*C + c at 2p + r
    u = u.reshape(u.shape[0], 2, channels, CFG.n_pilot_sc, -1).permute(0, 2, 3, 1, 4)
    u = u.reshape(u.shape[0], channels, CFG.n_sc, -1)
    corr = conv(u, layers[-1])
    nxt = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
    base = torch.stack([x, 0.5 * (x + nxt)], dim=3).reshape(corr.shape)
    out = (base + corr).reshape(2, CFG.n_ant, 2, CFG.n_sc, -1)
    got = torch.complex(out[:, :, 0], out[:, :, 1])[:, :, None]
    want = tai.ai_estimate_folded(folded, h_ls)
    torch.testing.assert_close(got, want, **F32_TOL)

    module = tai.AiEstimator(params, CFG.n_dmrs_sym, torch.bfloat16)
    assert torch.equal(module.kernel_w, w.to(torch.bfloat16).to(torch.float32))
    assert torch.equal(module.kernel_b, b)


# -- the card kernel's arithmetic, emulated -------------------------------------------


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """TF32 with round to nearest, ties away from zero (the kernel's integer
    form of cvt.rna.tf32.f32 on finite float32)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """TF32 by truncation: the low 13 mantissa bits cleared."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """A float64 rounded toward zero to float32's 24-bit significand."""
    return (x.view(torch.int64) & -(1 << 29)).view(torch.float64)


def _split(x: torch.Tensor):
    """The kernel's operand split: hi = rna(x), lo = x - hi (exact) truncated,
    both as float64 (their TF32 products are exact there)."""
    hi = _tf32_rna(x)
    return hi.double(), _tf32_trunc(x - hi).double()


#: the card kernel's widest one-chunk form (CP 16, 32, 48 or 64) and its wide
#: form's chunk, in input and output channels alike (csrc/gated_expert.cu)
WIDEST_CP, KC = 64, 32


def _chunking(channels: int) -> tuple[int, int]:
    """The card kernel's ``(padded channels, chunk)`` at a width: up to 64
    channels one chunk of the width padded to 16; past it chunks of 32."""
    if channels <= WIDEST_CP:
        cp = -(-channels // 16) * 16
        return cp, cp
    return -(-channels // KC) * KC, KC


def _conv_3xtf32(x, w, b, cp, form, chunk=None):
    """One tensor-core conv of the kernel: ``x (B, C, H, W)`` float32 (H the
    subcarriers, W the symbols), ``w (O, C, 3, 3)``, ``b (O,)``, input and
    output channels zero-padded to ``cp`` and taken ``chunk`` at a time (the
    kernel's N- and K-chunks; all ``cp`` at once by default).  N-chunk by
    N-chunk, then K-chunk by K-chunk, then tap by tap, ``(d, j)`` in order,
    the k8 steps of a wgmma each add their eight exact products to the
    accumulator and truncate to float32.  ``"kernel"``: a fresh accumulator a
    (K-chunk, tap), lo*hi and hi*lo of every k8 step, then hi*hi, added to a
    float32 sum rounded to nearest.  ``"one_accumulator"``: one accumulator
    over all nine taps (one chunk only).  Returns ``(B, O, H, W)`` float32
    with the bias added."""
    chunk = chunk or cp
    assert form == "kernel" or chunk == cp
    bsz, c, hh, ww = x.shape
    o = w.shape[0]
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1, 0, cp - c))  # zero 'SAME' and channels
    wp = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, cp - c, 0, cp - o))
    out = torch.zeros(bsz * hh * ww, cp, dtype=torch.float32)
    steps = [slice(8 * s, 8 * s + 8) for s in range(chunk // 8)]
    for n0 in range(0, cp, chunk):  # N-chunk
        total = torch.zeros(bsz * hh * ww, chunk, dtype=torch.float32)
        acc = torch.zeros(bsz * hh * ww, chunk, dtype=torch.float64)
        for k0 in range(0, cp, chunk):  # K-chunk
            for d in range(3):
                for j in range(3):
                    a = xp[:, k0:k0 + chunk, d:d + hh, j:j + ww].permute(0, 2, 3, 1)
                    a_hi, a_lo = _split(a.reshape(-1, chunk))
                    b_hi, b_lo = _split(wp[n0:n0 + chunk, k0:k0 + chunk, d, j].T.contiguous())
                    if form == "kernel":
                        acc = torch.zeros_like(acc)
                        order = ([p for k in steps
                                  for p in ((a_lo[:, k], b_hi[k]), (a_hi[:, k], b_lo[k]))]
                                 + [(a_hi[:, k], b_hi[k]) for k in steps])
                    else:
                        order = [p for k in steps for p in ((a_lo[:, k], b_hi[k]),
                                                            (a_hi[:, k], b_lo[k]),
                                                            (a_hi[:, k], b_hi[k]))]
                    for u, v in order:
                        acc = _trunc_f32(torch.addmm(acc, u, v))
                    if form == "kernel":
                        total += acc.float()
        out[:, n0:n0 + chunk] = total if form == "kernel" else acc.float()
    out = out[:, :o].reshape(bsz, hh, ww, o).permute(0, 3, 1, 2)
    return out + b[None, :, None, None]


def _gated_emulated(folded, h_ls: torch.Tensor, form: str) -> torch.Tensor:
    """The fused kernel's estimate for every UE of ``h_ls``: the stem and the
    head in float32 (the kernel runs them as FMAs on the CUDA cores), the
    residual convs and both sub-pixel passes of the up-projection as
    ``_conv_3xtf32`` in the kernel's chunking at this width.  Returns
    ``(U, ant, 1, n_sc, S)`` complex64."""
    channels = folded["stem_w"].shape[0] // folded["width"]
    cp, chunk = _chunking(channels)
    n_res = len(folded["res"])
    w, b = tai.kernel_operands(folded)
    shapes = ([(2, channels)] + [(channels, channels)] * (2 * n_res)
              + [(channels, 2 * channels), (channels, 2)])
    layers, wo, bo = [], 0, 0
    for cin, cout in shapes:
        cpad = -(-cout // 4) * 4
        wl = w[wo: wo + cin * 9 * cpad].reshape(cin, 3, 3, cpad)[..., :cout]
        layers.append((wl.permute(3, 0, 1, 2).contiguous(), b[bo: bo + cout]))
        wo, bo = wo + cin * 9 * cpad, bo + cpad
    n_ues, n_ant, n_sym, n_p = h_ls.shape
    x = torch.stack([h_ls.real, h_ls.imag], dim=2).permute(0, 1, 2, 4, 3)
    x = x.reshape(-1, 2, n_p, n_sym)  # (U*ant, C, H = subcarrier, W = symbol)

    def conv(a, layer):
        return torch.nn.functional.conv2d(a, layer[0], layer[1], padding=1)

    h = conv(x, layers[0])
    for r in range(n_res):
        y = torch.relu(_conv_3xtf32(h, *layers[1 + 2 * r], cp, form, chunk))
        h = h + _conv_3xtf32(y, *layers[2 + 2 * r], cp, form, chunk)
    wu, bu = layers[-2]
    u = torch.stack([_conv_3xtf32(h, wu[r * channels:(r + 1) * channels],
                                  bu[r * channels:(r + 1) * channels], cp, form, chunk)
                     for r in range(2)], dim=3)  # (B, C, Np, phase, S)
    u = u.reshape(u.shape[0], channels, 2 * n_p, n_sym)
    corr = conv(u, layers[-1])
    nxt = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
    base = torch.stack([x, 0.5 * (x + nxt)], dim=3).reshape(corr.shape)
    out = (base + corr).reshape(n_ues, n_ant, 2, 2 * n_p, n_sym)
    return torch.complex(out[:, :, 0], out[:, :, 1])[:, :, None]


def test_gated_expert_3xtf32_order_within_tolerance(weights, rng):
    """Why the card kernel sums its taps apart: its order of arithmetic (3xTF32,
    a fresh truncating accumulator each tap, added to a float32 sum), emulated
    at C 8, R 1, n_prb 24, stays within ``F32_TOL`` of ``repro``'s unfused
    reference.  On one residual conv (the first, on the stem's output), held
    against the same conv in float64, the kernel's per-tap form errs no more
    than a float32 convolution, and one accumulator over all nine taps more
    than twice as much as the per-tap form."""
    ref, rfolded, tparams = weights
    n_ues = 2
    h_ls = _cplx(rng, (n_ues, CFG.n_ant, CFG.n_dmrs_sym, CFG.n_pilot_sc))
    des = _cplx(rng, (n_ues, CFG.n_ant, 1, CFG.n_sc, CFG.n_dmrs_sym))
    idx, src = _compaction(np.zeros(n_ues, np.int64), n_ues)
    want = np.asarray(r_gated_expert_apply(jnp.asarray(idx), jnp.asarray(src), jnp.asarray(h_ls),
                                           jnp.asarray(des), rfolded, backend="ref"))
    folded = tai.AiEstimator(tparams, CFG.n_dmrs_sym).folded()
    th = torch.as_tensor(h_ls)
    np.testing.assert_allclose(_gated_emulated(folded, th, "kernel").numpy(), want, **F32_TOL)

    x = torch.stack([th.real, th.imag], dim=2).permute(0, 1, 2, 4, 3).reshape(-1, 2, CFG.n_pilot_sc,
                                                                             CFG.n_dmrs_sym)
    h = torch.nn.functional.conv2d(x, tparams["stem_w"], tparams["stem_b"], padding=1)
    w1, b1 = tparams["res"][0]["w1"], tparams["res"][0]["b1"]
    exact = torch.nn.functional.conv2d(h.double(), w1.double(), b1.double(), padding=1)
    err = {form: float((_conv_3xtf32(h, w1, b1, 16, form).double() - exact).abs().max())
           for form in ("kernel", "one_accumulator")}
    err["float32"] = float((torch.nn.functional.conv2d(h, w1, b1, padding=1).double()
                            - exact).abs().max())
    assert err["one_accumulator"] > 2 * err["kernel"], err
    assert err["kernel"] <= err["float32"], err  # no worse than a float32 convolution
    # the split's rounding rules, both signs
    v = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-12])
    np.testing.assert_array_equal(_tf32_rna(v).numpy(),
                                  [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0 + 2.0**-10])
    np.testing.assert_array_equal(_tf32_trunc(v).numpy(), [1.0, -1.0, 1.0])


@pytest.mark.parametrize("channels", [48, 64, 72, 96])
def test_gated_expert_chunked_order_within_tolerance(channels, rng):
    """The card kernel's order at the wider widths, emulated at R 1, n_prb 24:
    at 48 and 64 channels one k-tile a tap over all of them (the CP 48 and
    CP 64 forms); at 72 (padded to 96) and 96 the wide form's N-chunks and
    K-chunks of 32, with a fresh truncating accumulator per (K-chunk, tap),
    lo terms first.  With a head as strong as the other layers it stays
    within ``F32_TOL`` of ``repro``'s unfused reference."""
    _, rfolded, tparams = _weights(channels, head_scale=2.0)
    assert _chunking(channels) == ((channels, channels) if channels <= 64 else (96, KC))
    h_ls = _cplx(rng, (2, CFG.n_ant, CFG.n_dmrs_sym, CFG.n_pilot_sc))
    des = _cplx(rng, (2, CFG.n_ant, 1, CFG.n_sc, CFG.n_dmrs_sym))
    idx, src = _compaction(np.zeros(2, np.int64), 2)
    want = np.asarray(r_gated_expert_apply(jnp.asarray(idx), jnp.asarray(src), jnp.asarray(h_ls),
                                           jnp.asarray(des), rfolded, backend="ref"))
    folded = tai.AiEstimator(tparams, CFG.n_dmrs_sym).folded()
    got = _gated_emulated(folded, torch.as_tensor(h_ls), "kernel").numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
