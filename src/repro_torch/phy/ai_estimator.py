"""Expert B: the residual-CNN channel estimator (paper 5.2): inference and
its in-framework training.

Two forms, as in ``repro.phy.ai_estimator``:

* the eager single-UE path of the host loop, ``ai_estimate_from_ls``: the
  convolutions are ``torch.nn.functional.conv2d`` with 'same' padding on
  the raw ``(O, I, kh, kw)`` weights, as the reference runs
  ``lax.conv_general_dilated`` outside any Pallas kernel (with TF32 off,
  which ``resolve_device`` sees to);
* the batched path of the slot engine.  Every 3x3 convolution
runs in the reference's folded-GEMM form: activations in a channel-leading
``(C, W, B, H)`` layout, the symbol axis ``W`` folded into ``(O*W, kh*C*W)``
tap matrices, one matrix product per layer.  The products are plain
``torch.matmul`` (the reference leaves them to XLA too); TF32 is off, so
the float32 path is IEEE float32.

``compute_dtype=torch.bfloat16`` rounds every GEMM *operand* to bf16 and
accumulates in float32, the reference's ``preferred_element_type``
contract: a product of two bf16 values is exact in float32, so the port
upcasts the rounded operands and runs the float32 GEMM.

Structure: naive comb-2 baseline + stem conv + R residual blocks + 2x
sub-pixel up-projection + head conv.

Training (``train_ai_estimator``) runs the eager form under
``torch.autograd`` with the port's AdamW (``repro_torch.optim``), on the
card unless ``device="cpu"`` is given: the reference's training reaches no Pallas kernel either (it
differentiates ``lax.conv_general_dilated`` through XLA), so the
convolutions' backward is PyTorch's.  The trained weight dict feeds
``fold_ai_params`` / ``AiEstimator`` as it is.

``kernel_operands`` packs the same weights in the layout the fused GATED
kernel (``csrc/gated_expert.cu``) reads; ``AiEstimator`` keeps that pack,
bf16-rounded for a bf16 module, beside its folded operands.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten
from repro_torch.phy.nr import SlotConfig


@dataclasses.dataclass(frozen=True)
class AiEstimatorConfig:
    channels: int = 32
    n_res_blocks: int = 4
    kernel_hw: tuple[int, int] = (3, 3)

    def flops(self, cfg: SlotConfig) -> float:
        """Conv MACs x2, all blocks, all antennas (cost-model input)."""
        kh, kw = self.kernel_hw
        hw_in = cfg.n_pilot_sc * cfg.n_dmrs_sym
        hw_out = cfg.n_sc * cfg.n_dmrs_sym
        c = self.channels
        per_ant = (
            2 * kh * kw * 2 * c * hw_in
            + self.n_res_blocks * 2 * (2 * kh * kw * c * c * hw_in)
            + 2 * kh * kw * c * (2 * c) * hw_in
            + 2 * kh * kw * (2 * c) * 2 * hw_out
        )
        return float(cfg.n_ant * per_ant)


def init_params(key: torch.Tensor, cfg: SlotConfig,
                net: AiEstimatorConfig = AiEstimatorConfig()) -> dict[str, Any]:
    """He-initialized weights from ``key``, drawn as the reference draws them."""
    kh, kw = net.kernel_hw
    c = net.channels
    keys = jr.split(key, 3 + 2 * net.n_res_blocks)
    dev = key.device

    def he(k, o, i, scale=2.0):
        s = torch.sqrt(torch.tensor(scale / (i * kh * kw), dtype=torch.float32,
                                    device=dev))
        return jr.normal(k, (o, i, kh, kw)) * s

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

    params = {
        "stem_w": he(keys[0], c, 2),
        "stem_b": zeros(c),
        "up_w": he(keys[1], 2 * c, c),
        "up_b": zeros(2 * c),
        "head_w": he(keys[2], 2, c, scale=1e-4),
        "head_b": zeros(2),
        "res": [],
    }
    for r in range(net.n_res_blocks):
        params["res"].append({
            "w1": he(keys[3 + 2 * r], c, c),
            "b1": zeros(c),
            "w2": he(keys[4 + 2 * r], c, c, scale=0.2),
            "b2": zeros(c),
        })
    return params


# -- eager single-UE path (host loop) -------------------------------------------


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NCHW 'same' conv: ``x (N, C, H, W)``, ``w (O, I, kh, kw)``, ``b (O,)``;
    the bias is added after the convolution, as the reference adds it."""
    return F.conv2d(x, w, padding="same") + b[:, None, None]


def _baseline_interp(x: torch.Tensor) -> torch.Tensor:
    """Naive comb-2 -> full-band interpolation, ``(..., Np, S) -> (..., 2*Np, S)``:
    even subcarriers take the pilot, odd ones the midpoint of the two
    neighbouring pilots (edge clamped)."""
    nxt = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    out = torch.stack([x, 0.5 * (x + nxt)], dim=-2)  # (..., Np, 2, S)
    return out.reshape(*x.shape[:-2], 2 * x.shape[-2], x.shape[-1])


def _forward_one_antenna(params: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """``(N, 2, n_pilot_sc, n_dmrs_sym) -> (N, 2, n_sc, n_dmrs_sym)``: one
    antenna image per leading row (the reference maps it over antennas)."""
    base = _baseline_interp(x)
    h = _conv(x, params["stem_w"], params["stem_b"])
    for blk in params["res"]:
        y = torch.relu(_conv(h, blk["w1"], blk["b1"]))
        h = h + _conv(y, blk["w2"], blk["b2"])
    u = _conv(h, params["up_w"], params["up_b"])  # (N, 2C, Np, S)
    n, c2, n_p, s = u.shape
    c = c2 // 2
    # sub-pixel upsample x2 in frequency (comb-2 -> full band)
    u = u.reshape(n, 2, c, n_p, s).movedim(1, 3).reshape(n, c, 2 * n_p, s)
    return base + _conv(u, params["head_w"], params["head_b"])


def ai_estimate_from_ls(params: dict[str, Any], h_ls: torch.Tensor) -> torch.Tensor:
    """``(n_ant, n_dmrs_sym, n_pilot_sc)`` complex LS -> the AI estimate
    ``(n_ant, 1, n_sc, n_dmrs_sym)`` complex64, contiguous (Expert A's contract)."""
    x = torch.stack([h_ls.real, h_ls.imag], dim=1).to(torch.float32).transpose(-1, -2)
    out = _forward_one_antenna(params, x)  # (ant, 2, n_sc, sym)
    return torch.complex(out[:, 0], out[:, 1])[:, None]


# -- in-framework training ---------------------------------------------------------


def _loss(params: dict[str, Any], h_ls: torch.Tensor, h_true: torch.Tensor) -> torch.Tensor:
    """Task-aligned loss: the estimator's post-MRC EVM contribution.

    The MRC combiner cancels estimation error parallel to the channel vector
    and is hurt by the component that rotates the combining direction, so
    the symbol error an estimate contributes at RE (sc, sym) is, to first
    order, ``|sum_a conj(delta_a) h_a|^2 / (sum_a |h_a|^2)^2``; a small
    plain-MSE anchor keeps early training stable.  Where the antenna sum is
    0 exactly, ``abs``'s gradient is 0 in both frameworks.
    """
    pred = ai_estimate_from_ls(params, h_ls)
    err = pred - h_true  # (ant, 1, sc, sym)
    num = torch.abs(torch.sum(torch.conj(err) * h_true, dim=0)) ** 2  # (1, sc, sym)
    den = torch.sum(torch.abs(h_true) ** 2, dim=0) + 1e-3
    e2e = torch.mean(num / den ** 2)
    mse = torch.mean(err.real ** 2 + err.imag ** 2)
    return e2e + 0.1 * mse


def _train_step(params: dict[str, Any], opt_state, h_ls: torch.Tensor,
                h_true: torch.Tensor, lr: float, opt_cfg: AdamWConfig):
    """One AdamW step on ``_loss``'s gradient: ``(params, opt_state, loss)``."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = _loss(live, h_ls, h_true)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    g_tree = tree_unflatten(live, grads)
    params, opt_state = adamw_update(g_tree, opt_state, params, opt_cfg, learning_rate=lr)
    return params, opt_state, loss.detach()


def train_ai_estimator(
    key: torch.Tensor,
    cfg: SlotConfig,
    sample_fn,
    *,
    net: AiEstimatorConfig = AiEstimatorConfig(),
    steps: int = 600,
    lr: float = 1e-3,
    lr_final_frac: float = 0.05,
    device: torch.device | str = "cuda",
) -> tuple[dict[str, Any], list[float]]:
    """Train Expert B on simulated slots (AdamW + cosine decay) on
    ``device``, through ``resolve_device``: the card by default, which
    raises where there is none, and the host only for ``device="cpu"``.
    ``key`` is moved there, so every key ``sample_fn`` receives and every
    weight lives on ``device``.

    ``sample_fn(key) -> (h_ls, h_true_at_dmrs)`` takes a port key and returns
    shapes ``(n_ant, n_dmrs_sym, n_pilot_sc)`` and ``(n_ant, 1, n_sc,
    n_dmrs_sym)``.  The keys are split as the reference splits them
    (``k_init, k_data = split(key)``, then one ``split(k_data)`` a step), and
    the cosine learning rate is computed on the host in float64 and enters
    the step as a float, as the reference passes it.  Returns the trained
    weight dict and the per-step losses.
    """
    k_init, k_data = jr.split(key.to(resolve_device(device)))
    params = init_params(k_init, cfg, net)
    opt_cfg = AdamWConfig(learning_rate=lr, weight_decay=0.0)
    opt_state = adamw_init(params, opt_cfg)
    losses = []
    for i in range(steps):
        k_data, k = jr.split(k_data)
        h_ls, h_true = sample_fn(k)
        frac = i / max(steps - 1, 1)
        cur_lr = lr * (lr_final_frac + (1 - lr_final_frac) * 0.5 * (
            1 + np.cos(np.pi * frac)))
        params, opt_state, loss = _train_step(params, opt_state, h_ls, h_true,
                                              float(cur_lr), opt_cfg)
        losses.append(float(loss))
    return params, losses


# -- batched path (slot engine) ---------------------------------------------------


def _wfold_matrices(w: torch.Tensor, width: int) -> torch.Tensor:
    """``w (O, C, kh, kw)`` -> ``(kh, O*width, C*width)`` tap matrices with
    ``[d, o*width + wo, c*width + wi] = w[o, c, d, wi - wo + pad]`` (zero
    outside the kernel: the W-direction 'SAME' padding)."""
    o, c, kh, kw = w.shape
    pad = (kw - 1) // 2
    m = torch.zeros((kh, o * width, c * width), dtype=w.dtype, device=w.device)
    for wo in range(width):
        for wi in range(width):
            dj = wi - wo + pad
            if 0 <= dj < kw:
                m[:, wo::width, wi::width] = w[:, :, :, dj].permute(2, 0, 1)
    return m


def fold_ai_params(params: dict[str, Any], width: int) -> dict[str, Any]:
    """Pre-fold every conv kernel into one ``(O*width, kh*C*width)`` operand."""

    def fold(w):
        m = _wfold_matrices(w, width)
        kh = m.shape[0]
        return m.permute(1, 0, 2).reshape(m.shape[1], kh * m.shape[2]).contiguous()

    return {
        "kh": int(params["stem_w"].shape[2]),
        "width": width,
        "stem_w": fold(params["stem_w"]),
        "stem_b": params["stem_b"],
        "up_w": fold(params["up_w"]),
        "up_b": params["up_b"],
        "head_w": fold(params["head_w"]),
        "head_b": params["head_b"],
        "res": [
            {"w1": fold(b["w1"]), "b1": b["b1"], "w2": fold(b["w2"]), "b2": b["b2"]}
            for b in params["res"]
        ],
    }


def _unfold(m2: torch.Tensor, kh: int, width: int) -> torch.Tensor:
    """Invert ``fold``: ``(O*width, kh*C*width)`` -> ``(O, C, kh, 3)`` 3x3-wide
    weights.  A symbol tap no (w_out, w_in) pair reaches stays zero; it only
    ever multiplies the 'SAME' padding, so the convolution is unchanged."""
    o = m2.shape[0] // width
    c = m2.shape[1] // (kh * width)
    m = m2.reshape(o, width, kh, c, width)  # [o, w_out, d, c, w_in]
    w = torch.zeros((o, c, kh, 3), dtype=m2.dtype, device=m2.device)
    for j in range(3):
        for wo in range(width):
            wi = wo + j - 1
            if 0 <= wi < width:
                w[:, :, :, j] = m[:, wo, :, :, wi].permute(0, 2, 1)
                break
    return w


def kernel_operands(folded: dict[str, Any],
                    compute_dtype: torch.dtype | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's operands: ``(weights, biases)``, two contiguous
    float32 vectors holding, layer by layer (stem, each residual block's two
    convs, up-projection, head), the conv weights as ``(C_in, 3, 3, C_out)``
    and the biases, ``C_out`` padded with zeros to a multiple of 4.  With
    ``compute_dtype=torch.bfloat16`` the weights are rounded to bf16 (the
    biases stay float32).  Raises unless every conv is 3x3."""
    kh, width = folded["kh"], folded["width"]
    if kh != 3:
        raise ValueError(f"the fused kernel runs 3x3 convolutions, not kh={kh}")
    layers = [(folded["stem_w"], folded["stem_b"])]
    for blk in folded["res"]:
        layers += [(blk["w1"], blk["b1"]), (blk["w2"], blk["b2"])]
    layers += [(folded["up_w"], folded["up_b"]), (folded["head_w"], folded["head_b"])]
    ws, bs = [], []
    for m2, b in layers:
        w = _unfold(m2, kh, width)
        if not torch.equal(_wfold_matrices(w, width).permute(1, 0, 2).reshape(m2.shape), m2):
            raise ValueError("the fused kernel runs 3x3 convolutions (kernel width is not 3)")
        pad = (-w.shape[0]) % 4
        w = torch.nn.functional.pad(w.permute(1, 2, 3, 0), (0, pad))  # (C, 3, 3, O_p)
        if compute_dtype is not None:
            w = w.to(compute_dtype).to(torch.float32)
        ws.append(w.reshape(-1))
        bs.append(torch.nn.functional.pad(b, (0, pad)))
    return (torch.cat(ws).to(torch.float32).contiguous(),
            torch.cat(bs).to(torch.float32).contiguous())


def _conv_wfold(x: torch.Tensor, m2: torch.Tensor, b: torch.Tensor, kh: int,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """'SAME' conv on ``x (C, W, B, H)`` through one GEMM with ``m2``."""
    c, width, bsz, h = x.shape
    o = m2.shape[0] // width
    pad = (kh - 1) // 2
    xp = torch.nn.functional.pad(x.reshape(c * width, bsz, h), (pad, kh - 1 - pad))
    taps = torch.stack([xp[:, :, d: d + h] for d in range(kh)], dim=0)
    rhs = taps.reshape(kh * c * width, bsz * h)
    if compute_dtype is None:
        y = m2 @ rhs
    else:
        y = m2.to(compute_dtype).to(torch.float32) @ rhs.to(compute_dtype).to(torch.float32)
    return y.reshape(o, width, bsz, h) + b[:, None, None, None]


def _forward_batched(folded: dict[str, Any], x: torch.Tensor,
                     compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``(2, W, B, n_pilot_sc)`` -> ``(2, W, B, n_sc)``, channel-leading."""
    kh = folded["kh"]
    nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    base = torch.stack([x, 0.5 * (x + nxt)], dim=-1).reshape(
        *x.shape[:-1], 2 * x.shape[-1])
    cd = compute_dtype
    h = _conv_wfold(x, folded["stem_w"], folded["stem_b"], kh, cd)
    for blk in folded["res"]:
        y = torch.relu(_conv_wfold(h, blk["w1"], blk["b1"], kh, cd))
        y = _conv_wfold(y, blk["w2"], blk["b2"], kh, cd)
        h = h + y
    u = _conv_wfold(h, folded["up_w"], folded["up_b"], kh, cd)  # (2C, W, B, Np)
    c = u.shape[0] // 2
    u = u.reshape(2, c, *u.shape[1:])  # (2, C, W, B, Np)
    u = u.movedim(0, -1).reshape(c, *u.shape[2:4], 2 * u.shape[4])
    corr = _conv_wfold(u, folded["head_w"], folded["head_b"], kh, cd)
    return base + corr


def ai_estimate_folded(folded: dict[str, Any], h_ls: torch.Tensor, *,
                       compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``(U, ant, n_dmrs_sym, n_pilot_sc)`` LS -> ``(U, ant, 1, n_sc, n_dmrs_sym)``,
    computed in the weights' dtype (float32; float64 weights give a float64
    reference and a complex128 result)."""
    n_ues, n_ant, n_sym, n_p = h_ls.shape
    x = torch.stack([h_ls.real, h_ls.imag], dim=0).to(folded["stem_w"].dtype)
    x = x.permute(0, 3, 1, 2, 4).reshape(2, n_sym, n_ues * n_ant, n_p)
    out = _forward_batched(folded, x, compute_dtype)  # (2, S, B, n_sc)
    h = torch.complex(out[0], out[1])  # (S, B, n_sc)
    h = h.permute(1, 2, 0).reshape(n_ues, n_ant, -1, n_sym)
    # dense, like the reference's result: the switch kernel writes into it
    return h[:, :, None].contiguous()


def ai_estimate_from_ls_batched(params: dict[str, Any], h_ls: torch.Tensor) -> torch.Tensor:
    """``(U, ant, n_dmrs_sym, n_pilot_sc)`` LS -> ``(U, ant, 1, n_sc,
    n_dmrs_sym)``: the multi-UE analogue of ``ai_estimate_from_ls``, the
    weights folded for the LS width and then ``ai_estimate_folded``."""
    return ai_estimate_folded(fold_ai_params(params, h_ls.shape[2]), h_ls)


class AiEstimator(nn.Module):
    """The AI expert as a module: folded weights held as buffers.

    ``forward(h_ls)`` is ``ai_estimate_folded`` with this module's weights
    and operand precision; ``.to(device)`` moves the folded operands and the
    fused kernel's pack (``kernel_w``, ``kernel_b``: ``kernel_operands`` at
    this module's operand precision, rounded once here).
    """

    def __init__(self, params: dict[str, Any], width: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        folded = fold_ai_params(params, width)
        self.kh = folded["kh"]
        self.width = width
        self.n_res_blocks = len(folded["res"])
        self.compute_dtype = compute_dtype
        for name in ("stem_w", "stem_b", "up_w", "up_b", "head_w", "head_b"):
            self.register_buffer(name, folded[name])
        for r, blk in enumerate(folded["res"]):
            for name, t in blk.items():
                self.register_buffer(f"res{r}_{name}", t)
        if tuple(params["stem_w"].shape[2:]) == (3, 3):
            kernel_w, kernel_b = kernel_operands(folded, compute_dtype)
            self.register_buffer("kernel_w", kernel_w)
            self.register_buffer("kernel_b", kernel_b)

    def folded(self) -> dict[str, Any]:
        return {
            "kh": self.kh, "width": self.width,
            **{n: getattr(self, n) for n in
               ("stem_w", "stem_b", "up_w", "up_b", "head_w", "head_b")},
            "res": [{n: getattr(self, f"res{r}_{n}") for n in ("w1", "b1", "w2", "b2")}
                    for r in range(self.n_res_blocks)],
        }

    def forward(self, h_ls: torch.Tensor) -> torch.Tensor:
        return ai_estimate_folded(self.folded(), h_ls,
                                  compute_dtype=self.compute_dtype)
