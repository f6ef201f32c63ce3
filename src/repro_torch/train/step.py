"""The training step: loss -> gradients -> clip -> (compress) -> AdamW
(port of ``repro.train.step``).

The step is functional, as the reference's jitted step is: it returns a
new ``TrainState`` and leaves the tensors of the state it was given as
they were, so a state saved by the checkpoint manager restarts the run
exactly.  Gradients come from autograd over ``Model.loss``.  Gradient
accumulation (``TrainConfig.microbatches``) is a Python loop over the
microbatches in the reference's order of operations, where the reference
scans: a float32 zero accumulator, ``g.float() / mb`` added per microbatch
and ``loss / mb`` added to a float32 loss, so the peak activation footprint
is one microbatch.  Under ``cfg.remat`` each block is rematerialised in the
backward pass (``models.transformer``).

The sharded step is the same function on a ``TrainState`` of DTensors
(placed by ``distributed.sharding.distribute`` with ``launch/specs.py``'s
``train_state_pspecs``), called under
``mesh_context``: the batch is placed on ``("pod", "data")`` (a batch of
numpy arrays or plain tensors, which every rank holds whole, is split with
no collective), the gradients come back on the params' placements (a
replicated weight's partial sums all-reduced, a sharded one's
reduce-scattered), and the new state keeps the input's placements, as the
reference's ``out_shardings=(state_ps, P())``; the metrics are plain 0-d
tensors, the same on every rank.  A microbatch is a contiguous slice of
the global batch, as the reference's ``reshape``: the token ids are
gathered (a few bytes a token) and each rank keeps its shard of each
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.distributed import sharding as S
from repro_torch.distributed.compression import (
    ErrorFeedbackState,
    compress_decompress,
    init_error_feedback,
)
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm_clip
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


#: the logical axes of a batch's leaves
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "encoder_frames": ("batch", "frames", "embed_act")}


class TrainState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    params: Any
    opt: AdamWState
    ef: ErrorFeedbackState | None  # gradient-compression error feedback


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    max_grad_norm: float = 1.0
    quantize_moments: bool = False  # int8 first moment, bf16 second
    compress_grads: bool = False  # int8 + error feedback
    microbatches: int = 1  # gradient accumulation

    def adamw(self) -> AdamWConfig:
        return AdamWConfig(learning_rate=self.learning_rate, b1=self.b1, b2=self.b2,
                           weight_decay=self.weight_decay,
                           quantize_moments=self.quantize_moments)


def init_train_state(model: Model, params: Any, tc: TrainConfig) -> TrainState:
    """Step 0 on the params' device."""
    dev = tree_leaves(params)[0].device
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        params=params,
        opt=adamw_init(params, tc.adamw()),
        ef=init_error_feedback(params) if tc.compress_grads else None,
    )


def _grads(model: Model, params: Any, batch: dict) -> tuple[torch.Tensor, Any]:
    """The loss and its gradients in the params' structure and dtypes."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = model.loss(tree_unflatten(params, live), batch["tokens"], batch["labels"],
                          encoder_frames=batch.get("encoder_frames"))
        grads = torch.autograd.grad(loss, live)
    if S.is_dtensor(leaves[0]):  # partial sums reduced onto the params' placements
        grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, grads)


def _on(batch: dict, device: torch.device, like: torch.Tensor) -> dict:
    """The batch's tensors on ``device``, placed on ``("pod", "data")`` when
    the params (``like``) are DTensors."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        if not S.is_dtensor(v):
            v = S.place(torch.as_tensor(v, device=device), BATCH_AXES[k], like=like)
        out[k] = S.constrain(v, BATCH_AXES[k])
    return out


def _micro(batch: dict, mb: int, i: int) -> dict:
    """Microbatch ``i`` of ``mb``: rows ``[i * B / mb, (i + 1) * B / mb)``."""
    out = {}
    for k, v in batch.items():
        whole = S.replicated(v)
        part = whole.reshape(mb, whole.shape[0] // mb, *whole.shape[1:])[i]
        if S.is_dtensor(v):
            part = S.constrain(S.place(part.to_local(), BATCH_AXES[k], like=v), BATCH_AXES[k])
        out[k] = part
    return out


def train_step(model: Model, tc: TrainConfig, state: TrainState,
               batch: dict) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimizer step.  ``batch`` holds ``tokens`` and ``labels`` (B, S)
    as numpy arrays or tensors; they go to the params' device.  Returns the
    new state and ``{"loss", "grad_norm", "step"}`` as 0-d tensors."""
    first = tree_leaves(state.params)[0]
    dev = first.device
    batch = _on(batch, dev, first)
    if tc.microbatches > 1:
        mb = tc.microbatches
        b = batch["tokens"].shape[0]
        if b % mb:
            raise ValueError(f"batch {b} does not split into {mb} microbatches")
        # a 0-d tensor divisor: a true division on every device, as the reference's
        div = torch.full((), mb, dtype=torch.float32, device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), state.params)
        for i in range(mb):
            loss_i, g = _grads(model, state.params, _micro(batch, mb, i))
            grads = tree_map(lambda a, gi: a + gi.to(torch.float32) / div, grads, g)
            loss = loss + loss_i / div
    else:
        loss, grads = _grads(model, state.params, batch)

    grads, gnorm = global_norm_clip(grads, tc.max_grad_norm)
    ef = state.ef
    if tc.compress_grads:
        grads, ef = compress_decompress(grads, ef)
    params, opt = adamw_update(grads, state.opt, state.params, tc.adamw())
    new_state = TrainState(step=state.step + 1, params=params, opt=opt, ef=ef)
    metrics = {"loss": loss, "grad_norm": gnorm, "step": new_state.step}
    return new_state, {k: S.local_value(S.replicated(v)) for k, v in metrics.items()}
