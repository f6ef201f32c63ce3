"""Model facade (port of ``repro.models.model``): one object tying config,
params, forward, loss and serving.  On DTensor logits (the sharded step)
the loss is a vocabulary-parallel cross-entropy (``_sharded_ll``)."""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.distributed import sharding as S
from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import abstract, count_params, materialize, pspecs


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- params ------------------------------------------------------------
    def defs(self):
        return T.make_defs(self.cfg)

    def init(self, key: torch.Tensor, dtype: torch.dtype | None = None):
        """Weights from ``key`` on its device, drawn as the reference draws them."""
        return materialize(key, self.defs(), dtype=dtype or self.cfg.param_dtype())

    def abstract_params(self, dtype: torch.dtype | None = None):
        """The params as ``meta`` tensors (shapes and dtype, no storage)."""
        return abstract(self.defs(), dtype=dtype or self.cfg.param_dtype())

    def param_pspecs(self, mesh, rules):
        return pspecs(self.defs(), mesh, rules)

    def n_params(self) -> int:
        return count_params(self.defs())

    # -- compute -------------------------------------------------------------
    def forward(self, params, tokens, **kw) -> T.ForwardOut:
        return T.forward(self.cfg, params, tokens, **kw)

    def loss(self, params, tokens: torch.Tensor, labels: torch.Tensor, *,
             encoder_frames: torch.Tensor | None = None) -> torch.Tensor:
        """Mean token cross-entropy over float32 logits, plus the aux loss.
        The encoder-decoder family takes ``encoder_frames``."""
        out = self.forward(params, tokens, encoder_frames=encoder_frames)
        logits = out.logits.to(torch.float32)
        if S.is_dtensor(logits):
            return S.replicated(-_sharded_mean(_sharded_ll(logits, labels)) + out.aux_loss)
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
        return -torch.mean(ll) + out.aux_loss

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device: torch.device | str = "cuda"):
        """An empty KV cache on ``device`` (the card unless the caller asks
        for the CPU)."""
        return D.init_cache(self.cfg, batch, max_seq, dtype, device)

    def prefill(self, params, tokens, cache, **kw):
        return D.prefill(self.cfg, params, tokens, cache, **kw)

    def decode_step(self, params, tokens, cache):
        return D.decode_step(self.cfg, params, tokens, cache)


def _pick(z: torch.Tensor, labels: torch.Tensor, v_off: int) -> torch.Tensor:
    """The label's entry of ``z`` (B, S, V_shard) where this shard holds it
    (vocabulary ids from ``v_off`` on), 0 elsewhere."""
    idx = labels.to(torch.int64) - v_off
    mine = (idx >= 0) & (idx < z.shape[-1])
    val = torch.gather(z, -1, torch.clamp(idx, 0, z.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(mine, val, torch.zeros((), dtype=z.dtype, device=z.device))


def _sharded_ll(logits, labels):
    """Token log-likelihoods of float32 logits sharded on ``vocab``, as the
    partitioner computes a log-softmax over a split last dim: the row max
    and the sum of exponentials are reduced over the vocabulary's shards
    (an all-reduce each), and the label's logit is taken on the shard that
    holds it and summed over the shards.  Nothing gathers the logits."""
    from torch.distributed.tensor import Partial

    m = S.constrain(torch.amax(logits, dim=-1, keepdim=True).detach(), ("batch", "seq", None))
    z = logits - m
    lse = torch.log(S.constrain(torch.sum(torch.exp(z), dim=-1), ("batch", "seq")))
    labels = S.constrain(S.place(labels, ("batch", "seq"), like=z), ("batch", "seq"))
    out_pl = tuple(Partial() if getattr(p, "dim", None) == 2 else p for p in z.placements)
    picked = S.local(functools.partial(_pick, v_off=S.shard_offset(z, 2)), z, labels, out=out_pl)
    return S.constrain(picked, ("batch", "seq")) - lse


def _sharded_mean(x):
    """The mean of DTensor ``x``: each rank sums its shard, and the sums are a
    partial sum over the mesh dims that split ``x`` (so the gradient comes
    back on ``x``'s own placements)."""
    from torch.distributed.tensor import Partial, Replicate

    out = tuple(Replicate() if isinstance(p, Replicate) else Partial() for p in x.placements)
    return S.local(torch.sum, x, out=out) / x.numel()
