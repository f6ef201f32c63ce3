"""Model facade (port of ``repro.models.model``): one object tying config,
params, forward, loss and serving."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import count_params, materialize


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- params ------------------------------------------------------------
    def defs(self):
        return T.make_defs(self.cfg)

    def init(self, key: torch.Tensor, dtype: torch.dtype | None = None):
        """Weights from ``key`` on its device, drawn as the reference draws them."""
        return materialize(key, self.defs(), dtype=dtype or self.cfg.param_dtype())

    def n_params(self) -> int:
        return count_params(self.defs())

    # -- compute -------------------------------------------------------------
    def forward(self, params, tokens, **kw) -> T.ForwardOut:
        return T.forward(self.cfg, params, tokens, **kw)

    def loss(self, params, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean token cross-entropy over float32 logits, plus the aux loss."""
        out = self.forward(params, tokens)
        logp = torch.log_softmax(out.logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
        return -torch.mean(ll) + out.aux_loss

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device: torch.device | str = "cuda"):
        """An empty KV cache on ``device`` (the card unless the caller asks
        for the CPU)."""
        return D.init_cache(self.cfg, batch, max_seq, dtype, device)

    def prefill(self, params, tokens, cache):
        return D.prefill(self.cfg, params, tokens, cache)

    def decode_step(self, params, tokens, cache):
        return D.decode_step(self.cfg, params, tokens, cache)
