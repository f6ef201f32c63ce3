"""Batch serving engine (port of ``repro.serving.engine``): prefill + decode
loop, optionally ARCHES-switched.

The engine is the host-side request loop around the serve steps --
deliberately thin, mirroring the paper's split (pipeline on the
accelerator, control in the dApp).  ``generate`` runs greedy decoding (or
a caller's sampler); ``generate_switched`` runs the full ARCHES control
loop (E3 telemetry -> dApp policy -> slot-boundary switching with its
fail-safe) over the port's ``ArchesRuntime``.  Both run on the params'
device, with a float32 KV cache as the reference's engine keeps it.  The
encoder-decoder family (whisper) takes ``encoder_frames`` (B, S_enc, D) to
its prefill; the reference's ``generate_switched`` takes none, so it
cannot serve whisper, and the port's takes them as ``generate`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.dapp import DApp, connect_dapp
from repro_torch.core.e3 import E3Agent
from repro_torch.core.runtime import ArchesRuntime, RunHistory
from repro_torch.models.model import Model
from repro_torch.serving.switched import SwitchedDecoder


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, steps)
    history: RunHistory | None = None


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


class ServingEngine:
    def __init__(self, model: Model, params: Any, *, max_seq: int = 4096):
        self.model = model
        self.params = params
        self.max_seq = max_seq

    def _prefill(self, prompts: torch.Tensor, encoder_frames: torch.Tensor | None):
        cache = self.model.init_cache(prompts.shape[0], self.max_seq, dtype=torch.float32,
                                      device=prompts.device)
        return self.model.prefill(self.params, prompts, cache, encoder_frames=encoder_frames)

    def generate(self, prompts: torch.Tensor, n_steps: int, *,
                 encoder_frames: torch.Tensor | None = None,
                 sample: Callable[[torch.Tensor], torch.Tensor] | None = None
                 ) -> GenerationResult:
        """Greedy (or custom-sampler) generation, no switching."""
        logits, cache = self._prefill(prompts, encoder_frames)
        pick = sample or _greedy
        toks = pick(logits)[:, None].to(torch.int32)
        out = [toks]
        for _ in range(n_steps - 1):
            logits, cache = self.model.decode_step(self.params, toks, cache)
            toks = pick(logits)[:, None].to(torch.int32)
            out.append(toks)
        return GenerationResult(tokens=torch.cat(out, dim=1).cpu().numpy())

    def generate_switched(self, prompts: torch.Tensor, n_steps: int, *,
                          decoder: SwitchedDecoder, dapp: DApp, default_mode: int = 1,
                          ttl_slots: int = 16, encoder_frames: torch.Tensor | None = None
                          ) -> GenerationResult:
        """ARCHES-switched generation: the full dApp control loop per decode slot."""
        logits, cache = self._prefill(prompts, encoder_frames)
        first = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)

        agent = E3Agent()
        connect_dapp(agent, dapp)
        runtime = ArchesRuntime(
            decoder.make_slot_fn(self.params),
            agent,
            default_mode=default_mode,
            fail_safe_mode=default_mode,
            ttl_slots=ttl_slots,
            keep_outputs=True,
        )
        history = runtime.run(range(n_steps - 1), carry=(first, cache))
        toks = torch.cat([first] + [r.output for r in history.records], dim=1)
        return GenerationResult(tokens=toks.cpu().numpy(), history=history)
