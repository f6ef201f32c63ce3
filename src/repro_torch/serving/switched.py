"""ARCHES-switched LM decoding (port of ``repro.serving.switched``): the
paper's mechanism generalized to serving ("only the experts and telemetry
inputs change").

Expert bank over two decode-attention implementations:

  Expert 0 (designated):  **exact** decode attention over the full KV cache
    -- highest quality, cost grows with context length.
  Expert 1 (fail-safe):   **windowed** decode attention over the last W
    cache positions -- bounded cost, approximate at long range.

Mapping to the paper's machinery:
  * the switch is the port's hand-written switch kernel over the logits
    buffer: the scalar switch (``switch_select_scalar_launch``) for a scalar
    mode, the per-UE switch (``copy_rows_kernel``) for a ``(batch,)`` mode
    vector, on the logits' own element type (bf16 at full width);
  * decisions take effect at decode-step ("slot") boundaries through the
    ``ArchesRuntime`` switch register with its fail-safe decay;
  * telemetry is KPMs per decode step: logit entropy, expert agreement (KL,
    argmax agreement), cache occupancy and per-expert cost proxies.

A switched step runs ``decode_step`` three times: once for the new cache
and once per expert.  Each expert decodes from the cache it is given and
leaves it as it was (the cache update is out of place), so the three calls
see the same cache, as the reference's functional update guarantees.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.expert_bank import ExecutionMode, Expert, ExpertBank
from repro_torch.models.model import Model


@dataclasses.dataclass(frozen=True)
class SwitchedDecodeConfig:
    window: int = 512  # windowed expert's attention span
    execution_mode: ExecutionMode = ExecutionMode.CONCURRENT
    # False: the bank's plain switch on any device (the oracle path)
    use_pallas_switch: bool = True


def _kv_bytes(cfg, positions: int) -> float:
    """Bytes of K and V read from a bf16 cache over ``positions`` (the
    experts' cost proxy, as the reference defines it)."""
    return float(2 * cfg.n_layers * positions * cfg.n_kv_heads * cfg.resolved_head_dim * 2)


class SwitchedDecoder:
    """Expert-bank decode step + per-slot KPM extraction."""

    def __init__(self, model: Model, sw: SwitchedDecodeConfig = SwitchedDecodeConfig()):
        if model.cfg.local_global_pattern:
            raise ValueError(
                "switched decode assumes a uniform attention pattern; "
                "gemma2-style alternation already hard-codes locality")
        self.model = model
        self.sw = sw
        self.cfg_exact = model.cfg
        self.cfg_win = model.cfg.with_(sliding_window=sw.window)
        self.model_win = Model(self.cfg_win)

        def exact_fn(_bank_params, params, tokens, cache):
            return self.model.decode_step(params, tokens, cache)[0]

        def win_fn(_bank_params, params, tokens, cache):
            return self.model_win.decode_step(params, tokens, cache)[0]

        self.bank = ExpertBank(
            [Expert(name="exact", fn=exact_fn, bytes_hbm=_kv_bytes(model.cfg, 32768)),
             Expert(name="windowed", fn=win_fn, bytes_hbm=_kv_bytes(model.cfg, sw.window))],
            default_mode=1,
            execution_mode=sw.execution_mode,
            use_pallas_switch=sw.use_pallas_switch,
        )

    def _mode(self, mode, device) -> int | torch.Tensor:
        """A scalar mode as an int (the scalar switch takes it by value); a
        ``(batch,)`` vector as int32 on the logits' device."""
        if isinstance(mode, torch.Tensor) and mode.ndim == 0:
            return int(mode)
        if isinstance(mode, int):
            return mode
        return torch.as_tensor(mode, dtype=torch.int32).to(device)

    def _step(self, mode, params, tokens, cache):
        # the cache update is expert-independent (the same K/V insert): once
        _, new_cache = self.model.decode_step(params, tokens, cache)
        out = self.bank(mode, params, tokens, cache)
        logits = out.selected
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        entropy = -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))
        if out.all_outputs is not None:
            la, lb = out.all_outputs
            pa = torch.log_softmax(la.to(torch.float32), -1)
            pb = torch.log_softmax(lb.to(torch.float32), -1)
            kl = torch.mean(torch.sum(torch.exp(pa) * (pa - pb), dim=-1))
            agree = torch.mean((torch.argmax(la, -1) == torch.argmax(lb, -1)).to(torch.float32))
        else:
            kl = torch.zeros((), device=logits.device)
            agree = torch.ones((), device=logits.device)
        return logits, new_cache, {"entropy": entropy, "expert_kl": kl, "expert_agree": agree}

    def step(self, mode, params, tokens: torch.Tensor,
             cache: dict[str, Any]) -> tuple[torch.Tensor, dict[str, Any], dict[str, float]]:
        """One decode slot. Returns (logits, cache, host KPMs).

        ``mode`` may be a scalar (the whole batch follows one expert; the
        scalar switch kernel) or a ``(batch,)`` vector, the serving analogue
        of the PHY engine's per-UE mode vector: each sequence independently
        selects exact or windowed attention, routed by the per-UE switch
        kernel over the per-sequence logits rows.
        """
        logits, cache, kpms = self._step(self._mode(mode, tokens.device), params, tokens,
                                         cache)
        vals = torch.stack([kpms["entropy"], kpms["expert_kl"], kpms["expert_agree"],
                            cache["index"].to(torch.float32)]).cpu().tolist()
        max_seq = cache["k"].shape[2] if "k" in cache else 1  # an SSM cache has no length
        host_kpms = {
            "entropy": vals[0],
            "expert_kl": vals[1],
            "expert_agree": vals[2],
            "cache_occupancy": vals[3] / max_seq,
            "exact_cost_bytes": self.bank.experts[0].bytes_hbm,
            "windowed_cost_bytes": self.bank.experts[1].bytes_hbm,
        }
        return logits, cache, host_kpms

    def make_slot_fn(self, params):
        """Adapter for ``ArchesRuntime``: carry = (tokens, cache)."""

        def slot_fn(active_mode, carry, _slot_idx):
            tokens, cache = carry
            logits, cache, kpms = self.step(active_mode, params, tokens, cache)
            next_tokens = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            return (next_tokens, cache), next_tokens, {"serving": kpms}

        return slot_fn


SERVING_KPMS = (
    "entropy",
    "expert_kl",
    "expert_agree",
    "cache_occupancy",
)
