"""Switchable expert bank (paper 2, 3.1), CONCURRENT execution.

Every expert runs on every UE each slot and the per-UE switch kernel
(``repro_torch.kernels.switch_select``) selects each UE's output into the
designated buffer.  Mode numbering follows the paper: the designated
expert comes first (mode 0 means its output is already in the downstream
buffer); the fail-safe expert is ``default_mode``.

The GATED and SELECTED_ONLY modes of the reference wait for a later slice
(ROADMAP, Queue 1 item 2) and raise here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Sequence

import torch

from repro_torch.kernels.switch_select import (
    switch_select,
    switch_select_batched_ref,
)


def coerce_enum(cls: type, value, noun: str):
    """Accept an enum member or its string value (the spec/JSON form)."""
    if isinstance(value, cls):
        return value
    try:
        return cls(str(value).lower())
    except ValueError:
        raise ValueError(
            f"unknown {noun} {value!r}; one of {[m.value for m in cls]}"
        ) from None


class ExecutionMode(enum.Enum):
    CONCURRENT = "concurrent"
    SELECTED_ONLY = "selected_only"
    GATED = "gated"

    @classmethod
    def coerce(cls, value: "ExecutionMode | str") -> "ExecutionMode":
        return coerce_enum(cls, value, "execution mode")


@dataclasses.dataclass(frozen=True)
class Expert:
    """One entry of the bank: ``fn(params, *inputs) -> (U, ...) tensor`` and
    its static per-UE-slot cost in FLOPs."""

    name: str
    fn: Callable[..., Any]
    params: Any = None
    flops: float = 0.0


@dataclasses.dataclass(frozen=True)
class BankOutput:
    """``selected`` is the designated buffer after the switch.  On the card
    the switch runs in place, so ``all_outputs[0]`` is that same switched
    buffer (the reference keeps it unswitched); the other entries are the
    alternatives' untouched outputs.  ``served_by (U,)`` is the expert each
    UE received."""

    selected: Any
    all_outputs: tuple
    mode: torch.Tensor
    served_by: torch.Tensor


class ExpertBank:
    """N-expert switchable bank with a uniform downstream interface."""

    def __init__(
        self,
        experts: Sequence[Expert],
        *,
        default_mode: int = 1,
        execution_mode: ExecutionMode = ExecutionMode.CONCURRENT,
        use_pallas_switch: bool = True,
    ):
        if len(experts) < 2:
            raise ValueError("an expert bank needs at least 2 experts")
        if not 0 <= default_mode < len(experts):
            raise ValueError(f"default_mode {default_mode} out of range")
        execution_mode = ExecutionMode.coerce(execution_mode)
        if execution_mode is not ExecutionMode.CONCURRENT:
            raise NotImplementedError(
                f"{execution_mode.value} execution is not ported yet "
                "(ROADMAP, Queue 1 item 2: GATED path)"
            )
        self.experts = tuple(experts)
        self.default_mode = default_mode
        self.execution_mode = execution_mode
        #: True: the hand-written switch kernel (plain version on the CPU);
        #: False: the gather oracle on any device
        self.use_pallas_switch = use_pallas_switch

    def __call__(self, mode: torch.Tensor, *inputs) -> BankOutput:
        """Run every expert; UE ``u`` receives expert ``mode[u]``'s output."""
        mode = mode.to(torch.int32)
        if mode.ndim != 1:
            raise ValueError("the port's bank is batched: mode must be (n_ues,)")
        outputs = tuple(e.fn(e.params, *inputs) for e in self.experts)
        if self.use_pallas_switch:
            selected = switch_select(mode, list(outputs))
        else:
            selected = switch_select_batched_ref(mode, list(outputs))
        return BankOutput(selected=selected, all_outputs=outputs, mode=mode,
                          served_by=mode)

    def executed_flops_per_ue(self, out: BankOutput) -> torch.Tensor:
        """Per-UE executed FLOPs: every expert ran every UE."""
        total = torch.tensor([e.flops for e in self.experts],
                             dtype=torch.float32).sum()
        return torch.full(out.served_by.shape, float(total), dtype=torch.float32,
                          device=out.served_by.device)
