"""Switchable expert bank (paper 2, 3.1): CONCURRENT, SELECTED_ONLY and GATED.

The mode is a scalar (an int, or a 0-d tensor) for the single-UE host
loop, or an ``(n_ues,)`` vector for the batched engine, in which case every
expert output carries a leading UE axis.

* ``CONCURRENT`` -- every expert runs each slot and the switch kernel
  (``repro_torch.kernels.switch_select``, scalar or per UE) selects the
  output into the designated buffer.
* ``SELECTED_ONLY`` -- with a scalar mode only the selected expert runs (an
  out-of-range mode is clamped, as ``jax.lax.switch`` clamps it); with a
  mode vector every expert runs and the plain gather selects per UE, as the
  reference does.
* ``GATED`` -- the cheap experts run densely on every UE; the designated
  (expensive) expert runs only on the UEs whose mode selects it, compacted
  into a dense capacity-``K`` sub-batch (stable cumsum partition), and the
  scatter kernel puts its rows back over a new copy of the fail-safe
  baseline.  UEs past
  capacity fall back to ``default_mode`` for the slot and are flagged in
  ``BankOutput.overflow``.  ``gated_fused_apply`` replaces the gather /
  expert / scatter triple with one kernel (``repro_torch.kernels.gated_expert``);
  ``audit_threshold`` reverts UEs whose gated output strays too far (NMSE)
  from the fail-safe baseline.

Mode numbering follows the paper: the designated expert comes first (mode
0 means its output is already in the downstream buffer); the fail-safe
expert is ``default_mode``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import cached_const
from repro_torch.ue_reduce import ue_sum
from repro_torch.kernels.switch_select import (
    switch_scatter,
    switch_select,
    switch_select_batched_ref,
    switch_select_ref,
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
    """One entry of the bank: ``fn(params, *inputs) -> tensor`` and its
    static per-call (per UE-slot) costs in FLOPs and device-memory bytes."""

    name: str
    fn: Callable[..., Any]
    params: Any = None
    flops: float = 0.0
    bytes_hbm: float = 0.0


def _batched_nmse(selected: torch.Tensor, baseline: torch.Tensor) -> torch.Tensor:
    """Per-UE NMSE ``sum |sel - base|^2 / sum |base|^2`` over every non-UE
    axis, float32 ``(n_ues,)``: the in-loop accuracy audit of a gated expert
    against the always-computed fail-safe baseline."""
    axes = tuple(range(1, selected.ndim))
    err = ue_sum(torch.abs(selected - baseline).to(torch.float32) ** 2, axes)
    ref = ue_sum(torch.abs(baseline).to(torch.float32) ** 2, axes)
    return err / torch.clamp(ref, min=1e-30)


@dataclasses.dataclass(frozen=True)
class BankOutput:
    """One bank call.

    ``selected`` is the designated buffer after the switch.  ``served_by
    (U,)`` is the expert each UE received (it differs from ``mode`` exactly
    on GATED overflow or an audit trip; batched calls only);
    ``executed_ue (n_experts,)`` counts the UEs each expert actually ran on
    (a scalar call's counts are host facts and stay on the CPU).

    Every expert output stays as its expert wrote it, on any device, as in
    the reference: ``selected`` is a new tensor, except where nothing is
    switched (a scalar mode-0 call, a GATED bank of capacity 0), where it may
    be that output itself.

    * CONCURRENT, mode vector: the per-UE switch writes ``selected`` out of
      place, so ``all_outputs`` are the experts' unswitched outputs and
      ``baseline`` is the fail-safe's.
    * CONCURRENT, scalar mode: the scalar switch kernel works in place, so
      it switches a copy of the designated output (one device copy of the
      estimate per call that may switch: a mode other than the int 0); a
      mode-0 call writes nothing, and its ``selected`` is ``all_outputs[0]``.
    * GATED: the scatter (or the fused expert, on a copy it makes) writes
      ``selected`` out of place, so ``baseline`` is the unswitched fail-safe
      estimate, with or without the audit, and the audit compares against
      it and reverts to it.
    """

    selected: Any
    all_outputs: tuple | None
    mode: torch.Tensor | int
    served_by: torch.Tensor | None = None
    executed_ue: torch.Tensor | None = None
    overflow: torch.Tensor | None = None  # (U,) bool, GATED only
    audit_tripped: torch.Tensor | None = None  # (U,) bool, GATED + audit only
    baseline: Any = None


class ExpertBank:
    """N-expert switchable bank with a uniform downstream interface."""

    def __init__(
        self,
        experts: Sequence[Expert],
        *,
        default_mode: int = 1,
        execution_mode: ExecutionMode = ExecutionMode.CONCURRENT,
        use_pallas_switch: bool = True,
        gated_capacity: int | None = None,
        gated_fused_apply: Callable[..., Any] | None = None,
        audit_threshold: float | None = None,
    ):
        if len(experts) < 2:
            raise ValueError("an expert bank needs at least 2 experts")
        if not 0 <= default_mode < len(experts):
            raise ValueError(f"default_mode {default_mode} out of range")
        execution_mode = ExecutionMode.coerce(execution_mode)
        if execution_mode is ExecutionMode.GATED and default_mode == 0:
            raise ValueError(
                "GATED gates the designated expert (mode 0); the fail-safe "
                "default_mode must be a different, cheap expert"
            )
        if gated_capacity is not None and gated_capacity < 0:
            raise ValueError(f"gated_capacity {gated_capacity} must be >= 0")
        if gated_fused_apply is not None and execution_mode is not ExecutionMode.GATED:
            raise ValueError("gated_fused_apply requires GATED execution")
        if audit_threshold is not None:
            if execution_mode is not ExecutionMode.GATED:
                raise ValueError(
                    "audit_threshold requires GATED execution (the audit "
                    "compares against the densely-run fail-safe baseline)"
                )
            if not audit_threshold > 0:
                raise ValueError(f"audit_threshold {audit_threshold} must be > 0")
        self.experts = tuple(experts)
        self.default_mode = default_mode
        self.execution_mode = execution_mode
        #: True: the hand-written switch and scatter kernels (plain versions
        #: on the CPU); False: the gather oracles on any device
        self.use_pallas_switch = use_pallas_switch
        #: dense sub-batch size for GATED execution; ``None`` == full batch
        #: (no overflow possible), ``0`` == the gated expert never runs
        self.gated_capacity = gated_capacity
        #: optional fused GATED hot path ``(idx, src, base, *inputs) ->
        #: selected`` (a new tensor) in place of the gather / expert / scatter
        #: triple
        self.gated_fused_apply = gated_fused_apply
        #: optional in-loop NMSE audit of the gated expert (GATED only)
        self.audit_threshold = audit_threshold
        #: each expert's span (``bank.<name>``, ``repro_torch.tracing``)
        self._span_names = tuple(f"bank.{e.name}" for e in self.experts)

    @property
    def n_experts(self) -> int:
        return len(self.experts)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(e.name for e in self.experts)

    def __call__(self, mode: torch.Tensor | int, *inputs) -> BankOutput:
        """Run the bank.  A scalar ``mode`` selects one output; an ``(n_ues,)``
        vector gives UE ``u`` expert ``mode[u]``'s output."""
        if isinstance(mode, torch.Tensor):
            mode = mode.to(torch.int32)
            if mode.ndim > 1:
                raise ValueError(f"mode must be a scalar or (n_ues,), got {tuple(mode.shape)}")
        else:
            mode = int(mode)
        batched = isinstance(mode, torch.Tensor) and mode.ndim == 1
        if self.execution_mode is ExecutionMode.GATED:
            if not batched:
                raise ValueError(
                    "GATED execution is the batched path: mode must be an "
                    "(n_ues,) vector (use SELECTED_ONLY for scalar gating)")
            return self._run_gated(mode, *inputs)
        if self.execution_mode is ExecutionMode.CONCURRENT:
            return self._run_concurrent(mode, batched, *inputs)
        return self._run_selected(mode, batched, *inputs)

    def _host_counts(self, counts) -> torch.Tensor:
        return torch.as_tensor(np.asarray(counts, np.int32))

    def _expert(self, i: int, *inputs):
        """Expert ``i`` on ``inputs``, under its span."""
        e = self.experts[i]
        with tracing.span(self._span_names[i]):
            return e.fn(e.params, *inputs)

    def _run_concurrent(self, mode, batched: bool, *inputs) -> BankOutput:
        outputs = tuple(self._expert(i, *inputs) for i in range(self.n_experts))
        if batched:
            with tracing.span("bank.switch"):
                if self.use_pallas_switch:
                    selected = switch_select(mode, list(outputs))
                else:
                    selected = switch_select_batched_ref(mode, list(outputs))
            n_ues = mode.shape[0]
            return BankOutput(
                selected=selected, all_outputs=outputs, mode=mode, served_by=mode,
                executed_ue=torch.full((self.n_experts,), n_ues, dtype=torch.int32,
                                       device=mode.device),
                baseline=outputs[self.default_mode],
            )
        if self.use_pallas_switch:
            # the kernel switches in place: into a copy, so that all_outputs[0]
            # stays the unswitched designated output; mode 0 writes nothing
            designated = outputs[0] if isinstance(mode, int) and mode == 0 else outputs[0].clone()
            selected = switch_select(mode, [designated, *outputs[1:]])
        else:  # oracle path
            selected = switch_select_ref(mode, outputs)
        return BankOutput(selected=selected, all_outputs=outputs, mode=mode,
                          executed_ue=self._host_counts([1] * self.n_experts))

    def _run_selected(self, mode, batched: bool, *inputs) -> BankOutput:
        if batched:
            # per-UE modes: any expert some UE selects must run, so every
            # expert runs and the plain gather selects (no all_outputs)
            outputs = [e.fn(e.params, *inputs) for e in self.experts]
            return BankOutput(
                selected=switch_select_batched_ref(mode, outputs), all_outputs=None,
                mode=mode, served_by=mode,
                executed_ue=torch.full((self.n_experts,), mode.shape[0],
                                       dtype=torch.int32, device=mode.device),
                baseline=outputs[self.default_mode],
            )
        m = int(mode)
        e = self.experts[min(max(m, 0), self.n_experts - 1)]  # clamped, as lax.switch
        return BankOutput(
            selected=e.fn(e.params, *inputs), all_outputs=None, mode=mode,
            executed_ue=self._host_counts(np.arange(self.n_experts) == m))

    def _run_gated(self, mode: torch.Tensor, *inputs) -> BankOutput:
        """Compaction-gated execution: pay only for the selected experts.

        Every input carries a leading ``(n_ues,)`` axis.  The cumsum
        partition and the stable argsort keep the compact sub-batch in UE
        order, so compact row ``k`` is the ``k``-th selecting UE.
        """
        n_ues = mode.shape[0]
        dev = mode.device
        capacity = n_ues if self.gated_capacity is None else min(self.gated_capacity, n_ues)

        with tracing.span("bank.switch"):
            is_gated = mode == 0
            pos = torch.cumsum(is_gated.to(torch.int32), 0, dtype=torch.int32) - 1
            within = is_gated & (pos < capacity)
            overflow = is_gated & ~within
            src = torch.where(within, pos, torch.full_like(pos, -1))
            # overflow UEs fall back to the fail-safe expert for this slot
            eff_mode = torch.where(overflow, torch.full_like(mode, self.default_mode), mode)

        # cheap experts run densely on all UEs
        alt_outputs = [self._expert(i, *inputs) for i in range(1, self.n_experts)]
        if len(alt_outputs) == 1:
            base = alt_outputs[0]
        else:
            # values at gated UEs are placeholders (overwritten below)
            with tracing.span("bank.switch"):
                base = switch_select_batched_ref(torch.clamp(eff_mode, min=1) - 1,
                                                 alt_outputs)

        if capacity > 0:
            with tracing.span("bank.switch"):
                order = torch.argsort((~is_gated).to(torch.int32), stable=True)
                idx = order[:capacity].to(torch.int32)
            if self.gated_fused_apply is not None:
                # gather, the designated expert and the scatter in one launch
                with tracing.span(self._span_names[0]):
                    selected = self.gated_fused_apply(idx, src, base, *inputs)
            else:
                with tracing.span("bank.switch"):
                    compact_inputs = [x.index_select(0, idx.to(torch.int64)) for x in inputs]
                compact_out = self._expert(0, *compact_inputs)
                with tracing.span("bank.switch"):
                    selected = switch_scatter(
                        src, compact_out, base,
                        backend="auto" if self.use_pallas_switch else "ref")
        else:
            selected = base

        served_by = torch.where(within, torch.zeros_like(eff_mode), eff_mode)
        audit_tripped = None
        if self.audit_threshold is not None and capacity > 0:
            nmse = _batched_nmse(selected, base)
            # NaN/inf-safe: anything not provably within the threshold trips
            tripped = within & ~(nmse <= self.audit_threshold)
            selected = torch.where(tripped.reshape((-1,) + (1,) * (selected.ndim - 1)),
                                   base, selected)
            served_by = torch.where(tripped, torch.full_like(served_by, self.default_mode),
                                    served_by)
            audit_tripped = tripped

        n_gated = within.sum(dtype=torch.int32).reshape(1)
        executed = torch.cat([n_gated, torch.full((self.n_experts - 1,), n_ues,
                                                  dtype=torch.int32, device=dev)])
        return BankOutput(
            selected=selected, all_outputs=None, mode=mode, served_by=served_by,
            executed_ue=executed, overflow=overflow, audit_tripped=audit_tripped,
            baseline=base,
        )

    # -- cost model ---------------------------------------------------------------

    def flops_for(self, mode: int | None = None) -> float:
        """FLOPs per call: every expert (CONCURRENT) or the selected one
        (SELECTED_ONLY)."""
        flops = [e.flops for e in self.experts]
        if self.execution_mode is ExecutionMode.CONCURRENT:
            return float(sum(flops))
        if self.execution_mode is ExecutionMode.GATED:
            raise ValueError("GATED cost depends on the realized mode mix: use "
                             "executed_flops(out)")
        if mode is None:
            raise ValueError("SELECTED_ONLY cost depends on the mode: pass it")
        return float(flops[mode])

    def bytes_for(self, mode: int | None = None) -> float:
        """Device-memory bytes per call: every expert (CONCURRENT) or the
        selected one (SELECTED_ONLY)."""
        if self.execution_mode is ExecutionMode.CONCURRENT:
            return float(sum(e.bytes_hbm for e in self.experts))
        if self.execution_mode is ExecutionMode.GATED:
            raise ValueError("GATED cost depends on the realized mode mix: use "
                             "executed_bytes(out)")
        if mode is None:
            raise ValueError("SELECTED_ONLY cost depends on the mode: pass it")
        return float(self.experts[mode].bytes_hbm)

    def _executed(self, out: BankOutput, key: str, costs: tuple[float, ...]) -> torch.Tensor:
        if out.executed_ue is None:
            raise ValueError("BankOutput carries no executed_ue counts")
        dev = out.executed_ue.device
        per_expert = cached_const((key,) + costs, dev, lambda: np.asarray(costs, np.float32))
        return (out.executed_ue.to(torch.float32) * per_expert).sum()

    def executed_flops(self, out: BankOutput) -> torch.Tensor:
        """FLOPs this call executed: ``sum_e executed_ue[e] * flops[e]``."""
        return self._executed(out, "bank_flops", tuple(e.flops for e in self.experts))

    def executed_bytes(self, out: BankOutput) -> torch.Tensor:
        """Device-memory bytes this call moved: ``sum_e executed_ue[e] *
        bytes_hbm[e]``."""
        return self._executed(out, "bank_bytes", tuple(e.bytes_hbm for e in self.experts))

    def provisioned_flops(self, n_ues: int) -> float:
        """Per-slot FLOPs the hardware is provisioned for: the GATED sub-batch
        always holds ``capacity`` rows, whatever the AI share."""
        if self.execution_mode is ExecutionMode.CONCURRENT:
            return float(n_ues * sum(e.flops for e in self.experts))
        if self.execution_mode is not ExecutionMode.GATED:
            raise ValueError("provisioned cost is per-mode in SELECTED_ONLY: "
                             "use n_ues * flops_for(mode)")
        cap = n_ues if self.gated_capacity is None else min(self.gated_capacity, n_ues)
        return float(cap * self.experts[0].flops
                     + n_ues * sum(e.flops for e in self.experts[1:]))

    def executed_flops_per_ue(self, out: BankOutput) -> torch.Tensor:
        """Per-UE executed FLOPs ``(U,)`` float32 (batched calls only); sums
        to ``executed_flops``."""
        if out.served_by is None:
            raise ValueError("per-UE accounting needs a batched (vector) call")
        # float32 sums on the host, as the reference sums its flops vector
        flops = torch.tensor([e.flops for e in self.experts], dtype=torch.float32)
        if self.execution_mode is ExecutionMode.GATED:
            ai_ran = out.served_by == 0
            if out.audit_tripped is not None:
                # a tripped UE is served by the fail-safe, but the gated
                # expert did run for it: the cost is real
                ai_ran = ai_ran | out.audit_tripped
            return float(flops[1:].sum()) + float(flops[0]) * ai_ran.to(torch.float32)
        return torch.full(out.served_by.shape, float(flops.sum()), dtype=torch.float32,
                          device=out.served_by.device)
