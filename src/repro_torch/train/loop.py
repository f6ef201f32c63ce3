"""Fault-tolerant training loop: checkpoint/restart, failure injection and a
straggler watchdog (port of ``repro.train.loop``).

The loop is host-driven around one step call, as the reference's:

* **checkpoint/restart** -- ``CheckpointManager.maybe_save`` every
  ``save_every`` steps and ``restore_latest`` at every (re)start; a crash,
  or a ``FailureInjector`` fault, resumes from the newest complete
  checkpoint.  The token stream is a pure function of the step and the step
  is functional, so the resumed run continues bitwise like the
  uninterrupted one.
* **straggler watchdog** -- a step slower than ``straggler_factor`` times
  the trailing median is recorded, and ``on_straggler`` is called.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.train.step import TrainState


class InjectedFailure(RuntimeError):
    """Simulated node failure (tests and examples)."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at the given global steps (once each)."""

    fail_at_steps: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    final_step: int
    losses: list[float]
    straggler_events: list[int]
    restarts: int


def run_training(
    *,
    step_fn: Callable[[TrainState, dict], tuple[TrainState, dict]],
    init_state: Callable[[], TrainState],
    data: Callable[[int], Iterator[dict]],
    ckpt: CheckpointManager,
    total_steps: int,
    failure_injector: FailureInjector | None = None,
    max_restarts: int = 3,
    straggler_factor: float = 3.0,
    on_straggler: Callable[[int, float], None] | None = None,
    log_every: int = 10,
    log: Callable[[str], None] = print,
) -> LoopReport:
    """Run to ``total_steps`` with restart-on-failure semantics.

    ``data(start_step)`` returns an iterator positioned at that step
    (deterministic, so a restart replays the exact stream).  A failure past
    ``max_restarts`` restarts propagates.
    """
    losses: list[float] = []
    stragglers: list[int] = []
    restarts = 0

    while True:
        # (re)start: the newest complete checkpoint, or a fresh init
        state = init_state()
        restored = ckpt.restore_latest(state)
        if restored is not None:
            start_step, state = restored
            log(f"[loop] restored checkpoint at step {start_step}")
        else:
            start_step = 0
        it = data(start_step)
        step_times: list[float] = []

        try:
            for step in range(start_step, total_steps):
                batch = next(it)
                if failure_injector is not None:
                    failure_injector.check(step)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                losses.append(loss)

                if len(step_times) >= 5:
                    med = float(np.median(step_times[-20:]))
                    if dt > straggler_factor * med:
                        stragglers.append(step)
                        if on_straggler is not None:
                            on_straggler(step, dt / med)
                step_times.append(dt)

                ckpt.maybe_save(step + 1, state)
                if (step + 1) % log_every == 0:
                    log(f"[loop] step {step + 1}/{total_steps} loss {loss:.4f}")
            ckpt.maybe_save(total_steps, state, force=True)
            return LoopReport(steps_run=len(losses), final_step=total_steps, losses=losses,
                              straggler_events=stragglers, restarts=restarts)
        except InjectedFailure as e:
            restarts += 1
            log(f"[loop] {e} -> restart {restarts}/{max_restarts}")
            if restarts > max_restarts:
                raise
