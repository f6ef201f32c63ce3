"""Slot-boundary switching semantics and fail-safe defaults (paper 2, 3.3).

The host loop's mode register, threaded through ``ArchesRuntime.run``:

* ``commit_decision`` -- the dApp commits a decision *during* slot n.
* ``slot_boundary``   -- at the setup phase of slot n+1 the pending decision
  becomes active.  Mid-slot updates are therefore deferred by construction.
* **Fail-safe**: if no valid decision has been committed for ``ttl_slots``
  slots (dApp crash, E3 stall), the active mode decays to the conventional
  default -- the system never depends on the control plane for baseline
  operation.

The reference keeps the register in ``jnp`` scalars so it can ride a jitted
step; here it is the host loop's, so its fields are Python ints and the
active mode reaches the switch kernel by value, with nothing uploaded.  The
batched engine's register is ``repro_torch.core.closed_loop``'s.
"""

from __future__ import annotations

from typing import NamedTuple


class SlotSwitchState(NamedTuple):
    active_mode: int  # consumed by the pipeline this slot
    pending_mode: int  # latest committed decision
    slots_since_decision: int  # staleness counter
    slot_index: int
    n_switches: int  # observability: boundary transitions


def init_switch_state(default_mode: int) -> SlotSwitchState:
    d = int(default_mode)
    return SlotSwitchState(active_mode=d, pending_mode=d, slots_since_decision=0,
                           slot_index=0, n_switches=0)


def commit_decision(state: SlotSwitchState, mode: int,
                    valid: bool = True) -> SlotSwitchState:
    """dApp commits ``mode`` during the current slot (takes effect next slot)."""
    if not valid:
        return state
    return state._replace(pending_mode=int(mode), slots_since_decision=0)


def slot_boundary(state: SlotSwitchState, *, fail_safe_mode: int,
                  ttl_slots: int) -> SlotSwitchState:
    """Advance to slot n+1: apply the pending decision, enforce fail-safe."""
    stale = state.slots_since_decision >= ttl_slots
    new_active = int(fail_safe_mode) if stale else state.pending_mode
    return SlotSwitchState(
        active_mode=new_active,
        pending_mode=new_active,
        slots_since_decision=state.slots_since_decision + 1,
        slot_index=state.slot_index + 1,
        n_switches=state.n_switches + int(new_active != state.active_mode),
    )
