"""Decision-tree inference and the closed loop's fused decision phase: the
wrappers of the hand-written kernels and their plain PyTorch versions.

``tree_infer(x, feature, threshold, leaf_values, depth)`` replaces
``repro.kernels.tree_infer.ops.tree_infer``.  It takes the level-order
tables directly (children of node ``n`` are ``2n+1``/``2n+2``; go right if
``x[feature] > threshold``), so there is no ``pack_tree`` step.  On a CUDA
tensor it launches ``csrc/tree_infer.cu`` (or raises); on a CPU tensor it
runs ``tree_infer_ref``, the literal walk the reference uses as its oracle.

``policy_step(state, kpm_vecs, policy, cfg, decide=...)`` is one slot's
decision phase of a ``DeviceTreePolicy`` for every UE -- ring push, window
mean, tree walk, hysteresis register, slot boundary -- in one launch of the
same source's second entry point.  It returns a new state and the raw
decisions and leaves its inputs as they were.  Its plain version
``policy_step_ref`` is the composition the loop runs otherwise,
``switch_update`` then ``switch_boundary``; it runs on a CPU tensor or with
``cfg.backend == "ref"``.  Either launch counts under ``tree_infer``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
#: (x, feature, threshold, leaves, out, rows, features, depth, stream)
_TREE_ARGS = (_P,) * 5 + (_I,) * 3 + (_P,)
#: (state in, kpm, feature, threshold, leaves, state out, raw, n_ues, ring capacity,
#: features, window, depth, hysteresis, decide, stream)
_STEP_ARGS = ((ctypes.POINTER(_P), _P, _P, _P, _P, ctypes.POINTER(_P), _P)
              + (_I,) * 7 + (_P,))
_STATE = _P * 7
#: the policy step keeps a block's window means in shared memory: 8 UEs x F floats
MAX_STEP_FEATURES = 1536


def tree_infer_ref(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
                   leaf_values: torch.Tensor, depth: int) -> torch.Tensor:
    """Plain version: descend the complete binary tree for each row of ``x``."""
    idx = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    feature = feature.to(torch.int64)
    for _ in range(depth):
        f = feature[idx]
        go_right = torch.gather(x, 1, f[:, None])[:, 0] > threshold[idx]
        idx = 2 * idx + 1 + go_right.to(torch.int64)
    return leaf_values[idx - (2**depth - 1)]


def _check_tables(dev: int, feature, threshold, leaf_values, depth: int) -> None:
    n_nodes = 2**depth - 1
    if feature.shape != (n_nodes,) or threshold.shape != (n_nodes,):
        raise ValueError(f"depth {depth} needs {n_nodes} internal nodes")
    if leaf_values.shape != (2**depth,):
        raise ValueError(f"depth {depth} needs {2**depth} leaves")
    if dev < 0:
        return
    for t, dt in ((feature, torch.int32), (threshold, torch.float32),
                  (leaf_values, torch.float32)):
        if t.dtype is not dt or t.get_device() != dev or not t.is_contiguous():
            raise ValueError("the tree kernels need contiguous float32 thresholds and "
                             "leaves and int32 features on the input's device")


def tree_infer(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
               leaf_values: torch.Tensor, depth: int) -> torch.Tensor:
    """Evaluate the tree on ``x (B, F)`` float32 -> float32 predictions ``(B,)``."""
    if x.ndim != 2:
        raise ValueError(f"x must be (B, F), got {tuple(x.shape)}")
    dev = x.get_device()
    _check_tables(dev, feature, threshold, leaf_values, depth)
    if dev < 0:
        return tree_infer_ref(x, feature, threshold, leaf_values, depth)
    if x.dtype is not torch.float32 or not x.is_contiguous():
        raise ValueError("tree_infer kernel needs a contiguous float32 x")
    rows = x.shape[0]
    out = build.unfilled(torch.empty, rows, dtype=torch.float32, device=x.device)
    fn = build.function("tree_infer", "tree_infer_launch", _TREE_ARGS)
    build.check(fn(x.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
                   leaf_values.data_ptr(), out.data_ptr(), rows, x.shape[1], depth,
                   build.stream(x)), "tree_infer")
    build.launch_counts["tree_infer"] += 1
    return out


def policy_step_ref(state, kpm_vecs: torch.Tensor, policy, cfg, *, decide: bool = True):
    """Plain version: ``switch_update`` then ``switch_boundary``.

    Returns ``(state after the boundary, raw decisions)``.
    """
    from repro_torch.core.closed_loop import switch_boundary, switch_update

    state, raw = switch_update(state, kpm_vecs, policy, cfg, decide=decide)
    return switch_boundary(state), raw


def policy_step(state, kpm_vecs: torch.Tensor, policy, cfg, *, decide: bool = True):
    """Slot ``n``'s decision phase and the boundary into slot ``n + 1`` for a
    ``DeviceTreePolicy``: ``(new state, raw decisions (U,) int32)``.

    ``state`` is a ``DeviceSwitchState``, ``kpm_vecs (U, F)`` the slot's
    KPMs in ``cfg.feature_names`` order, ``decide`` False on a periodic
    policy's hold slots.  On a CUDA tensor (``cfg.backend`` "auto", "pallas"
    or "cuda") one launch writes the whole new state; on a CPU tensor, or
    with ``cfg.backend == "ref"``, the plain version runs.
    """
    if cfg.backend not in ("auto", "pallas", "cuda", "ref"):
        raise ValueError(f"unknown policy backend {cfg.backend!r}")
    rings = state.rings
    dev = kpm_vecs.get_device()
    if dev < 0 or cfg.backend == "ref":
        return policy_step_ref(state, kpm_vecs, policy, cfg, decide=decide)
    n_ues, cap, n_feat = rings.buf.shape
    depth = policy.depth
    _check_tables(dev, policy.feature, policy.threshold, policy.leaf_modes, depth)
    if n_feat > MAX_STEP_FEATURES:
        raise ValueError(f"the policy step takes at most {MAX_STEP_FEATURES} KPMs, "
                         f"not {n_feat}")
    ins = (rings.buf, rings.idx, rings.count, state.active_mode, state.pending_mode,
           state.streak, state.n_switches)
    for t, dt, shape in zip(ins + (kpm_vecs,), (torch.float32,) + (torch.int64,) * 2
                            + (torch.int32,) * 4 + (torch.float32,),
                            ((n_ues, cap, n_feat),) + ((n_ues,),) * 6 + ((n_ues, n_feat),)):
        if t.dtype is not dt or t.shape != shape or t.get_device() != dev \
                or not t.is_contiguous():
            raise ValueError(f"policy step needs contiguous {dt} {shape} state and KPMs "
                             f"on one device, got {t.dtype} {tuple(t.shape)}")
    buf = build.unfilled(torch.empty_like, rings.buf)
    i64 = build.unfilled(torch.empty, (2, n_ues), dtype=torch.int64, device=kpm_vecs.device)
    i32 = build.unfilled(torch.empty, (5, n_ues), dtype=torch.int32, device=kpm_vecs.device)
    idx, count = i64
    active, pending, streak, n_switches, raw = i32
    outs = (buf, idx, count, active, pending, streak, n_switches)
    fn = build.function("tree_infer", "policy_step_launch", _STEP_ARGS)
    build.check(fn(_STATE(*[t.data_ptr() for t in ins]), kpm_vecs.data_ptr(),
                   policy.feature.data_ptr(), policy.threshold.data_ptr(),
                   policy.leaf_modes.data_ptr(), _STATE(*[t.data_ptr() for t in outs]),
                   raw.data_ptr(), n_ues, cap, n_feat, min(cfg.window_slots, cap), depth,
                   cfg.hysteresis_slots, int(decide), build.stream(kpm_vecs)), "policy_step")
    build.launch_counts["tree_infer"] += 1
    new = state._replace(rings=rings._replace(buf=buf, idx=idx, count=count),
                         active_mode=active, pending_mode=pending, streak=streak,
                         n_switches=n_switches)
    return new, raw
