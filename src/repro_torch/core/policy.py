"""Switching policies (paper 5.3) and the Gini tree trainer.

``fit_decision_tree`` is a copy of the reference's numpy trainer (the same
arithmetic, so identical inputs give an identical tree).
``DecisionTreePolicy`` evaluates one KPM vector with the literal walk on
the host and exports its tables for the in-loop ``tree_infer`` kernel;
``ThresholdPolicy`` is the single-KPM gate with hysteresis.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.tree_infer import tree_infer, tree_infer_ref

# -- trainer -----------------------------------------------------------------


def _gini(y: np.ndarray) -> float:
    if y.size == 0:
        return 0.0
    p = np.bincount(y, minlength=2) / y.size
    return float(1.0 - np.sum(p**2))


def _best_split(x: np.ndarray, y: np.ndarray):
    """Best (feature, threshold, impurity_decrease) for one node."""
    n, f = x.shape
    base = _gini(y)
    best = (0, np.inf, 0.0)
    for j in range(f):
        order = np.argsort(x[:, j], kind="stable")
        xs, ys = x[order, j], y[order]
        distinct = np.nonzero(np.diff(xs) > 0)[0]
        for i in distinct:
            t = 0.5 * (xs[i] + xs[i + 1])
            left, right = ys[: i + 1], ys[i + 1:]
            w = (left.size * _gini(left) + right.size * _gini(right)) / n
            dec = base - w
            if dec > best[2] + 1e-12:
                best = (j, float(t), float(dec))
    return best


@dataclasses.dataclass
class FittedTree:
    feature: np.ndarray  # (2**d - 1,) int32, level order
    threshold: np.ndarray  # (2**d - 1,) float32 (+inf for pass-through nodes)
    leaf_values: np.ndarray  # (2**d,) float32
    depth: int
    n_features: int
    importances: np.ndarray  # (n_features,) normalized impurity decrease


def fit_decision_tree(x: np.ndarray, y: np.ndarray, *, depth: int = 2,
                      min_samples: int = 2) -> FittedTree:
    """Greedy Gini trainer producing a complete (padded) binary tree.

    Unreached/pure nodes become pass-through (threshold=+inf -> always left)
    with the majority label propagated to all their descendant leaves.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.int64)
    n_nodes = 2**depth - 1
    n_leaves = 2**depth
    feature = np.zeros(n_nodes, np.int32)
    threshold = np.full(n_nodes, np.inf, np.float32)
    leaf_values = np.zeros(n_leaves, np.float32)
    importances = np.zeros(x.shape[1], np.float64)
    n_total = max(len(y), 1)

    def majority(yy):
        return float(np.bincount(yy, minlength=2).argmax()) if yy.size else 0.0

    node_data = {0: (x, y)}
    for node in range(n_nodes):
        xx, yy = node_data.get(node, (x[:0], y[:0]))
        left_child, right_child = 2 * node + 1, 2 * node + 2
        split = None
        if yy.size >= min_samples and _gini(yy) > 0:
            j, t, dec = _best_split(xx, yy)
            if np.isfinite(t) and dec > 0:
                split = (j, t, dec)
        if split is None:
            node_data[left_child] = (xx, yy)
            node_data[right_child] = (xx[:0], yy[:0])
        else:
            j, t, dec = split
            feature[node] = j
            threshold[node] = t
            importances[j] += dec * yy.size / n_total
            mask = xx[:, j] > t
            node_data[left_child] = (xx[~mask], yy[~mask])
            node_data[right_child] = (xx[mask], yy[mask])

    for leaf in range(n_leaves):
        xx, yy = node_data.get(n_nodes + leaf, (x[:0], y[:0]))
        if yy.size == 0:
            anc = (n_nodes + leaf - 1) // 2
            while anc > 0 and node_data.get(anc, (None, y[:0]))[1].size == 0:
                anc = (anc - 1) // 2
            yy = node_data.get(anc, (x, y))[1]
        leaf_values[leaf] = majority(yy)

    total = importances.sum()
    if total > 0:
        importances = importances / total
    return FittedTree(
        feature=feature, threshold=threshold, leaf_values=leaf_values,
        depth=depth, n_features=x.shape[1],
        importances=importances.astype(np.float32),
    )


# -- policies ----------------------------------------------------------------


class DecisionTreePolicy:
    """The paper's switching policy: depth-2 Gini tree over 10 KPMs."""

    def __init__(self, tree: FittedTree, feature_names: Sequence[str]):
        if len(feature_names) != tree.n_features:
            raise ValueError("feature_names/tree mismatch")
        self.tree = tree
        self.feature_names = tuple(feature_names)
        self._tables = tuple(torch.as_tensor(a) for a in (
            np.asarray(tree.feature, np.int32),
            np.asarray(tree.threshold, np.float32),
            np.asarray(tree.leaf_values, np.float32)))

    def __call__(self, x) -> int:
        """One KPM vector ``(F,)`` -> int mode (literal walk on the host)."""
        xv = torch.as_tensor(x, dtype=torch.float32).cpu()[None, :]
        return int(tree_infer_ref(xv, *self._tables, self.tree.depth)[0])

    def batch(self, x: torch.Tensor) -> torch.Tensor:
        """Batched ``(B, F)`` inference through the ``tree_infer`` wrapper."""
        tables = [t.to(x.device) for t in self._tables]
        return tree_infer(x.to(torch.float32).contiguous(), *tables,
                          self.tree.depth).to(torch.int32)

    def to_device(self, device: torch.device | str = "cuda"):
        """Export to level-order device tables for in-loop inference, on
        ``device`` (the card unless the caller asks for the CPU)."""
        from repro_torch.core.closed_loop import export_tree_tables

        return export_tree_tables(self.tree.feature, self.tree.threshold,
                                  self.tree.leaf_values, device)


@dataclasses.dataclass
class ThresholdPolicy:
    """Single-KPM gate with hysteresis (paper 9 'threshold-based gating')."""

    feature_idx: int
    threshold: float
    hysteresis: float = 0.0
    mode_above: int = 1
    mode_below: int = 0

    def __call__(self, x, prev_mode: int = 1) -> int:
        v = torch.as_tensor(x, dtype=torch.float32)[self.feature_idx]
        hi = torch.tensor(self.threshold + self.hysteresis, dtype=torch.float32)
        lo = torch.tensor(self.threshold - self.hysteresis, dtype=torch.float32)
        if bool(v > hi):
            return int(self.mode_above)
        if bool(v < lo):
            return int(self.mode_below)
        return int(prev_mode)

    def to_device(self, device: torch.device | str = "cuda"):
        """The gate as device tensors on ``device`` (the card unless the
        caller asks for the CPU)."""
        from repro_torch.core.closed_loop import DeviceThresholdPolicy

        device = resolve_device(device)

        def t(v, dt):
            return torch.tensor(v, dtype=dt, device=device)

        return DeviceThresholdPolicy(
            feature_idx=t(self.feature_idx, torch.int64),
            lo=t(self.threshold - self.hysteresis, torch.float32),
            hi=t(self.threshold + self.hysteresis, torch.float32),
            mode_above=t(self.mode_above, torch.int32),
            mode_below=t(self.mode_below, torch.int32),
        )


# -- policy design from profiled campaigns ------------------------------------


def profile_and_fit_tree(engine, schedule, *, n_slots: int, n_ues: int,
                         depth: int = 2, feature_names: Sequence[str] | None = None,
                         key=None) -> DecisionTreePolicy:
    """Profile both experts on the batched engine and fit the switching tree.

    Runs the labelled ``schedule`` once per expert mode (every slot under
    interference is labelled mode 0 / AI), stacks each campaign's
    per-(slot, UE) KPMs into feature rows, and fits the Gini tree.
    """
    from repro_torch.core.telemetry import SELECTED_KPMS, trajectory_kpm_matrix

    names = tuple(feature_names) if feature_names is not None else SELECTED_KPMS
    labels = np.asarray([0 if schedule(s).interference else 1 for s in range(n_slots)])
    xs, ys = [], []
    for mode in (0, 1):
        _, traj = engine.run(schedule, mode, n_slots=n_slots, n_ues=n_ues, key=key)
        feats = trajectory_kpm_matrix(traj["kpms"], names).cpu().numpy()
        xs.append(feats.reshape(-1, feats.shape[-1]))
        ys.append(np.repeat(labels, n_ues))
    tree = fit_decision_tree(np.concatenate(xs).astype(np.float32),
                             np.concatenate(ys).astype(np.int32), depth=depth)
    return DecisionTreePolicy(tree, names)


# -- Table-1 metrics -----------------------------------------------------------


def classification_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    """Accuracy / precision / recall / specificity / F1 for the positive
    class 0 (AI): the paper labels interference slots mode=0 (Table 1)."""
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    pos = 0
    tp = int(np.sum((y_pred == pos) & (y_true == pos)))
    fp = int(np.sum((y_pred == pos) & (y_true != pos)))
    tn = int(np.sum((y_pred != pos) & (y_true != pos)))
    fn = int(np.sum((y_pred != pos) & (y_true == pos)))
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return {
        "accuracy": (tp + tn) / max(tp + tn + fp + fn, 1),
        "precision": prec,
        "recall": rec,
        "specificity": tn / max(tn + fp, 1),
        "f1": 2 * prec * rec / max(prec + rec, 1e-12),
    }
