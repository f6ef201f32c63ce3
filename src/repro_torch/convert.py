"""Carry the reference package's weights and policies into the port.

Inputs are numpy arrays (or anything ``np.asarray`` accepts, such as the
reference's arrays), so this module imports neither ``jax`` nor ``repro``:

* ``ai_params_from_reference`` -- the AI expert's ``init_params`` pytree
  (``stem_w``/``stem_b``/``up_w``/``up_b``/``head_w``/``head_b`` plus a
  ``res`` list of ``w1``/``b1``/``w2``/``b2``) -> the port's weight dict,
  which ``BatchedPuschPipeline`` and ``ArchesSession(ai_params=...)`` take;
* ``tree_policy_from_reference`` -- a fitted tree's level-order
  ``feature``/``threshold``/``leaf_values`` tables -> the port's host
  ``DecisionTreePolicy`` (pass it as ``ArchesSession(host_policies=...)``);
* ``device_tree_policy`` -- the same tables -> a ``DeviceTreePolicy`` on a
  device, for ``BatchedPuschPipeline.run_closed_loop``;
* ``lm_params_from_reference`` -- the side LM stack's param tree (nested
  dicts of arrays, the stacked layer axis leading) -> the port's, dtype for
  dtype (a bfloat16 leaf stays bfloat16).

Trained AI-expert weights (``train_ai_estimator``'s result) carry over
through ``ai_params_from_reference`` like initial ones.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.closed_loop import DeviceTreePolicy, export_tree_tables
from repro_torch.core.policy import DecisionTreePolicy, FittedTree

_AI_KEYS = ("stem_w", "stem_b", "up_w", "up_b", "head_w", "head_b")
_RES_KEYS = ("w1", "b1", "w2", "b2")


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def ai_params_from_reference(params: Any, device: torch.device | str = "cpu") -> dict:
    """The reference's AI-expert pytree -> the port's float32 weight dict."""
    return {
        **{k: _t(params[k], device) for k in _AI_KEYS},
        "res": [{k: _t(blk[k], device) for k in _RES_KEYS} for blk in params["res"]],
    }


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own: exact via float32
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def lm_params_from_reference(params: Any, device: torch.device | str = "cpu") -> Any:
    """The reference's LM param tree -> the port's (same structure and dtypes)."""
    if isinstance(params, dict):
        return {k: lm_params_from_reference(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(lm_params_from_reference(v, device) for v in params)
    return _leaf(params, device)


def tree_policy_from_reference(feature, threshold, leaf_values,
                               feature_names: Sequence[str]) -> DecisionTreePolicy:
    """Level-order tree tables -> the port's host ``DecisionTreePolicy``."""
    feature = np.asarray(feature, np.int32)
    depth = int(feature.shape[0] + 1).bit_length() - 1
    tree = FittedTree(
        feature=feature,
        threshold=np.asarray(threshold, np.float32),
        leaf_values=np.asarray(leaf_values, np.float32),
        depth=depth,
        n_features=len(feature_names),
        importances=np.zeros(len(feature_names), np.float32),
    )
    return DecisionTreePolicy(tree, feature_names)


def device_tree_policy(feature, threshold, leaf_values,
                       device: torch.device | str = "cpu") -> DeviceTreePolicy:
    """Level-order tree tables -> a ``DeviceTreePolicy`` on ``device``."""
    return export_tree_tables(np.asarray(feature), np.asarray(threshold),
                              np.asarray(leaf_values), device=device)
