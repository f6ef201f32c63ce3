"""Planner input specs (port of ``repro.launch.specs``): ``meta`` tensors
standing in for every (arch x shape x mesh) cell's inputs, caches and train
state, with their partition specs.  Nothing is allocated: a ``meta`` tensor
has a shape and a dtype and no storage, as the reference's
``ShapeDtypeStruct``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.data.tokens import make_batch_specs
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import ShardingRules, local_bytes
from repro_torch.distributed.sharding import spec as axis_spec
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.decode import init_cache
from repro_torch.models.model import Model
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.step import BATCH_AXES, TrainConfig, TrainState, init_train_state

CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "cross_k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "cross_v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "conv": ("layers", "batch", "conv", "ssm_inner"),
    "ssm": ("layers", "batch", "ssm_heads", None, "ssm_state"),
    "index": (),
}


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict[str, torch.Tensor]:
    """Model inputs of one cell as ``meta`` tensors (tokens/labels/frames)."""
    return make_batch_specs(cfg, cell)


def batch_pspecs(specs: dict[str, torch.Tensor], mesh: Any,
                 rules: ShardingRules) -> dict[str, P]:
    return {k: axis_spec(v.shape, BATCH_AXES[k], mesh, rules) for k, v in specs.items()}


def cache_abstract(cfg: ModelConfig, cell: ShapeCell) -> dict[str, torch.Tensor]:
    """The KV/SSM cache of a cell as ``meta`` tensors (bf16, as the reference's)."""
    return init_cache(cfg, cell.global_batch, cell.seq_len, torch.bfloat16, device="meta")


def cache_pspecs(cache_abs: dict[str, torch.Tensor], mesh: Any,
                 rules: ShardingRules) -> dict[str, P]:
    return {k: axis_spec(v.shape, CACHE_AXES[k], mesh, rules) if v.shape else P()
            for k, v in cache_abs.items()}


def logits_pspec(logits: torch.Tensor, mesh: Any, rules: ShardingRules) -> P:
    """The spec of a serving step's last-position logits (B, V): as the
    ``vocab`` constraint leaves them, the reference's output (``P()``)
    gathered from it."""
    return axis_spec(logits.shape, ("batch", "vocab"), mesh, rules)


def train_state_abstract(model: Model, tc: TrainConfig) -> TrainState:
    """The train state (params, AdamW moments, error feedback) as ``meta``
    tensors: ``init_train_state`` over the abstract params."""
    return init_train_state(model, model.abstract_params(), tc)


def _map_nodes(fn, tree: Any) -> Any:
    """``fn`` over the tensors of a tree of dicts, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _map_nodes(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_nodes(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_nodes(fn, v) for v in tree)
    return fn(tree)


def train_state_pspecs(model: Model, state_abs: TrainState, mesh: Any,
                       rules: ShardingRules) -> TrainState:
    """Partition specs of the train state: float32 moments and the error
    feedback residual follow the params; a quantized moment (int8 blocks of
    128 and their scales) puts its block axis on ``"data"`` where it
    divides and replicates otherwise, as the reference does."""
    p_specs = model.param_pspecs(mesh, rules)
    n_params = len(tree_leaves(state_abs.params))
    n_data = mesh.shape.get("data", 1)

    def leaf_spec(x: torch.Tensor) -> P:
        if x.ndim >= 1 and x.shape[0] % n_data == 0 and x.shape[0] >= n_data:
            return P("data", *([None] * (x.ndim - 1)))
        return P(*([None] * x.ndim))

    def like_params(tree_abs: Any) -> Any:
        if len(tree_leaves(tree_abs)) == n_params:
            return p_specs
        return _map_nodes(leaf_spec, tree_abs)

    opt = state_abs.opt
    return TrainState(
        step=P(),
        params=p_specs,
        opt=type(opt)(step=P(), m=like_params(opt.m), v=like_params(opt.v)),
        ef=None if state_abs.ef is None else type(state_abs.ef)(residual=p_specs),
    )


def placed(tensors: Any, specs: Any):
    """``(tensor, spec)`` pairs of a tree of tensors and its tree of specs
    (``None`` leaves, such as a train state without error feedback, skipped)."""
    if isinstance(tensors, torch.Tensor):
        yield tensors, specs
    elif isinstance(tensors, dict):
        for k, v in tensors.items():
            yield from placed(v, specs[k])
    elif isinstance(tensors, (list, tuple)):
        for t, s in zip(tensors, specs, strict=True):
            yield from placed(t, s)
    elif tensors is not None:
        raise TypeError(f"unexpected node {type(tensors)}")


def per_device_bytes(tensors: Any, specs: Any, mesh: Any) -> int:
    """Bytes a device holds of a tree placed by ``specs`` on ``mesh``: each
    leaf's largest shard (every device's, as ``spec`` only splits dims that
    divide)."""
    return sum(local_bytes(t, s, mesh) for t, s in placed(tensors, specs))
