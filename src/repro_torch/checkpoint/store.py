"""Fault-tolerant checkpointing: atomic writes, keep-k, restart-from-latest.

Port of ``repro.checkpoint.store`` over numpy payloads, with the same on-disk
layout (one ``leaf_NNNNN.npy`` file a leaf and a JSON manifest with the same
keys), so this module's ``load_pytree`` reads a directory the reference
wrote, leaf for leaf.

* **Atomicity** -- a checkpoint is written to ``step_<n>.tmp-<nonce>/`` and
  ``os.rename``d into place only after every leaf and the manifest are
  fsync'd; a crash mid-write never corrupts the restore path.
* **Restart-from-latest** -- ``latest_step`` scans complete checkpoints only
  (manifest present).
* **Keep-k** -- bounded disk use (``keep=None`` keeps everything, which
  delta chains need).
* **bf16-safe** -- bfloat16 leaves round-trip as uint16 payloads plus a dtype
  tag (numpy has no bf16).
* **Delta chains** -- a step tagged (through ``manifest_extra``) as an
  incremental checkpoint carries only what changed since the previous step;
  ``resume_chain`` walks back through the tagged deltas to step 1 or to an
  untagged (monolithic) checkpoint that anchors them.

A tree is nested dicts, lists, tuples and NamedTuples over tensors, numpy
arrays and scalars.  Its leaves' keys are the reference's: a dict's key, a
sequence's index, a NamedTuple field as ``.name``, joined with ``/``; dict
keys are walked in sorted order.  The treedef string is this module's own.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

_MANIFEST = "manifest.json"

#: ``manifest_extra["kind"]`` tag marking a step as an incremental delta in a
#: manifest-chained sequence (``manifest_extra["prev_step"]`` names its
#: predecessor).  Untagged checkpoints are monolithic (full state).
STREAMING_DELTA_KIND = "arches-streaming-delta-v1"


class CheckpointMismatchError(ValueError):
    """The stored checkpoint does not match the restore template (treedef,
    a leaf's shape or a leaf's dtype)."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), path + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (str(i),))]
    if tree is None:
        return []
    return [(path, tree)]


def _treedef(tree: Any) -> str:
    """The tree's structure as a string (leaves are ``*``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (type(tree).__name__ + "("
                + ", ".join(f"{f}={_treedef(getattr(tree, f))}" for f in tree._fields) + ")")
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_treedef(v) for v in tree) + ",)"
    return "None" if tree is None else "*"


def _unflatten(template: Any, leaves) -> Any:
    if isinstance(template, dict):
        # leaves come in sorted-key order; the dict keeps the template's order,
        # which tree code that walks dicts in insertion order sums by
        vals = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: vals[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if template is None:
        return None
    return next(leaves)


def _leaf_paths(tree: Any) -> list[tuple[str, Any]]:
    return [("/".join(p), leaf) for p, leaf in _flatten(tree)]


def _dtype_tag(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array written to disk (bf16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _from_disk(arr: np.ndarray, dtype_tag: str) -> torch.Tensor:
    # ``np.ascontiguousarray`` returns at least one dimension: keep a 0-d leaf 0-d
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype_tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_pytree(tree: Any, directory: str, *, manifest_extra: dict | None = None) -> None:
    """Atomically write ``tree`` to ``directory``.

    ``manifest_extra`` (a plain-JSON dict) is merged into the manifest, so
    a delta chain's ``kind``/``prev_step`` link is published in the same
    atomic rename as the payload; ``leaves``/``treedef`` are reserved.
    """
    doc = dict(manifest_extra or {})
    if "leaves" in doc or "treedef" in doc:
        raise ValueError("manifest_extra may not override leaves/treedef")
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(directory) + ".tmp-", dir=parent)
    try:
        manifest = {}
        for i, (key, leaf) in enumerate(_leaf_paths(tree)):
            arr = _to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest[key] = {"file": fname, "dtype": _dtype_tag(leaf),
                             "shape": list(arr.shape)}
        doc.update({"leaves": manifest, "treedef": _treedef(tree)})
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.rename(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore_pytree(template: Any, directory: str) -> Any:
    """Restore into the structure of ``template``.

    The checkpoint must match the template: the same treedef and, leaf by
    leaf, the same shape and dtype, or ``CheckpointMismatchError``.  A
    tensor leaf comes back as a tensor on the template leaf's device, any
    other leaf as a numpy array.
    """
    with open(os.path.join(directory, _MANIFEST)) as f:
        stored = json.load(f)
    manifest = stored["leaves"]
    treedef = _treedef(template)
    if stored.get("treedef") is not None and stored["treedef"] != treedef:
        raise CheckpointMismatchError(
            f"checkpoint treedef mismatch in {directory}:\n"
            f"  stored:   {stored['treedef']}\n  template: {treedef}")
    leaves = []
    for key, leaf in _leaf_paths(template):
        if key not in manifest:
            raise CheckpointMismatchError(f"checkpoint {directory} has no leaf {key!r}")
        meta = manifest[key]
        t_dtype = _dtype_tag(leaf)
        if meta["dtype"] != t_dtype:
            raise CheckpointMismatchError(
                f"leaf {key!r} dtype mismatch in {directory}: stored {meta['dtype']}, "
                f"template {t_dtype}")
        t_shape = list(np.shape(leaf)) if not isinstance(leaf, torch.Tensor) else list(leaf.shape)
        if list(meta["shape"]) != t_shape:  # bf16 is stored as same-shape uint16
            raise CheckpointMismatchError(
                f"leaf {key!r} shape mismatch in {directory}: stored {meta['shape']}, "
                f"template {t_shape}")
        arr = np.load(os.path.join(directory, meta["file"]))
        if isinstance(leaf, torch.Tensor):
            leaves.append(_from_disk(arr, meta["dtype"]).to(leaf.device))
        else:
            leaves.append(arr)
    return _unflatten(template, iter(leaves))


def load_pytree(directory: str) -> Any:
    """Load a checkpoint without a template, as nested dicts of CPU tensors.

    The manifest's ``a/b/c`` leaf keys rebuild a nested-``dict`` tree: exact
    for checkpoints whose tree was all dicts (the streaming resume state),
    and a plain-data view of any other.  bf16 comes back from its uint16
    payload.
    """
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)["leaves"]
    out: dict = {}
    for key, meta in manifest.items():
        arr = _from_disk(np.load(os.path.join(directory, meta["file"])), meta["dtype"])
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def read_manifest_extra(directory: str) -> dict:
    """The manifest's fields other than the payload's (``manifest_extra``)."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        doc = json.load(f)
    return {k: v for k, v in doc.items() if k not in ("leaves", "treedef")}


def checkpoint_kind(directory: str) -> str | None:
    """A checkpoint's ``kind`` tag (None: untagged, i.e. monolithic)."""
    return read_manifest_extra(directory).get("kind")


def resume_chain(root: str) -> tuple[int | None, list[int]]:
    """The restore path of a delta-chained checkpoint directory.

    Returns ``(anchor, deltas)``: ``deltas`` is the ascending run of
    ``STREAMING_DELTA_KIND`` steps ending at the latest complete step, and
    ``anchor`` the monolithic checkpoint they build on (None when the chain
    reaches step 1, or the directory is empty).  A directory whose latest
    step is monolithic returns ``(latest, [])``.  Raises
    ``CheckpointMismatchError`` on a broken chain (a delta whose
    ``prev_step`` is missing).
    """
    steps = list_steps(root)
    if not steps:
        return None, []
    present = set(steps)
    deltas: list[int] = []
    s = steps[-1]
    while s >= 1 and s in present:
        d = os.path.join(root, f"step_{s:08d}")
        if checkpoint_kind(d) != STREAMING_DELTA_KIND:
            return s, deltas[::-1]
        prev = read_manifest_extra(d).get("prev_step")
        prev = s - 1 if prev is None else int(prev)
        deltas.append(s)
        s = prev
    if s >= 1:
        raise CheckpointMismatchError(
            f"delta chain in {root} is broken: step {deltas[-1]}'s predecessor {s} is "
            f"missing (complete steps: {steps})")
    return None, deltas[::-1]


def list_steps(root: str) -> list[int]:
    """Every *complete* checkpoint step under ``root``, ascending (a crash
    mid-write leaves only ``.tmp-`` directories, which are skipped)."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and ".tmp-" not in name:
            if os.path.exists(os.path.join(root, name, _MANIFEST)):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
    return sorted(steps)


def latest_step(root: str) -> int | None:
    """The newest complete checkpoint step under ``root`` (None if none)."""
    steps = list_steps(root)
    return steps[-1] if steps else None


class CheckpointManager:
    """save-every / keep-k / restore-latest around the atomic store.

    ``keep=None`` disables garbage collection, which delta chains need.
    """

    def __init__(self, root: str, *, save_every: int = 100, keep: int | None = 3):
        self.root = root
        self.save_every = save_every
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def dir_for(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def maybe_save(self, step: int, tree: Any, *, force: bool = False,
                   manifest_extra: dict | None = None) -> bool:
        if not force and (step == 0 or step % self.save_every):
            return False
        save_pytree(tree, self.dir_for(step), manifest_extra=manifest_extra)
        self._gc()
        return True

    def restore_latest(self, template: Any) -> tuple[int, Any] | None:
        step = latest_step(self.root)
        if step is None:
            return None
        return step, restore_pytree(template, self.dir_for(step))

    def steps(self) -> list[int]:
        """Complete checkpoint steps currently kept, ascending."""
        return list_steps(self.root)

    def _gc(self) -> None:
        if self.keep is None:
            return
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.root)
                       if n.startswith("step_") and ".tmp-" not in n)
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir_for(s), ignore_errors=True)
