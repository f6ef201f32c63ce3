"""The port's checkpoint store: its contract (atomic writes, keep-k, restore
validation, bf16, delta chains) as the reference's tests state it, and the
on-disk layout shared with ``repro``: the port's ``load_pytree`` reads a
directory ``repro``'s ``save_pytree`` wrote, leaf for leaf, and the manifest
keys of the same tree agree."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as rstore
from repro_torch.checkpoint.store import (
    STREAMING_DELTA_KIND,
    CheckpointManager,
    CheckpointMismatchError,
    checkpoint_kind,
    latest_step,
    load_pytree,
    read_manifest_extra,
    restore_pytree,
    resume_chain,
    save_pytree,
)
from repro_torch.core.telemetry import KPMRing


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(8, 4, generator=g),
        "b": torch.arange(3, dtype=torch.bfloat16),
        "nested": {"step": np.int32(17 + seed), "ring": KPMRing(
            buf=torch.randn(2, 3, 4, generator=g), idx=torch.arange(2),
            count=torch.full((2,), 5))},
        "seq": [np.arange(4, dtype=np.int64), torch.ones(2, dtype=torch.bool)],
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zeros_like(v) for v in tree))
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return np.zeros_like(tree)


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert type(a) is type(b) or np.shape(a) == np.shape(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_roundtrip_exact(tmp_path):
    t = _tree()
    save_pytree(t, str(tmp_path / "ck"))
    r = restore_pytree(_zeros_like(t), str(tmp_path / "ck"))
    _equal(t, r)
    assert r["b"].dtype == torch.bfloat16
    assert isinstance(r["nested"]["ring"], KPMRing)


def test_latest_step_keep_k_and_save_every(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"), save_every=1, keep=2)
    for s in range(1, 6):
        mgr.maybe_save(s, _tree(s))
    assert mgr.steps() == [4, 5] and latest_step(str(tmp_path / "a")) == 5
    mgr = CheckpointManager(str(tmp_path / "b"), save_every=4, keep=10)
    assert [mgr.maybe_save(s, _tree()) for s in range(1, 10)] == [s % 4 == 0
                                                                  for s in range(1, 10)]
    assert mgr.steps() == [4, 8]
    assert not mgr.maybe_save(3, _tree()) and mgr.maybe_save(3, _tree(), force=True)


def test_restore_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=3)
    assert mgr.restore_latest(_tree()) is None
    trees = {s: _tree(s) for s in (1, 2, 3)}
    for s, t in trees.items():
        mgr.maybe_save(s, t)
    step, restored = mgr.restore_latest(_zeros_like(_tree()))
    assert step == 3
    _equal(restored, trees[3])
    assert all(e.startswith("step_") and ".tmp-" not in e for e in os.listdir(tmp_path))


@pytest.mark.parametrize("change,match", [
    (lambda t: {"w": t["w"], "extra": torch.zeros(())}, "treedef"),
    (lambda t: dict(t, w=torch.zeros(4, 8)), "shape"),
    (lambda t: dict(t, w=torch.zeros(8, 4, dtype=torch.bfloat16)), "dtype"),
    (lambda t: dict(t, b=torch.zeros(7, dtype=torch.bfloat16)), "shape"),
])
def test_restore_refuses_a_mismatch(tmp_path, change, match):
    t = _tree()
    save_pytree(t, str(tmp_path / "ck"))
    with pytest.raises(CheckpointMismatchError, match=match):
        restore_pytree(change(_zeros_like(t)), str(tmp_path / "ck"))


def test_load_pytree_templateless(tmp_path):
    t = _tree()
    save_pytree(t, str(tmp_path / "ck"))
    r = load_pytree(str(tmp_path / "ck"))
    assert set(r) == {"w", "b", "nested", "seq"}
    assert torch.equal(r["w"], t["w"]) and r["b"].dtype == torch.bfloat16
    assert torch.equal(r["b"], t["b"])
    assert int(r["nested"]["step"]) == 17
    assert torch.equal(r["nested"]["ring"][".buf"], t["nested"]["ring"].buf)
    assert torch.equal(r["seq"]["1"], t["seq"][1])


def test_crash_mid_write_never_corrupts(tmp_path, monkeypatch):
    """A crash at the final rename leaves no visible checkpoint and no tmp
    residue; the earlier checkpoint stays restorable."""
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=5)
    good = _tree(1)
    mgr.maybe_save(1, good)

    def exploding_rename(src, dst):
        raise OSError("simulated crash at publish time")

    monkeypatch.setattr(os, "rename", exploding_rename)
    with pytest.raises(OSError, match="simulated crash"):
        mgr.maybe_save(2, _tree(2))
    monkeypatch.undo()
    assert latest_step(str(tmp_path)) == 1
    _equal(mgr.restore_latest(_zeros_like(good))[1], good)
    assert all(".tmp-" not in e for e in os.listdir(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp-zz")  # a killed writer's residue
    os.makedirs(tmp_path / "step_00000007")  # no manifest
    assert latest_step(str(tmp_path)) == 1


def _delta_extra(step):
    return {"kind": STREAMING_DELTA_KIND, "prev_step": step - 1}


def test_manifest_extra_and_kind(tmp_path):
    d = str(tmp_path / "ck")
    save_pytree(_tree(), d, manifest_extra=_delta_extra(5))
    assert checkpoint_kind(d) == STREAMING_DELTA_KIND
    assert read_manifest_extra(d) == {"kind": STREAMING_DELTA_KIND, "prev_step": 4}
    d2 = str(tmp_path / "mono")
    save_pytree(_tree(), d2)
    assert checkpoint_kind(d2) is None and read_manifest_extra(d2) == {}
    _equal(restore_pytree(_zeros_like(_tree()), d), _tree())
    with pytest.raises(ValueError, match="leaves/treedef"):
        save_pytree(_tree(), str(tmp_path / "x"), manifest_extra={"leaves": 1})


def test_resume_chain(tmp_path):
    assert resume_chain(str(tmp_path / "none")) == (None, [])
    mono = CheckpointManager(str(tmp_path / "mono"), save_every=1, keep=None)
    mono.maybe_save(3, _tree())
    assert resume_chain(mono.root) == (3, [])
    full = CheckpointManager(str(tmp_path / "full"), save_every=1, keep=None)
    for s in range(1, 8):
        full.maybe_save(s, _tree(s), manifest_extra=_delta_extra(s))
    assert resume_chain(full.root) == (None, list(range(1, 8)))  # keep=None: no gc
    mixed = CheckpointManager(str(tmp_path / "mixed"), save_every=1, keep=None)
    mixed.maybe_save(1, _tree(1))
    mixed.maybe_save(2, _tree(2))
    for s in (3, 4):
        mixed.maybe_save(s, _tree(s), manifest_extra=_delta_extra(s))
    assert resume_chain(mixed.root) == (2, [3, 4])
    broken = CheckpointManager(str(tmp_path / "broken"), save_every=1, keep=None)
    for s in (2, 3):  # step 1 never written
        broken.maybe_save(s, _tree(s), manifest_extra=_delta_extra(s))
    with pytest.raises(CheckpointMismatchError, match="broken"):
        resume_chain(broken.root)


def test_crash_mid_delta_resumes_from_last_complete(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=None)
    trees = {s: _tree(s) for s in (1, 2, 3)}
    for s in (1, 2):
        mgr.maybe_save(s, trees[s], manifest_extra=_delta_extra(s))
    monkeypatch.setattr(os, "rename", lambda *a: (_ for _ in ()).throw(OSError("crash")))
    with pytest.raises(OSError, match="crash"):
        mgr.maybe_save(3, trees[3], manifest_extra=_delta_extra(3))
    monkeypatch.undo()
    assert resume_chain(str(tmp_path)) == (None, [1, 2])
    for s in (1, 2):
        assert torch.equal(load_pytree(mgr.dir_for(s))["w"], trees[s]["w"])


def test_reads_a_reference_written_directory(tmp_path):
    """``repro``'s ``save_pytree`` output, bf16 and nested dicts included, is
    read by the port's ``load_pytree`` leaf for leaf; the same tree written
    by both packages has the same manifest keys, dtypes, shapes and files."""
    rng = np.random.default_rng(0)
    payload = {
        "meta": {"next_seg": np.int32(3), "spec_fp_hi": np.uint32(7)},
        "link": {"olla": rng.normal(size=5).astype(np.float32),
                 "slots": np.arange(5, dtype=np.int32)},
        "rows": {"kpms": {"snr": rng.normal(size=(4, 6)).astype(np.float32)},
                 "modes": np.full((4, 6), -1, np.int32)},
        "ok": np.array([True, False]),
    }
    ref_tree = dict(payload, half={"x": jnp.arange(6, dtype=jnp.bfloat16)})
    rdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    rstore.save_pytree(ref_tree, rdir, manifest_extra=_delta_extra(3))
    got = load_pytree(rdir)
    assert read_manifest_extra(rdir) == _delta_extra(3)

    def walk(want, have):
        assert set(want) == set(have)
        for k, v in want.items():
            if isinstance(v, dict):
                walk(v, have[k])
            elif k == "x":
                assert have[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(have[k].float().numpy(),
                                              np.asarray(v, np.float32))
            else:
                np.testing.assert_array_equal(have[k].numpy(), np.asarray(v))
                assert have[k].numpy().dtype == np.asarray(v).dtype

    walk(ref_tree, got)
    save_pytree(dict(payload, half={"x": torch.arange(6, dtype=torch.bfloat16)}), tdir,
                manifest_extra=_delta_extra(3))
    with open(os.path.join(rdir, "manifest.json")) as f:
        rman = json.load(f)
    with open(os.path.join(tdir, "manifest.json")) as f:
        tman = json.load(f)
    assert rman["leaves"] == tman["leaves"]
    assert {k: v for k, v in rman.items() if k != "treedef"} == \
        {k: v for k, v in tman.items() if k != "treedef"}
