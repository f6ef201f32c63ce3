"""``launch/train.py --mesh`` on a group of the mesh's size: 4 spawned gloo
ranks, one CPU thread each, with ``make_production_mesh`` replaced by
``make_cpu_mesh(2, 2)``.  The launcher trains the reduced granite-20b with
the sharded step for 3 steps and writes a checkpoint (each leaf whole, by
rank 0); a second launch on the same directory restores it and runs to
step 5.  Held against an uninterrupted 5-step launch: the losses and every
leaf of the final checkpoint bitwise.
"""

import os
import tempfile

import numpy as np
import torch

from repro_torch.core import topology as ttopo

torch.set_num_threads(1)

ARGS = ["--device", "cpu", "--mesh", "single", "--batch", "4", "--seq", "16",
        "--save-every", "2"]


def _launches(rank, resumed, whole):
    """In one group: 3 steps, a second launch on the same directory to step
    5, and an uninterrupted 5-step launch on another."""
    from repro_torch.launch import train as tlaunch

    os.nice(5)  # yield the cores to the suite's workers
    tlaunch.make_production_mesh = lambda multi_pod=False: ttopo.make_cpu_mesh(2, 2)

    def launch(ckpt_dir, steps):
        return tlaunch.main([*ARGS, "--steps", str(steps), "--ckpt-dir", ckpt_dir]).losses

    first = launch(resumed, 3)
    after_first = sorted(os.listdir(resumed))
    return first, after_first, launch(resumed, 5), launch(whole, 5)


def _leaves(directory):
    """Every leaf of a checkpoint, by its path in the manifest."""
    import json

    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    return {k: np.load(os.path.join(directory, m["file"])) for k, m in manifest.items()}


def test_sharded_launch_restarts_bitwise():
    with tempfile.TemporaryDirectory() as resumed, tempfile.TemporaryDirectory() as whole:
        runs = ttopo.spawn_ranks(_launches, 4, (resumed, whole), device="cpu")
        assert all(r == runs[0] for r in runs)  # every rank sees the same replicated losses
        first, after_first, second, straight = runs[0]
        assert after_first == ["step_00000002", "step_00000003"]
        assert len(first) == 3 and len(second) == 2
        assert first + second == straight
        a = _leaves(os.path.join(resumed, "step_00000005"))
        b = _leaves(os.path.join(whole, "step_00000005"))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # each leaf is stored whole: the embedding (vocab 256, d_model 64)
        assert a[".params/embed"].shape == (256, 64)
