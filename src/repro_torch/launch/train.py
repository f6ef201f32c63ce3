"""Training launcher: config-driven and fault-tolerant (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch granite-20b --steps 100
    python -m repro_torch.launch.train --full --layers 4 --seq 4096 --batch 8 --microbatches 4
    python -m repro_torch.launch.train --device cpu --steps 3

It trains on the card unless ``--device cpu`` is given, with the reference's
flags: ``--full`` is the published config (bf16 weights) and the default the
reduced smoke config; ``--layers`` cuts the depth and changes nothing else.
The weights come from ``repro_torch.random.PRNGKey(0)``, so they are the
reference's.  The token stream's host slice follows the default
``torch.distributed`` group when one is initialised.

``--mesh single|multi`` plans the step on the production mesh (16 x 16, or
2 x 16 x 16): it prints the train state's and the batch's placements, by
the logical-axis rules of ``distributed/sharding.py``, and the bytes a
device holds, then builds the ``DeviceMesh``, which raises ``ValueError``
unless the process group has 256 (512) ranks, as the reference's launcher
raises on any host short of a pod.  The port writes no train step sharded
over that many ranks: no machine it runs on has them (``ROADMAP.md``
Queue 3, "Deviations held by test").
"""

from __future__ import annotations

import argparse
import functools
import os
import tempfile

import torch

from repro_torch import random as jr
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.core.topology import make_production_mesh
from repro_torch.distributed.sharding import make_rules, placements
from repro_torch.launch import specs as S
from repro_torch.models.config import ARCH_IDS, get_config
from repro_torch.models.model import Model
from repro_torch.train.loop import LoopReport, run_training
from repro_torch.train.step import TrainConfig, init_train_state, train_step


def plan_mesh(model: Model, tc: TrainConfig, mesh_kind: str, batch: int, seq: int):
    """Print the train state's and the batch's placements on the production
    mesh and the bytes a device holds of each; returns the mesh."""
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    rules = make_rules()
    state = S.train_state_abstract(model, tc)
    state_ps = S.train_state_pspecs(model, state, mesh, rules)
    tokens = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    batch_abs = {"tokens": tokens, "labels": tokens}
    batch_ps = S.batch_pspecs(batch_abs, mesh, rules)
    print(f"[train] plan on the {mesh_kind} mesh {mesh.shape} ({mesh.size} devices):")
    for path, (t, ps) in _named(state.params, state_ps.params):
        print(f"[train]   params.{path} {tuple(t.shape)}: {ps} -> {placements(ps, mesh)}")
    for k, ps in batch_ps.items():
        print(f"[train]   batch.{k} {(batch, seq)}: {ps} -> {placements(ps, mesh)}")
    total = sum(t.numel() * t.element_size() for t, _ in S.placed(state, state_ps))
    print(f"[train] train state {S.per_device_bytes(state, state_ps, mesh):,} B a device of "
          f"{total:,} B; batch {S.per_device_bytes(batch_abs, batch_ps, mesh):,} B a device")
    return mesh


def _named(tensors, specs, prefix: str = ""):
    for k, v in tensors.items():
        if isinstance(v, dict):
            yield from _named(v, specs[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", (v, specs[k])


def main(argv=None) -> LoopReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-20b")
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers, nothing else")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", choices=("none", "single", "multi"), default="none",
                    help="'none' = the one device as it is")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--quantize-moments", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full)
    if args.layers is not None:
        cfg = cfg.with_(n_layers=args.layers)
    model = Model(cfg)
    tc = TrainConfig(learning_rate=args.lr, microbatches=args.microbatches,
                     quantize_moments=args.quantize_moments,
                     compress_grads=args.compress_grads)
    print(f"[train] {cfg.name}: {model.n_params() / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers, {cfg.dtype}, remat {cfg.remat}")
    if args.mesh != "none":
        mesh = plan_mesh(model, tc, args.mesh, args.batch, args.seq)
        mesh.device_mesh()  # raises unless the process group has mesh.size ranks
        raise NotImplementedError(f"the port has no train step sharded over {mesh.size} ranks "
                                  f"(ROADMAP.md Queue 3)")
    dev = resolve_device(args.device)
    print(f"[train] on {dev}")

    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    ckpt = CheckpointManager(args.ckpt_dir, save_every=args.save_every, keep=3)

    def init_state():
        return init_train_state(model, model.init(jr.PRNGKey(0, dev)), tc)

    report = run_training(
        step_fn=functools.partial(train_step, model, tc), init_state=init_state,
        data=lambda start: stream.iterate(start), ckpt=ckpt, total_steps=args.steps)
    if report.losses:
        print(f"[train] final step {report.final_step}, loss {report.losses[0]:.3f} -> "
              f"{report.losses[-1]:.3f}, restarts {report.restarts}")
    else:
        print(f"[train] final step {report.final_step}: restored at the end, no step run")
    return report


if __name__ == "__main__":
    main()
