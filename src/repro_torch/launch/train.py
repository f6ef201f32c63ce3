"""Training launcher: config-driven and fault-tolerant (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch granite-20b --steps 100
    python -m repro_torch.launch.train --full --layers 4 --seq 4096 --batch 8 --microbatches 4
    python -m repro_torch.launch.train --device cpu --steps 3

It trains on the card unless ``--device cpu`` is given, with the reference's
flags: ``--full`` is the published config (bf16 weights) and the default the
reduced smoke config; ``--layers`` cuts the depth and changes nothing else.
The weights come from ``repro_torch.random.PRNGKey(0)``, so they are the
reference's.  The token stream's host slice follows the default
``torch.distributed`` group when one is initialised.  ``--mesh none`` is
the only mesh: the sharded meshes (``single``, ``multi``) wait for the
sharded training half in ``ROADMAP.md`` Queue 1.
"""

from __future__ import annotations

import argparse
import functools
import os
import tempfile

from repro_torch import random as jr
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.config import ARCH_IDS, SHARDED_TRAINING_QUEUE_ITEM, get_config
from repro_torch.models.model import Model
from repro_torch.train.loop import LoopReport, run_training
from repro_torch.train.step import TrainConfig, init_train_state, train_step


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

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh} is not ported yet: the sharded meshes wait in ROADMAP.md "
            f"Queue 1, item {SHARDED_TRAINING_QUEUE_ITEM} (the sharded training half)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    if args.layers is not None:
        cfg = cfg.with_(n_layers=args.layers)
    model = Model(cfg)
    tc = TrainConfig(learning_rate=args.lr, microbatches=args.microbatches,
                     quantize_moments=args.quantize_moments,
                     compress_grads=args.compress_grads)
    print(f"[train] {cfg.name}: {model.n_params() / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers, {cfg.dtype}, remat {cfg.remat}, on {dev}")

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
