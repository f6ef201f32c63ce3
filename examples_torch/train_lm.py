"""Example on the PyTorch/CUDA port: fault-tolerant LM training (the port of
``examples/train_lm.py``).

The default is ``mamba2-130m``'s reduced config, as in the reference;
``--full`` takes the published config (about 129M parameters) with
``remat="block"``, as the reference does.  ``--arch`` takes any of the ten
configs; whisper-large-v3 fails as in the reference: the token stream
yields no encoder frames, and the encoder-decoder forward asserts them.
``--inject-failure k``
simulates a node failure before step ``k``: the loop restarts from the
newest checkpoint and continues bitwise.

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 60] [--device cuda|cpu]
"""

import argparse
import os
import tempfile

from repro_torch import random as jr
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.config import get_config
from repro_torch.models.model import Model
from repro_torch.train.loop import FailureInjector, run_training
from repro_torch.train.step import TrainConfig, init_train_state, train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke one")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="step at which to simulate a node failure")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    if args.full:
        cfg = cfg.with_(remat="block")
    model = Model(cfg)
    print(f"{cfg.name}: {model.n_params() / 1e6:.1f}M params on {dev}")

    tc = TrainConfig(learning_rate=1e-3)
    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=0)

    def init_state():
        return init_train_state(model, model.init(jr.PRNGKey(0, dev)), tc)

    ckpt = CheckpointManager(args.ckpt_dir, save_every=20, keep=2)
    injector = (FailureInjector(fail_at_steps=(args.inject_failure,))
                if args.inject_failure >= 0 else None)
    report = run_training(
        step_fn=lambda s, b: train_step(model, tc, s, b),
        init_state=init_state,
        data=lambda start: stream.iterate(start),
        ckpt=ckpt,
        total_steps=args.steps,
        failure_injector=injector,
        log_every=10,
    )
    if not report.losses:
        print(f"\ndone: step {report.final_step} was already checkpointed in {args.ckpt_dir}")
        return
    print(f"\ndone: {report.final_step} steps, "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}, "
          f"restarts {report.restarts}, stragglers {len(report.straggler_events)}")


if __name__ == "__main__":
    main()
