"""Serving launcher: batched decode with optional ARCHES expert switching
(port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch granite-20b --steps 32
    python -m repro_torch.launch.serve --arch granite-20b --full --switched
    python -m repro_torch.launch.serve --arch whisper-large-v3 --device cpu

It runs on the card unless ``--device cpu`` is given.  ``--arch`` takes all
ten configs; ``--full`` is the published config (bf16 weights), the default
the reduced smoke config.  The encoder-decoder family (whisper) gets zero
frames, (batch, 8, d_model) in the param dtype, as the reference's launcher
gives it.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.models.config import ARCH_IDS, Family, get_config
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.switched import SwitchedDecodeConfig, SwitchedDecoder


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-20b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--switched", action="store_true",
                    help="ARCHES expert bank over decode attention")
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    model = Model(cfg)
    params = model.init(jr.PRNGKey(0, dev))
    print(f"[serve] {cfg.name}: {model.n_params() / 1e6:.1f}M params on {dev}")

    prompts = jr.randint(jr.PRNGKey(1, dev), (args.batch, args.prompt_len), 0, cfg.vocab)
    frames = None
    if cfg.family is Family.ENC_DEC:
        frames = torch.zeros((args.batch, 8, cfg.d_model), dtype=cfg.param_dtype(), device=dev)
    if not args.switched:
        eng = ServingEngine(model, params, max_seq=args.max_seq)
        _sync(dev)
        t0 = time.perf_counter()
        res = eng.generate(prompts, args.steps, encoder_frames=frames)
        dt = time.perf_counter() - t0
        print(f"[serve] {args.batch}x{args.steps} tokens in {dt:.1f}s "
              f"({args.batch * args.steps / dt:.1f} tok/s)")
        print("[serve] first sequence:", res.tokens[0][:16], "...")
        return

    dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=args.window))
    cache = model.init_cache(args.batch, args.max_seq, device=dev)
    _, cache = model.prefill(params, prompts, cache, encoder_frames=frames)
    tok = prompts[:, -1:]
    _sync(dev)
    t0 = time.perf_counter()
    for step in range(args.steps):
        mode = 0 if step % 8 < 4 else 1  # scripted switching demo
        logits, cache, kpms = dec.step(mode, params, tok, cache)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        if step % 8 == 0:
            print(f"[serve] step {step}: expert={'exact' if mode == 0 else 'win'} "
                  f"kl={kpms['expert_kl']:.4f} occ={kpms['cache_occupancy']:.2f}")
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] switched decode: {args.batch * args.steps / dt:.1f} tok/s")


if __name__ == "__main__":
    main()
