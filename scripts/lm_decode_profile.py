"""Where a decode step of the LM stack spends its time, on one card.

    python3 scripts/lm_decode_profile.py [--arch mamba2-130m] [--layers N]

Draws the arch's published config (bf16 weights from seed 0, its depth cut
to ``--layers`` where given), prefills ``chip_smoke.py``'s serving batch (8
prompts of 128 tokens, a float32 cache of 1,024 positions; whisper with its
1,500 stub frames) and then, under
``torch.use_deterministic_algorithms(True)`` as the script runs:

- ms a decode step on the host clock (synchronised), the mean of 5 after 3
  warm-up steps;
- the host-device synchronisations in one step (PyTorch's sync debug mode);
- one step under ``torch.profiler``: its wall time, device time and kernel
  launches, the kernels by device time and the host operations by their
  own CPU time.

Each ``--arch`` given runs in turn; the card's name and power limit close
the output as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def profile_decode(arch: str, layers: int | None) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random as jr
    from repro_torch.models import Model, get_config

    dev = torch.device("cuda")
    cfg = get_config(arch)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    model = Model(cfg)
    params = model.init(jr.PRNGKey(0, dev))
    prompts = jr.randint(jr.PRNGKey(1, dev), (cs.SERVE_BATCH, cs.SERVE_PROMPT), 0, cfg.vocab)
    frames = cs.stub_frames(cfg, cs.SERVE_BATCH, cs.WHISPER_FRAMES, dev)
    _, cache = model.prefill(params, prompts, model.init_cache(
        cs.SERVE_BATCH, cs.SERVE_MAX_SEQ, dtype=torch.float32, device=dev),
        encoder_frames=frames)
    tok = prompts[:, -1:]
    for _ in range(3):
        model.decode_step(params, tok, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        model.decode_step(params, tok, cache)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model.decode_step(params, tok, cache)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "prototype feature" not in str(w.message)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_step(params, tok, cache)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = sorted((e for e in events if e.device_type.name == "CUDA"),
                    key=lambda e: e.self_device_time_total, reverse=True)
    host = sorted((e for e in events if e.device_type.name == "CPU"),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in device) / 1e3
    cs.log(f"{cfg.name} ({cfg.n_layers} layers, bf16, batch {cs.SERVE_BATCH}, context "
           f"{cs.SERVE_PROMPT}): a decode step {ms:.3f} ms (host clock); {len(syncs)} host-device "
           f"syncs in a step; profiled: {wall:.3f} ms wall, {busy:.3f} ms of device time "
           f"({busy / wall:.4f} busy) in {sum(e.count for e in device)} kernel launches")
    for e in device[:10]:
        cs.log(f"  device {e.self_device_time_total:10.1f} us {e.count:6d}  {e.key[:110]}")
    for e in host[:12]:
        cs.log(f"  host   {e.self_cpu_time_total:10.1f} us {e.count:6d}  {e.key[:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append",
                    help="an arch id of repro_torch.models.config.ARCH_IDS (repeatable)")
    ap.add_argument("--layers", type=int, action="append",
                    help="depth cut, one per --arch in order (0: the published depth)")
    args = ap.parse_args(argv)
    archs = args.arch or ["mamba2-130m"]
    layers = args.layers or [0] * len(archs)
    if len(layers) != len(archs):
        raise SystemExit("give one --layers per --arch")
    smi = cs.phase_device()
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, n in zip(archs, layers):
        profile_decode(arch, n or None)
        torch.cuda.empty_cache()
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
