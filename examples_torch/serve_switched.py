"""Example on the PyTorch/CUDA port: ARCHES-switched serving through the
resident campaign service (the port of ``examples/serve_switched.py``).

Two halves of the paper-7 generalisation ("only the experts and telemetry
inputs change"):

1. **The serving expert bank**: two decode-attention experts (exact
   full-cache against windowed) behind the same switch kernels that route
   the channel-estimation experts (the scalar switch for one mode, the
   per-UE switch for a mode vector), emitting per-step KPMs (expert KL,
   agreement, cache occupancy) a policy would switch on.
2. **The serving control plane**: campaigns go to the resident
   ``repro_torch.service`` and are driven over its HTTP API: the demo
   starts the service in-process, submits a switched campaign as
   ``CampaignSpec`` JSON, polls its segments and provenance, reads the
   per-segment telemetry and drains.

    PYTHONPATH=src python examples_torch/serve_switched.py [--device cuda|cpu]
"""

import json
import tempfile
import time
import urllib.request

import argparse

import torch

from repro_torch import random as jr
from repro_torch.core.session import CampaignSpec, PolicySpec, SwitchSpec, spec_hash
from repro_torch.device import resolve_device
from repro_torch.models.config import get_config
from repro_torch.models.model import Model
from repro_torch.serving.switched import SwitchedDecoder, SwitchedDecodeConfig
from repro_torch.service import CampaignService, JsonlExporter
from repro_torch.service.api import ServiceAPI


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read().decode())


def _post(url: str, payload: str = "null"):
    req = urllib.request.Request(
        url, data=payload.encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read().decode())


def expert_bank_demo(device: str) -> None:
    """The serving expert pair and its per-step switch telemetry."""
    cfg = get_config("granite-20b", reduced=True)
    model = Model(cfg)
    dev = resolve_device(device)
    params = model.init(jr.PRNGKey(0, dev))
    dec = SwitchedDecoder(model, SwitchedDecodeConfig(window=8))

    batch = 2
    cache = model.init_cache(batch, 128, device=dev)
    prompt = jr.randint(jr.PRNGKey(1, dev), (batch, 16), 0, cfg.vocab)
    _, cache = model.prefill(params, prompt, cache)
    print(f"== serving expert bank: {cfg.name}, batch={batch}, "
          f"experts = exact vs window-8 attention ==")

    tokens = torch.ones((batch, 1), dtype=torch.int32, device=dev)
    names = {0: "exact ", 1: "window"}
    # per-sequence mode vector, the serving analogue of the per-UE mode
    # vector; decisions would come from the policy bank the service runs
    for step, mode in enumerate(([0, 1], [1, 1], [0, 0], [1, 0])):
        logits, cache, kpms = dec.step(torch.tensor(mode, dtype=torch.int32, device=dev),
                                       params, tokens, cache)
        tokens = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        row = "/".join(names[m] for m in mode)
        print(f"step {step} experts={row} kl={kpms['expert_kl']:.4f} "
              f"agree={kpms['expert_agree']*100:3.0f}% "
              f"cache={kpms['cache_occupancy']*100:3.0f}%")
    print("(the same switch kernels as the PHY case; the KPMs feed the policy "
          "bank)\n")


def service_demo(device: str) -> None:
    """Submit -> poll -> telemetry -> drain over the northbound API."""
    n_phase = 8
    spec = CampaignSpec(
        path="closed_loop",
        scenario="good_poor_good",
        scenario_args=(("poor_start", n_phase), ("poor_end", 2 * n_phase)),
        n_ues=4,
        n_slots=3 * n_phase,
        seed=42,
        policies=(PolicySpec(kind="threshold", feature="snr",
                             threshold=18.0, hysteresis=2.0),),
        switch=SwitchSpec(window_slots=2),
    )

    with tempfile.TemporaryDirectory() as state:
        jsonl = f"{state}/telemetry.jsonl"
        svc = CampaignService(
            state, max_segment_slots=n_phase,
            exporters=[JsonlExporter(jsonl)], device=device,
        ).start()
        api = ServiceAPI(svc).start()
        print(f"== resident campaign service on {api.url} "
              f"(state dir: checkpoints + status, telemetry -> JSONL) ==")

        cid = _post(api.url + "/campaigns", spec.to_json())["campaign_id"]
        print(f"POST /campaigns -> campaign_id {cid} "
              f"[spec {spec_hash(spec)}]")

        last = None
        while True:
            st = _get(api.url + f"/campaigns/{cid}")
            key = (st["state"], st["segments_done"])
            if key != last:
                print(f"GET  /campaigns/{cid[:5]}..: {st['state']:9s} "
                      f"segment {st['segments_done']}/{st['n_segments']} "
                      f"checkpoints {st['checkpoint_steps']}")
                last = key
            if st["state"] in ("completed", "failed", "cancelled"):
                break
            time.sleep(0.05)
        if st["state"] != "completed":
            raise SystemExit(f"campaign ended {st['state']}: {st['error']}")
        assert st["spec_hash"] == spec_hash(spec)  # provenance carried

        print("\nGET  /telemetry — per-segment samples off the ring:")
        for s in _get(api.url + "/telemetry?n=8"):
            print(f"  seg {s['seg_idx']} slots [{s['t0']},{s['t1']}): "
                  f"AI share {s['ai_share']:4.0%}  "
                  f"throughput {s['throughput_bps'] / 1e6:5.1f} Mbps  "
                  f"flops {s['executed_flops'] / 1e9:.2f} G")

        health = _get(api.url + "/health")
        print(f"\nGET  /health: {health['status']}, "
              f"workers={health['workers']}, "
              f"campaigns={health['campaign_states']}, "
              f"telemetry exported={health['telemetry']['exported']} "
              f"dropped={health['telemetry']['dropped']}")

        _post(api.url + "/drain")
        api.stop()
        if not svc.drain(timeout=60):
            raise SystemExit("drain timed out")
        with open(jsonl) as f:
            rows = sum(1 for _ in f)
        print(f"POST /drain -> graceful exit; {rows} telemetry rows "
              "exported losslessly")
    print("(kill the service instead of draining and a restart resumes "
          "the campaign bitwise; see tests/test_torch_service.py)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args()
    expert_bank_demo(args.device)
    service_demo(args.device)


if __name__ == "__main__":
    main()
