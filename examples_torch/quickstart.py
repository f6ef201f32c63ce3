"""Quickstart on the PyTorch/CUDA port: ARCHES expert switching through the
declarative session API (the port of ``examples/quickstart.py``).

Every campaign is one ``CampaignSpec`` (scenario by registry name, campaign
shape, expert bank, switch and policy config, seeds), run by
``ArchesSession`` on the card, or on the CPU with ``--device cpu``:

    spec = CampaignSpec(path="closed_loop", scenario="good_poor_good", ...)
    hist = ArchesSession(spec, device="cuda").run()   # -> BatchedRunHistory

The demo walks the execution paths the session dispatches over:

* default: the paper's Fig. 9 scenario under the device-side closed loop
  (the policy decides inside the slot loop), checked bitwise against the
  host replay of the same policy.
* ``--host``: the single-UE Python slot loop with the full E3 + dApp
  control plane.
* ``--gated``: compaction-gated execution: the AI expert runs only on a
  capacity-limited sub-batch of the UEs that selected it; prints the
  compute saved and the capacity a recorded campaign suggests
  (``suggest_gated_capacity``); the fused GATED path must equal the
  CONCURRENT campaign bitwise (the unfused path, bitwise on the CPU, is
  held to its MCS agreement on the card); then bf16 operands under the
  NMSE audit.
* ``--heterogeneous``: the ``mixed_cell`` scenario gives each UE its own
  channel schedule, and two policies are assigned across the UEs.
* ``--multi-cell``: a 4-cell campaign (``multi_cell`` + ``TopologySpec``)
  with per-cell noise offsets and inter-cell coupling; it runs as one
  shard here, and over the ranks of a ``torch.distributed`` group when the
  caller starts one; reports each cell's AI share and throughput.
* ``--streaming``: a ``ChurnSchedule`` attaches and detaches UEs at segment
  boundaries over a stable-id universe wider than the bank (``.`` =
  detached), with the host replay through the churn boundaries; the
  campaign is checkpointed as a delta chain, killed half-way and resumed
  bitwise.
* ``--service``: the resident campaign service (``repro_torch.service``)
  with its HTTP API: submit the campaign as JSON, poll it, read the
  per-segment telemetry, drain; the service-run history must equal the
  monolithic ``run()`` bitwise.  Standalone:
  ``python -m repro_torch.service --state-dir <dir>``.
* ``--faults``: the fault-injection ladder: a dApp outage past the TTL
  decays to the MMSE fail-safe, a NaN burst in the AI expert trips the
  health screen and the circuit breaker; the device trajectory replays
  bitwise through the host oracle.

Every section prints its campaign's ``spec_hash`` after a JSON round trip.

    PYTHONPATH=src python examples_torch/quickstart.py [--n-ues 4] [--host] [--gated]
        [--heterogeneous] [--multi-cell] [--streaming] [--faults] [--service]
        [--device cuda|cpu]
"""

import argparse
import os

import numpy as np

from repro_torch.core.runtime import suggest_gated_capacity
from repro_torch.core.session import (
    ArchesSession,
    CampaignSpec,
    ExpertBankSpec,
    PolicySpec,
    SwitchSpec,
    spec_hash,
)
from repro_torch.phy.scenario import make_schedule, scenario_names

N_PHASE = 10


def roundtrip(spec: CampaignSpec) -> CampaignSpec:
    """Serialize -> parse, proving the spec is its own provenance record."""
    restored = CampaignSpec.from_json(spec.to_json())
    assert restored == spec
    return restored


def closed_loop_demo(n_ues: int, device: str) -> None:
    spec = roundtrip(CampaignSpec(
        path="closed_loop",
        scenario="good_poor_good",
        scenario_args=(("poor_start", N_PHASE), ("poor_end", 2 * N_PHASE)),
        n_ues=n_ues,
        n_slots=3 * N_PHASE,
        seed=42,
        policies=(PolicySpec(kind="tree", depth=2),),
        switch=SwitchSpec(window_slots=2),
    ))
    session = ArchesSession(spec, device=device)
    hist = session.run()

    schedule = make_schedule(spec.scenario, **spec.scenario_kwargs)
    print(f"== closed loop: decisions inside the slot loop "
          f"({spec.n_ues} UEs x {spec.n_slots} slots) "
          f"[spec {spec_hash(spec)}] ==")
    for s in range(0, spec.n_slots, 3):
        cond = "poor" if schedule(s).interference else "good"
        row = "".join("A" if m == 0 else "M" for m in hist.modes[s])
        print(f"slot {s:3d} [{cond}] per-UE experts: {row}")

    replay = session.host_replay(hist)
    match = np.array_equal(hist.modes, replay["active_mode"])
    print(f"device == host replay: {'yes (bitwise)' if match else 'NO'}; "
          f"switches/UE: {hist.n_switches.tolist()}")
    if not match:
        raise SystemExit("closed-loop equivalence violated")


def host_demo(device: str) -> None:
    spec = roundtrip(CampaignSpec(
        path="host",
        scenario="good_poor_good",
        scenario_args=(("poor_start", N_PHASE), ("poor_end", 2 * N_PHASE)),
        n_ues=1,
        n_slots=3 * N_PHASE,
        policies=(PolicySpec(kind="tree", depth=2, train_ues=2),),
        switch=SwitchSpec(window_slots=2, ttl_slots=8),
    ))
    hist = ArchesSession(spec, device=device).run()

    schedule = make_schedule(spec.scenario, **spec.scenario_kwargs)
    names = {0: "AI  ", 1: "MMSE"}
    print(f"\n== host loop: E3 + dApp control plane [spec {spec_hash(spec)}] ==")
    for s in range(spec.n_slots):
        cond = "poor" if schedule(s).interference else "good"
        tput = hist.kpms["phy_throughput"][s, 0]
        bar = "#" * int(tput / 2e6)
        print(f"slot {s:3d} [{cond}] expert={names[int(hist.modes[s, 0])]} "
              f"tput={tput / 1e6:5.1f} Mbps {bar}")
    print("(decisions apply at slot n+1 — paper 3.3)")


def _same_trajectory(a, b) -> bool:
    return np.array_equal(a.modes, b.modes) and all(
        np.array_equal(a.kpms[k], b.kpms[k]) for k in a.kpms)


def gated_demo(n_ues: int, device: str) -> None:
    n_ai = max(1, n_ues // 4)
    modes = np.ones((3 * N_PHASE, n_ues), np.int32)
    modes[:, :n_ai] = 0  # 1-in-4 UEs on AI
    base = dict(
        scenario="good_poor_good",
        scenario_args=(("poor_start", N_PHASE), ("poor_end", 2 * N_PHASE)),
        n_ues=n_ues,
        n_slots=3 * N_PHASE,
        modes=tuple(map(tuple, modes)),
    )
    gated = roundtrip(CampaignSpec(
        path="gated",
        bank=ExpertBankSpec(execution_mode="gated", gated_capacity=n_ai),
        **base,
    ))
    conc = CampaignSpec(path="batched", **base)

    hist_g = ArchesSession(gated, device=device).run()
    hist_c = ArchesSession(conc, device=device).run()

    fl_c = hist_c.executed_flops_per_slot().mean()
    fl_g = hist_g.executed_flops_per_slot().mean()
    print(f"\n== gated execution: {n_ai}/{n_ues} UEs on AI "
          f"[spec {spec_hash(gated)}] ==")
    print(f"executed compute:  concurrent {fl_c / 1e9:.3f} GFLOP/slot -> "
          f"gated {fl_g / 1e9:.3f} GFLOP/slot "
          f"({(1 - fl_g / fl_c) * 100:.0f}% saved)")
    print(f"overflow slot-UEs: {hist_g.overflow_slot_ues}; "
          f"suggest_gated_capacity(history) -> "
          f"{suggest_gated_capacity(hist_g)} (provisioned: {n_ai})")

    # the fused hot path: one kernel replaces the gather -> expert -> scatter
    # triple, and each UE's estimate is the same bits at any batch, so the
    # fused GATED campaign equals the CONCURRENT one bitwise on either device
    fused = roundtrip(CampaignSpec(
        path="gated",
        bank=ExpertBankSpec(execution_mode="gated", gated_capacity=n_ai,
                            fused=True),
        **base,
    ))
    hist_f = ArchesSession(fused, device=device).run()
    fused_same = _same_trajectory(hist_c, hist_f)
    print(f"fused GATED == CONCURRENT [spec {spec_hash(fused)}]: "
          f"{'yes (bitwise)' if fused_same else 'NO'}")
    if not fused_same:
        raise SystemExit("fused gated != concurrent trajectory")
    # the unfused path's compact expert is its own GEMM over the selected
    # UEs: bitwise on the CPU; on the card a UE's bits depend on the batch,
    # so it is held to its discrete leaves' agreement
    if _same_trajectory(hist_c, hist_g):
        print("unfused GATED == CONCURRENT: yes (bitwise)")
    else:
        agree = float(np.mean(hist_g.kpms["mcs_index"] == hist_c.kpms["mcs_index"]))
        print(f"unfused GATED vs CONCURRENT: modes equal, MCS agreement {agree:.3f}")
        if not np.array_equal(hist_g.modes, hist_c.modes) or agree < 0.95:
            raise SystemExit("unfused gated and concurrent trajectories disagree")

    # bf16 expert variant: half the GEMM operand bytes, f32 accumulation.
    # Not bitwise — the in-loop NMSE audit guards it: any served UE whose
    # output diverges > threshold from the dense MMSE fail-safe reverts to
    # it (and is flagged in the audit_tripped leaf).  The score is
    # expert-vs-fail-safe, so tight thresholds trip wherever the expert
    # genuinely disagrees with MMSE — tripped UEs are served the fail-safe.
    bf16 = roundtrip(CampaignSpec(
        path="gated",
        bank=ExpertBankSpec(execution_mode="gated", gated_capacity=n_ai,
                            fused=True, dtype="bfloat16",
                            audit_nmse_threshold=1.0),
        **base,
    ))
    hist_b = ArchesSession(bf16, device=device).run()
    total = hist_b.modes.size
    print(f"bf16 expert [spec {spec_hash(bf16)}]: audit tripped "
          f"{hist_b.audit_tripped_slot_ues}/{total} slot-UEs at NMSE 1.0 "
          f"(tripped UEs reverted to the MMSE fail-safe that slot)")


def heterogeneous_demo(n_ues: int, device: str) -> None:
    spec = roundtrip(CampaignSpec(
        path="closed_loop",
        scenario="mixed_cell",
        n_ues=n_ues,
        n_slots=3 * N_PHASE,
        seed=1,
        policies=(
            # train_scenario=None: per-UE campaign -> the tree trains on
            # good_poor_good with its window scaled into the horizon
            PolicySpec(kind="tree", depth=2),
            PolicySpec(kind="threshold", feature="snr", threshold=18.0,
                       hysteresis=2.0),
        ),
        policy_assignment=tuple(u % 2 for u in range(n_ues)),
        switch=SwitchSpec(window_slots=2),
    ))
    session = ArchesSession(spec, device=device)
    hist = session.run()

    print(f"\n== per-UE heterogeneity: mixed_cell scenario, 2 policies "
          f"[spec {spec_hash(spec)}] ==")
    kinds = [spec.policies[i].kind for i in spec.policy_assignment]
    print("UE ->", "  ".join(f"{u}:{k}" for u, k in enumerate(kinds)))
    for s in range(0, spec.n_slots, 3):
        row = "".join("A" if m == 0 else "M" for m in hist.modes[s])
        print(f"slot {s:3d} per-UE experts: {row}")

    replay = session.host_replay(hist)
    match = np.array_equal(hist.modes, replay["active_mode"])
    print(f"device == per-UE host replay: "
          f"{'yes (bitwise)' if match else 'NO'}; "
          f"switches/UE: {hist.n_switches.tolist()}")
    if not match:
        raise SystemExit("per-UE closed-loop equivalence violated")


def multi_cell_demo(n_ues: int, device: str) -> None:
    from repro_torch.core.topology import TopologySpec

    n_cells = 4
    n_ues = max(n_ues, n_cells) // n_cells * n_cells  # cells split evenly
    spec = roundtrip(CampaignSpec(
        path="closed_loop",
        scenario="multi_cell",
        scenario_args=(
            ("n_cells", n_cells),
            ("per_cell_scenario",
             ("good", "poor", "bursty_interference", "good")),
        ),
        n_ues=n_ues,
        n_slots=3 * N_PHASE,
        seed=3,
        policies=(PolicySpec(kind="threshold", feature="snr",
                             threshold=18.0, hysteresis=2.0),),
        switch=SwitchSpec(window_slots=2),
        topology=TopologySpec(
            n_cells=n_cells,
            coupling=0.4,
            cell_noise_offsets_db=(0.0, 0.0, 2.0, 0.0),
        ),
    ))
    session = ArchesSession(spec, device=device)
    hist = session.run()

    topo = session.cell_topology
    print(f"\n== sharded multi-cell: {n_cells} cells x "
          f"{n_ues // n_cells} UEs on {topo.n_shards} shard(s) "
          f"[spec {spec_hash(spec)}] ==")
    cell_scen = dict(spec.scenario_args)["per_cell_scenario"]
    share = hist.per_cell_ai_share
    tput = hist.per_cell_throughput
    for c in range(n_cells):
        bar = "#" * int(share[c] * 20)
        print(f"cell {c} [{cell_scen[c]:>20s}] AI share {share[c]:4.0%} "
              f"{bar:20s} throughput {tput[c] / 1e6:5.1f} Mbps")

    replay = session.host_replay(hist)
    match = np.array_equal(hist.modes, replay["active_mode"])
    print(f"device == host replay across shards: "
          f"{'yes (bitwise)' if match else 'NO'}")
    if not match:
        raise SystemExit("sharded closed-loop equivalence violated")


def streaming_demo(n_ues: int, device: str) -> None:
    from repro_torch.core.closed_loop import host_replay_closed_loop
    from repro_torch.core.streaming import ChurnSchedule

    seg = N_PHASE // 2
    n_slots = 6 * seg
    n_ids = 2 * n_ues  # stable-id universe, twice the bank capacity
    churn = ChurnSchedule(
        n_ue_ids=n_ids,
        segment_slots=seg,
        initial=tuple(range(n_ues)),
        events=(
            (seg, 1, "detach"), (seg, n_ues, "attach"),
            (2 * seg, 0, "detach"), (2 * seg, n_ues + 1, "attach"),
            (3 * seg, n_ues, "detach"), (3 * seg, 1, "attach"),
            (4 * seg, n_ues + 1, "detach"), (4 * seg, 0, "attach"),
        ),
    )
    spec = roundtrip(CampaignSpec(
        path="closed_loop",
        scenario="churn_cell",
        n_ues=n_ues,
        n_slots=n_slots,
        seed=7,
        policies=(PolicySpec(kind="threshold", feature="snr",
                             threshold=18.0, hysteresis=2.0),),
        switch=SwitchSpec(window_slots=2),
        churn=churn,
    ))
    session = ArchesSession(spec, device=device)
    hist = session.run()

    print(f"\n== streaming churn: {n_ids}-id universe on a {n_ues}-slot "
          f"bank, {n_slots // seg} segments of {seg} slots "
          f"[spec {spec_hash(spec)}] ==")
    boundaries = {
        t0: [(u, kind) for (t, u, kind) in churn.events
             if (t + seg - 1) // seg * seg == t0]
        for t0 in range(0, n_slots, seg)
    }
    for s in range(n_slots):
        if s % seg == 0 and boundaries.get(s):
            evs = ", ".join(f"{kind} UE{u}" for u, kind in boundaries[s])
            print(f"--- segment boundary (slot {s}): {evs} ---")
        row = "".join(
            "." if m == -1 else ("A" if m == 0 else "M")
            for m in hist.modes[s]
        )
        print(f"slot {s:3d} per-id experts: {row}  "
              f"(resident {int(hist.attached[s].sum())}/{n_ids})")

    feats = np.stack(
        [hist.kpms[n] for n in spec.feature_names], axis=-1
    ).astype(np.float32)
    replay = host_replay_closed_loop(
        session.host_policies[0], feats,
        spec.switch.to_config(spec.feature_names),
        attached=hist.attached,
    )
    match = np.array_equal(hist.modes, replay["active_mode"])
    print(f"device == host replay through churn boundaries: "
          f"{'yes (bitwise)' if match else 'NO'}; "
          f"switches/id: {hist.n_switches.tolist()}")
    if not match:
        raise SystemExit("streaming closed-loop equivalence violated")

    # checkpoint layout: one delta per segment boundary, O(segment) bytes,
    # chained back to its predecessor; kill after half the campaign and
    # resume the chain bitwise
    import tempfile

    from repro_torch.checkpoint.store import checkpoint_kind, list_steps

    with tempfile.TemporaryDirectory() as ckpt:
        kill_after = (n_slots // seg) // 2
        session.run_streaming(checkpoint_dir=ckpt, max_segments=kill_after)
        print(f"\ncheckpoint chain after {kill_after} segments "
              f"(killed mid-campaign):")
        for step in list_steps(ckpt):
            d = os.path.join(ckpt, f"step_{step:08d}")
            size = sum(
                os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
            )
            print(f"  step_{step:08d}/  {size:6d} B  "
                  f"kind={checkpoint_kind(d) or 'monolithic'}")
        resumed = session.run_streaming(resume_from=ckpt)
        ok = np.array_equal(resumed.modes, hist.modes)
        print(f"killed-and-resumed == uninterrupted: "
              f"{'yes (bitwise)' if ok else 'NO'}")
        if not ok:
            raise SystemExit("streaming checkpoint resume violated")


def faults_demo(n_ues: int, device: str) -> None:
    from repro_torch.core.faults import FaultSpec

    n_slots = 3 * N_PHASE
    ttl = 3
    outage = (N_PHASE, 2 * N_PHASE)  # dApp down for the middle phase
    burst = (4, 8)  # NaN corruption early, while the dApp is still up
    faults = FaultSpec(
        seed=11,
        decision_outages=(outage,),
        corruption_spans=(burst,),
        corruption_kind="nan",
        breaker_trips=2,
        breaker_window=4,
        breaker_cooldown=4,
    )
    spec = roundtrip(CampaignSpec(
        path="closed_loop",
        scenario="good",
        n_ues=n_ues,
        n_slots=n_slots,
        seed=9,
        # threshold above any SNR: the policy always decides AI, so every
        # MMSE slot below is the ladder acting, not the policy
        policies=(PolicySpec(kind="threshold", feature="snr",
                             threshold=1e9),),
        switch=SwitchSpec(window_slots=2, ttl_slots=ttl),
        faults=faults,
    ))
    session = ArchesSession(spec, device=device)
    hist = session.run()

    print(f"\n== fault injection: dApp outage slots "
          f"{outage[0]}-{outage[1] - 1} (ttl={ttl}), NaN burst slots "
          f"{burst[0]}-{burst[1] - 1} [spec {spec_hash(spec)}] ==")
    tripped = np.asarray(hist.outputs["health_tripped"]) > 0
    quar = np.asarray(hist.outputs["quarantined"]) > 0
    for s in range(n_slots):
        row = "".join(
            "q" if quar[s, u]
            else ("!" if tripped[s, u]
                  else ("A" if m == 0 else "M"))
            for u, m in enumerate(hist.modes[s])
        )
        note = ""
        if burst[0] <= s < burst[1]:
            note = "NaN burst -> health screen serves fail-safe"
        elif quar[s].any():
            note = "breaker open: expert quarantined"
        elif outage[0] <= s < outage[0] + ttl:
            note = "dApp down, last decision still fresh"
        elif s < outage[1] and s >= outage[0] + ttl:
            note = f"dApp down > ttl={ttl} -> decayed to fail-safe"
        elif outage[1] <= s < outage[1] + 1:
            note = "dApp back: decisions flow again"
        print(f"slot {s:3d} per-UE: {row}  {note}")
    print("legend: A=AI  M=MMSE fail-safe  !=health trip  q=quarantined")
    print(f"health trips: {int(tripped.sum())} slot-UEs, quarantined: "
          f"{int(quar.sum())} slot-UEs")

    replay = session.host_replay(hist)
    match = (
        np.array_equal(hist.modes, replay["active_mode"])
        and np.array_equal(hist.decisions, replay["raw_decision"])
        and np.array_equal(quar, np.asarray(replay["quarantined"]) > 0)
    )
    print(f"fault-injected device == host oracle: "
          f"{'yes (bitwise)' if match else 'NO'}")
    if not match:
        raise SystemExit("fault-injection replay equivalence violated")


def service_demo(n_ues: int, device: str) -> None:
    import json
    import tempfile
    import time
    import urllib.request

    from repro_torch.service import CampaignService
    from repro_torch.service.api import ServiceAPI

    spec = roundtrip(CampaignSpec(
        path="closed_loop",
        scenario="good_poor_good",
        scenario_args=(("poor_start", N_PHASE), ("poor_end", 2 * N_PHASE)),
        n_ues=n_ues,
        n_slots=3 * N_PHASE,
        seed=42,
        policies=(PolicySpec(kind="tree", depth=2),),
        switch=SwitchSpec(window_slots=2),
    ))
    hist_mono = ArchesSession(spec, device=device).run()

    print(f"\n== running the service: submit -> poll -> drain "
          f"[spec {spec_hash(spec)}] ==")
    with tempfile.TemporaryDirectory() as state:
        svc = CampaignService(state, max_segment_slots=N_PHASE,
                              device=device).start()
        api = ServiceAPI(svc).start()
        print(f"service up on {api.url} (standalone: "
              f"python -m repro_torch.service --state-dir <dir>)")

        # submit: the campaign spec IS the wire format; the service lifts
        # the zero-churn spec to its segmented streaming form
        req = urllib.request.Request(
            api.url + "/campaigns", data=spec.to_json().encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            cid = json.loads(r.read().decode())["campaign_id"]
        print(f"POST /campaigns -> {cid}")

        # poll: state + segment progress + provenance + checkpoint lineage
        last = None
        while True:
            with urllib.request.urlopen(
                api.url + f"/campaigns/{cid}", timeout=10
            ) as r:
                st = json.loads(r.read().decode())
            key = (st["state"], st["segments_done"])
            if key != last:
                print(f"GET  /campaigns/<id> -> {st['state']:9s} "
                      f"segment {st['segments_done']}/{st['n_segments']} "
                      f"checkpoints {st['checkpoint_steps']}")
                last = key
            if st["state"] in ("completed", "failed", "cancelled"):
                break
            time.sleep(0.05)
        if st["state"] != "completed":
            raise SystemExit(f"service campaign ended {st['state']!r}: "
                             f"{st['error']}")
        assert st["spec_hash"] == spec_hash(spec)

        with urllib.request.urlopen(
            api.url + "/telemetry?n=2", timeout=10
        ) as r:
            for s in json.loads(r.read().decode()):
                print(f"GET  /telemetry -> seg {s['seg_idx']} "
                      f"slots [{s['t0']},{s['t1']}) "
                      f"AI share {s['ai_share']:4.0%} "
                      f"throughput {s['throughput_bps'] / 1e6:5.1f} Mbps")

        hist_svc = svc.result(cid)
        api.stop()
        # drain: finish in-flight segments, checkpoint, exit; a killed
        # service instead resumes every in-flight campaign on restart
        if not svc.drain(timeout=60):
            raise SystemExit("drain timed out")
        print("POST /drain -> graceful exit")

    same = np.array_equal(hist_mono.modes, hist_svc.modes) and all(
        np.array_equal(hist_mono.kpms[k], hist_svc.kpms[k])
        for k in hist_mono.kpms
    )
    print(f"service-run campaign == monolithic run(): "
          f"{'yes (bitwise)' if same else 'NO'}")
    if not same:
        raise SystemExit("service zero-churn equivalence violated")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-ues", type=int, default=4)
    ap.add_argument("--host", action="store_true",
                    help="also run the single-UE host loop (E3 + dApp)")
    ap.add_argument("--gated", action="store_true",
                    help="demo compaction-gated execution")
    ap.add_argument("--heterogeneous", action="store_true",
                    help="demo per-UE scenario + policy heterogeneity")
    ap.add_argument("--multi-cell", action="store_true",
                    help="demo the sharded multi-cell topology (4 cells)")
    ap.add_argument("--streaming", action="store_true",
                    help="demo the epoch-chunked streaming driver (churn)")
    ap.add_argument("--faults", action="store_true",
                    help="demo the fault-injection degradation ladder")
    ap.add_argument("--service", action="store_true",
                    help="demo the resident campaign service "
                         "(submit -> poll -> drain over HTTP)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args()

    print("registered scenarios:", ", ".join(scenario_names()), "\n")
    closed_loop_demo(max(args.n_ues, 2), args.device)
    if args.host:
        host_demo(args.device)
    if args.gated:
        gated_demo(max(args.n_ues, 4), args.device)
    if args.heterogeneous:
        heterogeneous_demo(max(args.n_ues, 4), args.device)
    if args.multi_cell:
        multi_cell_demo(max(args.n_ues, 8), args.device)
    if args.streaming:
        streaming_demo(max(args.n_ues, 2), args.device)
    if args.faults:
        faults_demo(max(args.n_ues, 2), args.device)
    if args.service:
        service_demo(max(args.n_ues, 2), args.device)


if __name__ == "__main__":
    main()
