"""Run the campaign service as a process: ``python -m repro_torch.service``.

Campaigns run on the card; ``--device cpu`` runs them on the host.

Prints one JSON line (``{"port": ..., "url": ..., "state_dir": ...}``) to
stdout once the API is bound — the handshake a parent process (or the
SIGTERM kill-and-resume test) parses to find the ephemeral port.

SIGTERM/SIGINT trigger the graceful drain: every worker finishes its
current segment (whose checkpoint is already durable), campaigns are
marked ``interrupted``, the telemetry pump flushes, and the process exits
0.  Restarting with the same ``--state-dir`` resumes every non-terminal
campaign bitwise from its latest checkpoint.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="ARCHES resident campaign service",
    )
    p.add_argument("--state-dir", required=True,
                   help="persistent service state root")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="API port (0 = ephemeral, printed on stdout)")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--queue-size", type=int, default=16)
    p.add_argument("--ring-capacity", type=int, default=256)
    p.add_argument("--max-segment-slots", type=int, default=8)
    p.add_argument("--telemetry-jsonl", default=None,
                   help="append segment telemetry to this JSONL file")
    p.add_argument("--device", default="cuda",
                   help="where campaigns run: cuda (default) or cpu")
    args = p.parse_args(argv)

    from repro_torch.service.api import ServiceAPI
    from repro_torch.service.exporters import JsonlExporter
    from repro_torch.service.service import CampaignService

    exporters = (
        [JsonlExporter(args.telemetry_jsonl)]
        if args.telemetry_jsonl
        else []
    )
    service = CampaignService(
        args.state_dir,
        n_workers=args.workers,
        queue_size=args.queue_size,
        ring_capacity=args.ring_capacity,
        exporters=exporters,
        max_segment_slots=args.max_segment_slots,
        device=args.device,
    ).start()
    api = ServiceAPI(service, host=args.host, port=args.port).start()

    stop = threading.Event()

    def _on_signal(signum, frame):
        service.request_drain()
        stop.set()

    # the handlers are in place before the handshake: a parent that signals
    # as soon as it has read the port must find them
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    print(
        json.dumps(
            {"port": api.port, "url": api.url, "state_dir": args.state_dir}
        ),
        flush=True,
    )

    stop.wait()
    ok = service.drain(timeout=120.0)
    api.stop()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
