"""Northbound status/control API (a copy of ``repro.service.api``) — stdlib
``http.server``, JSON in/out.

Routes (all JSON bodies/responses):

* ``GET  /health``                  — service health + telemetry counters
* ``GET  /campaigns``               — list campaigns (submission order)
* ``POST /campaigns``               — submit a ``CampaignSpec`` (its JSON
  form); 201 + ``{"campaign_id": ...}``; 400 invalid spec, 503 when the
  queue is saturated or the service is draining
* ``GET  /campaigns/<id>``          — per-campaign status: state, segment
  progress, spec_hash provenance, checkpoint lineage; 404 unknown
* ``POST /campaigns/<id>/cancel``   — cancel (queued: immediate; running:
  next segment boundary); 404 unknown
* ``GET  /telemetry?n=K``           — the most recent K ring samples
* ``POST /drain``                   — begin graceful drain

``ThreadingHTTPServer`` keeps slow clients off the dispatch loop; every
handler only touches the service's lock-guarded views, never the workers.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from repro_torch.service.service import (
    CampaignService,
    ServiceDrainingError,
    ServiceSaturatedError,
    UnknownCampaignError,
)


class _Handler(BaseHTTPRequestHandler):
    service: CampaignService  # bound by ServiceAPI via a subclass attribute

    # -- plumbing --------------------------------------------------------------

    def log_message(self, fmt, *args):  # silent: the service is the log
        pass

    def _send(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        return json.loads(raw.decode() or "null")

    # -- routes ----------------------------------------------------------------

    def do_GET(self):
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if parts == ["health"]:
                return self._send(200, self.service.health())
            if parts == ["campaigns"]:
                return self._send(200, self.service.list_campaigns())
            if len(parts) == 2 and parts[0] == "campaigns":
                return self._send(200, self.service.status(parts[1]))
            if parts == ["telemetry"]:
                q = parse_qs(url.query)
                try:
                    n = int(q["n"][0]) if "n" in q else None
                except ValueError:
                    return self._send(
                        400, {"error": "n must be an integer"}
                    )
                return self._send(200, self.service.ring.snapshot(n))
            self._send(404, {"error": f"no route {url.path!r}"})
        except UnknownCampaignError as e:
            self._send(404, {"error": f"unknown campaign {e.args[0]!r}"})

    def do_POST(self):
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if parts == ["campaigns"]:
                cid = self.service.submit(self._body())
                return self._send(201, {"campaign_id": cid})
            if (
                len(parts) == 3
                and parts[0] == "campaigns"
                and parts[2] == "cancel"
            ):
                state = self.service.cancel(parts[1])
                return self._send(
                    200, {"campaign_id": parts[1], "state": state}
                )
            if parts == ["drain"]:
                self.service.request_drain()
                return self._send(202, {"draining": True})
            self._send(404, {"error": f"no route {url.path!r}"})
        except UnknownCampaignError as e:
            self._send(404, {"error": f"unknown campaign {e.args[0]!r}"})
        except (ServiceSaturatedError, ServiceDrainingError) as e:
            self._send(503, {"error": str(e)})
        except (ValueError, TypeError, KeyError) as e:
            self._send(400, {"error": f"invalid campaign spec: {e}"})


class ServiceAPI:
    """Bind a ``CampaignService`` to an HTTP endpoint.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` — the
    test/benchmark pattern).  The server runs on a daemon thread;
    ``stop()`` shuts it down without touching the service itself.
    """

    def __init__(
        self,
        service: CampaignService,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        handler = type("_BoundHandler", (_Handler,), {"service": service})
        self.service = service
        self.server = ThreadingHTTPServer((host, port), handler)
        self.server.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def host(self) -> str:
        return self.server.server_address[0]

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServiceAPI":
        self._thread = threading.Thread(
            target=self.server.serve_forever,
            name="service-api",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
