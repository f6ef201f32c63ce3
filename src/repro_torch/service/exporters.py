"""Pluggable telemetry exporters + the pump that feeds them off the ring (a copy
of ``repro.service.exporters``).

``Exporter`` is the northbound telemetry interface: batches of plain-dict
segment samples, at-least-once per drain, strictly ordered.  The in-tree
``JsonlExporter`` appends one JSON object per line.  ``ExportPump`` is a
daemon thread with its own ring cursor: it polls ``TelemetryRing.drain``
and hands batches to every exporter — exporter exceptions are counted
(``export_errors``) and swallowed, and ring drops are accumulated
(``dropped``), so a slow or broken exporter degrades to counted loss and
can never stall the dispatch loop.
"""

from __future__ import annotations

import json
import threading

from repro_torch.service.ring import TelemetryRing


class Exporter:
    """Interface for telemetry sinks consumed by ``ExportPump``."""

    def export(self, samples: list) -> None:
        """Deliver a batch of samples (dicts), oldest first."""
        raise NotImplementedError

    def close(self) -> None:
        """Flush and release resources; called once at pump shutdown."""


class JsonlExporter(Exporter):
    """Append-only JSON-lines file sink (one sample object per line)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def export(self, samples: list) -> None:
        for s in samples:
            self._f.write(json.dumps(s, sort_keys=True) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class ExportPump(threading.Thread):
    """Daemon thread draining the ring into a set of exporters.

    Counters (all monotonic): ``exported`` samples handed to exporters,
    ``dropped`` samples the ring overwrote before this pump drained them
    (exact, from ``TelemetryRing.drain``), ``export_errors`` exporter
    ``export()`` calls that raised.
    """

    def __init__(
        self,
        ring: TelemetryRing,
        exporters: list,
        *,
        poll_interval: float = 0.05,
    ):
        super().__init__(name="telemetry-export-pump", daemon=True)
        self.ring = ring
        self.exporters = list(exporters)
        self.poll_interval = poll_interval
        self.exported = 0
        self.dropped = 0
        self.export_errors = 0
        self._cursor = 0
        self._stop_event = threading.Event()

    def run(self) -> None:
        while not self._stop_event.wait(self.poll_interval):
            self.pump_once()
        # final flush: everything still in the ring goes out before close
        self.pump_once()
        for ex in self.exporters:
            try:
                ex.close()
            except Exception:
                self.export_errors += 1

    def pump_once(self) -> int:
        """One drain-and-export cycle; returns samples delivered."""
        samples, self._cursor, dropped = self.ring.drain(self._cursor)
        self.dropped += dropped
        if samples:
            for ex in self.exporters:
                try:
                    ex.export(samples)
                except Exception:
                    self.export_errors += 1
            self.exported += len(samples)
        return len(samples)

    def stop(self, timeout: float | None = 5.0) -> None:
        """Signal shutdown and wait for the final flush."""
        self._stop_event.set()
        if self.is_alive():
            self.join(timeout)

    def counters(self) -> dict:
        return {
            "exported": self.exported,
            "dropped": self.dropped,
            "export_errors": self.export_errors,
        }
