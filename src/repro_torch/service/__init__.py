"""repro_torch.service — the resident campaign service over streaming campaigns
(port of ``repro.service``).

The long-running-service shape from the ROADMAP's streaming line of work:
an async dispatch loop (`CampaignService`) that schedules submitted
``CampaignSpec``s across a worker pool via the segment-boundary streaming
machinery (checkpointing on by default, graceful drain, bitwise crash
resume), a non-blocking telemetry export layer (``TelemetryRing`` +
pluggable ``Exporter``s), and a northbound stdlib-HTTP status/control API
(``ServiceAPI``).
"""

from repro_torch.service.exporters import Exporter, ExportPump, JsonlExporter
from repro_torch.service.ring import TelemetryRing
from repro_torch.service.service import (
    CampaignRecord,
    CampaignService,
    CampaignState,
    ServiceDrainingError,
    ServiceSaturatedError,
    UnknownCampaignError,
)

__all__ = [
    "CampaignRecord",
    "CampaignService",
    "CampaignState",
    "Exporter",
    "ExportPump",
    "JsonlExporter",
    "ServiceAPI",
    "ServiceDrainingError",
    "ServiceSaturatedError",
    "TelemetryRing",
    "UnknownCampaignError",
]


def __getattr__(name):
    # ServiceAPI pulls in http.server; keep the core service importable
    # without it (and avoid the import cost on the worker-only path)
    if name == "ServiceAPI":
        from repro_torch.service.api import ServiceAPI

        return ServiceAPI
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
