from .export import TEXT_CONTENT_TYPE, MetricsExporter
from .promparse import Exposition, ExpositionError, parse_exposition
from .server import MonitorServer, StatusWriter, serving_payload

__all__ = [
    "Exposition",
    "ExpositionError",
    "MetricsExporter",
    "MonitorServer",
    "StatusWriter",
    "TEXT_CONTENT_TYPE",
    "parse_exposition",
    "serving_payload",
]
