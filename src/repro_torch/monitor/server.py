"""Online application monitoring (paper Sec. 3.1: "a web-accessible HTTP
interface") — a stdlib HTTP server in a daemon thread serving the live timer
database, steerable parameters, and run status.

Endpoints:
    /            HTML overview (Fig.-2-style timer table + scope tree + the
                 serving queue/slot/shed rows when a serving engine is wired)
    /metrics     Prometheus text exposition (``text/plain; version=0.0.4``)
                 rendered by a :class:`repro_torch.monitor.export.MetricsExporter` —
                 pass ``exporter=`` to enrich it with detector/control-loop
                 state; by default one is built over the database plus any
                 wired serving/checkpoint payload fns
    /timers      JSON timer snapshot
    /tree        nested JSON timer forest (inclusive/exclusive seconds per
                 scope, children recursively — repro_torch.timing tree view)
    /params      JSON steerable parameters; POST /params {"name":..,"value":..}
                 steers a parameter live (paper Sec. 5 steering)
    /status      JSON run status (iteration, loss, checkpoint stats)
    /serving     JSON serving view: engine-level stats (queue depth, slot
                 occupancy, shed count, KV utilization) + per-request rows —
                 wire with ``serving_fn=engine.stats`` or the richer
                 ``serving_payload(engine)``
    /checkpoints JSON checkpoint view: on-disk checkpoints, retention policy,
                 quarantined (corrupt) entries with reasons, and the resume
                 plan the run started from — wire with
                 ``checkpoint_fn=manager.status_payload``
    /fleet       JSON fleet membership view: epoch, per-host weight/share/
                 stage/heartbeat age, join/leave/defer counters — wire with
                 ``fleet_fn=FleetController.status_payload``

Also provides :class:`StatusWriter`, which atomically writes the same payload to
a JSON file for clusters where an open port is not possible.
"""

from __future__ import annotations

import json
import os
import threading
from collections.abc import Callable
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ..core.params import ParamRegistry, param_registry
from ..core.report import format_report, format_tree_report, tree_rows
from ..core.timers import TimerDB, timer_db
from .export import TEXT_CONTENT_TYPE, MetricsExporter


__all__ = ["MonitorServer", "StatusWriter", "serving_payload"]


def serving_payload(engine) -> Callable[[], dict[str, Any]]:
    """Build a ``serving_fn`` over a :class:`repro_torch.serving.ServeSession`:
    engine-level stats plus the per-request rows, refreshed per scrape."""

    def payload() -> dict[str, Any]:
        return {"engine": engine.stats(), "requests": engine.request_stats()}

    return payload


def _serving_table(payload: dict[str, Any]) -> str:
    """Render the serving stats as report-style rows for the HTML overview."""
    engine = payload.get("engine", payload)
    width = max([len(k) for k in engine] + [len("serving row")]) + 2
    lines = ["Serving", "=" * (width + 14), f"{'serving row'.ljust(width)} {'value':>12}"]
    lines.append("-" * (width + 14))
    for key in sorted(engine):
        value = engine[key]
        shown = f"{value:12.4f}" if isinstance(value, float) else f"{value!s:>12}"
        lines.append(f"{key.ljust(width)} {shown}")
    return "\n".join(lines)


class StatusWriter:
    """Atomically writes run status + timer snapshot to a JSON file."""

    def __init__(self, path: str, db: TimerDB | None = None) -> None:
        self.path = path
        self._db = db if db is not None else timer_db()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, status: dict[str, Any]) -> None:
        payload = {"status": status, "timers": self._db.snapshot()}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)


class MonitorServer:
    """Threaded HTTP monitor.  Start with ``start()``; idempotent ``stop()``."""

    def __init__(
        self,
        port: int = 0,
        db: TimerDB | None = None,
        params: ParamRegistry | None = None,
        status_fn: Callable[[], dict[str, Any]] | None = None,
        serving_fn: Callable[[], dict[str, Any]] | None = None,
        checkpoint_fn: Callable[[], dict[str, Any]] | None = None,
        fleet_fn: Callable[[], dict[str, Any]] | None = None,
        exporter: MetricsExporter | None = None,
    ) -> None:
        self._db = db if db is not None else timer_db()
        self._params = params if params is not None else param_registry()
        self._status_fn = status_fn or (lambda: {})
        self._serving_fn = serving_fn
        self._checkpoint_fn = checkpoint_fn
        self._fleet_fn = fleet_fn
        self._exporter = (
            exporter
            if exporter is not None
            else MetricsExporter(
                self._db,
                serving_fn=serving_fn,
                checkpoint_fn=checkpoint_fn,
                fleet_fn=fleet_fn,
            )
        )
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._port = port

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        monitor = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence
                pass

            def _send(self, code: int, body: bytes, ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/metrics"):
                    self._send(
                        200,
                        monitor._exporter.render().encode(),
                        TEXT_CONTENT_TYPE,
                    )
                elif self.path.startswith("/timers"):
                    self._send(200, json.dumps(monitor._db.snapshot()).encode())
                elif self.path.startswith("/tree"):
                    self._send(200, json.dumps(tree_rows(monitor._db)).encode())
                elif self.path.startswith("/params"):
                    self._send(200, json.dumps(monitor._params.describe()).encode())
                elif self.path.startswith("/status"):
                    self._send(200, json.dumps(monitor._status_fn()).encode())
                elif self.path.startswith("/serving"):
                    if monitor._serving_fn is None:
                        self._send(404, b'{"error": "no serving engine wired"}')
                    else:
                        self._send(200, json.dumps(monitor._serving_fn()).encode())
                elif self.path.startswith("/checkpoints"):
                    if monitor._checkpoint_fn is None:
                        self._send(404, b'{"error": "no checkpoint manager wired"}')
                    else:
                        self._send(
                            200, json.dumps(monitor._checkpoint_fn()).encode()
                        )
                elif self.path.startswith("/fleet"):
                    if monitor._fleet_fn is None:
                        self._send(404, b'{"error": "no fleet controller wired"}')
                    else:
                        self._send(200, json.dumps(monitor._fleet_fn()).encode())
                elif self.path == "/" or self.path.startswith("/index"):
                    sections = [format_report(monitor._db), format_tree_report(monitor._db)]
                    if monitor._serving_fn is not None:
                        sections.append(_serving_table(monitor._serving_fn()))
                    body = (
                        "<html><body><pre>"
                        + "\n\n".join(sections)
                        + "</pre></body></html>"
                    )
                    self._send(200, body.encode(), "text/html")
                else:
                    self._send(404, b'{"error": "not found"}')

            def do_POST(self):
                if not self.path.startswith("/params"):
                    self._send(404, b'{"error": "not found"}')
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                    monitor._params.set(req["name"], req["value"])
                    self._send(200, b'{"ok": true}')
                except Exception as exc:  # noqa: BLE001 - report to client
                    self._send(400, json.dumps({"error": str(exc)}).encode())

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None
