"""The live observability server: /metrics /healthz /snapshot /flight
/memory /audit /timeline /incidents /serve (copy of
``pyruhvro_tpu/runtime/obs_server.py``, whole).

An opt-in background HTTP server of the standard library
(``http.server`` on a daemon thread, bound to 127.0.0.1 by default) that
renders the live registry on each request:

* ``GET /metrics``: the Prometheus text, byte-identical to
  ``telemetry.prometheus()`` (it is the same function); ``?exemplars=1``
  adds trace-id exemplars to the latency histograms;
* ``GET /healthz``: readiness and degradation bits as JSON (:func:`health`),
  200 while the process serves, 503 while a storm, a drift, an SLO
  breach or an audit mismatch makes it unhealthy;
* ``GET /snapshot``: ``telemetry.snapshot()`` (``?compress=1`` gzips it);
* ``GET /flight``: the flight recorder (``telemetry.flight_dump()``);
* ``GET /memory``: the live memory accounting section
  (``memacct.snapshot_memory()``: RSS, the planes' bytes, the lifecycle,
  the card's watermarks, the tenants); a saved snapshot's own section;
* ``GET /audit``, ``/timeline`` (``?tick=1`` ticks first) and
  ``/incidents``: :mod:`.audit`, :mod:`.timeline` and :mod:`.incident`;
* ``GET /serve``: ``{}``, since no serving plane ran (``ROADMAP.md`` (a)
  8.9).

``PYRUHVRO_TPU_OBS_PORT=<port>`` (``0`` = any free port; the chosen port
is printed to stderr and is ``server().port``) starts it at the import
of :mod:`.telemetry`, never in a spawn-pool worker; ``PYRUHVRO_TPU_OBS_HOST``
sets the bind host. It costs nothing per call (it reads, on its own
thread, under the locks every exporter takes). A handler that fails
answers 500 and counts ``obs.handler_error`` (fault site
``obs_handler``), as in the reference: the server observes, and the
calls it observes are already complete.

The same server also serves a SAVED snapshot dict (``python -m
pyruhvro_tpu_torch.telemetry serve snapshot.json``).

Departures (``ROADMAP.md`` (c) 9): ``degraded_bits.device_backend``
reads ``"unprobed"`` until ``ops/codec.py`` is imported and
``"imported"`` after, never ``"remote"`` or ``"local"`` (the port has no
interconnect probe); ``native_ext`` reads the module cache of
:mod:`.native` (``"loaded"`` or ``"unprobed"``; a failed build raises
and is not cached) and never starts a build.
"""

from __future__ import annotations

import gzip
import json
import os
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from . import knobs, metrics

__all__ = [
    "ENDPOINTS",
    "ObsServer",
    "health",
    "start",
    "stop",
    "server",
    "start_from_env",
]

# the paths the server answers (the reference's)
ENDPOINTS = ("/metrics", "/healthz", "/snapshot", "/flight", "/memory",
             "/audit", "/serve", "/timeline", "/incidents")

# how long (seconds) a storm/drift event keeps /healthz unhealthy after
# it fired — long enough for a scraper on a normal interval to see it,
# short enough that a recovered process goes green again on its own
_DEFAULT_HEALTH_WINDOW_S = 60.0

_lock = threading.Lock()
_server: Optional["ObsServer"] = None  # guarded-by: _lock

# the port's package name, for the modules read through sys.modules
_PACKAGE = __name__.rsplit(".", 2)[0]


def _health_window_s() -> float:
    return max(0.0, knobs.get_float("PYRUHVRO_TPU_HEALTH_WINDOW"))


def _native_state() -> str:
    """Native-extension state WITHOUT triggering a build: a health probe
    must never spend seconds in g++. Either flavour serves the native
    tier (the profiled one is what PYRUHVRO_TPU_NATIVE_PROF and the deep
    sampler load)."""
    from . import native

    if native.loaded("host_codec") or native.loaded("host_codec", True):
        return "loaded"
    return "unprobed"


def _device_state() -> str:
    """Device-backend state without touching the card: whether the
    device codec's module was imported."""
    codec = sys.modules.get(_PACKAGE + ".ops.codec")
    return "unprobed" if codec is None else "imported"


def health() -> Tuple[int, Dict[str, Any]]:
    """-> (http_status, body). Unhealthy (503) bits are ACTIVE
    conditions: a quarantine or recompile storm / latency drift within
    the health window, or a currently-breached SLO. Degraded-but-
    serviceable facts (broken spawn pool, native tier unavailable)
    stay 200 — the process still answers calls — but are reported so
    a dashboard can alarm on them separately."""
    from . import breaker, slo
    from .pool import process_available

    window = _health_window_s()

    def recent(key: str) -> bool:
        age = metrics.mark_age(key)
        return age is not None and age <= window

    slo_breached = slo.breached()
    unhealthy = {
        "quarantine_storm": recent("quarantine_storm"),
        "recompile_storm": recent("recompile_storm"),
        "latency_drift": recent("latency_drift"),
        "slo_breach": bool(slo_breached),
        # RSS crossed the memory high-water mark within the window
        # (memacct.tick marks it)
        "mem_pressure": recent("mem_pressure"),
        # a differential-audit shadow caught a tier producing wrong
        # bytes within the window — the one bit that means
        # "answers may be silently wrong", which outranks every
        # latency condition above
        "audit_mismatch": recent("audit_mismatch"),
        # a serving-plane queue hit its depth cap within the window
        # (the serving plane is not ported yet: ROADMAP.md (a) 8.9)
        "queue_saturated": recent("queue_saturated"),
    }
    # non-closed circuit breakers are degradation facts: the process
    # still answers (the degraded path serves), so they stay 200, but a
    # dashboard can alarm on the seam being withheld
    open_breakers = {name: b["state"]
                     for name, b in breaker.snapshot_breakers().items()
                     if b.get("state") != "closed"}
    # the serving plane's brownout ladder: engaged rungs are live state
    # (not window-based), read without importing the package eagerly
    serving_mod = sys.modules.get(_PACKAGE + ".serving")
    brownout_rungs = (list(serving_mod.engaged_rungs())
                      if serving_mod is not None else [])
    degraded = {
        "spawn_pool_broken": not process_available(),
        "native_ext": _native_state(),
        "device_backend": _device_state(),
        "breakers": open_breakers,
        # serving plane shed at least one request within the window
        "shedding": recent("serve_shed"),
        # brownout rungs currently engaged (auto-recover on pressure
        # release; each engagement is also counted)
        "brownout": brownout_rungs,
    }
    ready = not any(unhealthy.values())
    status = ("ok" if ready and not degraded["spawn_pool_broken"]
              and not open_breakers and not degraded["shedding"]
              and not brownout_rungs
              else "degraded" if ready else "unhealthy")
    body: Dict[str, Any] = {
        "status": status,
        "ready": ready,
        "pid": os.getpid(),
        "health_window_s": window,
        "unhealthy_bits": unhealthy,
        "degraded_bits": degraded,
    }
    if slo_breached:
        body["slo_breached"] = slo_breached
    return (200 if ready else 503), body


class _Handler(BaseHTTPRequestHandler):
    server_version = "pyruhvro-tpu-obs"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silent: a scrape per 15s must
        pass                            # not spam the service's stderr

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, doc: Any) -> None:
        self._send(code, json.dumps(doc, indent=1, default=str).encode(),
                   "application/json")

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path, _, query = self.path.partition("?")
        path = path.rstrip("/") or "/"
        params = urllib.parse.parse_qs(query)

        def flag(name: str) -> bool:
            v = params.get(name, [""])[-1].strip().lower()
            return v not in ("", "0", "false", "no", "off")

        snap_doc = self.server._static_snapshot  # type: ignore[attr-defined]
        try:
            metrics.inc("obs.requests")
            from . import faults

            faults.fire("obs_handler")  # chaos seam -> the 500 path below
            if path == "/metrics":
                from . import telemetry

                # plain scrapes stay BYTE-IDENTICAL to
                # telemetry.prometheus(); ?exemplars=1 opts an
                # OpenMetrics-aware collector into exemplar syntax
                text = telemetry.prometheus(
                    snap_doc, exemplars=flag("exemplars"))  # None = live
                self._send(200, text.encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                if snap_doc is not None:
                    code, body = _static_health(snap_doc)
                else:
                    code, body = health()
                self._send_json(code, body)
            elif path == "/snapshot":
                if snap_doc is not None:
                    doc = snap_doc
                else:
                    from . import telemetry

                    doc = telemetry.snapshot()
                if flag("compress"):
                    # ?compress=1 (the fleet scraper): gzip on the wire
                    # makes a 3-replica pull cheap over a WAN
                    body = gzip.compress(
                        json.dumps(doc, indent=1, default=str).encode())
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Encoding", "gzip")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send_json(200, doc)
            elif path == "/flight":
                if snap_doc is not None:
                    self._send_json(200, {
                        "static": True,
                        "records": [],
                        "note": "flight records are not part of saved "
                                "snapshots; use the live endpoint or a "
                                "flight dump file",
                    })
                else:
                    from . import telemetry

                    self._send_json(200, telemetry.flight_dump())
            elif path == "/audit":
                if snap_doc is not None:
                    aud = snap_doc.get("audit")
                    self._send_json(
                        200, aud if aud is not None else {
                            "static": True,
                            "note": "snapshot predates the "
                                    "differential-audit plane",
                        })
                else:
                    from . import audit

                    self._send_json(200, audit.snapshot_audit())
            elif path == "/serve":
                if snap_doc is not None:
                    sv = snap_doc.get("serving")
                    self._send_json(
                        200, sv if sv is not None else {
                            "static": True,
                            "note": "snapshot predates the serving "
                                    "plane, or no plane ran",
                        })
                else:
                    serving_mod = sys.modules.get(_PACKAGE + ".serving")
                    self._send_json(
                        200, serving_mod.snapshot_serving()
                        if serving_mod is not None else {})
            elif path == "/timeline":
                if snap_doc is not None:
                    tl = snap_doc.get("timeline")
                    self._send_json(
                        200, tl if tl is not None else {
                            "static": True,
                            "note": "snapshot predates the incident "
                                    "timeline plane, or it never "
                                    "ticked",
                        })
                else:
                    from . import timeline

                    if flag("tick"):
                        # ?tick=1: force an aggregation tick NOW so an
                        # operator mid-incident sees the current
                        # interval without waiting out the clock
                        timeline.tick_now()
                    self._send_json(200, timeline.snapshot_timeline())
            elif path == "/incidents":
                if snap_doc is not None:
                    self._send_json(200, {
                        "static": True,
                        "incidents": [],
                        "note": "incident bundles are on-disk "
                                "artifacts, not part of saved "
                                "snapshots; use the live endpoint or "
                                "list PYRUHVRO_TPU_INCIDENT_DIR",
                    })
                else:
                    from . import incident

                    self._send_json(200, incident.list_incidents())
            elif path == "/memory":
                if snap_doc is not None:
                    mem = snap_doc.get("memory")
                    self._send_json(
                        200, mem if mem is not None else {
                            "static": True,
                            "note": "snapshot predates the memory "
                                    "accounting plane",
                        })
                else:
                    from . import memacct

                    self._send_json(200, memacct.snapshot_memory())
            else:
                self._send_json(404, {
                    "error": f"unknown path {path!r}",
                    "endpoints": list(ENDPOINTS),
                })
        except BrokenPipeError:
            pass  # scraper went away mid-response
        except Exception as e:  # noqa: BLE001 — the server must survive
            metrics.inc("obs.handler_error")
            try:
                self._send_json(500, {"error": repr(e)})
            except OSError:
                pass


def _static_health(snap: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
    """Health computed from a SAVED snapshot: no liveness to assert,
    but the recorded SLO/storm state still renders (a breached saved
    snapshot serves 503 so alert rules can be tested against files)."""
    slo_sec = snap.get("slo") or {}
    breached = slo_sec.get("breached") or []
    counters = snap.get("counters") or {}
    body = {
        "status": "unhealthy" if breached else "static",
        "ready": not breached,
        "static": True,
        "pid": snap.get("pid"),
        "schema_version": snap.get("schema_version"),
        "recorded": {
            "quarantine_storms": (
                counters.get("decode.quarantine_storms", 0)
                + counters.get("encode.quarantine_storms", 0)),
            "recompile_storms": counters.get("device.recompile_storm", 0),
            "drift_detections": counters.get("drift.detected", 0),
            "slo_breaches": counters.get("slo.breach", 0),
            "audit_mismatches": counters.get("audit.mismatches", 0),
            "serve_shed": counters.get("serve.shed", 0),
        },
    }
    if breached:
        body["slo_breached"] = breached
    return (503 if breached else 200), body


class ObsServer:
    """One background HTTP server (live registry, or a static snapshot
    dict when ``snapshot`` is given)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 snapshot: Optional[Dict[str, Any]] = None):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd._static_snapshot = snapshot  # type: ignore[attr-defined]
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ObsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.25},
                name="pyruhvro-obs", daemon=True,
            )
            self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Foreground mode (the CLI ``serve`` subcommand)."""
        self._httpd.serve_forever(poll_interval=0.25)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def server() -> Optional[ObsServer]:
    """The process's live obs server, if one is running."""
    return _server


def start(port: int = 0, host: str = "127.0.0.1") -> ObsServer:
    """Start (or return) the process-wide live obs server. Idempotent:
    a second start returns the running instance."""
    global _server
    with _lock:
        if _server is None:
            _server = ObsServer(port=port, host=host).start()
            metrics.inc("obs.server_started")
    return _server


def stop() -> None:
    global _server
    with _lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()


def start_from_env() -> Optional[ObsServer]:
    """Start the server when ``PYRUHVRO_TPU_OBS_PORT`` is set (the
    import-time hook in :mod:`.telemetry`). A malformed value or an
    unbindable port is counted and logged, never raised — observability
    must not take the service down."""
    raw = knobs.get_raw("PYRUHVRO_TPU_OBS_PORT").strip()
    if not raw:
        return None
    try:
        import multiprocessing

        if multiprocessing.parent_process() is not None:
            # spawn-pool workers inherit the env: the PARENT owns the
            # scrape endpoint (worker telemetry merges back into it);
            # a worker binding the same fixed port would just fail
            return None
    except Exception:
        pass
    try:
        port = int(raw)
    except ValueError:
        metrics.inc("obs.bad_port")
        return None
    try:
        srv = start(port=port,
                    host=knobs.get_str("PYRUHVRO_TPU_OBS_HOST"))
    except OSError:
        metrics.inc("obs.bind_error")
        return None
    print(f"[pyruhvro_tpu_torch] obs server listening on {srv.url} "
          f"({' '.join(ENDPOINTS)})", file=sys.stderr)
    return srv
