"""Dependency-free OTLP/HTTP-JSON exporter: spans and metrics (copy of
``pyruhvro_tpu/runtime/otel.py``, whole).

Ships the telemetry plane's data to any OpenTelemetry collector over the
OTLP/HTTP JSON encoding (``/v1/traces`` and ``/v1/metrics``) with the
standard library only: no SDK, no protobuf.

* :func:`telemetry.set_span_sink` hands every finished ROOT span to
  :meth:`OtlpExporter.enqueue`: one bounded ``deque`` append on the
  call's path (a drop counts ``otlp.spans_dropped`` when the collector
  cannot keep up; the call never waits on the export).
* One daemon thread wakes every ``PYRUHVRO_TPU_OTLP_INTERVAL_S``
  seconds, drains the queue, maps the span trees, counters, gauges and
  histograms (with the worst call's trace id as an **exemplar**) to OTLP
  JSON and POSTs them through ``urllib``. The card's launch spans
  (``device.compile_s`` / ``device.launch_s``) travel as children of
  their root, their kernel seconds (``walk_s``, ``finalize_s``, ...)
  and bound ``bytes`` as plain OTLP attributes.
* Both POSTs go through an ``otlp_export`` circuit breaker
  (:mod:`.breaker`): a dead collector costs one failed request per
  backoff window, and the spans of a refused flush stay queued (bounded)
  for the next pass. A failed POST is counted (``otlp.export_errors``),
  never raised: the calls it observes are complete, as in the reference.

The resource and scope names are the reference's (``pyruhvro_tpu``), as
the Prometheus names are, so one collector's views read both packages.

Opt-in through ``PYRUHVRO_TPU_OTLP_ENDPOINT`` (the collector's base URL;
telemetry's import hook calls :func:`start_from_env`) or :func:`start`.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Any, Dict, List, Optional

from . import breaker, knobs, metrics, traceprop

__all__ = ["OtlpExporter", "start", "start_from_env", "stop", "exporter"]

_QUEUE_MAX = 2048       # root spans buffered between flushes
_POST_TIMEOUT_S = 5.0

_lock = threading.Lock()
_exporter: Optional["OtlpExporter"] = None  # guarded-by: _lock

# epoch anchor for cumulative metric start times (process start is the
# natural zero for counters that only ever grow)
_START_NS = int(time.time() * 1e9)


def _ns(epoch_s: float) -> int:
    return int(epoch_s * 1e9)


def _attr(key: str, value: Any) -> Dict[str, Any]:
    """One OTLP KeyValue (bool before int: bool IS an int in Python)."""
    if isinstance(value, bool):
        v: Dict[str, Any] = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def _resource() -> Dict[str, Any]:
    return {"attributes": [
        _attr("service.name", "pyruhvro_tpu"),
        _attr("process.pid", os.getpid()),
    ]}


def _flatten_span(node: Dict[str, Any], trace_id: str, parent_id: str,
                  out: List[Dict[str, Any]]) -> None:
    """One span-tree node -> flat OTLP spans. Child phases carry no ids
    of their own (only roots do); they mint export-time span ids and
    parent under the node above."""
    span_id = node.get("span_id") or traceprop.new_span_id()
    ts = float(node.get("ts") or 0.0)
    dur = float(node.get("dur_s") or 0.0)
    otlp: Dict[str, Any] = {
        "traceId": trace_id,
        "spanId": span_id,
        "name": str(node.get("name", "?")),
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(_ns(ts)),
        "endTimeUnixNano": str(_ns(ts + dur)),
        "attributes": [
            _attr(k, v) for k, v in (node.get("attrs") or {}).items()
            if isinstance(v, (str, int, float, bool))
        ],
    }
    if parent_id:
        otlp["parentSpanId"] = parent_id
    if (node.get("attrs") or {}).get("error"):
        otlp["status"] = {"code": 2}  # STATUS_CODE_ERROR
    out.append(otlp)
    for c in node.get("children") or []:
        _flatten_span(c, trace_id, span_id, out)


def spans_to_otlp(roots: List[Dict[str, Any]]) -> Dict[str, Any]:
    """An ExportTraceServiceRequest JSON dict from finished root-span
    dicts (:meth:`telemetry.Span.to_dict` shape)."""
    flat: List[Dict[str, Any]] = []
    for root in roots:
        trace_id = root.get("trace_id") or traceprop.new_trace_id()
        _flatten_span(root, trace_id, root.get("parent_span_id") or "",
                      flat)
    return {"resourceSpans": [{
        "resource": _resource(),
        "scopeSpans": [{
            "scope": {"name": "pyruhvro_tpu.telemetry"},
            "spans": flat,
        }],
    }]}


def _hist_datapoint(summary: Dict[str, Any], now_ns: int) -> Dict[str, Any]:
    """De-cumulate a telemetry histogram summary (cumulative [le, n]
    pairs, zero buckets elided, +Inf-terminated) into OTLP explicit
    bounds + per-bucket counts."""
    bounds: List[float] = []
    counts: List[int] = []
    prev = 0
    for le, cum in summary.get("buckets", []):
        if le != "+Inf":
            bounds.append(float(le))
        counts.append(int(cum) - prev)
        prev = int(cum)
    dp: Dict[str, Any] = {
        "startTimeUnixNano": str(_START_NS),
        "timeUnixNano": str(now_ns),
        "count": str(int(summary.get("count", 0))),
        "sum": float(summary.get("sum", 0.0)),
        "explicitBounds": bounds,
        "bucketCounts": [str(c) for c in counts],
    }
    ex = summary.get("exemplar")
    if ex:
        dp["exemplars"] = [{
            "asDouble": float(ex["value"]),
            "timeUnixNano": str(now_ns),
            "traceId": ex["trace_id"],
        }]
    return dp


def metrics_to_otlp(counters: Dict[str, float],
                    gauges: Dict[str, float],
                    hists: Dict[str, Any]) -> Dict[str, Any]:
    """An ExportMetricsServiceRequest JSON dict: cumulative monotonic
    sums for the flat counters, gauges as-is, histograms with
    worst-call exemplars."""
    now_ns = _ns(time.time())
    out: List[Dict[str, Any]] = []
    for key, v in sorted(counters.items()):
        out.append({"name": key, "sum": {
            "dataPoints": [{"asDouble": float(v),
                            "startTimeUnixNano": str(_START_NS),
                            "timeUnixNano": str(now_ns)}],
            "aggregationTemporality": 2,  # CUMULATIVE
            "isMonotonic": True,
        }})
    for key, v in sorted(gauges.items()):
        out.append({"name": key, "gauge": {
            "dataPoints": [{"asDouble": float(v),
                            "timeUnixNano": str(now_ns)}],
        }})
    for key, h in sorted(hists.items()):
        out.append({"name": key, "histogram": {
            "dataPoints": [_hist_datapoint(h, now_ns)],
            "aggregationTemporality": 2,
        }})
    return {"resourceMetrics": [{
        "resource": _resource(),
        "scopeMetrics": [{
            "scope": {"name": "pyruhvro_tpu.telemetry"},
            "metrics": out,
        }],
    }]}


class OtlpExporter:
    """Background OTLP/HTTP-JSON shipper (one daemon thread)."""

    def __init__(self, endpoint: str, interval_s: Optional[float] = None):
        self.endpoint = endpoint.rstrip("/")
        iv = (interval_s if interval_s is not None
              else knobs.get_float("PYRUHVRO_TPU_OTLP_INTERVAL_S"))
        self.interval_s = max(0.05, float(iv or 5.0))
        # bounded hot-path buffer: enqueue is one GIL-atomic append;
        # overflow drops the OLDEST span (deque maxlen semantics) and
        # counts it — the data plane never blocks on a slow collector
        self._q: deque = deque(maxlen=_QUEUE_MAX)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- hot path -----------------------------------------------------------

    def enqueue(self, span) -> None:
        """telemetry's finished-root-span sink (set_span_sink)."""
        if len(self._q) == _QUEUE_MAX:
            metrics.inc("otlp.spans_dropped")
        self._q.append(span.to_dict())

    # -- background thread --------------------------------------------------

    def start(self) -> "OtlpExporter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="pyruhvro-otlp", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush()
        self.flush()  # final drain on stop()

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    # -- flush / POST -------------------------------------------------------

    def flush(self) -> bool:
        """Drain the queue and POST spans + a metrics snapshot. Returns
        True when everything that was attempted succeeded. Never
        raises: export failure is the collector's problem, counted and
        retried through the breaker, never the data plane's."""
        br = breaker.get("otlp_export")
        if not br.acquire():
            # breaker open: leave the (bounded) queue for the next pass
            metrics.inc("otlp.export_skipped")
            return False
        spans: List[Dict[str, Any]] = []
        while True:
            try:
                spans.append(self._q.popleft())
            except IndexError:
                break
        from . import telemetry

        ok = True
        if spans:
            ok = self._post("/v1/traces", spans_to_otlp(spans))
            if ok:
                metrics.inc("otlp.spans_exported", float(len(spans)))
            else:
                # requeue at the front so ordering survives a retry;
                # maxlen evicts (and the next enqueue counts) overflow
                for sd in reversed(spans):
                    self._q.appendleft(sd)
        ok = self._post("/v1/metrics", metrics_to_otlp(
            metrics.snapshot(), metrics.gauges(),
            telemetry.hist_summaries())) and ok
        if ok:
            br.record_success()
            metrics.inc("otlp.exports")
        else:
            br.record_failure()
            metrics.inc("otlp.export_errors")
        return ok

    def _post(self, path: str, doc: Dict[str, Any]) -> bool:
        body = json.dumps(doc).encode("utf-8")
        req = urllib.request.Request(
            self.endpoint + path, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=_POST_TIMEOUT_S) as r:
                return 200 <= r.status < 300
        except (urllib.error.URLError, OSError, ValueError):
            return False


# ---------------------------------------------------------------------------
# module-level lifecycle (telemetry's import hook + tests)
# ---------------------------------------------------------------------------


def start(endpoint: str,
          interval_s: Optional[float] = None) -> OtlpExporter:
    """Start (or return) the process-wide exporter and register it as
    telemetry's span sink."""
    global _exporter
    from . import telemetry

    with _lock:
        if _exporter is None:
            _exporter = OtlpExporter(endpoint, interval_s).start()
            telemetry.set_span_sink(_exporter.enqueue)
            metrics.inc("otlp.exporter_started")
        return _exporter


def start_from_env() -> Optional[OtlpExporter]:
    """Start the exporter when ``PYRUHVRO_TPU_OTLP_ENDPOINT`` is set.
    Spawned pool workers skip it: their spans ship home inside the
    worker payload and export once, from the parent."""
    ep = knobs.get_str("PYRUHVRO_TPU_OTLP_ENDPOINT")
    if not ep or not ep.strip():
        return None
    import multiprocessing

    if multiprocessing.parent_process() is not None:
        return None
    return start(ep.strip())


def stop() -> None:
    """Stop the exporter (final flush included) and detach the sink."""
    global _exporter
    from . import telemetry

    with _lock:
        ex = _exporter
        _exporter = None
    if ex is not None:
        telemetry.set_span_sink(None)
        ex.stop()


def exporter() -> Optional[OtlpExporter]:
    with _lock:
        return _exporter
