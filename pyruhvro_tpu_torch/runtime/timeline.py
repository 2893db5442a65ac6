"""The timeline: time-bucketed telemetry history and state-transition
events (copy of ``pyruhvro_tpu/runtime/timeline.py``, whole).

Every other exporter is cumulative (counters since start, gauges now,
histograms over the process's life). This module binds them to a clock:

* **Aggregation ring.** A daemon thread, started at the import of
  :mod:`.telemetry`, snapshots the registry every
  ``PYRUHVRO_TPU_TIMELINE_INTERVAL_S`` seconds (default 10) and keeps
  the last ``PYRUHVRO_TPU_TIMELINE_RETENTION`` intervals (default 360,
  an hour) as per-interval counter **deltas**, gauge values, and
  per-interval histogram bucket deltas with p50/p95/p99 computed from
  the interval's own distribution (:func:`tick_now`).
* **Event stream.** The state changes the port counts publish a
  timestamped event through :func:`event`: ``breaker.opened`` /
  ``.half_open`` / ``.closed``, ``drift.detected``,
  ``quarantine.storm``, ``device.recompile_storm``, ``slo.breach`` /
  ``slo.recovered`` and ``audit.mismatch``. A ``severity="incident"``
  event also queues an incident bundle (:mod:`.incident`), which the
  tick thread writes: never on the call's path, never from a signal
  handler.

Every tick and event carries a paired ``ts`` (epoch) and ``mono``
(``perf_counter``) stamp, as the flight records do.

``PYRUHVRO_TPU_NO_TIMELINE=1`` stops ticks, events and the automatic
bundles (``incident.capture_now()`` still writes one). Cost when on: a
lock and a list append per state change (not per call), and one
registry copy per interval on the tick thread. A tick that fails is
counted (``timeline.tick_error``) and the thread goes on, as in the
reference: it observes calls whose results are already complete.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import knobs, metrics, schedtest

__all__ = [
    "SEVERITIES",
    "event",
    "tick_now",
    "ensure_started",
    "snapshot_timeline",
    "render_timeline",
    "enabled",
    "interval_s",
    "retention",
    "reset",
]

SEVERITIES = ("info", "warn", "incident")

# event-ring capacity: bounded so an event storm cannot grow memory
# without bound; a module constant, not a knob — the drop counter
# (timeline.events reported minus events retained) makes truncation
# visible
EVENT_RING = 512

_lock = threading.Lock()
_ticks: List[Dict[str, Any]] = []  # guarded-by: _lock
_events: List[Dict[str, Any]] = []  # guarded-by: _lock
_events_seen = 0  # guarded-by: _lock
_prev_counters: Dict[str, float] = {}  # guarded-by: _lock
# per-key non-cumulative bucket counts + (count, sum) at the last tick
_prev_hists: Dict[str, Tuple[Dict[Any, int], int, float]] = {}  # guarded-by: _lock
_last_tick_mono = time.perf_counter()  # guarded-by: _lock
_thread: Optional[threading.Thread] = None  # guarded-by: _lock
# lock-free-ok(threading.Event is internally synchronized)
_wake = threading.Event()


def enabled() -> bool:
    """The plane's kill switch (``PYRUHVRO_TPU_NO_TIMELINE``)."""
    return not knobs.get_bool("PYRUHVRO_TPU_NO_TIMELINE")


def interval_s() -> float:
    """Tick interval (``PYRUHVRO_TPU_TIMELINE_INTERVAL_S``, default 10
    s), floored at 50 ms so a typo cannot spin the tick thread."""
    v = knobs.get_float("PYRUHVRO_TPU_TIMELINE_INTERVAL_S")
    return max(0.05, v if v is not None else 10.0)


def retention() -> int:
    """Retained intervals (``PYRUHVRO_TPU_TIMELINE_RETENTION``,
    default 360 — one hour at the default interval)."""
    return max(1, knobs.get_int("PYRUHVRO_TPU_TIMELINE_RETENTION"))


# ---------------------------------------------------------------------------
# the event stream
# ---------------------------------------------------------------------------


def event(name: str, severity: str = "info",
          attrs: Optional[Dict[str, Any]] = None,
          trace_id: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Publish one structured state-transition event onto the timeline.

    Lock-light by contract — callers sit inside state machines (the
    breaker fires this under its own lock): one ring append under the
    timeline lock, one counter increment after releasing it. Unknown
    severities degrade to ``info`` rather than raising — an event hook
    must never fail the transition it observes. ``severity="incident"``
    additionally requests an incident-bundle capture, performed by the
    tick thread off the hot path."""
    if not enabled():
        return None
    if severity not in SEVERITIES:
        severity = "info"
    rec: Dict[str, Any] = {
        "ts": round(time.time(), 6),
        "mono": time.perf_counter(),
        "name": str(name),
        "severity": severity,
    }
    if attrs:
        rec["attrs"] = dict(attrs)
    if trace_id is None:
        from . import traceprop

        ctx = traceprop.current()
        if ctx is not None:
            trace_id = ctx.trace_id
    if trace_id is not None:
        rec["trace_id"] = trace_id
    global _events_seen
    with _lock:
        _events_seen += 1
        _events.append(rec)
        if len(_events) > EVENT_RING:
            del _events[: len(_events) - EVENT_RING]
    metrics.inc("timeline.events")
    if severity == "incident":
        from . import incident

        incident.request(str(name), attrs)
        _wake.set()
    return rec


# ---------------------------------------------------------------------------
# the aggregation ring
# ---------------------------------------------------------------------------


def _bucket_counts(summary: Dict[str, Any]) -> Dict[Any, int]:
    """De-cumulate one histogram summary (cumulative ``[le, n]`` pairs)
    into per-bucket counts keyed by upper bound."""
    counts: Dict[Any, int] = {}
    prev = 0
    for le, cum in summary.get("buckets") or []:
        key = "+Inf" if le == "+Inf" else float(le)
        counts[key] = counts.get(key, 0) + int(cum) - prev
        prev = int(cum)
    return counts


def _quantile(ordered: List[Tuple[Any, int]], n: int, q: float) -> float:
    """Prometheus-style upper-bound quantile over non-cumulative bucket
    counts (ascending, ``+Inf`` last)."""
    if not n:
        return 0.0
    target = q * n
    cum = 0
    for le, c in ordered:
        cum += c
        if c and cum >= target:
            return float("inf") if le == "+Inf" else float(le)
    return float("inf")


def _hist_delta(prev: Optional[Tuple[Dict[Any, int], int, float]],
                cur_counts: Dict[Any, int], cur_n: int,
                cur_sum: float) -> Optional[Dict[str, Any]]:
    """The per-interval histogram slice: bucket-count deltas against
    the previous tick with p50/p95/p99 recomputed from the interval's
    OWN distribution (the cumulative quantiles barely move once a
    histogram holds hours of samples — the per-interval ones are what
    show a latency shift)."""
    pc, pn, psum = prev if prev is not None else ({}, 0, 0.0)
    dn = cur_n - pn
    if dn <= 0:
        return None
    deltas: Dict[Any, int] = {}
    for le, c in cur_counts.items():
        d = c - pc.get(le, 0)
        if d > 0:
            deltas[le] = d
    ordered = sorted(deltas.items(),
                     key=lambda kv: (kv[0] == "+Inf",
                                     kv[0] if kv[0] != "+Inf" else 0.0))
    return {
        "count": dn,
        "sum": round(cur_sum - psum, 9),
        "p50": _quantile(ordered, dn, 0.50),
        "p95": _quantile(ordered, dn, 0.95),
        "p99": _quantile(ordered, dn, 0.99),
        # NON-cumulative [le, n] pairs, zero buckets elided (unlike the
        # cumulative pairs in snapshot histograms: a delta slice is a
        # distribution fragment, and fragments re-merge by addition)
        "buckets": [[le, c] for le, c in ordered],
    }


def tick_now() -> Optional[Dict[str, Any]]:
    """Perform ONE aggregation tick synchronously (the background
    thread's unit of work; also the deterministic entry for tests, the
    perf gate and ``/timeline?tick=1``). Returns the appended tick
    record, or None when the plane is disabled."""
    if not enabled():
        return None
    from . import telemetry

    # registry reads happen BEFORE taking the timeline lock: snapshot()
    # runs deferred-count flush hooks and takes the metrics lock
    counters = metrics.snapshot()
    gauges = metrics.gauges()
    hists = telemetry.hist_summaries()
    ts = time.time()
    mono = time.perf_counter()
    schedtest.yp("timeline.tick")
    global _prev_counters, _prev_hists, _last_tick_mono
    with _lock:
        deltas = {
            k: round(v - _prev_counters.get(k, 0.0), 9)
            for k, v in counters.items()
            if v != _prev_counters.get(k, 0.0)
        }
        hsec: Dict[str, Any] = {}
        cur_state: Dict[str, Tuple[Dict[Any, int], int, float]] = {}
        for k, h in hists.items():
            bc = _bucket_counts(h)
            n = int(h.get("count", 0))
            s = float(h.get("sum", 0.0))
            cur_state[k] = (bc, n, s)
            d = _hist_delta(_prev_hists.get(k), bc, n, s)
            if d is not None:
                hsec[k] = d
        dur = mono - _last_tick_mono
        rec: Dict[str, Any] = {
            "ts": round(ts, 6),
            "mono": mono,
            "dur_s": round(dur, 6) if _ticks or _prev_counters else None,
            "counters": deltas,
        }
        if gauges:
            rec["gauges"] = gauges
        if hsec:
            rec["histograms"] = hsec
        _prev_counters = dict(counters)
        _prev_hists = cur_state
        _last_tick_mono = mono
        _ticks.append(rec)
        keep = retention()
        if len(_ticks) > keep:
            del _ticks[: len(_ticks) - keep]
    metrics.inc("timeline.ticks")
    return rec


def _run() -> None:
    """The tick thread: sleep until the next interval boundary (or an
    incident wake), capture any pending incident bundle, tick. A broken
    tick is counted and the loop continues — the history plane must
    never take the process down."""
    while True:
        try:
            iv = interval_s()
            if not enabled():
                # kill switch flipped live: stay parked, re-check later
                if _wake.wait(timeout=max(1.0, iv)):
                    _wake.clear()
                continue
            with _lock:
                last = _last_tick_mono
            delay = last + iv - time.perf_counter()
            if delay > 0:
                if _wake.wait(timeout=delay):
                    # woken early: an incident wants prompt capture —
                    # the tick itself stays on its interval schedule
                    _wake.clear()
                    from . import incident

                    incident.maybe_capture()
                continue
            tick_now()
            from . import incident

            incident.maybe_capture()
        except Exception:  # noqa: BLE001 — the ticker must survive
            metrics.inc("timeline.tick_error")


def ensure_started() -> bool:
    """Start the background tick thread (idempotent; daemon). Called at
    :mod:`.telemetry` import so every process gets history without any
    code change; returns False when the kill switch is set."""
    global _thread
    if not enabled():
        return False
    with _lock:
        if _thread is not None and _thread.is_alive():
            return True
        _thread = threading.Thread(target=_run, name="pyruhvro-timeline",
                                   daemon=True)
        _thread.start()
    return True


# ---------------------------------------------------------------------------
# export / render
# ---------------------------------------------------------------------------


def snapshot_timeline() -> Dict[str, Any]:
    """The ``timeline`` section of ``telemetry.snapshot()`` — empty
    dict until the first tick or event, so snapshots stay
    shape-compatible with older consumers. ``now_ts``/``now_mono`` are
    captured at export: the fleet merge uses them to place every
    record on a common clock via drift-free monotonic ages."""
    iv = interval_s()
    keep = retention()
    with _lock:
        if not _ticks and not _events:
            return {}
        return {
            "interval_s": iv,
            "retention": keep,
            "now_ts": round(time.time(), 6),
            "now_mono": time.perf_counter(),
            "ticks": [dict(t) for t in _ticks],
            "events": [dict(e) for e in _events],
            "events_dropped": _events_seen - len(_events),
        }


def _fmt_ts(ts: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(ts)) + (
        "%.3f" % (ts % 1.0))[1:]


def _fmt_date(ts: float) -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))


def _fmt_attr_v(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _event_line(e: Dict[str, Any]) -> str:
    attrs = " ".join(f"{k}={_fmt_attr_v(v)}"
                     for k, v in sorted((e.get("attrs") or {}).items()))
    tag = f" @{e['replica']}" if e.get("replica") else ""
    line = (f"    {_fmt_ts(float(e.get('ts') or 0.0))} "
            f"[{e.get('severity', 'info'):<8}] {e.get('name')}{tag}")
    if attrs:
        line += "  " + attrs
    if e.get("trace_id"):
        line += f"  trace={e['trace_id'][:16]}"
    return line


def _tick_line(t: Dict[str, Any], top: int = 4) -> str:
    deltas = sorted(((k, float(v)) for k, v in
                     (t.get("counters") or {}).items()),
                    key=lambda kv: -abs(kv[1]))
    parts = [f"{k} {'+' if v >= 0 else ''}{v:.6g}"
             for k, v in deltas[:top]]
    more = len(deltas) - top
    if more > 0:
        parts.append(f"(+{more} more)")
    hs = t.get("histograms") or {}
    for k in sorted(hs):
        if k.endswith(".total_s") or k == "serve.e2e_s":
            h = hs[k]
            p95 = h.get("p95")
            p95s = "inf" if p95 == float("inf") else f"{p95 * 1e3:.3g}ms"
            parts.append(f"{k} p95<={p95s} n={h.get('count')}")
            break
    tag = f" @{t['replica']}" if t.get("replica") else ""
    body = "  ".join(parts) if parts else "(idle)"
    return f"{_fmt_ts(float(t.get('ts') or 0.0))}{tag}  {body}"


def render_timeline(doc: Dict[str, Any], top: int = 4) -> str:
    """Text rendering of a timeline: tick rows with their top counter
    deltas, events interleaved at their position in time. ``doc`` is a
    snapshot (``timeline`` section), an incident bundle, or a bare
    timeline section. Legacy snapshots degrade to a clear note."""
    sec = doc.get("timeline") if "timeline" in doc else (
        doc if ("ticks" in doc or "events" in doc) else None)
    if not isinstance(sec, dict) or not sec:
        return ("== timeline ==\nno timeline section: snapshot predates "
                "the timeline plane (or PYRUHVRO_TPU_NO_TIMELINE was "
                "set)\n")
    ticks = list(sec.get("ticks") or [])
    events = list(sec.get("events") or [])
    rows: List[Tuple[float, int, str]] = []
    for t in ticks:
        rows.append((float(t.get("ts") or 0.0), 0, _tick_line(t, top)))
    for e in events:
        rows.append((float(e.get("ts") or 0.0), 1, _event_line(e)))
    rows.sort(key=lambda r: (r[0], r[1]))
    dropped = int(sec.get("events_dropped") or 0)
    head = (f"== timeline (interval {sec.get('interval_s')}s, "
            f"{len(ticks)} tick(s), {len(events)} event(s)"
            + (f", {dropped} dropped" if dropped else "")
            + (", fleet" if sec.get("fleet") else "") + ") ==")
    out = [head]
    if rows:
        out.append(f"-- from {_fmt_date(rows[0][0])} to "
                   f"{_fmt_date(rows[-1][0])} --")
    out += [r[2] for r in rows]
    if not rows:
        out.append("(empty)")
    return "\n".join(out) + "\n"


def reset() -> None:
    """Clear rings and delta baselines and RE-ARM the tick clock (test
    isolation: the next background tick is a full interval away). The
    thread itself survives — it is process state, like the obs
    server."""
    global _events_seen, _prev_counters, _prev_hists, _last_tick_mono
    with _lock:
        _ticks.clear()
        _events.clear()
        _events_seen = 0
        _prev_counters = {}
        _prev_hists = {}
        _last_tick_mono = time.perf_counter()
    _wake.clear()
