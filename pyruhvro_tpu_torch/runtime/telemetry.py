"""Per-call span telemetry: where a call went and where its time went
(the core of ``pyruhvro_tpu/runtime/telemetry.py``: ``_Hist``, ``Span``,
``attach``, ``root_span``, ``phase``, ``observe``, ``observe_value``,
``annotate``, ``annotate_root``, ``set_route``, ``worker_scope``,
``merge_worker``, ``set_span_sink``, ``hist_summaries``,
``set_enabled``/``enabled``, ``reset``, ``snapshot``, ``prometheus``,
``perfetto_trace``, the ``PYRUHVRO_TPU_TRACE`` JSON-lines sink, the
flight recorder (``flight_dump``, ``install_flight_signal``, the
auto-dumps and their rotation), the import-time start of the obs server,
the timeline's tick thread and the OTLP exporter, the ``rings`` memory
probe, ``render_report`` and ``main``).

Layered on the flat counters of :mod:`.metrics`, which stay the
always-on base: each public API call opens a **root span** carrying the
schema fingerprint, the backend asked for, the row count and the tier
it was routed to; the phase boundaries (``decode.pack_s``,
``decode.h2d_s``, each device launch, ``decode.d2h_s``, ``host.vm_s``,
the pool's chunks) are its **child spans**. One lock per event, on the
host. ``set_enabled(False)`` (or ``PYRUHVRO_TPU_NO_TELEMETRY=1``) drops
spans and histograms and keeps the counters.

Exporters: :func:`snapshot` (counters, fixed-bucket latency histograms
with p50/p95/p99, the last root span trees, and a ``device`` section of
launch registry and memory watermarks from :mod:`.device_obs`, the
``routing``, ``breakers``, ``drift``, ``slo``, ``sampling``, ``audit``,
``memory`` and ``timeline`` sections of :mod:`.router`, :mod:`.breaker`,
:mod:`.drift`, :mod:`.slo`, :mod:`.sampling`, :mod:`.audit`,
:mod:`.memacct` and :mod:`.timeline`, the ``mem.*`` gauges, and the
flight recorder's ``flight_records``), :func:`prometheus` (text
exposition), :func:`perfetto_trace` (Chrome trace-event JSON), and
``PYRUHVRO_TPU_TRACE=<path or stderr>``, one JSON line per finished root
span. ``python -m pyruhvro_tpu_torch.telemetry report|prom|perfetto|
route-report|what-if|slo-report|audit-report|mem-report|timeline|
incident-report <file>`` renders a saved snapshot (or an incident
bundle), ``serve <file>`` serves it over HTTP, ``fleet`` merges
replicas' snapshots (:mod:`.fleet`), ``diff <a> <b>`` attributes the
change between two, and ``knobs`` lists the environment knobs; a file
that is missing or not a snapshot exits 2.

**The flight recorder** keeps the last ``PYRUHVRO_TPU_FLIGHT_N`` root
spans (default 64; read again by :func:`reset`) and makes each a compact
record when it is read: name, duration, attributes, per-phase time
totals (the device launches' spans among them) and the trace id.
:func:`flight_dump` returns them or writes them atomically, through the
``flight_dump`` fault seam. With
``PYRUHVRO_TPU_FLIGHT_DIR`` set, an errored root span, an SLO breach and
the quarantine, recompile and drift storms auto-dump into that
directory as ``flight_<pid>_<seq>_<tag>.json``, at most one a second,
keeping the newest ``PYRUHVRO_TPU_FLIGHT_MAX_FILES`` such files (default
32, 0 = no limit; other files are never touched); a failed dump counts
``flight.dump_error`` and never fails the call. The same variable arms
SIGUSR1 (a dump) at import; it and ``PYRUHVRO_TPU_OBS_PORT`` arm
SIGUSR2 (deep sampling on or off, :func:`.sampling.install_toggle_signal`).

At import, ``PYRUHVRO_TPU_OBS_PORT`` starts the obs server
(:func:`.obs_server.start_from_env`), the timeline's tick thread
starts (:func:`.timeline.ensure_started`; ``PYRUHVRO_TPU_NO_TIMELINE=1``
keeps it parked) and ``PYRUHVRO_TPU_OTLP_ENDPOINT`` starts the OTLP
exporter (:func:`.otel.start_from_env`, which takes the span sink).

Every finished root span feeds the SLO engine (:func:`.slo.record_root`)
with its seconds less an audit shadow's
(:func:`.audit.consume_shadow_seconds`) and corrected for the deep
sampler's tax (:func:`.sampling.consume_last_correction`).

Keys are ``component.event``; keys ending ``_s`` are seconds and get
histograms, every other key is a count or a byte counter.

Departures from the reference (``ROADMAP.md`` (c)): nothing here catches
an exception. A phase or root span records the error's type on its span
and re-raises it; a span sink or a trace file that fails raises into the
call, where the reference counts the failure and goes on (the OTLP
exporter's sink only appends to its queue, and its failed POSTs are
counted behind its breaker on its own thread, as in the reference). The
device launches' spans are opened at launch and closed when their CUDA
events are read (:mod:`.device_obs`), at the latest when the root span
exits.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Any, Dict, List, Optional

from . import knobs, memacct, metrics, slo, traceprop

__all__ = [
    "SNAPSHOT_SCHEMA_VERSION",
    "Span",
    "root_span",
    "phase",
    "observe",
    "observe_value",
    "current_span",
    "attach",
    "annotate",
    "annotate_root",
    "set_route",
    "snapshot",
    "prometheus",
    "perfetto_trace",
    "reset",
    "set_enabled",
    "enabled",
    "render_report",
    "main",
    "worker_scope",
    "merge_worker",
    "set_span_sink",
    "hist_summaries",
    "flight_dump",
    "install_flight_signal",
]

# fixed log-spaced latency buckets, 1 µs … 500 s (~3/decade); +Inf is
# implicit
_BUCKET_BOUNDS: tuple = tuple(
    m * (10.0 ** e) for e in range(-6, 3) for m in (1.0, 2.5, 5.0)
)

_MAX_SPANS = 64  # root spans retained for snapshot(); older ones are counted

# the reference's snapshot shape version 3, without the section of the
# plane the port does not have yet: serving (ROADMAP.md (a) 8.9)
SNAPSHOT_SCHEMA_VERSION = 3


def _flight_n() -> int:
    """The flight ring's size in root spans (``PYRUHVRO_TPU_FLIGHT_N``,
    read at import and by :func:`reset`)."""
    return max(1, knobs.get_int("PYRUHVRO_TPU_FLIGHT_N"))


_lock = threading.Lock()
_hists: Dict[str, "_Hist"] = {}  # guarded-by: _lock
_spans: deque = deque(maxlen=_MAX_SPANS)  # guarded-by: _lock
# flight recorder: the last N finished root spans, kept even after they
# age out of the snapshot ring, and made compact records when read (the
# reference builds each record at the span's exit)
_flight: deque = deque(maxlen=_flight_n())  # guarded-by: _lock
_roots_seen = 0  # guarded-by: _lock
# lock-free-ok(single GIL-atomic bool store; readers tolerate staleness)
_enabled = not knobs.get_bool("PYRUHVRO_TPU_NO_TELEMETRY")
_tls = threading.local()


class _Hist:
    """Fixed-bucket latency histogram (counts per bucket + sum), with one
    exemplar: the trace id of the largest traced observation."""

    __slots__ = ("counts", "n", "sum", "ex_value", "ex_trace")

    def __init__(self):
        self.counts = [0] * (len(_BUCKET_BOUNDS) + 1)
        self.n = 0
        self.sum = 0.0
        self.ex_value = 0.0
        self.ex_trace: Optional[str] = None

    def observe(self, v: float, trace_id: Optional[str] = None) -> None:
        self.counts[bisect_left(_BUCKET_BOUNDS, v)] += 1
        self.n += 1
        self.sum += v
        if trace_id is not None and (self.ex_trace is None
                                     or v > self.ex_value):
            self.ex_value = v
            self.ex_trace = trace_id

    def quantile(self, q: float) -> float:
        """Upper bucket bound holding the q-quantile (Prometheus-style)."""
        if not self.n:
            return 0.0
        target = q * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if c and cum >= target:
                return (_BUCKET_BOUNDS[i] if i < len(_BUCKET_BOUNDS)
                        else float("inf"))
        return float("inf")

    def summary(self) -> Dict[str, Any]:
        buckets: List[list] = []
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if c:
                le = (_BUCKET_BOUNDS[i] if i < len(_BUCKET_BOUNDS)
                      else "+Inf")
                buckets.append([le, cum])
        if not buckets or buckets[-1][0] != "+Inf":
            buckets.append(["+Inf", cum])
        out = {
            "count": self.n,
            "sum": self.sum,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "buckets": buckets,  # cumulative [le, n], zero buckets elided
        }
        if self.ex_trace is not None:
            out["exemplar"] = {"value": self.ex_value,
                               "trace_id": self.ex_trace}
        return out


def _hist_locked(key: str) -> _Hist:
    """Get-or-create; callers hold ``_lock``."""
    h = _hists.get(key)
    if h is None:
        h = _hists[key] = _Hist()
    return h


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Span:
    """One timed node of a call tree (root = public API call). Roots carry
    the W3C trace identity (:mod:`.traceprop`): a 128-bit ``trace_id``,
    their own 64-bit ``span_id`` and, when the call joined a trace, the
    caller's ``parent_span_id``."""

    __slots__ = ("name", "attrs", "children", "dur_s", "ts", "_t0",
                 "parent", "trace_id", "span_id", "parent_span_id")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.children: List[Span] = []
        self.dur_s: Optional[float] = None
        self.ts = time.time()
        self._t0 = time.perf_counter()
        # up-link for annotate_root (not serialized; to_dict walks down)
        self.parent: Optional["Span"] = None
        self.trace_id: Optional[str] = None
        self.span_id: Optional[str] = None
        self.parent_span_id: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "ts": round(self.ts, 6),
            "dur_s": self.dur_s,
            "attrs": dict(self.attrs),
        }
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
            d["span_id"] = self.span_id
            if self.parent_span_id is not None:
                d["parent_span_id"] = self.parent_span_id
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


def current_span() -> Optional[Span]:
    """The innermost open span on THIS thread (None outside API calls)."""
    return getattr(_tls, "span", None)


class attach:
    """Adopt ``span`` as the current span on this thread, with its root's
    trace context: the pool's worker threads parent their chunk spans
    under the calling thread's span this way."""

    __slots__ = ("span", "_prev", "_tp")

    def __init__(self, span: Optional[Span]):
        self.span = span

    def __enter__(self):
        self._prev = getattr(_tls, "span", None)
        _tls.span = self.span
        root = self.span
        while root is not None and root.parent is not None:
            root = root.parent
        ctx = None
        if root is not None and root.trace_id is not None:
            ctx = traceprop.TraceContext(root.trace_id, root.span_id)
        self._tp = traceprop.activate(ctx)
        self._tp.__enter__()
        return self.span

    def __exit__(self, *exc):
        self._tp.__exit__(*exc)
        _tls.span = self._prev
        return False


class root_span:
    """Open the per-call root span (one per public API entry).

    Disabled mode is a no-op (the flat counters still flow). A root opened
    while another is active on the thread attaches as a child of the
    outer one and is not separately retained. The root joins the context
    resolved from ``trace_ctx=`` > thread-local >
    ``PYRUHVRO_TPU_TRACEPARENT``, minting a fresh 128-bit trace id when
    there is none, and pushes its own context thread-local while open.
    On the outermost root's exit the device launches still pending are
    read (:func:`.device_obs.flush`), the span joins the flight
    recorder and the SLO engine is fed; an errored root span
    auto-dumps the flight recorder. An exception is recorded on the
    span (``error``) and propagates."""

    __slots__ = ("span", "_prev", "_trace_ctx", "_tp")

    def __init__(self, name: str, trace_ctx=None, **attrs):
        self.span = Span(name, attrs) if _enabled else None
        self._trace_ctx = trace_ctx

    def __enter__(self):
        s = self.span
        if s is None:
            return None
        self._prev = getattr(_tls, "span", None)
        if self._prev is not None:
            with _lock:
                self._prev.children.append(s)
            s.parent = self._prev
        ctx = traceprop.resolve(self._trace_ctx)
        s.span_id = traceprop.new_span_id()
        if ctx is not None:
            s.trace_id = ctx.trace_id
            s.parent_span_id = ctx.span_id
        else:
            s.trace_id = traceprop.new_trace_id()
        self._tp = traceprop.activate(
            traceprop.TraceContext(s.trace_id, s.span_id))
        self._tp.__enter__()
        _tls.span = s
        return s

    def __exit__(self, exc_type, exc, tb):
        s = self.span
        if s is None:
            return False
        if self._prev is None:
            from . import device_obs

            device_obs.flush()
        s.dur_s = round(time.perf_counter() - s._t0, 9)
        if exc_type is not None:
            s.attrs["error"] = exc_type.__name__
        _tls.span = self._prev
        self._tp.__exit__(exc_type, exc, tb)
        metrics.inc(s.name + "_s", s.dur_s)
        global _roots_seen
        with _lock:
            _hist_locked(s.name + "_s").observe(s.dur_s, s.trace_id)
            if self._prev is None:
                _spans.append(s)
                _flight.append(s)
                _roots_seen += 1
        if self._prev is None:
            sink = _span_sink
            if sink is not None:
                sink(s)
            _maybe_trace(s)
            # every finished API call is one good/bad/errored event for
            # the matching SLO objectives; a deep-sampled call feeds its
            # comparable cost, so the sampler's tax trips no breach, and
            # an audit shadow that ran inside this root is the audit's
            # time, not the caller's: subtracted (destructive consume)
            # before the sampler's correction
            from . import audit as _audit
            from . import sampling as _sampling

            slo.record_root(
                s.name, s.attrs.get("schema"),
                _sampling.consume_last_correction(
                    max(0.0, s.dur_s - _audit.consume_shadow_seconds())),
                exc_type is not None)
            if exc_type is not None:
                # a failed decode/encode leaves a replayable artifact
                # when PYRUHVRO_TPU_FLIGHT_DIR points somewhere
                _flight_autodump("error")
        return False


class phase:
    """``with phase("decode.pack_s"): ...`` — the span-aware timer.

    Always adds the elapsed seconds to the flat counter; when telemetry is
    enabled it also observes the latency histogram and, under an open
    root span, attaches a child span. ``dt`` holds the elapsed seconds
    after exit, so a caller keeps one measurement in two views."""

    __slots__ = ("key", "attrs", "span", "_t0", "_prev", "dt")

    def __init__(self, key: str, **attrs):
        self.key = key
        self.attrs = attrs
        self.span = None
        self.dt = 0.0

    def __enter__(self):
        if _enabled:
            parent = getattr(_tls, "span", None)
            if parent is not None:
                self.span = Span(self.key, self.attrs)
                with _lock:
                    parent.children.append(self.span)
                self.span.parent = parent
                self._prev = parent
                _tls.span = self.span
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = self.dt = time.perf_counter() - self._t0
        metrics.inc(self.key, dt)
        if self.span is not None:
            self.span.dur_s = round(dt, 9)
            if exc_type is not None:
                self.span.attrs["error"] = exc_type.__name__
            _tls.span = self._prev
        if _enabled:
            ctx = traceprop.current()
            with _lock:
                _hist_locked(self.key).observe(
                    dt, ctx.trace_id if ctx else None)
        return False


def observe(key: str, seconds: float, **attrs) -> None:
    """Record a pre-measured duration: counter + histogram + child span."""
    metrics.inc(key, seconds)
    if not _enabled:
        return
    parent = getattr(_tls, "span", None)
    ctx = traceprop.current()
    with _lock:
        _hist_locked(key).observe(seconds, ctx.trace_id if ctx else None)
        if parent is not None:
            s = Span(key, attrs)
            # the interval ENDED at creation: shift ts back so the span's
            # [ts, ts+dur_s] window is the real one in trace timelines
            s.ts -= seconds
            s.dur_s = round(seconds, 9)
            parent.children.append(s)


def open_span(key: str, **attrs) -> Optional[Span]:
    """A child span of the current one whose duration is not known yet
    (a device launch, timed by events read later); None when disabled or
    outside a span. :func:`close_span` completes it."""
    if not _enabled:
        return None
    parent = getattr(_tls, "span", None)
    if parent is None:
        return None
    s = Span(key, attrs)
    s.parent = parent
    with _lock:
        parent.children.append(s)
    return s


def close_span(span: Optional[Span], key: str, seconds: float,
               trace_id: Optional[str] = None) -> None:
    """Complete a launch measured after the fact: counter, histogram and
    (when :func:`open_span` made one) the span's duration."""
    metrics.inc(key, seconds)
    if not _enabled:
        return
    with _lock:
        _hist_locked(key).observe(seconds, trace_id)
        if span is not None:
            span.dur_s = round(seconds, 9)


def observe_value(key: str, value: float) -> None:
    """Counter + histogram for a dimensionless value (a ratio such as
    ``pool.chunk_efficiency``): no child span."""
    metrics.inc(key, value)
    if not _enabled:
        return
    with _lock:
        _hist_locked(key).observe(value)


def annotate(**attrs) -> None:
    """Merge attributes into the current span (no-op outside a span)."""
    s = getattr(_tls, "span", None)
    if s is not None:
        s.attrs.update(attrs)


def annotate_root(**attrs) -> None:
    """Merge attributes into the ROOT of the current span tree (no-op
    outside a span)."""
    s = getattr(_tls, "span", None)
    if s is None:
        return
    while s.parent is not None:
        s = s.parent
    s.attrs.update(attrs)


def set_route(tier: str, reason: Optional[str] = None) -> None:
    """Record where THIS call was routed (device/native/fallback) and why:
    on the root span and as flat ``route.*`` counters."""
    metrics.inc("route." + tier)
    if reason:
        metrics.inc("route.reason." + reason)
    s = getattr(_tls, "span", None)
    if s is not None:
        s.attrs["route"] = tier
        if reason:
            s.attrs["route_reason"] = reason


# ---------------------------------------------------------------------------
# flight recorder (the reference's telemetry.py:490-697)
# ---------------------------------------------------------------------------
#
# A ring of the last N finished root spans, reduced to compact records
# (schema fingerprint, routing verdict, per-phase time totals), dumpable
# as JSON when something goes wrong: on any decode/encode error, an SLO
# breach or a storm (when PYRUHVRO_TPU_FLIGHT_DIR names a directory), on
# SIGUSR1 (same gate), or explicitly via flight_dump().

# lock-free-ok(mutated from signal context where locks deadlock; a racing
# pair costs at worst one extra dump / a reused dump filename)
_flight_seq = 0
_flight_last_auto = 0.0  # lock-free-ok(see _flight_seq above)
_flight_signal_installed = False  # lock-free-ok(idempotent install flag)


def _flight_record(s: Span) -> Dict[str, Any]:
    phases: Dict[str, float] = {}

    def walk(node: Span) -> None:
        for c in node.children:
            if c.dur_s is not None:
                phases[c.name] = round(
                    phases.get(c.name, 0.0) + c.dur_s, 9)
            walk(c)

    walk(s)
    rec = {
        "ts": round(s.ts, 6),
        # paired monotonic clock (perf_counter at span open): epoch ts
        # alone cannot time-align dumps across replicas whose wall
        # clocks drift
        "mono": round(s._t0, 6),
        "name": s.name,
        "dur_s": s.dur_s,
        "attrs": dict(s.attrs),
        "phases": phases,
    }
    if s.trace_id is not None:
        rec["trace_id"] = s.trace_id
    return rec


def _flight_records(blocking: bool = True) -> List[Dict[str, Any]]:
    """Copy the ring. ``blocking=False`` is the signal-handler path: the
    handler runs on the main thread at a bytecode boundary, possibly
    INSIDE a ``with _lock:`` region of the very frame it interrupted —
    blocking there would deadlock on the non-reentrant lock, so fall
    back to a best-effort unlocked copy (the interrupted mutator is
    paused; a concurrent thread's append at worst raises the RuntimeError
    swallowed here)."""
    if _lock.acquire(blocking=blocking):
        try:
            roots = list(_flight)
        finally:
            _lock.release()
    else:
        try:
            roots = list(_flight)
        except RuntimeError:
            return []
    return [_flight_record(s) for s in roots]


def flight_dump(path: Optional[str] = None, *, blocking: bool = True):
    """The flight-recorder contents: as a dict (``path=None``) or
    written to ``path`` as JSON (returns the path), through the
    ``flight_dump`` fault seam. File writes are atomic (tmp + rename,
    :mod:`.fsio`): a process killed mid-dump never leaves a truncated
    artifact."""
    from . import faults, fsio

    records = _flight_records(blocking)
    doc = {
        "pid": os.getpid(),
        "time": round(time.time(), 3),
        "records": records,
    }
    if path is None:
        return doc
    if blocking:
        # signal-ok: gated to the non-signal path — fire() takes the
        # metrics/faults locks, which the interrupted frame may hold
        faults.fire("flight_dump")
    return fsio.atomic_write_json(path, doc)


def _flight_max_files() -> int:
    """Auto-dump retention cap (``PYRUHVRO_TPU_FLIGHT_MAX_FILES``,
    default 32, 0 = unlimited): sustained storms must not grow the dump
    directory without bound."""
    return max(0, knobs.get_int("PYRUHVRO_TPU_FLIGHT_MAX_FILES"))


# rotation deletions / dump errors observed from SIGNAL context defer
# their count (metrics._lock is not reentrant and the handler may have
# interrupted a frame inside it); flushed on the next normal-path pass
_flight_dropped = metrics.DeferredCount("flight.dump_dropped")
_flight_dump_errors = metrics.DeferredCount("flight.dump_error")


def _rotate_flight_dir(d: str, keep: int, counters: bool = True) -> int:
    """Delete the oldest ``flight_*.json`` dumps past ``keep`` files;
    each deletion counts ``flight.dump_dropped``. Only auto-dump-shaped
    names are touched — operator-written files are never rotated.
    ``counters=False`` is the signal-handler path: deletions are
    deferred to the ``_flight_dropped`` tally instead of taking the
    metrics lock (which the interrupted frame may hold). Returns the
    number dropped; never raises (best-effort cleanup)."""
    if counters:
        # flush BEFORE the early returns below: deletions deferred from
        # signal context must not wait for the next over-limit rotation
        _flight_dropped.flush()
    if keep <= 0:
        return 0
    try:
        # only the exact auto-dump shape flight_<pid>_<seq>_<tag>.json:
        # an operator's hand-saved flight_incident.json must survive
        files = [
            os.path.join(d, f) for f in os.listdir(d)
            if re.fullmatch(r"flight_\d+_\d+_\w+\.json", f)
        ]
    except OSError:
        return 0
    if len(files) <= keep:
        return 0

    def mtime(p: str) -> float:
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0

    files.sort(key=mtime)
    dropped = 0
    for p in files[: len(files) - keep]:
        try:
            os.remove(p)
            dropped += 1
        except OSError:
            continue
    if dropped:
        _flight_dropped.bump(dropped)  # signal-safe: increment only
        if counters:
            _flight_dropped.flush()
    return dropped


def _flight_autodump(tag: str, blocking: bool = True) -> Optional[str]:
    """Write a flight dump into PYRUHVRO_TPU_FLIGHT_DIR (no-op when
    unset); rate-limited to one per second so an error storm cannot
    flood the disk, rotated to PYRUHVRO_TPU_FLIGHT_MAX_FILES retained
    dumps so a long-running storm cannot fill it either, and never
    allowed to fail the call it observes. ``blocking=False`` from
    signal context (see _flight_records)."""
    global _flight_seq, _flight_last_auto
    d = knobs.get_str("PYRUHVRO_TPU_FLIGHT_DIR")
    if not d:
        return None
    now = time.monotonic()
    if now - _flight_last_auto < 1.0:
        return None
    _flight_last_auto = now
    _flight_seq += 1
    path = os.path.join(d, f"flight_{os.getpid()}_{_flight_seq}_{tag}.json")
    from .faults import FaultInjected

    try:
        out = flight_dump(path, blocking=blocking)
    except (OSError, ValueError, FaultInjected):
        # a failed dump (incl. injected chaos) must never fail the call
        # it observes; the count defers (signal-safe) and flushes
        # immediately on the normal path
        _flight_dump_errors.bump()
        if blocking:
            _flight_dump_errors.flush()
        return None
    _rotate_flight_dir(d, _flight_max_files(), counters=blocking)
    return out


def install_flight_signal() -> bool:
    """Register a SIGUSR1 handler that dumps the flight recorder into
    PYRUHVRO_TPU_FLIGHT_DIR. Safe to call repeatedly; returns False
    when unavailable (non-main thread, platform without SIGUSR1). The
    previous handler is chained, not replaced."""
    global _flight_signal_installed
    if _flight_signal_installed:
        return True
    import signal

    if not hasattr(signal, "SIGUSR1"):
        return False

    prev = signal.getsignal(signal.SIGUSR1)

    def handler(signum, frame):
        _flight_autodump("sigusr1", blocking=False)
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    try:
        signal.signal(signal.SIGUSR1, handler)
    except ValueError:  # not the main thread
        return False
    _flight_signal_installed = True
    return True


# operators who configure a dump directory get the SIGUSR1 dump without
# any code change; everyone else pays nothing (no handler installed).
# SIGUSR2 (toggle deep sampling live) rides the same opt-in, plus the
# obs server's: both are incident-time controls.
if (knobs.get_str("PYRUHVRO_TPU_FLIGHT_DIR")
        or knobs.get_raw("PYRUHVRO_TPU_OBS_PORT")):
    if knobs.get_str("PYRUHVRO_TPU_FLIGHT_DIR"):
        install_flight_signal()
    from . import sampling as _sampling

    _sampling.install_toggle_signal()

# the live obs server: opt-in through PYRUHVRO_TPU_OBS_PORT, started once
# at import so a service gets /metrics and /healthz without a code change
if knobs.get_raw("PYRUHVRO_TPU_OBS_PORT"):
    from . import obs_server as _obs_server

    _obs_server.start_from_env()

# the timeline's tick thread is on by default (one registry copy per 10 s
# interval), so every process keeps a history without a code change;
# PYRUHVRO_TPU_NO_TIMELINE keeps it parked
from . import timeline as _timeline  # noqa: E402

_timeline.ensure_started()


# the span and flight rings are long-lived state too: the memory
# accounting counts them at a stated estimate a record (both rings are
# bounded)
def _ring_probe():
    with _lock:
        n = len(_spans) + len(_flight)
    return {"bytes": float(n * memacct.RING_RECORD_EST_BYTES),
            "items": float(n)}


memacct.register_probe("rings", _ring_probe)


# ---------------------------------------------------------------------------
# cross-process worker telemetry
# ---------------------------------------------------------------------------


class worker_scope:
    """Capture one pool or process worker's telemetry for the parent::

        with telemetry.worker_scope("pool.worker", rows=n) as w:
            result = do_chunk()
        return result, w.payload

    Inside the scope a ``pool.worker`` root span times the work and every
    counter increment is also recorded as a delta. On exit ``payload`` is
    a picklable dict (counter deltas and the span tree) that the parent
    folds back with :func:`merge_worker`; the cost-model observations the
    worker's own API calls made ride along (``routing``)."""

    __slots__ = ("name", "attrs", "payload", "_rec", "_delta", "_root",
                 "_robs", "_trace_ctx")

    def __init__(self, name: str = "pool.worker", trace_ctx=None, **attrs):
        self.name = name
        self.attrs = attrs
        self.payload: Optional[Dict[str, Any]] = None
        # the caller's shipped trace context: the worker's root joins it
        self._trace_ctx = trace_ctx

    def __enter__(self) -> "worker_scope":
        from . import costmodel

        self._rec = metrics.record_deltas()
        self._delta = self._rec.__enter__()
        self._robs = costmodel.record_observations()
        self._robs.__enter__()
        self._root = root_span(self.name, trace_ctx=self._trace_ctx,
                               pid=os.getpid(), **self.attrs)
        self._root.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._root.__exit__(exc_type, exc, tb)
        self._robs.__exit__(exc_type, exc, tb)
        self._rec.__exit__(exc_type, exc, tb)
        span = self._root.span
        self.payload = {
            "pid": os.getpid(),
            "rows": self.attrs.get("rows"),
            "counters": dict(self._delta),
            "span": span.to_dict() if span is not None else None,
        }
        if self._robs.obs:
            self.payload["routing"] = list(self._robs.obs)
        return False


def _span_from_dict(d: Dict[str, Any]) -> Span:
    s = Span(d.get("name", "?"), dict(d.get("attrs") or {}))
    ts = d.get("ts")
    if ts is not None:
        s.ts = ts
    s.dur_s = d.get("dur_s")
    s.trace_id = d.get("trace_id")
    s.span_id = d.get("span_id")
    s.parent_span_id = d.get("parent_span_id")
    s.children = [_span_from_dict(c) for c in d.get("children") or []]
    return s


def merge_worker(payload: Dict[str, Any], *, counters: bool = True) -> None:
    """Fold a worker's exported telemetry into THIS process.

    ``counters=True`` (process workers): the delta dict adds into the flat
    counters; ``counters=False`` for same-process thread workers whose
    increments already landed. The worker's span tree re-parents under
    the caller's current open span, ``pool.worker_rows`` adds the worker's
    rows and ``pool.worker_merges`` counts the merge. Quarantine entries
    shipped with the payload go to the caller's collector
    (``quarantine.extend_current``), routing observations to the cost
    model (``costmodel.merge_observations``)."""
    if not payload:
        return
    if counters:
        metrics.merge(payload.get("counters") or {})
        rows = payload.get("rows")
        if rows:
            metrics.inc("pool.worker_rows", float(rows))
    metrics.inc("pool.worker_merges")
    q = payload.get("quarantine")
    if q:
        from . import quarantine

        quarantine.extend_current(q)
    robs = payload.get("routing")
    if robs:
        from . import costmodel

        costmodel.merge_observations(robs)
    sd = payload.get("span")
    if sd and _enabled:
        parent = getattr(_tls, "span", None)
        if parent is not None:
            s = _span_from_dict(sd)
            with _lock:
                parent.children.append(s)


# the finished-root-span hook: one callable, invoked outside the lock
# lock-free-ok(single GIL-atomic store; readers tolerate staleness)
_span_sink = None


def set_span_sink(fn) -> None:
    """Register (or clear, with None) the finished-root-span hook. What it
    raises propagates into the call that finished."""
    global _span_sink
    _span_sink = fn


def hist_summaries() -> Dict[str, Any]:
    """Histogram summaries only."""
    with _lock:
        return {k: h.summary() for k, h in sorted(_hists.items())}


def set_enabled(flag: bool) -> None:
    """Toggle spans + histograms (flat counters always stay on)."""
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Clear spans, histograms, the flight recorder (and re-arm its
    auto-dump rate limit), the device registry, the router (ledger,
    cost model, capacity plans), the sampler, the SLO engine, the
    breakers, drift, the audit, the memory accounting (the tenant
    sketch, the tick throttle and the collect memo), the timeline (rings
    and baselines; its clock re-armed), the incident debounce AND the
    flat counters (test isolation); closes an open trace file. Unlike the reference's, it
    resets the breakers too, whose tests do that on their own; the
    fault injector's counters stay (``faults.reset()``), and the
    timeline's thread and the obs server keep running, as in the
    reference."""
    global _roots_seen, _trace_memo, _flight_last_auto, _flight
    with _lock:
        _hists.clear()
        _spans.clear()
        _flight = deque(maxlen=_flight_n())
        _roots_seen = 0
        _flight_last_auto = 0.0  # re-arm the auto-dump rate limiter
    _flight_dropped.reset()
    from . import (audit, breaker, device_obs, drift, incident, router,
                   sampling, timeline)

    device_obs.reset()
    memacct.reset()
    router.reset()
    sampling.reset()
    drift.reset()
    audit.reset()
    slo.reset()
    breaker.reset()
    timeline.reset()
    incident.reset()
    with _trace_lock:
        if _trace_memo is not None:
            fh = _trace_memo[1]
            if fh is not sys.stderr:
                fh.close()
            _trace_memo = None
    metrics.reset()


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


def snapshot() -> Dict[str, Any]:
    """Structured export: flat counters + histogram summaries + the most
    recent root span trees (oldest→newest; ``spans_dropped`` counts roots
    aged out of the ring), a ``device`` section when a device launch was
    recorded (:mod:`.device_obs`), ``routing`` (the ledger and the cost
    model) once a call was routed, ``slo`` with an SLO file set,
    ``sampling`` once the sampler ran, ``drift`` once the detector saw a
    call, ``audit`` once the audit saw a call, ``breakers`` once a
    breaker was touched, ``memory`` always (:func:`.memacct.snapshot_memory`:
    RSS, the planes' bytes, the lifecycle, the card's watermarks and the
    tenant sketch; its probes refresh the ``mem.*`` gauges), ``timeline``
    after its first tick or event, and ``gauges`` when any was set;
    ``flight_records`` counts the flight recorder's ring."""
    # rotation drops deferred from signal context surface on the next
    # export even if no further rotation ever runs
    _flight_dropped.flush()
    with _lock:
        hists = {k: h.summary() for k, h in sorted(_hists.items())}
        spans = [s.to_dict() for s in _spans]
        dropped = _roots_seen - len(_spans)
        flight_n = len(_flight)
    out = {
        "schema_version": SNAPSHOT_SCHEMA_VERSION,
        "pid": os.getpid(),
        "counters": metrics.snapshot(),
        "histograms": hists,
        "spans": spans,
        "spans_dropped": dropped,
        "flight_records": flight_n,
    }
    from . import (audit, breaker, device_obs, drift, router, sampling,
                   timeline)

    dev = device_obs.snapshot()
    if dev:
        out["device"] = dev
    routing = router.snapshot_routing()
    if routing:
        out["routing"] = routing
    slo_sec = slo.snapshot_slo()
    if slo_sec:
        out["slo"] = slo_sec
    samp = sampling.snapshot_sampling()
    if samp:
        out["sampling"] = samp
    dr = drift.snapshot_drift()
    if dr:
        out["drift"] = dr
    aud = audit.snapshot_audit()
    if aud:
        out["audit"] = aud
    brs = breaker.snapshot_breakers()
    if brs:
        out["breakers"] = brs
    # always present: RSS exists before any cache does; the probes also
    # refresh the mem.* gauges read below
    out["memory"] = memacct.snapshot_memory()
    # not ported: the serving section (ROADMAP.md (a) 8.9)
    tl = timeline.snapshot_timeline()
    if tl:
        out["timeline"] = tl
    g = metrics.gauges()
    if g:
        out["gauges"] = g
    return out


def _prom_name(key: str) -> str:
    base = key[:-2] + "_seconds" if key.endswith("_s") else key
    name = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in base)
    if name and name[0].isdigit():
        name = "_" + name
    return "pyruhvro_tpu_" + name


def prometheus(snap: Optional[Dict[str, Any]] = None, *,
               exemplars: bool = False) -> str:
    """Prometheus text exposition of a snapshot (default: live state).

    Counters export as ``*_total`` counters (keys ending ``_s`` as
    ``*_seconds_total``); gauges as gauges; histograms as
    ``_bucket``/``_sum``/``_count`` families with the fixed bucket
    bounds. ``exemplars=True`` appends OpenMetrics exemplar syntax to the
    bucket holding each histogram's worst traced call. The metric names
    keep the reference's ``pyruhvro_tpu_`` prefix, so one dashboard reads
    both packages."""
    if snap is None:
        snap = snapshot()
    lines: List[str] = []
    for key, v in sorted(snap.get("counters", {}).items()):
        name = _prom_name(key) + "_total"
        lines.append(f"# HELP {name} pyruhvro_tpu counter {key}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {float(v)!r}")
    for key, v in sorted(snap.get("gauges", {}).items()):
        name = _prom_name(key)
        lines.append(f"# HELP {name} pyruhvro_tpu gauge {key}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {float(v)!r}")
    for key, h in sorted(snap.get("histograms", {}).items()):
        name = _prom_name(key)
        lines.append(f"# HELP {name} pyruhvro_tpu latency histogram {key}")
        lines.append(f"# TYPE {name} histogram")
        ex = h.get("exemplar") if exemplars else None
        ex_done = False
        seen_inf = False
        for le, cum in h.get("buckets", []):
            if le == "+Inf":
                seen_inf = True
                line = f'{name}_bucket{{le="+Inf"}} {cum}'
            else:
                line = f'{name}_bucket{{le="{float(le)!r}"}} {cum}'
            if ex and not ex_done and (
                    le == "+Inf" or ex["value"] <= float(le)):
                line += (f' # {{trace_id="{ex["trace_id"]}"}} '
                         f'{float(ex["value"])!r}')
                ex_done = True
            lines.append(line)
        if not seen_inf:
            lines.append(f'{name}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{name}_sum {float(h['sum'])!r}")
        lines.append(f"{name}_count {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


# -- Chrome/Perfetto trace_event exporter -----------------------------------
#
# Each root span tree renders into its process row (spans re-parented from
# process-pool workers carry their worker's ``pid`` attr and get their own
# row); siblings that overlap in time (concurrent pool chunks) spread
# across ``tid`` lanes so the flame view nests like the span tree.


def perfetto_trace(snap: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Render a snapshot's span trees as a Chrome trace-event document
    (default: live state), loadable in ui.perfetto.dev."""
    if snap is None:
        snap = snapshot()
    main_pid = int(snap.get("pid") or os.getpid())
    events: List[Dict[str, Any]] = []
    seen_pids: Dict[int, str] = {}
    next_tid: Dict[int, int] = {}
    worker_tids: Dict[int, List[tuple]] = {}  # pid -> [(tid, label)]

    def alloc_tid(pid: int) -> int:
        t = next_tid.get(pid, 2)
        next_tid[pid] = t + 1
        return t

    def emit(span: Dict[str, Any], pid: int, tid: int) -> None:
        attrs = dict(span.get("attrs") or {})
        span_pid = attrs.get("pid")
        if isinstance(span_pid, (int, float)) and int(span_pid) != pid:
            pid = int(span_pid)
            tid = 1
            seen_pids.setdefault(pid, f"pyruhvro_tpu worker {pid}")
        ts = float(span.get("ts") or 0.0) * 1e6
        dur = max(float(span.get("dur_s") or 0.0), 0.0) * 1e6
        events.append({
            "name": str(span.get("name", "?")),
            "cat": str(span.get("name", "?")).split(".")[0],
            "ph": "X",
            "ts": round(ts, 3),
            "dur": round(dur, 3),
            "pid": pid,
            "tid": tid,
            "args": {k: v for k, v in attrs.items()
                     if isinstance(v, (str, int, float, bool))},
        })
        children = sorted(
            span.get("children") or [],
            key=lambda c: float(c.get("ts") or 0.0),
        )
        lane_end = [float("-inf")]
        lane_tid = {0: tid}
        for c in children:
            cts = float(c.get("ts") or 0.0) * 1e6
            cdur = max(float(c.get("dur_s") or 0.0), 0.0) * 1e6
            lane = None
            for i, end in enumerate(lane_end):
                if cts >= end - 1.0:  # 1 µs slack for rounding
                    lane = i
                    break
            if lane is None:
                lane = len(lane_end)
                lane_end.append(float("-inf"))
            lane_end[lane] = cts + cdur
            if lane not in lane_tid:
                lane_tid[lane] = alloc_tid(pid)
                worker_tids.setdefault(pid, []).append(
                    (lane_tid[lane], f"pool lane {lane}")
                )
            emit(c, pid, lane_tid[lane])

    seen_pids[main_pid] = "pyruhvro_tpu"
    for root in snap.get("spans") or []:
        emit(root, main_pid, 1)
    meta: List[Dict[str, Any]] = []
    for pid, name in sorted(seen_pids.items()):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": name}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 1, "args": {"name": "calls"}})
        for tid, label in worker_tids.get(pid, []):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": label}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


# -- JSON-lines trace stream (opt-in) ---------------------------------------

_trace_lock = threading.Lock()
_trace_memo: Optional[tuple] = None  # guarded-by: _trace_lock (path, handle)


def _trace_sink():
    """Resolve PYRUHVRO_TPU_TRACE to a writable handle (memoized per path;
    re-resolved when the variable changes). A file that cannot be opened
    raises ``OSError`` into the call."""
    global _trace_memo
    path = knobs.get_raw("PYRUHVRO_TPU_TRACE")
    if not path:
        return None
    memo = _trace_memo
    if memo is not None and memo[0] == path:
        return memo[1]
    with _trace_lock:
        if _trace_memo is None or _trace_memo[0] != path:
            old = _trace_memo[1] if _trace_memo else None
            if old is not None and old is not sys.stderr:
                old.close()
            fh = sys.stderr if path in ("stderr", "-") else \
                open(path, "a", encoding="utf-8")
            _trace_memo = (path, fh)
        return _trace_memo[1]


def _maybe_trace(span: Span) -> None:
    fh = _trace_sink()
    if fh is None:
        return
    line = json.dumps(span.to_dict(), default=str)
    with _trace_lock:
        fh.write(line + "\n")
        fh.flush()


# ---------------------------------------------------------------------------
# report rendering (CLI: python -m pyruhvro_tpu_torch.telemetry report)
# ---------------------------------------------------------------------------


def _fmt_ms(v) -> str:
    if v is None:
        return "-"
    if v == float("inf"):
        return "inf"
    return f"{v * 1e3:.3f}"


def _phase_table(hists: Dict[str, Any], seconds: Dict[str, float]) -> List[str]:
    header = (f"{'phase':<36} {'count':>7} {'total_s':>10} "
              f"{'p50_ms':>9} {'p95_ms':>9} {'p99_ms':>9}")
    rows = [header, "-" * len(header)]
    for k in sorted(set(hists) | set(seconds)):
        h = hists.get(k)
        if h:
            rows.append(
                f"{k:<36} {h['count']:>7} {h['sum']:>10.4f} "
                f"{_fmt_ms(h.get('p50')):>9} {_fmt_ms(h.get('p95')):>9} "
                f"{_fmt_ms(h.get('p99')):>9}"
            )
        else:
            rows.append(
                f"{k:<36} {'-':>7} {seconds[k]:>10.4f} "
                f"{'-':>9} {'-':>9} {'-':>9}"
            )
    return rows


# native-profiler key families: rendered as their own section, kept out
# of the generic phase and counter tables. Each maps to the parent phase
# its self-times decompose.
_PROF_FAMILIES = (
    ("vm.op.", "host.vm_s"),
    ("vm.encop.", "host.encode_vm_s"),
    ("extract.op.", "host.extract_native_s"),
)
_PROF_PREFIXES = tuple(p for p, _ in _PROF_FAMILIES)


def _prof_tables(counters: Dict[str, float]) -> List[str]:
    out: List[str] = []
    for pfx, parent_key in _PROF_FAMILIES:
        entries: Dict[str, list] = {}
        for k, v in counters.items():
            if not k.startswith(pfx):
                continue
            name = k[len(pfx):]
            if name.endswith("_s"):
                entries.setdefault(name[:-2], [0.0, 0.0])[1] = v
            else:
                entries.setdefault(name, [0.0, 0.0])[0] = v
        if not entries:
            continue
        tot = sum(s for _h, s in entries.values())
        parent = counters.get(parent_key)
        head = f"{pfx}* ({tot * 1e3:.3f} ms self time"
        if parent:
            head += f" = {tot / parent * 100:.1f}% of {parent_key}"
        out.append(head + ")")
        for name, (h, s) in sorted(entries.items(), key=lambda kv: -kv[1][1]):
            share = (s / tot * 100) if tot else 0.0
            out.append(f"  {name:<12} {h:>12.0f} hits "
                       f"{s * 1e3:>10.3f} ms {share:>5.1f}%")
    return out


def _fmt_bytes(v: float) -> str:
    if v >= 1e9:
        return f"{v / 1e9:.2f} GB"
    if v >= 1e6:
        return f"{v / 1e6:.2f} MB"
    if v >= 1e3:
        return f"{v / 1e3:.1f} kB"
    return f"{v:.0f} B"


def _device_section(counters: Dict[str, float],
                    device: Dict[str, Any]) -> List[str]:
    """The device-tier breakdown: first-launch vs launch split, the
    launch registry's hit ratio, transfer bytes, retry/storm counts, the
    kernels' bound bytes, per-entry registry rows and memory watermarks.
    [] when the snapshot never exercised the device tier."""
    keys = {k: v for k, v in counters.items() if k.startswith("device.")}
    if not keys and not device:
        return []
    out = ["== device tier =="]
    comp = keys.get("device.compile_s", 0.0)
    launch = keys.get("device.launch_s", 0.0)
    pipe = keys.get("device.pipeline_s", 0.0)
    line = (f"compile {comp * 1e3:.3f} ms / launch {launch * 1e3:.3f} ms")
    if pipe:
        line += (f" (pipeline {pipe * 1e3:.3f} ms, "
                 f"{(comp + launch) / pipe * 100:.1f}% compile+launch)")
    out.append(line)
    hits = keys.get("device.jit_cache.hits", 0.0)
    misses = keys.get("device.jit_cache.misses", 0.0)
    if hits or misses:
        total = hits + misses
        out.append(f"jit cache: {misses:.0f} miss(es) / {hits:.0f} hit(s)"
                   f" = {hits / total * 100:.1f}% hit ratio")
    h2d = keys.get("device.h2d_bytes", 0.0)
    d2h = keys.get("device.d2h_bytes", 0.0)
    if h2d or d2h:
        out.append(f"transfers: h2d {_fmt_bytes(h2d)} / "
                   f"d2h {_fmt_bytes(d2h)}")
    retries = keys.get("device.retries", 0.0)
    storms = keys.get("device.recompile_storm", 0.0)
    if retries or storms:
        out.append(f"capacity retries: {retries:.0f}; "
                   f"recompile storms: {storms:.0f}")
    flops = keys.get("device.cost.flops", 0.0)
    ba = keys.get("device.cost.bytes_accessed", 0.0)
    if flops or ba:
        # the reference's line reads XLA's cost model summed over
        # compiles; the port's sums each kernel launch's bound bytes
        out.append(f"kernel bounds: {flops:,.0f} flops, "
                   f"{_fmt_bytes(ba)} accessed (sum over launches)")
    cache = (device or {}).get("jit_cache") or {}
    if cache:
        out.append("executables (fingerprint|kind|bucket):")
        rows = sorted(cache.items(),
                      key=lambda kv: -(kv[1].get("compile_s") or 0.0))
        for key, e in rows[:12]:
            out.append(
                f"  {key}: {e.get('compiles', 0)} compile(s) "
                f"{(e.get('compile_s') or 0) * 1e3:.1f} ms, "
                f"{e.get('launches', 0)} launch(es) "
                f"{(e.get('launch_s') or 0) * 1e3:.1f} ms, "
                f"{e.get('hits', 0)} hit(s)"
            )
        if len(rows) > 12:
            out.append(f"  ... {len(rows) - 12} more")
    mem = (device or {}).get("memory") or {}
    for dev_id, m in sorted(mem.items()):
        out.append(
            f"memory[{dev_id}]: in use {_fmt_bytes(m.get('bytes_in_use', 0))}"
            f", peak {_fmt_bytes(m.get('peak_bytes_in_use', 0))}"
        )
    return out


def _render_span(s: Dict[str, Any], indent: int, out: List[str]) -> None:
    attrs = " ".join(f"{k}={v}" for k, v in s.get("attrs", {}).items())
    dur = s.get("dur_s")
    dur_txt = "-" if dur is None else f"{dur * 1e3:.3f} ms"
    out.append("  " * indent + f"{s.get('name', '?')}  {dur_txt}"
               + (f"  [{attrs}]" if attrs else ""))
    for c in s.get("children", []):
        _render_span(c, indent + 1, out)


def render_report(data: Dict[str, Any]) -> str:
    """Phase-breakdown table from a :func:`snapshot` dict, with the
    native profiler's per-opcode tables, the device tier, routing, SLO,
    deep-sampling, memory, drift and audit sections. Not ported: the
    reference's ``BENCH_DETAILS.json`` branch (the port has no bench
    yet)."""
    out: List[str] = []
    counters = data.get("counters", {})
    hists = data.get("histograms", {})
    out.append("== phase breakdown ==")
    out.extend(_phase_table(
        hists,
        {k: v for k, v in counters.items()
         if k.endswith("_s") and k not in hists
         and not k.startswith(_PROF_PREFIXES)},
    ))
    prof = _prof_tables(counters)
    if prof:
        out += ["", "== native profiler (per-opcode self time) =="]
        out.extend(prof)
    dev = _device_section(counters, data.get("device") or {})
    if dev:
        out += [""]
        out.extend(dev)
    workers = {k: v for k, v in counters.items()
               if k.startswith(("pool.worker", "pool.proc"))}
    if workers.get("pool.worker_rows") or workers.get("pool.worker_merges"):
        out += ["", "== pool workers =="]
        out.extend(f"{k:<36} {v:>14.0f}"
                   for k, v in sorted(workers.items()))
    routes = {k: v for k, v in counters.items()
              if k.startswith(("route.", "router."))}
    if routes:
        out += ["", "== routing =="]
        out.extend(f"{k:<36} {v:>10.0f}" for k, v in sorted(routes.items()))
    routing = data.get("routing") or {}
    if routing.get("ledger"):
        out.append(
            f"decision ledger: {len(routing['ledger'])} entr"
            f"{'y' if len(routing['ledger']) == 1 else 'ies'} "
            f"(autotune {'on' if routing.get('autotune') else 'off'}"
            ") — render with the route-report / what-if subcommands")
    slo_sec = data.get("slo") or {}
    if slo_sec:
        breached = slo_sec.get("breached") or []
        out += ["", "== slo =="]
        out.append(
            f"{len(slo_sec.get('objectives') or [])} objective(s); "
            f"breached: {', '.join(breached) or 'none'} — render "
            "with the slo-report subcommand")
    samp = data.get("sampling") or {}
    if samp:
        out += ["", "== adaptive deep sampling =="]
        out.append(
            f"deep {samp.get('deep_calls', 0)}/"
            f"{samp.get('calls', 0)} call(s), period "
            f"{samp.get('period')}, est. deep overhead "
            f"{(samp.get('overhead_frac') or 0) * 100:.2f}% per "
            f"sampled call (budget "
            f"{(samp.get('budget') or 0) * 100:.2f}% of total)")
    mem = data.get("memory") or {}
    if mem:
        rss = mem.get("rss_bytes") or 0
        tracked = mem.get("tracked_bytes") or 0
        out += ["", "== memory =="]
        line = (f"rss {_fmt_bytes(rss)}, tracked "
                f"{_fmt_bytes(tracked)} across "
                f"{len(mem.get('caches') or {})} cache(s)")
        if rss:
            line += f" ({tracked / rss * 100:.1f}% of rss)"
        out.append(line + " — render with the mem-report subcommand")
    dr = data.get("drift") or {}
    if dr.get("entries"):
        hot = [e for e in dr["entries"] if e.get("detections")]
        out += ["", "== latency drift =="]
        out.append(f"{len(dr['entries'])} (schema, arm) pair(s) "
                   f"tracked; {len(hot)} with detections")
        for e in hot[:8]:
            out.append(
                f"  {e.get('schema')} {e.get('op', '?')} "
                f"band={e.get('band', '?')} {e.get('arm')}: "
                f"{e.get('detections')} detection(s), "
                f"fast/slow={e.get('ratio')}")
    aud = data.get("audit") or {}
    if aud:
        out += ["", "== differential audit =="]
        out.append(
            f"audited {aud.get('audited', 0)}/{aud.get('calls', 0)}"
            f" call(s), {aud.get('mismatches', 0)} mismatch(es), "
            f"coverage {(aud.get('coverage') or 0) * 100:.3f}% — "
            "render with the audit-report subcommand")
    other = {k: v for k, v in counters.items()
             if not k.endswith("_s")
             and not k.startswith(("route.", "router."))
             and not k.startswith(_PROF_PREFIXES)
             and not k.startswith("device.")  # rendered above
             and k not in workers}
    if other:
        out += ["", "== counters =="]
        out.extend(f"{k:<36} {v:>14.0f}" for k, v in sorted(other.items()))
    if data.get("flight_records"):
        out += ["", f"flight recorder: {data['flight_records']} record(s)"
                    " buffered (telemetry.flight_dump())"]
    spans = data.get("spans") or []
    if spans:
        out += ["", "== last call span =="]
        _render_span(spans[-1], 0, out)
    return "\n".join(out) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``report <file>`` (phase table), ``prom <file>`` (text
    exposition), ``perfetto <file> [-o out.json]`` (Chrome/Perfetto
    trace-event timeline), ``route-report <file>`` (the routing ledger
    and the learned cost model), ``what-if <file>`` (the ledger replayed:
    where another arm would have won), ``slo-report <file>`` (objectives,
    burn rates and breaches), ``audit-report <file>`` (the audit's
    coverage, mismatches and exported digests), ``mem-report <file>``
    (RSS against the tracked caches, eviction causes, the tenants),
    ``timeline <file> [--json]`` (the time-bucketed history),
    ``incident-report <file>`` (an incident bundle's post-mortem, or a
    snapshot's timeline), ``serve <file> [--port N]`` (a saved snapshot
    over HTTP), ``knobs [--markdown]`` (the environment knobs),
    ``fleet <snap...|--scrape host:port...>`` (N replicas' snapshots
    merged into one) and ``diff <a> <b> [--json] [--window A..B]`` (the
    attribution of the change between two snapshots). ``<file>`` is a
    JSON dict saved from :func:`snapshot` (or an incident bundle). A
    file that cannot be read, is not JSON or is not a snapshot, and a
    replica that cannot be scraped, exit 2 with the problem named on
    stderr, as in the reference (its ``serve-report`` waits for the
    serving plane, ``ROADMAP.md`` (a) 8.9)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m pyruhvro_tpu_torch.telemetry",
        description="Render pyruhvro_tpu_torch telemetry snapshots.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_rep = sub.add_parser("report",
                           help="phase-breakdown table from a snapshot")
    p_rep.add_argument("path")
    p_prom = sub.add_parser(
        "prom", help="Prometheus text format from a snapshot JSON")
    p_prom.add_argument("path")
    p_prom.add_argument("--exemplars", action="store_true",
                        help="append OpenMetrics exemplars (worst "
                             "traced call per histogram)")
    p_perf = sub.add_parser(
        "perfetto", help="Chrome trace-event JSON (load in "
                         "ui.perfetto.dev) from a snapshot JSON")
    p_perf.add_argument("path")
    p_perf.add_argument("-o", "--out",
                        help="write the trace here instead of stdout")
    p_route = sub.add_parser(
        "route-report", help="routing decision ledger + learned cost "
                             "model from a snapshot JSON")
    p_route.add_argument("path")
    p_whatif = sub.add_parser(
        "what-if", help="replay a snapshot's routing ledger: where "
                        "would a different arm have won?")
    p_whatif.add_argument("path")
    p_slo = sub.add_parser(
        "slo-report", help="SLO objectives, burn rates and breach "
                           "state from a snapshot JSON")
    p_slo.add_argument("path")
    p_audit = sub.add_parser(
        "audit-report", help="differential-audit coverage, mismatch "
                             "records and exported result digests "
                             "from a snapshot JSON")
    p_audit.add_argument("path")
    p_mem = sub.add_parser(
        "mem-report", help="memory accounting: RSS vs tracked cache "
                           "footprints, eviction causes and per-tenant "
                           "heavy hitters from a snapshot JSON")
    p_mem.add_argument("path")
    p_knobs = sub.add_parser(
        "knobs", help="list the PYRUHVRO_TPU_* environment knobs "
                      "(runtime/knobs.py) with their types and defaults")
    p_knobs.add_argument("--markdown", action="store_true",
                         help="emit a markdown table instead of the "
                              "plain-text listing")
    p_fleet = sub.add_parser(
        "fleet", help="merge N replicas' snapshot JSONs (or live "
                      "--scrape host:port pulls) into ONE fleet "
                      "snapshot: counters sum, histogram buckets "
                      "merge, gauges sum-or-max by kind, routing "
                      "ledgers and SLO objectives concatenate with "
                      "replica tags")
    p_fleet.add_argument("paths", nargs="*",
                         help="saved snapshot JSON files, one per "
                              "replica")
    p_fleet.add_argument("--scrape", action="append", default=[],
                         metavar="HOST:PORT",
                         help="pull a live /snapshot from this obs "
                              "server (repeatable)")
    p_fleet.add_argument("--tag", action="append", default=[],
                         help="replica tag for the matching source, in "
                              "order (default: file basename / "
                              "host:port)")
    p_fleet.add_argument("-o", "--out",
                         help="write the merged snapshot here instead "
                              "of stdout (render it with report / prom "
                              "/ slo-report)")
    p_diff = sub.add_parser(
        "diff", help="regression attribution between two snapshots: "
                     "per-key counter/gauge deltas, per-phase latency "
                     "shift (p50/p95/p99), new/dead keys, routing-arm "
                     "mix changes")
    p_diff.add_argument("a", help="baseline snapshot JSON")
    p_diff.add_argument("b", help="candidate snapshot JSON")
    p_diff.add_argument("--json", action="store_true",
                        help="emit the structured diff document "
                             "instead of the text report")
    p_diff.add_argument("--window", metavar="A..B",
                        help="diff only the timeline window A..B of "
                             "each snapshot: bounds are epoch seconds "
                             "(>= 1e9), seconds from the first tick "
                             "(>= 0), or seconds back from the newest "
                             "tick (< 0); either side may be empty")
    p_tl = sub.add_parser(
        "timeline", help="time-bucketed history from a snapshot JSON: "
                         "per-interval counter deltas and histogram "
                         "quantiles with state-transition events "
                         "interleaved at their position in time")
    p_tl.add_argument("path")
    p_tl.add_argument("--json", action="store_true",
                      help="emit the raw timeline section instead of "
                           "the text rendering")
    p_inc = sub.add_parser(
        "incident-report", help="post-mortem rendering of an "
                                "auto-captured incident bundle (also "
                                "accepts a plain snapshot: renders its "
                                "timeline section)")
    p_inc.add_argument("path")
    p_serve = sub.add_parser(
        "serve", help="serve a SAVED snapshot over HTTP (/metrics "
                      "/healthz /snapshot) — point dashboards at a "
                      "post-mortem file; live services use "
                      "PYRUHVRO_TPU_OBS_PORT instead")
    p_serve.add_argument("path")
    p_serve.add_argument("--port", type=int, default=0,
                         help="bind port (default 0 = any free port)")
    p_serve.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)

    if args.cmd == "knobs":
        # the registry needs no snapshot file
        sys.stdout.write(knobs.render_markdown_table() if args.markdown
                         else knobs.render_text_table())
        return 0

    def _usage_error(msg: str) -> int:
        # a missing or malformed snapshot is an operator mistake, not a
        # crash: name the problem, show the usage, exit 2
        print(f"error: {msg}", file=sys.stderr)
        ap.print_usage(sys.stderr)
        print("hint: <file> is a JSON dict saved from "
              "telemetry.snapshot() (or an incident bundle)",
              file=sys.stderr)
        return 2

    def _needs(keys, what: str) -> Optional[int]:
        if keys & set(data):
            return None
        return _usage_error(f"not a telemetry snapshot (expected {what} "
                            "keys)")

    def _load(path: str):
        """A parsed JSON dict, or an exit code (2)."""
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except OSError as e:
            return _usage_error(f"cannot read {path}: {e}")
        except ValueError as e:
            return _usage_error(f"{path} is not valid JSON: {e}")
        if not isinstance(doc, dict):
            return _usage_error(
                f"{path} holds a JSON {type(doc).__name__}, not a "
                "snapshot object")
        return doc

    def _load_snapshot(path: str):
        """A parsed snapshot, or an exit code (2)."""
        doc = _load(path)
        if isinstance(doc, dict) and not (
                {"counters", "histograms", "spans"} & set(doc)):
            return _usage_error(
                f"{path} is not a telemetry snapshot (expected "
                "'counters'/'histograms'/'spans' keys)")
        return doc

    if args.cmd == "fleet":
        return _fleet_cmd(args, _usage_error, _load_snapshot)
    if args.cmd == "diff":
        return _diff_cmd(args, _usage_error, _load_snapshot)
    data = _load(args.path)
    if isinstance(data, int):
        return data
    ver = data.get("schema_version")
    if isinstance(ver, (int, float)) and ver > SNAPSHOT_SCHEMA_VERSION:
        # a snapshot from a newer build renders best-effort
        print(f"note: snapshot schema_version {ver:g} is newer than "
              f"this CLI ({SNAPSHOT_SCHEMA_VERSION}); rendering "
              "best-effort", file=sys.stderr)
    if args.cmd in ("route-report", "what-if"):
        bad = _needs({"routing", "counters", "histograms"},
                     "'routing'/'counters'/'histograms'")
        if bad is not None:
            return bad
        from . import router

        render = (router.render_route_report if args.cmd == "route-report"
                  else router.render_what_if)
        sys.stdout.write(render(data))
    elif args.cmd == "slo-report":
        bad = _needs({"slo", "counters", "histograms"},
                     "'slo'/'counters'/'histograms'")
        if bad is not None:
            return bad
        sys.stdout.write(slo.render_slo_report(data))
    elif args.cmd == "audit-report":
        bad = _needs({"audit", "counters", "histograms"},
                     "'audit'/'counters'/'histograms'")
        if bad is not None:
            return bad
        from . import audit as _audit

        sys.stdout.write(_audit.render_audit_report(data))
        sys.stdout.write("\n")
    elif args.cmd == "mem-report":
        bad = _needs({"memory", "counters", "histograms"},
                     "'memory'/'counters'/'histograms'")
        if bad is not None:
            return bad
        sys.stdout.write(memacct.render_mem_report(data))
    elif args.cmd == "timeline":
        bad = _needs({"timeline", "counters", "histograms"},
                     "'timeline'/'counters'/'histograms'")
        if bad is not None:
            return bad
        # a snapshot without a timeline section renders a note
        from . import timeline as _tl

        if args.json:
            json.dump(data.get("timeline") or {}, sys.stdout, indent=1,
                      default=str)
            sys.stdout.write("\n")
        else:
            sys.stdout.write(_tl.render_timeline(data))
    elif args.cmd == "incident-report":
        if not ({"timeline", "trigger", "counters", "histograms"}
                & set(data)):
            return _usage_error(
                "not an incident bundle or telemetry snapshot "
                "(expected 'trigger'/'timeline'/'counters'/"
                "'histograms' keys)")
        from . import incident as _incident

        sys.stdout.write(_incident.render_incident_report(data))
    elif args.cmd == "serve":
        bad = _needs({"counters", "histograms", "spans"},
                     "'counters'/'histograms'/'spans'")
        if bad is not None:
            return bad
        from . import obs_server

        srv = obs_server.ObsServer(port=args.port, host=args.host,
                                   snapshot=data)
        print(f"serving {args.path} on {srv.url} "
              "(/metrics /healthz /snapshot) — Ctrl-C to stop",
              file=sys.stderr, flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.stop()
    elif args.cmd == "report":
        bad = _needs({"counters", "histograms"}, "'counters'/'histograms'")
        if bad is not None:
            return bad
        sys.stdout.write(render_report(data))
    elif args.cmd == "perfetto":
        bad = _needs({"spans", "counters", "histograms"},
                     "'spans'/'counters'/'histograms'")
        if bad is not None:
            return bad
        doc = json.dumps(perfetto_trace(data))
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(doc)
        else:
            sys.stdout.write(doc + "\n")
    else:
        bad = _needs({"counters", "histograms"}, "'counters'/'histograms'")
        if bad is not None:
            return bad
        sys.stdout.write(prometheus(data, exemplars=args.exemplars))
    return 0


def _fleet_cmd(args, usage_error, load_snapshot) -> int:
    """``fleet``: saved snapshots and live scrapes merged into one."""
    from . import fleet as _fleet

    if not args.paths and not args.scrape:
        return usage_error(
            "fleet needs at least one snapshot file or --scrape host:port")
    snaps: List[Dict[str, Any]] = []
    tags: List[str] = []
    for i, path in enumerate(args.paths):
        doc = load_snapshot(path)
        if isinstance(doc, int):
            return doc
        snaps.append(doc)
        tags.append(args.tag[i] if i < len(args.tag)
                    else os.path.basename(path))
    for j, hostport in enumerate(args.scrape):
        try:
            doc = _fleet.fetch_snapshot(hostport)
        except (OSError, ValueError) as e:
            return usage_error(f"cannot scrape {hostport}: {e}")
        snaps.append(doc)
        k = len(args.paths) + j
        tags.append(args.tag[k] if k < len(args.tag) else hostport)
    merged = _fleet.merge_snapshots(snaps, tags)
    if args.out:
        from . import fsio

        fsio.atomic_write_json(args.out, merged)
        print(f"merged {len(snaps)} replica snapshot(s) -> {args.out} "
              "(render with report / prom / slo-report)", file=sys.stderr)
    else:
        json.dump(merged, sys.stdout, indent=1, default=str)
        sys.stdout.write("\n")
    return 0


def _diff_cmd(args, usage_error, load_snapshot) -> int:
    """``diff``: the attribution of the change from snapshot a to b,
    over a timeline window of each with ``--window``."""
    from . import fleet as _fleet

    a = load_snapshot(args.a)
    if isinstance(a, int):
        return a
    b = load_snapshot(args.b)
    if isinstance(b, int):
        return b
    if args.window:
        try:
            win = _fleet.parse_window(args.window)
        except ValueError as e:
            return usage_error(str(e))
        for name, path, doc in (("a", args.a, a), ("b", args.b, b)):
            w = _fleet.window_snapshot(doc, win)
            if w is None:
                # attribution still runs, on the whole snapshot
                print(f"note: {path} has no timeline ticks — diffing the "
                      f"whole snapshot for side '{name}'", file=sys.stderr)
            elif name == "a":
                a = w
            else:
                b = w
    if args.json:
        json.dump(_fleet.diff_snapshots(a, b), sys.stdout, indent=1,
                  default=str)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(_fleet.render_diff(a, b))
    return 0


# the OTLP/HTTP exporter (runtime/otel.py): opt-in through
# PYRUHVRO_TPU_OTLP_ENDPOINT, started once at import; last in the module,
# because its start registers the span sink defined above
if knobs.get_raw("PYRUHVRO_TPU_OTLP_ENDPOINT"):
    from . import otel as _otel

    _otel.start_from_env()
