"""Process-wide counters, gauges and marks (copy of
``pyruhvro_tpu/runtime/metrics.py``, whole).

Counters are cumulative floats keyed by ``"component.event"`` (e.g.
``decode.h2d_bytes``, ``device.launch_s``), cheap enough to stay always
on: one lock and one dict add per event, on the host. Keys ending in
``_s`` are seconds. :mod:`.telemetry` layers spans and histograms on
top; ``telemetry.snapshot()`` exports these counters with them.

Gauges are a last-value store for facts that go down as well as up
(exported as ``# TYPE ... gauge`` by ``telemetry.prometheus``); marks
timestamp events (a quarantine storm, a recompile storm) so a reader
can tell how long ago they happened. :class:`record_deltas` records the
increments of one thread, which ``telemetry.worker_scope`` ships from a
worker to its parent.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict

__all__ = ["inc", "merge", "snapshot", "reset", "timer", "record_deltas",
           "mark", "mark_age", "DeferredCount", "register_flush_hook",
           "set_gauge", "gauges", "declare_gauge_kind", "gauge_kind"]

_lock = threading.Lock()
_counters: Dict[str, float] = defaultdict(float)  # guarded-by: _lock
_gauges: Dict[str, float] = {}  # guarded-by: _lock
_marks: Dict[str, float] = {}  # guarded-by: _lock
_tls = threading.local()


def inc(key: str, value: float = 1.0) -> None:
    with _lock:
        _counters[key] += value
    rec = getattr(_tls, "delta", None)
    if rec is not None:
        rec[key] = rec.get(key, 0.0) + value


def merge(deltas: Dict[str, float]) -> None:
    """Fold a counter-delta dict (a pool/process worker's exported
    increments) into this process's counters in one lock acquisition."""
    with _lock:
        for k, v in deltas.items():
            _counters[k] += v
    rec = getattr(_tls, "delta", None)
    if rec is not None:
        for k, v in deltas.items():
            rec[k] = rec.get(k, 0.0) + v


class record_deltas:
    """Record every ``inc`` made on THIS thread into a plain dict —
    the per-worker attribution primitive behind
    :func:`..telemetry.worker_scope` and the pool's per-chunk
    accounting. Nesting is additive: an inner recorder's deltas fold
    into the enclosing one on exit, so a worker-scope wrapped around
    chunk-scopes still sees the full total."""

    __slots__ = ("delta", "_prev")

    def __enter__(self) -> Dict[str, float]:
        self._prev = getattr(_tls, "delta", None)
        self.delta = {}
        _tls.delta = self.delta
        return self.delta

    def __exit__(self, *exc):
        _tls.delta = self._prev
        if self._prev is not None:
            for k, v in self.delta.items():
                self._prev[k] = self._prev.get(k, 0.0) + v
        return False


def set_gauge(key: str, value: float) -> None:
    """Set a last-value gauge (cache bytes, RSS, live entry counts).
    Same cost model as :func:`inc`: one lock + dict store. Gauges are
    NOT folded into worker deltas — a worker's footprint is its own
    process's fact, not an increment the parent should sum."""
    with _lock:
        _gauges[key] = float(value)


def gauges() -> Dict[str, float]:
    """A copy of every gauge's current value."""
    with _lock:
        return dict(_gauges)


# fleet-merge semantics per gauge family: when N replicas'
# snapshots merge, most gauges SUM (total cache bytes across the fleet
# is the capacity fact an operator wants) but watermark-shaped gauges
# must take the MAX — peaks summed across replicas describe a process
# that never existed. Declared by key prefix; longest match wins.
# Static defaults cover the known watermark families so an OFFLINE
# merge (the fleet CLI over saved files) agrees with a live one.
_GAUGE_MAX_PREFIXES = {"mem.peak_", "mem.high_water"}  # guarded-by: _lock


def declare_gauge_kind(prefix: str, kind: str = "sum") -> None:
    """Declare how gauges under ``prefix`` merge across replicas:
    ``"sum"`` (the default for undeclared keys) or ``"max"`` for
    watermarks/high-water facts."""
    assert kind in ("sum", "max"), kind
    with _lock:
        if kind == "max":
            _GAUGE_MAX_PREFIXES.add(prefix)
        else:
            _GAUGE_MAX_PREFIXES.discard(prefix)


def gauge_kind(key: str) -> str:
    """The declared fleet-merge kind for one gauge key."""
    with _lock:
        for p in _GAUGE_MAX_PREFIXES:
            if key.startswith(p):
                return "max"
    return "sum"


def mark(key: str) -> None:
    """Timestamp an EVENT (quarantine storm, recompile storm, SLO
    breach…). Unlike counters — which only ever grow — a mark carries
    WHEN, which is what the live health endpoint needs: "a storm
    happened at some point" is history, "a storm happened 4 s ago" is a
    page. Same cost model as :func:`inc`: one lock + dict store."""
    with _lock:
        _marks[key] = time.monotonic()


def mark_age(key: str):
    """Seconds since ``key`` was last marked, or None (never marked /
    cleared by :func:`reset`)."""
    with _lock:
        ts = _marks.get(key)
    return None if ts is None else max(0.0, time.monotonic() - ts)


class DeferredCount:
    """A counter that may be bumped from SIGNAL context, where
    :func:`inc` could deadlock (the handler may have interrupted a
    frame that holds the non-reentrant metrics lock). A monotonic
    total/reported pair instead of a reset-to-zero pending count: the
    signal side only ever INCREMENTS (plain int ``+=`` on the main
    thread, atomic under the GIL), and flushers advance ``reported``
    under a lock — two concurrent flushers cannot double-count a
    delta, and a handler firing mid-flush is simply picked up by the
    next one."""

    __slots__ = ("key", "_total", "_reported", "_lock")

    def __init__(self, key: str):
        self.key = key
        self._total = 0
        self._reported = 0
        self._lock = threading.Lock()

    def bump(self, n: int = 1) -> None:
        """Signal-context side: increment only, never a lock."""
        self._total += n

    def flush(self) -> None:
        """Normal-thread side: publish any un-reported delta via
        :func:`inc`. Lock-free fast path — both fields only ever
        advance, so an equal read means nothing to flush (the ~100%
        case on per-call paths)."""
        if self._total == self._reported:
            return
        with self._lock:
            delta = self._total - self._reported
            if delta <= 0:
                return
            self._reported += delta
        inc(self.key, float(delta))

    def reset(self) -> None:
        with self._lock:
            self._total = 0
            self._reported = 0


# modules holding DeferredCounts that signal context may bump register
# a flush callback here; snapshot() runs them (lock NOT held) so
# deferred deltas are never invisible to a reader. Hooks must be
# idempotent and cheap.
_flush_hooks: list = []  # lock-free-ok(append-only registration at import; snapshot's iteration tolerates a concurrent append)


def register_flush_hook(fn) -> None:
    _flush_hooks.append(fn)


def snapshot() -> Dict[str, float]:
    for fn in _flush_hooks:
        fn()
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _marks.clear()


class timer:
    """``with timer("decode.pack_s"): ...`` — adds elapsed seconds."""

    __slots__ = ("key", "_t0")

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        inc(self.key, time.perf_counter() - self._t0)
        return False
