"""Memory accounting: the bytes of every long-lived cache (copy of
``pyruhvro_tpu/runtime/memacct.py``, whole but for the allocator release
after a pressure relief, and an arrow-ingested input's bytes read off
its two end offsets: the reference's number without its pass over every
datum).

Every long-lived structure self-reports its footprint through a **probe
registry**: the schema cache, the buckets' launch state
(``cache.executables``), the pinned arenas with their card twins
(``cache.arenas``), the built kernel libraries (``cache.kernels``), the
capacity planner, the routing ledger and the span and flight rings.
:func:`collect` publishes them as **gauges** (``mem.<name>.bytes`` /
``mem.<name>.items``) beside the process's RSS and the card's allocator
watermarks (``device_obs.note_memory``). ``telemetry.snapshot()``
carries the whole picture as its ``memory`` section, rendered by
``python -m pyruhvro_tpu_torch.telemetry mem-report`` and served live at
the obs server's ``/memory``.

Three jobs beyond plain accounting:

* **decomposition**: :func:`snapshot_memory` reports ``tracked_bytes``
  beside ``rss_bytes``;
* **pressure**: :func:`tick` (one call per API entry, throttled)
  compares RSS with ``PYRUHVRO_TPU_MEM_HIGH_WATER``; crossing it counts
  ``mem.pressure``, marks the ``mem_pressure`` health bit, publishes a
  ``mem.pressure`` timeline event, asks :mod:`.cachelife` to evict the
  overage in global LRU order, annotates the root span and auto-dumps
  the flight recorder;
* **attribution**: every API call feeds a space-saving **top-k
  heavy-hitter sketch** keyed (tenant, schema fingerprint): calls, rows
  and approximate input bytes. The ``tenant=`` keyword of the public API
  threads the id through; untagged calls pool under ``"-"``.

Nothing here initialises CUDA: the card's figures are the watermarks
``device_obs.note_memory`` recorded after a device call and the sizes of
tensors that already exist, and no ``torch.cuda`` function is called
unless ``torch.cuda.is_initialized()``. A ``/memory`` scrape of a
process that never touched the card therefore creates no CUDA context.

One departure (``ROADMAP.md`` (c) 8): the arenas are pinned host blocks
and card blocks, which PyTorch's caching allocators keep when they are
freed, so RSS and the card's reserved bytes need not fall after an
eviction. After a pressure relief (and only then) :func:`tick` empties
both allocators' caches once (``device_obs.release_allocator_caches``).

Bytes are exact where a buffer gives them (numpy and tensor ``nbytes``,
``.so`` file sizes) and stated estimates elsewhere (parsed schema IR,
ring records, registry rows).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import cachelife, knobs, metrics, schedtest

__all__ = [
    "register_probe",
    "rss_bytes",
    "peak_rss_bytes",
    "collect",
    "tracked_bytes",
    "snapshot_memory",
    "attribute",
    "tick",
    "high_water_bytes",
    "render_mem_report",
    "reset",
]

_lock = threading.Lock()
_probes: Dict[str, Callable[[], Dict[str, float]]] = {}  # guarded-by: _lock

# estimates for ring records whose true per-entry size would need a
# json.dumps per snapshot to measure (documented, deliberately coarse)
RING_RECORD_EST_BYTES = 512


def register_probe(name: str, fn: Callable[[], Dict[str, float]]) -> None:
    """Register (idempotent by name) a footprint probe: ``fn()`` returns
    at least ``{"bytes": float}`` and optionally ``"items"``. Probes run
    at snapshot time and must be cheap and exception-safe — a raising
    probe is skipped and counted ``mem.probe_error``."""
    with _lock:
        _probes[name] = fn


# ---------------------------------------------------------------------------
# process RSS
# ---------------------------------------------------------------------------

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_bytes() -> int:
    """Current resident set size in bytes (``/proc/self/statm`` on
    Linux; 0 where unavailable — callers treat 0 as "unknown")."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return 0


def peak_rss_bytes() -> int:
    """Peak RSS (``ru_maxrss``; kilobytes on Linux)."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


def high_water_bytes() -> int:
    return max(0, knobs.get_int("PYRUHVRO_TPU_MEM_HIGH_WATER") or 0)


# ---------------------------------------------------------------------------
# collection -> gauges
# ---------------------------------------------------------------------------


# collect() memoizes for a short interval: RSS and footprints are
# time-varying, and publishing a fresh sample per render would break
# the contract that a /metrics scrape is byte-identical to
# telemetry.prometheus() on the same registry state (two back-to-back
# renders must see the SAME gauge values). One probe walk per second
# is also simply cheaper under scrape + snapshot + report traffic.
_COLLECT_TTL_S = 1.0
_collect_lock = threading.Lock()
_collect_memo: Optional[tuple] = None  # guarded-by: _collect_lock
# generation stamp against the collect-vs-reset race: a
# probe walk that started before a reset() must not re-publish its
# pre-reset sample into the memo/gauges after the reset lands — the
# walk captures the generation up front and its results are discarded
# when reset() bumped it meanwhile (the next collect() samples fresh)
_collect_gen = 0  # guarded-by: _collect_lock


def _collect_full(force: bool = False):
    """-> (caches, rss_bytes), memoized for ``_COLLECT_TTL_S``."""
    global _collect_memo
    now = time.monotonic()
    with _collect_lock:
        memo = _collect_memo
        gen = _collect_gen
        if not force and memo is not None and now - memo[0] < _COLLECT_TTL_S:
            return memo[1], memo[2]
    schedtest.yp("memacct.collect")
    with _lock:
        probes = list(_probes.items())
    out: Dict[str, Dict[str, float]] = {}
    total = 0.0
    gauge_writes = []
    for name, fn in probes:
        try:
            res = fn() or {}
            b = float(res.get("bytes", 0.0) or 0.0)
        except Exception:
            metrics.inc("mem.probe_error")
            continue
        out[name] = res
        total += b
        # metric-key: mem.<plane>.bytes
        gauge_writes.append((f"mem.{name}.bytes", b))
        if "items" in res:
            # metric-key: mem.<plane>.items
            gauge_writes.append((f"mem.{name}.items", float(res["items"])))
    rss = rss_bytes()
    # metric-key: mem.rss_bytes
    gauge_writes.append(("mem.rss_bytes", float(rss)))
    # metric-key: mem.tracked_bytes
    gauge_writes.append(("mem.tracked_bytes", total))
    schedtest.yp("memacct.collect.store")
    with _collect_lock:
        if _collect_gen == gen:
            _collect_memo = (now, out, rss)
            # publish under the generation check too: a reset that beat
            # us here cleared the gauges, and re-publishing a pre-reset
            # sample would resurrect them (metrics._lock nests inside
            # _collect_lock; both are leaf-cheap, no blocking work)
            for key, val in gauge_writes:
                metrics.set_gauge(key, val)
    return out, rss


def collect(force: bool = False) -> Dict[str, Dict[str, float]]:
    """Run every probe (at most once per ``_COLLECT_TTL_S``; pass
    ``force=True`` to bypass the memo), publish ``mem.*`` gauges,
    return the per-cache results. Called from ``telemetry.snapshot()``
    so every export sees current-within-a-second footprints."""
    return _collect_full(force)[0]


def tracked_bytes() -> int:
    """Sum of every probe's current byte footprint (no gauge writes)."""
    with _lock:
        probes = list(_probes.values())
    total = 0.0
    for fn in probes:
        try:
            total += float((fn() or {}).get("bytes", 0.0) or 0.0)
        except Exception:
            metrics.inc("mem.probe_error")
    return int(total)


def _device_memory() -> Dict[str, Any]:
    """Per-card allocator watermarks, from the device-obs registry only
    (never initialises CUDA)."""
    try:
        from . import device_obs

        return (device_obs.snapshot() or {}).get("memory") or {}
    except Exception:
        return {}


def snapshot_memory() -> Dict[str, Any]:
    """The ``memory`` section of ``telemetry.snapshot()``: RSS + peak,
    tracked total, per-cache footprints, lifecycle summary (live
    entries / capacity per managed cache), per-device watermarks,
    high-water configuration and the heavy-hitter attribution table.
    Caches and RSS come from the same memoized :func:`collect` pass,
    so the section is internally consistent with the gauges."""
    caches, rss = _collect_full()
    tracked = int(sum(float(c.get("bytes", 0) or 0)
                      for c in caches.values()))
    out: Dict[str, Any] = {
        "rss_bytes": rss,
        "peak_rss_bytes": peak_rss_bytes(),
        "tracked_bytes": tracked,
        "caches": {k: {kk: (int(vv) if isinstance(vv, float)
                            and float(vv).is_integer() else vv)
                       for kk, vv in v.items()}
                   for k, v in sorted(caches.items())},
        "lifecycle": cachelife.snapshot_lifecycle(),
    }
    hw = high_water_bytes()
    if hw:
        out["high_water_bytes"] = hw
        out["over_high_water"] = bool(rss and rss > hw)
    dev = _device_memory()
    if dev:
        out["devices"] = dev
    tenants = _sketch.snapshot()
    if tenants:
        out["tenants"] = tenants
    return out


# ---------------------------------------------------------------------------
# per-(tenant, schema) heavy-hitter attribution
# ---------------------------------------------------------------------------


class _SpaceSaving:
    """Space-saving top-k: bounded-memory heavy hitters over the
    (tenant, schema fingerprint) call stream. When the table is full, a
    new key replaces the minimum-weight row and inherits its weight as
    the classical over-estimate bound (kept as ``err``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[tuple, Dict[str, float]] = {}

    def _k(self) -> int:
        return max(1, knobs.get_int("PYRUHVRO_TPU_MEM_TOPK") or 64)

    def note(self, tenant: str, schema: str, op: str, rows: int,
             nbytes: int) -> None:
        key = (tenant, schema)
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                k = self._k()
                if len(self._rows) >= k:
                    victim = min(self._rows,
                                 key=lambda r: self._rows[r]["bytes"])
                    inherited = self._rows.pop(victim)
                    row = {"calls": 0.0, "rows": 0.0,
                           "bytes": inherited["bytes"],
                           "err": inherited["bytes"]}
                else:
                    row = {"calls": 0.0, "rows": 0.0, "bytes": 0.0,
                           "err": 0.0}
                self._rows[key] = row
            row["calls"] += 1
            row["rows"] += rows
            row["bytes"] += nbytes
            row[f"{op}_calls"] = row.get(f"{op}_calls", 0.0) + 1

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            rows = [
                {"tenant": t, "schema": s,
                 **{k: int(v) for k, v in r.items()}}
                for (t, s), r in self._rows.items()
            ]
        rows.sort(key=lambda r: -r["bytes"])
        return rows

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()


_sketch = _SpaceSaving()


def tenant_hotlist() -> List[Dict[str, Any]]:
    """The heavy-hitter sketch rows (tenant, schema, calls, rows,
    bytes; bytes-descending) WITHOUT running the cache probes that
    ``snapshot_memory`` triggers — the serving plane's per-tenant
    admission signal reads this on the submit path, so it must stay
    cheap."""
    return _sketch.snapshot()


def _approx_bytes(payload) -> int:
    """Cheap input-size estimate for attribution: exact for pyarrow
    batches (``nbytes``) and arrow-ingested datum views (their end
    offsets' difference); sampled (first 64 datums x n) for plain sequences —
    an O(1) estimate, never an O(n) pass on the hot path."""
    if payload is None:
        return 0
    try:
        if hasattr(payload, "lens"):  # runtime.ingest.DatumView
            # lens().sum() without the pass over every datum
            return payload.total_bytes()
        if hasattr(payload, "nbytes"):  # pa.RecordBatch / numpy
            return int(payload.nbytes)
        n = len(payload)
        if not n:
            return 0
        k = min(n, 64)
        sample = sum(len(payload[i]) for i in range(k))
        return int(sample * (n / k))
    except Exception:
        return 0


def attribute(tenant: Optional[str], schema_fp: str, op: str, rows: int,
              payload=None) -> None:
    """Feed one API call into the heavy-hitter sketch (untagged calls
    pool under tenant ``"-"``)."""
    _sketch.note(tenant or "-", schema_fp, op, int(rows),
                 _approx_bytes(payload))


# ---------------------------------------------------------------------------
# the per-call tick: TTL sweep + high-water pressure
# ---------------------------------------------------------------------------

_TICK_MIN_INTERVAL_S = 1.0

_tick_lock = threading.Lock()
_tick_last = 0.0  # guarded-by: _tick_lock


def tick() -> None:
    """Opportunistic lifecycle tick, called once per public API call:
    throttled to at most one real pass per ``_TICK_MIN_INTERVAL_S``,
    it runs the TTL sweep and the high-water pressure check. The
    throttled fast path costs one lock + one ``monotonic()`` read; a
    real pass with both knobs off costs two env reads on top."""
    global _tick_last
    with _tick_lock:
        now = time.monotonic()
        if now - _tick_last < _TICK_MIN_INTERVAL_S:
            return
        _tick_last = now
    if cachelife.ttl_s() > 0:
        cachelife.sweep(now)
    hw = high_water_bytes()
    if not hw:
        return
    rss = rss_bytes()
    if not rss or rss <= hw:
        return
    metrics.inc("mem.pressure")
    metrics.mark("mem_pressure")
    from . import timeline

    timeline.event("mem.pressure", severity="incident",
                   attrs={"rss_bytes": rss, "high_water_bytes": hw})
    evicted, freed = cachelife.relieve(rss - hw)
    metrics.inc("mem.pressure_evicted", evicted)
    # the evicted blocks go back to PyTorch's caching allocators, not to
    # the OS or CUDA: hand the cached ones back once, here
    from . import device_obs

    device_obs.release_allocator_caches()
    from . import telemetry

    telemetry.annotate_root(mem_pressure=True)
    telemetry._flight_autodump("mem_high_water")


def force_pressure_check() -> None:
    """Un-throttled pressure/TTL pass (tests, the chip smoke)."""
    global _tick_last
    with _tick_lock:
        _tick_last = 0.0
    tick()


# ---------------------------------------------------------------------------
# mem-report rendering (CLI: python -m pyruhvro_tpu_torch.telemetry mem-report)
# ---------------------------------------------------------------------------


def render_mem_report(snap: Dict[str, Any]) -> str:
    """Human rendering of a snapshot's ``memory`` section (+ the
    eviction counters that explain how it got that way). Degrades with
    a one-line note on snapshots that predate the section."""
    # the report CLI's byte formatter, shared so the two renderings
    # can never diverge (deferred: telemetry imports this module)
    from .telemetry import _fmt_bytes

    mem = snap.get("memory")
    counters = snap.get("counters") or {}
    out: List[str] = []
    if not mem:
        return ("no memory section in this snapshot (predates the "
                "memory accounting plane)\n")
    out.append("== memory ==")
    rss = mem.get("rss_bytes") or 0
    tracked = mem.get("tracked_bytes") or 0
    line = (f"rss {_fmt_bytes(rss)} (peak "
            f"{_fmt_bytes(mem.get('peak_rss_bytes') or 0)}); tracked "
            f"{_fmt_bytes(tracked)}")
    if rss:
        line += f" = {tracked / rss * 100:.1f}% of rss"
    out.append(line)
    hw = mem.get("high_water_bytes")
    if hw:
        state = "OVER" if mem.get("over_high_water") else "under"
        out.append(f"high water {_fmt_bytes(hw)} ({state}); pressure "
                   f"events {counters.get('mem.pressure', 0):.0f}")
    caches = mem.get("caches") or {}
    life = mem.get("lifecycle") or {}
    if caches:
        out.append("")
        out.append(f"{'cache':<22} {'bytes':>12} {'items':>8} "
                   f"{'live':>6} {'cap':>6} "
                   f"{'lru':>6} {'ttl':>6} {'press':>6}")
        for name in sorted(caches):
            c = caches[name]
            lf = life.get(name.split(".", 1)[-1]) or {}
            short = name.split(".", 1)[-1]
            ev = [counters.get(f"cache.evict.{short}.{cause}", 0)
                  for cause in ("lru", "ttl", "pressure")]
            out.append(
                f"{name:<22} {_fmt_bytes(c.get('bytes', 0)):>12} "
                f"{c.get('items', '-')!s:>8} "
                f"{lf.get('entries', '-')!s:>6} "
                f"{lf.get('capacity', '-')!s:>6} "
                f"{ev[0]:>6.0f} {ev[1]:>6.0f} {ev[2]:>6.0f}"
            )
    devices = mem.get("devices") or {}
    for dev_id, m in sorted(devices.items()):
        line = (f"device[{dev_id}]: in use "
                f"{_fmt_bytes(m.get('bytes_in_use', 0))}, peak "
                f"{_fmt_bytes(m.get('peak_bytes_in_use', 0))}")
        if "bytes_reserved" in m:
            # the card's caching allocator: what it holds beside what is
            # allocated
            line += f", reserved {_fmt_bytes(m['bytes_reserved'])}"
        out.append(line)
    tenants = mem.get("tenants") or []
    if tenants:
        out.append("")
        out.append("== heavy hitters (tenant, schema) ==")
        out.append(f"{'tenant':<16} {'schema':<14} {'calls':>8} "
                   f"{'rows':>12} {'bytes':>12}")
        for row in tenants[:16]:
            out.append(
                f"{str(row.get('tenant', '-')):<16} "
                f"{str(row.get('schema', '?')):<14} "
                f"{row.get('calls', 0):>8} {row.get('rows', 0):>12} "
                f"{_fmt_bytes(row.get('bytes', 0)):>12}"
            )
        if len(tenants) > 16:
            out.append(f"  ... {len(tenants) - 16} more")
    return "\n".join(out) + "\n"


def reset() -> None:
    """Clear the attribution sketch, the tick throttle and the collect
    memo (test isolation; probes are module wiring and survive). Bumps
    the collect generation so an in-flight probe walk cannot re-publish
    its pre-reset sample (see :func:`_collect_full`)."""
    global _tick_last, _collect_memo, _collect_gen
    _sketch.reset()
    with _tick_lock:
        _tick_last = 0.0
    with _collect_lock:
        _collect_gen += 1
        _collect_memo = None
