"""Cache lifecycle: LRU and TTL eviction and admission control (copy of
``pyruhvro_tpu/runtime/cachelife.py``, whole).

Every long-lived schema-keyed cache grows without bound unless something
evicts it: the schema cache pins every ``SchemaEntry`` (and through its
extras the native codec, the readers and the device codec with its
decoders), every bucket's launch state lives as long as its decoder, and
every pinned arena and its card twin as long as theirs. This module is
the one place the eviction policy lives; the caches stay plain.

Each managed cache **registers** three callables:

* ``entries() -> [(key, last_used_monotonic, bytes), ...]``, a cheap
  enumeration of the live entries (estimates are fine);
* ``evict(key) -> bool``, which drops one entry. It must be safe against
  users in flight: callers hold their own references, eviction only
  unlinks the cache's, so the entry rebuilds at its next use, bit for bit,
  because everything in these caches derives from the schema string;
* ``capacity() -> int``, the most live entries (0 = no limit).

Three causes, each counted as ``cache.evict.<name>.{lru,ttl,pressure}``:

* **lru**: :func:`admit` runs after an insert and evicts the least
  recently used entries past ``capacity()``;
* **ttl**: :func:`sweep` drops entries idle longer than
  ``PYRUHVRO_TPU_CACHE_TTL_S`` (called from the API's tick in
  :mod:`.memacct`, throttled there);
* **pressure**: :func:`relieve` frees at least the requested bytes in
  global least-recently-used order across every cache (the
  ``PYRUHVRO_TPU_MEM_HIGH_WATER`` check).

A cache whose hooks raise is skipped and counted ``cache.hook_error``; a
sweep never fails the call that triggered it, as in the reference.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import knobs, metrics, schedtest

__all__ = [
    "register",
    "admit",
    "sweep",
    "relieve",
    "ttl_s",
    "snapshot_lifecycle",
    "reset",
]


class _Managed:
    __slots__ = ("name", "entries", "evict", "capacity")

    def __init__(self, name: str, entries: Callable, evict: Callable,
                 capacity: Optional[Callable]):
        self.name = name
        self.entries = entries
        self.evict = evict
        self.capacity = capacity


_lock = threading.Lock()
_caches: Dict[str, _Managed] = {}  # guarded-by: _lock


def register(name: str, *, entries: Callable[[], List[tuple]],
             evict: Callable[[Any], bool],
             capacity: Optional[Callable[[], int]] = None) -> None:
    """Register (or re-register — idempotent by name) a managed cache."""
    with _lock:
        _caches[name] = _Managed(name, entries, evict, capacity)


def ttl_s() -> float:
    return max(0.0, knobs.get_float("PYRUHVRO_TPU_CACHE_TTL_S") or 0.0)


def _safe_entries(c: _Managed) -> List[tuple]:
    try:
        return list(c.entries())
    except Exception:
        metrics.inc("cache.hook_error")
        return []


def _evict_one(c: _Managed, key, cause: str) -> bool:
    schedtest.yp("cachelife.evict")
    try:
        ok = bool(c.evict(key))
    except Exception:
        metrics.inc("cache.hook_error")
        return False
    if ok:
        metrics.inc(f"cache.evict.{c.name}.{cause}")
        # pressure-relief evictions are operationally interesting (the
        # evictor is eating caches to save the process); TTL/capacity
        # churn is routine and would flood the event ring
        if cause == "pressure":
            from . import timeline

            timeline.event("cache.evict", severity="warn",
                           attrs={"cache": c.name, "cause": cause})
    return ok


def admit(name: str) -> int:
    """Admission control after an insert into cache ``name``: evict the
    least-recently-used entries past ``capacity()``. Returns the number
    evicted. Cheap when under cap (one enumeration)."""
    with _lock:
        c = _caches.get(name)
    if c is None or c.capacity is None:
        return 0
    try:
        cap = int(c.capacity() or 0)
    except Exception:
        metrics.inc("cache.hook_error")
        return 0
    if cap <= 0:
        return 0
    ents = _safe_entries(c)
    over = len(ents) - cap
    if over <= 0:
        return 0
    ents.sort(key=lambda e: e[1])  # oldest last_used first
    evicted = 0
    for key, _ts, _b in ents[:over]:
        if _evict_one(c, key, "lru"):
            evicted += 1
    return evicted


def sweep(now: float) -> int:
    """TTL pass over every managed cache: evict entries idle longer
    than ``PYRUHVRO_TPU_CACHE_TTL_S``. ``now`` is ``time.monotonic()``
    (passed in so tests can advance the clock). No-op when the TTL
    knob is 0."""
    ttl = ttl_s()
    if ttl <= 0:
        return 0
    with _lock:
        caches = list(_caches.values())
    evicted = 0
    for c in caches:
        for key, ts, _b in _safe_entries(c):
            if now - ts > ttl:
                if _evict_one(c, key, "ttl"):
                    evicted += 1
    return evicted


def relieve(overage_bytes: int) -> Tuple[int, int]:
    """Memory-pressure eviction: free at least ``overage_bytes`` of
    tracked cache footprint in global least-recently-used order across
    every managed cache. Returns ``(entries_evicted, bytes_freed)`` —
    best effort: stops early when the caches are empty."""
    with _lock:
        caches = list(_caches.values())
    pool: List[tuple] = []  # (last_used, cache, key, bytes)
    for c in caches:
        for key, ts, b in _safe_entries(c):
            pool.append((ts, c, key, float(b or 0.0)))
    pool.sort(key=lambda e: e[0])
    freed = 0.0
    evicted = 0
    for _ts, c, key, b in pool:
        if freed >= overage_bytes:
            break
        if _evict_one(c, key, "pressure"):
            evicted += 1
            freed += b
    return evicted, int(freed)


def snapshot_lifecycle() -> Dict[str, Any]:
    """Per-cache live-entry/byte/capacity summary (the ``lifecycle``
    half of ``snapshot()["memory"]``)."""
    with _lock:
        caches = list(_caches.values())
    out: Dict[str, Any] = {}
    for c in caches:
        ents = _safe_entries(c)
        cap = 0
        if c.capacity is not None:
            try:
                cap = int(c.capacity() or 0)
            except Exception:
                cap = 0
        out[c.name] = {
            "entries": len(ents),
            "bytes": int(sum(float(b or 0.0) for _k, _t, b in ents)),
            "capacity": cap,
        }
    return out


def reset() -> None:
    """Test isolation: registrations are module wiring and survive (the
    registering modules only run once per process); there is no other
    state to clear."""
    return None
