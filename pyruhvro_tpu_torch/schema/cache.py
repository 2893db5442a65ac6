"""Process-global schema cache (port of ``pyruhvro_tpu/schema/cache.py``,
its lifecycle included).

≙ upstream's ``schema_cache``/``get_or_parse_schema`` (``src/lib.rs:35-54``):
a lock-guarded map keyed by the raw schema string. Each entry holds the
parsed IR, the translated Arrow schema and (through :meth:`get_extra`)
the per-schema codecs. The cache is lifecycle-managed as in the
reference: every hit stamps ``last_used``, an insert runs admission
control (``PYRUHVRO_TPU_CACHE_MAX_SCHEMAS``, LRU), idle entries age out
under ``PYRUHVRO_TPU_CACHE_TTL_S`` and memory pressure evicts in global
LRU order (:mod:`..runtime.cachelife`). An evicted entry takes its
device codec (decoder and encoder) and host codecs with it; everything
it held derives from the schema string, so the next call re-parses and
rebuilds it bit for bit. ``schema_cache.hits`` / ``.misses`` /
``.evictions`` and the ``schema_cache.parse_s`` histogram count it; the
``cache.schema`` probe of :mod:`..runtime.memacct` reports its bytes.
The ``schema_cache.get`` / ``.insert`` / ``.memo`` / ``.evict`` yield
points of :mod:`..runtime.schedtest` are the reference's.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, Optional

import pyarrow as pa

from ..runtime import cachelife, knobs, memacct, metrics, schedtest, telemetry
from .arrow_map import to_arrow_schema
from .model import AvroType
from .parser import parse_schema

__all__ = ["SchemaEntry", "get_or_parse_schema", "clear_schema_cache"]

# the program arrays an extra may hold: the native host codec's
# (``prog.ops`` / ``prog.coltypes``) and the device decoder's and
# encoder's field programs (``prog.code``)
_PROGRAM_ARRAYS = ("ops", "coltypes", "code")


def _programs(val):
    """The lowered programs an extra holds: its own ``prog`` (the native
    host codec), and a device codec's decoder's and encoder's."""
    for holder in (val, getattr(val, "decoder", None),
                   getattr(val, "_encoder", None)):
        prog = getattr(holder, "prog", None)
        if prog is not None:
            yield prog


class SchemaEntry:
    """Everything derived from one schema string, computed once."""

    __slots__ = ("schema_str", "ir", "_arrow", "_lock", "_extras", "_fp",
                 "last_used", "_fpb")

    def __init__(self, schema_str: str, ir: AvroType):
        self.schema_str = schema_str
        self.ir = ir
        self._arrow: Optional[pa.Schema] = None
        # reentrant: a get_extra factory may itself read arrow_schema
        self._lock = threading.RLock()
        self._extras: Dict[str, object] = {}
        self._fp: Optional[str] = None
        # the lifecycle's LRU clock, stamped on every hit (a float store
        # is atomic under the interpreter lock)
        self.last_used: float = time.monotonic()
        # the footprint, memoized until the next extra lands: admission
        # enumerates every entry per insert
        self._fpb: Optional[int] = None

    @property
    def fingerprint(self) -> str:
        """Short stable id for this schema string."""
        if self._fp is None:
            self._fp = hashlib.sha1(self.schema_str.encode()).hexdigest()[:12]
        return self._fp

    @property
    def arrow_schema(self) -> pa.Schema:
        if self._arrow is None:
            with self._lock:
                if self._arrow is None:
                    self._arrow = to_arrow_schema(self.ir)
        return self._arrow

    def get_extra(self, key: str, factory):
        """Lazily build and memoize a per-schema derived object."""
        try:
            return self._extras[key]
        except KeyError:
            pass
        schedtest.yp("schema_cache.memo")
        with self._lock:
            if key not in self._extras:
                self._extras[key] = factory()
                self._fpb = None  # the footprint memo is stale now
            return self._extras[key]

    def footprint_bytes(self) -> int:
        """Approximate host bytes this entry pins: the schema text, parsed
        IR and Arrow schema (estimated as a multiple of the text, as in
        the reference), 128 bytes a memoized extra, the program arrays
        of its codecs (the native host codec's op and column tables, the
        device decoder's and encoder's field programs; exact) and the
        oracle's compiled closures (estimated). Buckets, arenas and
        kernel libraries are counted by their own planes
        (``cache.executables``, ``cache.arenas``, ``cache.kernels``),
        never twice. Memoized until the next :meth:`get_extra` insert."""
        fpb = self._fpb
        if fpb is not None:
            return fpb
        n = len(self.schema_str) * 4 + 512
        with self._lock:
            extras = list(self._extras.items())
        for key, val in extras:
            n += 128  # dict slot + memo object overhead
            for prog in _programs(val):
                for arr_name in _PROGRAM_ARRAYS:
                    nbytes = getattr(getattr(prog, arr_name, None),
                                     "nbytes", None)
                    if nbytes:
                        n += int(nbytes)
            if key in ("host_reader", "host_encode_plan"):
                n += len(self.schema_str) * 2  # compiled-closure estimate
        self._fpb = n
        return n


_cache: Dict[str, SchemaEntry] = {}  # guarded-by: _cache_lock
_cache_lock = threading.Lock()


def get_or_parse_schema(schema_str: str) -> SchemaEntry:
    """Return the cached entry for this exact schema string, parsing on
    first sight (double-checked, like ``src/lib.rs:44-54``)."""
    entry = _cache.get(schema_str)
    if entry is not None:
        metrics.inc("schema_cache.hits")
        schedtest.yp("schema_cache.get")
        entry.last_used = time.monotonic()
        return entry
    metrics.inc("schema_cache.misses")
    t0 = time.perf_counter()
    ir = parse_schema(schema_str)  # parse outside the lock; parsing is pure
    telemetry.observe("schema_cache.parse_s", time.perf_counter() - t0)
    schedtest.yp("schema_cache.insert")
    with _cache_lock:
        entry = _cache.get(schema_str)
        if entry is None:
            entry = SchemaEntry(schema_str, ir)
            _cache[schema_str] = entry
    # admission control outside the cache lock (eviction takes it)
    entry.last_used = time.monotonic()
    cachelife.admit("schema")
    return entry


def clear_schema_cache() -> None:
    with _cache_lock:
        _cache.clear()


# -- lifecycle and accounting ------------------------------------------------


def _lifecycle_entries():
    with _cache_lock:
        entries = list(_cache.items())
    return [(k, e.last_used, e.footprint_bytes()) for k, e in entries]


def _evict(key: str) -> bool:
    """Unlink one entry. Calls in flight hold their own reference and
    finish on it; the next ``get_or_parse_schema`` re-parses (a miss) and
    rebuilds every derived object bit for bit."""
    schedtest.yp("schema_cache.evict")
    with _cache_lock:
        gone = _cache.pop(key, None)
    if gone is None:
        return False
    metrics.inc("schema_cache.evictions")
    return True


cachelife.register(
    "schema",
    entries=_lifecycle_entries,
    evict=_evict,
    capacity=lambda: knobs.get_int("PYRUHVRO_TPU_CACHE_MAX_SCHEMAS"),
)


def _probe():
    with _cache_lock:
        entries = list(_cache.values())
    return {
        "bytes": float(sum(e.footprint_bytes() for e in entries)),
        "items": float(len(entries)),
    }


memacct.register_probe("cache.schema", _probe)
