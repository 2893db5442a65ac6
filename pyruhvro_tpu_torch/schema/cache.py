"""Process-global schema cache (slim port of ``pyruhvro_tpu/schema/cache.py``).

≙ upstream's ``schema_cache``/``get_or_parse_schema`` (``src/lib.rs:35-54``):
a lock-guarded map keyed by the raw schema string. Each entry holds the
parsed IR, the translated Arrow schema and (through :meth:`get_extra`)
the per-schema codecs. The reference's lifecycle planes (LRU/TTL
eviction, memory accounting, telemetry) are not part of this slice.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Optional

import pyarrow as pa

from .arrow_map import to_arrow_schema
from .model import AvroType
from .parser import parse_schema

__all__ = ["SchemaEntry", "get_or_parse_schema"]


class SchemaEntry:
    """Everything derived from one schema string, computed once."""

    __slots__ = ("schema_str", "ir", "_arrow", "_lock", "_extras", "_fp")

    def __init__(self, schema_str: str, ir: AvroType):
        self.schema_str = schema_str
        self.ir = ir
        self._arrow: Optional[pa.Schema] = None
        # reentrant: a get_extra factory may itself read arrow_schema
        self._lock = threading.RLock()
        self._extras: Dict[str, object] = {}
        self._fp: Optional[str] = None

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
        with self._lock:
            if key not in self._extras:
                self._extras[key] = factory()
            return self._extras[key]


_cache: Dict[str, SchemaEntry] = {}  # guarded-by: _cache_lock
_cache_lock = threading.Lock()


def get_or_parse_schema(schema_str: str) -> SchemaEntry:
    """Return the cached entry for this exact schema string, parsing on
    first sight (double-checked, like ``src/lib.rs:44-54``)."""
    entry = _cache.get(schema_str)
    if entry is not None:
        return entry
    ir = parse_schema(schema_str)  # parse outside the lock; parsing is pure
    with _cache_lock:
        entry = _cache.get(schema_str)
        if entry is None:
            entry = SchemaEntry(schema_str, ir)
            _cache[schema_str] = entry
    return entry
