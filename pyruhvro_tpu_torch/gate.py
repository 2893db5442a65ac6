"""Device decode gate (port of ``device_supported``, ``pyruhvro_tpu/gate.py:102``).

The device walk covers upstream's full type surface: its fast subset
(``fast_decode.rs:38-61``: record top level; null/boolean/int/long/
float/double/string; date and timestamp-millis/micros; enum, record,
union, array, map) plus bytes, fixed (incl. duration and decimals up to
decimal128), uuid, time-* and local-timestamp-*.
"""

from __future__ import annotations

from .schema.model import (
    Array,
    AvroType,
    Enum,
    Fixed,
    Map,
    Primitive,
    Record,
    Union,
)

__all__ = ["device_supported"]

_SUPPORTED_LOGICAL = {
    None: ("null", "boolean", "int", "long", "float", "double", "string",
           "bytes"),
    "date": ("int",),
    "timestamp-millis": ("long",),
    "timestamp-micros": ("long",),
    "time-millis": ("int",),
    "time-micros": ("long",),
    "local-timestamp-millis": ("long",),
    "local-timestamp-micros": ("long",),
}


def _inner(t: AvroType) -> bool:
    if isinstance(t, Primitive):
        if t.logical == "decimal":
            return t.name == "bytes" and t.precision <= 38
        if t.logical == "uuid":
            return t.name == "string"
        allowed = _SUPPORTED_LOGICAL.get(t.logical)
        return allowed is not None and t.name in allowed
    if isinstance(t, Enum):
        return True
    if isinstance(t, Record):
        return all(_inner(f.type) for f in t.fields)
    if isinstance(t, Union):
        return all(_inner(v) for v in t.variants)
    if isinstance(t, Array):
        return _inner(t.items)
    if isinstance(t, Map):
        return _inner(t.values)
    if isinstance(t, Fixed):
        if t.logical == "decimal":
            # size 0 can hold no value at all; wider than 16 bytes is
            # beyond decimal128
            return 1 <= t.size <= 16 and t.precision <= 38
        return t.logical in (None, "duration")
    return False


def device_supported(t: AvroType) -> bool:
    """True if the device decode walk can handle this top-level schema."""
    return isinstance(t, Record) and _inner(t)
