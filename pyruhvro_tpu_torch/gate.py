"""Schema gates (port of ``is_supported``, ``device_supported`` and
``host_supported``, ``pyruhvro_tpu/gate.py:31-36, 88-115``).

:func:`is_supported` is upstream's fast subset
(``fast_decode.rs:38-61``), exactly as the reference keeps it for parity
documentation, with a table of its own (``_FAST_LOGICAL``): it gates
nothing in the port.

The device walk covers upstream's full type surface: its fast subset
(``fast_decode.rs:38-61``: record top level; null/boolean/int/long/
float/double/string; date and timestamp-millis/micros; enum, record,
union, array, map) plus bytes, fixed (incl. duration and decimals up to
decimal128), uuid, time-* and local-timestamp-*. That is exactly the
reference's native host VM subset (its fast subset plus
``_HOST_EXTRA_LOGICAL``), so in the port :func:`host_supported` and
:func:`device_supported` are one predicate: the schemas outside it —
fixed decimals over 16 bytes, bytes decimals over precision 38 — go to
the pure-Python oracle.
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

__all__ = ["is_supported", "device_supported", "host_supported"]

# upstream's fast subset (the reference's ``_SUPPORTED_LOGICAL``)
_FAST_LOGICAL = {
    None: ("null", "boolean", "int", "long", "float", "double", "string"),
    "date": ("int",),
    "timestamp-millis": ("long",),
    "timestamp-micros": ("long",),
}

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


def _fast(t: AvroType) -> bool:
    if isinstance(t, Primitive):
        allowed = _FAST_LOGICAL.get(t.logical)
        return allowed is not None and t.name in allowed
    if isinstance(t, Enum):
        return True
    if isinstance(t, Record):
        return all(_fast(f.type) for f in t.fields)
    if isinstance(t, Union):
        return all(_fast(v) for v in t.variants)
    if isinstance(t, Array):
        return _fast(t.items)
    if isinstance(t, Map):
        return _fast(t.values)
    return False  # fixed (incl. decimal and duration), unknown


def is_supported(t: AvroType) -> bool:
    """True if the top-level schema is in upstream's fast subset
    (``fast_decode.rs:38-61``): a record of null/boolean/int/long/
    float/double/string, date and timestamp-millis/micros, enum,
    record, union, array and map."""
    return isinstance(t, Record) and _fast(t)


def device_supported(t: AvroType) -> bool:
    """True if the device decode walk can handle this top-level schema."""
    return isinstance(t, Record) and _inner(t)


def host_supported(t: AvroType) -> bool:
    """True if the native host VM can handle this top-level schema: the
    device walk's subset (module docstring)."""
    return device_supported(t)
