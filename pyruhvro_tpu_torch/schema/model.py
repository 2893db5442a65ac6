"""Avro schema IR (intermediate representation).

Copy of ``pyruhvro_tpu/schema/model.py`` (the port imports nothing of the
JAX package). A small, immutable tree of Python objects describing a
parsed Avro schema: the analogue of ``apache_avro::Schema`` in upstream
(consumed by ``ruhvro/src/schema_translate.rs`` and both codec paths). The
walk lowering (``ops/fieldprog.py``) wants a normalized,
logical-type-annotated tree rather than raw JSON.

Design notes
------------
* Logical types are *annotations* on an underlying primitive/fixed type
  (``Primitive.logical`` / ``Fixed.logical``), mirroring how the Avro spec
  layers them and how the reference models them as distinct
  ``AvroSchema::Date`` etc. variants (``schema_translate.rs:133-143``).
* Named-type references ("Ref") are resolved at parse time into shared
  object references — an improvement over the reference, whose translation
  layer has ``todo!()`` for refs (``schema_translate.rs:51``). Recursive
  schemas are detected and rejected (Arrow cannot represent them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = [
    "AvroType",
    "Primitive",
    "Fixed",
    "Enum",
    "Array",
    "Map",
    "Union",
    "RecordField",
    "Record",
    "PRIMITIVE_NAMES",
    "LOGICAL_ON_INT",
    "LOGICAL_ON_LONG",
]

PRIMITIVE_NAMES = (
    "null",
    "boolean",
    "int",
    "long",
    "float",
    "double",
    "bytes",
    "string",
)

# logical types recognized on each underlying primitive (Avro 1.11 spec)
LOGICAL_ON_INT = ("date", "time-millis")
LOGICAL_ON_LONG = (
    "time-micros",
    "timestamp-millis",
    "timestamp-micros",
    "local-timestamp-millis",
    "local-timestamp-micros",
)


class AvroType:
    """Base class for all IR nodes."""

    __slots__ = ()

    def is_null(self) -> bool:
        return isinstance(self, Primitive) and self.name == "null"


@dataclass(frozen=True)
class Primitive(AvroType):
    """A primitive type, optionally carrying a logical-type annotation.

    ``name`` is one of PRIMITIVE_NAMES. ``logical`` is e.g. ``"date"`` on
    int, ``"timestamp-millis"`` on long, ``"decimal"`` on bytes,
    ``"uuid"`` on string — or None.
    """

    name: str
    logical: Optional[str] = None
    # decimal parameters (only when logical == "decimal")
    precision: int = 0
    scale: int = 0


@dataclass(frozen=True)
class Fixed(AvroType):
    """Avro ``fixed`` named type; logical may be "decimal" or "duration"."""

    fullname: str
    size: int
    logical: Optional[str] = None
    precision: int = 0
    scale: int = 0


@dataclass(frozen=True)
class Enum(AvroType):
    fullname: str
    symbols: Tuple[str, ...]
    doc: Optional[str] = None


@dataclass(frozen=True)
class Array(AvroType):
    items: AvroType


@dataclass(frozen=True)
class Map(AvroType):
    values: AvroType


@dataclass(frozen=True)
class Union(AvroType):
    variants: Tuple[AvroType, ...]

    @property
    def null_index(self) -> Optional[int]:
        """Index of the null variant, or None."""
        for i, v in enumerate(self.variants):
            if v.is_null():
                return i
        return None

    @property
    def is_nullable_pair(self) -> bool:
        """True for the 2-variant ``["null", T]`` / ``[T, "null"]`` shape that
        collapses to a nullable Arrow field (``schema_translate.rs:76-93``)."""
        return len(self.variants) == 2 and self.null_index is not None

    @property
    def non_null_variant(self) -> AvroType:
        assert self.is_nullable_pair
        return self.variants[1 - self.null_index]


@dataclass(frozen=True)
class RecordField:
    name: str
    type: AvroType
    doc: Optional[str] = None
    has_default: bool = False
    default: object = None
    aliases: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Record(AvroType):
    fullname: str
    fields: Tuple[RecordField, ...]
    doc: Optional[str] = None
    aliases: Tuple[str, ...] = ()
