"""Avro schema IR, parser, Arrow mapping and cache (counterpart of
``pyruhvro_tpu/schema/``)."""

from .model import (
    Array,
    AvroType,
    Enum,
    Fixed,
    Map,
    Primitive,
    Record,
    RecordField,
    Union,
)
from .parser import SchemaParseError, parse_schema
from .arrow_map import to_arrow_schema, to_arrow_field
from .cache import SchemaEntry, get_or_parse_schema

__all__ = [
    "Array",
    "AvroType",
    "Enum",
    "Fixed",
    "Map",
    "Primitive",
    "Record",
    "RecordField",
    "Union",
    "SchemaParseError",
    "parse_schema",
    "to_arrow_schema",
    "to_arrow_field",
    "SchemaEntry",
    "get_or_parse_schema",
]
