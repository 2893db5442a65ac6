"""Avro IR → Arrow (pyarrow) schema translation (copy of
``pyruhvro_tpu/schema/arrow_map.py``).

This mirrors the reference's type-mapping source of truth,
``ruhvro/src/schema_translate.rs`` (itself adapted from DataFusion),
rule for rule — including its quirks, so that a user switching from the
reference sees identical Arrow schemas:

* int→Int32, long→Int64, bytes→Binary, string→Utf8 (``:53-59``)
* array→List with a nullable child field named "item" (``:60-65``)
* map→Map(entries: Struct{keys: non-null Utf8, values: non-null V}) (``:66-75``)
* ``["null", T]`` 2-variant union → nullable field of T (``:76-93``)
* N-variant union → sparse Union, type_ids 0..N-1, children named by the
  DataFusion default-name table, each nullable (``:94-104``)
* record→Struct; child fields INHERIT the parent field's nullability
  (the reference passes its ``nullable`` flag down, ``:106-123``)
* enum→Utf8, field named after the Avro field, else the enum fullname
  (``:124-132``)
* fixed→FixedSizeBinary, decimal→Decimal128, uuid→FixedSizeBinary(16),
  date→Date32, time-millis/micros→Time32/64, timestamp-→Timestamp,
  duration→Duration(ms) (``:133-143``)
* ``avro::doc`` / ``avro::aliases`` metadata preservation (``:222-266``):
  top-level fields carry the *type's* doc/aliases; nested record fields
  carry the *field's* doc.
"""

from __future__ import annotations

from typing import Dict, Optional

import pyarrow as pa

from .model import (
    Array,
    AvroType,
    Enum,
    Fixed,
    Map,
    Primitive,
    Record,
    Union,
)

__all__ = ["to_arrow_schema", "to_arrow_field", "default_field_name"]


_PRIMITIVE_ARROW = {
    "null": pa.null(),
    "boolean": pa.bool_(),
    "int": pa.int32(),
    "long": pa.int64(),
    "float": pa.float32(),
    "double": pa.float64(),
    "bytes": pa.binary(),
    "string": pa.string(),
}

_LOGICAL_ARROW = {
    "date": pa.date32(),
    "time-millis": pa.time32("ms"),
    "time-micros": pa.time64("us"),
    "timestamp-millis": pa.timestamp("ms"),
    "timestamp-micros": pa.timestamp("us"),
    "local-timestamp-millis": pa.timestamp("ms"),
    "local-timestamp-micros": pa.timestamp("us"),
    "uuid": pa.binary(16),
}


def default_field_name(dt: pa.DataType) -> str:
    """DataFusion's default field name per datatype
    (``schema_translate.rs:158-220``); used for unnamed union children."""
    if pa.types.is_null(dt):
        return "null"
    if pa.types.is_boolean(dt):
        return "bit"
    if pa.types.is_int32(dt):
        return "int"
    if pa.types.is_int64(dt):
        return "bigint"
    if pa.types.is_float32(dt):
        return "float4"
    if pa.types.is_float64(dt):
        return "float8"
    if pa.types.is_date32(dt):
        return "dateday"
    if pa.types.is_time32(dt) or pa.types.is_time64(dt):
        return {
            "s": "timesec",
            "ms": "timemilli",
            "us": "timemicro",
            "ns": "timenano",
        }[dt.unit]
    if pa.types.is_timestamp(dt):
        suffix = "tz" if dt.tz is not None else ""
        return {
            "s": "timestampsec",
            "ms": "timestampmilli",
            "us": "timestampmicro",
            "ns": "timestampnano",
        }[dt.unit] + suffix
    if pa.types.is_duration(dt):
        return "duration"
    if pa.types.is_fixed_size_binary(dt):
        return "fixedsizebinary"
    if pa.types.is_binary(dt):
        return "varbinary"
    if pa.types.is_string(dt):
        return "varchar"
    if pa.types.is_list(dt):
        return "list"
    if pa.types.is_struct(dt):
        return "struct"
    if pa.types.is_union(dt):
        return "union"
    if pa.types.is_decimal(dt):
        return "decimal"
    raise NotImplementedError(f"no default field name for {dt}")


def to_arrow_schema(schema: AvroType) -> pa.Schema:
    """Translate a parsed Avro schema to a ``pyarrow.Schema``
    (≙ ``schema_translate.rs:19-41``)."""
    if isinstance(schema, Record):
        fields = [
            to_arrow_field(
                f.type, name=f.name, nullable=False, props=_external_props(f.type)
            )
            for f in schema.fields
        ]
        return pa.schema(fields)
    return pa.schema([to_arrow_field(schema, name="", nullable=False)])


def _external_props(t: AvroType) -> Dict[str, str]:
    """Doc/alias metadata of a *named type* (``schema_translate.rs:222-266``)."""
    props: Dict[str, str] = {}
    doc = getattr(t, "doc", None)
    if doc:
        props["avro::doc"] = doc
    aliases = getattr(t, "aliases", ())
    if aliases:
        ns = None
        fullname = getattr(t, "fullname", "")
        if "." in fullname:
            ns = fullname.rsplit(".", 1)[0]
        resolved = [a if "." in a or not ns else f"{ns}.{a}" for a in aliases]
        props["avro::aliases"] = "[" + ",".join(resolved) + "]"
    return props


def to_arrow_field(
    t: AvroType,
    name: Optional[str] = None,
    nullable: bool = False,
    props: Optional[Dict[str, str]] = None,
) -> pa.Field:
    """≙ ``schema_to_field_with_props`` (``schema_translate.rs:43-157``)."""
    dt: pa.DataType

    if isinstance(t, Primitive):
        if t.logical == "decimal":
            dt = pa.decimal128(t.precision, t.scale)
        elif t.logical is not None:
            dt = _LOGICAL_ARROW[t.logical]
        else:
            dt = _PRIMITIVE_ARROW[t.name]
    elif isinstance(t, Fixed):
        if t.logical == "decimal":
            dt = pa.decimal128(t.precision, t.scale)
        elif t.logical == "duration":
            dt = pa.duration("ms")
        else:
            dt = pa.binary(t.size)
    elif isinstance(t, Enum):
        # enum → Utf8; name defaults to the enum's fullname (:124-132)
        field_name = name if name else t.fullname
        return pa.field(field_name, pa.string(), nullable, props or None)
    elif isinstance(t, Array):
        item = to_arrow_field(t.items, name="item", nullable=True)
        dt = pa.list_(item)
    elif isinstance(t, Map):
        key = pa.field("keys", pa.string(), nullable=False)
        value = to_arrow_field(t.values, name="values", nullable=False)
        dt = pa.map_(key, value)
    elif isinstance(t, Union):
        if t.is_nullable_pair:
            inner = to_arrow_field(t.non_null_variant, name=name, nullable=True)
            return pa.field(
                name if name is not None else inner.name,
                inner.type,
                True,
                props or None,
            )
        nullable = nullable or (t.null_index is not None)
        children = [
            to_arrow_field(v, name=None, nullable=True) for v in t.variants
        ]
        dt = pa.union(children, mode="sparse", type_codes=list(range(len(children))))
    elif isinstance(t, Record):
        # NOTE reference quirk: child fields inherit the parent's `nullable`
        # flag (schema_translate.rs:106-123).
        children = []
        for f in t.fields:
            child_props = {"avro::doc": f.doc} if f.doc else None
            children.append(
                to_arrow_field(f.type, name=f.name, nullable=nullable, props=child_props)
            )
        dt = pa.struct(children)
    else:
        raise NotImplementedError(f"cannot map {t!r} to Arrow")

    if name is None or name == "":
        name = default_field_name(dt)
    return pa.field(name, dt, nullable, props or None)
