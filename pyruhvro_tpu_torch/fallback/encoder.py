"""The host oracle's encoder: Arrow → Avro in pure Python (copy of
``pyruhvro_tpu/fallback/encoder.py``).

The analogue of upstream's fallback serializer
(``ruhvro/src/serialization_containers.rs``): walks Arrow arrays
column-wise into per-row Python values (cursor-style, ≙ ``ContainerIter``),
then writes each row as one Avro datum. It serves ``backend="host"``
encodes (``api.py``), and its writers generate the test data
(``utils/datagen.py``). Upstream's semantics preserved:

* name-based column matching with a missing-column error
  (``serialization_containers.rs:248-267``)
* nullable fields encode as the original union with the correct null
  branch index (``NullInfo``, ``:364-396``)
* N-variant unions take the branch from the Arrow type_ids buffer
  (``:399-513``)
* arrays/maps emit the single-block form ``[count, items..., 0]``; empty
  emits just ``0`` (≙ ``fast_encode.rs:518-554``)
* enums encode the symbol's index; unknown symbols error
  (``fast_encode.rs:356-362``)
"""

from __future__ import annotations

import decimal
import uuid as _uuid
from typing import List

import numpy as np
import pyarrow as pa

from ..schema.arrow_map import to_arrow_field
from ..schema.model import (
    Array,
    AvroType,
    Enum,
    Fixed,
    Map,
    Primitive,
    Record,
    Union,
)
from .io import (
    write_bool,
    write_bytes,
    write_double,
    write_float,
    write_long,
)

__all__ = ["encode_record_batch", "extract_rows", "compile_writer",
           "compile_encoder_plan"]


# ---------------------------------------------------------------------------
# Arrow arrays → per-row value trees (same conventions as decoder.py)
# ---------------------------------------------------------------------------

def extract_rows(arr: pa.Array, t: AvroType) -> List[object]:
    """Decompose an Arrow array into the decoder's value-tree convention."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()

    if isinstance(t, Union) and t.is_nullable_pair:
        null_idx = t.null_index
        val_idx = 1 - null_idx
        inner = extract_rows(arr, t.non_null_variant)
        return [
            None if v is None else (val_idx, v) for v in inner
        ]

    if isinstance(t, Union):
        type_ids = np.frombuffer(
            arr.buffers()[1], np.int8, count=len(arr) + arr.offset
        )[arr.offset :]
        children_rows = [
            extract_rows(arr.field(i), vt) for i, vt in enumerate(t.variants)
        ]
        out = []
        for i in range(len(arr)):
            tid = int(type_ids[i])
            if not 0 <= tid < len(children_rows):
                raise ValueError(f"union type_id {tid} out of range")
            out.append((tid, children_rows[tid][i]))
        return out

    if isinstance(t, Record):
        validity = _validity(arr)
        children = [
            extract_rows(arr.field(i), f.type) for i, f in enumerate(t.fields)
        ]
        names = [f.name for f in t.fields]
        out = []
        for i in range(len(arr)):
            if validity is not None and not validity[i]:
                out.append(None)
            else:
                out.append({n: c[i] for n, c in zip(names, children)})
        return out

    if isinstance(t, Array):
        lists = arr.to_pylist() if _is_simple(t.items) else None
        if lists is not None:
            return lists
        validity = _validity(arr)
        offsets = arr.offsets.to_pylist()
        child = extract_rows(arr.values, t.items)
        out = []
        for i in range(len(arr)):
            if validity is not None and not validity[i]:
                out.append(None)
            else:
                out.append(child[offsets[i] : offsets[i + 1]])
        return out

    if isinstance(t, Map):
        validity = _validity(arr)
        offsets = arr.offsets.to_pylist()
        keys = arr.keys.to_pylist()
        vals = extract_rows(arr.items, t.values)
        out = []
        for i in range(len(arr)):
            if validity is not None and not validity[i]:
                out.append(None)
            else:
                out.append(
                    list(zip(keys[offsets[i] : offsets[i + 1]],
                             vals[offsets[i] : offsets[i + 1]]))
                )
        return out

    if isinstance(t, Primitive) and t.logical == "decimal":
        return [None if v is None else _unscaled(v, t.scale) for v in arr.to_pylist()]
    if isinstance(t, Fixed) and t.logical == "decimal":
        return [None if v is None else _unscaled(v, t.scale) for v in arr.to_pylist()]
    if isinstance(t, Primitive) and t.logical == "uuid":
        return [
            None if v is None else str(_uuid.UUID(bytes=v)) for v in arr.to_pylist()
        ]
    if isinstance(t, Fixed) and t.logical == "duration":
        def from_ms(ms):
            if ms is None:
                return None
            days, ms = divmod(ms, 86_400_000)
            months, days = divmod(days, 30)
            return (
                int(months).to_bytes(4, "little")
                + int(days).to_bytes(4, "little")
                + int(ms).to_bytes(4, "little")
            )
        vals = arr.cast(pa.int64()).to_pylist()
        return [from_ms(v) for v in vals]

    if (
        isinstance(t, Primitive)
        and t.logical in ("timestamp-millis", "timestamp-micros",
                          "local-timestamp-millis", "local-timestamp-micros",
                          "time-millis", "time-micros", "date")
    ):
        # pylist gives datetime objects; go through the raw integers instead
        target = pa.int32() if t.name == "int" else pa.int64()
        return arr.cast(target).to_pylist()

    return arr.to_pylist()


def _validity(arr: pa.Array):
    if arr.null_count == 0:
        return None
    return np.asarray(arr.is_valid())


def _is_simple(t: AvroType) -> bool:
    return isinstance(t, (Primitive, Enum)) and getattr(t, "logical", None) is None


# exact context for decimal128: the default context's prec=28 would silently
# round values with 29-38 significant digits (upstream's i128 path is exact)
_DEC_CTX = decimal.Context(prec=76)


def _unscaled(v, scale: int) -> int:
    return int(v.scaleb(scale, _DEC_CTX).to_integral_value())


# ---------------------------------------------------------------------------
# Value trees → wire bytes
# ---------------------------------------------------------------------------

def compile_writer(t: AvroType):
    """Build a ``writer(out: bytearray, value)`` closure for ``t``.

    Every non-union writer rejects ``None`` with a clear error (unions
    route nulls to their null branch; bare nulls elsewhere are a schema
    violation the wire format cannot express)."""
    w = _compile_writer(t)
    if isinstance(t, Union) or (isinstance(t, Primitive) and t.name == "null"):
        return w
    what = type(t).__name__.lower()
    if isinstance(t, Primitive):
        what = t.logical or t.name
    return _non_null(w, what)


def _compile_writer(t: AvroType):
    if isinstance(t, Primitive):
        name = t.name
        if name == "null":
            return lambda out, v: None
        if name == "boolean":
            return write_bool
        if name in ("int", "long"):
            return write_long
        if name == "float":
            return write_float
        if name == "double":
            return write_double
        if name == "bytes":
            if t.logical == "decimal":
                def write_decimal(out, v):
                    n = max((int(v).bit_length() + 8) // 8, 1)
                    write_bytes(out, int(v).to_bytes(n, "big", signed=True))
                return write_decimal
            return write_bytes
        if name == "string":
            return lambda out, v: write_bytes(out, v.encode("utf-8"))
        raise NotImplementedError(name)

    if isinstance(t, Fixed):
        size = t.size
        if t.logical == "decimal":
            def write_fixed_decimal(out, v):
                out += int(v).to_bytes(size, "big", signed=True)
            return write_fixed_decimal
        def write_fixed(out, v):
            if len(v) != size:
                raise ValueError(f"fixed size mismatch: {len(v)} != {size}")
            out += v
        return write_fixed

    if isinstance(t, Enum):
        index = {s: i for i, s in enumerate(t.symbols)}
        def write_enum(out, v):
            try:
                write_long(out, index[v])
            except KeyError:
                raise ValueError(
                    f"value {v!r} is not a symbol of enum {t.fullname}"
                ) from None
        return write_enum

    if isinstance(t, Array):
        item_writer = compile_writer(t.items)
        def write_array(out, v):
            if v:
                write_long(out, len(v))
                for item in v:
                    item_writer(out, item)
            write_long(out, 0)
        return write_array

    if isinstance(t, Map):
        value_writer = compile_writer(t.values)
        def write_map(out, v):
            if v:
                write_long(out, len(v))
                for k, item in v:
                    write_bytes(out, k.encode("utf-8"))
                    value_writer(out, item)
            write_long(out, 0)
        return write_map

    if isinstance(t, Union):
        writers = tuple(compile_writer(v) for v in t.variants)
        null_idx = t.null_index
        def write_union(out, v):
            if v is None:
                if null_idx is None:
                    raise ValueError("null value for union without null variant")
                write_long(out, null_idx)
                return
            idx, inner = v
            write_long(out, idx)
            writers[idx](out, inner)
        return write_union

    if isinstance(t, Record):
        field_writers = tuple((f.name, compile_writer(f.type)) for f in t.fields)
        def write_record(out, v):
            for name, w in field_writers:
                try:
                    fv = v[name]
                except KeyError:
                    raise ValueError(f"row missing record field {name!r}") from None
                w(out, fv)
        return write_record

    raise NotImplementedError(f"no writer for {t!r}")


def _types_compatible(actual: pa.DataType, expected: pa.DataType) -> bool:
    """Structural type equality ignoring *container child* field names, so
    e.g. a list child named "element" (Parquet convention) matches the
    expected "item". Struct children still match by name — record fields
    are name-matched, like upstream (``serialization_containers.rs:248-267``)."""
    if actual.equals(expected):
        return True
    if pa.types.is_list(actual) and pa.types.is_list(expected):
        return _types_compatible(actual.value_type, expected.value_type)
    if pa.types.is_map(actual) and pa.types.is_map(expected):
        return _types_compatible(
            actual.key_type, expected.key_type
        ) and _types_compatible(actual.item_type, expected.item_type)
    if pa.types.is_struct(actual) and pa.types.is_struct(expected):
        if actual.num_fields != expected.num_fields:
            return False
        return all(
            actual.field(i).name == expected.field(i).name
            and _types_compatible(actual.field(i).type, expected.field(i).type)
            for i in range(actual.num_fields)
        )
    if pa.types.is_union(actual) and pa.types.is_union(expected):
        if actual.mode != expected.mode:
            # dense vs sparse changes child indexing; extract_rows assumes sparse
            return False
        if actual.num_fields != expected.num_fields or list(
            actual.type_codes
        ) != list(expected.type_codes):
            return False
        return all(
            _types_compatible(actual.field(i).type, expected.field(i).type)
            for i in range(actual.num_fields)
        )
    return False


def _non_null(writer, what: str):
    """Nulls are representable only under a union with a null variant; the
    lenient type check admits nullable child fields (Parquet-style batches),
    so a null in a non-nullable Avro position must fail with a clear error
    rather than a crash deep in a wire writer."""
    def checked(out, v):
        if v is None:
            raise ValueError(
                f"null value for non-nullable Avro {what} "
                f"(no null union at this position in the schema)"
            )
        writer(out, v)
    return checked


def compile_encoder_plan(t: Record) -> List[tuple]:
    """Schema-only work of :func:`encode_record_batch`, computed once per
    schema and reusable across chunks/calls (cache it via
    ``SchemaEntry.get_extra``): per field
    ``(name, expected_arrow_type, avro_type, writer)``."""
    if not isinstance(t, Record):
        raise ValueError("top-level Avro schema must be a record")
    return [
        (f.name, to_arrow_field(f.type, name=f.name, nullable=False).type,
         f.type, compile_writer(f.type))
        for f in t.fields
    ]


def encode_record_batch(
    batch: pa.RecordBatch, t: Record, plan: List[tuple] = None
) -> List[bytes]:
    """Encode every row of ``batch`` as one Avro datum
    (≙ ``serialization_containers::serialize``, ``:13-22``).

    Columns are matched by name; a missing column is an error
    (``:248-267``). Extra columns in the batch are ignored.
    """
    if plan is None:
        plan = compile_encoder_plan(t)
    n = batch.num_rows
    cols = []
    for name, expected_type, ftype, writer in plan:
        idx = batch.schema.get_field_index(name)
        if idx == -1:
            raise ValueError(
                f"record batch is missing column {name!r} required by schema"
            )
        actual = batch.schema.field(idx).type
        if not _types_compatible(actual, expected_type):
            raise ValueError(
                f"column {name!r} has Arrow type {actual}, but the Avro "
                f"schema requires {expected_type}"
            )
        cols.append((name, extract_rows(batch.column(idx), ftype), writer))
    out: List[bytes] = []
    for i in range(n):
        buf = bytearray()
        for name, rows, writer in cols:
            try:
                writer(buf, rows[i])
            except ValueError as e:
                raise ValueError(f"column {name!r}, row {i}: {e}") from None
        out.append(bytes(buf))
    return out
