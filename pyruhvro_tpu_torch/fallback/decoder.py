"""The host oracle's decoder: Avro → Arrow in pure Python (copy of
``pyruhvro_tpu/fallback/decoder.py``).

The analogue of upstream's ``Value``-tree baseline path
(``ruhvro/src/deserialize.rs:34-48`` + ``ruhvro/src/complex.rs``). It
covers the full Avro type surface and is the differential oracle the
device tier is held against. In the port it serves ``backend="host"``,
the per-record last resort of the tolerant policies (``api.py``) and the
device decoder's cap sampling (``ops/decode.py``
``seed_caps_from_sample``).

Two stages, mirroring upstream:
1. per-datum wire decode into a Python value tree
   (≙ ``apache_avro::from_avro_datum`` → ``Value``), via per-schema
   compiled reader closures;
2. value-tree → Arrow builders (≙ ``complex.rs`` ``AvroToArrowBuilder``),
   finished into a ``pyarrow.RecordBatch``.

Value-tree conventions: null→None, record→dict, array→list,
map→list[(key, value)], union→(branch_index, value), enum→symbol str,
decimal→unscaled int.
"""

from __future__ import annotations

import decimal
import threading
import uuid as _uuid
from typing import Callable, List, Sequence, Tuple

import numpy as np
import pyarrow as pa

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
from ..runtime import knobs
from ..schema.arrow_map import to_arrow_schema
from .io import (
    MAX_ZERO_WIDTH_ITEMS,
    MalformedAvro,
    max_datum_bytes,
    read_bool,
    read_bytes,
    read_double,
    read_float,
    read_long,
)

__all__ = [
    "compile_reader",
    "decode_records",
    "decode_records_tolerant",
    "decode_pairs_tolerant",
    "rows_to_record_batch",
    "MalformedAvro",
]


# ---------------------------------------------------------------------------
# Stage 1: wire bytes → value tree
# ---------------------------------------------------------------------------

# Hostile-input guard: the walker's recursion depth is bounded by the
# SCHEMA's nesting depth (the parser rejects recursive schemas), so the
# cap is enforced once at compile time rather than per datum. Default 64
# levels (``runtime/knobs.py``); PYRUHVRO_TPU_MAX_DEPTH overrides.


def _max_depth() -> int:
    return knobs.get_int("PYRUHVRO_TPU_MAX_DEPTH")


# per-thread budget of zero-width array/map items for the datum being
# decoded (reset per datum by decode_records / decode_records_tolerant):
# null / empty-record items consume no wire bytes, so a claimed block
# count is the ONE quantity the remaining-bytes bound cannot limit
_zw_tls = threading.local()


def _reset_zw_budget() -> None:
    _zw_tls.budget = MAX_ZERO_WIDTH_ITEMS


def _charge_zero_width(count: int) -> None:
    left = getattr(_zw_tls, "budget", MAX_ZERO_WIDTH_ITEMS) - count
    _zw_tls.budget = left
    if left < 0:
        raise MalformedAvro(
            f"block claims more zero-width items than the per-datum cap "
            f"({MAX_ZERO_WIDTH_ITEMS})",
            err_name="zero_width_items",
        )


def compile_reader(t: AvroType, _depth: int = 0) -> Callable:
    """Build a ``reader(buf, pos) -> (value, pos)`` closure for ``t``."""
    if _depth > _max_depth():
        raise ValueError(
            f"schema nesting depth exceeds the walker cap "
            f"({_max_depth()}; PYRUHVRO_TPU_MAX_DEPTH overrides)"
        )
    if isinstance(t, Primitive):
        name = t.name
        if name == "null":
            return lambda buf, pos: (None, pos)
        if name == "boolean":
            return read_bool
        if name in ("int", "long"):
            if t.logical == "decimal":  # bytes-decimal handled under bytes
                raise NotImplementedError
            return read_long
        if name == "float":
            return read_float
        if name == "double":
            return read_double
        if name == "bytes":
            if t.logical == "decimal":
                def read_decimal(buf, pos):
                    raw, pos = read_bytes(buf, pos)
                    return int.from_bytes(raw, "big", signed=True), pos
                return read_decimal
            return read_bytes
        if name == "string":
            def read_string(buf, pos):
                raw, pos = read_bytes(buf, pos)
                try:
                    return raw.decode("utf-8"), pos
                except UnicodeDecodeError as e:
                    raise MalformedAvro(f"invalid UTF-8 in string: {e}",
                                        err_name="bad_utf8") from None
            return read_string
        raise NotImplementedError(name)

    if isinstance(t, Fixed):
        size = t.size
        if t.logical == "decimal":
            def read_fixed_decimal(buf, pos):
                if pos + size > len(buf):
                    raise MalformedAvro("truncated fixed", err_name="overrun")
                return (
                    int.from_bytes(buf[pos : pos + size], "big", signed=True),
                    pos + size,
                )
            return read_fixed_decimal

        def read_fixed(buf, pos):
            if pos + size > len(buf):
                raise MalformedAvro("truncated fixed", err_name="overrun")
            return bytes(buf[pos : pos + size]), pos + size
        return read_fixed

    if isinstance(t, Enum):
        symbols = t.symbols
        n = len(symbols)
        def read_enum(buf, pos):
            idx, pos = read_long(buf, pos)
            if not 0 <= idx < n:
                raise MalformedAvro(f"enum index {idx} out of range 0..{n}",
                                    err_name="bad_enum")
            return symbols[idx], pos
        return read_enum

    if isinstance(t, Array):
        item_reader = compile_reader(t.items, _depth + 1)
        def read_array(buf, pos):
            out = []
            while True:
                count, pos = read_long(buf, pos)
                if count == 0:
                    return out, pos
                if count < 0:
                    # negative block count: abs(count) items preceded by a
                    # byte-size long we can skip over (fast_decode.rs:689-700)
                    count = -count
                    _, pos = read_long(buf, pos)
                for k in range(count):
                    prev = pos
                    v, pos = item_reader(buf, pos)
                    out.append(v)
                    if k == 0 and pos == prev:
                        # zero-width items (null / empty record): the
                        # claimed count is unbounded by remaining bytes —
                        # charge it against the per-datum budget before
                        # materializing (hostile-input cap)
                        _charge_zero_width(count)
        return read_array

    if isinstance(t, Map):
        value_reader = compile_reader(t.values, _depth + 1)
        def read_map(buf, pos):
            out = []
            while True:
                count, pos = read_long(buf, pos)
                if count == 0:
                    return out, pos
                if count < 0:
                    count = -count
                    _, pos = read_long(buf, pos)
                for _ in range(count):
                    raw, pos = read_bytes(buf, pos)
                    try:
                        k = raw.decode("utf-8")
                    except UnicodeDecodeError as e:
                        raise MalformedAvro(
                            f"invalid UTF-8 in map key: {e}",
                            err_name="bad_utf8",
                        ) from None
                    v, pos = value_reader(buf, pos)
                    out.append((k, v))
        return read_map

    if isinstance(t, Union):
        readers = tuple(compile_reader(v, _depth + 1) for v in t.variants)
        n = len(readers)
        def read_union(buf, pos):
            idx, pos = read_long(buf, pos)
            if not 0 <= idx < n:
                raise MalformedAvro(f"union branch {idx} out of range 0..{n}",
                                    err_name="bad_branch")
            v, pos = readers[idx](buf, pos)
            return (idx, v), pos
        return read_union

    if isinstance(t, Record):
        field_readers = tuple(
            (f.name, compile_reader(f.type, _depth + 1)) for f in t.fields
        )
        def read_record(buf, pos):
            row = {}
            for name, rd in field_readers:
                row[name], pos = rd(buf, pos)
            return row, pos
        return read_record

    raise NotImplementedError(f"no reader for {t!r}")


def _decode_one(datum, reader: Callable, limit: int):
    """One datum through the reader with the hostile-input guards: the
    PYRUHVRO_TPU_MAX_DATUM_BYTES ceiling fires before any decode work,
    the per-datum zero-width item budget resets, trailing bytes error."""
    if limit and len(datum) > limit:
        raise MalformedAvro(
            f"datum of {len(datum)} bytes exceeds "
            f"PYRUHVRO_TPU_MAX_DATUM_BYTES={limit}",
            err_name="datum_too_large",
        )
    _reset_zw_budget()
    value, pos = reader(datum, 0)
    if pos != len(datum):
        raise MalformedAvro(
            f"trailing bytes after datum: consumed {pos} of {len(datum)}",
            err_name="trailing",
        )
    return value


def decode_records(
    data: Sequence[bytes], t: AvroType, reader: Callable = None,
    index_base: int = 0,
) -> List[object]:
    """Decode each datum fully; trailing bytes are an error.

    Pass a precompiled ``reader`` (from :func:`compile_reader`, cached per
    schema via ``SchemaEntry.get_extra``) to skip per-call recompilation.
    Errors carry the GLOBAL row index (``index_base`` + position), so the
    chunked host path reports the same index as the device tier
    (``record <i>: <why>``)."""
    if reader is None:
        reader = compile_reader(t)
    limit = max_datum_bytes()
    out = []
    for j, datum in enumerate(data):
        try:
            out.append(_decode_one(datum, reader, limit))
        except MalformedAvro as e:
            i = index_base + j
            raise MalformedAvro(
                f"record {i}: {e}", index=i,
                err_name=e.err_name, tier="fallback",
            ) from None
    return out


def decode_records_tolerant(
    data: Sequence[bytes], t: AvroType, reader: Callable = None,
    index_base: int = 0,
) -> Tuple[List[object], List[Tuple[int, bytes, str]]]:
    """Per-record error capture (the error-policy layer's last resort):
    decode every datum independently,
    returning ``(surviving_value_trees, errors)`` where errors is
    ``[(global_index, raw_datum_bytes, err_name), ...]`` in row order.
    Surviving values keep their relative order."""
    return decode_pairs_tolerant(
        [(index_base + j, d) for j, d in enumerate(data)], t, reader
    )


def decode_pairs_tolerant(
    pairs: Sequence[Tuple[int, bytes]], t: AvroType, reader: Callable = None
) -> Tuple[List[object], List[Tuple[int, bytes, str]]]:
    """Like :func:`decode_records_tolerant` but over explicit
    ``(global_index, datum)`` pairs — the shape the error-policy resume
    loop holds after earlier offenders were already removed (survivor
    sets are not contiguous index ranges)."""
    if reader is None:
        reader = compile_reader(t)
    limit = max_datum_bytes()
    out: List[object] = []
    errors: List[Tuple[int, bytes, str]] = []
    for gi, datum in pairs:
        try:
            out.append(_decode_one(datum, reader, limit))
        except MalformedAvro as e:
            errors.append((gi, bytes(datum), e.err_name or "malformed"))
    return out, errors


# ---------------------------------------------------------------------------
# Stage 2: value trees → Arrow arrays
# ---------------------------------------------------------------------------

def _build_array(t: AvroType, dt: pa.DataType, values: List[object]) -> pa.Array:
    # unwrap nullable-pair unions: values are (branch, v) tuples
    if isinstance(t, Union) and t.is_nullable_pair:
        null_idx = t.null_index
        inner = [None if v is None or v[0] == null_idx else v[1] for v in values]
        return _build_array(t.non_null_variant, dt, inner)

    if isinstance(t, Primitive):
        if t.logical == "decimal":
            ctx = decimal.Context(prec=max(t.precision, 1))
            scale = t.scale
            vals = [
                None
                if v is None
                else ctx.create_decimal(v).scaleb(-scale, ctx)
                for v in values
            ]
            return pa.array(vals, type=dt)
        if t.logical == "uuid":
            vals = [
                None if v is None else _uuid.UUID(v).bytes for v in values
            ]
            return pa.array(vals, type=dt)
        return pa.array(values, type=dt)

    if isinstance(t, Fixed):
        if t.logical == "decimal":
            ctx = decimal.Context(prec=max(t.precision, 1))
            scale = t.scale
            vals = [
                None
                if v is None
                else ctx.create_decimal(v).scaleb(-scale, ctx)
                for v in values
            ]
            return pa.array(vals, type=dt)
        if t.logical == "duration":
            # avro duration fixed(12) = (months, days, millis) little-endian
            # u32; reference maps to Duration(ms). Months/days have no exact
            # ms length; we use the Arrow convention 1 day = 86_400_000 ms,
            # 1 month = 30 days, documenting the reference's lossy mapping.
            def to_ms(v):
                if v is None:
                    return None
                months = int.from_bytes(v[0:4], "little")
                days = int.from_bytes(v[4:8], "little")
                ms = int.from_bytes(v[8:12], "little")
                return ((months * 30 + days) * 86_400_000) + ms
            return pa.array([to_ms(v) for v in values], type=dt)
        return pa.array(values, type=dt)

    if isinstance(t, Enum):
        return pa.array(values, type=pa.string())

    if isinstance(t, Array):
        item_field = dt.value_field
        # null rows repeat the previous offset and set a validity bit; a null
        # in the offsets array itself would mark the WRONG row (the from_arrays
        # null-offset convention applies to the start position, which is the
        # previous row's end)
        offsets = [0]
        validity = []
        child_values = []
        n = 0
        for v in values:
            if v is None:
                validity.append(False)
            else:
                child_values.extend(v)
                n += len(v)
                validity.append(True)
            offsets.append(n)
        child = _build_array(t.items, item_field.type, child_values)
        mask = pa.array([not ok for ok in validity]) if not all(validity) else None
        return pa.ListArray.from_arrays(
            pa.array(offsets, pa.int32()), child, type=dt, mask=mask
        )

    if isinstance(t, Map):
        offsets = [0]
        validity = []
        keys: List[object] = []
        vals: List[object] = []
        n = 0
        for v in values:
            if v is None:
                validity.append(False)
            else:
                for k, item in v:
                    keys.append(k)
                    vals.append(item)
                n += len(v)
                validity.append(True)
            offsets.append(n)
        key_arr = pa.array(keys, pa.string())
        val_arr = _build_array(t.values, dt.item_type, vals)
        entries = pa.StructArray.from_arrays(
            [key_arr, val_arr], fields=[dt.key_field, dt.item_field]
        )
        if all(validity):
            vbuf, nulls = None, 0
        else:
            vbuf = pa.py_buffer(
                np.packbits(np.array(validity, bool), bitorder="little")
            )
            nulls = validity.count(False)
        return pa.Array.from_buffers(
            dt, len(values),
            [vbuf, pa.py_buffer(np.array(offsets, np.int32))],
            null_count=nulls, children=[entries],
        )

    if isinstance(t, Union):
        # sparse union: one child per variant, same length; non-selected
        # rows are null in every child (fast_decode.rs:643-668)
        n_var = len(t.variants)
        type_ids = []
        per_child: List[List[object]] = [[] for _ in range(n_var)]
        for v in values:
            idx, inner = (0, None) if v is None else v
            type_ids.append(idx)
            for c in range(n_var):
                per_child[c].append(inner if c == idx else None)
        children = []
        field_names = []
        for c, (vt, child_field) in enumerate(zip(t.variants, dt)):
            children.append(_build_array(vt, child_field.type, per_child[c]))
            field_names.append(child_field.name)
        return pa.UnionArray.from_sparse(
            pa.array(type_ids, pa.int8()),
            children,
            field_names=field_names,
            type_codes=list(dt.type_codes),
        )

    if isinstance(t, Record):
        validity = [v is not None for v in values]
        any_null = not all(validity)
        if not t.fields:
            # StructArray.from_arrays([]) would be length 0 regardless of
            # len(values); build the empty-struct rows explicitly
            return pa.array(
                [None if v is None else {} for v in values], pa.struct([])
            )
        children = []
        fields = []
        for i, f in enumerate(t.fields):
            child_field = dt.field(i)
            child_vals = [None if v is None else v[f.name] for v in values]
            children.append(_build_array(f.type, child_field.type, child_vals))
            fields.append(child_field)
        mask = pa.array([not v for v in validity]) if any_null else None
        return pa.StructArray.from_arrays(children, fields=fields, mask=mask)

    raise NotImplementedError(f"no builder for {t!r}")


def decode_to_record_batch(
    data: Sequence[bytes],
    t: AvroType,
    arrow_schema: pa.Schema = None,
    reader: Callable = None,
    index_base: int = 0,
) -> pa.RecordBatch:
    """Full host decode: ``list[bytes]`` → ``pa.RecordBatch``
    (≙ ``per_datum_deserialize_baseline``, ``deserialize.rs:34-48``).
    ``index_base`` offsets error indices so chunked callers report the
    GLOBAL position of a malformed datum."""
    if not isinstance(t, Record):
        raise ValueError("top-level Avro schema must be a record")
    if arrow_schema is None:
        arrow_schema = to_arrow_schema(t)
    rows = decode_records(data, t, reader, index_base)
    return rows_to_record_batch(rows, t, arrow_schema)


def rows_to_record_batch(
    rows: List[object], t: AvroType, arrow_schema: pa.Schema
) -> pa.RecordBatch:
    """Stage 2 alone: decoded value trees → ``pa.RecordBatch`` (used by
    the tolerant decode paths, which assemble from SURVIVING rows after
    per-record error capture)."""
    if not t.fields:
        # zero-column batch must still carry the row count
        return pa.RecordBatch.from_struct_array(
            pa.array([{}] * len(rows), pa.struct([]))
        )
    arrays = []
    for i, f in enumerate(t.fields):
        field = arrow_schema.field(i)
        col_vals = [row[f.name] for row in rows]
        arrays.append(_build_array(f.type, field.type, col_vals))
    return pa.RecordBatch.from_arrays(arrays, schema=arrow_schema)
