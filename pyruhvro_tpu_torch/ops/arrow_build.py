"""Walk outputs → ``pyarrow`` arrays (host assembly; copy of
``pyruhvro_tpu/ops/arrow_build.py`` ``build_record_batch``,
``build_fused_record_batch`` and ``compact_union_slices``, numpy paths
only: the reference's native ``cumsum0``, ``uuid16`` and
``dec128_check`` shortcuts give the same values and are left out).

``build_record_batch`` takes either layout: the device walk's
(``#lo``/``#hi`` lanes, ``(start, len)`` descriptors) or the host VM's
plan buffers (``#v64``, ``#bytes``, ``#dec``, ``#fix``).
``build_fused_record_batch`` wraps the host VM's fused decode, whose
buffers already have Arrow's layout, positionally.

The decoder hands over dense numpy buffers in Arrow's own layout — int32
offsets, per-lane validity bytes, (lo, hi) 64-bit halves, ``(start, len)``
descriptors into the concatenated record bytes — so assembly is
``pa.Array.from_buffers`` over those plus cheap vectorized host ops:
recombining (lo, hi) u32 pairs into int64/float64 (a numpy ``view``),
bit-packing validity/boolean bytes (``np.packbits``), gathering string
bytes through the descriptors, and expanding enum indices through the
symbol table. This replaces upstream's Arrow C-data FFI handoff
(``src/lib.rs:70,88,104``) — same boundary, columnar buffers instead of
per-value appends.

Null semantics mirror the reference's oracle
(``pyruhvro_tpu/fallback/decoder.py``) exactly, and through it upstream:
children under a null struct are null, non-selected sparse union children
are null (``fast_decode.rs:643-668``), and a null parent forces nulls all
the way down — implemented by threading ``parent_valid`` through the
recursion.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pyarrow as pa

from ..errors import MalformedAvro, mark_value_error
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

__all__ = [
    "build_fused_record_batch",
    "build_record_batch",
    "compact_union_slices",
]


def _contains_union(dt: pa.DataType) -> bool:
    if pa.types.is_union(dt):
        return True
    if pa.types.is_struct(dt) or pa.types.is_map(dt):
        return any(_contains_union(dt.field(i).type)
                   for i in range(dt.num_fields))
    if pa.types.is_list(dt) or pa.types.is_large_list(dt):
        return _contains_union(dt.value_type)
    return False


def compact_union_slices(batch: pa.RecordBatch) -> pa.RecordBatch:
    """Repair a SLICED batch whose columns contain sparse unions:
    pyarrow's scalar access mis-reads a sparse union reached through a
    non-zero offset when its children hold validity bitmaps
    (``to_pylist``/``as_py`` return null for every row — reproducible on
    a pure ``pa.UnionArray.from_sparse(...).slice(...)`` with pyarrow
    22, and equally through a sliced struct PARENT, where the offset
    lives on the struct and the union child still mis-resolves).
    ``pa.concat_arrays`` of the single slice compacts it back to offset
    0 — children included — copying only the union-bearing columns;
    every other column stays the zero-copy slice. A batch with no
    union-bearing columns (or no offset) is returned untouched — this
    keeps the reference's slice-per-chunk shape (``deserialize.rs:57-68``)
    while making the returned chunks render correctly."""
    if not any(_contains_union(f.type) for f in batch.schema):
        return batch
    cols = [
        pa.concat_arrays([c]) if _contains_union(c.type) and c.offset
        else c
        for c in batch.columns
    ]
    return pa.RecordBatch.from_arrays(cols, schema=batch.schema)


def _validity(valid: Optional[np.ndarray], count: int):
    """(buffer, null_count) for an optional boolean lane vector."""
    if valid is None:
        return None, 0
    nulls = count - int(np.count_nonzero(valid))
    if nulls == 0:
        return None, 0
    return pa.py_buffer(np.packbits(valid, bitorder="little")), nulls


def _and(a: Optional[np.ndarray], b: Optional[np.ndarray]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _check_utf8(values: np.ndarray, voff: np.ndarray, path: str) -> None:
    """Validate a whole string column's bytes in one pass, matching the
    host oracle (which raises :class:`MalformedAvro` on invalid UTF-8 in
    ``fallback/decoder.py``). The reference deliberately skips this check
    (``fast_decode.rs:914-921``); we keep the device path byte-for-byte
    equal to our own fallback instead — the differential contract wins.

    Cost: the overwhelmingly common all-ASCII column is settled by one
    vectorized ``max`` (SIMD, ~memory speed); only columns containing
    high bytes pay the real decode. Per-string validity follows from two
    whole-column facts: (a) the concatenation decodes as UTF-8, and
    (b) no string starts on a continuation byte (0x80–0xBF). Any string
    boundary that splits a multi-byte sequence makes the next string
    start on a continuation byte, and a dangling lead byte at a string's
    end makes the concatenation invalid — so (a) ∧ (b) ⟺ every string
    is valid."""
    if values.size == 0 or int(values.max(initial=0)) < 0x80:
        return  # pure ASCII — necessarily valid, and start-bytes too
    try:
        values.tobytes().decode("utf-8")
    except UnicodeDecodeError as e:
        raise mark_value_error(MalformedAvro(
            f"invalid UTF-8 in string column {path!r}: {e}"))
    firsts = values[voff[:-1][voff[:-1] < voff[1:]].astype(np.int64)]
    if firsts.size and bool(((firsts & 0xC0) == 0x80).any()):
        raise mark_value_error(MalformedAvro(
            f"invalid UTF-8 in string column {path!r}: string begins on a "
            f"continuation byte"
        ))


def _combine64(lo: np.ndarray, hi: np.ndarray, view) -> np.ndarray:
    out = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return out.view(view)


# uuid text positions that carry hex nibbles (dashes at 8/13/18/23)
_UUID_KEEP = np.delete(np.arange(36), [8, 13, 18, 23])


def cumsum0(lens: np.ndarray) -> np.ndarray:
    """Arrow offsets (leading 0) from an int32 length vector. Callers
    guard the int32 total themselves (the sum would wrap)."""
    voff = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=voff[1:])
    return voff


class _Assembler:
    def __init__(self, host: Dict[str, np.ndarray], meta):
        self.host = host
        self.item_totals = meta["item_totals"]
        self.flat = meta["flat"]  # original datum bytes (value-gather source)

    def col(self, key: str, count: int) -> np.ndarray:
        return np.ascontiguousarray(self.host[key][:count])

    def build(
        self,
        t: AvroType,
        dt: pa.DataType,
        path: str,
        count: int,
        parent_valid: Optional[np.ndarray],
    ) -> pa.Array:
        if isinstance(t, Union) and t.is_nullable_pair:
            own = self.host[path + "#valid"][:count].astype(bool)
            return self.build(
                t.non_null_variant, dt, path, count, _and(parent_valid, own)
            )

        if isinstance(t, Primitive):
            return self._primitive(t, dt, path, count, parent_valid)
        if isinstance(t, Fixed):
            return self._fixed(t, dt, path, count, parent_valid)
        if isinstance(t, Enum):
            return self._enum(t, path, count, parent_valid)
        if isinstance(t, Record):
            return self._struct(t, dt, path, count, parent_valid)
        if isinstance(t, Union):
            return self._union(t, dt, path, count, parent_valid)
        if isinstance(t, (Array, Map)):
            return self._repeated(t, dt, path, count, parent_valid)
        raise NotImplementedError(repr(t))

    def _primitive(self, t, dt, path, count, valid):
        vbuf, nulls = _validity(valid, count)
        name = t.name
        if name == "null":
            return pa.nulls(count, pa.null())
        if name == "bytes" and t.logical == "decimal":
            return self._decimal(t, dt, path, count, vbuf, nulls, valid)
        if name == "string" and t.logical == "uuid":
            return self._uuid(dt, path, count, vbuf, nulls, valid)
        if name in ("string", "bytes"):
            values, voff, _lens = self._string_values(path, count)
            if name == "string":
                _check_utf8(values, voff, path)
            return pa.Array.from_buffers(
                dt, count,
                [vbuf, pa.py_buffer(voff), pa.py_buffer(values)],
                null_count=nulls,
            )
        if name == "boolean":
            bits = np.packbits(
                self.col(path + "#v", count).astype(bool), bitorder="little"
            )
            return pa.Array.from_buffers(
                dt, count, [vbuf, pa.py_buffer(bits)], null_count=nulls
            )
        if name == "int":
            arr = self.col(path + "#v", count)
            return pa.Array.from_buffers(
                dt, count, [vbuf, pa.py_buffer(arr)], null_count=nulls
            )
        if name == "long":
            # the walk ships (lo, hi) u32 lanes; the host VM writes int64
            # directly under "#v64"
            if path + "#v64" in self.host:
                arr = self.col(path + "#v64", count)
            else:
                arr = _combine64(
                    self.col(path + "#lo", count),
                    self.col(path + "#hi", count),
                    np.int64,
                )
            return pa.Array.from_buffers(
                dt, count, [vbuf, pa.py_buffer(arr)], null_count=nulls
            )
        if name == "float":
            arr = self.col(path + "#v", count)
            return pa.Array.from_buffers(
                dt, count, [vbuf, pa.py_buffer(arr)], null_count=nulls
            )
        if name == "double":
            if path + "#v64" in self.host:
                arr = self.col(path + "#v64", count)
            else:
                arr = _combine64(
                    self.col(path + "#lo", count),
                    self.col(path + "#hi", count),
                    np.float64,
                )
            return pa.Array.from_buffers(
                dt, count, [vbuf, pa.py_buffer(arr)], null_count=nulls
            )
        raise NotImplementedError(name)

    def _string_values(self, path: str, count: int):
        """Materialize one string-ish column's ``(values, voff, lens)``
        from either layout — the host VM's contiguous ``#bytes`` or the
        walk's ``(start, len)`` descriptors into the concatenated record
        bytes — with the 2 GiB int32-offset guard (the oracle's
        ``pa.array`` raises the same error class)."""
        lens = self.host[path + "#len"][:count]
        total = int(lens.sum(dtype=np.int64))
        if total >= (1 << 31):
            raise pa.lib.ArrowCapacityError(
                f"column {path!r} carries {total} value bytes — over "
                f"the 2 GiB Binary/Utf8 capacity; split the batch"
            )
        voff = cumsum0(lens)
        if path + "#bytes" in self.host:
            values = self.host[path + "#bytes"][:total]
        else:
            starts = self.host[path + "#start"][:count]
            src = np.repeat(
                starts.astype(np.int64) - voff[:-1], lens
            ) + np.arange(total, dtype=np.int64)
            values = self.flat[src]
        return values, voff, lens

    # char → nibble; 0xFF marks non-hex
    _HEX_LUT = np.full(256, 0xFF, np.uint8)
    for i, ch in enumerate(b"0123456789abcdef"):
        _HEX_LUT[ch] = i
    for i, ch in enumerate(b"ABCDEF"):
        _HEX_LUT[ch] = 10 + i
    del i, ch

    def _uuid(self, dt, path, count, vbuf, nulls, valid):
        """uuid text → FixedSizeBinary(16). Live rows in the canonical
        36-char form (dashes at 8/13/18/23) convert vectorized; anything
        else goes through the stdlib ``uuid.UUID`` — the oracle's own
        parser (``fallback/decoder.py``), so exotic-but-accepted forms
        and error behavior match by construction. Dead rows (nulls,
        non-selected union arms) emit zero bytes."""
        values, voff, lens = self._string_values(path, count)
        _check_utf8(values, voff, path)

        live = (
            np.ones(count, bool) if valid is None else valid.astype(bool)
        )
        out = np.zeros((count, 16), np.uint8)
        canonical = np.zeros(count, bool)
        cand = np.flatnonzero(live & (lens == 36))
        if cand.size:
            if cand.size == count and values.size == count * 36:
                # every row live and 36 chars: the value bytes are one
                # dense (count, 36) block — zero-copy reshape instead of
                # the fancy-index gather
                m = values.reshape(count, 36)
            else:
                m = values[
                    voff[:-1][cand, None].astype(np.int64) + np.arange(36)
                ]
            nib = self._HEX_LUT[m[:, _UUID_KEEP]]
            ok = (m[:, [8, 13, 18, 23]] == ord("-")).all(axis=1) & (
                nib != 0xFF
            ).all(axis=1)
            rows = cand[ok]
            out[rows] = (nib[ok, 0::2] << 4) | nib[ok, 1::2]
            canonical[rows] = True
        rest = np.flatnonzero(live & ~canonical)
        if rest.size:
            import uuid as _uuid_mod

            for i in rest:
                try:
                    s = values[voff[i] : voff[i + 1]].tobytes().decode(
                        "utf-8")
                    out[i] = np.frombuffer(_uuid_mod.UUID(s).bytes,
                                           np.uint8)
                except ValueError as e:  # UnicodeDecodeError included
                    # a value error that names no row: the tolerant
                    # policies send the chunk to the oracle
                    raise mark_value_error(e)
        return pa.Array.from_buffers(
            dt, count,
            [vbuf, pa.py_buffer(np.ascontiguousarray(out).reshape(-1))],
            null_count=nulls,
        )

    def _decimal_raw_from_descriptors(self, t, path, count, valid):
        """Device-walk layout → 16-byte-LE decimal128 words: gather each
        row's big-endian two's-complement run from the datum bytes via
        its ``(start, len)`` descriptor and sign-extend to 16 bytes.
        Over-long encodings (len > 16, or a fixed size > 16) are legal
        when the leading bytes are pure sign fill — exactly the values
        ``int.from_bytes`` accepts in the oracle; anything wider than
        128 bits necessarily exceeds precision ≤ 38 and raises the
        oracle's error class. Dead rows (len 0) emit zeros."""
        live = np.ones(count, bool) if valid is None else valid.astype(bool)
        starts = np.where(live, self.host[path + "#start"][:count], 0
                          ).astype(np.int64)
        if path + "#len" in self.host:
            lens = np.where(live, self.host[path + "#len"][:count], 0
                            ).astype(np.int64)
        else:  # decimal over fixed: static size
            lens = np.where(live, t.size, 0).astype(np.int64)
        hi = np.int64(max(len(self.flat) - 1, 0))
        first = self.flat[np.clip(starts, 0, hi)]
        fill = np.where(
            (lens > 0) & ((first & 0x80) != 0), 0xFF, 0
        ).astype(np.uint8)
        take = np.minimum(lens, 16)
        j = np.arange(16)
        pos = np.clip(starts[:, None] + lens[:, None] - 1 - j, 0, hi)
        out = np.where(j < take[:, None], self.flat[pos], fill[:, None])
        over = lens > 16
        if bool(over.any()):
            extra = np.where(over, lens - 16, 0)
            total = int(extra.sum())
            off = np.zeros(count + 1, np.int64)
            np.cumsum(extra, out=off[1:])
            src = np.repeat(starts - off[:-1], extra) + np.arange(
                total, dtype=np.int64
            )
            lead_ok = np.ones(count, bool)
            np.logical_and.at(
                lead_ok,
                np.repeat(np.arange(count), extra),
                self.flat[np.clip(src, 0, hi)] == np.repeat(fill, extra),
            )
            sign_ok = ((out[:, 15] & 0x80) != 0) == (fill == 0xFF)
            bad = over & ~(lead_ok & sign_ok)
            if bool(bad.any()):
                i = int(np.flatnonzero(bad)[0])
                raise mark_value_error(pa.lib.ArrowInvalid(
                    f"decimal at {path!r} row {i} exceeds precision "
                    f"{t.precision}"
                ))
        return np.ascontiguousarray(out.astype(np.uint8).reshape(-1))

    def _decimal(self, t, dt, path, count, vbuf, nulls, valid):
        """Decimal128 from either layout — the host VM's ready
        16-byte-LE ``#dec`` words, or the walk's ``(start, len)``
        descriptors (``_decimal_raw_from_descriptors``) — validating live
        values against the declared precision; the oracle's ``pa.array``
        raises ArrowInvalid for over-precision values, and
        ``from_buffers`` would silently accept them."""
        if path + "#dec" in self.host:
            raw = np.ascontiguousarray(self.host[path + "#dec"][: count * 16])
        else:
            raw = self._decimal_raw_from_descriptors(t, path, count, valid)
        if count:
            words = raw.view(np.uint64).reshape(count, 2)
            lo, hi = words[:, 0], words[:, 1]
            neg = (hi >> np.uint64(63)) != 0
            # |v| over two u64 halves (two's-complement negate)
            lo_a = np.where(neg, (~lo) + np.uint64(1), lo)
            hi_a = np.where(neg, (~hi) + (lo == 0).astype(np.uint64), hi)
            bound = 10 ** t.precision
            b_hi = np.uint64(bound >> 64)
            b_lo = np.uint64(bound & ((1 << 64) - 1))
            fits = (hi_a < b_hi) | ((hi_a == b_hi) & (lo_a < b_lo))
            live = (
                np.ones(count, bool) if valid is None
                else valid.astype(bool)
            )
            bad = live & ~fits
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                raise mark_value_error(pa.lib.ArrowInvalid(
                    f"decimal at {path!r} row {i} exceeds precision "
                    f"{t.precision}"
                ))
        return pa.Array.from_buffers(
            dt, count, [vbuf, pa.py_buffer(raw)], null_count=nulls
        )

    def _fixed(self, t, dt, path, count, valid):
        """Avro ``fixed`` from the host VM's raw ``#fix`` byte column, or
        gathered from the concatenated record bytes; ``duration`` converts fixed(12) (months, days, ms u32-LE) to
        Duration(ms) with the oracle's 30-day-month convention
        (``fallback/decoder.py``)."""
        vbuf, nulls = _validity(valid, count)
        if t.logical == "decimal":
            return self._decimal(t, dt, path, count, vbuf, nulls, valid)
        if path + "#fix" in self.host:
            raw = self.host[path + "#fix"][: count * t.size]
        else:
            # the static-size run per row; dead rows (null / non-selected
            # arm) → zeros, like the host VM's builder
            live = (np.ones(count, bool) if valid is None
                    else valid.astype(bool))
            starts = self.host[path + "#start"][:count].astype(np.int64)
            hi = np.int64(max(len(self.flat) - 1, 0))
            pos = np.clip(starts[:, None] + np.arange(t.size), 0, hi)
            raw = np.where(
                live[:, None], self.flat[pos], np.uint8(0)
            ).astype(np.uint8).reshape(-1)
        if t.logical == "duration":
            u = np.ascontiguousarray(raw).view(np.uint32).reshape(count, 3)
            # uint64 holds the wire maximum ((2^32·30 + 2^32)·86400000 +
            # 2^32 < 2^64); values past int64 overflow Duration(ms) like
            # the oracle's pa.array does
            ms = (
                (u[:, 0].astype(np.uint64) * 30 + u[:, 1]) * 86_400_000
                + u[:, 2]
            )
            if bool((ms > np.uint64(np.iinfo(np.int64).max)).any()):
                raise mark_value_error(OverflowError(
                    f"duration at {path!r} exceeds Duration(ms) int64"
                ))
            return pa.Array.from_buffers(
                dt, count,
                [vbuf, pa.py_buffer(ms.astype(np.int64))],
                null_count=nulls,
            )
        return pa.Array.from_buffers(
            dt, count,
            [vbuf, pa.py_buffer(np.ascontiguousarray(raw))],
            null_count=nulls,
        )

    def _enum(self, t, path, count, valid):
        """Enum indices → Utf8 through the symbol table, vectorized."""
        vbuf, nulls = _validity(valid, count)
        idx = self.col(path + "#v", count)
        sym_bytes = np.frombuffer("".join(t.symbols).encode("utf-8"), np.uint8)
        sym_lens = np.array([len(s.encode("utf-8")) for s in t.symbols], np.int32)
        if count and int(sym_lens.max()) == int(sym_lens.min()):
            # uniform symbol width L (the typical enum): offsets are a
            # ramp and the values one (count, L) table gather — replaces
            # the repeat/arange expansion below (~4x on this hot cell)
            L = int(sym_lens[0])
            if count * L >= (1 << 31):
                raise pa.lib.ArrowCapacityError(
                    f"enum column {path!r} expands to {count * L} symbol "
                    f"bytes — over the 2 GiB Utf8 capacity; split the batch"
                )
            offsets = (np.arange(count + 1, dtype=np.int64) * L).astype(
                np.int32
            )
            values = sym_bytes.reshape(len(t.symbols), L)[idx].reshape(-1)
            return pa.Array.from_buffers(
                pa.utf8(), count,
                [vbuf, pa.py_buffer(offsets), pa.py_buffer(values)],
                null_count=nulls,
            )
        sym_starts = np.zeros(len(t.symbols), np.int32)
        np.cumsum(sym_lens[:-1], out=sym_starts[1:])
        lens = sym_lens[idx]
        total = int(lens.sum(dtype=np.int64))
        if total >= (1 << 31):
            raise pa.lib.ArrowCapacityError(
                f"enum column {path!r} expands to {total} symbol bytes — "
                f"over the 2 GiB Utf8 capacity; split the batch"
            )
        offsets = cumsum0(lens)
        pos = np.arange(total, dtype=np.int64) - np.repeat(offsets[:-1], lens)
        src = np.repeat(sym_starts[idx], lens) + pos
        values = sym_bytes[src]
        return pa.Array.from_buffers(
            pa.utf8(), count,
            [vbuf, pa.py_buffer(offsets), pa.py_buffer(values)],
            null_count=nulls,
        )

    def _struct(self, t, dt, path, count, valid):
        vbuf, nulls = _validity(valid, count)
        prefix = path + "/" if path else ""
        children = [
            self.build(f.type, dt.field(i).type, prefix + f.name, count, valid)
            for i, f in enumerate(t.fields)
        ]
        return pa.Array.from_buffers(
            dt, count, [vbuf], null_count=nulls, children=children
        )

    def _union(self, t, dt, path, count, parent_valid):
        tid = self.col(path + "#tid", count)
        if parent_valid is not None:
            # a null parent renders as branch 0 + null child, like the oracle
            tid = np.where(parent_valid, tid, 0).astype(tid.dtype)
        children = []
        names = []
        for k, v in enumerate(t.variants):
            child_field = dt.field(k)
            names.append(child_field.name)
            sel = _and(parent_valid, tid == k)
            if v.is_null():
                children.append(pa.nulls(count, pa.null()))
            else:
                children.append(
                    self.build(v, child_field.type, f"{path}/{k}", count, sel)
                )
        return pa.UnionArray.from_sparse(
            pa.array(tid.astype(np.int8), pa.int8()),
            children,
            field_names=names,
            type_codes=list(dt.type_codes),
        )

    def _repeated(self, t, dt, path, count, valid):
        vbuf, nulls = _validity(valid, count)
        offsets = self.col(path + "#offsets", count + 1)
        total = self.item_totals[path]
        if isinstance(t, Array):
            child = self.build(
                t.items, dt.value_field.type, path + "/@item", total, None
            )
            return pa.Array.from_buffers(
                dt, count, [vbuf, pa.py_buffer(offsets)],
                null_count=nulls, children=[child],
            )
        keys = self._primitive(
            Primitive("string"), pa.utf8(), path + "/@key", total, None
        )
        vals = self.build(t.values, dt.item_type, path + "/@val", total, None)
        entries = pa.StructArray.from_arrays(
            [keys, vals], fields=[dt.key_field, dt.item_field]
        )
        return pa.Array.from_buffers(
            dt, count, [vbuf, pa.py_buffer(offsets)],
            null_count=nulls, children=[entries],
        )


class _FusedNodes:
    """Positional cursor over the fused decoder's flat node list
    (``csrc/host/arrow_decode_core.h``) — both sides walk the same
    schema tree pre-order, so entries carry no keys."""

    __slots__ = ("nodes", "i")

    def __init__(self, nodes):
        self.nodes = nodes
        self.i = 0

    def next(self):
        e = self.nodes[self.i]
        self.i += 1
        return e


def _fused_build(t: AvroType, dt: pa.DataType, count: int,
                 it: _FusedNodes) -> pa.Array:
    """One schema node from its finished native buffers — the fused
    mirror of ``_Assembler.build``: every buffer arrives in final Arrow
    layout (validity bitmaps, leading-0 offsets, int8 type ids), so
    this walk is pure ``pa.Array.from_buffers`` composition; no numpy
    op exists anywhere on this path."""
    if isinstance(t, Union) and t.is_nullable_pair:
        # the native pass folded the wrapper's validity into the child
        return _fused_build(t.non_null_variant, dt, count, it)

    if isinstance(t, Primitive):
        name = t.name
        if name == "null":
            return pa.nulls(count, pa.null())
        if name in ("string", "bytes") and t.logical != "uuid" \
                and t.logical != "decimal":
            nc, vb, offs, vals = it.next()
            return pa.Array.from_buffers(
                dt, count,
                [None if vb is None else pa.py_buffer(vb),
                 pa.py_buffer(offs), pa.py_buffer(vals)],
                null_count=nc,
            )
        # uuid / decimal / numeric / boolean: one value buffer
        nc, vb, data = it.next()
        return pa.Array.from_buffers(
            dt, count,
            [None if vb is None else pa.py_buffer(vb), pa.py_buffer(data)],
            null_count=nc,
        )
    if isinstance(t, (Fixed, Enum)):
        if isinstance(t, Enum):
            nc, vb, offs, vals = it.next()
            return pa.Array.from_buffers(
                pa.utf8(), count,
                [None if vb is None else pa.py_buffer(vb),
                 pa.py_buffer(offs), pa.py_buffer(vals)],
                null_count=nc,
            )
        nc, vb, data = it.next()
        return pa.Array.from_buffers(
            dt, count,
            [None if vb is None else pa.py_buffer(vb), pa.py_buffer(data)],
            null_count=nc,
        )
    if isinstance(t, Record):
        nc, vb = it.next()
        children = [
            _fused_build(f.type, dt.field(i).type, count, it)
            for i, f in enumerate(t.fields)
        ]
        return pa.Array.from_buffers(
            dt, count,
            [None if vb is None else pa.py_buffer(vb)],
            null_count=nc, children=children,
        )
    if isinstance(t, Union):
        (tid8,) = it.next()
        tid_arr = pa.Array.from_buffers(
            pa.int8(), count, [None, pa.py_buffer(tid8)]
        )
        children = []
        names = []
        for k, v in enumerate(t.variants):
            child_field = dt.field(k)
            names.append(child_field.name)
            if v.is_null():
                children.append(pa.nulls(count, pa.null()))
            else:
                children.append(
                    _fused_build(v, child_field.type, count, it)
                )
        return pa.UnionArray.from_sparse(
            tid_arr, children,
            field_names=names, type_codes=list(dt.type_codes),
        )
    if isinstance(t, (Array, Map)):
        nc, vb, offs, total = it.next()
        vbuf = None if vb is None else pa.py_buffer(vb)
        if isinstance(t, Array):
            child = _fused_build(t.items, dt.value_field.type, total, it)
            return pa.Array.from_buffers(
                dt, count, [vbuf, pa.py_buffer(offs)],
                null_count=nc, children=[child],
            )
        knc, kvb, koffs, kvals = it.next()  # map keys: a string entry
        keys = pa.Array.from_buffers(
            pa.utf8(), total,
            [None if kvb is None else pa.py_buffer(kvb),
             pa.py_buffer(koffs), pa.py_buffer(kvals)],
            null_count=knc,
        )
        vals = _fused_build(t.values, dt.item_type, total, it)
        entries = pa.StructArray.from_arrays(
            [keys, vals], fields=[dt.key_field, dt.item_field]
        )
        return pa.Array.from_buffers(
            dt, count, [vbuf, pa.py_buffer(offs)],
            null_count=nc, children=[entries],
        )
    raise NotImplementedError(repr(t))


def _empty_fields_batch(n: int) -> pa.RecordBatch:
    """An n-row batch for a zero-field schema, built without an n-long
    Python list (shared by both assembly engines)."""
    return pa.RecordBatch.from_struct_array(
        pa.Array.from_buffers(pa.struct([]), n, [None], children=[])
    )


def build_fused_record_batch(
    ir: Record,
    arrow_schema: pa.Schema,
    nodes,
    n: int,
) -> pa.RecordBatch:
    """RecordBatch from the fused native decoder's node list — the
    zero-copy handoff: every ``pa.py_buffer`` wraps the returned bytes
    objects in place. Raises if the node list and schema disagree
    (a contract violation, not a data error)."""
    it = _FusedNodes(nodes)
    arrays = [
        _fused_build(f.type, arrow_schema.field(i).type, n, it)
        for i, f in enumerate(ir.fields)
    ]
    if it.i != len(nodes):
        # the positional protocol's one failure mode is a silent walk
        # desync — unconsumed entries must never pass as a valid batch
        raise ValueError(
            f"fused decode walk desync: {len(nodes) - it.i} node "
            f"entr{'y' if len(nodes) - it.i == 1 else 'ies'} unconsumed"
        )
    if not arrays:
        return _empty_fields_batch(n)
    return pa.RecordBatch.from_arrays(arrays, schema=arrow_schema)


def build_record_batch(
    ir: Record,
    arrow_schema: pa.Schema,
    host: Dict[str, np.ndarray],
    n: int,
    meta,
) -> pa.RecordBatch:
    asm = _Assembler(host, meta)
    arrays = [
        asm.build(f.type, arrow_schema.field(i).type, f.name, n, None)
        for i, f in enumerate(ir.fields)
    ]
    if not arrays:
        return _empty_fields_batch(n)
    return pa.RecordBatch.from_arrays(arrays, schema=arrow_schema)
