"""Arrow batch → the encoder's device inputs (numpy copy of
``pyruhvro_tpu/ops/encode.py:616-1283``).

The host side of the encode: ``_Extractor`` (``encode.py:616-1182``)
walks the schema IR and the Arrow arrays into per-path numpy lanes (the
keys, dtypes and region order of the reference) and an upper bound of
the output bytes; ``extract_batch`` (``:1225-1267``) pads every lane to
its region's power-of-two bucket (``#src`` with the ``_BIG`` sentinel)
and ``input_entries`` (``:1270``) gives the sorted packed-buffer layout.
``batch_to_struct`` (``:1184``) matches columns by name, with the host
oracle's ``_types_compatible`` (:mod:`..fallback.encoder`).

``host_mode`` (``encode.py:629-643``) gives the host VM's layout
instead (``hostpath/codec.py``, when the native extractor declines a
batch's shape): whole ``#v64`` int64/float64 lanes read off the Arrow
buffers, ``#fix`` dense fixed columns, no ``#dlen`` and no bucket
padding. Left out: the native ``uuid_text`` branch; uuids are rendered
by the numpy branch. Every
``ValueError`` / ``OverflowError`` message is the reference's. The bound
decides ``BatchTooLarge`` and so the codec's halving; it is kept exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from ..errors import mark_value_error
from ..fallback.encoder import _types_compatible
from ..runtime.pack import bucket_len
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
from . import UnsupportedOnDevice
from .fieldprog import ROWS

__all__ = ["extract_batch", "run_extractor", "batch_to_struct",
           "input_entries"]

_BIG = 1 << 30  # ``#src`` pad: a padded element never owns a payload byte


class _Extractor:
    """Walk the schema IR + Arrow arrays, producing the device input
    dict (same path keys the lowering registered) and a byte-capacity
    upper bound. Validity/shape errors match the host oracle's
    (``fallback/encoder.py``): nulls at non-nullable positions, unknown
    enum symbols and out-of-range union type_ids raise ``ValueError``.

    A ``parent`` validity chain (None = all rows live) tracks which
    lanes the encoder will actually read — nulls are only an error where
    the chain is live (a null under a null struct or a non-selected
    union arm is never encoded, so never an error; same as the oracle,
    which never visits masked values)."""

    def __init__(self, host_mode: bool = False) -> None:
        self.arrays: Dict[str, Tuple[np.ndarray, int]] = {}  # key → (arr, region)
        self.byte_bufs: Dict[str, np.ndarray] = {}           # key → u8 buffer
        self.region_len: Dict[int, int] = {}
        self.regions: List[str] = [""]
        self.bound = 0
        # host_mode: produce the native VM's input layout — whole int64/
        # float64 ``#v64`` arrays (no u32 lane split) read zero-copy off
        # the Arrow values buffers, with NO fill_null materialization:
        # the VM consumes-but-never-emits dead entries, so whatever bytes
        # a null slot holds are fine (Arrow defines the buffer exists,
        # not its content there). Device mode keeps defined zeros — the
        # vectorized size pass reads every lane before masking.
        self.host_mode = host_mode

    def put(self, key: str, arr: np.ndarray, region: int) -> None:
        self.arrays[key] = (np.ascontiguousarray(arr), region)

    # -- leaf readers (offset-aware) --------------------------------------

    @staticmethod
    def _raw_fixed_width(arr: pa.Array, np_dtype) -> Optional[np.ndarray]:
        """Zero-copy view of a fixed-width values buffer when the Arrow
        physical layout matches ``np_dtype``'s width (int32/date32,
        int64/timestamp/time64, float32, float64 — NOT boolean, whose
        values are bit-packed). None → caller takes the cast path."""
        t = arr.type
        try:
            w = t.byte_width
        except (ValueError, AttributeError):
            return None
        if w != np.dtype(np_dtype).itemsize or pa.types.is_boolean(t):
            return None
        buf = arr.buffers()[1]
        if buf is None:
            return np.zeros(len(arr), np_dtype)
        return np.frombuffer(
            buf, np_dtype, count=len(arr) + arr.offset
        )[arr.offset:]

    @staticmethod
    def _valid(arr: pa.Array) -> Optional[np.ndarray]:
        if arr.null_count == 0:
            return None
        vbuf = arr.buffers()[0]
        if vbuf is None:  # null_count > 0 without a bitmap: NullArray etc.
            return arr.is_valid().to_numpy(zero_copy_only=False)
        n = len(arr)
        bits = np.frombuffer(
            vbuf, np.uint8, count=(arr.offset + n + 7) // 8
        )
        return np.unpackbits(bits, bitorder="little")[
            arr.offset : arr.offset + n
        ].astype(bool)

    @staticmethod
    def _ints(arr: pa.Array, target: pa.DataType, dtype) -> np.ndarray:
        import pyarrow.compute as pc

        a = arr if arr.type.equals(target) else arr.cast(target)
        if a.null_count:
            a = pc.fill_null(a, 0)
        return a.to_numpy(zero_copy_only=False).astype(dtype, copy=False)

    def _require_valid(self, arr: pa.Array, path: str,
                       parent: Optional[np.ndarray]) -> None:
        """Error on nulls the encoder would actually read."""
        if not arr.null_count:
            return
        dead = ~self._valid(arr)
        if parent is not None:
            dead = dead & parent
        if dead.any():
            i = int(np.flatnonzero(dead)[0])
            raise ValueError(
                f"row {i}: null value for non-nullable Avro position "
                f"{path or '<top>'!r} (no null union there in the schema)"
            )

    # -- recursive walk ---------------------------------------------------

    def extract(self, t: AvroType, arr: pa.Array, path: str,
                region: int, parent: Optional[np.ndarray]) -> None:
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()

        if isinstance(t, Union) and t.is_nullable_pair:
            valid = self._valid(arr)
            if valid is None:
                valid = np.ones(len(arr), bool)
            self.put(path + "#valid", valid.astype(np.uint8), region)
            self.bound += len(arr)  # 1-byte branch varint
            sub = valid if parent is None else (valid & parent)
            self.extract(t.non_null_variant, arr, path, region, sub)
            return

        if isinstance(t, Primitive) and t.name == "null":
            # a null at a null position is its only value: zero wire
            # bytes, as the oracle writes it (a departure from the
            # reference, whose extractor rejects it; ROADMAP.md (c) 1)
            return
        self._require_valid(arr, path, parent)

        if isinstance(t, Primitive):
            self._extract_primitive(t, arr, path, region, parent)
            return
        if isinstance(t, Enum):
            self._extract_enum(t, arr, path, region, parent)
            return
        if isinstance(t, Record):
            prefix = path + "/" if path else ""
            sub = parent
            v = self._valid(arr)
            if v is not None:
                sub = v if sub is None else (v & sub)
            for i, f in enumerate(t.fields):
                self.extract(f.type, arr.field(i), prefix + f.name,
                             region, sub)
            return
        if isinstance(t, Union):
            tids = np.frombuffer(
                arr.buffers()[1], np.int8, count=len(arr) + arr.offset
            )[arr.offset:].astype(np.int32)
            live_bad = (tids < 0) | (tids >= len(t.variants))
            if parent is not None:
                live_bad = live_bad & parent
            if live_bad.any():
                bad = int(tids[live_bad][0])
                raise ValueError(f"union type_id {bad} out of range")
            self.put(path + "#tid", tids, region)
            self.bound += 5 * len(arr)
            for k, v in enumerate(t.variants):
                if not v.is_null():
                    sel = tids == k
                    sub = sel if parent is None else (sel & parent)
                    self.extract(v, arr.field(k), f"{path}/{k}", region,
                                 sub)
            return
        if isinstance(t, (Array, Map)):
            self._extract_repeated(t, arr, path, region, parent)
            return
        if isinstance(t, Fixed):
            self._extract_fixed(t, arr, path, region, parent)
            return
        raise UnsupportedOnDevice(f"type {type(t).__name__} at {path!r}")

    def _extract_fixed(self, t, arr, path, region,
                       parent=None) -> None:
        """Avro ``fixed`` → one raw byte run (size per entry); a
        ``duration`` Arrow input (Duration(ms) int64) converts back to
        the wire's (months, days, ms) u32-LE triple with the oracle's
        divmod arithmetic (``fallback/encoder.py``)."""
        n = len(arr)
        size = t.size
        if t.logical == "decimal":
            self._extract_decimal(arr, path, region, fixed_size=size,
                                  parent=parent)
            return
        if t.logical == "duration":
            import pyarrow.compute as pc

            ms = (
                pc.fill_null(arr.cast(pa.int64()), 0)
                .to_numpy(zero_copy_only=False)
                .astype(np.int64)
            )
            days_total, ms_r = np.divmod(ms, 86_400_000)
            months, days = np.divmod(days_total, 30)
            live = self._valid(arr)
            if parent is not None:
                live = parent if live is None else (live & parent)
            for name, v in (("months", months), ("days", days),
                            ("ms", ms_r)):
                # only lanes the encoder will read can error — dead
                # slots (nulls, non-selected union arms) hold garbage
                bad = (v < 0) | (v >= (1 << 32))
                if live is not None:
                    bad = bad & live
                if bad.any():
                    raise ValueError(
                        f"duration {name} component out of uint32 range "
                        f"at row {int(np.flatnonzero(bad)[0])}"
                    )
            raw = np.ascontiguousarray(
                np.stack(
                    [months.astype(np.uint32), days.astype(np.uint32),
                     ms_r.astype(np.uint32)],
                    axis=1,
                )
            ).view(np.uint8).reshape(-1)
        else:
            buf = arr.buffers()[1]
            if buf is None:
                raw = np.zeros(n * size, np.uint8)
            else:
                raw = np.frombuffer(
                    buf, np.uint8, count=(arr.offset + n) * size
                )[arr.offset * size:]
        if self.host_mode:
            self.put(path + "#fix", raw, region)  # the VM's dense column
        else:
            # fixed runs go through the payload copy: the same #src/#len/
            # #bytes layout as strings, with constant lens
            self.put(
                path + "#src",
                (np.arange(n, dtype=np.int64) * size).astype(np.int32),
                region,
            )
            self.put(path + "#len", np.full(n, size, np.int32), region)
            self.byte_bufs[path + "#bytes"] = np.ascontiguousarray(raw)
        self.bound += size * n

    def _extract_primitive(self, t: Primitive, arr, path, region,
                           parent=None) -> None:
        name = t.name
        if name == "null":
            return
        if name == "int":
            raw = (self._raw_fixed_width(arr, np.int32) if self.host_mode
                   else None)
            self.put(
                path + "#v",
                raw if raw is not None
                else self._ints(arr, pa.int32(), np.int32),
                region,
            )
            self.bound += 5 * len(arr)
        elif name == "long":
            raw = (self._raw_fixed_width(arr, np.int64) if self.host_mode
                   else None)
            v = (raw if raw is not None
                 else self._ints(arr, pa.int64(), np.int64))
            if self.host_mode:
                self.put(path + "#v64", v, region)
            else:
                u = v.view(np.uint64)
                self.put(path + "#v:lo", (u & 0xFFFFFFFF).astype(np.uint32),
                         region)
                self.put(path + "#v:hi", (u >> 32).astype(np.uint32), region)
            self.bound += 10 * len(arr)
        elif name == "float":
            raw = (self._raw_fixed_width(arr, np.float32) if self.host_mode
                   else None)
            if raw is None:
                import pyarrow.compute as pc

                a = pc.fill_null(arr, 0.0) if arr.null_count else arr
                raw = a.to_numpy(zero_copy_only=False).astype(
                    np.float32, copy=False
                )
            self.put(path + "#v", raw, region)
            self.bound += 4 * len(arr)
        elif name == "double":
            raw = (self._raw_fixed_width(arr, np.float64) if self.host_mode
                   else None)
            if raw is None:
                import pyarrow.compute as pc

                a = pc.fill_null(arr, 0.0) if arr.null_count else arr
                raw = a.to_numpy(zero_copy_only=False).astype(
                    np.float64, copy=False
                )
            if self.host_mode:
                self.put(path + "#v64", raw, region)
            else:
                u = raw.view(np.uint64)
                self.put(path + "#v:lo", (u & 0xFFFFFFFF).astype(np.uint32),
                         region)
                self.put(path + "#v:hi", (u >> 32).astype(np.uint32), region)
            self.bound += 8 * len(arr)
        elif name == "boolean":
            self.put(path + "#v", self._ints(arr, pa.uint8(), np.uint8), region)
            self.bound += len(arr)
        elif name == "string":
            if t.logical == "uuid":
                self._extract_uuid(arr, path, region)
            else:
                self._extract_string(arr, path, region)
        elif name == "bytes":
            if t.logical == "decimal":
                self._extract_decimal(arr, path, region, parent=parent)
            else:
                # Binary shares Utf8's offsets+data layout
                self._extract_string(arr, path, region)
        else:
            raise UnsupportedOnDevice(f"primitive {name!r} at {path!r}")

    _HEXCHARS = np.frombuffer(b"0123456789abcdef", np.uint8)

    def _extract_uuid(self, arr, path, region) -> None:
        """FixedSizeBinary(16) → canonical lowercase uuid text (what the
        oracle writes: ``str(UUID(bytes=v))``), vectorized, emitted in
        the string column layout the encode VM consumes."""
        n = len(arr)
        buf = arr.buffers()[1]
        if buf is None:
            raw = np.zeros((n, 16), np.uint8)
        else:
            raw = np.frombuffer(
                buf, np.uint8, count=(arr.offset + n) * 16
            )[arr.offset * 16:].reshape(n, 16)
        chars = np.empty((n, 32), np.uint8)
        chars[:, 0::2] = self._HEXCHARS[raw >> 4]
        chars[:, 1::2] = self._HEXCHARS[raw & 0xF]
        out = np.empty((n, 36), np.uint8)
        out[:, [8, 13, 18, 23]] = ord("-")
        out[:, 0:8] = chars[:, 0:8]
        out[:, 9:13] = chars[:, 8:12]
        out[:, 14:18] = chars[:, 12:16]
        out[:, 19:23] = chars[:, 16:20]
        out[:, 24:36] = chars[:, 20:32]
        # int32 like every #src: n*36 would wrap past ~59.6M rows, but
        # the byte bound (37n < 2^30) splits such batches before any
        # consumer sees these offsets
        self.put(
            path + "#src",
            (np.arange(n, dtype=np.int64) * 36).astype(np.int32),
            region,
        )
        self.put(path + "#len", np.full(n, 36, np.int32), region)
        self.byte_bufs[path + "#bytes"] = np.ascontiguousarray(
            out
        ).reshape(-1)
        self.bound += 37 * n  # 36 chars + 1-byte length varint

    @staticmethod
    def _bitlen64(x: np.ndarray) -> np.ndarray:
        """Vectorized bit length of a uint64 array."""
        bits = np.zeros(x.shape, np.int32)
        v = x.copy()
        for s in (32, 16, 8, 4, 2, 1):
            ge = v >= (np.uint64(1) << np.uint64(s))
            bits += np.where(ge, s, 0).astype(np.int32)
            v = np.where(ge, v >> np.uint64(s), v)
        return bits + (v > 0).astype(np.int32)

    def _extract_decimal(self, arr, path, region, fixed_size=None,
                         parent=None) -> None:
        """Decimal128 values buffer: 16 bytes LE per entry (what the
        encode VM's OP_DEC ops consume). Device mode additionally
        derives per-entry wire byte lengths (``#dlen``, the oracle's
        ``max((abs_bit_length + 8) // 8, 1)``) for bytes-decimals, and
        pre-checks fixed-decimals against their size — both vectorized
        over the u64 halves; only LIVE entries are checked (a null slot
        holds undefined buffer bytes)."""
        n = len(arr)
        buf = arr.buffers()[1]
        if buf is None:
            raw = np.zeros(n * 16, np.uint8)
        else:
            raw = np.frombuffer(
                buf, np.uint8, count=(arr.offset + n) * 16
            )[arr.offset * 16:]
        self.put(path + "#dec", raw, region)
        if not self.host_mode and n:
            w = np.ascontiguousarray(raw).view(np.uint64).reshape(n, 2)
            lo, hi = w[:, 0], w[:, 1]
            neg = (hi >> np.uint64(63)) != 0
            lo_a = np.where(neg, (~lo) + np.uint64(1), lo)
            hi_a = np.where(neg, (~hi) + (lo == 0).astype(np.uint64), hi)
            if fixed_size is None:
                bits = np.where(
                    hi_a > 0, 64 + self._bitlen64(hi_a), self._bitlen64(lo_a)
                )
                self.put(
                    path + "#dlen",
                    np.maximum((bits + 8) // 8, 1).astype(np.int32),
                    region,
                )
            elif fixed_size < 16:
                # signed-range fit: |v| < 2^(8s-1), or == for the most
                # negative value (≙ the VM's check / int.to_bytes)
                live = self._valid(arr)
                if parent is not None:
                    live = parent if live is None else (live & parent)
                sbits = 8 * fixed_size - 1
                if sbits >= 64:
                    l_hi = np.uint64(1) << np.uint64(sbits - 64)
                    l_lo = np.uint64(0)
                else:
                    l_hi = np.uint64(0)
                    l_lo = np.uint64(1) << np.uint64(sbits)
                over = (hi_a > l_hi) | ((hi_a == l_hi) & (lo_a > l_lo)) | (
                    (~neg) & (hi_a == l_hi) & (lo_a == l_lo)
                )
                if live is not None:
                    over = over & live
                if over.any():
                    raise OverflowError(
                        "decimal value does not fit its fixed size"
                    )
        elif not self.host_mode and fixed_size is None:
            self.put(path + "#dlen", np.zeros(0, np.int32), region)
        self.bound += 18 * n  # ≤16 value bytes + length varint

    @staticmethod
    def _utf8_view(arr):
        """(offs, values, lens) numpy views of a Utf8/Binary array's
        buffers, offset-aware and tolerant of absent buffers (legal for
        all-null arrays per the Arrow C data interface). ``offs`` are
        ABSOLUTE positions into ``values``' underlying buffer (a sliced
        array's offs[0] is nonzero); ``values`` covers [0, offs[-1])."""
        n = len(arr)
        off_buf = arr.buffers()[1]
        if off_buf is None:
            offs = np.zeros(n + 1, np.int32)
        else:
            offs = np.frombuffer(off_buf, np.int32,
                                 count=n + arr.offset + 1)[arr.offset:]
        end = int(offs[-1])
        val_buf = arr.buffers()[2]
        values = (
            np.frombuffer(val_buf, np.uint8, count=end)
            if val_buf is not None and end
            else np.zeros(0, np.uint8)
        )
        return offs, values, np.diff(offs).astype(np.int32)

    def _extract_string(self, arr, path, region) -> None:
        n = len(arr)
        offs, values, lens = self._utf8_view(arr)
        base, end = int(offs[0]), int(offs[-1])
        vals = values[base:end]
        src = (offs[:-1] - base).astype(np.int32)
        self.put(path + "#src", src, region)
        self.put(path + "#len", lens, region)
        self.byte_bufs[path + "#bytes"] = vals
        self.bound += 5 * n + int(lens.sum())

    def _extract_enum(self, t: Enum, arr, path, region,
                      parent: Optional[np.ndarray]) -> None:
        n = len(arr)
        if pa.types.is_string(arr.type) and n:
            # vectorized symbol match on the raw utf8 buffers: per
            # symbol, one length filter + one (cand, L) byte compare —
            # replaces pc.index_in's generic hash kernel (~8x on the
            # kafka enum cell). Distinct symbols can't share bytes, so
            # each row matches at most once.
            offs, values, lens = self._utf8_view(arr)
            idx = np.full(n, -1, np.int32)
            L0 = int(lens[0])
            if bool((lens == L0).all()):
                # uniform value width (the typical enum column): dense
                # row-matrix compares, no candidate fancy-indexing —
                # numpy's per-op overhead dominates at this size.
                # Uniform lens ⇒ offsets are a ramp from offs[0], so the
                # slice's bytes are one contiguous [n, L0] block (a
                # sliced array's offs[0] is nonzero).
                base = int(offs[0])
                m = (values[base: base + n * L0].reshape(n, L0)
                     if L0 else None)
                for k, sym in enumerate(t.symbols):
                    sb = np.frombuffer(sym.encode("utf-8"), np.uint8)
                    if len(sb) != L0:
                        continue
                    if L0 == 0:
                        idx[:] = k  # at most one zero-length symbol
                    elif L0 == 1:
                        idx[m[:, 0] == sb[0]] = k
                    else:
                        idx[(m == sb).all(axis=1)] = k
            else:
                for k, sym in enumerate(t.symbols):
                    sb = np.frombuffer(sym.encode("utf-8"), np.uint8)
                    L = len(sb)
                    cand = np.flatnonzero(lens == L)
                    if not cand.size:
                        continue
                    if L == 0:
                        idx[cand] = k
                        continue
                    m = values[
                        offs[:-1][cand, None].astype(np.int64)
                        + np.arange(L)
                    ]
                    idx[cand[(m == sb).all(axis=1)]] = k
            missing = idx < 0
            valid = self._valid(arr)
            if valid is not None:
                missing = missing & valid
            if parent is not None:
                missing = missing & parent
            if missing.any():
                i = int(np.flatnonzero(missing)[0])
                raise ValueError(
                    f"value {arr[i].as_py()!r} is not a symbol of enum "
                    f"{t.fullname}"
                )
            np.maximum(idx, 0, out=idx)
            if valid is not None:
                # null slots may own garbage bytes that happen to match
                # a symbol; the fallback path emits 0 for them — keep
                # the two paths byte-identical
                idx[~valid] = 0
            self.put(path + "#v", idx, region)
            self.bound += 5 * n
            return
        import pyarrow.compute as pc

        idx = pc.index_in(arr, value_set=pa.array(list(t.symbols), pa.utf8()))
        missing = pc.and_(pc.is_null(idx), arr.is_valid()).to_numpy(
            zero_copy_only=False
        )
        if parent is not None:
            missing = missing & parent
        if missing.any():
            i = int(np.flatnonzero(missing)[0])
            raise ValueError(
                f"value {arr[i].as_py()!r} is not a symbol of enum "
                f"{t.fullname}"
            )
        self.put(
            path + "#v",
            pc.fill_null(idx, 0).to_numpy(zero_copy_only=False)
            .astype(np.int32, copy=False),
            region,
        )
        self.bound += 5 * len(arr)

    def _extract_repeated(self, t, arr, path, region: int,
                          parent: Optional[np.ndarray]) -> None:
        rid = len(self.regions)
        self.regions.append(path)
        n = len(arr)
        offs = np.frombuffer(
            arr.offsets.buffers()[1], np.int32,
            count=n + arr.offsets.offset + 1,
        )[arr.offsets.offset:]
        # RAW counts: the device derives the flat item-axis mapping from
        # cumsum(counts), which must mirror the Arrow child layout even
        # at rows the walk later masks out (a null row may still own a
        # nonzero offset range). For nested repetition the counts live on
        # the OUTER item axis (``region``).
        counts = np.diff(offs).astype(np.int32)
        base, end = int(offs[0]), int(offs[-1])
        self.put(path + "#count", counts, region)
        self.region_len[rid] = end - base
        self.bound += 7 * n  # count varint (≤5) + terminator + slack
        # lift the row validity chain onto the item axis
        live = self._valid(arr)
        if parent is not None:
            live = parent if live is None else (live & parent)
        item_parent = (
            None if live is None
            else np.repeat(live, counts)
        )
        if isinstance(t, Array):
            child = arr.values.slice(base, end - base)
            self.extract(t.items, child, path + "/@item", rid, item_parent)
        else:
            keys = arr.keys.slice(base, end - base)
            vals = arr.items.slice(base, end - base)
            self._require_valid(keys, path + "/@key", item_parent)
            self._extract_string(keys, path + "/@key", rid)
            self.extract(t.values, vals, path + "/@val", rid, item_parent)


def batch_to_struct(ir: Record, batch: pa.RecordBatch) -> pa.StructArray:
    """Column-match an Arrow batch against the schema → one StructArray
    mirroring the IR's field order. Columns are matched by NAME
    (missing → error, extras ignored), exactly like the oracle and the
    reference (``serialization_containers.rs:248-267``)."""
    cols = []
    for f in ir.fields:
        idx = batch.schema.get_field_index(f.name)
        if idx == -1:
            raise ValueError(
                f"record batch is missing column {f.name!r} required by "
                f"schema"
            )
        expected = to_arrow_field(f.type, name=f.name, nullable=False).type
        actual = batch.schema.field(idx).type
        if not _types_compatible(actual, expected):
            raise ValueError(
                f"column {f.name!r} has Arrow type {actual}, but the Avro "
                f"schema requires {expected}"
            )
        cols.append(batch.column(idx))
    return pa.StructArray.from_arrays(
        cols, names=[f.name for f in ir.fields]
    ) if cols else pa.array([{}] * batch.num_rows, pa.struct([]))


def run_extractor(ir: Record, batch: pa.RecordBatch,
                  host_mode: bool = False) -> "_Extractor":
    """Walk a column-matched Arrow batch into per-path numpy arrays
    (``host_mode``: the host VM's layout, shared with
    ``hostpath/codec.py``)."""
    ex = _Extractor(host_mode)
    ex.extract(ir, batch_to_struct(ir, batch), "", ROWS, None)
    return ex


def extract_batch(prog, batch: pa.RecordBatch,
                  ir: Record) -> Tuple[Dict[str, np.ndarray], int]:
    """Arrow batch → padded device-input dict + output byte bound.
    ``prog`` is the lowered encode program (``ops/encode.py``
    ``EncProgram``); its regions must be the extractor's. The value
    errors of the batch (a null where none is allowed, an unknown symbol,
    a value that does not fit) are tagged with
    :func:`~..errors.mark_value_error`: the tolerant policies isolate
    their rows."""
    try:
        ex = run_extractor(ir, batch)
    except UnsupportedOnDevice:
        raise
    except (ValueError, OverflowError) as e:
        raise mark_value_error(e)

    if ex.regions != prog.regions:  # pragma: no cover — same walk order
        raise AssertionError("extractor/lowering region mismatch")

    n = batch.num_rows
    ex.region_len[ROWS] = n
    dv: Dict[str, np.ndarray] = {}
    pads = {
        rid: bucket_len(max(ln, 1), minimum=8) for rid, ln in ex.region_len.items()
    }
    for rid, ln in ex.region_len.items():
        act = np.zeros(pads[rid], np.uint8)
        act[:ln] = 1
        dv["#active:%d" % rid] = act
    for key, (arr, rid) in ex.arrays.items():
        # per-entry arrays pad to the region bucket; multi-byte-per-
        # entry arrays (#dec 16/entry, #fix size/entry) exceed it and
        # pad to their own power-of-two bucket so jit shapes stay stable
        P = pads[rid] if len(arr) <= pads[rid] else bucket_len(len(arr))
        if len(arr) < P:
            if key.endswith("#src"):
                # pad with an out-of-range sentinel so padded elements
                # never win the byte→element scatter-max mapping
                padded = np.full(P, _BIG, arr.dtype)
            else:
                padded = np.zeros(P, arr.dtype)
            padded[: len(arr)] = arr
            arr = padded
        dv[key] = arr
    for key, buf in ex.byte_bufs.items():
        V = bucket_len(max(len(buf), 4), minimum=16)
        if len(buf) < V:
            buf = np.concatenate([buf, np.zeros(V - len(buf), np.uint8)])
        dv[key] = np.ascontiguousarray(buf).view(np.uint32)
    return dv, max(ex.bound, 16)


def input_entries(dv: Dict[str, np.ndarray]) -> tuple:
    """The packed-buffer layout: sorted (key, dtype, length) per input
    array, the order in which ``ops/encode.py`` packs them."""
    return tuple(sorted((k, str(v.dtype), v.shape[0]) for k, v in dv.items()))

