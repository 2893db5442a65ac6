"""Canonical per-column content digests (copy of
``pyruhvro_tpu/runtime/coldigest.py``, whole).

The audit (:mod:`.audit`) compares a call's result with an independent
re-execution. Comparing value by value would cost more than the shadow
and drag pyarrow's sliced-union rendering into the comparison, so each
side is reduced to one streaming hash per column over its *logical*
content:

* validity, as the effective per-row bits (bit-packed little-endian);
* per-row **lengths** for variable-size layouts, never absolute
  offsets, so a zero-copy slice and a freshly built array agree;
* value bytes with null (and union-irrelevant) rows zeroed;
* union type ids with the irrelevant lanes masked to ``-1``, and each
  child hashed under its lane mask;
* children of a list or map restricted to the intervals of its valid
  rows, so bytes outside the window never reach the hash.

A sliced batch, its compacted repair and a compact rebuild of the same
rows digest equal, while one flipped payload bit changes the column's
digest. Chunking is normalised too: :func:`column_digests` concatenates
a column's chunks logically before hashing, so the same rows chunked
differently digest equal. numpy and pyarrow only.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, Iterable, List, Tuple, Union

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

__all__ = [
    "array_digest",
    "batch_digest",
    "column_digests",
    "input_digest",
]


def _new_hash():
    return hashlib.blake2b(digest_size=16)


def _valid_mask(arr: pa.Array) -> np.ndarray:
    """Per-row validity as a bool vector (union arrays carry no
    top-level validity; their relevance comes from the lane mask)."""
    n = len(arr)
    if pa.types.is_union(arr.type) or arr.null_count == 0:
        return np.ones(n, dtype=bool)
    return pc.is_valid(arr).to_numpy(zero_copy_only=False).astype(
        bool, copy=False)


def _true_runs(eff: np.ndarray) -> List[Tuple[int, int]]:
    """Maximal ``[start, stop)`` runs of True — lets the byte-level
    paths hash contiguous valid regions in O(runs) updates."""
    n = len(eff)
    if n == 0:
        return []
    padded = np.zeros(n + 2, dtype=np.int8)
    padded[1:-1] = eff
    d = np.diff(padded)
    return list(zip(np.flatnonzero(d == 1).tolist(),
                    np.flatnonzero(d == -1).tolist()))


def _byte_width(t: pa.DataType) -> int:
    """Fixed byte width of a flat type, or 0 (variable/nested/bool)."""
    try:
        bw = t.byte_width
        if bw is not None and bw > 0:
            return int(bw)
    except (ValueError, AttributeError):
        pass
    try:
        bits = t.bit_width
        if bits and bits % 8 == 0:
            return bits // 8
    except (ValueError, AttributeError):
        pass
    return 0


def _window_offsets(arr: pa.Array, big: bool, n: int) -> np.ndarray:
    """The window's ``n+1`` raw offsets read straight from the offsets
    buffer (absolute into the FULL child; callers hash only diffs)."""
    odt, osz = (np.int64, 8) if big else (np.int32, 4)
    buf = arr.buffers()[1]
    return np.frombuffer(buf, odt, count=n + 1,
                         offset=arr.offset * osz).astype(np.int64)


def _update_intervals(h, child: pa.Array, off: np.ndarray,
                      eff: np.ndarray) -> None:
    """Hash ``child`` restricted to the intervals of the valid rows —
    the canonicalization that makes a sliced list and its compacted
    rebuild agree even when a null row's interval still holds bytes."""
    pieces = [child.slice(int(off[s]), int(off[e] - off[s]))
              for s, e in _true_runs(eff) if off[e] > off[s]]
    if not pieces:
        restricted = child.slice(0, 0)
    elif len(pieces) == 1:
        restricted = pieces[0]
    else:
        restricted = pa.concat_arrays(pieces)
    _update(h, restricted, np.ones(len(restricted), dtype=bool))


def _update(h, arr: pa.Array, mask: np.ndarray) -> None:
    """Fold one array's canonical content into ``h``. ``mask`` marks
    the rows that are relevant (False under a union lane the row does
    not occupy); masked-out rows hash as if null."""
    t = arr.type
    n = len(arr)
    h.update(b"T" + str(t).encode() + b"\x00" + struct.pack("<q", n))
    eff = _valid_mask(arr) & mask
    h.update(np.packbits(eff, bitorder="little").tobytes())
    if n == 0 or pa.types.is_null(t) or not eff.any():
        return

    if pa.types.is_boolean(t):
        bits = np.frombuffer(arr.buffers()[1], np.uint8)
        vals = np.unpackbits(bits, bitorder="little",
                             count=arr.offset + n)[arr.offset:]
        vals = vals.astype(bool) & eff
        h.update(np.packbits(vals, bitorder="little").tobytes())
        return

    if pa.types.is_string(t) or pa.types.is_large_string(t) \
            or pa.types.is_binary(t) or pa.types.is_large_binary(t):
        big = (pa.types.is_large_string(t)
               or pa.types.is_large_binary(t))
        off = _window_offsets(arr, big, n)
        lens = np.where(eff, np.diff(off), 0)
        h.update(lens.astype("<i8").tobytes())
        data = arr.buffers()[2]
        if data is not None:
            view = memoryview(data)
            for s, e in _true_runs(eff):
                h.update(view[off[s]:off[e]])
        return

    if pa.types.is_list(t) or pa.types.is_large_list(t):
        off = _window_offsets(arr, pa.types.is_large_list(t), n)
        h.update(np.where(eff, np.diff(off), 0).astype("<i8").tobytes())
        _update_intervals(h, arr.values, off, eff)
        return

    if pa.types.is_map(t):
        off = _window_offsets(arr, False, n)
        h.update(np.where(eff, np.diff(off), 0).astype("<i8").tobytes())
        _update_intervals(h, arr.keys, off, eff)
        _update_intervals(h, arr.items, off, eff)
        return

    if pa.types.is_struct(t):
        for i in range(t.num_fields):
            h.update(b"F" + t.field(i).name.encode() + b"\x00")
            child = arr.field(i)
            if len(child) > n:  # defensive: un-windowed accessor
                child = child.slice(arr.offset, n)
            _update(h, child, eff)
        return

    if pa.types.is_union(t) and t.mode == "sparse":
        tids = np.frombuffer(arr.buffers()[1], np.int8, count=n,
                             offset=arr.offset)
        h.update(np.where(eff, tids, -1).astype(np.int8).tobytes())
        try:
            codes = list(t.type_codes)
        except AttributeError:
            codes = list(range(t.num_fields))
        for j in range(t.num_fields):
            code = int(codes[j])
            h.update(b"U" + struct.pack("<b", code))
            child = arr.field(j)
            if len(child) > n:  # un-windowed child on a sliced union
                child = child.slice(arr.offset, n)
            _update(h, child, eff & (tids == code))
        return

    if pa.types.is_dictionary(t):
        _update(h, arr.dictionary_decode(), mask)
        return

    w = _byte_width(t)
    if w:
        mm = np.frombuffer(arr.buffers()[1], np.uint8, count=n * w,
                           offset=arr.offset * w).reshape(n, w).copy()
        mm[~eff] = 0
        h.update(mm.tobytes())
        return

    # last resort for layouts without a fast lane (dense unions, future
    # types): hash the python values of the relevant rows. Compact
    # first — pyarrow's scalar access mis-reads some sliced layouts
    # (see ops/arrow_build.py compact_union_slices).
    if arr.offset:
        arr = pa.concat_arrays([arr])
    vals = arr.to_pylist()
    for i in np.flatnonzero(eff).tolist():
        h.update(repr(vals[i]).encode())


def array_digest(arr: Union[pa.Array, pa.ChunkedArray]) -> str:
    """Canonical content digest of one array (chunked layout is
    normalized by logical concatenation)."""
    if isinstance(arr, pa.ChunkedArray):
        chunks = [c for c in arr.chunks if len(c)]
        if not chunks:
            arr = pa.array([], type=arr.type)
        elif len(chunks) == 1:
            arr = chunks[0]
        else:
            arr = pa.concat_arrays(chunks)
    h = _new_hash()
    _update(h, arr, np.ones(len(arr), dtype=bool))
    return h.hexdigest()


def _as_batches(result) -> List[pa.RecordBatch]:
    if isinstance(result, pa.Table):
        return result.to_batches()
    if isinstance(result, pa.RecordBatch):
        return [result]
    return [b for b in result]


def column_digests(result) -> Dict[str, str]:
    """Per-column digests of one result — a RecordBatch, a Table, or a
    list of per-chunk RecordBatches. Chunk bounds do not matter: the
    same rows split differently digest equal."""
    batches = _as_batches(result)
    if not batches:
        return {}
    out: Dict[str, str] = {}
    for i, name in enumerate(batches[0].schema.names):
        chunks = [b.column(i) for b in batches]
        out[name] = array_digest(
            chunks[0] if len(chunks) == 1 else pa.chunked_array(chunks))
    return out


def batch_digest(result) -> str:
    """One digest over every column (names included) — the per-result
    key the fleet merge compares across replicas."""
    h = _new_hash()
    for name, d in column_digests(result).items():
        h.update(name.encode() + b"\x00" + d.encode())
    return h.hexdigest()


def input_digest(data) -> str:
    """Digest of a call's INPUT: length-prefixed datum bytes for
    decode, the batch digest for encode. Two replicas that saw the
    same input share this key, which is what lets the fleet merge
    flag divergent *results* for it."""
    if isinstance(data, (pa.RecordBatch, pa.Table)):
        return batch_digest(data)
    h = _new_hash()
    count = 0
    for d in data:
        if not isinstance(d, (bytes, bytearray, memoryview)):
            d = d.as_py() if hasattr(d, "as_py") else bytes(d)
        h.update(struct.pack("<q", len(d)))
        h.update(d)
        count += 1
    h.update(struct.pack("<q", count))
    return h.hexdigest()
