"""Datum input as pyarrow binary arrays (copy of
``pyruhvro_tpu/runtime/ingest.py``: ``DatumView``, with its native
descriptor ``native_parts``, and ``as_datum_input``).

Every deserialize entry point accepts a pyarrow ``BinaryArray`` /
``LargeBinaryArray`` (or a ``ChunkedArray`` of either) of datums — the
shape ``serialize_record_batch`` returns — besides a list of ``bytes``.
The decoders' record pack (``runtime/pack.py`` ``concat_records``)
reads the array's own offsets and values buffers: the values are the
records already concatenated, so no per-datum ``bytes`` object is made.
The host oracle and the tolerant policies see a sequence of ``bytes``
through :class:`DatumView`'s sequence protocol, and the host tier's VM
through :meth:`DatumView.native_parts`, which hands it the array's
buffers.
"""

from __future__ import annotations

from typing import Iterator, Union

import numpy as np
import pyarrow as pa

__all__ = ["DatumView", "as_datum_input"]


class DatumView:
    """A pyarrow binary array presented as a ``Sequence[bytes]``.

    Slicing returns another (zero-copy) ``DatumView``; integer access
    and iteration materialize individual ``bytes`` objects — only the
    paths that need Python objects pay for them.
    """

    __slots__ = ("arr",)

    def __init__(self, arr: Union[pa.BinaryArray, pa.LargeBinaryArray]):
        self.arr = arr

    def __len__(self) -> int:
        return len(self.arr)

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self.arr))
            if step != 1:
                raise ValueError("DatumView slices must be contiguous")
            return DatumView(self.arr.slice(start, max(stop - start, 0)))
        if i < 0:
            i += len(self.arr)
        return self.arr[i].as_py()

    def __iter__(self) -> Iterator[bytes]:
        for v in self.arr:
            yield v.as_py()

    def native_parts(self):
        """The zero-copy native descriptor:
        ``("arrowbuf", offsets_buffer, values_buffer, start, n, width)``
        — the tuple keeps the pyarrow buffers alive for the duration of
        the native call (the C side holds its own Py_buffer views)."""
        arr = self.arr
        width = 8 if pa.types.is_large_binary(arr.type) else 4
        bufs = arr.buffers()  # [validity, offsets, values]
        offsets = bufs[1]
        values = bufs[2]
        if offsets is None:  # empty array without buffers
            offsets = b"\x00" * ((arr.offset + len(arr) + 1) * width)
        if values is None:  # all-empty datums: no values buffer
            values = b""
        return ("arrowbuf", offsets, values, arr.offset, len(arr), width)

    def offsets(self) -> np.ndarray:
        """The ``len + 1`` offsets of this view's datums into
        :meth:`values`, as int64 (not rebased to 0)."""
        arr = self.arr
        if len(arr) == 0 or arr.buffers()[1] is None:
            return np.zeros(1, np.int64)
        dt = np.int64 if pa.types.is_large_binary(arr.type) else np.int32
        offs = np.frombuffer(arr.buffers()[1], dtype=dt,
                             count=arr.offset + len(arr) + 1)
        return offs[arr.offset:].astype(np.int64)

    def values(self) -> np.ndarray:
        """The array's values buffer as read-only uint8 (empty when the
        array has none)."""
        buf = self.arr.buffers()[2]
        return (np.zeros(0, np.uint8) if buf is None
                else np.frombuffer(buf, np.uint8))

    def lens(self) -> np.ndarray:
        """Per-datum byte lengths straight off the offsets buffer (the
        MAX_DATUM_BYTES screen without materializing datums)."""
        return np.diff(self.offsets())

    def total_bytes(self) -> int:
        """The datums' bytes in all, ``lens().sum()``, read off the two
        end offsets (no pass over the datums)."""
        arr = self.arr
        if len(arr) == 0 or arr.buffers()[1] is None:
            return 0
        dt = np.int64 if pa.types.is_large_binary(arr.type) else np.int32
        offs = np.frombuffer(arr.buffers()[1], dtype=dt,
                             count=arr.offset + len(arr) + 1)
        return int(offs[-1]) - int(offs[arr.offset])


def as_datum_input(data):
    """Normalize a deserialize call's ``data`` argument.

    pyarrow Binary/LargeBinary arrays (and single-type ChunkedArrays of
    them) wrap into :class:`DatumView`; anything else passes through
    untouched. Arrays with nulls are rejected — a null is not a datum,
    and silently decoding it as empty would hide producer bugs."""
    if isinstance(data, pa.ChunkedArray):
        # one contiguous array (combine_chunks' return type varies
        # across pyarrow versions, so flatten explicitly)
        if data.num_chunks == 1:
            data = data.chunk(0)
        elif data.num_chunks:
            data = pa.concat_arrays(data.chunks)
        else:
            data = pa.array([], data.type)
    if isinstance(data, pa.Array) and (
        pa.types.is_binary(data.type) or pa.types.is_large_binary(data.type)
    ):
        if data.null_count:
            raise ValueError(
                f"datum array carries {data.null_count} null(s); every "
                f"datum must be a (possibly empty) binary value"
            )
        return DatumView(data)
    return data
