"""Record packing (port of ``pyruhvro_tpu/runtime/pack.py:25,81`` and
``pyruhvro_tpu/ops/decode.py:177-203``).

Both walks consume the records unpadded: their bytes concatenated into
one flat uint8 buffer, record ``i`` at ``[offsets[i], offsets[i+1])``.
The pipeline engine (``ops/decode.py``) takes them as one packed launch
buffer, ``[words | starts | lengths | n]``. On the card path the join is
the native, multi-threaded ``concat`` (``csrc/packer.cpp``, built by
``runtime/native.py``); the CPU path and the tests join with
``bytearray().join``, its plain version. A pyarrow binary array
(:class:`..runtime.ingest.DatumView`) is joined already: its values
buffer is the flat concat, on either path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .ingest import DatumView

__all__ = ["bucket_len", "record_lengths", "concat_records",
           "launch_shape", "launch_lanes", "pack_launch_into",
           "LAUNCH_MAX_BYTES"]


def bucket_len(n: int, minimum: int = 16) -> int:
    """Round up to a power of two (≥ minimum)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def record_lengths(data: Sequence[bytes]) -> np.ndarray:
    """Byte length of every datum, as int64."""
    if isinstance(data, DatumView):
        return data.lens()
    return np.fromiter(map(len, data), dtype=np.int64, count=len(data))


def concat_records(data: Sequence[bytes], lens: np.ndarray = None,
                   tail: int = 0, *, native: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``(flat, offsets)``: every datum's bytes in one uint8 array
    (writable for a list) followed by ``tail`` zero bytes, and
    ``offsets[len(data)+1]`` int64 (copy of
    ``pyruhvro_tpu/runtime/pack.py:81-95`` ``concat_records``).
    ``native`` joins with the native ``concat`` (the card path; a failed
    build raises), else with one ``bytearray().join``, its plain version.
    ``lens`` are the datum lengths when the caller has them (the native
    join does not need them). A :class:`DatumView` is not joined: its
    values buffer is ``flat`` (read-only; copied only to append
    ``tail``) and its offsets, rebased to 0, are ``offsets``."""
    if isinstance(data, DatumView):
        offsets = data.offsets()
        flat = data.values()[offsets[0]:offsets[-1]]
        if tail:
            flat = np.concatenate([flat, np.zeros(tail, np.uint8)])
        return flat, offsets - offsets[0]
    if native:
        from .native import load_packer

        lib = load_packer().module
        _max, total = lib.max_len(data)
        flat = np.empty(total + tail, np.uint8)
        flat[total:] = 0
        offsets = np.empty(len(data) + 1, np.int64)
        lib.concat(data, flat, offsets)
        return flat, offsets
    if lens is None:
        lens = record_lengths(data)
    offsets = np.zeros(len(data) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    joined = bytearray().join([*data, bytes(tail)])
    return np.frombuffer(joined, np.uint8), offsets


LAUNCH_MAX_BYTES = 1 << 30  # one launch's datum bytes (int32 cursors)


def launch_shape(n: int, total: int) -> Tuple[int, int]:
    """``(R, B)`` of one pipeline launch over ``n`` records of ``total``
    bytes (``pyruhvro_tpu/ops/decode.py:986-987``): ``R`` lanes, at least
    8, and ``B`` bytes of words, at least 16, both powers of two."""
    return (bucket_len(max(n, 1), minimum=8),
            bucket_len(max(total, 4), minimum=16))


def launch_lanes(offsets: np.ndarray, R: int, B: int,
                 out: np.ndarray = None) -> np.ndarray:
    """The tail of one launch's packed input, ``[starts | lengths | n]``
    as ``2 * R + 1`` uint32, written into ``out`` (or a new array): each
    lane's record start in the words and its length (inactive lanes:
    start ``B``, length 0), then ``n``. ``offsets`` are
    :func:`concat_records` offsets or a slice of them (``n + 1`` entries;
    they may start above 0, and the starts are taken relative to
    ``offsets[0]``). The words before the tail are the records
    concatenated and zero-filled to ``B`` bytes
    (:func:`pack_launch_into`)."""
    n = len(offsets) - 1
    if out is None:
        out = np.empty(2 * R + 1, np.uint32)
    starts = out[:R].view(np.int32)
    starts[:] = B
    # subtract in int64 before the int32 store: a chunk whose absolute base
    # offset passes 2 GiB would overflow an in-place int32 subtraction
    starts[:n] = offsets[:-1] - offsets[0]
    lengths = out[R:2 * R].view(np.int32)
    lengths[n:] = 0
    np.subtract(offsets[1:], offsets[:-1], out=lengths[:n], casting="unsafe")
    out[-1] = n
    return out


def pack_launch_into(out: np.ndarray, flat: np.ndarray, offsets: np.ndarray,
                     R: int, B: int) -> np.ndarray:
    """Write one record run's packed launch buffer ``[words | starts |
    lengths | n]`` into ``out`` (a persistent arena of ``B // 4 + 2 * R +
    1`` uint32) in place: the words zero-padded to ``B`` bytes, then
    :func:`launch_lanes` (copy of ``pyruhvro_tpu/ops/decode.py:177-203``).
    ``flat``/``offsets`` are :func:`concat_records` output or a slice of
    one."""
    W = B // 4
    total = int(offsets[-1] - offsets[0])
    u8 = out[:W].view(np.uint8)
    u8[:total] = flat[:total]
    u8[total:] = 0
    launch_lanes(offsets, R, B, out[W:])
    return out
