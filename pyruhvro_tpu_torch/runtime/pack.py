"""Record packing (port of ``pyruhvro_tpu/runtime/pack.py:25,81`` and
``pyruhvro_tpu/ops/decode.py:177-203``).

Both walks consume the records unpadded: their bytes concatenated into
one flat uint8 buffer, record ``i`` at ``[offsets[i], offsets[i+1])``.
The pipeline engine (``ops/decode.py``) takes them as one packed launch
buffer, ``[words | starts | lengths | n]``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["bucket_len", "record_lengths", "concat_records",
           "launch_shape", "launch_lanes", "LAUNCH_MAX_BYTES"]


def bucket_len(n: int, minimum: int = 16) -> int:
    """Round up to a power of two (≥ minimum)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def record_lengths(data: Sequence[bytes]) -> np.ndarray:
    """Byte length of every datum, as int64."""
    return np.fromiter(map(len, data), dtype=np.int64, count=len(data))


def concat_records(data: Sequence[bytes], lens: np.ndarray = None,
                   tail: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``(flat, offsets)``: every datum's bytes in one writable uint8 array
    followed by ``tail`` zero bytes, and ``offsets[len(data)+1]`` int64
    (copy of ``pyruhvro_tpu/runtime/pack.py:81`` ``concat_records``, one
    join instead of the native shim). ``lens`` are the datum lengths when
    the caller has them."""
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


def launch_lanes(lens: np.ndarray, R: int, B: int) -> np.ndarray:
    """The tail of one launch's packed input, ``[starts | lengths | n]``
    as ``2 * R + 1`` uint32: each lane's record start in the words and its
    length (inactive lanes: start ``B``, length 0), then ``n``. The words
    before it are the records concatenated and zero-filled to ``B`` bytes
    (``ops/decode.py`` ``DeviceDecoder.launch_buffer``); together they are
    the buffer of ``pyruhvro_tpu/ops/decode.py:177-203``
    ``pack_launch_into``. ``lens`` are the datum lengths."""
    n = len(lens)
    out = np.empty(2 * R + 1, np.uint32)
    starts = out[:R].view(np.int32)
    starts[:] = B
    starts[:n] = np.cumsum(lens) - lens
    lengths = out[R:2 * R].view(np.int32)
    lengths[:] = 0
    lengths[:n] = lens
    out[-1] = n
    return out
