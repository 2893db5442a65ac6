"""Record packing (port of ``pyruhvro_tpu/runtime/pack.py:25,81``).

The walk consumes the records unpadded: their bytes concatenated into one
flat uint8 buffer, record ``i`` at ``[offsets[i], offsets[i+1])``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["bucket_len", "record_lengths", "concat_records"]


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
