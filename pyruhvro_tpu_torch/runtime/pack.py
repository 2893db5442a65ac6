"""Record packing (port of ``pyruhvro_tpu/runtime/pack.py:25``).

The walk consumes records row-padded: one record per row of a
``[R, BW*4]`` uint8 matrix, zero past each record's length.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["bucket_len", "record_lengths", "pack_rows"]


def bucket_len(n: int, minimum: int = 16) -> int:
    """Round up to a power of two (≥ minimum)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def record_lengths(data: Sequence[bytes]) -> np.ndarray:
    """Byte length of every datum, as int64."""
    return np.fromiter(map(len, data), dtype=np.int64, count=len(data))


def pack_rows(data: Sequence[bytes], n_rows: int, row_bytes: int) -> np.ndarray:
    """``[n_rows, row_bytes]`` uint8: datum ``i`` at ``[i, :len_i]``, zeros
    elsewhere (rows past ``len(data)`` stay all zero). Every datum must
    fit ``row_bytes``."""
    padded = np.zeros((n_rows, row_bytes), np.uint8)
    if data:
        joined = b"".join(d.ljust(row_bytes, b"\0") for d in data)
        padded[: len(data)] = np.frombuffer(joined, np.uint8).reshape(
            len(data), row_bytes
        )
    return padded
