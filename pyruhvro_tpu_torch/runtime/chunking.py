"""Chunking policy (copy of ``pyruhvro_tpu/runtime/chunking.py:18-37``).

≙ ``clamp_chunks`` (``deserialize.rs:50-55``) and ``build_slices``
(``deserialize.rs:57-68``): ``num_chunks`` is clamped to
``[1, max(rows, 1)]``; slices are ``len // num_chunks`` rows each with the
remainder folded into the LAST chunk.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["clamp_chunks", "chunk_bounds", "bounds_rows"]


def bounds_rows(ab: Tuple[int, int]) -> int:
    """Row count of one (start, stop) chunk bound: the pool's per-chunk
    attribution (the chunk span's ``rows`` and ``pool.worker_rows``)."""
    return ab[1] - ab[0]


def clamp_chunks(num_chunks: int, data_len: int) -> int:
    return max(1, min(num_chunks, max(data_len, 1)))


def chunk_bounds(data_len: int, num_chunks: int) -> List[Tuple[int, int]]:
    """(start, stop) per chunk; remainder goes to the last chunk."""
    num_chunks = clamp_chunks(num_chunks, data_len)
    chunk_size = data_len // num_chunks
    bounds = []
    for i in range(num_chunks):
        start = i * chunk_size
        stop = data_len if i == num_chunks - 1 else start + chunk_size
        bounds.append((start, stop))
    return bounds
