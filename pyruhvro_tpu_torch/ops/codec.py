"""Device codec: the object ``api.py`` routes to (slim port of
``pyruhvro_tpu/ops/codec.py:192-380``).

One codec per (schema, device), memoized on the ``SchemaEntry``. It
decodes through :class:`WalkDecoder` and keeps the reference's batch
policy: a batch over the single-launch byte budget is halved (each half
still decodes on the device) with the malformed row index re-based to
the whole batch, and the threaded entry decodes once and slices the
result per chunk, compacting sliced sparse unions.
"""

from __future__ import annotations

from typing import List, Sequence

import pyarrow as pa

from ..errors import BatchTooLarge, MalformedAvro, shift_malformed
from ..runtime.chunking import chunk_bounds
from ..schema.cache import SchemaEntry
from .arrow_build import build_record_batch, compact_union_slices
from .walk_decode import WalkDecoder, resolve_device

__all__ = ["DeviceCodec", "get_device_codec"]


class DeviceCodec:
    """Schema-bound decode on one torch device."""

    def __init__(self, entry: SchemaEntry, device="cuda"):
        self.ir = entry.ir
        self.arrow_schema = entry.arrow_schema
        self.decoder = WalkDecoder(entry.ir, device)

    def decode(self, data: Sequence[bytes]) -> pa.RecordBatch:
        try:
            host, n, meta = self.decoder.decode_to_columns(data)
        except BatchTooLarge:
            # one launch is bounded in bytes: halve the batch — each half
            # still decodes on the device — and concatenate the results
            if len(data) < 2:
                raise
            mid = len(data) // 2
            left = self.decode(data[:mid])
            try:
                right = self.decode(data[mid:])
            except MalformedAvro as e:
                # the right half reports half-local row indices
                raise shift_malformed(e, mid) from None
            return _concat_batches([left, right])
        return build_record_batch(self.ir, self.arrow_schema, host, n, meta)

    def decode_threaded(self, data: Sequence[bytes],
                        num_chunks: int) -> List[pa.RecordBatch]:
        """Decode once, then slice per chunk with the reference's chunk
        bounds (``deserialize.rs:57-68``)."""
        batch = self.decode(data)
        return [
            compact_union_slices(batch.slice(a, b - a))
            for a, b in chunk_bounds(len(data), num_chunks)
        ]


def _concat_batches(batches: List[pa.RecordBatch]) -> pa.RecordBatch:
    """Concatenate RecordBatches into one (pyarrow-version tolerant)."""
    if hasattr(pa, "concat_batches"):
        return pa.concat_batches(batches)
    return pa.Table.from_batches(batches).combine_chunks().to_batches()[0]


def get_device_codec(entry: SchemaEntry, device="cuda") -> DeviceCodec:
    """The memoized codec of this schema on ``device``."""
    dev = resolve_device(device)
    return entry.get_extra(f"device_codec:{dev}",
                           lambda: DeviceCodec(entry, dev))
