"""Public entry points of the port (counterparts of
``pyruhvro_tpu/api.py:868`` ``deserialize_array``, ``:981``
``deserialize_array_threaded`` and ``:1156`` ``serialize_record_batch``;
upstream ``src/lib.rs:56-106``).

All run on the card by default (``device="cuda"``) and raise
``RuntimeError`` when there is none; ``device="cpu"`` runs the kernels'
plain PyTorch versions and is taken only when the caller asks for it. ``data`` is a
list of Avro datums (``bytes``). Malformed input raises
:class:`~pyruhvro_tpu_torch.errors.MalformedAvro` naming the first bad
row; a schema outside the device subset raises
:class:`~pyruhvro_tpu_torch.ops.UnsupportedOnDevice`, a batch past the
item-slot limit :class:`~pyruhvro_tpu_torch.errors.DeviceCapacityExceeded`
(the port has no host tier to serve either). ``serialize_record_batch``
raises the reference's ``ValueError`` for a batch that does not fit the
schema, and :class:`~pyruhvro_tpu_torch.errors.BatchTooLarge` for one row
whose output passes the launch budget.
"""

from __future__ import annotations

from typing import List, Sequence

import pyarrow as pa

from .ops.codec import get_device_codec
from .schema.cache import get_or_parse_schema

__all__ = ["deserialize_array", "deserialize_array_threaded",
           "serialize_record_batch"]


def deserialize_array(data: Sequence[bytes], schema: str, *,
                      device="cuda") -> pa.RecordBatch:
    """Decode Avro datums into a single RecordBatch."""
    entry = get_or_parse_schema(schema)
    return get_device_codec(entry, device).decode(data)


def deserialize_array_threaded(data: Sequence[bytes], schema: str,
                               num_chunks: int, *,
                               device="cuda") -> List[pa.RecordBatch]:
    """Decode into ``num_chunks`` RecordBatches, one per chunk, with
    upstream's chunk boundaries (``len // num_chunks`` rows each, the
    remainder in the last). The batch decodes once and is sliced."""
    entry = get_or_parse_schema(schema)
    return get_device_codec(entry, device).decode_threaded(data, num_chunks)


def serialize_record_batch(batch, schema: str, num_chunks: int, *,
                           device="cuda") -> List[pa.Array]:
    """Encode a RecordBatch (or a Table) into Avro datums, one
    ``BinaryArray`` per chunk with upstream's chunk boundaries. The batch
    encodes once and is sliced."""
    entry = get_or_parse_schema(schema)
    if isinstance(batch, pa.Table):
        batches = batch.combine_chunks().to_batches()
        batch = batches[0] if batches else pa.RecordBatch.from_pylist(
            [], schema=batch.schema)
    return get_device_codec(entry, device).encode_threaded(batch, num_chunks)
