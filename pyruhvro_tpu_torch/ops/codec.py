"""Device codec: the object ``api.py`` routes to (slim port of
``pyruhvro_tpu/ops/codec.py:192-380, 496-523``).

One codec per (schema, device, engine mode), memoized on the
``SchemaEntry``. The engine is chosen as the reference chooses it: the
pipeline engine (:class:`.decode.DeviceDecoder`) by default, the
row-padded walk (:class:`.walk_decode.WalkDecoder`, the port of the
Pallas kernel) when ``PYRUHVRO_TPU_PALLAS`` is ``1``/``true``/``mosaic``
and the schema has no nested array/map (a nested schema takes the
pipeline engine under that setting too). Both run on the card.

The codec keeps the reference's batch policy: on the pipeline engine a
batch of ``overlap_chunks(n) > 1`` chunks (8,192 rows or more by
default) decodes through the overlapped chunk path, one RecordBatch per
chunk concatenated into one (``_decode_triples``, ``codec.py:253-263``);
``PYRUHVRO_TPU_OVERLAP=0`` keeps it on one launch, and the row-padded
engine is always one launch. A batch over the engine's single-launch
budget is halved (each half still decodes on the device) with the
malformed row index re-based to the whole batch, and the threaded entry
decodes once and slices the result per chunk, compacting sliced sparse
unions. ``DeviceCapacityExceeded`` reaches the caller: the
port has no host tier.

Encode (``codec.py:382-430``): the encoder (:class:`.encode.DeviceEncoder`,
K3) is built on the first call; a batch whose output bound passes the
launch budget is halved (each half still encodes on the device), and
``BatchTooLarge(n, -1)`` is raised when the halves' concatenation would
overflow int32 offsets; ``encode_threaded`` encodes once and slices.
Where the reference serves from its host tier (a schema outside the
encode subset, one row over the budget, a backend fault), the port
raises.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import pyarrow as pa

from ..errors import BatchTooLarge, MalformedAvro, shift_malformed
from ..runtime.chunking import chunk_bounds
from ..schema.cache import SchemaEntry
from . import UnsupportedOnDevice
from .arrow_build import build_record_batch, compact_union_slices
from .decode import DeviceDecoder, overlap_chunks
from .walk_decode import WalkDecoder, resolve_device

__all__ = ["DeviceCodec", "get_device_codec", "pallas_mode"]


def pallas_mode() -> str:
    """``PYRUHVRO_TPU_PALLAS`` normalized (the reference's ``_pallas_mode``,
    ``codec.py:496-507``): ``"mosaic"`` for ``1``/``true``/``mosaic``, the
    row-padded walk; ``"off"`` for anything else. The reference's
    ``interpret`` has no counterpart: ``device="cpu"`` runs each kernel's
    plain version."""
    raw = os.environ.get("PYRUHVRO_TPU_PALLAS", "").lower()
    return "mosaic" if raw in ("1", "true", "mosaic") else "off"


class DeviceCodec:
    """Schema-bound decode on one torch device."""

    def __init__(self, entry: SchemaEntry, device="cuda", pallas="off"):
        self.ir = entry.ir
        self.arrow_schema = entry.arrow_schema
        self.decoder = None
        if pallas == "mosaic":
            try:
                self.decoder = WalkDecoder(entry.ir, device)
            except UnsupportedOnDevice:
                pass  # nested repetition: the pipeline engine serves it
        if self.decoder is None:
            self.decoder = DeviceDecoder(entry.ir, device,
                                         fingerprint=entry.fingerprint)
        self.device = device
        self._encoder = None

    def _decode_triples(self, data: Sequence[bytes]):
        """One ``(host, n, meta)`` triple per launch chunk: the overlapped
        chunk path on the pipeline engine when ``overlap_chunks`` gives
        more than one chunk, else one launch."""
        dec = self.decoder
        if isinstance(dec, DeviceDecoder):
            k = overlap_chunks(len(data))
            if k > 1:
                return dec.decode_to_columns_overlapped(data, k)
        return [dec.decode_to_columns(data)]

    def decode(self, data: Sequence[bytes]) -> pa.RecordBatch:
        try:
            triples = self._decode_triples(data)
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
        batches = [build_record_batch(self.ir, self.arrow_schema, host, n,
                                      meta) for host, n, meta in triples]
        return batches[0] if len(batches) == 1 else _concat_batches(batches)

    def decode_threaded(self, data: Sequence[bytes],
                        num_chunks: int) -> List[pa.RecordBatch]:
        """Decode once, then slice per chunk with the reference's chunk
        bounds (``deserialize.rs:57-68``)."""
        batch = self.decode(data)
        return [
            compact_union_slices(batch.slice(a, b - a))
            for a, b in chunk_bounds(len(data), num_chunks)
        ]


    def encode(self, batch: pa.RecordBatch) -> pa.Array:
        """Every row as one Avro datum, in one ``BinaryArray``."""
        if self._encoder is None:
            from .encode import DeviceEncoder

            self._encoder = DeviceEncoder(self.ir, self.arrow_schema,
                                          self.device)
        try:
            return self._encoder.encode(batch)
        except BatchTooLarge:
            # the output would pass the launch budget: halve the batch,
            # each half still on the device
            if batch.num_rows < 2:
                raise
            mid = batch.num_rows // 2
            try:
                return pa.concat_arrays([self.encode(batch.slice(0, mid)),
                                         self.encode(batch.slice(mid))])
            except pa.lib.ArrowInvalid:
                # the halves fit, their concatenation overflows int32
                # offsets
                raise BatchTooLarge(batch.num_rows, -1) from None

    def encode_threaded(self, batch: pa.RecordBatch,
                        num_chunks: int) -> List[pa.Array]:
        """Encode the whole batch once and slice the ``BinaryArray`` with
        the reference's chunk bounds (``serialize.rs:38-66``)."""
        arr = self.encode(batch)
        return [arr.slice(a, b - a)
                for a, b in chunk_bounds(batch.num_rows, num_chunks)]


def _concat_batches(batches: List[pa.RecordBatch]) -> pa.RecordBatch:
    """Concatenate RecordBatches into one (pyarrow-version tolerant)."""
    if hasattr(pa, "concat_batches"):
        return pa.concat_batches(batches)
    return pa.Table.from_batches(batches).combine_chunks().to_batches()[0]


def get_device_codec(entry: SchemaEntry, device="cuda") -> DeviceCodec:
    """The memoized codec of this schema on ``device``. The engine mode is
    read once here and is part of the memo key (as in
    ``pyruhvro_tpu/ops/codec.py:510-523``): toggling
    ``PYRUHVRO_TPU_PALLAS`` between calls gives a codec that honours the
    new value."""
    dev = resolve_device(device)
    mode = pallas_mode()
    return entry.get_extra(f"device_codec:{dev}:pallas={mode}",
                           lambda: DeviceCodec(entry, dev, mode))
