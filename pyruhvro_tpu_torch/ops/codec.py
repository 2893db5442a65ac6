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
malformed row index re-based to the whole batch. The threaded entry
fans out over the cards (K5, :class:`..parallel.ShardedDecoder`,
``codec.py:316-380`` of the reference) when the codec is on the pipeline
engine, the caller's device is ``"cuda"`` without an index and more than
one card is visible: one chunk per card, the shards' batches returned as
they are when their count is the caller's, else concatenated and sliced
again. Otherwise (one card, ``"cuda:k"``, ``device="cpu"``, the
row-padded engine) it decodes once and slices the result per chunk,
compacting sliced sparse unions. A shard over the launch's byte budget
sends the call to the one-card path, which halves it; a capacity limit
answers on the host under ``"auto"`` and raises under ``"device"``; a
fault of the fan-out raises (the reference decodes such a call again on
one chip, ``ROADMAP.md`` (c) 10).

Encode (``codec.py:382-430``): the encoder (:class:`.encode.DeviceEncoder`,
K3) is built on the first call; a batch whose output bound passes the
launch budget is halved (each half still encodes on the device), and
``BatchTooLarge(n, -1)`` is raised when the halves' concatenation would
overflow int32 offsets; ``encode_threaded`` encodes once and slices.

The host answers (``codec.py:268-298, 404-430`` of the reference) apply
only where the caller allowed the host tier, ``backend="auto"``, which
calls through :meth:`DeviceCodec.with_host_answers`: a batch the card
cannot take (``DeviceCapacityExceeded``), one datum over the launch
budget (``BatchTooLarge`` at one row), ``UnsupportedOnDevice`` per batch
(K4's tile budget), and on encode a schema outside the encode subset or
one row over the budget are served by the native host tier, or by the
oracle outside its subset, each counted in ``device.host_answer`` and
``device.host_answer.<why>`` and annotated on the span as
``device_host_answer``. Under ``backend="device"`` every one of them
raises. A backend fault (``RuntimeError``, ``OSError``,
``MemoryError``, but not a deadline: the reference's
``faults.degradable``) raises under both backends: it is counted in
``device.call_failure`` and annotated on the span as
``device_degraded`` (``codec.py:110-117``), and the reference's
``device_backend`` breaker and host retry are not ported
(``ROADMAP.md`` (c) 9).
"""

from __future__ import annotations

from typing import List, Sequence

import pyarrow as pa
import torch

from ..errors import (BatchTooLarge, DeviceCapacityExceeded, MalformedAvro,
                      mark_value_error, shift_malformed)
from ..runtime import deadline, knobs, metrics, telemetry
from ..runtime.chunking import chunk_bounds
from ..schema.cache import SchemaEntry
from . import UnsupportedOnDevice
from .arrow_build import build_record_batch, compact_union_slices
from .decode import DeviceDecoder, overlap_chunks
from .walk_decode import WalkDecoder, resolve_device

__all__ = ["DeviceCodec", "HostAnswering", "get_device_codec", "pallas_mode"]


def _degradable(e: BaseException) -> bool:
    """The reference's fault taxonomy (``runtime/faults.py:57-69``): a
    backend or runtime fault, not a data, capacity or deadline
    condition."""
    return (isinstance(e, (RuntimeError, OSError, MemoryError))
            and not isinstance(e, deadline.DeadlineExceeded))


def _device_call_failed(e: BaseException) -> None:
    """Count and annotate one device fault; the caller re-raises it. Not
    ported: the reference's ``device_backend`` breaker, which this feeds
    there, and its host retry (``ROADMAP.md`` (c) 9: a failure of the
    card raises)."""
    metrics.inc("device.call_failure")
    telemetry.annotate(device_degraded=type(e).__name__)


def pallas_mode() -> str:
    """``PYRUHVRO_TPU_PALLAS`` normalized (the reference's ``_pallas_mode``,
    ``codec.py:496-507``): ``"mosaic"`` for ``1``/``true``/``mosaic``, the
    row-padded walk; ``"off"`` for anything else. The reference's
    ``interpret`` has no counterpart: ``device="cpu"`` runs each kernel's
    plain version. Read through ``knobs``, so a value that is none of
    these counts ``knob.parse_error``."""
    return "mosaic" if knobs.get_enum("PYRUHVRO_TPU_PALLAS") == "mosaic" \
        else "off"


class DeviceCodec:
    """Schema-bound decode on one torch device."""

    def __init__(self, entry: SchemaEntry, device="cuda", pallas="off"):
        self.entry = entry
        self.ir = entry.ir
        self.arrow_schema = entry.arrow_schema
        self.fingerprint = entry.fingerprint
        self.decoder = None
        if pallas == "mosaic":
            try:
                self.decoder = WalkDecoder(entry.ir, device,
                                           fingerprint=entry.fingerprint)
            except UnsupportedOnDevice:
                pass  # nested repetition: the pipeline engine serves it
        if self.decoder is None:
            self.decoder = DeviceDecoder(entry.ir, device,
                                         fingerprint=entry.fingerprint)
        self.device = device
        self._encoder = None
        # the encode subset's refusal of this schema, kept so that it is
        # found once (raised under backend="device", answered on the
        # host under "auto")
        self._encode_unsupported = None
        self._host_view = None
        self._sharded = None  # the fan-out: None = not decided yet

    def with_host_answers(self) -> "HostAnswering":
        """This codec as ``backend="auto"`` calls it: the batches the card
        cannot take are answered on the host tier."""
        if self._host_view is None:
            self._host_view = HostAnswering(self)
        return self._host_view

    def _host_answer(self, why: str) -> None:
        metrics.inc("device.host_answer")
        # metric-key: device.host_answer.<why>
        metrics.inc("device.host_answer." + why)
        telemetry.annotate(device_host_answer=why)

    def _host_decode(self, data, why: str) -> pa.RecordBatch:
        """Decode a batch the card handed back on the host tier: the
        native VM inside its subset, else the oracle (the reference's
        ``_host_decode``)."""
        from ..api import _host_reader, _native_host_codec
        from ..fallback.decoder import decode_to_record_batch

        self._host_answer(why)
        native = _native_host_codec(self.entry)
        if native is not None:
            return native.decode(data)
        with telemetry.phase("fallback.decode_s", rows=len(data)):
            return decode_to_record_batch(data, self.ir, self.arrow_schema,
                                          _host_reader(self.entry))

    def _host_encode(self, batch: pa.RecordBatch, why: str) -> pa.Array:
        """Encode a batch the card handed back on the host tier."""
        from ..api import _host_plan, _native_host_codec
        from ..fallback.encoder import encode_record_batch

        self._host_answer(why)
        native = _native_host_codec(self.entry)
        if native is not None:
            return native.encode(batch)
        with telemetry.phase("fallback.encode_s", rows=batch.num_rows):
            try:
                return pa.array(encode_record_batch(batch, self.ir,
                                                    _host_plan(self.entry)),
                                pa.binary())
            except (ValueError, OverflowError) as e:
                raise mark_value_error(e)  # the oracle has no device fault

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

    def decode(self, data: Sequence[bytes], *,
               host_ok: bool = False) -> pa.RecordBatch:
        """Decode ``data`` into one RecordBatch on the card; ``host_ok``
        (``backend="auto"``) lets the host tier answer the batches the
        card cannot take."""
        try:
            return self._decode(data, host_ok)
        except Exception as e:
            if _degradable(e):
                _device_call_failed(e)
            raise

    def _decode(self, data: Sequence[bytes], host_ok: bool) -> pa.RecordBatch:
        try:
            triples = self._decode_triples(data)
        except BatchTooLarge:
            # one launch is bounded in bytes: halve the batch — each half
            # still decodes on the device — and concatenate the results
            if len(data) < 2:
                if host_ok:  # one datum over the budget
                    return self._host_decode(data, "batch_too_large")
                raise
            mid = len(data) // 2
            left = self._decode(data[:mid], host_ok)
            try:
                right = self._decode(data[mid:], host_ok)
            except MalformedAvro as e:
                # the right half reports half-local row indices
                raise shift_malformed(e, mid) from None
            return _concat_batches([left, right])
        except DeviceCapacityExceeded:
            # valid Avro whose item counts pass the card's limits
            if host_ok:
                return self._host_decode(data, "capacity")
            raise
        except UnsupportedOnDevice:
            # a per-batch limit of the row-padded engine (K4's tile)
            if host_ok:
                return self._host_decode(data, "unsupported")
            raise
        batches = [build_record_batch(self.ir, self.arrow_schema, host, n,
                                      meta) for host, n, meta in triples]
        return batches[0] if len(batches) == 1 else _concat_batches(batches)

    def _sharded_decoder(self):
        """The fan-out over every visible card, or None
        (``codec.py:316-334`` of the reference): only on the pipeline
        engine, for ``device="cuda"`` without an index, and with more than
        one card visible."""
        if self._sharded is None:
            fan_out = (isinstance(self.decoder, DeviceDecoder)
                       and self.device.type == "cuda"
                       and self.device.index is None
                       and torch.cuda.device_count() > 1)
            if fan_out:
                from ..parallel import ShardedDecoder

                self._sharded = ShardedDecoder(base=self.decoder)
            else:
                self._sharded = False
        return self._sharded or None

    def decode_threaded(self, data: Sequence[bytes], num_chunks: int, *,
                        host_ok: bool = False) -> List[pa.RecordBatch]:
        """One RecordBatch per chunk, with the reference's chunk bounds
        (``deserialize.rs:57-68``; ``codec.py:336-380`` of the reference):
        on the fan-out when there is one, else decoded once and sliced."""
        bounds = chunk_bounds(len(data), num_chunks)
        sd = self._sharded_decoder() if len(data) else None
        if sd is not None:
            batches = self._decode_sharded(sd, data, host_ok)
            if batches is not None:
                if len(batches) == len(bounds):
                    # the shards were cut with the reference's bounds too
                    return batches
                whole = _concat_batches(batches)
                return [compact_union_slices(whole.slice(a, b - a))
                        for a, b in bounds]
        batch = (self.decode(data, host_ok=True) if host_ok
                 else self.decode(data))
        return [compact_union_slices(batch.slice(a, b - a))
                for a, b in bounds]

    def _decode_sharded(self, sd, data: Sequence[bytes], host_ok: bool):
        """The shards' batches; None when a shard passes the launch's byte
        budget (the one-card path halves the batch, still on the card)."""
        try:
            return sd.decode(data, self.ir, self.arrow_schema)
        except BatchTooLarge:
            return None
        except DeviceCapacityExceeded:
            if host_ok:
                return [self._host_decode(data, "capacity")]
            raise
        except Exception as e:
            # no quiet fall-through to one card: a fault raises
            if _degradable(e):
                _device_call_failed(e)
            raise


    def encode(self, batch: pa.RecordBatch, *,
               host_ok: bool = False) -> pa.Array:
        """Every row as one Avro datum, in one ``BinaryArray``; ``host_ok``
        as for :meth:`decode`."""
        try:
            return self._encode(batch, host_ok)
        except Exception as e:
            if _degradable(e):
                _device_call_failed(e)
            raise

    def _encode(self, batch: pa.RecordBatch, host_ok: bool) -> pa.Array:
        if self._encoder is None and self._encode_unsupported is None:
            from .encode import DeviceEncoder

            try:
                self._encoder = DeviceEncoder(self.ir, self.arrow_schema,
                                              self.device,
                                              fingerprint=self.fingerprint)
            except UnsupportedOnDevice as e:
                self._encode_unsupported = e
        if self._encode_unsupported is not None:
            # a schema outside the encode subset
            if host_ok:
                return self._host_encode(batch, "unsupported")
            raise self._encode_unsupported
        try:
            return self._encoder.encode(batch)
        except BatchTooLarge:
            # the output would pass the launch budget: halve the batch,
            # each half still on the device
            if batch.num_rows < 2:
                if host_ok:  # one row over the budget
                    return self._host_encode(batch, "batch_too_large")
                raise
            mid = batch.num_rows // 2
            try:
                return pa.concat_arrays([
                    self._encode(batch.slice(0, mid), host_ok),
                    self._encode(batch.slice(mid), host_ok)])
            except pa.lib.ArrowInvalid:
                # the halves fit, their concatenation overflows int32
                # offsets
                raise BatchTooLarge(batch.num_rows, -1) from None

    def encode_threaded(self, batch: pa.RecordBatch, num_chunks: int, *,
                        host_ok: bool = False) -> List[pa.Array]:
        """Encode the whole batch once and slice the ``BinaryArray`` with
        the reference's chunk bounds (``serialize.rs:38-66``)."""
        arr = (self.encode(batch, host_ok=True) if host_ok
               else self.encode(batch))
        return [arr.slice(a, b - a)
                for a, b in chunk_bounds(batch.num_rows, num_chunks)]


class HostAnswering:
    """A :class:`DeviceCodec` as ``backend="auto"`` calls it: the same
    codec, decoder and kernels, with ``host_ok=True`` on every call."""

    __slots__ = ("codec", "decoder")

    def __init__(self, codec: DeviceCodec):
        self.codec = codec
        self.decoder = codec.decoder

    def decode(self, data: Sequence[bytes]) -> pa.RecordBatch:
        return self.codec.decode(data, host_ok=True)

    def decode_threaded(self, data: Sequence[bytes],
                        num_chunks: int) -> List[pa.RecordBatch]:
        return self.codec.decode_threaded(data, num_chunks, host_ok=True)

    def encode(self, batch: pa.RecordBatch) -> pa.Array:
        return self.codec.encode(batch, host_ok=True)

    def encode_threaded(self, batch: pa.RecordBatch,
                        num_chunks: int) -> List[pa.Array]:
        return self.codec.encode_threaded(batch, num_chunks, host_ok=True)


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
