"""Public entry points of the port (counterparts of the five functions of
``pyruhvro_tpu/api.py:868-1304``; upstream ``src/lib.rs:56-147``).

* ``deserialize_array(data, schema)`` → one ``pyarrow.RecordBatch``
* ``deserialize_array_threaded(data, schema, num_chunks)`` → one
  RecordBatch per chunk, with upstream's chunk bounds
* ``deserialize_array_threaded_spawn`` — the same result (upstream's
  spawn variant differs only in its host thread pool)
* ``serialize_record_batch(batch, schema, num_chunks)`` → one
  ``BinaryArray`` per chunk
* ``serialize_record_batch_spawn`` — the same result

``backend=``: ``"device"`` (the default) runs on the card
(``device="cuda"``, raising ``RuntimeError`` when there is none) or, only
when the caller asks for it with ``device="cpu"``, on the kernels' plain
PyTorch versions; ``"host"`` runs the pure-Python oracle
(:mod:`.fallback`) and ignores ``device``. The reference's ``"auto"``
(its tier router) and ``"tpu"`` raise ``ValueError``: the router is not
ported (``ROADMAP.md`` (a) 8) and the port has no TPU. ``tenant=`` and
``trace_ctx=`` wait for the planes they feed.

``data`` is a list of Avro datums (``bytes``) or a pyarrow
``BinaryArray`` / ``LargeBinaryArray`` (or a ``ChunkedArray`` of either;
:mod:`.runtime.ingest`), whose buffers the record pack reads directly.

The error policy (``api.py:394-712`` of the reference): ``on_error=
"raise"`` (the default) raises :class:`~.errors.MalformedAvro` naming the
first bad row; ``"skip"`` drops and quarantines corrupt rows
(:func:`last_quarantine`, or ``return_errors=True`` for ``(result,
[QuarantinedRecord, ...])``); ``"null"`` also keeps the row count, with
all-null rows, on schemas whose top-level fields are all nullable (and
degrades to skip elsewhere). On the device tier every bad row of a batch
is named by the walk's error rows in one pass, quarantined at once, and
each chunk's survivors decode in one more launch; the oracle serves a
chunk only where an error of a record's value names no row (invalid
UTF-8, a decimal past its precision or a duration overflow in the Arrow
assembly), as in the reference.

Unlike the reference, which sends any exception of a tolerant decode to
the oracle, the port isolates only those two kinds of data error (and,
on encode, the extraction's value errors, :func:`~.errors.is_value_error`).
Every other error propagates as under ``"raise"``: ``RuntimeError`` (a
failed build or launch, a launch precondition, no card),
:class:`DeadlineExceeded`, ``DeviceCapacityExceeded``, ``BatchTooLarge``,
``UnsupportedOnDevice`` and any untagged ``ValueError``.

``timeout_s``: the call's budget in seconds (``None`` defers to
``PYRUHVRO_TPU_DEADLINE_S``), checked at call start, at each capacity
rung, at each chunk of the overlapped path and at each tolerant resume;
expiry raises :class:`DeadlineExceeded` whatever ``on_error`` says.
``PYRUHVRO_TPU_MAX_DATUM_BYTES`` rejects (or quarantines) longer datums
before any decode work.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import pyarrow as pa

from .errors import MalformedAvro, is_value_error, mark_value_error
from .fallback.decoder import (
    compile_reader,
    decode_pairs_tolerant,
    decode_to_record_batch,
    rows_to_record_batch,
)
from .fallback.encoder import compile_encoder_plan, encode_record_batch
from .fallback.io import max_datum_bytes
from .ops.codec import _concat_batches, get_device_codec
from .runtime import deadline, quarantine
from .runtime.chunking import chunk_bounds
from .runtime.ingest import as_datum_input
from .runtime.pack import record_lengths
from .schema.cache import SchemaEntry, get_or_parse_schema
from .schema.model import Union

__all__ = [
    "deserialize_array",
    "deserialize_array_threaded",
    "deserialize_array_threaded_spawn",
    "serialize_record_batch",
    "serialize_record_batch_spawn",
]

# the errors a tolerant call looks at; of the device tier's, only the walk's
# row errors (``MalformedAvro.indices``) and the host stages' value errors
# (``errors.is_value_error``) are isolated, every other one propagates
_DATA_ERRORS = (ValueError, OverflowError)


def _check_backend(backend: str) -> str:
    if backend in ("auto", "tpu"):
        raise ValueError(
            f"backend={backend!r} is not available in the port: the tier "
            f"router ('auto') is not ported (ROADMAP.md (a) 8) and the port "
            f"has no TPU ('tpu'); use 'device' or 'host'")
    if backend not in ("device", "host"):
        raise ValueError(
            f"backend must be 'device' or 'host', got {backend!r}")
    return backend


def _check_on_error(on_error: str) -> str:
    if on_error not in ("raise", "skip", "null"):
        raise ValueError(
            f"on_error must be 'raise', 'skip' or 'null', got {on_error!r}"
        )
    return on_error


def _codec(entry: SchemaEntry, backend: str, device):
    """The device codec, or None for the host oracle."""
    return None if backend == "host" else get_device_codec(entry, device)


def _host_reader(entry: SchemaEntry):
    """The schema's memoized oracle reader."""
    return entry.get_extra("host_reader", lambda: compile_reader(entry.ir))


def _host_plan(entry: SchemaEntry):
    """The schema's memoized oracle encode plan."""
    return entry.get_extra("host_encode_plan",
                           lambda: compile_encoder_plan(entry.ir))


# -- the error policy (on_error="skip"/"null") ------------------------------
#
# Optimistic: the batch decodes on its tier at full speed, and only a data
# error pays extra work. The device tier's error rows give every bad row of
# a chunk (``MalformedAvro.indices``), so its offenders quarantine at once
# and its survivors decode in one more launch. An error of a record's value
# that names no row (the Arrow assembly's) sends the chunk to the oracle,
# per record. Any other error of the device tier propagates.


def _too_long(data) -> np.ndarray:
    """The rows longer than PYRUHVRO_TPU_MAX_DATUM_BYTES (none when the
    knob is unset: one env read)."""
    limit = max_datum_bytes()
    if not limit:
        return np.zeros(0, np.int64)
    return np.flatnonzero(record_lengths(data) > limit)


def _enforce_max_datum(data) -> None:
    """The PYRUHVRO_TPU_MAX_DATUM_BYTES ceiling under ``on_error="raise"``."""
    over = _too_long(data)
    if over.size:
        j = int(over[0])
        raise MalformedAvro(
            f"record {j}: datum of {len(data[j])} bytes exceeds "
            f"PYRUHVRO_TPU_MAX_DATUM_BYTES={max_datum_bytes()}",
            index=j, err_name="datum_too_large", tier="policy",
        )


def _row_nullable(ir) -> bool:
    """True when every top-level field admits null — the schemas where
    ``on_error="null"`` can keep the row count; anywhere else the policy
    degrades to skip."""
    return all(
        isinstance(f.type, Union) and f.type.null_index is not None
        for f in ir.fields
    )


def _concat(batches: List[pa.RecordBatch], entry) -> pa.RecordBatch:
    batches = [b for b in batches if b.num_rows]
    if not batches:
        return rows_to_record_batch([], entry.ir, entry.arrow_schema)
    return batches[0] if len(batches) == 1 else _concat_batches(batches)


def _oracle_pairs(pairs, entry, quar) -> pa.RecordBatch:
    """Per-record last resort: every ``(global index, datum)`` pair
    through the oracle, offenders into ``quar``. Covers wire-level poison
    (captured per record by the reader) and value-level poison (datums
    whose values cannot build, isolated by bisecting the Arrow build)."""
    rows, errs = decode_pairs_tolerant(pairs, entry.ir, _host_reader(entry))
    for gi, datum, name in errs:
        quar.append(quarantine.QuarantinedRecord(gi, datum, name,
                                                 "fallback"))
    bad = {gi for gi, _d, _n in errs}
    triples = [(gi, d, v) for (gi, d), v in
               zip([pr for pr in pairs if pr[0] not in bad], rows)]

    def build(tris):
        return rows_to_record_batch([v for _, _, v in tris], entry.ir,
                                    entry.arrow_schema)

    try:
        return build(triples)
    except _DATA_ERRORS:
        pass

    def bisect(tris):
        if not tris:
            return []
        try:
            return [build(tris)]
        except _DATA_ERRORS:
            if len(tris) == 1:
                gi, d, _v = tris[0]
                quar.append(quarantine.QuarantinedRecord(
                    gi, d, "bad_value", "fallback"))
                return []
            mid = len(tris) // 2
            return bisect(tris[:mid]) + bisect(tris[mid:])

    return _concat(bisect(triples), entry)


def _named_rows(e, n: int) -> Optional[dict]:
    """``{row: slug}`` of an error that names every bad row (the walk's
    error rows, all in ``[0, n)``), else None."""
    idxs = getattr(e, "indices", None)
    if not idxs or not all(0 <= i < n for i, _ in idxs):
        return None
    names: dict = {}
    for i, nm in idxs:
        names.setdefault(i, nm or "malformed")
    return names


def _tolerant_decode(impl, entry, pairs, quar) -> pa.RecordBatch:
    """Decode ``(global index, datum)`` pairs under a tolerant policy →
    the survivors' batch, in order; offenders go into ``quar``. ``impl``
    is the device codec, or None for the oracle."""
    if impl is None:
        return _oracle_pairs(pairs, entry, quar)
    parts: List[pa.RecordBatch] = []
    while pairs:
        # a deadline is a call contract and outranks the policy: stop the
        # salvage here, naming the first record it never reached
        deadline.check(index=pairs[0][0], site="tolerant.resume")
        try:
            parts.append(impl.decode([d for _, d in pairs]))
            break
        except _DATA_ERRORS as e:
            names = _named_rows(e, len(pairs))
            if names is not None:
                tier = getattr(e, "tier", None) or "device"
                for i in sorted(names):
                    gi, d = pairs[i]
                    quar.append(quarantine.QuarantinedRecord(
                        gi, d, names[i], tier))
                pairs = [p for j, p in enumerate(pairs) if j not in names]
            elif is_value_error(e):
                # no row named (invalid UTF-8, a decimal past its
                # precision, a duration overflow in the assembly): the
                # oracle serves the rest per record
                parts.append(_oracle_pairs(pairs, entry, quar))
                break
            else:
                raise
    return _concat(parts, entry)


def _decode_tolerant(impl, entry, data, num_chunks, policy):
    """The tolerant decode body → ``(one batch per chunk, entries)``;
    ``num_chunks=None`` is the single-batch entry, which has one chunk and
    no optimistic pass. The clean case is the ``"raise"`` shape, one
    decode of the batch. When that fails on the walk's error rows, or on
    a value error that names no row, each chunk decodes on its own, as in
    the reference: which rows a launch names, and by which slug, depends
    on where they fall in it (the last lane of a launch reads past its
    end, another lane its neighbour's bytes), so only a chunk's own
    launch gives the reference's entries."""
    n = len(data)
    bounds = [(0, n)] if num_chunks is None else chunk_bounds(n, num_chunks)
    too_long = [int(j) for j in _too_long(data)]
    if impl is not None and num_chunks is not None and not too_long:
        try:
            out = impl.decode_threaded(data, num_chunks)
            quarantine.publish([])
            return out, []
        except _DATA_ERRORS as e:
            if _named_rows(e, n) is None and not is_value_error(e):
                raise
    quar: List[quarantine.QuarantinedRecord] = []
    out = []
    for a, b in bounds:
        entries = [quarantine.QuarantinedRecord(j, data[j], "datum_too_large",
                                                "policy")
                   for j in too_long if a <= j < b]
        drop = {e.index for e in entries}
        pairs = [(j, d) for j, d in enumerate(data[a:b], a) if j not in drop]
        batch = _tolerant_decode(impl, entry, pairs, entries)
        quar.extend(entries)
        out.append(_apply_null_policy(batch, entries, a, b - a, policy,
                                      entry))
    quarantine.publish(quar)
    return out, quar


def _encode_bisect(encode_fn, batch, base, quar, tier):
    """Isolate encode offenders by recursive halving (encode errors carry
    no row index): good halves encode whole, a single failing row is
    quarantined with ``datum=None``. O(n) when clean, O(bad × log n)
    extra per offender. Only value errors are isolated; any other error
    propagates."""
    try:
        return [encode_fn(batch)]
    except _DATA_ERRORS as e:
        if not is_value_error(e):
            raise
        if batch.num_rows <= 1:
            if batch.num_rows == 1:
                quar.append(quarantine.QuarantinedRecord(
                    base, None, "encode_" + type(e).__name__.lower(), tier))
            return []
        mid = batch.num_rows // 2
        return (_encode_bisect(encode_fn, batch.slice(0, mid), base, quar,
                               tier)
                + _encode_bisect(encode_fn, batch.slice(mid), base + mid,
                                 quar, tier))


def _tolerant_encode(impl, entry, batch, policy):
    """Encode under a tolerant policy → ``(binary_array, entries)``; the
    clean case is one normal encode. Under ``"null"`` on an all-nullable
    schema the offending rows encode as all-null rows, so the output row
    count matches the input."""
    if impl is not None:
        encode_fn, tier = impl.encode, "device"
    else:
        plan = _host_plan(entry)
        tier = "fallback"

        def encode_fn(b):
            try:
                return pa.array(encode_record_batch(b, entry.ir, plan),
                                pa.binary())
            except _DATA_ERRORS as e:
                raise mark_value_error(e)  # the oracle has no device fault

    quar: List[quarantine.QuarantinedRecord] = []
    arrays = _encode_bisect(encode_fn, batch, 0, quar, tier)
    if quar and policy == "null" and _row_nullable(entry.ir):
        bad = {e.index for e in quar}
        indices = [None if j in bad else j for j in range(batch.num_rows)]
        try:
            repaired = batch.take(pa.array(indices, type=pa.int64()))
        except (pa.lib.ArrowNotImplementedError, pa.lib.ArrowInvalid):
            repaired = None  # a batch ``take`` cannot null: the skip shape
        if repaired is not None:
            try:
                return encode_fn(repaired), quar
            except _DATA_ERRORS as e:
                if not is_value_error(e):
                    raise
    if not arrays:
        return pa.array([], pa.binary()), quar
    return (arrays[0] if len(arrays) == 1
            else pa.concat_arrays(arrays)), quar


def _apply_null_policy(batch, entries, base, n, policy, entry):
    """Under ``on_error="null"`` re-inflate the survivors' batch to ``n``
    rows with all-null rows at the quarantined positions (schemas whose
    top-level fields are all nullable); otherwise the skip shape."""
    if policy != "null" or not entries or not _row_nullable(entry.ir):
        return batch
    bad = {e.index - base for e in entries}
    indices: List[Optional[int]] = []
    k = 0
    for j in range(n):
        if j in bad:
            indices.append(None)
        else:
            indices.append(k)
            k += 1
    if k != batch.num_rows:  # survivor accounting mismatch: keep skip
        return batch
    try:
        return batch.take(pa.array(indices, type=pa.int64()))
    except (pa.lib.ArrowNotImplementedError, pa.lib.ArrowInvalid):
        # e.g. sparse-union columns without take support: degrade to skip
        return batch


# -- the entry points --------------------------------------------------------


def deserialize_array(
    data: Sequence[bytes], schema: str, *, backend: str = "device",
    device="cuda", on_error: str = "raise", return_errors: bool = False,
    timeout_s: Optional[float] = None,
) -> pa.RecordBatch:
    """Decode Avro datums into a single RecordBatch (≙ upstream's
    ``deserialize_array``, ``src/lib.rs:56-71``). The keywords are the
    module's."""
    _check_backend(backend)
    _check_on_error(on_error)
    data = as_datum_input(data)
    entry = get_or_parse_schema(schema)
    with deadline.scope(timeout_s, op="deserialize_array"):
        impl = _codec(entry, backend, device)
        deadline.check(site="call_start")
        return _deserialize_one(impl, entry, data, on_error, return_errors)


def _deserialize_one(impl, entry, data, on_error, return_errors):
    """The single-batch decode body."""
    if on_error == "raise":
        _enforce_max_datum(data)
        if impl is None:
            batch = decode_to_record_batch(data, entry.ir, entry.arrow_schema,
                                           _host_reader(entry))
        else:
            batch = impl.decode(data)
        return (batch, []) if return_errors else batch
    out, quar = _decode_tolerant(impl, entry, data, None, on_error)
    return (out[0], quar) if return_errors else out[0]


def deserialize_array_threaded(
    data: Sequence[bytes], schema: str, num_chunks: int, *,
    backend: str = "device", device="cuda", on_error: str = "raise",
    return_errors: bool = False, timeout_s: Optional[float] = None,
) -> List[pa.RecordBatch]:
    """Decode into one RecordBatch per chunk, with upstream's chunk
    bounds (``len // num_chunks`` rows each, the remainder in the last;
    ≙ ``src/lib.rs:73-89``). On the device tier the batch decodes once
    and is sliced. Chunk bounds are computed on the input rows: under
    ``"skip"`` a chunk's batch holds its surviving rows (``"null"`` keeps
    each chunk's row count on all-nullable schemas)."""
    _check_backend(backend)
    _check_on_error(on_error)
    data = as_datum_input(data)
    entry = get_or_parse_schema(schema)
    with deadline.scope(timeout_s, op="deserialize_array_threaded"):
        impl = _codec(entry, backend, device)
        deadline.check(site="call_start")
        return _deserialize_chunks(impl, entry, data, num_chunks, on_error,
                                   return_errors)


def _deserialize_chunks(impl, entry, data, num_chunks, on_error,
                        return_errors):
    """The chunked decode body (the reference's without its process
    pool, ``ROADMAP.md`` (a) 6)."""
    if on_error == "raise":
        _enforce_max_datum(data)
        if impl is not None:
            out = impl.decode_threaded(data, num_chunks)
        else:
            reader = _host_reader(entry)
            out = [decode_to_record_batch(data[a:b], entry.ir,
                                          entry.arrow_schema, reader,
                                          index_base=a)
                   for a, b in chunk_bounds(len(data), num_chunks)]
        return (out, []) if return_errors else out
    out, quar = _decode_tolerant(impl, entry, data, num_chunks, on_error)
    return (out, quar) if return_errors else out


def deserialize_array_threaded_spawn(
    data: Sequence[bytes], schema: str, num_chunks: int, *,
    backend: str = "device", device="cuda", on_error: str = "raise",
    return_errors: bool = False, timeout_s: Optional[float] = None,
) -> List[pa.RecordBatch]:
    """Signature-parity alias of :func:`deserialize_array_threaded`
    (≙ ``src/lib.rs:108-128``; the thread-pool flavour is a host-side
    detail)."""
    return deserialize_array_threaded(
        data, schema, num_chunks, backend=backend, device=device,
        on_error=on_error, return_errors=return_errors, timeout_s=timeout_s)


def serialize_record_batch(
    batch, schema: str, num_chunks: int, *, backend: str = "device",
    device="cuda", on_error: str = "raise", return_errors: bool = False,
    timeout_s: Optional[float] = None,
) -> List[pa.Array]:
    """Encode a RecordBatch (or a Table) into Avro datums, one
    ``BinaryArray`` per chunk with upstream's chunk bounds
    (≙ ``src/lib.rs:91-106``). On the device tier the batch encodes once
    and is sliced. Under ``"skip"`` rows whose values cannot encode (a
    decimal that does not fit its fixed size) are dropped and
    quarantined with ``datum=None``, and the chunks are taken over the
    surviving rows; ``"null"`` encodes them as all-null rows on
    all-nullable schemas. The device tier raises
    :class:`~.errors.BatchTooLarge` for one row whose output passes the
    launch budget."""
    _check_backend(backend)
    _check_on_error(on_error)
    entry = get_or_parse_schema(schema)
    if isinstance(batch, pa.Table):
        batches = batch.combine_chunks().to_batches()
        batch = batches[0] if batches else pa.RecordBatch.from_pylist(
            [], schema=batch.schema)
    with deadline.scope(timeout_s, op="serialize_record_batch"):
        impl = _codec(entry, backend, device)
        deadline.check(site="call_start")
        return _serialize_chunks(impl, entry, batch, num_chunks, on_error,
                                 return_errors)


def _serialize_chunks(impl, entry, batch, num_chunks, on_error,
                      return_errors):
    """The chunked encode body (the reference's without its process
    pool)."""
    if on_error == "raise":
        if impl is not None:
            out = impl.encode_threaded(batch, num_chunks)
        else:
            plan = _host_plan(entry)
            out = [pa.array(encode_record_batch(batch.slice(a, b - a),
                                                entry.ir, plan), pa.binary())
                   for a, b in chunk_bounds(batch.num_rows, num_chunks)]
        return (out, []) if return_errors else out
    arr, quar = _tolerant_encode(impl, entry, batch, on_error)
    out = [arr.slice(a, b - a) for a, b in chunk_bounds(len(arr), num_chunks)]
    quarantine.publish(quar)
    return (out, quar) if return_errors else out


def serialize_record_batch_spawn(
    batch, schema: str, num_chunks: int, *, backend: str = "device",
    device="cuda", on_error: str = "raise", return_errors: bool = False,
    timeout_s: Optional[float] = None,
) -> List[pa.Array]:
    """Signature-parity alias of :func:`serialize_record_batch`
    (≙ ``src/lib.rs:130-147``)."""
    return serialize_record_batch(
        batch, schema, num_chunks, backend=backend, device=device,
        on_error=on_error, return_errors=return_errors, timeout_s=timeout_s)
