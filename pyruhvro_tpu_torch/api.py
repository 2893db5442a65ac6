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
PyTorch versions; ``"host"`` runs on the CPU and ignores ``device``: the
native C++ VM (:mod:`.hostpath`, tier ``"native"``) serves the schemas
inside :func:`.gate.host_supported`, the pure-Python oracle
(:mod:`.fallback`, tier ``"fallback"``) the rest, and every schema under
``PYRUHVRO_TPU_NO_NATIVE=1`` (the reference's ``_route_candidates`` and
``_native_host_codec``, ``api.py:222-306``). ``"auto"`` (the reference's
default) lets the router choose (``runtime/router.py``): the static
verdict keeps a call on the card whenever a card is present (reason
``device_selected``), sends it to the host tier when the caller passed
``device="cpu"`` (``devices_cpu_only``), when it has fewer rows than
``PYRUHVRO_TPU_DEVICE_MIN_ROWS`` (``device_min_rows``) or when the schema
is outside the device subset (``gate_fail``); under
``PYRUHVRO_TPU_AUTOTUNE=1`` the learned cost model picks the arm
(``autotune_model``, ``autotune_explore``). Under ``"auto"`` the batches
the card cannot take are answered on the host tier
(``ops/codec.py`` :meth:`~.ops.codec.DeviceCodec.with_host_answers`); a
failed build or launch, or no card under ``device="cuda"``, raises under
every backend (``ROADMAP.md`` (c) 9: the reference's per-schema
device-failure latch, its ``device_backend`` breaker and its host retry
are not ported). ``"tpu"`` raises ``ValueError``: the port has no TPU.
``tenant=`` (an optional caller id; the reference's ``api.py:871-927``)
feeds the memory accounting's heavy-hitter sketch keyed (tenant, schema
fingerprint) with the call's rows and approximate input bytes before the
root span opens (``memacct.attribute``; untagged calls pool under
``"-"``), and rides on the root span as its ``tenant`` attribute. Inside
the root span each call ticks the memory accounting (``memacct.tick``,
throttled to one real pass a second: the TTL sweep and the
``PYRUHVRO_TPU_MEM_HIGH_WATER`` check), so that a pressure relief
annotates the call that ran it. The process arm's workers re-enter this
API without a tenant, as the reference's do (``api.py:713-751``): the
parent attributes the whole call once.

Every call goes through ``router.decide`` and ends with
``router.observe``, which leaves one entry in the routing ledger
(``telemetry.snapshot()["routing"]``). ``PYRUHVRO_TPU_POOL=process``
fans a chunked call of the host tier out to spawned worker processes
(:func:`_proc_map`), each re-entering this API with ``backend="host"``
on its chunk.

A clean call is then offered to the differential audit
(``runtime/audit.py``; on by default, ``PYRUHVRO_TPU_AUDIT_BUDGET``
0.005): about one call in ``cost ratio / budget`` is decoded again
through the oracle (an encode is decoded back from its wire) inside the
call's root span, sampler scope and deadline, and the per-column digests
are compared (:func:`_maybe_audit_decode`, :func:`_maybe_audit_encode`).
A mismatch or a shadow error never changes the result or its tier.

Telemetry (``runtime/telemetry.py``): each call opens the reference's
root span (``api.deserialize_array``, ``api.deserialize_array_threaded``
or ``api.serialize_record_batch``) and, inside it, the deep sampler's
``sampling.call_scope`` (``runtime/sampling.py``: about one call in a
period runs the deep path, ``RouteDecision.sampled``), with ``rows``,
``backend`` and
``schema`` (the fingerprint), and records its tier with
``set_route(tier, reason)`` (tiers ``device``, ``native``,
``fallback``; reasons ``backend_device``, ``backend_host`` and the
router's). The
oracle's work runs under ``fallback.decode_s`` / ``fallback.encode_s``,
the tolerant paths under ``decode.tolerant_s`` / ``encode.tolerant_s``.
``trace_ctx=`` (a W3C ``traceparent`` string, a
``traceprop.TraceContext`` or a ``(trace_id, span_id)`` tuple) makes the
root span join that trace; without it the ambient context, then
``PYRUHVRO_TPU_TRACEPARENT``, applies, else a new trace id is minted
(``api.py:904-912`` of the reference). A malformed value counts
``trace.parse_error`` and is ignored. Quarantine entries carry the
call's trace id. A call of the device tier with telemetry on reads the
card's memory watermarks once, after its work (``device_obs.note_memory``;
the reference reads them after each decode and encode).

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
assembly), as in the reference. The native tier names the first bad
row of a pass: the rows before it decode in one pass, the offender is
quarantined, and the rest is decoded again on one VM thread, so that the
VM stops at the next offender (``api.py:542-590`` of the reference).

Unlike the reference, which sends any exception of a tolerant decode to
the oracle, the port isolates only the data errors that name a row (the
walk's error rows, the native VM's first bad row) and the value errors
that name none (and, on encode, the extraction's value errors,
:func:`~.errors.is_value_error`). Every other error propagates as under
``"raise"``: ``RuntimeError`` (a failed build or launch, a launch
precondition, no card, a fault of the native VM),
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

from .errors import (MalformedAvro, is_value_error, mark_value_error,
                     shift_malformed)
from .gate import device_supported, host_supported
from .fallback.decoder import (
    compile_reader,
    decode_pairs_tolerant,
    decode_to_record_batch,
    rows_to_record_batch,
)
from .fallback.encoder import compile_encoder_plan, encode_record_batch
from .fallback.io import max_datum_bytes
from .ops.codec import _concat_batches, get_device_codec
from .runtime import (audit, coldigest, deadline, device_obs, faults, knobs,
                      memacct, metrics, quarantine, router, sampling,
                      telemetry, traceprop)
from .runtime.deadline import DeadlineExceeded
from .runtime.chunking import bounds_rows, chunk_bounds
from .runtime.ingest import as_datum_input
from .runtime.pack import record_lengths
from .runtime.pool import map_chunks, map_chunks_proc
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
    if backend == "tpu":
        raise ValueError(
            "backend='tpu' is not available in the port, which has no TPU; "
            "use 'auto', 'device' or 'host'")
    if backend not in ("auto", "device", "host"):
        raise ValueError(
            f"backend must be 'auto', 'device' or 'host', got {backend!r}")
    return backend


def _check_on_error(on_error: str) -> str:
    if on_error not in ("raise", "skip", "null"):
        raise ValueError(
            f"on_error must be 'raise', 'skip' or 'null', got {on_error!r}"
        )
    return on_error


def _route_candidates(entry: SchemaEntry, backend: str, n_rows: int,
                      device):
    """The static verdict and the tiers the router may choose among →
    ``(tier, impl, reason, candidates)`` (the reference's
    ``_route_candidates``, ``api.py:206-262``). ``impl`` is the tier's
    codec: a ``DeviceCodec`` (under ``"auto"`` its
    :meth:`~.ops.codec.DeviceCodec.with_host_answers` view), a
    ``NativeHostCodec``, or None for the oracle. A device codec that the
    static gate passes over stays a candidate: under
    ``PYRUHVRO_TPU_AUTOTUNE=1`` the cost model decides whether it runs. A
    card that is missing or fails to build raises here under
    ``"device"`` and ``"auto"`` alike (``ROADMAP.md`` (c) 9)."""
    codec = None
    reason = None
    host_pref = None
    if backend == "host":
        reason = "backend_host"
    elif backend == "auto" and not device_supported(entry.ir):
        reason = "gate_fail"
    else:
        codec = get_device_codec(entry, device)
        if backend == "auto":
            host_pref = _auto_prefers_host(entry, n_rows, codec)
            codec = codec.with_host_answers()
    native = None if backend == "device" else _native_host_codec(entry)
    candidates = {}
    if codec is not None:
        candidates["device"] = codec
    if backend != "device":
        if native is not None:
            candidates["native"] = native
        else:
            candidates["fallback"] = None
    if codec is not None and host_pref is None:
        return "device", codec, ("backend_device" if backend == "device"
                                 else "device_selected"), candidates
    if host_pref is not None:
        reason = host_pref
    if native is not None:
        return "native", native, reason, candidates
    return "fallback", None, reason, candidates


def _auto_prefers_host(entry: SchemaEntry, n_rows: int, codec):
    """Under ``backend="auto"`` with both a device codec and the native
    host VM: the reason to serve the call on the host, else None (the
    reference's ``_auto_prefers_host``, ``api.py:308-345``).
    ``PYRUHVRO_TPU_DEVICE_MIN_ROWS=<n>`` gives ``device_min_rows`` below
    n rows and replaces the other signal: ``devices_cpu_only``, which
    holds exactly when the caller passed ``device="cpu"`` (the kernels'
    plain versions are a slower CPU program than the native VM, as
    JAX's CPU platform is for the reference). There is no interconnect
    probe: the card is local."""
    if _native_host_codec(entry) is None:
        return None
    min_rows = knobs.get_int("PYRUHVRO_TPU_DEVICE_MIN_ROWS")
    if min_rows is not None:
        return "device_min_rows" if n_rows < min_rows else None
    if codec.device.type == "cpu":
        return "devices_cpu_only"
    return None


def _decide(entry: SchemaEntry, backend: str, n_rows: int, device, *,
            op: str, chunks: int = 1):
    """One routed decision (``api.py:281-291`` of the reference): the
    static verdict feeds the router as its cold-start policy, the router
    acts (the ledger, autotune), and the verdict lands on the call's
    span."""
    tier, impl, reason, cands = _route_candidates(entry, backend, n_rows,
                                                  device)
    dec = router.decide(entry, backend, n_rows, op=op, chunks=chunks,
                        candidates=cands, static=(tier, impl, reason))
    telemetry.set_route(dec.tier, dec.reason)
    return dec


def _note_memory(dec) -> None:
    """The card's memory watermarks (``device_obs.note_memory``), once
    per call of the device tier with telemetry on."""
    if dec.tier == "device" and telemetry.enabled():
        device_obs.note_memory(dec.impl.decoder.device)


def _native_host_codec(entry: SchemaEntry):
    """The schema's memoized native host codec, or None when the schema is
    outside :func:`.gate.host_supported` or ``PYRUHVRO_TPU_NO_NATIVE`` is
    on. A failed build raises ``RuntimeError``: the oracle never stands in
    for a broken VM."""
    if knobs.get_bool("PYRUHVRO_TPU_NO_NATIVE") or \
            not host_supported(entry.ir):
        return None
    from .hostpath import NativeHostCodec

    return entry.get_extra(
        "native_host_codec",
        lambda: NativeHostCodec(entry.ir, entry.arrow_schema))


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


def _first_bad(tier, e, n: int) -> Optional[int]:
    """The first bad row of a pass of ``n`` rows that a host tier named
    (the native VM's, or a host answer's under ``backend="auto"``), else
    None."""
    k = getattr(e, "index", None)
    if isinstance(e, MalformedAvro) and k is not None and 0 <= k < n and \
            (tier == "native" or e.tier in ("native", "fallback")):
        return k
    return None


def _tolerant_decode(tier, impl, entry, pairs, quar) -> pa.RecordBatch:
    """Decode ``(global index, datum)`` pairs under a tolerant policy →
    the survivors' batch, in order; offenders go into ``quar``. ``impl``
    is the tier's codec (None for the oracle)."""
    if tier == "fallback":
        return _oracle_pairs(pairs, entry, quar)
    parts: List[pa.RecordBatch] = []
    first = True
    while pairs:
        # a deadline is a call contract and outranks the policy: stop the
        # salvage here, naming the first record it never reached
        deadline.check(index=pairs[0][0], site="tolerant.resume")
        items = [d for _, d in pairs]
        try:
            if tier == "native" and not first:
                # one VM thread: the pass stops at the next offender
                # instead of decoding the whole tail
                parts.append(impl.decode(items, nthreads=1))
            else:
                parts.append(impl.decode(items))
            break
        except _DATA_ERRORS as e:
            first = False
            names = _named_rows(e, len(pairs))
            k = _first_bad(tier, e, len(pairs))
            if names is not None:
                named_by = getattr(e, "tier", None) or "device"
                for i in sorted(names):
                    gi, d = pairs[i]
                    quar.append(quarantine.QuarantinedRecord(
                        gi, d, names[i], named_by))
                pairs = [p for j, p in enumerate(pairs) if j not in names]
            elif k is not None:
                # the rows before the first bad one are good on the wire:
                # one pass decodes them (the oracle where a value of
                # theirs cannot build), the offender is quarantined, the
                # tail is tried again
                if k:
                    try:
                        parts.append(impl.decode(items[:k]))
                    except _DATA_ERRORS as e2:
                        if not (is_value_error(e2)
                                or isinstance(e2, MalformedAvro)):
                            raise
                        parts.append(_oracle_pairs(pairs[:k], entry, quar))
                gi, d = pairs[k]
                quar.append(quarantine.QuarantinedRecord(
                    gi, d, e.err_name or "malformed", e.tier or tier))
                pairs = pairs[k + 1:]
            elif is_value_error(e):
                # no row named (invalid UTF-8, a decimal past its
                # precision, a duration overflow in the assembly): the
                # oracle serves the rest per record
                parts.append(_oracle_pairs(pairs, entry, quar))
                break
            else:
                raise
    return _concat(parts, entry)


def _decode_tolerant(tier, impl, entry, data, num_chunks, policy):
    """The tolerant decode body → ``(one batch per chunk, entries)``;
    ``num_chunks=None`` is the single-batch entry, which has one chunk and
    no optimistic pass. The clean case is the ``"raise"`` shape, one
    decode of the batch. When that fails on a bad row, or on a value error
    that names no row, each chunk decodes on its own, as in the
    reference: which rows a launch names, and by which slug, depends on
    where they fall in it (the last lane of a launch reads past its end,
    another lane its neighbour's bytes), so only a chunk's own launch
    gives the reference's entries. The native tier's chunks run on the
    thread pool (the VM releases the interpreter lock), the others' in
    turn."""
    n = len(data)
    bounds = [(0, n)] if num_chunks is None else chunk_bounds(n, num_chunks)
    too_long = [int(j) for j in _too_long(data)]
    if tier != "fallback" and num_chunks is not None and not too_long:
        try:
            out = impl.decode_threaded(data, num_chunks)
            quarantine.publish([], policy)
            return out, []
        except _DATA_ERRORS as e:
            if _named_rows(e, n) is None and not is_value_error(e) and \
                    _first_bad(tier, e, n) is None:
                raise

    def run_chunk(ab):
        return _tolerant_chunk(tier, impl, entry, data, ab, too_long, policy)

    if tier == "native":
        done = map_chunks(run_chunk, bounds)
    else:
        done = [run_chunk(ab) for ab in bounds]
    quar = [e for _batch, entries in done for e in entries]
    quarantine.publish(quar, policy)
    return [batch for batch, _entries in done], quar


def _tolerant_chunk(tier, impl, entry, data, ab, too_long, policy):
    """One chunk ``[a, b)`` of a tolerant decode → ``(batch, entries)``:
    the rows in ``too_long`` quarantined as ``datum_too_large``, the rest
    through :func:`_tolerant_decode`, then the null policy. Publishes
    nothing: the caller does, once for the call."""
    a, b = ab
    entries = [quarantine.QuarantinedRecord(j, data[j], "datum_too_large",
                                            "policy")
               for j in too_long if a <= j < b]
    drop = {e.index for e in entries}
    pairs = [(j, d) for j, d in enumerate(data[a:b], a) if j not in drop]
    with telemetry.phase("decode.tolerant_s", rows=b - a, tier=tier):
        batch = _tolerant_decode(tier, impl, entry, pairs, entries)
    return _apply_null_policy(batch, entries, a, b - a, policy,
                              entry), entries


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


def _tolerant_encode(tier, impl, entry, batch, policy):
    """Encode under a tolerant policy → ``(binary_array, entries)``; the
    clean case is one normal encode. Under ``"null"`` on an all-nullable
    schema the offending rows encode as all-null rows, so the output row
    count matches the input."""
    if tier != "fallback":
        encode_fn = impl.encode
    else:
        plan = _host_plan(entry)

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


# -- the process pool (PYRUHVRO_TPU_POOL=process) ----------------------------
#
# A chunked call of the host tier can fan its chunks out to the spawn
# process pool: each worker re-enters this API with backend="host" on its
# slice under a telemetry.worker_scope, and ships its counter deltas, span
# tree, routing observations and quarantine entries back with the result;
# map_chunks_proc merges them, so the parent's snapshot covers the whole
# fan-out. The device tier never fans out this way. Copies of
# pyruhvro_tpu/api.py:700-781.


def _proc_decode_task(payload):
    schema, data, base, on_error, tp = payload
    with telemetry.worker_scope("pool.worker", rows=len(data),
                                op="decode", trace_ctx=tp) as w:
        # the chaos seam inside the spawned worker (the parent's fault
        # spec reaches it through pool._run_with_chaos_env): error fails
        # the chunk, exit kills the worker mid-fan-out
        faults.fire("pool_worker")
        try:
            if on_error == "raise":
                batch = deserialize_array(data, schema, backend="host")
                errs = []
            else:
                batch, errs = deserialize_array(
                    data, schema, backend="host", on_error=on_error,
                    return_errors=True)
        except MalformedAvro as e:
            # the worker sees a chunk: re-base to the call's row index
            # before the error crosses the process boundary (__reduce__
            # keeps its fields)
            raise shift_malformed(e, base) from None
    if errs:
        w.payload["quarantine"] = quarantine.rebase(errs, base)
    return batch, w.payload


def _proc_encode_task(payload):
    schema, batch, base, on_error, tp = payload
    with telemetry.worker_scope("pool.worker", rows=batch.num_rows,
                                op="encode", trace_ctx=tp) as w:
        faults.fire("pool_worker")
        if on_error == "raise":
            [arr] = serialize_record_batch(batch, schema, 1, backend="host")
            errs = []
        else:
            [arr], errs = serialize_record_batch(
                batch, schema, 1, backend="host", on_error=on_error,
                return_errors=True)
    if errs:
        w.payload["quarantine"] = quarantine.rebase(errs, base)
    return arr, w.payload


def _proc_map(task, payloads, rows):
    """Fan out on the process pool; None means: serve on the thread path
    (counted ``pool.process_fallback``), since a failure of the pool's
    infrastructure must degrade, not fail the call. A worker's
    ``MalformedAvro`` (with the worker's error name and the call's row
    index) re-raises and counts ``pool.worker_malformed``; a
    ``DeadlineExceeded`` re-raises too. Any other worker error falls
    back as well, and the thread path then raises it in this process if
    it recurs."""
    try:
        return map_chunks_proc(task, payloads, rows=rows)
    except MalformedAvro:
        metrics.inc("pool.worker_malformed")
        raise
    except DeadlineExceeded:
        # the budget is spent: the thread path would only overrun it
        raise
    except Exception:
        metrics.inc("pool.process_fallback")
        return None


# -- the differential audit's seams (pyruhvro_tpu/api.py:781-862) ----------
#
# Called right after router.observe on a clean call, still inside the root
# span, the sampler's call_scope and the deadline scope: the cost model
# never sees shadow seconds, the sampler and the SLO feed subtract them
# (runtime/audit.py's thread-local), and the caller's deadline bounds the
# shadow. The shadow always runs the port's pure-Python oracle
# (fallback/), the tier every other tier is held equal to; on the device
# tier that holds K1/K2's and K3's output against it. A mismatch or a
# shadow error never changes the caller's result or its tier.


def _audit_shadow_decode(entry, data, bounds, on_error):
    """Decode the SAME rows again, per chunk, through the oracle under
    the caller's policy; the chunk bounds matter only for the tolerant
    policies' row indices (the digests do not see chunking)."""
    reader = _host_reader(entry)
    too_long = [] if on_error == "raise" else [int(j)
                                               for j in _too_long(data)]
    out = []
    for a, b in bounds:
        deadline.check(site="audit.shadow")
        if on_error == "raise":
            out.append(decode_to_record_batch(
                data[a:b], entry.ir, entry.arrow_schema, reader,
                index_base=a))
        else:
            out.append(_tolerant_chunk("fallback", None, entry, data,
                                       (a, b), too_long, on_error)[0])
    return out


def _audit_shadow_roundtrip(entry, arrays):
    """The encode shadow: the produced wire bytes decoded back through
    the oracle; ``decode(encode(x))`` must equal ``x``."""
    reader = _host_reader(entry)
    out = []
    base = 0
    for arr in arrays:
        deadline.check(site="audit.shadow")
        datums = arr.to_pylist()
        out.append(decode_to_record_batch(
            datums, entry.ir, entry.arrow_schema, reader, index_base=base))
        base += len(datums)
    return out


def _maybe_audit_decode(dec, entry, data, bounds, on_error, result):
    if not audit.enabled():
        return
    batches = result if isinstance(result, list) else [result]
    audit.maybe_audit(
        dec, "decode",
        expected=lambda: batches,
        shadow=lambda: _audit_shadow_decode(entry, data, bounds, on_error),
        input_fn=lambda: coldigest.input_digest(data),
        chunks=len(bounds),
    )


def _maybe_audit_encode(dec, entry, batch, bounds, on_error, arrays, quar):
    if not audit.enabled():
        return
    if quar is None and on_error != "raise":
        quar = quarantine.last()
    skip = None
    if quar:
        # re-chunking the survivors (or re-encoding nulls) breaks the row
        # alignment between the input batch and the round trip
        skip = "quarantine"
    elif not batch.schema.equals(entry.arrow_schema):
        # a caller-typed batch: the digests cover types, not coercions
        skip = "schema"
    audit.maybe_audit(
        dec, "encode",
        expected=lambda: [batch],
        shadow=lambda: _audit_shadow_roundtrip(entry, arrays),
        input_fn=lambda: coldigest.input_digest(batch),
        result_fn=lambda: (coldigest.array_digest(
            pa.chunked_array(arrays)) if arrays else ""),
        chunks=len(bounds),
        skip_reason=skip,
    )


# -- the entry points --------------------------------------------------------


def deserialize_array(
    data: Sequence[bytes], schema: str, *, backend: str = "device",
    device="cuda", on_error: str = "raise", return_errors: bool = False,
    timeout_s: Optional[float] = None, tenant: Optional[str] = None,
    trace_ctx=None,
) -> pa.RecordBatch:
    """Decode Avro datums into a single RecordBatch (≙ upstream's
    ``deserialize_array``, ``src/lib.rs:56-71``). The keywords are the
    module's."""
    _check_backend(backend)
    _check_on_error(on_error)
    data = as_datum_input(data)
    entry = get_or_parse_schema(schema)
    memacct.attribute(tenant, entry.fingerprint, "decode", len(data), data)
    with telemetry.root_span("api.deserialize_array", rows=len(data),
                             trace_ctx=trace_ctx, backend=backend,
                             schema=entry.fingerprint,
                             **({"tenant": tenant} if tenant else {})), \
            sampling.call_scope("decode", entry.fingerprint,
                                len(data)) as smp, \
            deadline.scope(timeout_s, op="deserialize_array"):
        # inside the root span: a pressure relief annotates this call
        memacct.tick()
        dec = _decide(entry, backend, len(data), device, op="decode")
        dec.sampled = smp.sampled
        try:
            # after the decision: a timeout_s=0 probe still leaves a
            # ledger entry
            deadline.check(site="call_start")
            out = _deserialize_one(dec.tier, dec.impl, entry, data,
                                   on_error, return_errors)
            _note_memory(dec)
        except Exception as e:
            router.observe(dec, error=e)
            raise
        router.observe(dec)
        _maybe_audit_decode(dec, entry, data, [(0, len(data))], on_error,
                            out[0] if return_errors else out)
        return out


def _deserialize_one(tier, impl, entry, data, on_error, return_errors):
    """The single-batch decode body."""
    if on_error == "raise":
        _enforce_max_datum(data)
        if tier == "fallback":
            with telemetry.phase("fallback.decode_s", rows=len(data)):
                batch = decode_to_record_batch(data, entry.ir,
                                               entry.arrow_schema,
                                               _host_reader(entry))
        else:
            batch = impl.decode(data)
        return (batch, []) if return_errors else batch
    out, quar = _decode_tolerant(tier, impl, entry, data, None, on_error)
    return (out[0], quar) if return_errors else out[0]


def deserialize_array_threaded(
    data: Sequence[bytes], schema: str, num_chunks: int, *,
    backend: str = "device", device="cuda", on_error: str = "raise",
    return_errors: bool = False, timeout_s: Optional[float] = None,
    tenant: Optional[str] = None, trace_ctx=None,
) -> List[pa.RecordBatch]:
    """Decode into one RecordBatch per chunk, with upstream's chunk
    bounds (``len // num_chunks`` rows each, the remainder in the last;
    ≙ ``src/lib.rs:73-89``). On the device tier the batch decodes once
    and is sliced. Chunk bounds are computed on the input rows: under
    ``"skip"`` a chunk's batch holds its surviving rows (``"null"`` keeps
    each chunk's row count on all-nullable schemas). On the process-pool
    arm the call's trace context ships to every worker, so the chunks'
    spans join the caller's trace."""
    _check_backend(backend)
    _check_on_error(on_error)
    data = as_datum_input(data)
    entry = get_or_parse_schema(schema)
    memacct.attribute(tenant, entry.fingerprint, "decode", len(data), data)
    bounds = chunk_bounds(len(data), num_chunks)
    with telemetry.root_span("api.deserialize_array_threaded",
                             rows=len(data), chunks=num_chunks,
                             trace_ctx=trace_ctx, backend=backend,
                             schema=entry.fingerprint,
                             **({"tenant": tenant} if tenant else {})), \
            sampling.call_scope("decode", entry.fingerprint,
                                len(data)) as smp, \
            deadline.scope(timeout_s, op="deserialize_array_threaded"):
        memacct.tick()  # inside the root span: pressure annotates it
        dec = _decide(entry, backend, len(data), device, op="decode",
                      chunks=len(bounds))
        dec.sampled = smp.sampled
        try:
            deadline.check(site="call_start")
            out = _deserialize_chunks(dec, entry, data, schema, num_chunks,
                                      bounds, on_error, return_errors)
            _note_memory(dec)
        except Exception as e:
            router.observe(dec, error=e)
            raise
        router.observe(dec)
        _maybe_audit_decode(dec, entry, data, bounds, on_error,
                            out[0] if return_errors else out)
        return out


def _deserialize_chunks(dec, entry, data, schema, num_chunks, bounds,
                        on_error, return_errors):
    """The chunked decode body, on the decided (tier, pool) arm."""
    tier, impl = dec.tier, dec.impl
    use_proc = dec.pool == "process"
    # the caller's live trace context, shipped so that the workers' spans
    # join the caller's trace
    tp = traceprop.current_traceparent()
    if use_proc:
        payloads = [(schema, list(data[a:b]), a, on_error, tp)
                    for a, b in bounds]
    if on_error == "raise":
        _enforce_max_datum(data)
        if use_proc:
            out = _proc_map(_proc_decode_task, payloads,
                            rows=lambda p: len(p[1]))
            if out is not None:
                return (out, []) if return_errors else out
            dec.degraded = True  # the thread path serves a process arm
        if tier != "fallback":
            out = impl.decode_threaded(data, num_chunks)
        else:
            reader = _host_reader(entry)

            def decode_chunk(ab):
                a, b = ab
                with telemetry.phase("fallback.decode_s", rows=b - a):
                    return decode_to_record_batch(
                        data[a:b], entry.ir, entry.arrow_schema, reader,
                        index_base=a)

            out = map_chunks(decode_chunk, bounds, rows=bounds_rows)
        return (out, []) if return_errors else out
    if use_proc:
        # the workers apply the policy to their own chunk and ship their
        # entries back, which merge_worker folds into ``quar``
        with quarantine.collecting() as quar:
            out = _proc_map(_proc_decode_task, payloads,
                            rows=lambda p: len(p[1]))
            if out is not None:
                quarantine.publish(quar, on_error)
                return (out, quar) if return_errors else out
        dec.degraded = True
    out, quar = _decode_tolerant(tier, impl, entry, data, num_chunks,
                                 on_error)
    return (out, quar) if return_errors else out


def deserialize_array_threaded_spawn(
    data: Sequence[bytes], schema: str, num_chunks: int, *,
    backend: str = "device", device="cuda", on_error: str = "raise",
    return_errors: bool = False, timeout_s: Optional[float] = None,
    tenant: Optional[str] = None, trace_ctx=None,
) -> List[pa.RecordBatch]:
    """Signature-parity alias of :func:`deserialize_array_threaded`
    (≙ ``src/lib.rs:108-128``; the thread-pool flavour is a host-side
    detail)."""
    return deserialize_array_threaded(
        data, schema, num_chunks, backend=backend, device=device,
        on_error=on_error, return_errors=return_errors, timeout_s=timeout_s,
        tenant=tenant, trace_ctx=trace_ctx)


def serialize_record_batch(
    batch, schema: str, num_chunks: int, *, backend: str = "device",
    device="cuda", on_error: str = "raise", return_errors: bool = False,
    timeout_s: Optional[float] = None, tenant: Optional[str] = None,
    trace_ctx=None,
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
    launch budget (under ``"auto"`` the host tier encodes it)."""
    _check_backend(backend)
    _check_on_error(on_error)
    entry = get_or_parse_schema(schema)
    if isinstance(batch, pa.Table):
        batches = batch.combine_chunks().to_batches()
        batch = batches[0] if batches else pa.RecordBatch.from_pylist(
            [], schema=batch.schema)
    memacct.attribute(tenant, entry.fingerprint, "encode", batch.num_rows,
                      batch)
    bounds = chunk_bounds(batch.num_rows, num_chunks)
    with telemetry.root_span("api.serialize_record_batch",
                             rows=batch.num_rows, chunks=num_chunks,
                             trace_ctx=trace_ctx, backend=backend,
                             schema=entry.fingerprint,
                             **({"tenant": tenant} if tenant else {})), \
            sampling.call_scope("encode", entry.fingerprint,
                                batch.num_rows) as smp, \
            deadline.scope(timeout_s, op="serialize_record_batch"):
        memacct.tick()  # inside the root span: pressure annotates it
        dec = _decide(entry, backend, batch.num_rows, device, op="encode",
                      chunks=len(bounds))
        dec.sampled = smp.sampled
        try:
            deadline.check(site="call_start")
            out = _serialize_chunks(dec, entry, batch, schema, num_chunks,
                                    bounds, on_error, return_errors)
            _note_memory(dec)
        except Exception as e:
            router.observe(dec, error=e)
            raise
        router.observe(dec)
        _maybe_audit_encode(dec, entry, batch, bounds, on_error,
                            out[0] if return_errors else out,
                            out[1] if return_errors else None)
        return out


def _serialize_chunks(dec, entry, batch, schema, num_chunks, bounds,
                      on_error, return_errors):
    """The chunked encode body, on the decided (tier, pool) arm."""
    tier, impl = dec.tier, dec.impl
    use_proc = dec.pool == "process"
    tp = traceprop.current_traceparent()  # ships the caller's trace
    if use_proc:
        payloads = [(schema, batch.slice(a, b - a), a, on_error, tp)
                    for a, b in bounds]
    if on_error == "raise":
        if use_proc:
            out = _proc_map(_proc_encode_task, payloads,
                            rows=lambda p: p[1].num_rows)
            if out is not None:
                return (out, []) if return_errors else out
            dec.degraded = True  # the thread path serves a process arm
        if tier != "fallback":
            out = impl.encode_threaded(batch, num_chunks)
        else:
            plan = _host_plan(entry)

            def encode_chunk(ab):
                a, b = ab
                with telemetry.phase("fallback.encode_s", rows=b - a):
                    return pa.array(encode_record_batch(
                        batch.slice(a, b - a), entry.ir, plan), pa.binary())

            out = map_chunks(encode_chunk, bounds, rows=bounds_rows)
        return (out, []) if return_errors else out
    if use_proc:
        with quarantine.collecting() as quar:
            out = _proc_map(_proc_encode_task, payloads,
                            rows=lambda p: p[1].num_rows)
            if out is not None:
                if quar:
                    # one array per input chunk → the documented shape:
                    # chunks taken over the surviving rows
                    whole = pa.concat_arrays(out)
                    out = [whole.slice(a, b - a)
                           for a, b in chunk_bounds(len(whole), num_chunks)]
                quarantine.publish(quar, on_error, op="encode")
                return (out, quar) if return_errors else out
        dec.degraded = True
    with telemetry.phase("encode.tolerant_s", rows=batch.num_rows,
                         tier=tier):
        arr, quar = _tolerant_encode(tier, impl, entry, batch, on_error)
    out = [arr.slice(a, b - a) for a, b in chunk_bounds(len(arr), num_chunks)]
    quarantine.publish(quar, on_error, op="encode")
    return (out, quar) if return_errors else out


def serialize_record_batch_spawn(
    batch, schema: str, num_chunks: int, *, backend: str = "device",
    device="cuda", on_error: str = "raise", return_errors: bool = False,
    timeout_s: Optional[float] = None, tenant: Optional[str] = None,
    trace_ctx=None,
) -> List[pa.Array]:
    """Signature-parity alias of :func:`serialize_record_batch`
    (≙ ``src/lib.rs:130-147``)."""
    return serialize_record_batch(
        batch, schema, num_chunks, backend=backend, device=device,
        on_error=on_error, return_errors=return_errors, timeout_s=timeout_s,
        tenant=tenant, trace_ctx=trace_ctx)
