"""NativeHostCodec: Avro datums ⇄ Arrow on the CPU through the C++ VM
(port of ``pyruhvro_tpu/hostpath/codec.py:69-860``).

The host tier (``backend="host"``) serves the schemas inside
:func:`..gate.host_supported` with it; the pure-Python oracle serves the
rest, and every schema under ``PYRUHVRO_TPU_NO_NATIVE=1``. The VM is
``csrc/host/host_codec.cpp`` and the Arrow-native extractor
``csrc/host/extract.cpp``, both copies of the reference's, built at first
use by :mod:`..runtime.native`.

Decode lanes: the fused ``decode_arrow`` pass writes every buffer in
Arrow's layout (:func:`..ops.arrow_build.build_fused_record_batch` wraps
them); where it declines a batch (an exotic value, or a data condition
whose error the Python assembly words) its plan buffers go through
:func:`..ops.arrow_build.build_record_batch`. Encode lanes: the native
extractor exports the batch through the Arrow C data interface and
extracts and encodes in one call; where it declines a batch's shape or
data, :func:`..ops.encode_extract.run_extractor`'s ``host_mode`` layout
feeds the VM's ``encode``. Chunked calls of at least ``_PER_CHUNK_ROWS``
rows per chunk go through the native shard runner in one call (an
encode it declines runs one encode per chunk on the thread pool). Every
lane gives the same values.

Telemetry (the reference's, ``hostpath/codec.py:156-860``): the phases
``host.decode_s``, ``host.vm_s`` and ``host.build_s`` on decode;
``host.extract_s``, ``host.extract_native_s`` and ``host.encode_vm_s``
on encode; the lane counters ``decode.fused`` /
``decode.fused_fallback``, ``extract.native`` / ``extract.fallback``
(with ``extract.fallback_shape`` / ``_data``) and ``shard.native``; a
``pool.fanout_s`` span with the shard runner's own efficiency
(``pool.eff_fanouts``), and ``chunk_mode`` on the call's span.

The native profiler (the reference's, ``hostpath/codec.py:35-52``):
under ``PYRUHVRO_TPU_NATIVE_PROF=1`` the modules are their profiled
builds (:mod:`..runtime.native`), and each call drains their per-opcode
counters into ``vm.op.*`` / ``vm.encop.*`` / ``extract.op.*``
(:func:`_drain_native_prof`). A deep-sampled decode
(:mod:`..runtime.sampling`) runs through the profiled VM instead of the
plain one, marks its deep path as run and drains with the sampler's
period as weight.

Fault seams (:mod:`..runtime.faults`, the reference's ``:193``, ``:371``,
``:535``, ``:761``): ``vm_decode`` before the VM's decode pass,
``shard_worker`` once per chunk before a shard-runner decode or encode,
``native_extract`` before the native extractor's call.

The specialiser (the reference's ``hostpath/codec.py:138-153``,
``:197-230``): after ``PYRUHVRO_TPU_SPECIALIZE_ROWS`` (20,000) rows
decoded or encoded by one codec, its schema's program is unrolled into
C++ and built (:mod:`.specialize`), and the engines serve in the order
deep-sampled profiled build > specialised > VM; the specialised module
also serves the fused ``encode_arrow`` lane and the ``host_mode``
``encode``. ``host.vm_s`` and ``host.encode_vm_s`` carry
``specialized=``. ``PYRUHVRO_TPU_NO_SPECIALIZE=1``,
``PYRUHVRO_TPU_NATIVE_PROF=1`` or either sanitizer flavour
(``PYRUHVRO_TPU_NATIVE_SAN``, ``PYRUHVRO_TPU_TSAN``, whose builds the
engine cache does not key) pins the VM.

The superoptimizer (the reference's ``hostpath/codec.py:97-110`` and
``:231-255``): each codec's program goes through
:func:`.optimize.optimize_program` once (fused runs of fixed-width
fields, elided validity tests, string-item loops decided at compile
time), and the rewrite is kept only when the IR verifier proves its
effects equal to the raw program's. The optimized program (``oprog``,
with ``opt_stats``) serves the VM's ``decode_arrow``, the deep-sampled
profiled VM's too; the raw program (``prog``) stays the source of the
specialiser, the plan buffers, the assembly and every encode lane.
``PYRUHVRO_TPU_NO_OPT=1`` keeps the raw program everywhere.

The bounds-checked writer (the reference's ``:677-734``, ``:772``):
under ``PYRUHVRO_DEBUG_BOUNDS=1``, read once per encode call, every
native encode (the extractor's and the specialised ``encode_arrow``,
the ``host_mode`` VM and specialised ``encode``, the shard encode)
checks each store against the extractor's bound, and an under-estimate
raises ``RuntimeError`` (``bound violated``) where the unchecked writer
would run past its allocation.

Departures from the reference (``ROADMAP.md`` (c)): a failed build (the
specialiser's too), an error of the VM or the shard runner, and an
injected fault at any of these seams raise (the reference degrades to
the oracle, to the VM or to its serial chunk loop, behind breakers the
port has not). The reference probes for a stale module (one without
``shard_stats`` pins the raw program; one without the checked writer's
argument raises or retries with fewer arguments); the port's modules
are keyed by the hash of their sources (:func:`..runtime.native.build_path`),
so no stale module loads and there is no probe (``ROADMAP.md`` (c) 12).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import pyarrow as pa

from ..errors import BatchTooLarge, mark_value_error
from ..fallback.io import malformed_record
from ..ops import UnsupportedOnDevice
from ..ops.arrow_build import (
    build_fused_record_batch,
    build_record_batch,
    compact_union_slices,
)
from ..ops.encode_extract import batch_to_struct, run_extractor
from ..ops.varint import ERR_NAMES, ERR_SLUGS
from ..runtime import (deadline, faults, knobs, metrics, native, sampling,
                       telemetry)
from ..runtime.chunking import bounds_rows, chunk_bounds
from ..runtime.pool import fanout_stats, map_chunks
from .optimize import optimize_program
from .program import (
    COL_F64,
    COL_I64,
    COL_OFFS,
    COL_STR,
    HostProgram,
    lower_host,
)
from .specialize import bind_engine_user, load_specialized, touch_engine

__all__ = ["NativeHostCodec"]


def _drain_native_prof(*mods, scale: float = 1.0) -> None:
    """Fold the profiled modules' per-opcode counters into the flat
    counters: ``vm.op.*`` / ``vm.encop.*`` / ``extract.op.*`` hit
    counts plus ``*_s`` self seconds (copy of the reference's
    ``hostpath/codec.py:35``). A no-op for a plain build, which has no
    ``prof_drain``. ``scale`` is the deep sampler's weight: a sampled
    call stands in for about ``period`` calls."""
    for mod in mods:
        drain = getattr(mod, "prof_drain", None)
        if drain is None:
            continue
        for key, (hits, ns) in drain().items():
            if hits:
                metrics.inc(key, float(hits) * scale)
            if ns:
                metrics.inc(key + "_s", ns * 1e-9 * scale)


def _checked() -> int:
    """The native writers' mode for one encode call: 1 checks every store
    against the extractor's bound (``PYRUHVRO_DEBUG_BOUNDS``)."""
    return 1 if knobs.get_bool("PYRUHVRO_DEBUG_BOUNDS") else 0


def _value_error(e: Exception) -> Exception:
    """Tag an extraction's or the writer's error of a row's value (a null
    where none is allowed, an unknown symbol, a decimal that does not fit)
    so that the tolerant encode isolates its row; returns ``e``."""
    if isinstance(e, (ValueError, OverflowError)) and \
            not isinstance(e, UnsupportedOnDevice):
        mark_value_error(e)
    return e


class NativeHostCodec:
    """Schema-bound native codec (the program lowers once).

    Raises :class:`..ops.UnsupportedOnDevice` when the schema is outside
    the host subset and ``RuntimeError`` when the module does not build.
    """

    # Above this many rows per chunk, a chunked call goes through the
    # shard runner in one native call, or decodes each chunk on its own:
    # a chunk's working set then stays cache-resident. Small batches keep
    # one pass and zero-copy slices. (The VM's sampled-reserve prepass
    # starts at 4 * _PER_CHUNK_ROWS rows, host_codec.cpp py_decode.)
    _PER_CHUNK_ROWS = 1 << 16

    def __init__(self, ir, arrow_schema: pa.Schema):
        self.ir = ir
        self.arrow_schema = arrow_schema
        self.prog: HostProgram = lower_host(ir)  # raises UnsupportedOnDevice
        self._plan = self.prog.buffer_plan()
        self._prof = native.prof_active()
        self._mod = native.load_host_codec().module  # raises RuntimeError
        # the superoptimizer's program serves the VM's generic decode;
        # the raw one stays the specialiser's, the plan's and encode's
        self.oprog: HostProgram = self.prog
        self.opt_stats = None
        if not knobs.get_bool("PYRUHVRO_TPU_NO_OPT"):
            self.oprog, self.opt_stats = optimize_program(self.prog)
        self._spec = None            # the specialized module, once built
        self._spec_name = None       # its engine-registry key
        # the per-opcode profiler lives in the VM's dispatch points; the
        # specialized engines are straight-line code with nothing to
        # attribute, so profiling pins the interpreter; a sanitized
        # session pins it too, since the engine cache does not key the
        # flavour
        self._spec_failed = (knobs.get_bool("PYRUHVRO_TPU_NO_SPECIALIZE")
                             or self._prof or native.san_active()
                             or native.tsan_active())
        self._spec_rows = knobs.get_int("PYRUHVRO_TPU_SPECIALIZE_ROWS")
        self._rows_seen = 0
        self._extract_mod = None  # built at the first native extract
        # the last Arrow schema the native extractor declined on shape:
        # repeated encodes of that shape skip the doomed native probe
        self._extract_declined_schema = None

    def _maybe_specialize(self, n: int) -> None:
        """Count ``n`` rows toward the schema's threshold; past it, build
        (or load) the specialized engine. A failed build raises."""
        if self._spec is not None or self._spec_failed:
            return
        self._rows_seen += n
        if self._rows_seen < self._spec_rows:
            return
        mod = load_specialized(self.prog)
        self._spec = mod
        # lifecycle hookup: the engine's LRU clock ticks per call and
        # eviction can unhook this codec's reference
        self._spec_name = mod.__name__
        bind_engine_user(self._spec_name, self)

    # -- decode -----------------------------------------------------------

    def decode(self, data: Sequence[bytes],
               nthreads: int = 0) -> pa.RecordBatch:
        """Decode ``data`` (bytes-likes, or a
        :class:`..runtime.ingest.DatumView`, whose buffers the VM reads
        directly) into one RecordBatch; ``nthreads`` 0 lets the VM pick
        its shard-thread count."""
        n = len(data)
        # a deep-sampled call decodes through the profiled VM (loaded on
        # a background thread; None until it is there)
        deep_mod = None
        if not self._prof and sampling.deep_active():
            deep_mod = sampling.prof_codec_module()
        with telemetry.phase("host.decode_s", rows=n):
            self._maybe_specialize(n)
            deadline.check(index=0, site="host.vm")
            faults.fire("vm_decode")
            native_data = (data.native_parts()
                           if hasattr(data, "native_parts") else data)
            prog = self.oprog
            # the serving engine: deep-sampled prof build > specialized
            # straight-line module > VM. Bind the specialized engine
            # ONCE: a concurrent lifecycle eviction may null self._spec
            # at any point (the module itself stays valid)
            spec_eng = self._spec
            if deep_mod is not None:
                eng = deep_mod
            elif spec_eng is not None:
                eng = spec_eng
                touch_engine(self._spec_name)
            else:
                eng = self._mod
            spec = spec_eng is not None and deep_mod is None
            with telemetry.phase("host.vm_s", specialized=spec, fused=True):
                if spec:  # compiled from the raw program
                    payload, err_rec, err_bits = eng.decode_arrow(
                        self.prog.coltypes, native_data, nthreads)
                else:
                    payload, err_rec, err_bits = eng.decode_arrow(
                        prog.ops, prog.coltypes, prog.op_aux, native_data,
                        nthreads)
            if self._prof:
                _drain_native_prof(self._mod)
            elif deep_mod is not None:
                sampling.note_deep_ran()
                _drain_native_prof(deep_mod, scale=sampling.deep_weight())
            self._raise_malformed(err_rec, err_bits)
            tag, body = payload
            if tag == "arrow":
                # every buffer already in Arrow's layout
                metrics.inc("decode.fused")
                with telemetry.phase("host.build_s", fused=True):
                    return build_fused_record_batch(self.ir,
                                                    self.arrow_schema, body,
                                                    n)
            # the native pass declined: its plan buffers go through the
            # Python assembly, which words the error where there is one
            metrics.inc("decode.fused_fallback")
            with telemetry.phase("host.build_s", fused=False):
                return self._plan_batch(body, n)

    @staticmethod
    def _raise_malformed(err_rec: int, err_bits: int) -> None:
        """Raise the VM's first bad record (``err_rec`` >= 0) as
        :class:`~..errors.MalformedAvro`."""
        if err_rec >= 0:
            bit = err_bits & -err_bits
            raise malformed_record(
                err_rec,
                ERR_NAMES.get(bit, f"error bit {bit:#x}"),
                err_name=ERR_SLUGS.get(bit, f"bit_{bit:#x}"),
                tier="native",
            )

    def _plan_batch(self, bufs, n: int) -> pa.RecordBatch:
        """The VM's plan buffers (``buffer_plan()`` order) assembled into a
        RecordBatch by :func:`..ops.arrow_build.build_record_batch`."""
        prog = self.prog
        host = {}
        for (key, dt, _region), b in zip(self._plan, bufs):
            host[key] = np.frombuffer(b, dtype=dt)
        item_totals = {}
        for path in prog.regions[1:]:
            k = path + "#offsets"
            # the VM returns running totals; Arrow offsets lead with 0
            host[k] = np.concatenate([np.zeros(1, np.int32), host[k]])
            item_totals[path] = int(host[k][-1])
        meta = {"item_totals": item_totals, "flat": np.zeros(0, np.uint8)}
        return build_record_batch(self.ir, self.arrow_schema, host, n, meta)

    def _drain_shard_stats(self) -> dict:
        """Read and clear the shard runners' fan-out stats (each module,
        the specialized engine's too, has its own pool and stats),
        summed."""
        tot = {"fanouts": 0, "shards": 0, "shard_s": 0.0, "wall_s": 0.0,
               "threads": 0}
        for m in (self._mod, self._spec, self._extract_mod):
            if m is None:
                continue
            d = m.shard_stats()
            for k in ("fanouts", "shards", "shard_s", "wall_s"):
                tot[k] += d[k]
            tot["threads"] = max(tot["threads"], d["threads"])
        return tot

    def _decode_native_shards(self, data, bounds) -> List[pa.RecordBatch]:
        """One native call for the whole batch, the shard runner fanning
        rows out over its workers; the batch is sliced per chunk."""
        for a, _b in bounds:
            deadline.check(index=a, site="host.chunk")
            faults.fire("shard_worker")
        telemetry.annotate(chunk_mode="native_shard")
        self._drain_shard_stats()  # discard counts from other callers
        with fanout_stats(len(bounds), native=True) as stats:
            batch = self.decode(data)
            d = self._drain_shard_stats()
            if d["fanouts"]:
                stats.native_fanout(d["shard_s"], d["wall_s"], d["threads"])
        metrics.inc("shard.native")
        return [compact_union_slices(batch.slice(a, b - a))
                for a, b in bounds]

    def decode_threaded(self, data: Sequence[bytes],
                        num_chunks: int) -> List[pa.RecordBatch]:
        """Decode into one RecordBatch per chunk, with upstream's chunk
        bounds. At ``_PER_CHUNK_ROWS`` rows per chunk or more: one call
        through the shard runner; below, one decode. Either way the batch
        is sliced per chunk."""
        bounds = chunk_bounds(len(data), num_chunks)
        if len(data) >= self._PER_CHUNK_ROWS * max(len(bounds), 1):
            return self._decode_native_shards(data, bounds)
        telemetry.annotate(chunk_mode="slice")
        batch = self.decode(data)
        return [compact_union_slices(batch.slice(a, b - a))
                for a, b in bounds]

    # -- encode -----------------------------------------------------------

    @staticmethod
    def _wrap_blob(blob, offs, n: int) -> pa.Array:
        """The native encode's return (the value bytes and the n+1 int32
        Arrow offsets) as a BinaryArray, without a copy."""
        return pa.Array.from_buffers(
            pa.binary(), n,
            [None, pa.py_buffer(offs),
             pa.py_buffer(np.frombuffer(blob, np.uint8))],
        )

    def _encode_native(self, batch: pa.RecordBatch, n: int, checked: int,
                       nshards: int = 1):
        """The fused Arrow-native encode: the column-matched struct goes
        through the Arrow C data interface, and extraction and the wire
        write run in one native call (``checked`` 1: the bounds-checked
        writer). None when the lane declines (a shape outside the native
        surface, or a data error the Python extractor words)."""
        if (self._extract_declined_schema is not None
                and batch.schema.equals(self._extract_declined_schema)):
            metrics.inc("extract.fallback")
            metrics.inc("extract.fallback_shape")
            return None
        spec = self._spec  # single read: eviction may null it
        if spec is not None:
            touch_engine(self._spec_name)
        elif self._extract_mod is None:
            self._extract_mod = native.load_extract().module
        faults.fire("native_extract")
        try:
            struct = batch_to_struct(self.ir, batch)
        except (ValueError, OverflowError) as e:
            raise _value_error(e)
        # ArrowArray is 80 ABI bytes, ArrowSchema 72; the native side moves
        # both structs out and releases them before returning
        holder_a = np.zeros(10, np.uint64)
        holder_s = np.zeros(9, np.uint64)
        struct._export_to_c(int(holder_a.ctypes.data),
                            int(holder_s.ctypes.data))
        addrs = (int(holder_a.ctypes.data), int(holder_s.ctypes.data), n,
                 checked)
        if spec is not None:
            fn = spec.encode_arrow
            args = (self.prog.coltypes,) + addrs
        else:
            fn = self._extract_mod.encode
            args = (self.prog.ops, self.prog.coltypes,
                    self.prog.op_aux) + addrs
        try:
            res = fn(*(args + (nshards,) if nshards > 1 else args))
        except OverflowError as e:
            if "decimal" in str(e):
                raise _value_error(e)  # a batch split cannot help
            raise BatchTooLarge(n, -1)
        if self._prof:  # profiling pins the interpreter: spec is None
            _drain_native_prof(self._extract_mod)
        if isinstance(res, int):
            # 1 = an Arrow shape outside the native surface; 2 = a data
            # error the Python extractor reports with its exact message
            metrics.inc("extract.fallback")
            metrics.inc("extract.fallback_data" if res == 2
                        else "extract.fallback_shape")
            if res == 1:
                self._extract_declined_schema = batch.schema
            return None
        blob, offs, t_ex, t_enc = res
        # the native call's own split of its seconds
        telemetry.observe("host.extract_s", t_ex, rows=n, native=True)
        telemetry.observe("host.extract_native_s", t_ex, rows=n)
        telemetry.observe("host.encode_vm_s", t_enc, fused=True,
                          specialized=spec is not None)
        metrics.inc("extract.native")
        return self._wrap_blob(blob, offs, n)

    def _encode_buffers(self, ex) -> List[np.ndarray]:
        """The ``host_mode`` extractor's per-path arrays in the VM's plan
        buffer order."""
        empty_u8 = np.zeros(0, np.uint8)
        bufs: List[np.ndarray] = []
        for c in self.prog.cols:
            key, ctype = c.key, c.ctype
            if ctype == COL_STR:
                bufs.append(ex.byte_bufs.get(key + "#bytes", empty_u8))
                bufs.append(ex.arrays[key + "#len"][0])
            elif ctype == COL_OFFS:
                path = key[: -len("#offsets")]
                bufs.append(ex.arrays[path + "#count"][0])
            elif ctype in (COL_I64, COL_F64):
                bufs.append(ex.arrays[key][0])  # whole #v64 lanes
            else:  # #v / #valid / #tid / #dec / #fix
                bufs.append(ex.arrays[key][0])
        return bufs

    def encode(self, batch: pa.RecordBatch) -> pa.Array:
        """Encode every row as one Avro datum → BinaryArray
        (≙ ``serialize_chunk``, ``fast_encode.rs:27-52``). Raises
        :class:`~..errors.BatchTooLarge` when the wire total passes int32
        binary offsets (callers split the batch). Batches over
        2 * ``_PER_CHUNK_ROWS`` rows encode in slices of that size whose
        arrays are concatenated: each slice's working set stays
        cache-resident."""
        n = batch.num_rows
        if n == 0:
            return pa.array([], pa.binary())
        step = self._PER_CHUNK_ROWS * 2
        if n > step:  # strict: a recursing slice is exactly `step`
            try:
                return pa.concat_arrays([
                    self.encode(batch.slice(a, min(step, n - a)))
                    for a in range(0, n, step)
                ])
            except pa.lib.ArrowInvalid:
                # each slice fit, but the concatenated offsets pass int32
                raise BatchTooLarge(n, -1)
        self._maybe_specialize(n)
        checked = _checked()
        out = self._encode_native(batch, n, checked)
        if out is not None:
            return out
        return self._encode_host_mode(batch, n, checked)

    def _encode_host_mode(self, batch: pa.RecordBatch, n: int,
                          checked: int = 0) -> pa.Array:
        """The lane for a batch the native extractor declines: the Python
        extractor's ``host_mode`` layout fed to the VM's ``encode``
        (``checked`` 1: the bounds-checked writer)."""
        with telemetry.phase("host.extract_s", rows=n, native=False):
            try:
                ex = run_extractor(self.ir, batch, host_mode=True)
            except (ValueError, OverflowError) as e:
                raise _value_error(e)
            bufs = self._encode_buffers(ex)
        # the extractor's bound is a strict upper bound on the wire total,
        # so the VM writes unchecked into one allocation of that size;
        # past 1 GiB hint=0 selects its capacity-checked growth instead
        hint = ex.bound if ex.bound <= (1 << 30) else 0
        spec = self._spec  # single read: eviction may null it
        if spec is not None:
            # encode-only traffic through this lane stamps the engine's
            # LRU clock too, or TTL/LRU would evict the hot engine
            touch_engine(self._spec_name)
        try:
            with telemetry.phase("host.encode_vm_s",
                                 specialized=spec is not None):
                if spec is not None:
                    blob, offs = spec.encode(self.prog.coltypes, bufs, n,
                                             hint, checked)
                else:
                    blob, offs = self._mod.encode(self.prog.ops,
                                                  self.prog.coltypes, bufs,
                                                  n, hint, checked)
        except OverflowError as e:
            if "decimal" in str(e):
                raise _value_error(e)  # the oracle's int.to_bytes overflow
            raise BatchTooLarge(n, -1)
        if self._prof:
            _drain_native_prof(self._mod)
        return self._wrap_blob(blob, offs, n)

    def _encode_native_shards(self, batch: pa.RecordBatch, bounds):
        """One native call for the whole chunked encode, the shard runner
        spreading rows over its workers; the array is sliced per chunk.
        None when the native extractor declines the batch, or the batch
        passes int32 offsets: the per-chunk path then serves."""
        for _a, _b in bounds:
            faults.fire("shard_worker")
        telemetry.annotate(chunk_mode="native_shard")
        self._drain_shard_stats()  # discard counts from other callers
        try:
            with fanout_stats(len(bounds), native=True, op="encode") as stats:
                arr = self._encode_native(batch, batch.num_rows, _checked(),
                                          nshards=len(bounds))
                d = self._drain_shard_stats()
                if d["fanouts"]:
                    stats.native_fanout(d["shard_s"], d["wall_s"],
                                        d["threads"])
        except BatchTooLarge:
            metrics.inc("shard.fallback")
            return None  # the per-chunk path's splitter serves the call
        if arr is None:
            metrics.inc("shard.fallback")
            return None
        metrics.inc("shard.native")
        return [arr.slice(a, b - a) for a, b in bounds]

    def encode_threaded(self, batch: pa.RecordBatch,
                        num_chunks: int) -> List[pa.Array]:
        """Encode into one BinaryArray per chunk. At ``_PER_CHUNK_ROWS``
        rows per chunk or more: one call through the shard runner, or
        where it declines the batch, one encode per chunk on the thread
        pool; below, one encode, sliced. A batch over int32 offsets is
        split in halves, still through the VM."""
        bounds = chunk_bounds(batch.num_rows, num_chunks)
        if batch.num_rows >= self._PER_CHUNK_ROWS * max(len(bounds), 1):
            out = self._encode_native_shards(batch, bounds)
            if out is not None:
                return out
            return map_chunks(
                lambda ab: self._encode_split(
                    batch.slice(ab[0], ab[1] - ab[0])),
                bounds, rows=bounds_rows)
        arr = self._encode_split(batch)
        return [arr.slice(a, b - a) for a, b in bounds]

    def _encode_split(self, batch: pa.RecordBatch) -> pa.Array:
        try:
            return self.encode(batch)
        except BatchTooLarge:
            if batch.num_rows < 2:
                raise
            mid = batch.num_rows // 2
            try:
                return pa.concat_arrays(
                    [self._encode_split(batch.slice(0, mid)),
                     self._encode_split(batch.slice(mid))])
            except pa.lib.ArrowInvalid:
                # the halves fit alone but their concatenation passes
                # int32 offsets: the caller must use more chunks
                raise BatchTooLarge(batch.num_rows, -1)
