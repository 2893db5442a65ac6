"""Device-tier observability on the card: launch times by CUDA events,
the bytes each launch must move, a launch registry, memory watermarks
and the recompile-churn guard (the counterpart of
``pyruhvro_tpu/runtime/device_obs.py``, written for the card rather than
copied: the reference wraps jitted XLA executables, the port launches
hand-written kernels).

**One launch** (:func:`launch`) is what the reference runs as one
executable: a rung of the pipeline engine (``decode_walk`` K1, then
``decode_finalize`` K2, kind ``decode.pipeline``), one run of the
row-padded walk (K4, ``decode.pallas``), one run of the encode program
(K3, ``encode.pipeline``). Its bucket is the launch's ``(R, B, caps)``
key, under which the port caches its plans and arenas. The first launch
of a bucket by its decoder or encoder is the port's nearest event to the
reference's compile: its plan is built then, and in a fresh process the
``nvcc`` / ``g++`` builds run then too. It is recorded as
``device.compile_s`` with ``mode="first_call"`` (the reference's mode
where its AOT split is unavailable) and the build seconds as the span's
``build_s``; every later launch as ``device.launch_s``. The flat
counters ``device.jit_cache.misses`` / ``.hits`` and the family's
``<op>.compiles`` / ``<op>.launches`` count them as the reference does.

**Times.** Inside a launch each kernel wrapper brackets each of its
launch calls with :func:`timed` (``walk``, ``finalize`` (K2's gather
passes and epilogue), ``walk_decode``, ``encode_rows``,
``encode_strings``; on the CPU the plain versions, by
``perf_counter``), and a launch sums a kernel's stretches. On the card
:func:`timed` hands the launch call two CUDA events, which the kernel
library records on the launch's own stream right before and right
after the kernel, so no host work (argument set-up, the binding's own
call, status reads, the next call's enqueue) falls between them even
when the stream is idle (K2's one call enqueues all of its launches
between the two events). The events come from a
small pool per stream, and nothing synchronises: they are read
(:func:`flush`) only once the call has already waited past them (its
device-to-host wait), and at the latest when the root span exits.
``PYRUHVRO_TPU_DEVICE_SYNC=0``, or telemetry disabled, records no
event at all.

**Sync mode** (:func:`sync_mode`, the reference's
``device_obs.py:106-131``) is the card's deep path: a deep-sampled call
(:mod:`.sampling`) waits on each launch's end event before the host goes
on, so every launch is bounded on its own stream, and tells the sampler
that its deep path ran (``sampling.note_deep_ran``). A :class:`launch`
decides it once, on entry, for the kernels inside it; each wait counts
``device.sync_waits``.
``PYRUHVRO_TPU_DEVICE_SYNC=1`` does the same for every call. Unset keeps
the event timing above, which waits on nothing; the reference's unset
means "bounded whenever telemetry is on" (``ROADMAP.md`` (c) 8).

**Faults** (:mod:`.faults`): ``device_compile`` fires at a bucket's
first launch (:class:`launch`), ``device_launch`` at each kernel's launch
call (:class:`timed`, on the CPU's plain versions too). Both raise into
the call: nothing in the port sends a device fault to the host tier
(``ROADMAP.md`` (c) 9).

**Bytes.** ``device.cost.bytes_accessed`` adds, per kernel of a launch,
the bytes its bound in ``PERF.md`` reckons at that launch's shapes (each
needed input byte read once, each output byte written once), by the
kernel modules' own functions, the ones ``chip_smoke.py`` reports
beside its kernel times. They are evaluated when the launch resolves, on
host values only. The bytes of K3 (``encode_rows``, ``encode_strings``)
need a walk of the encode code over every row's lanes
(``encode.rows_traffic``), host work in proportion to the batch: it runs
only while :func:`count_walked_bytes` is on (off by default; a report
that wants K3's bytes turns it on, as ``chip_smoke.py`` does), and K3's
launches carry no bytes otherwise. ``device.cost.flops`` stays 0: no
kernel does float work.

The registry (``snapshot()["jit_cache"]``) is keyed
``fingerprint|kernel|bucket``: per kernel of a bucket its first-launch
and later-launch counts, seconds and bytes. :func:`note_memory` keeps
``torch.cuda.memory_stats`` watermarks per ``cuda:<index>``; the churn
guard (:func:`note_compile`) counts first launches per schema in
``PYRUHVRO_TPU_RECOMPILE_WINDOW`` seconds and, at
``PYRUHVRO_TPU_RECOMPILE_STORM``, counts ``device.recompile_storm`` and
penalizes the schema in the cost model (``costmodel.penalize``), so the
router withholds its device arm for the window. A storm also auto-dumps
the flight recorder (``telemetry._flight_autodump("recompile_storm")``)
and publishes a ``device.recompile_storm`` incident event on
:mod:`.timeline`.

**Lifecycle** (the reference's ``_register_lifecycle``,
``device_obs.py:575-700``). :func:`track_holder` keeps (weakly) the
objects that hold launch state across calls: the one-card
``DeviceDecoder``, ``WalkDecoder`` and ``DeviceEncoder`` and the sharded
decoder and encoder. Three planes of :mod:`.cachelife` and
:mod:`.memacct` read them:

* ``executables``: the port's counterpart of an XLA executable is a
  bucket's launch state, its registry rows (one a kernel) and its
  holders' ``_launched`` entry; no per-bucket tensor stays on the card,
  so its bytes are a stated estimate (:data:`_EXE_EST_BYTES` a row).
  Evicting one drops every row of that (schema, bucket) and the bucket
  from its schema's holders, so the next launch of the bucket is a first
  launch again (``device.compile_s``, a counted miss: misses still equal
  first launches) and counts ``device.jit_cache.evictions``. The
  bucket's learned caps and the capacity planner's plans stay, as in
  the reference. A first launch runs admission control
  (``PYRUHVRO_TPU_CACHE_MAX_EXECUTABLES`` rows, LRU) once its rows
  exist.
* ``arenas``: the pipeline decoders' pinned launch inputs, each a
  pinned host tensor and its card twin. The probe's ``bytes`` are the
  pinned host bytes (what RSS sees), ``device_bytes`` the card's. An
  arena whose last copy (``copied``) or last launch (``consumed``) has
  not finished is never evicted: it is skipped and counted
  ``device.arena.evict_busy``. An evicted arena that a call in flight
  checked out stays alive through that call's own reference; its card
  block returns to the caching allocator when the call drops it, on the
  stream that allocated it, behind the launches that read it.
* ``finalize``: K2's per-rung tables and per-thread scratch
  (``FinalizeCache`` of each pipeline decoder), card bytes only
  (``device_bytes``); an evicted rung is built again at its next run.

The nvcc libraries are shared by every schema and never evicted;
``ops/_build.py`` reports them as the ``cache.kernels`` probe. Freed
blocks go back to PyTorch's caching allocators, not to CUDA or the
OS: :func:`release_allocator_caches` hands them back, once after a
pressure relief (:func:`.memacct.tick`; ``ROADMAP.md`` (c) 8).
"""

from __future__ import annotations

import gc
import sys
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import cachelife, faults, knobs, memacct, metrics, telemetry, traceprop

__all__ = [
    "launch",
    "timed",
    "recording",
    "add_bytes",
    "count_walked_bytes",
    "walked_bytes",
    "flush",
    "sync_mode",
    "note_build",
    "note_compile",
    "note_memory",
    "track_holder",
    "holders",
    "release_allocator_caches",
    "snapshot",
    "reset",
]

_lock = threading.Lock()
# (fingerprint, kernel, bucket) -> per-kernel stats
_registry: Dict[Tuple[str, str, str], Dict[str, Any]] = {}  # guarded-by: _lock
# "cuda:<index>" -> last-seen memory watermarks
_memory: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
# fingerprint -> monotonic timestamps of recent first launches
_compile_log: Dict[str, deque] = {}  # guarded-by: _lock
# build name -> seconds of builds no first launch has carried yet
_builds: Dict[str, float] = {}  # guarded-by: _lock
# (device index, stream) -> timing events free for reuse
_pools: Dict[Tuple[int, int], List[Any]] = {}  # guarded-by: _lock
# objects holding launch state across calls (track_holder)
_holders: "weakref.WeakSet" = weakref.WeakSet()  # guarded-by: _lock
_POOL_MAX = 256      # events kept per stream
_PENDING_MAX = 4096  # launches a thread keeps unread before dropping
_tls = threading.local()
_walked = False  # lock-free-ok(a flag set between calls)


def sync_mode() -> bool:
    """Should each launch be bounded (waited on at its end) right now?
    ``PYRUHVRO_TPU_DEVICE_SYNC=1`` always, ``=0`` never; unset only
    inside a deep-sampled call (:func:`.sampling.deep_active`), which
    is then marked as having run deep. Inside a :class:`launch` this is
    the answer its entry took; the CPU's plain versions consult it too,
    so a deep-sampled ``device="cpu"`` call is marked alike."""
    s = getattr(_tls, "sync", None)
    if s is not None:
        return s
    return _sync_now(knobs.get_tristate("PYRUHVRO_TPU_DEVICE_SYNC"))


def _sync_now(v: Optional[bool]) -> bool:
    """:func:`sync_mode` under the knob's value ``v``."""
    from . import sampling

    deep = sampling.deep_active()
    if v is False:
        return False
    if deep:
        sampling.note_deep_ran()
        return True
    return v is True


def count_walked_bytes(on: bool) -> None:
    """Count the bytes that need a walk over the data (K3's) from now on,
    or stop."""
    global _walked
    _walked = bool(on)


def walked_bytes() -> bool:
    """Are bytes that need a walk over the data counted?"""
    return _walked


def track_holder(holder) -> None:
    """Register an object that holds launch state or arenas across calls
    (the reference's ``track_holder``, for the lifecycle planes); kept
    weakly, so registering keeps nothing alive. The contract is duck-typed:
    a ``_lock``, a ``_launched`` set of bucket labels and a
    ``fingerprint`` (or a ``base`` with one), and/or an ``_arenas`` dict
    of ``ops.decode._Arena``."""
    with _lock:
        _holders.add(holder)


def holders() -> list:
    """The registered holders still alive."""
    with _lock:
        return list(_holders)


def churn_window_s() -> float:
    return max(0.001, knobs.get_float("PYRUHVRO_TPU_RECOMPILE_WINDOW"))


def churn_threshold() -> int:
    return max(1, knobs.get_int("PYRUHVRO_TPU_RECOMPILE_STORM"))


def note_build(name: str, seconds: float) -> None:
    """A build that ran in this process (``nvcc`` of a kernel source,
    ``g++`` of the record pack): its seconds go on the next first launch
    that uses it."""
    with _lock:
        _builds[name] = _builds.get(name, 0.0) + seconds


def _take_builds(names) -> float:
    with _lock:
        return sum(_builds.pop(n, 0.0) for n in names)


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------


def _acquire(key, stream):
    """A timing event for ``stream``: from its pool, or a new one recorded
    once on it so that its handle exists for the kernel library."""
    with _lock:
        pool = _pools.get(key)
        if pool:
            return pool.pop()
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _release(key, events) -> None:
    with _lock:
        pool = _pools.setdefault(key, [])
        room = _POOL_MAX - len(pool)
        if room > 0:
            pool.extend(events[:room])


class _Segment:
    """One timed stretch of a kernel: two events on a stream (the card)
    or two ``perf_counter`` readings (the CPU)."""

    __slots__ = ("key", "start", "end")

    def __init__(self, key, start, end=None):
        self.key, self.start, self.end = key, start, end

    def ready(self) -> bool:
        return self.key is None or self.end.query()

    def seconds(self) -> float:
        if self.key is None:
            return self.end - self.start
        return self.start.elapsed_time(self.end) / 1e3


class Launch:
    """One launch of a bucket: its kernels' segments and bytes, the span
    opened for it, and ``info`` (host values the caller learns later,
    e.g. the item totals the bytes of ``decode_finalize`` depend on)."""

    __slots__ = ("kind", "bucket", "fingerprint", "first", "span",
                 "segments", "nbytes", "info", "build_s", "trace_id",
                 "_prev", "_prev_sync")

    def __init__(self, kind, bucket, fingerprint, first):
        self.kind, self.bucket = kind, str(bucket)
        self.fingerprint = fingerprint or "?"
        self.first = first
        self.span = None
        self.segments: Dict[str, List[_Segment]] = {}
        self.nbytes: Dict[str, Any] = {}
        self.info: Dict[str, Any] = {}
        self.build_s = 0.0
        ctx = traceprop.current()
        self.trace_id = ctx.trace_id if ctx else None

    def add_bytes(self, kernel: str, nbytes) -> None:
        """The bytes ``kernel`` must move: an int, or a function of this
        launch evaluated when it resolves."""
        self.nbytes[kernel] = nbytes

    def ready(self) -> bool:
        return all(s.ready() for segs in self.segments.values()
                   for s in segs)


class launch:
    """``with launch(kind, bucket, fingerprint, first=..., builds=(...),
    family="decode") as L:`` around the kernels of one
    launch; the kernels inside record into ``L`` through :func:`timed`.
    ``first`` marks the bucket's first launch by its decoder or encoder;
    ``builds`` names the builds whose seconds such a launch carries;
    ``info`` becomes the launch's ``info`` (the caller fills it later)."""

    __slots__ = ("L", "family", "builds")

    def __init__(self, kind: str, bucket, fingerprint: Optional[str],
                 first: bool, builds=(), family: str = "decode",
                 info: Optional[Dict[str, Any]] = None):
        self.L = Launch(kind, bucket, fingerprint, first)
        if info is not None:
            self.L.info = info
        self.family, self.builds = family, builds

    def __enter__(self) -> Launch:
        L = self.L
        if L.first:
            metrics.inc("device.jit_cache.misses")
            # metric-key: <op>.compiles
            metrics.inc(self.family + ".compiles")
            faults.fire("device_compile")
            L.build_s = _take_builds(self.builds)
            note_compile(L.fingerprint, L.kind, L.bucket)
            L.span = telemetry.open_span(
                "device.compile_s", kind=L.kind, bucket=L.bucket,
                mode="first_call", build_s=round(L.build_s, 6))
        else:
            metrics.inc("device.jit_cache.hits")
            # metric-key: <op>.launches
            metrics.inc(self.family + ".launches")
            L.span = telemetry.open_span("device.launch_s", kind=L.kind,
                                         bucket=L.bucket)
        # one read of the knob for the events and the sync mode of
        # every kernel inside
        v = knobs.get_tristate("PYRUHVRO_TPU_DEVICE_SYNC")
        L._prev = getattr(_tls, "current", None)
        L._prev_sync = getattr(_tls, "sync", None)
        _tls.sync = _sync_now(v)
        _tls.current = L if telemetry.enabled() and v is not False \
            else None
        return L

    def __exit__(self, exc_type, exc, tb):
        L = self.L
        _tls.current = L._prev
        _tls.sync = L._prev_sync
        if exc_type is not None and L.span is not None:
            L.span.attrs["error"] = exc_type.__name__
        if L.segments:
            pending = getattr(_tls, "pending", None)
            if pending is None:
                pending = _tls.pending = deque()
            pending.append(L)
            while len(pending) > _PENDING_MAX:
                pending.popleft()
                metrics.inc("device.launch_unresolved")
        return False


class timed:
    """``with timed("walk", device, stream) as t: rc = fn(*args,
    *t.events)`` around one kernel's launch call inside a
    :class:`launch` (its arguments made before it): on the card
    ``t.events`` are the raw handles of two pooled CUDA events, which the
    launch function records on ``stream`` (by default ``device``'s
    current stream) right before and right after its kernel; on the CPU
    two ``perf_counter`` readings around the body. ``(None, None)`` and
    a no-op outside a launch or with events off; nothing is recorded when
    the body raises (a wrapper raises on a failed launch inside it).
    The ``device_launch`` fault fires on entry, before the launch call;
    under :func:`sync_mode` the exit waits for the kernel's end."""

    __slots__ = ("kernel", "device", "events", "_seg", "_stream")

    def __init__(self, kernel: str, device, stream=None):
        self.kernel, self.device = kernel, device
        self.events = (None, None)
        self._seg, self._stream = None, stream

    def __enter__(self):
        faults.fire("device_launch")
        L = getattr(_tls, "current", None)
        if L is None:
            return self
        if self.device.type == "cuda":
            stream = self._stream
            if stream is None:
                import torch

                stream = torch.cuda.current_stream(self.device)
            key = (self.device.index, stream.cuda_stream)
            self._seg = _Segment(key, _acquire(key, stream),
                                 _acquire(key, stream))
            self.events = (self._seg.start.cuda_event,
                           self._seg.end.cuda_event)
        else:
            self._seg = _Segment(None, time.perf_counter())
        return self

    def __exit__(self, exc_type, exc, tb):
        seg = self._seg
        if exc_type is not None:
            if seg is not None and seg.key is not None:
                _release(seg.key, [seg.start, seg.end])
            return False
        if seg is not None and seg.key is None:
            seg.end = time.perf_counter()
        if sync_mode() and self.device.type == "cuda":
            metrics.inc("device.sync_waits")
            if seg is not None:
                seg.end.synchronize()
            else:
                import torch

                (self._stream or torch.cuda.current_stream(
                    self.device)).synchronize()
        if seg is None:
            return False
        L = getattr(_tls, "current", None)
        L.segments.setdefault(self.kernel, []).append(seg)
        return False


def recording() -> bool:
    """Is a :class:`launch` recording on this thread?"""
    return getattr(_tls, "current", None) is not None


def add_bytes(kernel: str, nbytes) -> None:
    """The bytes ``kernel`` must move in the launch recording on this
    thread (see :meth:`Launch.add_bytes`); a no-op outside one."""
    L = getattr(_tls, "current", None)
    if L is not None:
        L.add_bytes(kernel, nbytes)


def flush(final: bool = True) -> None:
    """Read this thread's launches whose events have completed; called
    after a call's device-to-host wait, and by the outermost root span's
    exit. With ``final`` the launches still running are dropped and
    counted in ``device.launch_unresolved`` (a call that raised before
    waiting on them); their events are left to the allocator."""
    pending = getattr(_tls, "pending", None)
    if not pending:
        return
    keep = deque()
    while pending:
        L = pending.popleft()
        if L.ready():
            _resolve(L)
        elif final:
            metrics.inc("device.launch_unresolved")
        else:
            keep.append(L)
    pending.extend(keep)


def _resolve(L: Launch) -> None:
    """Close a launch: its kernels' seconds and bytes into the counters,
    the registry and its span."""
    secs: Dict[str, float] = {}
    for kernel, segs in L.segments.items():
        secs[kernel] = sum(s.seconds() for s in segs)
        for s in segs:
            if s.key is not None:
                _release(s.key, [s.start, s.end])
    nbytes: Dict[str, int] = {}
    for kernel, v in L.nbytes.items():
        if kernel in secs:
            nbytes[kernel] = int(v(L) if callable(v) else v)
    total = sum(secs.values())
    if L.span is not None:
        L.span.attrs.update({k + "_s": round(v, 9) for k, v in secs.items()})
        if nbytes:
            L.span.attrs["bytes"] = sum(nbytes.values())
    key = "device.compile_s" if L.first else "device.launch_s"
    telemetry.close_span(L.span, key, total + L.build_s, L.trace_id)
    if nbytes:
        metrics.inc("device.cost.bytes_accessed", float(sum(nbytes.values())))
    now = time.monotonic()
    with _lock:
        for kernel, s in secs.items():
            e = _entry_locked((L.fingerprint, kernel, L.bucket))
            if L.first:
                e["compiles"] += 1
                e["compile_s"] = round(e["compile_s"] + s, 9)
            else:
                e["hits"] += 1
                e["launches"] += 1
                e["launch_s"] = round(e["launch_s"] + s, 9)
                e["bytes"] += nbytes.get(kernel, 0)
            e["last_used"] = now
    if L.first:
        # admission control once the bucket's rows exist (outside _lock:
        # an eviction takes it)
        cachelife.admit("executables")


# ---------------------------------------------------------------------------
# registry, churn guard, memory
# ---------------------------------------------------------------------------


def _entry_locked(key: Tuple[str, str, str]) -> Dict[str, Any]:
    """Get-or-create a registry row; callers hold ``_lock``."""
    e = _registry.get(key)
    if e is None:
        e = _registry[key] = {
            "fingerprint": key[0],
            "kind": key[1],
            "bucket": key[2],
            "compiles": 0,
            "hits": 0,
            "launches": 0,
            "compile_s": 0.0,
            "launch_s": 0.0,
            "bytes": 0,
            "last_used": time.monotonic(),
        }
    return e


def note_compile(fingerprint: str, kind: str, bucket: str) -> None:
    """Feed the churn guard one first launch: at
    ``PYRUHVRO_TPU_RECOMPILE_STORM`` of them for one schema within the
    window it counts ``device.recompile_storm``, marks
    ``recompile_storm``, annotates the span, penalizes the schema's
    device arm in the cost model and clears the window so one storm
    counts once."""
    storm = False
    now = time.monotonic()
    with _lock:
        log = _compile_log.setdefault(fingerprint, deque())
        log.append(now)
        window = churn_window_s()
        while log and now - log[0] > window:
            log.popleft()
        if len(log) >= churn_threshold():
            storm = True
            log.clear()
    if storm:
        metrics.inc("device.recompile_storm")
        metrics.mark("recompile_storm")  # the live /healthz bit
        from . import timeline

        timeline.event("device.recompile_storm", severity="incident",
                       attrs={"schema": fingerprint})
        telemetry.annotate(recompile_storm=True)
        telemetry._flight_autodump("recompile_storm")
        # a storming schema's device arm is withheld from the router for
        # the churn window: a hard penalty, not one the model must
        # learn by paying more first launches
        from . import costmodel

        costmodel.penalize(fingerprint, churn_window_s())


def note_memory(device) -> None:
    """The card's allocator watermarks (``torch.cuda.memory_stats``:
    ``allocated_bytes.all.current`` and ``.peak``, and
    ``reserved_bytes.all.current``, what the caching allocator holds;
    ``bytes_limit``, the card's total from ``torch.cuda.mem_get_info``,
    read once per card), keyed ``cuda:<index>``, in the device snapshot.
    A no-op for a CPU device."""
    if device.type != "cuda":
        return
    import torch

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    ms = torch.cuda.memory_stats(index)
    in_use = int(ms.get("allocated_bytes.all.current", 0))
    peak = int(ms.get("allocated_bytes.all.peak", in_use))
    reserved = int(ms.get("reserved_bytes.all.current", 0))
    key = f"cuda:{index}"
    with _lock:
        limit = _memory.get(key, {}).get("bytes_limit")
    if limit is None:
        limit = int(torch.cuda.mem_get_info(index)[1])
    with _lock:
        rec = _memory.setdefault(key, {"platform": "gpu"})
        rec["bytes_in_use"] = in_use
        rec["peak_bytes_in_use"] = max(peak,
                                       rec.get("peak_bytes_in_use", 0))
        rec["bytes_reserved"] = reserved
        rec["bytes_limit"] = limit


def release_allocator_caches() -> bool:
    """Free what an eviction unlinked and hand the blocks PyTorch's
    caching allocators keep back: a garbage collection first (an evicted
    schema entry and its device codec refer to each other, so their
    decoders and arenas wait for the cycle collector), then the card's
    cache (``torch.cuda.empty_cache``) and the pinned host allocator's
    (where this PyTorch has a call for it). The allocators only in a
    process whose CUDA is initialised (this never creates a context);
    counts ``mem.allocator_release``. True when they were emptied."""
    gc.collect()
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return False
    empty_host = getattr(getattr(torch, "accelerator", None),
                         "empty_host_cache", None) or \
        getattr(torch._C, "_host_emptyCache", None)
    if empty_host is not None:
        empty_host()
    torch.cuda.empty_cache()
    metrics.inc("mem.allocator_release")
    return True


def snapshot() -> Dict[str, Any]:
    """The device section of ``telemetry.snapshot()``: ``jit_cache`` rows
    keyed ``fingerprint|kernel|bucket`` and ``memory`` watermarks; an
    empty dict when nothing was recorded."""
    with _lock:
        out: Dict[str, Any] = {}
        if _registry:
            out["jit_cache"] = {
                "|".join(k): dict(v) for k, v in sorted(_registry.items())
            }
        if _memory:
            out["memory"] = {k: dict(v) for k, v in sorted(_memory.items())}
    return out


def reset() -> None:
    """Clear the registry, watermarks, churn windows and this thread's
    unread launches (test isolation; called by ``telemetry.reset()``)."""
    with _lock:
        _registry.clear()
        _memory.clear()
        _compile_log.clear()
    pending = getattr(_tls, "pending", None)
    if pending:
        pending.clear()


# ---------------------------------------------------------------------------
# lifecycle planes: buckets' launch state and pinned arenas
# ---------------------------------------------------------------------------

# host bytes of one registry row and its holders' ``_launched`` entry (a
# stated estimate: no per-bucket tensor stays on the card)
_EXE_EST_BYTES = 512


def _holder_fingerprint(h) -> str:
    fp = getattr(h, "fingerprint", None)
    if fp is None:
        fp = getattr(getattr(h, "base", None), "fingerprint", None)
    return fp or "?"


def _exe_entries():
    with _lock:
        return [("|".join(k), e["last_used"], _EXE_EST_BYTES)
                for k, e in _registry.items()]


def _evict_executable(key_str: str) -> bool:
    """Drop one bucket's launch state: every registry row of its (schema,
    bucket), and the bucket from the ``_launched`` set of each holder of
    that schema, so that its next launch is a first launch (a counted
    miss) again."""
    parts = key_str.split("|", 2)
    if len(parts) != 3:
        return False
    fingerprint, _kernel, bucket = parts
    with _lock:
        rows = [k for k in _registry
                if k[0] == fingerprint and k[2] == bucket]
        for k in rows:
            del _registry[k]
        live = list(_holders)
    if not rows:
        return False
    for h in live:
        launched = getattr(h, "_launched", None)
        if launched is None or _holder_fingerprint(h) != fingerprint:
            continue
        with h._lock:
            launched.discard(bucket)
    metrics.inc("device.jit_cache.evictions")
    return True


def _arena_holders():
    with _lock:
        return [h for h in _holders if getattr(h, "_arenas", None) is not None]


def _arena_entries():
    out = []
    for h in _arena_holders():
        with h._lock:
            items = list(h._arenas.items())
        out += [((id(h), key), a.last_used, a.host_t.nbytes)
                for key, a in items]
    return out


def _arena_idle(arena) -> bool:
    """Have the arena's last copy and the last launch that read it ended
    (an event's ``query`` waits on nothing)?"""
    return all(ev is None or ev.query()
               for ev in (arena.copied, arena.consumed))


def _evict_arena(ent_key) -> bool:
    """Unlink one idle arena from its holder (``device.arena.evictions``);
    an arena with a copy or a launch in flight stays
    (``device.arena.evict_busy``)."""
    hid, key = ent_key
    for h in _arena_holders():
        if id(h) != hid:
            continue
        with h._lock:
            arena = h._arenas.get(key)
            if arena is None:
                return False
            if not _arena_idle(arena):
                metrics.inc("device.arena.evict_busy")
                return False
            del h._arenas[key]
        metrics.inc("device.arena.evictions")
        return True
    return False


def _exe_probe():
    ents = _exe_entries()
    return {"bytes": float(sum(b for _k, _t, b in ents)),
            "items": float(len(ents))}


def _arena_probe():
    """Pinned host bytes (``bytes``) and the card twins' bytes
    (``device_bytes``) of every live arena; on the CPU the twin is the
    host tensor itself and counts once."""
    host = card = n = 0
    for h in _arena_holders():
        with h._lock:
            arenas = list(h._arenas.values())
        for a in arenas:
            n += 1
            host += a.host_t.nbytes
            if a.dev is not a.host_t:
                card += a.dev.nbytes
    return {"bytes": float(host), "items": float(n),
            "device_bytes": float(card)}


cachelife.register(
    "executables",
    entries=_exe_entries,
    evict=_evict_executable,
    capacity=lambda: knobs.get_int("PYRUHVRO_TPU_CACHE_MAX_EXECUTABLES"),
)
# arenas have no entry cap of their own (each decoder keeps only the
# largest B per (R, slot, thread)); TTL and pressure manage them
cachelife.register("arenas", entries=_arena_entries, evict=_evict_arena)
memacct.register_probe("cache.executables", _exe_probe)
memacct.register_probe("cache.arenas", _arena_probe)


def _finalize_caches():
    with _lock:
        return [h._finalize for h in _holders
                if getattr(h, "_finalize", None) is not None]


def _finalize_entries():
    return [((id(c), key), used, nbytes) for c in _finalize_caches()
            for key, used, nbytes in c.entries()]


def _evict_finalize(ent_key) -> bool:
    """Drop one rung's finalize tables and scratch from its decoder; a run
    in flight keeps its own references."""
    cid, key = ent_key
    for c in _finalize_caches():
        if id(c) == cid:
            return c.evict(key)
    return False


def _finalize_probe():
    """The card bytes of every decoder's finalize tables and scratch
    (``device_bytes``; nothing of them is on the host)."""
    ents = _finalize_entries()
    return {"bytes": 0.0, "items": float(len(ents)),
            "device_bytes": float(sum(b for _k, _t, b in ents))}


# K2's per-rung tables and per-thread scratch (``ops/decode.py``
# ``FinalizeCache``): no entry cap of their own; TTL and pressure
cachelife.register("finalize", entries=_finalize_entries,
                   evict=_evict_finalize)
memacct.register_probe("cache.finalize", _finalize_probe)
