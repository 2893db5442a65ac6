"""The process-global host pools and their chunk fan-outs (copy of
``pyruhvro_tpu/runtime/pool.py``: ``pool_mode``, ``process_available``,
``shard_available``, ``get_pool``, ``get_process_pool``,
``fanout_stats``, ``map_chunks``, ``_gather`` and ``map_chunks_proc``).

Python threads overlap only where the work releases the interpreter lock:
the native host VM and extractor do for essentially the whole call, so
the host tier's per-chunk encodes and tolerant chunk decodes genuinely run
side by side. Each chunk runs under a ``pool.chunk_s`` span parented to
the calling thread's span (``telemetry.attach``), with its rows and its
own counter deltas; a fan-out of more than one chunk opens a
``pool.fanout_s`` span carrying its parallel efficiency. The counters
are the reference's: ``pool.chunks``, ``pool.fanouts``,
``pool.worker_rows``, ``pool.eff_fanouts``, ``pool.chunk_efficiency``
and ``deadline.cancelled_futures``.

``PYRUHVRO_TPU_POOL=process`` sends the host tier's chunks to a
**spawn** process pool (:func:`map_chunks_proc`; spawn, never fork: the
parent may hold a CUDA context, pool threads and their locks). Each
worker runs its chunk under ``telemetry.worker_scope`` and ships its
counter deltas, span tree, routing observations and quarantine entries
home with the result; nothing is merged until every chunk has answered.
A broken pool opens the ``process_pool`` circuit breaker (:mod:`.breaker`):
calls degrade to the thread path at once, and after the backoff one
fan-out probes the pool back in. Each chunk runs through
:func:`_run_with_chaos_env`, which hands the worker the parent's live
fault spec (``PYRUHVRO_TPU_FAULTS``, ``_FAULT_HANG_S``) for the
``pool_worker`` seam, as in the reference.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Callable, List, Optional, Sequence

from . import breaker, deadline, knobs, metrics, native, telemetry

__all__ = ["get_pool", "map_chunks", "get_process_pool", "map_chunks_proc",
           "pool_mode", "process_available", "shard_available",
           "fanout_stats", "shutdown_process_pool"]

_pool = None       # guarded-by: _lock
_proc_pool = None  # guarded-by: _lock
_lock = threading.Lock()


def pool_mode() -> str:
    """``thread`` (default) or ``process`` (``PYRUHVRO_TPU_POOL``)."""
    return knobs.get_enum("PYRUHVRO_TPU_POOL")


def process_available() -> bool:
    """Can a process-pool arm be offered? False while the
    ``process_pool`` breaker is open (the spawn pool broke and its
    backoff has not passed); half-open reads True: the next fan-out is
    the probe."""
    return breaker.get("process_pool").allow()


def shard_available() -> bool:
    """Can the one-call native shard-runner arm be offered? True once the
    host tier's module is loaded. Unlike the reference's there is no
    breaker and no knob: a module that does not build raises
    (``ROADMAP.md`` (c) 7), so a loaded module is a working runner."""
    return native.loaded("host_codec", native.prof_active())


class fanout_stats:
    """Measure one chunk fan-out's parallel efficiency: a
    ``pool.fanout_s`` phase span; callers report each chunk's seconds by
    :meth:`chunk`, or a native fan-out's own busy and wall seconds by
    :meth:`native_fanout`. On exit ``chunk_efficiency`` (busy seconds
    over wall seconds times workers; 1.0 is perfect overlap) lands on the
    span and in the ``pool.chunk_efficiency`` histogram, and
    ``pool.eff_fanouts`` counts it."""

    __slots__ = ("chunks", "attrs", "_dts", "_ph", "_t0", "_native")

    def __init__(self, chunks: int, **attrs):
        self.chunks = chunks
        self.attrs = attrs
        self._dts: List[float] = []
        self._native = None

    def chunk(self, seconds: float) -> None:
        self._dts.append(seconds)  # list.append is atomic under the GIL

    def native_fanout(self, busy_s: float, wall_s: float,
                      threads: int) -> None:
        """A native fan-out's own measurements (the shard runner's
        drained stats)."""
        self._native = (busy_s, wall_s, threads)

    def __enter__(self) -> "fanout_stats":
        self._ph = telemetry.phase("pool.fanout_s", chunks=self.chunks,
                                   **self.attrs)
        self._ph.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self._t0
        span = self._ph.span
        self._ph.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            return False
        if self._native is not None:
            busy, nwall, nthreads = self._native
            if nwall > 0 and nthreads > 0:
                eff = min(1.0, busy / (nwall * nthreads))
                metrics.inc("pool.eff_fanouts")
                telemetry.observe_value("pool.chunk_efficiency", eff)
                if span is not None:
                    span.attrs["chunk_efficiency"] = round(eff, 4)
                    span.attrs["threads"] = nthreads
                    span.attrs["speedup"] = round(busy / nwall, 3)
        elif self._dts and wall > 0 and self.chunks > 0:
            eff = min(1.0, sum(self._dts) / (wall * self.chunks))
            metrics.inc("pool.eff_fanouts")
            telemetry.observe_value("pool.chunk_efficiency", eff)
            if span is not None:
                span.attrs["chunk_efficiency"] = round(eff, 4)
                span.attrs["speedup"] = round(sum(self._dts) / wall, 3)
        return False


def get_pool() -> ThreadPoolExecutor:
    """The pool (made at first use, one worker per CPU)."""
    global _pool
    if _pool is None:
        with _lock:
            if _pool is None:
                _pool = ThreadPoolExecutor(
                    max_workers=os.cpu_count() or 4,
                    thread_name_prefix="pyruhvro_torch",
                )
    return _pool


def get_process_pool() -> ProcessPoolExecutor:
    """The spawn process pool (made at first use, ``min(cpu_count, 8)``
    workers, which start as chunks arrive). Spawn, not fork: the parent
    may hold a CUDA context and live pool threads whose locks a forked
    child could inherit mid-acquire. A worker imports the port and so
    torch, and never touches ``torch.cuda``: it runs the host tier."""
    global _proc_pool
    if _proc_pool is None:
        with _lock:
            if _proc_pool is None:
                import multiprocessing

                _proc_pool = ProcessPoolExecutor(
                    max_workers=min(os.cpu_count() or 4, 8),
                    mp_context=multiprocessing.get_context("spawn"),
                )
    return _proc_pool


def map_chunks(fn: Callable, chunks: Sequence,
               rows: Optional[Callable] = None) -> List:
    """Run ``fn`` over ``chunks`` on the pool, in order; a single chunk
    runs inline. Each chunk first checks the caller's deadline, which the
    worker threads take over (:class:`..deadline.attach`), so a spent
    budget skips every chunk not yet started. ``rows`` (optional) maps a
    chunk to its row count: it lands on the chunk's span and in
    ``pool.worker_rows``."""
    metrics.inc("pool.chunks", len(chunks))

    def run_one(i, chunk, stats=None, inline=False):
        deadline.check(site="pool.chunk")
        n = rows(chunk) if rows is not None else None
        attrs = {"chunk": i}
        if inline:
            attrs["inline"] = True
        if n is not None:
            attrs["rows"] = n
            metrics.inc("pool.worker_rows", float(n))
        t0 = time.perf_counter()
        with metrics.record_deltas() as delta, \
                telemetry.phase("pool.chunk_s", **attrs) as ph:
            out = fn(chunk)
        dt = time.perf_counter() - t0
        if stats is not None:
            stats.chunk(dt)
        if ph.span is not None:
            if delta:
                ph.span.attrs["counters"] = {
                    k: round(v, 9) for k, v in sorted(delta.items())
                }
            if n and dt > 0:
                ph.span.attrs["rec_s"] = round(n / dt, 1)
        return out

    if len(chunks) == 1:
        return [run_one(0, chunks[0], inline=True)]
    metrics.inc("pool.fanouts")
    # captured before the fan-out span: the chunk spans are children of
    # the call's span, the pool.fanout_s span their sibling
    parent = telemetry.current_span()
    dl = deadline.current()
    with fanout_stats(len(chunks)) as stats:
        def run(i_chunk):
            i, chunk = i_chunk
            with telemetry.attach(parent), deadline.attach(dl):
                return run_one(i, chunk, stats)

        futures = [get_pool().submit(run, ic) for ic in enumerate(chunks)]
        return _gather(futures, site="pool.fanout")


def _gather(futures: List, site: str) -> List:
    """Collect the futures in order. Under a deadline each wait is bounded
    by the remaining budget (and a grace, so a chunk that checks right at
    the edge still raises its own expiry); on a timeout the unstarted
    futures are cancelled and :class:`..deadline.DeadlineExceeded`
    raises. A chunk's own error cancels its siblings and propagates."""
    try:
        out = []
        for fut in futures:
            rem = deadline.remaining()
            if rem is None:
                out.append(fut.result())
            else:
                out.append(fut.result(timeout=rem + 0.5))
        return out
    except _FutTimeout as e:
        for f in futures:
            f.cancel()
        if fut.done() and fut.exception(timeout=0) is e:
            raise  # the chunk's own TimeoutError, not the wait's
        metrics.inc("deadline.cancelled_futures")
        deadline.check(site=site)          # raises the structured error
        raise deadline.DeadlineExceeded(   # unreachable safety net
            f"{site}: fan-out wait timed out", site=site)
    except BaseException:
        for f in futures:
            f.cancel()
        raise


_CHAOS_ENV_KEYS = ("PYRUHVRO_TPU_FAULTS", "PYRUHVRO_TPU_FAULT_HANG_S")


def _run_with_chaos_env(task: Callable, env, payload):
    """Worker-side shim: sync the chaos env vars to the parent's view,
    then run the real task (module-level, so picklable for spawn)."""
    for k, v in env.items():
        if v:
            os.environ[k] = v
        else:
            os.environ.pop(k, None)
    return task(payload)


def map_chunks_proc(task: Callable, payloads: Sequence,
                    rows: Optional[Callable] = None) -> List:
    """Run ``task(payload)`` per chunk on the PROCESS pool, in order.
    ``task`` is a picklable module-level callable returning ``(result,
    worker_payload)``, the payload from ``telemetry.worker_scope``; every
    worker's counters, spans, routing observations and quarantine
    entries merge here once all chunks have answered, so a fan-out that
    dies midway leaves the parent's counters, quarantine collector and
    cost model untouched. Raises what the pool raises (a pickling error,
    a broken pool): the caller falls back to the thread path and counts
    it.

    A BROKEN pool is torn down and the ``process_pool`` breaker records
    the failure (it opens at its threshold, default 1); its half-open
    probe's success here closes it again. A deadline-bounded call waits
    with the remaining budget and cancels unstarted chunks on expiry;
    the expiry fails a half-open probe but never counts against a
    closed breaker. A worker's ``MalformedAvro`` proves the pool
    healthy: it closes a probing breaker."""
    from concurrent.futures.process import BrokenProcessPool

    global _proc_pool
    br = breaker.get("process_pool")
    if not br.acquire():
        raise RuntimeError("process pool circuit open")
    metrics.inc("pool.proc_chunks", len(payloads))
    if len(payloads) > 1:
        metrics.inc("pool.proc_fanouts")
    try:
        with fanout_stats(len(payloads), pool="process") as stats:
            chaos_env = {k: os.environ.get(k, "") for k in _CHAOS_ENV_KEYS}
            futures = [get_process_pool().submit(
                           _run_with_chaos_env, task, chaos_env, p)
                       for p in payloads]
            # every result before any merge: partial merges would count
            # twice the work the thread path then redoes
            results = _gather(futures, site="pool.proc_fanout")
            for _result, payload in results:
                dur = ((payload or {}).get("span") or {}).get("dur_s")
                if dur:
                    stats.chunk(float(dur))
        out = []
        for i, (result, payload) in enumerate(results):
            telemetry.merge_worker(payload)
            out.append(result)
            n = rows(payloads[i]) if rows is not None else None
            if n is not None and not (payload or {}).get("rows"):
                metrics.inc("pool.worker_rows", float(n))
        br.record_success()
        return out
    except BrokenProcessPool:
        with _lock:
            broken, _proc_pool = _proc_pool, None
        if broken is not None:
            broken.shutdown(wait=False, cancel_futures=True)
        br.record_failure()
        raise
    except deadline.DeadlineExceeded:
        # an expiry judges the pool only when it was the recovery probe
        if br.state() == "half_open":
            br.record_failure()
        raise
    except BaseException as e:
        # a worker's structured data error means workers spawned, ran and
        # reported: the pool is healthy. Anything else (a pickling error)
        # fails a probe but never opens a closed breaker
        from ..errors import MalformedAvro

        if isinstance(e, MalformedAvro):
            br.record_success()
        elif br.state() == "half_open":
            br.record_failure()
        raise


def shutdown_process_pool() -> None:
    """Stop the spawn pool's workers (the next fan-out makes a new
    pool). For tests and scripts that must leave no process behind."""
    global _proc_pool
    with _lock:
        p, _proc_pool = _proc_pool, None
    if p is not None:
        p.shutdown(wait=True, cancel_futures=True)
