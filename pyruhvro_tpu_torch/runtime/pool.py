"""The process-global host thread pool and its chunk fan-out (copy of
``pyruhvro_tpu/runtime/pool.py``: ``get_pool``, ``fanout_stats``,
``map_chunks`` and ``_gather``).

Python threads overlap only where the work releases the interpreter lock:
the native host VM and extractor do for essentially the whole call, so
the host tier's per-chunk encodes and tolerant chunk decodes genuinely run
side by side. Each chunk runs under a ``pool.chunk_s`` span parented to
the calling thread's span (``telemetry.attach``), with its rows and its
own counter deltas; a fan-out of more than one chunk opens a
``pool.fanout_s`` span carrying its parallel efficiency. The counters
are the reference's: ``pool.chunks``, ``pool.fanouts``,
``pool.worker_rows``, ``pool.eff_fanouts``, ``pool.chunk_efficiency``
and ``deadline.cancelled_futures``. The reference's process pool
(``map_chunks_proc``) waits for ``ROADMAP.md`` (a) 6.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Callable, List, Optional, Sequence

from . import deadline, metrics, telemetry

__all__ = ["get_pool", "map_chunks", "fanout_stats"]

_pool = None  # guarded-by: _lock
_lock = threading.Lock()


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
