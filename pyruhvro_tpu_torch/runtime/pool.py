"""The process-global host thread pool and its chunk fan-out (copy of
``pyruhvro_tpu/runtime/pool.py``: ``get_pool``, ``map_chunks`` and
``_gather``, without the metrics and span attribution, which wait for
the planes they feed).

Python threads overlap only where the work releases the interpreter lock:
the native host VM and extractor do for essentially the whole call, so
the host tier's per-chunk encodes and tolerant chunk decodes genuinely run
side by side. The reference's process pool (``map_chunks_proc``) waits
for ``ROADMAP.md`` (a) 6.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Callable, List, Sequence

from . import deadline

__all__ = ["get_pool", "map_chunks"]

_pool = None  # guarded-by: _lock
_lock = threading.Lock()


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


def map_chunks(fn: Callable, chunks: Sequence) -> List:
    """Run ``fn`` over ``chunks`` on the pool, in order; a single chunk
    runs inline. Each chunk first checks the caller's deadline, which the
    worker threads take over (:class:`..deadline.attach`), so a spent
    budget skips every chunk not yet started."""

    def run_one(chunk):
        deadline.check(site="pool.chunk")
        return fn(chunk)

    if len(chunks) == 1:
        return [run_one(chunks[0])]
    dl = deadline.current()

    def run(chunk):
        with deadline.attach(dl):
            return run_one(chunk)

    futures = [get_pool().submit(run, c) for c in chunks]
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
        deadline.check(site=site)          # raises the structured error
        raise deadline.DeadlineExceeded(   # unreachable safety net
            f"{site}: fan-out wait timed out", site=site)
    except BaseException:
        for f in futures:
            f.cancel()
        raise
