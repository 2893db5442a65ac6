"""Deterministic interleaving harness (copy of
``pyruhvro_tpu/runtime/schedtest.py``: ``yield_point`` / ``yp``,
``Harness``, ``run_interleaved``, ``active``, ``default_seed``,
``explore_seeds`` and ``point_filter``).

The races of shared runtime state live in a few check-then-act windows
that CPython's scheduler almost never preempts. This module makes the
preemption an *input*: the shared-state seams carry named
:func:`yield_point` markers, and under an active :class:`Harness` each
marker hands control to a **seeded scheduler** that decides which
registered thread runs next. Same seed, same interleaving, same failure.

The port's seams: ``costmodel.observe`` and ``costmodel.save``
(:mod:`.costmodel`), ``breaker.acquire`` / ``.record`` / ``.release``
(:mod:`.breaker`), ``arena.checkout`` (``ops/decode.py``
``DeviceDecoder._arena``) and ``schema_cache.get`` / ``.insert`` /
``.memo`` (``schema/cache.py``). The reference's ``schema_cache.evict``
waits for the schema cache's eviction (``ROADMAP.md`` (a) 8).

Production cost: ``yield_point`` is ONE module-global read + a None
check when no harness is active.

How the scheduler stays deterministic
-------------------------------------

Registered threads run **one at a time**: each worker blocks until the
harness hands it the turn, and the turn only changes hands at yield
points (and at thread start/finish). At each yield point the running
thread appends ``(thread, point)`` to the schedule trace and asks the
seeded RNG to pick the next runnable thread from the registration-
ordered runnable set, so the trace is deterministic. Yield points are
never placed while holding a lock another registered thread can take
(markers sit just *outside* ``with <lock>:`` bodies), so the running
thread can never block on a peer. A stall watchdog backstops the rule:
a thread that waits longer than ``stall_timeout_s`` for its turn steals
it back and counts ``self.stalls``; determinism-asserting tests require
``stalls == 0``.

Knobs (:mod:`.knobs`): ``PYRUHVRO_TPU_SCHED_SEED`` pins the default
schedule seed for a local repro, ``PYRUHVRO_TPU_SCHED_SEEDS`` sizes a
per-window seed sweep, ``PYRUHVRO_TPU_SCHED_POINTS`` filters which named
points participate (comma list; empty = all).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = [
    "yield_point",
    "yp",
    "Harness",
    "active",
    "default_seed",
    "explore_seeds",
    "point_filter",
]

# the active harness; written only by Harness.run() on the driving
# thread, read lock-free by every yield_point (a simple attribute
# load — worst case a racing reader misses the first/last switch of a
# run, never corrupts state)
# lock-free-ok(single-writer publish; readers tolerate staleness)
_active: Optional["Harness"] = None

_tls = threading.local()


def yield_point(name: str) -> None:
    """A named interleaving seam. No-op in production (one global read);
    under an active :class:`Harness`, offers the scheduler a chance to
    switch to another registered thread. Unregistered threads (anything
    the harness does not own, e.g. a real pool worker wandering through
    an instrumented seam mid-test) pass straight through."""
    h = _active
    if h is not None:
        h._switch(name)


# the short alias used at hot seams (kept a separate name so the
# signal-safety lint can match either spelling)
yp = yield_point


def active() -> bool:
    return _active is not None


def default_seed() -> Optional[int]:
    """``PYRUHVRO_TPU_SCHED_SEED`` when set — pins every Harness created
    without an explicit seed (a local repro)."""
    from . import knobs

    return knobs.get_int("PYRUHVRO_TPU_SCHED_SEED")


def explore_seeds() -> int:
    """How many seeds a sweep runs per race window
    (``PYRUHVRO_TPU_SCHED_SEEDS``, default 20)."""
    from . import knobs

    return max(1, knobs.get_int("PYRUHVRO_TPU_SCHED_SEEDS") or 1)


def point_filter() -> Optional[frozenset]:
    """``PYRUHVRO_TPU_SCHED_POINTS`` as a frozenset (None = all points
    participate)."""
    from . import knobs

    raw = knobs.get_raw("PYRUHVRO_TPU_SCHED_POINTS").strip()
    if not raw:
        return None
    return frozenset(p.strip() for p in raw.split(",") if p.strip())


class _Worker:
    __slots__ = ("name", "fn", "args", "kwargs", "thread", "started",
                 "done", "exc", "result")

    def __init__(self, name: str, fn: Callable, args, kwargs):
        self.name = name
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.thread: Optional[threading.Thread] = None
        self.started = False
        self.done = False
        self.exc: Optional[BaseException] = None
        self.result = None


class Harness:
    """One deterministic run: register threads with :meth:`thread`,
    execute with :meth:`run`, read the interleaving from :attr:`trace`.

    ``seed`` defaults to ``PYRUHVRO_TPU_SCHED_SEED`` (or 0 when unset);
    ``points`` restricts which yield-point names participate (others
    pass through), defaulting to the ``PYRUHVRO_TPU_SCHED_POINTS`` knob.
    """

    def __init__(self, seed: Optional[int] = None,
                 points: Optional[Sequence[str]] = None,
                 stall_timeout_s: float = 5.0):
        if seed is None:
            seed = default_seed()
        self.seed = 0 if seed is None else int(seed)
        self.rng = random.Random(self.seed)
        self.points = (frozenset(points) if points is not None
                       else point_filter())
        self.stall_timeout_s = max(0.1, float(stall_timeout_s))
        self.trace: List[Tuple[str, str]] = []
        self.stalls = 0
        self._cond = threading.Condition()
        self._workers: List[_Worker] = []
        self._current: Optional[_Worker] = None
        self._ran = False
        self._aborted = False

    # -- registration -------------------------------------------------------

    def thread(self, fn: Callable, *args, name: Optional[str] = None,
               **kwargs) -> _Worker:
        """Register one worker (not started until :meth:`run`).
        Registration ORDER is part of the schedule identity: the RNG
        picks among runnable workers by registration index."""
        assert not self._ran, "harness already ran"
        w = _Worker(name or f"t{len(self._workers)}", fn, args, kwargs)
        self._workers.append(w)
        return w

    # -- scheduling core ----------------------------------------------------

    def _pick_locked(self, me: Optional[_Worker]) -> Optional[_Worker]:
        """Choose who runs next among runnable workers (me included when
        still runnable). Deterministic: candidates in registration
        order, seeded RNG index."""
        cands = [w for w in self._workers if w.started and not w.done]
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        return cands[self.rng.randrange(len(cands))]

    def _wait_for_turn_locked(self, w: _Worker) -> None:
        deadline = time.monotonic() + self.stall_timeout_s
        while self._current is not w:
            if self._aborted:
                raise RuntimeError("schedtest: harness aborted")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # the placement rule was violated (or a worker blocked
                # on un-instrumented real work): steal the turn so the
                # RUN finishes; determinism tests assert stalls == 0
                self.stalls += 1
                self._current = w
                return
            self._cond.wait(remaining)

    def _switch(self, point: str) -> None:
        w = getattr(_tls, "worker", None)
        if w is None or w not in self._workers:
            return  # unregistered thread: pass through
        if self.points is not None and point not in self.points:
            return
        with self._cond:
            if self._aborted:
                # a worker the timed-out run() abandoned mid-block has
                # resumed: kill it at its first yield point rather than
                # letting it keep mutating shared state under whatever
                # runs next in this process
                raise RuntimeError("schedtest: harness aborted")
            self.trace.append((w.name, point))
            nxt = self._pick_locked(w)
            if nxt is not None and nxt is not w:
                self._current = nxt
                self._cond.notify_all()
                self._wait_for_turn_locked(w)

    def _bootstrap(self, w: _Worker) -> None:
        _tls.worker = w
        try:
            with self._cond:
                w.started = True
                self._cond.notify_all()
                self._wait_for_turn_locked(w)
            try:
                w.result = w.fn(*w.args, **w.kwargs)
            except BaseException as e:  # noqa: BLE001 - re-raised in run()
                w.exc = e
        finally:
            _tls.worker = None
            with self._cond:
                w.done = True
                nxt = self._pick_locked(None)
                if nxt is not None:
                    self._current = nxt
                self._cond.notify_all()

    # -- driving ------------------------------------------------------------

    def run(self, timeout_s: float = 30.0, raise_worker_exc: bool = True):
        """Start every registered worker, schedule deterministically,
        join all; re-raise the first worker exception (registration
        order) unless ``raise_worker_exc=False``. Returns the list of
        worker results in registration order."""
        global _active
        assert not self._ran, "harness already ran"
        assert self._workers, "no workers registered"
        self._ran = True
        assert _active is None, "nested harness runs are not supported"
        _active = self
        try:
            for w in self._workers:
                w.thread = threading.Thread(
                    target=self._bootstrap, args=(w,),
                    name=f"schedtest-{w.name}", daemon=True)
                w.thread.start()
            with self._cond:
                deadline = time.monotonic() + timeout_s
                while not all(w.started for w in self._workers):
                    if not self._cond.wait(deadline - time.monotonic()):
                        raise RuntimeError("schedtest: workers failed to "
                                           "start")
                # first turn: same deterministic pick as every switch
                self._current = self._pick_locked(None)
                self._cond.notify_all()
            join_deadline = time.monotonic() + timeout_s
            for w in self._workers:
                w.thread.join(max(0.0,
                                  join_deadline - time.monotonic()))
                if w.thread.is_alive():
                    # abandon: the daemon thread is blocked in real
                    # work we cannot interrupt — flag the harness so
                    # the worker dies at its next yield point instead
                    # of silently resuming its workload later
                    with self._cond:
                        self._aborted = True
                        self._cond.notify_all()
                    raise RuntimeError(
                        f"schedtest: worker {w.name!r} did not finish "
                        f"within {timeout_s}s (trace so far: "
                        f"{self.trace[-8:]})")
        finally:
            _active = None
        if raise_worker_exc:
            for w in self._workers:
                if w.exc is not None:
                    raise w.exc
        return [w.result for w in self._workers]


def run_interleaved(fns: Sequence[Callable], seed: int,
                    points: Optional[Sequence[str]] = None,
                    timeout_s: float = 30.0) -> "Harness":
    """Convenience: one harness, one worker per callable, run to
    completion, return the harness (trace/stalls/results inspectable).
    Worker exceptions propagate."""
    h = Harness(seed=seed, points=points)
    for fn in fns:
        h.thread(fn)
    h.run(timeout_s=timeout_s)
    return h
