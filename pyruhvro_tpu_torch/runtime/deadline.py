"""Per-call deadlines (copy of ``pyruhvro_tpu/runtime/deadline.py``:
``DeadlineExceeded``, ``scope``, ``attach``, ``check``, ``current``,
``remaining`` and ``default_timeout_s``).

Every public entry point takes ``timeout_s=``
(``PYRUHVRO_TPU_DEADLINE_S`` is the process-wide default; the keyword
wins), enforced **cooperatively**:

* a thread-local absolute deadline opens with :class:`scope` at the API
  boundary; nesting takes the tighter bound;
* :func:`check` runs at call start, at each capacity-ladder rung and each
  chunk of the overlapped path (``ops/decode.py``), before each pass of
  the host VM and at each chunk of a chunked host call
  (``hostpath/codec.py``, ``host.vm`` and ``host.chunk``), at each chunk
  of the thread fan-out (``runtime/pool.py``), and at each
  tolerant-decode resume (``api.py``): the places where one unit of work
  ends and the next could be skipped.

Expiry raises :class:`DeadlineExceeded`: structured (op, budget, elapsed,
the global row index where expiry was detected when known, and the site
that detected it) and pickle-safe. A deadline is a call contract, not a
data error, so it outranks ``on_error``.

``timeout_s=0`` means "no budget at all": the call raises at its first
checkpoint, before any launch. ``timeout_s=None`` (the default) defers
to the knob; no knob means unbounded (one thread-local read per check).

An expiry counts ``deadline.exceeded`` and ``deadline.exceeded.<site>``
(``deadline.py:196-202``). The reference's ``run_bounded`` watchdog
thread is not ported: a launch on the card cannot be abandoned from a
thread.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from . import knobs

__all__ = [
    "DeadlineExceeded",
    "scope",
    "attach",
    "current",
    "remaining",
    "check",
    "default_timeout_s",
]

_tls = threading.local()


class DeadlineExceeded(RuntimeError):
    """A call spent its ``timeout_s`` budget.

    Structured like ``MalformedAvro``: ``op`` (which API call),
    ``budget_s`` / ``elapsed_s``, ``index`` (the global row index at
    which expiry was detected, when the checkpoint knew one), ``site``
    (which checkpoint fired) and ``wedged`` (always False in the port,
    kept for the reference's field set). Pickle-safe (``__reduce__``
    keeps every field)."""

    def __init__(self, message: str = "", *, op: Optional[str] = None,
                 budget_s: Optional[float] = None,
                 elapsed_s: Optional[float] = None,
                 index: Optional[int] = None, site: Optional[str] = None,
                 wedged: bool = False):
        super().__init__(message or "deadline exceeded")
        self.op = op
        self.budget_s = budget_s
        self.elapsed_s = elapsed_s
        self.index = index
        self.site = site
        self.wedged = wedged

    def __reduce__(self):
        return (_rebuild, (self.args, self.op, self.budget_s,
                           self.elapsed_s, self.index, self.site,
                           self.wedged))


def _rebuild(args, op, budget_s, elapsed_s, index, site, wedged=False):
    e = DeadlineExceeded(*args)
    e.op, e.budget_s, e.elapsed_s = op, budget_s, elapsed_s
    e.index, e.site, e.wedged = index, site, wedged
    return e


def default_timeout_s() -> Optional[float]:
    """The process-wide default budget (``PYRUHVRO_TPU_DEADLINE_S``;
    unset, empty, malformed or negative = no default = unbounded)."""
    v = knobs.get_float("PYRUHVRO_TPU_DEADLINE_S")
    return v if (v is not None and v >= 0) else None


class _Deadline:
    __slots__ = ("until", "budget_s", "op", "t0")

    def __init__(self, until: float, budget_s: float, op: str):
        self.until = until
        self.budget_s = budget_s
        self.op = op
        self.t0 = time.monotonic()


class scope:
    """Open a deadline for the current call (thread-local). ``timeout_s``
    None defers to the env default (no scope at all when that is unset
    too); a nested scope takes the TIGHTER of its own and the enclosing
    bound. Negative budgets are a caller error."""

    __slots__ = ("_dl", "_prev")

    def __init__(self, timeout_s: Optional[float], op: str = "call"):
        if timeout_s is None:
            timeout_s = default_timeout_s()
        if timeout_s is not None and timeout_s < 0:
            raise ValueError(f"timeout_s must be >= 0, got {timeout_s!r}")
        self._dl: Optional[_Deadline] = None
        if timeout_s is not None:
            until = time.monotonic() + timeout_s
            outer = getattr(_tls, "deadline", None)
            if outer is not None:
                until = min(until, outer.until)
            self._dl = _Deadline(until, timeout_s, op)

    def __enter__(self) -> "scope":
        self._prev = getattr(_tls, "deadline", None)
        if self._dl is not None:
            _tls.deadline = self._dl
        return self

    def __exit__(self, *exc):
        if self._dl is not None:
            _tls.deadline = self._prev
        return False


class attach:
    """Install an already-open deadline on this thread (copy of the
    reference's ``attach``). Deadlines are thread-local, so a fan-out
    worker thread starts unbounded; :func:`..pool.map_chunks` attaches
    the caller's :func:`current` handle around each chunk so ``check()``
    fires inside the workers too."""

    __slots__ = ("_dl", "_prev")

    def __init__(self, dl: Optional[_Deadline]):
        self._dl = dl

    def __enter__(self) -> "attach":
        self._prev = getattr(_tls, "deadline", None)
        if self._dl is not None:
            _tls.deadline = self._dl
        return self

    def __exit__(self, *exc):
        if self._dl is not None:
            _tls.deadline = self._prev
        return False


def current() -> Optional[_Deadline]:
    """The calling thread's open deadline (None = unbounded)."""
    return getattr(_tls, "deadline", None)


def remaining() -> Optional[float]:
    """Seconds left in the current budget (None = unbounded; never
    negative — an expired deadline reads 0.0). It bounds the thread
    fan-out's waits (``runtime/pool.py``)."""
    dl = current()
    if dl is None:
        return None
    return max(0.0, dl.until - time.monotonic())


def check(index: Optional[int] = None, site: Optional[str] = None) -> None:
    """Cooperative checkpoint: raise :class:`DeadlineExceeded` when the
    current budget is spent. Free when no deadline is active (one TLS
    read)."""
    dl = current()
    if dl is None or time.monotonic() < dl.until:
        return
    from . import metrics

    elapsed = time.monotonic() - dl.t0
    metrics.inc("deadline.exceeded")
    if site:
        metrics.inc("deadline.exceeded." + site)
    at = f" at record {index}" if index is not None else ""
    raise DeadlineExceeded(
        f"{dl.op}: deadline of {dl.budget_s:g}s exceeded after "
        f"{elapsed:.3f}s{at}" + (f" ({site})" if site else ""),
        op=dl.op, budget_s=dl.budget_s, elapsed_s=round(elapsed, 6),
        index=index, site=site,
    )
