"""Half-open circuit breakers (copy of ``pyruhvro_tpu/runtime/breaker.py``:
``CircuitBreaker``, ``get``, ``snapshot_breakers``, ``backoff_schedule``
and ``reset``).

A breaker guards one seam that can break and recover:

* **closed**: normal operation; failures count, a success resets them.
* **open**: the seam is withheld (the router stops offering its arm,
  callers degrade at once without paying the failure). Entered when the
  failures in a row reach the threshold; left after an exponential
  backoff (base x 2^(opens-1), capped).
* **half-open**: the backoff has passed and exactly ONE probe call is
  admitted. Its success closes the breaker, its failure opens it again
  with the backoff doubled.

Knobs: ``PYRUHVRO_TPU_BREAKER_THRESHOLD`` (failures to open, overriding
every breaker's default) and ``PYRUHVRO_TPU_BREAKER_BACKOFF`` (base
backoff seconds). State changes count ``breaker.<name>.opened`` /
``.half_open`` / ``.closed`` and mark ``breaker_open``; the live state
is ``telemetry.snapshot()["breakers"]``.

In the port only the ``process_pool`` breaker is fed (by
:func:`.pool.map_chunks_proc`). The reference's ``device_backend``
breaker and its feeds are not ported: a failure of the card raises
(``ROADMAP.md`` (c) 9). The ``breaker.acquire`` / ``.record`` /
``.release`` yield points of :mod:`.schedtest` sit just outside the
lock, as in the reference. Each state change also publishes a
``breaker.opened`` (severity ``warn``), ``.half_open`` or ``.closed``
event on :mod:`.timeline`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from . import knobs, metrics, schedtest, timeline

__all__ = [
    "CircuitBreaker",
    "get",
    "snapshot_breakers",
    "backoff_schedule",
    "reset",
]

_MAX_BACKOFF_S = 60.0
# a half-open probe that never reports back (its call path ended without
# reaching a record_* hook) must not wedge the breaker: after this long
# the probe slot is forfeited and the next caller may probe again
_PROBE_TTL_S = 30.0


def _env_threshold() -> Optional[int]:
    v = knobs.get_int("PYRUHVRO_TPU_BREAKER_THRESHOLD")
    return None if v is None else max(1, v)


def _env_backoff() -> Optional[float]:
    v = knobs.get_float("PYRUHVRO_TPU_BREAKER_BACKOFF")
    return None if v is None else max(0.0, v)


class CircuitBreaker:
    """One named breaker (thread-safe). ``threshold``/``backoff_s`` are
    per-seam defaults; the env knobs override both when set (read per
    transition, so tests can flip them in-process)."""

    __slots__ = ("name", "_threshold", "_backoff_s", "_lock", "_failures",
                 "_opens", "_state", "_open_until", "_probe_at",
                 "_probe_owner")

    def __init__(self, name: str, threshold: int = 3,
                 backoff_s: float = 1.0):
        self.name = name
        self._threshold = max(1, int(threshold))
        self._backoff_s = max(0.0, float(backoff_s))
        self._lock = threading.Lock()
        self._failures = 0
        self._opens = 0          # consecutive opens (backoff exponent)
        self._state = "closed"
        self._open_until = 0.0
        self._probe_at: Optional[float] = None  # half-open probe start
        # thread ident of the probe holder: release() is a
        # no-verdict exit and must only clear the slot for the thread
        # that ACQUIRED it — a stale release (TTL-forfeited probe whose
        # slot a second caller re-acquired) would otherwise free the
        # live probe's slot and admit two concurrent probes
        self._probe_owner: Optional[int] = None

    # -- knobs --------------------------------------------------------------

    def threshold(self) -> int:
        return _env_threshold() or self._threshold

    def base_backoff_s(self) -> float:
        env = _env_backoff()
        return self._backoff_s if env is None else env

    def _next_backoff_s(self) -> float:
        return backoff_schedule(self._opens, self.base_backoff_s())

    # -- state machine ------------------------------------------------------

    def _state_locked(self, now: float) -> str:
        """Current state, promoting open→half_open when the backoff has
        expired and reclaiming a leaked half-open probe slot."""
        if self._state == "open" and now >= self._open_until:
            self._state = "half_open"
            self._probe_at = None
            self._probe_owner = None
            metrics.inc(f"breaker.{self.name}.half_open")
            timeline.event("breaker.half_open",
                           attrs={"breaker": self.name})
        if (self._state == "half_open" and self._probe_at is not None
                and now - self._probe_at > _PROBE_TTL_S):
            # forfeited probe: allow another (the forfeiter's eventual
            # release() is a no-op — it no longer owns the slot)
            self._probe_at = None
            self._probe_owner = None
        return self._state

    def state(self) -> str:
        with self._lock:
            return self._state_locked(time.monotonic())

    def allow(self) -> bool:
        """Non-consuming peek: can a call go through right now? True in
        closed and half-open (someone may probe), False while open."""
        return self.state() != "open"

    def acquire(self) -> bool:
        """Admission check for one call. Closed → True. Open → False.
        Half-open → True for exactly one in-flight probe (the caller
        MUST end with :meth:`record_success` or :meth:`record_failure`);
        concurrent callers are refused until the probe reports (or its
        TTL lapses)."""
        schedtest.yp("breaker.acquire")
        with self._lock:
            now = time.monotonic()
            st = self._state_locked(now)
            if st == "closed":
                return True
            if st == "open":
                return False
            if self._probe_at is not None:
                return False
            self._probe_at = now
            self._probe_owner = threading.get_ident()
            metrics.inc(f"breaker.{self.name}.probe")
            return True

    def record_success(self) -> None:
        """A call through the seam succeeded: reset failures; a
        half-open probe success closes the breaker for good (the
        backoff exponent resets too).

        Deliberately NOT owner-checked (unlike :meth:`release`): a
        verdict is evidence about the SEAM, whoever carries it — a
        TTL-forfeited probe whose call eventually succeeded still
        proves the seam works, so it closes; its failure still proves
        the seam broken, so it opens. Ownership only gates the
        no-verdict exit, where a stale release would free a live
        probe's slot without any evidence at all."""
        schedtest.yp("breaker.record")
        with self._lock:
            self._failures = 0
            self._probe_at = None
            self._probe_owner = None
            if self._state != "closed":
                self._state = "closed"
                self._opens = 0
                metrics.inc(f"breaker.{self.name}.closed")
                timeline.event("breaker.closed",
                               attrs={"breaker": self.name})

    def record_failure(self) -> None:
        """A call through the seam failed. In half-open (failed probe)
        or past the threshold in closed: open with exponential backoff.
        """
        schedtest.yp("breaker.record")
        with self._lock:
            now = time.monotonic()
            st = self._state_locked(now)
            self._failures += 1
            self._probe_at = None
            self._probe_owner = None
            if st == "half_open" or (st == "closed"
                                     and self._failures >= self.threshold()):
                self._opens += 1
                self._state = "open"
                self._open_until = now + self._next_backoff_s()
                metrics.inc(f"breaker.{self.name}.opened")
                metrics.mark("breaker_open")
                timeline.event("breaker.opened", severity="warn",
                               attrs={"breaker": self.name,
                                      "failures": self._failures,
                                      "opens": self._opens})

    def release(self) -> None:
        """Return an acquired half-open probe slot WITHOUT a verdict:
        the call exited through a path that proves nothing about the
        seam (e.g. a data/contract error raised before the probed work
        could succeed or fail). Without this, a raising exit between
        :meth:`acquire` and a ``record_*`` call would wedge the
        half-open slot for the probe TTL.

        Owner-checked: only the thread that acquired the CURRENT probe
        slot can return it. A stale release — this thread's probe was
        TTL-forfeited and the slot re-acquired by someone else — is a
        no-op, so it can never free a live probe and admit a second
        concurrent one."""
        schedtest.yp("breaker.release")
        with self._lock:
            if self._probe_owner == threading.get_ident():
                self._probe_at = None
                self._probe_owner = None

    def force_open(self, backoff_s: Optional[float] = None) -> None:
        """Open immediately (tests / operator escape hatch)."""
        with self._lock:
            self._opens += 1
            self._state = "open"
            self._open_until = time.monotonic() + (
                self._next_backoff_s() if backoff_s is None
                else max(0.0, backoff_s))
            self._probe_at = None
            self._probe_owner = None
            metrics.inc(f"breaker.{self.name}.opened")
            metrics.mark("breaker_open")
            timeline.event("breaker.opened", severity="warn",
                           attrs={"breaker": self.name, "forced": True,
                                  "opens": self._opens})

    def export(self) -> Dict[str, Any]:
        with self._lock:
            now = time.monotonic()
            st = self._state_locked(now)
            out: Dict[str, Any] = {
                "state": st,
                "failures": self._failures,
                "opens": self._opens,
                "threshold": self.threshold(),
            }
            if st == "open":
                out["reopen_in_s"] = round(max(0.0, self._open_until - now),
                                           3)
            if st == "half_open" and self._probe_at is not None:
                out["probe_inflight"] = True
            return out


_lock = threading.Lock()
_registry: Dict[str, CircuitBreaker] = {}  # guarded-by: _lock

# per-seam defaults: the spawn pool opens on its FIRST failure (a broken
# pool is costly to find again: every attempt spawns workers)
_DEFAULTS = {
    "process_pool": (1, 1.0),
}


def get(name: str) -> CircuitBreaker:
    """The process-wide breaker for ``name`` (created on first use)."""
    br = _registry.get(name)
    if br is None:
        with _lock:
            br = _registry.get(name)
            if br is None:
                thr, backoff = _DEFAULTS.get(name, (3, 1.0))
                br = _registry[name] = CircuitBreaker(
                    name, threshold=thr, backoff_s=backoff)
    return br


def snapshot_breakers() -> Dict[str, Any]:
    """Live state of every instantiated breaker — the ``breakers``
    section of ``telemetry.snapshot()``. Empty dict when no breaker was
    ever touched."""
    with _lock:
        items = list(_registry.items())
    return {name: br.export() for name, br in sorted(items)}


def backoff_schedule(opens: int, base_s: float = 1.0) -> float:
    """The exponential backoff of every breaker: ``base × 2^(opens-1)``,
    capped, the base overridable by ``PYRUHVRO_TPU_BREAKER_BACKOFF``."""
    env = _env_backoff()
    base = base_s if env is None else env
    return min(_MAX_BACKOFF_S, base * (2.0 ** max(0, opens - 1)))


def reset() -> None:
    """Drop every breaker (test isolation; ``telemetry.reset()`` calls it,
    where the reference's tests reset breakers on their own)."""
    with _lock:
        _registry.clear()
