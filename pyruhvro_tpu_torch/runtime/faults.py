"""Deterministic fault injection at every fault seam (copy of
``pyruhvro_tpu/runtime/faults.py``: ``FaultInjected``, ``SITES``,
``fire``, ``active``, ``hang_seconds``, ``injected_count`` and
``reset``).

``PYRUHVRO_TPU_FAULTS="site:kind:rate[:seed][,site2:kind:rate...]"``

* ``site`` — a named injection point (see :data:`SITES`); every seam
  calls :func:`fire` with its site name.
* ``kind`` — ``error`` (raise :class:`FaultInjected`), ``hang`` (sleep
  ``PYRUHVRO_TPU_FAULT_HANG_S`` seconds, default 2.0 — long enough to
  trip a deadline, short enough that nothing waits forever), or
  ``exit`` (``os._exit(13)`` — worker-death simulation; only honored at
  the ``pool_worker`` site, where a spawned process dies and the parent
  must survive).
* ``rate`` — fraction of calls injected, in (0, 1]. Injection is
  **counter-based** (call ``k`` injects iff
  ``floor(k*rate) > floor((k-1)*rate)``), not random — the same spec
  over the same call sequence injects at exactly the same calls.
* ``seed`` — optional integer phase shift of the counter.

Every injection counts ``fault.injected.<site>`` and annotates the
current root span (``fault_injected=<site>``), so the flight recorder
shows chaos runs for what they are. A malformed spec never breaks the
process: bad entries count ``fault.config_error`` and are ignored.

What a fault does depends on its seam, and departs from the reference
(``ROADMAP.md`` (c) 4, 7 and 9): the port has no fallback that hides the
card or the native tier, so the device seams (``device_compile``,
``device_launch``, ``h2d``) and the native ones (``native_build``,
``vm_decode``, ``shard_worker``, ``native_extract``) raise into the
call under every backend, ``"auto"`` included. The reference's
``degradable`` taxonomy, which sends such faults to the host tier, is
left out: nothing in the port degrades by it. ``pool_worker`` fails a
spawn-pool chunk, which the ``process_pool`` breaker and the thread
path handle (``runtime/pool.py``). The best-effort seams
(``profile_load``, ``profile_save``, ``flight_dump``, ``slo_alert``)
and the observers' (``audit_shadow``: ``audit.shadow_error``;
``incident_capture``: ``incident.capture_failed``; ``obs_handler``: a
500 and ``obs.handler_error``) count the failure and leave the call
unaffected, as in the reference.

Production cost when the knob is unset: one ``os.environ.get`` + a
string compare per seam call.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

from . import knobs, metrics

__all__ = [
    "FaultInjected",
    "SITES",
    "fire",
    "active",
    "hang_seconds",
    "injected_count",
    "reset",
]

# the canonical seam registry — one name per seam, the reference's whole
# tuple. fire() accepts only these (a typo in a chaos spec is loud, not
# silently never-firing).
SITES = (
    "native_build",     # runtime/native.py: extension compile/load
    "native_extract",   # hostpath/codec.py: fused Arrow-native encode lane
    "vm_decode",        # hostpath/codec.py: the C++ VM decode call
    "shard_worker",     # hostpath/codec.py: per-chunk seam of the native
                        # shard-runner decode/encode fan-out
    "device_compile",   # device_obs.launch: a bucket's first launch
    "device_launch",    # device_obs.timed: each kernel's launch call
    "h2d",              # ops/decode.py: host->device copy of an arena
    "pool_worker",      # api._proc_*_task: inside a spawn-pool worker
    "profile_save",     # costmodel.save_profile
    "profile_load",     # costmodel.load_profile
    "flight_dump",      # telemetry.flight_dump file write
    "obs_handler",      # obs_server: request handler (the 500 path)
    "slo_alert",        # slo alert_command hook
    "audit_shadow",     # audit: shadow re-execution through the oracle
    # the three serve_* sites belong to the serving plane, not ported
    # yet (ROADMAP.md (a) 8.9): they parse in a spec and fire nowhere
    "serve_enqueue",    # serving: admission seam
    "serve_worker",     # serving: coalesced micro-batch execution seam
    "serve_flight",     # serving/flight.py: Arrow Flight handler seam
    "incident_capture",  # incident.capture_now: bundle write seam
)

_KINDS = ("error", "hang", "exit")


class FaultInjected(RuntimeError):
    """An injected fault (never raised outside a chaos run). Pickle-safe
    across the spawn pool: ``site`` survives ``__reduce__``."""

    def __init__(self, site: str, message: Optional[str] = None):
        super().__init__(message or f"injected fault at {site!r}")
        self.site = site

    def __reduce__(self):
        return (_rebuild, (self.site, str(self)))


def _rebuild(site: str, message: str) -> "FaultInjected":
    return FaultInjected(site, message)


def hang_seconds() -> float:
    """Sleep length of the ``hang`` kind (``PYRUHVRO_TPU_FAULT_HANG_S``,
    default 2.0 s). Bounded by design: a chaos hang exists to trip
    deadlines and watchdogs, not to wedge the test harness."""
    return max(0.0, knobs.get_float("PYRUHVRO_TPU_FAULT_HANG_S"))


_lock = threading.Lock()
# parsed plan memo: (raw env string, {site: (kind, rate)})
_plan_memo: Optional[Tuple[str, Dict[str, Tuple[str, float]]]] = None  # guarded-by: _lock
# per-site deterministic call counters (seed folds in as a phase shift)
_counters: Dict[str, int] = {}  # guarded-by: _lock


def _parse_locked(raw: str) -> Dict[str, Tuple[str, float]]:
    """``site:kind:rate[:seed]`` comma list -> {site: (kind, rate)};
    seeds are applied to the counters as a phase shift at parse time;
    callers hold ``_lock``. Malformed entries count
    ``fault.config_error`` and are dropped."""
    plan: Dict[str, Tuple[str, float]] = {}
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        try:
            site, kind, rate = parts[0], parts[1], float(parts[2])
            seed = int(parts[3]) if len(parts) > 3 else 0
            if site not in SITES or kind not in _KINDS:
                raise ValueError(item)
            if not (0.0 < rate <= 1.0):
                raise ValueError(item)
        except (IndexError, ValueError):
            metrics.inc("fault.config_error")
            continue
        plan[site] = (kind, rate)
        if seed:
            _counters[site] = seed
    return plan


def _plan() -> Dict[str, Tuple[str, float]]:
    """The active injection plan (re-parsed when the env var changes, so
    tests and chaos runs can flip specs in-process)."""
    global _plan_memo
    raw = knobs.get_raw("PYRUHVRO_TPU_FAULTS")
    memo = _plan_memo
    if memo is not None and memo[0] == raw:
        return memo[1]
    with _lock:
        if _plan_memo is None or _plan_memo[0] != raw:
            _plan_memo = (raw, _parse_locked(raw) if raw else {})
        return _plan_memo[1]


def active() -> bool:
    """Is any fault spec configured? (Cheap: one env read.)"""
    return bool(_plan())


def fire(site: str) -> None:
    """The seam hook: deterministically inject the configured fault for
    ``site`` (no-op when no spec covers it). Raises
    :class:`FaultInjected` for kind ``error``; sleeps for ``hang``;
    ``os._exit(13)`` for ``exit`` (``pool_worker`` only — elsewhere it
    acts as ``error``, a library must never kill its host process)."""
    plan = _plan()
    if not plan:
        return
    assert site in SITES, f"unknown fault site {site!r}"
    ent = plan.get(site)
    if ent is None:
        return
    kind, rate = ent
    with _lock:
        k = _counters.get(site, 0) + 1
        _counters[site] = k
    if int(k * rate) <= int((k - 1) * rate):
        return
    metrics.inc("fault.injected." + site)
    from . import telemetry

    telemetry.annotate_root(fault_injected=site)
    if kind == "hang":
        time.sleep(hang_seconds())
        return
    if kind == "exit" and site == "pool_worker":
        os._exit(13)
    raise FaultInjected(site)


def injected_count(site: str) -> float:
    """Injections so far at ``site`` (from the counters snapshot)."""
    return metrics.snapshot().get("fault.injected." + site, 0.0)


def reset() -> None:
    """Clear counters and the parsed-plan memo (test isolation)."""
    global _plan_memo
    with _lock:
        _counters.clear()
        _plan_memo = None
