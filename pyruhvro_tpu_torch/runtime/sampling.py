"""Always-on adaptive deep-profiling sampler (copy of
``pyruhvro_tpu/runtime/sampling.py``).

The native profiler and the device sync answer *why* a call was slow,
but both tax every call they are on. This module keeps them on for a
sampled subset of calls:

* every ~Nth public API call runs the **deep path**: the native tier
  decodes through the per-opcode-profiled VM build (same module surface,
  its own cached ``.so``: :func:`..native.load_host_codec_prof`) and the
  device tier bounds each launch (:func:`.device_obs.sync_mode`, which
  consults :func:`deep_active`, waits on each launch's end event);
* the sampling period **auto-tunes online**: per-(schema, op, row-band,
  arm) EWMAs of seconds-per-row for deep vs normal calls estimate the
  deep path's relative overhead, and the period is set so that
  ``overhead_fraction / period <= PYRUHVRO_TPU_SAMPLE_BUDGET``
  (default 1% of total wall time);
* sampled per-opcode observations merge into the live registry
  **weight-corrected** (hits and self-seconds scaled by the period at
  sample time — :func:`deep_weight`), so ``vm.op.*`` totals estimate
  what an always-profiled run would have recorded;
* a sampled call's wall seconds are **corrected** before they feed the
  cost model (:func:`corrected_seconds` divides out the estimated deep
  overhead; ``router.observe`` calls it) and the SLO engine
  (:func:`consume_last_correction`, at the root span's exit).

``PYRUHVRO_TPU_SAMPLE_BUDGET=0`` disables the sampler;
``PYRUHVRO_TPU_NO_TELEMETRY=1`` (telemetry off) disables it too.
SIGUSR2 (:func:`install_toggle_signal`, installed at import when
``PYRUHVRO_TPU_FLIGHT_DIR`` is set) flips it live.

An audited call's shadow re-execution (:mod:`.audit`) runs inside the
scope: its seconds (``audit.tls_shadow_seconds()``) are subtracted from
the call's before they feed the per-feature EWMAs.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from . import knobs, metrics

__all__ = [
    "enabled",
    "set_enabled",
    "toggle",
    "call_scope",
    "deep_active",
    "deep_weight",
    "corrected_seconds",
    "prof_codec_module",
    "budget",
    "period",
    "overhead_fraction",
    "snapshot_sampling",
    "install_toggle_signal",
    "reset",
]

# period bounds: never deeper than 1-in-MIN (the budget math can ask for
# period 1 when overhead measures ~0, but a floor keeps pathological
# feedback — deep call perturbs the EWMA that tunes the deep rate —
# bounded), never shallower than 1-in-MAX (always SOME coverage)
_PERIOD_MIN = 8
_PERIOD_MAX = 1 << 16
_PERIOD_START = 32

# EWMA smoothing for the per-feature seconds-per-row estimates
_ALPHA = 0.2

_lock = threading.Lock()
_tls = threading.local()
_calls = 0          # guarded-by: _lock
_deep_calls = 0     # guarded-by: _lock
_period = _PERIOD_START  # guarded-by: _lock
# lock-free-ok(single GIL-atomic store; written from SIGUSR2 signal
# context where taking a lock could deadlock the interrupted frame)
_forced: Optional[bool] = None
_overhead = 0.0     # guarded-by: _lock (weighted overhead estimate)
# lock-free-ok(main-thread-only install flag — signal.signal itself
# rejects non-main threads, so two installers cannot race)
_signal_installed = False
_prof_mod_probed = False    # guarded-by: _lock
_prof_mod = None            # guarded-by: _lock
_prof_thread: Optional[threading.Thread] = None  # guarded-by: _lock
_overhead_known = False     # guarded-by: _lock
_pending_resample = False   # guarded-by: _lock
_skip_streak = 0            # guarded-by: _lock
# (schema, op, band, arm) -> [norm_ewma_spr, deep_ewma_spr, n_norm,
# n_deep]. The arm (from router.observe via note_arm, None when the
# call was never routed or ran degraded) is part of the key because the
# deep/normal ratio is only comparable WITHIN one arm: the native tier
# pays ~4x to swap its specialized engine for the profiled interpreter
# while a device call pays only a sync per launch — one blended ratio
# would over-correct the cheap arm and under-correct the expensive one.
_feat: Dict[Tuple[Any, ...], list] = {}  # guarded-by: _lock


def budget() -> float:
    """Target fraction of total wall time the deep path may cost
    (``PYRUHVRO_TPU_SAMPLE_BUDGET``, default 0.01 = 1%). <= 0 disables
    the sampler."""
    return knobs.get_float("PYRUHVRO_TPU_SAMPLE_BUDGET")


def enabled() -> bool:
    """Is the sampler live? The SIGUSR2/:func:`set_enabled` override
    wins; otherwise on iff the budget is positive and telemetry is on
    (the telemetry-off path must stay at bare counter cost)."""
    if _forced is not None:
        return _forced
    if budget() <= 0:
        return False
    from . import telemetry

    return telemetry.enabled()


def set_enabled(flag: Optional[bool]) -> None:
    """Force the sampler on/off (None restores env-driven behavior)."""
    global _forced
    _forced = flag


# toggles observed from SIGNAL context defer their count; flushed by
# the next call_scope / snapshot on a normal thread
_toggles = metrics.DeferredCount("sampling.toggled")


def toggle(counters: bool = True) -> bool:
    """Flip the sampler live; returns the new state. The toggle pivots
    off the current *effective* state, so a kill -USR2 always does the
    intuitive thing. ``counters=False`` is the signal-handler path:
    the count defers instead of taking the (non-reentrant) metrics
    lock from inside a handler that may have interrupted it."""
    global _forced
    new = not enabled()
    _forced = new
    _toggles.bump()  # signal-safe: increment only
    if counters:
        _toggles.flush()
    return new


def deep_active() -> bool:
    """Is THIS thread inside a deep-sampled call? (The native codec and
    ``device_obs.sync_mode`` consult this per call and per launch.)"""
    return bool(getattr(_tls, "deep", False))


def deep_ran() -> bool:
    """Did THIS thread's current sampled call actually execute an
    instrumented path? ``router.observe`` (which runs INSIDE the call
    scope, before ``__exit__`` clears the flag) uses it to decide
    whether the call's wall time needs the overhead correction at all —
    a sampled call whose deep path never ran executed at normal speed
    and must teach the cost model uncorrected."""
    return bool(getattr(_tls, "deep_ran", False))


def note_deep_ran() -> None:
    """Called by the instrumented paths (profiled VM drain, forced
    device sync) when a sampled call ACTUALLY ran deep. A sampled call
    that could not (prof module still loading in the background, pure
    fallback tier) is counted ``sampling.deep_skipped`` instead and —
    crucially — contributes nothing to the deep-cost EWMA, so an
    uninstrumented call can never tune the period."""
    if getattr(_tls, "deep", False):
        _tls.deep_ran = True


def note_arm(arm: Optional[str]) -> None:
    """Called by ``router.observe`` (which runs INSIDE the call scope)
    with the arm that actually served this call, so the overhead EWMAs
    and the correction lookup key by the full routing feature. Pass
    None for a degraded call (the labeled arm did not run)."""
    _tls.arm = arm


def deep_weight() -> float:
    """The weight a sampled observation represents: the sampling period
    at the time the call was sampled (each deep call stands in for
    ~period calls). Callers scale drained per-opcode hits/seconds by it
    before merging into the live registry."""
    return float(getattr(_tls, "weight", _period))


def overhead_fraction() -> float:
    return _overhead


def overhead_known() -> bool:
    """Has at least one feature been measured on BOTH the deep and the
    normal path? Until then :func:`corrected_seconds` would be an
    identity — so a deep call's wall time (interpreter + profiler tax,
    possibly a cold prof load) must not teach the routing cost model at
    all (``router.observe`` ledgers it and skips the update)."""
    return _overhead_known


def period() -> int:
    return _period


def _tier_of(arm: Any) -> Optional[str]:
    """The tier prefix of a router arm label (``native/c4/thread`` ->
    ``native``), or None for an unrouted/degraded call."""
    return arm.split("/", 1)[0] if isinstance(arm, str) else None


def _correction_locked(key) -> float:
    """The deep/normal cost ratio to divide out of a sampled call's
    wall time (>= 1.0); callers hold ``_lock``. Per-feature when both
    sides of the pair have been measured ON THE SAME ARM — overhead
    varies a lot by feature (a warm specialized engine pays ~4x to run
    the interpreter, an unspecialized schema only the prof tax, a
    device arm just a sync per launch). Unmeasured features fall back
    to the mean of measured features on the SAME TIER (one tier shares
    one overhead mechanism); a wholly unmeasured tier gets NO
    correction — dividing a device call by the native interpreter's
    ratio would teach the cost model the arm is ~4x cheaper than it
    is, and a mild overestimate is the safer error. The global mean
    only serves keyless callers (no routing feature available)."""
    st = _feat.get(key) if key is not None else None
    if (st is not None and st[2] >= 1 and st[3] >= 1
            and st[0] > 0 and st[1] > st[0]):
        return st[1] / st[0]
    if key is not None:
        tier = _tier_of(key[3])
        num = den = 0.0
        for k, st2 in _feat.items():
            if (_tier_of(k[3]) == tier and st2[2] >= 1 and st2[3] >= 1
                    and st2[0] > 0):
                w = min(st2[3], 32.0)
                num += w * max(0.0, st2[1] / st2[0] - 1.0)
                den += w
        return 1.0 + (num / den if den > 0 else 0.0)
    return 1.0 + max(0.0, _overhead)


def corrected_seconds(seconds: float, schema: Optional[str] = None,
                      op: Optional[str] = None,
                      band: Optional[int] = None,
                      arm: Optional[str] = None) -> float:
    """A deep-sampled call's wall seconds with the estimated deep
    overhead divided out — what the call WOULD have cost un-profiled.
    Feeding the raw figure into the routing cost model would teach it
    that every ~Nth call's arm is mysteriously slower. Pass the call's
    (schema, op, band, arm) feature for the per-feature ratio — a ratio
    learned on another arm must not correct this one's wall time."""
    key = ((schema, op, int(band), arm)
           if schema is not None and op is not None and band is not None
           else None)
    with _lock:
        return seconds / _correction_locked(key)


def consume_last_correction(seconds: float) -> float:
    """Correct a figure for the call THIS thread just finished —
    ``telemetry.root_span.__exit__`` uses it to feed the SLO engine the
    call's comparable cost (the scope exits before the root span does,
    leaving the correction behind). Reads-and-clears, so it never leaks
    onto an unrelated later root span; 1.0 (identity) for calls that
    never ran deep."""
    c = getattr(_tls, "last_corr", 1.0)
    _tls.last_corr = 1.0
    return seconds / c if c > 1.0 else seconds


def prof_codec_module():
    """The per-opcode-profiled host VM module, or None (not yet built /
    no toolchain). The first deep-sampled call kicks the build+load on
    a BACKGROUND thread and itself runs undeep: a cold prof build is a
    g++ run (seconds) that must never stall a live request. Once the
    cached ``.so`` is loaded, every later deep call gets it directly."""
    global _prof_thread
    if _prof_mod_probed:
        return _prof_mod
    with _lock:
        if _prof_mod_probed or _prof_thread is not None:
            return _prof_mod

        def load():
            global _prof_mod_probed, _prof_mod, _skip_streak
            try:
                from .native import load_host_codec_prof

                mod = load_host_codec_prof().module
            except Exception:
                # no profiled build (no g++, a failed build, an injected
                # native_build fault): deep calls run undeep, counted
                mod = None
            with _lock:
                _prof_mod = mod
                _prof_mod_probed = True
                # skips accumulated WHILE loading don't count against
                # the post-probe retry budget: the module just landed,
                # give the next few sampled calls a clean shot
                _skip_streak = 0
            if mod is None:
                metrics.inc("sampling.prof_unavailable")

        _prof_thread = threading.Thread(
            target=load, name="pyruhvro-prof-load", daemon=True)
        _prof_thread.start()
    return None


def _retune_locked() -> None:
    """Recompute the overhead estimate and the period from the
    per-feature EWMAs; callers hold ``_lock``. Overhead is the
    deep-call-count-weighted mean of per-feature (deep/normal - 1)
    ratios — only features observed on BOTH paths vote."""
    global _overhead, _period, _overhead_known
    num = den = 0.0
    for norm, deep, n_norm, n_deep in _feat.values():
        if n_norm >= 1 and n_deep >= 1 and norm > 0:
            w = min(n_deep, 32.0)
            num += w * max(0.0, deep / norm - 1.0)
            den += w
    if den <= 0:
        return
    _overhead_known = True
    _overhead = num / den
    b = budget()
    if b > 0:
        want = _overhead / b
        _period = int(min(_PERIOD_MAX, max(_PERIOD_MIN, round(want))))


class call_scope:
    """Wrap one public API call body: decides whether THIS call runs the
    deep path, times it, and feeds the observation back into the online
    overhead estimate. The deep flag is thread-local, so concurrent
    calls never leak instrumentation into each other. Nested API
    re-entries (pool workers re-entering the public API for a chunk) do
    not re-sample: the outer scope owns the call."""

    __slots__ = ("op", "schema", "rows", "sampled", "_t0", "_nested")

    def __init__(self, op: str, schema: str, rows: int):
        self.op = op
        self.schema = schema
        self.rows = int(rows)
        self.sampled = False
        self._nested = False

    def __enter__(self) -> "call_scope":
        global _calls, _deep_calls
        _toggles.flush()
        if getattr(_tls, "deep", None) is not None:
            self._nested = True
            return self
        if not enabled():
            return self
        global _pending_resample
        with _lock:
            _calls += 1
            self.sampled = (_calls % _period == 0) or _pending_resample
            if self.sampled:
                _pending_resample = False
                weight = float(_period)
        metrics.inc("sampling.calls")
        if self.sampled:
            _tls.deep = True
            _tls.deep_ran = False
            _tls.weight = weight
            from . import telemetry

            telemetry.annotate(deep_sample=True)
        else:
            _tls.deep = False
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _deep_calls, _pending_resample
        if self._nested or getattr(_tls, "deep", None) is None:
            return False
        dt = time.perf_counter() - self._t0
        # an audited call's shadow re-execution ran inside this scope:
        # its wall seconds are the audit plane's tax, not the call's
        # cost (non-destructive peek; the root span consumes the TLS
        # for the SLO feed after this scope exits)
        from . import audit

        dt = max(1e-9, dt - audit.tls_shadow_seconds())
        sampled = self.sampled
        deep_ran = bool(getattr(_tls, "deep_ran", False))
        arm = getattr(_tls, "arm", None)
        _tls.deep = None
        _tls.deep_ran = False
        _tls.weight = None
        _tls.arm = None
        if sampled:
            global _skip_streak
            if deep_ran:
                with _lock:
                    _deep_calls += 1
                    _skip_streak = 0
                metrics.inc("sampling.deep_calls")
            else:
                # the slot fired but nothing instrumented ran (prof
                # build still loading, or this call's tier had nothing
                # to instrument): re-arm so the NEXT call samples —
                # coverage starts the moment the module lands — but
                # give up after a short streak so a workload with no
                # instrumentable tier doesn't sample every call forever
                metrics.inc("sampling.deep_skipped")
                with _lock:
                    _skip_streak += 1
                    if _prof_thread is not None and (
                            # loader still in flight: keep arming —
                            # these calls run the plain path, so the
                            # wait is free and coverage starts the
                            # moment the module lands
                            not _prof_mod_probed
                            # loaded, but this call's tier had nothing
                            # to instrument: a short streak covers
                            # mixed workloads without sampling every
                            # call of an uninstrumentable one forever
                            or (_prof_mod is not None
                                and _skip_streak <= 4)):
                        _pending_resample = True
        key = (self.schema, self.op,
               self.rows.bit_length() if self.rows > 0 else 0, arm)
        if (exc_type is None and self.rows > 0 and dt > 0
                and (deep_ran or not sampled)):
            spr = dt / self.rows
            with _lock:
                st = _feat.get(key)
                if st is None:
                    st = _feat[key] = [0.0, 0.0, 0.0, 0.0]
                i = 1 if sampled else 0
                st[i] = spr if st[i + 2] == 0 else (
                    st[i] + _ALPHA * (spr - st[i]))
                st[i + 2] += 1.0
                if sampled:
                    _retune_locked()
        if sampled and deep_ran and _overhead_known:
            # leave the correction behind for the enclosing root span
            # (it exits after this scope and feeds the SLO engine —
            # which must judge the call's COMPARABLE cost, not the
            # profiler's tax, or the sampler itself trips breaches)
            with _lock:
                _tls.last_corr = _correction_locked(key)
        else:
            _tls.last_corr = 1.0
        return False


def snapshot_sampling() -> Dict[str, Any]:
    """The ``sampling`` section of ``telemetry.snapshot()``: live
    state + tuning evidence. Empty dict when the sampler never ran, so
    snapshots stay shape-compatible with older consumers."""
    _toggles.flush()
    with _lock:
        if not _calls and _forced is None:
            return {}
        return {
            "enabled": enabled(),
            "budget": budget(),
            "period": _period,
            "calls": _calls,
            "deep_calls": _deep_calls,
            "overhead_frac": round(_overhead, 6),
            "features": len(_feat),
        }


def install_toggle_signal() -> bool:
    """Register a SIGUSR2 handler that flips deep sampling live — the
    companion of the SIGUSR1 flight dump. Safe to
    call repeatedly; returns False when unavailable (non-main thread,
    platform without SIGUSR2). The previous handler is chained."""
    global _signal_installed
    if _signal_installed:
        return True
    import signal

    if not hasattr(signal, "SIGUSR2"):
        return False

    prev = signal.getsignal(signal.SIGUSR2)

    def handler(signum, frame):
        toggle(counters=False)
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    try:
        signal.signal(signal.SIGUSR2, handler)
    except ValueError:  # not the main thread
        return False
    _signal_installed = True
    return True


def reset() -> None:
    """Clear counters, EWMAs and overrides (test isolation; called from
    ``telemetry.reset()``). The probed prof module stays cached — it is
    machine state, not telemetry."""
    global _calls, _deep_calls, _period, _forced, _overhead, \
        _overhead_known, _pending_resample, _skip_streak
    with _lock:
        _calls = 0
        _deep_calls = 0
        _period = _PERIOD_START
        _forced = None
        _overhead = 0.0
        _overhead_known = False
        _pending_resample = False
        _skip_streak = 0
        _feat.clear()
    _toggles.reset()
    _tls.deep = None
    _tls.deep_ran = False
    _tls.weight = None
    _tls.arm = None
