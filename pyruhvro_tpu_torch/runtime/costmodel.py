"""Online routing cost model: learned per-(schema, row band) arm costs
(copy of ``pyruhvro_tpu/runtime/costmodel.py``).

The knowledge store behind :mod:`.router`. Every routed call's observed
wall seconds update a per-(schema fingerprint, op, row band, arm)
estimate of **seconds per row**, where an *arm* is one concrete
execution choice ``tier/c<chunks>/<pool>`` (e.g. ``native/c8/shard``,
``device/c1/none``). The router predicts each candidate arm's cost from
these estimates, acts, and feeds the observation back here.

Statistics are Welford (count, mean, M2) over seconds per row, which
makes them **mergeable**: two profiles, or a process worker's shipped
observations (:class:`record_observations`, carried home by
``telemetry.worker_scope``), combine exactly. Counts are capped (aging)
so the model tracks drift instead of freezing on its first calls.

Persistence: ``PYRUHVRO_TPU_ROUTING_PROFILE`` (default
``ROUTING_PROFILE.torch.json``; set but empty turns it off), a versioned
document that also carries the capacity planner's plans (version 2,
:mod:`.capacity`) and the tag ``"package": "pyruhvro_tpu_torch"``: a
document without the tag (the reference's, or any other) is refused
like a stale version, so the two packages never teach each other.
:func:`save_profile` does a read-modify-write merge so concurrent
processes fold together, and :func:`load_profile` treats a corrupt,
stale or foreign file as a cold start (counted, never raised). With
``PYRUHVRO_TPU_AUTOTUNE=1`` or ``PYRUHVRO_TPU_CAPACITY_PERSIST=1`` the
profile loads at import and a merge-save registers at exit.

The recompile-storm guard (``device_obs.note_compile``) feeds
:func:`penalize`: a storming schema's device arms are withheld from the
router for the churn window. The reference's seams are in place: the
``profile_load`` / ``profile_save`` faults (:mod:`.faults`; counted as a
load or save error, the call goes on) and the ``costmodel.observe`` /
``costmodel.save`` yield points (:mod:`.schedtest`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import fsio, knobs, metrics, schedtest

__all__ = [
    "PROFILE_VERSION",
    "PACKAGE",
    "autotune_enabled",
    "explore_rate",
    "profile_path",
    "row_band",
    "band_label",
    "arm_key",
    "observe",
    "predict",
    "obs_count",
    "tick",
    "penalize",
    "device_penalized",
    "penalize_arm",
    "arm_penalized",
    "record_observations",
    "merge_observations",
    "snapshot",
    "merge_doc",
    "load_profile",
    "save_profile",
    "arm_persistence",
    "reset",
]

# version 2: adds the learned device-capacity section
# ("capacity": [...] rows, max-merged — see runtime/capacity.py) next
# to the Welford arm entries. Version-1 files still LOAD (they simply
# carry no capacity knowledge); saves always write version 2.
PROFILE_VERSION = 2
_READABLE_VERSIONS = (1, 2)
# the tag every document of this package carries; one without it is
# refused, so the reference's profile never teaches the port
PACKAGE = "pyruhvro_tpu_torch"

# evidence cap per (feature, arm): past this, old counts halve before a
# new observation lands, so the mean is an EWMA-like tracker of the
# RECENT regime (a re-specialized schema, a recovered tunnel) instead of
# an ever-heavier anchor on history
_N_CAP = 256.0

_lock = threading.Lock()
# (schema_fp, op, band, arm) -> [n, mean_s_per_row, m2]
_stats: Dict[Tuple[str, str, int, str], List[float]] = {}  # guarded-by: _lock
# per-key baseline of evidence that came FROM DISK (load_profile or a
# previous save's rebase): save_profile subtracts it so each save
# contributes only THIS process's own observations — without it, every
# load+save cycle would Welford-merge the same historical evidence
# twice and the profile would compound its own past
_loaded: Dict[Tuple[str, str, int, str], List[float]] = {}  # guarded-by: _lock
# (schema_fp, op, band) -> decide() count (the exploration schedule)
_decides: Dict[Tuple[str, str, int], int] = {}  # guarded-by: _lock
# schema_fp -> monotonic expiry of the recompile-storm device penalty
_penalties: Dict[str, float] = {}  # guarded-by: _lock
# (schema_fp, arm) -> (monotonic expiry, cost factor) of a per-arm
# penalty (latency drift: the drifting arm's predictions are INFLATED
# by the measured regression ratio while it re-learns — soft, unlike
# the hard device-storm withholding, because "this arm got 1.6x
# slower" must not force the router onto an arm predicted 4x worse)
_arm_penalties: Dict[Tuple[str, str], Tuple[float, float]] = {}  # guarded-by: _lock
_persist_armed = False  # guarded-by: _lock
_tls = threading.local()


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------


def autotune_enabled() -> bool:
    """``PYRUHVRO_TPU_AUTOTUNE=1`` — the router predicts/acts from this
    model instead of the static env-knob gates (read per call so tests
    can flip it in-process)."""
    return knobs.get_bool("PYRUHVRO_TPU_AUTOTUNE")


def explore_rate() -> float:
    """Exploration rate in [0, 1] (``PYRUHVRO_TPU_EXPLORE``, default
    0.05): roughly this fraction of autotuned calls try the
    least-observed candidate arm instead of the predicted-best one.
    0 disables exploration (pure exploitation of the warm profile). The
    reference's in-process override (``set_explore_override``, for its
    serving plane's brownout) waits for that plane (``ROADMAP.md``
    (a) 8)."""
    return min(1.0, max(0.0, knobs.get_float("PYRUHVRO_TPU_EXPLORE")))


def profile_path() -> str:
    """Where routing knowledge persists (default
    ``ROUTING_PROFILE.torch.json`` in the working directory). Set but
    empty turns persistence off."""
    # set-but-empty disables persistence, so the raw value (not the
    # empty-means-default get_str view) is the contract here
    if knobs.is_set("PYRUHVRO_TPU_ROUTING_PROFILE"):
        return knobs.get_raw("PYRUHVRO_TPU_ROUTING_PROFILE")
    return knobs.DEFAULTS["PYRUHVRO_TPU_ROUTING_PROFILE"]


# ---------------------------------------------------------------------------
# features and arms
# ---------------------------------------------------------------------------


def row_band(n: int) -> int:
    """Log2 row band: 0 for an empty call, else ``bit_length`` — rows in
    [2^(b-1), 2^b) share a band, coarse enough to pool evidence and fine
    enough that seconds-per-row stays comparable within one."""
    n = int(n)
    return n.bit_length() if n > 0 else 0


def band_label(b: int) -> str:
    if b <= 0:
        return "0"
    return f"{1 << (b - 1)}..{(1 << b) - 1}"


def arm_key(tier: str, chunks: int, pool: str) -> str:
    """One executable routing choice: ``tier/c<chunks>/<pool>``."""
    return f"{tier}/c{int(chunks)}/{pool}"


# ---------------------------------------------------------------------------
# observe / predict
# ---------------------------------------------------------------------------


def observe(schema: str, op: str, band: int, arm: str, rows: int,
            seconds: float) -> None:
    """Fold one observed call into the model (Welford on s/row, aged at
    ``_N_CAP``) and into any active thread-local recorder (the worker
    export path — see :class:`record_observations`)."""
    if rows <= 0 or seconds < 0:
        return
    x = seconds / rows
    key = (schema, op, int(band), arm)
    schedtest.yp("costmodel.observe")
    with _lock:
        st = _stats.get(key)
        if st is None:
            st = _stats[key] = [0.0, 0.0, 0.0]
        n, mean, m2 = st
        if n >= _N_CAP:
            n *= 0.5
            m2 *= 0.5
        n += 1.0
        d = x - mean
        mean += d / n
        m2 += d * (x - mean)
        st[0], st[1], st[2] = n, mean, m2
    rec = getattr(_tls, "robs", None)
    if rec is not None:
        rec.append([schema, op, int(band), arm, int(rows),
                    round(seconds, 9)])


def predict(schema: str, op: str, band: int, arm: str,
            rows: int) -> Optional[float]:
    """Predicted wall seconds for ``rows`` on this arm, or None when the
    arm has never been observed at this feature (the router never picks
    an unobserved arm greedily — only the exploration schedule does).
    An active drift penalty (:func:`penalize_arm`) inflates the figure
    by its factor."""
    with _lock:
        st = _stats.get((schema, op, int(band), arm))
        if st is None or st[0] <= 0:
            return None
        return st[1] * max(int(rows), 1) * _arm_factor_locked(schema, arm)


def obs_count(schema: str, op: str, band: int, arm: str) -> float:
    with _lock:
        st = _stats.get((schema, op, int(band), arm))
        return st[0] if st else 0.0


def predict_drain(schema: str, op: str, rows: int) -> Optional[float]:
    """Predicted wall seconds to process ``rows`` of ``schema`` on the
    BEST observed arm at any band — the serving plane's shed
    retry-after hint ("come back once the backlog should have
    drained"). Optimistic by construction (the router will pick at
    least this good an arm); None when the model has never observed
    this (schema, op)."""
    with _lock:
        best = None
        for (s, o, _band, arm), st in _stats.items():
            if s != schema or o != op or st[0] <= 0:
                continue
            est = st[1] * max(int(rows), 1) * _arm_factor_locked(s, arm)
            if best is None or est < best:
                best = est
    return best


def tick(schema: str, op: str, band: int) -> int:
    """Per-feature decide counter — drives the deterministic exploration
    schedule (every ``round(1/rate)``-th call explores)."""
    key = (schema, op, int(band))
    with _lock:
        _decides[key] = _decides.get(key, 0) + 1
        return _decides[key]


# ---------------------------------------------------------------------------
# recompile-storm penalty (device_obs.note_compile feeds this)
# ---------------------------------------------------------------------------


def penalize(schema: str, window_s: float = 60.0) -> None:
    """Withhold this schema's device arms from the router for
    ``window_s`` seconds — the recompile-storm guard's hard cost
    penalty. A storming arm must stop being OFFERED; waiting for the
    model to learn its cost would mean re-paying a compile per lesson."""
    with _lock:
        _penalties[schema] = time.monotonic() + max(0.0, window_s)
    metrics.inc("router.device_penalty")


def device_penalized(schema: str) -> bool:
    with _lock:
        until = _penalties.get(schema)
        if until is None:
            return False
        if time.monotonic() >= until:
            del _penalties[schema]
            return False
        return True


def penalize_arm(schema: str, arm: str, window_s: float = 60.0,
                 factor: float = 2.0) -> None:
    """Inflate ONE arm's predictions by ``factor`` for ``window_s``
    seconds — the latency-drift detector's verdict (:mod:`.drift`): a
    drifting arm keeps its learned estimate (which drift just proved
    stale-low) and would keep winning greedily on it, so its predicted
    cost carries the measured regression ratio until fresh evidence
    accumulates. Soft by design: the router leaves the arm only when
    an alternative is predicted cheaper even against the inflated
    figure — a 1.6x drift must not force traffic onto a 4x-worse arm
    (the failure mode a hard withhold showed in the route matrix)."""
    with _lock:
        _arm_penalties[(schema, arm)] = (
            time.monotonic() + max(0.0, window_s), max(1.0, factor))
    metrics.inc("router.arm_penalty")


def _arm_factor_locked(schema: str, arm: str) -> float:
    """Current penalty factor (1.0 = none); callers hold ``_lock``."""
    ent = _arm_penalties.get((schema, arm))
    if ent is None:
        return 1.0
    until, factor = ent
    if time.monotonic() >= until:
        del _arm_penalties[(schema, arm)]
        return 1.0
    return factor


def arm_penalty(schema: str, arm: str) -> float:
    with _lock:
        return _arm_factor_locked(schema, arm)


def arm_penalized(schema: str, arm: str) -> bool:
    return arm_penalty(schema, arm) > 1.0


# ---------------------------------------------------------------------------
# cross-process observation shipping (worker_scope payloads)
# ---------------------------------------------------------------------------


class record_observations:
    """Record every :func:`observe` made on THIS thread into a plain
    list — the routing analogue of :class:`.metrics.record_deltas`.
    ``telemetry.worker_scope`` wraps worker work in one of these and
    ships the list in its payload; :func:`merge_observations` folds it
    into the parent process's model. Nesting is additive."""

    __slots__ = ("obs", "_prev")

    def __enter__(self) -> List[list]:
        self._prev = getattr(_tls, "robs", None)
        self.obs = []
        _tls.robs = self.obs
        return self.obs

    def __exit__(self, *exc):
        _tls.robs = self._prev
        if self._prev is not None:
            self._prev.extend(self.obs)
        return False


def merge_observations(obs) -> int:
    """Fold a worker's shipped observation list into this process's
    model; malformed items are skipped (a worker on a newer/older
    version must never fail the parent's call)."""
    merged = 0
    for item in obs or ():
        try:
            schema, op, band, arm, rows, seconds = item
            observe(str(schema), str(op), int(band), str(arm), int(rows),
                    float(seconds))
            merged += 1
        except (TypeError, ValueError):
            continue
    if merged:
        metrics.inc("router.worker_obs", float(merged))
    return merged


# ---------------------------------------------------------------------------
# export / persistence
# ---------------------------------------------------------------------------


def snapshot() -> Dict[str, Any]:
    """The model as a versioned, mergeable document — also the on-disk
    ``ROUTING_PROFILE.json`` format."""
    now = time.monotonic()
    with _lock:
        entries = [
            {"schema": k[0], "op": k[1], "band": k[2], "arm": k[3],
             "n": round(st[0], 3), "s_per_row": st[1], "m2": st[2]}
            for k, st in sorted(_stats.items())
        ]
        pen = {k: round(v - now, 3) for k, v in _penalties.items()
               if v > now}
        apen = {f"{k[0]}|{k[1]}": {"remaining_s": round(v[0] - now, 3),
                                   "factor": v[1]}
                for k, v in _arm_penalties.items() if v[0] > now}
    doc: Dict[str, Any] = {"version": PROFILE_VERSION, "package": PACKAGE,
                           "entries": entries}
    if pen:
        doc["device_penalties_s"] = pen  # runtime-only; never persisted
    if apen:
        doc["arm_penalties"] = apen  # runtime-only; never persisted
    from . import capacity

    cap = capacity.entries()
    if cap:
        doc["capacity"] = cap
    return doc


def _combine(a: Optional[List[float]],
             b: List[float]) -> List[float]:
    """Parallel Welford combine of two [n, mean, m2] triples (capped)."""
    if a is None or a[0] <= 0:
        return [min(b[0], _N_CAP), b[1], b[2]]
    na, ma, m2a = a
    nb, mb, m2b = b
    nt = na + nb
    if nt <= 0:
        return list(a)
    d = mb - ma
    mt = ma + d * nb / nt
    m2t = m2a + m2b + d * d * na * nb / nt
    if nt > _N_CAP:
        scale = _N_CAP / nt
        nt *= scale
        m2t *= scale
    return [nt, mt, m2t]


def _subtract(total: List[float],
              base: Optional[List[float]]) -> Optional[List[float]]:
    """Reverse the combine: ``total ⊖ base`` = the evidence added on
    top of ``base``. None when nothing (or nonsense, e.g. after aging
    shrank the count below the baseline) remains — the caller then
    contributes nothing for the key rather than phantom counts."""
    if base is None or base[0] <= 0:
        return list(total)
    nt, mt, m2t = total
    na, ma, m2a = base
    nb = nt - na
    if nb <= 1e-9:
        return None
    mb = (mt * nt - ma * na) / nb
    d = mb - ma
    m2b = m2t - m2a - d * d * na * nb / nt
    if mb < 0:
        return None
    return [nb, mb, max(m2b, 0.0)]


def _merge_entry(key: Tuple[str, str, int, str], n: float, mean: float,
                 m2: float, *, loaded: bool = False) -> None:
    with _lock:
        _stats[key] = _combine(_stats.get(key), [n, mean, m2])
        if loaded:
            _loaded[key] = _combine(_loaded.get(key), [n, mean, m2])


def _doc_entries(doc: Any) -> Dict[Tuple[str, str, int, str],
                                   List[float]]:
    """Validate a profile document -> {key: [n, mean, m2]}. Raises
    ValueError on a non-profile, a version this build does not speak or
    a document of another package; individual malformed entries are
    skipped."""
    if not isinstance(doc, dict):
        raise ValueError("routing profile must be a JSON object")
    if doc.get("version") not in _READABLE_VERSIONS:
        raise ValueError(
            f"routing profile version {doc.get('version')!r} not in "
            f"{_READABLE_VERSIONS}")
    if doc.get("package") != PACKAGE:
        raise ValueError(
            f"routing profile of package {doc.get('package')!r}, not "
            f"{PACKAGE!r}")
    out: Dict[Tuple[str, str, int, str], List[float]] = {}
    for e in doc.get("entries") or []:
        try:
            key = (str(e["schema"]), str(e["op"]), int(e["band"]),
                   str(e["arm"]))
            n = float(e["n"])
            mean = float(e["s_per_row"])
            m2 = float(e.get("m2", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        if n <= 0 or mean < 0 or m2 < 0:
            continue
        out[key] = _combine(out.get(key), [n, mean, m2])
    return out


def merge_doc(doc: Any, *, loaded: bool = False) -> int:
    """Fold a profile document into the live model (exact Welford
    combine per entry); ``loaded=True`` additionally records it as
    disk-sourced baseline so :func:`save_profile` does not write the
    same evidence back twice. Raises ValueError on a non-profile or a
    stale version. Returns the number of entries merged."""
    entries = _doc_entries(doc)
    for key, (n, mean, m2) in entries.items():
        _merge_entry(key, n, mean, m2, loaded=loaded)
    # capacity rows (profile v2) max-merge — idempotent, so no loaded
    # baseline is needed for them
    from . import capacity

    capacity.merge_entries(doc.get("capacity"))
    return len(entries)


def load_profile(path: Optional[str] = None) -> bool:
    """Merge the on-disk profile into the live model. A missing,
    corrupt, stale-version or foreign file is a COLD START, not an
    error: counted as ``router.profile_load_error`` and the process
    routes statically until it learns — never raises."""
    from . import faults

    path = path or profile_path()
    if not path:
        return False
    try:
        faults.fire("profile_load")
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        merge_doc(doc, loaded=True)
    except FileNotFoundError:
        return False  # no profile yet is the normal first run, not an error
    except (OSError, ValueError, faults.FaultInjected):
        metrics.inc("router.profile_load_error")
        return False
    metrics.inc("router.profile_loaded")
    return True


def save_profile(path: Optional[str] = None) -> Optional[str]:
    """Persist the model: write (latest disk content) ⊕ (THIS process's
    own evidence — live stats minus the loaded baseline) atomically
    (tmp + rename). Subtracting the baseline keeps load→save cycles
    idempotent; re-reading disk first lets concurrent writers fold
    together instead of clobbering. On success the live model and
    baseline REBASE onto the saved document (siblings' fresh evidence
    flows in; a second save contributes nothing new). Returns the path,
    or None when persistence is disabled/failed."""
    path = path or profile_path()
    if not path:
        return None
    with _lock:
        own: Dict[Tuple[str, str, int, str], List[float]] = {}
        # pre-save snapshot: observations that land while the disk RMW
        # below runs are invisible to ``own`` — the rebase recovers them
        # by diffing the live stats against THIS snapshot (the
        # atexit save raced in-flight observe() and silently erased its
        # evidence between the own-compute and the rebase clear)
        pre = {key: list(st) for key, st in _stats.items()}
        for key, st in pre.items():
            contrib = _subtract(st, _loaded.get(key))
            if contrib is not None and contrib[0] > 0:
                own[key] = contrib
    schedtest.yp("costmodel.save")
    # serialize concurrent savers (two processes exiting together):
    # without the lock, both read the same disk doc and the second
    # rename silently drops the first writer's evidence. flock is
    # advisory and POSIX-only; where unavailable the read-modify-write
    # window stays (small, and bounded-loss: one process's deltas)
    lock_fh = None
    try:
        import fcntl

        lock_fh = open(path + ".lock", "a")
        fcntl.flock(lock_fh.fileno(), fcntl.LOCK_EX)
    except (ImportError, OSError):
        lock_fh = None
    try:
        from . import capacity

        merged: Dict[Tuple[str, str, int, str], List[float]] = {}
        try:
            with open(path, encoding="utf-8") as f:
                disk_doc = json.load(f)
            merged = _doc_entries(disk_doc)
            # capacity is max-merged and idempotent: folding the disk
            # rows into the live planner and exporting the union is the
            # concurrent-writer-safe read-modify-write
            capacity.merge_entries(disk_doc.get("capacity"))
        except (OSError, ValueError):
            pass  # first save, or a corrupt/stale file being replaced
        for key, st in own.items():
            merged[key] = _combine(merged.get(key), st)
        doc: Dict[str, Any] = {
            "version": PROFILE_VERSION,
            "package": PACKAGE,
            "entries": [
                {"schema": k[0], "op": k[1], "band": k[2], "arm": k[3],
                 "n": round(st[0], 3), "s_per_row": st[1], "m2": st[2]}
                for k, st in sorted(merged.items())
            ],
            "saved_unix": round(time.time(), 3),
        }
        cap_rows = capacity.entries()
        if cap_rows:
            doc["capacity"] = cap_rows
        from . import faults

        try:
            faults.fire("profile_save")
            fsio.atomic_write_json(path, doc, sort_keys=True,
                                   default=None)
        except (OSError, ValueError, faults.FaultInjected):
            metrics.inc("router.profile_save_error")
            return None
    finally:
        if lock_fh is not None:
            try:
                lock_fh.close()  # closing releases the flock
            except OSError:
                pass
    with _lock:
        # evidence observed while the file RMW ran: live minus the
        # pre-save snapshot. Folded back into the rebased stats but NOT
        # into the loaded baseline — it was never written, so the next
        # save still contributes it. (Aging that halved counts in the
        # window can make the diff vanish; that loss is bounded to the
        # window and counted nowhere because it cannot be detected.)
        late = {}
        for key, st in _stats.items():
            d = _subtract(st, pre.get(key))
            if d is not None and d[0] > 0:
                late[key] = d
        _stats.clear()
        _loaded.clear()
        for key, st in merged.items():
            _stats[key] = list(st)
            _loaded[key] = list(st)
        for key, d in late.items():
            _stats[key] = _combine(_stats.get(key), d)
    metrics.inc("router.profile_saved")
    return path


def _atexit_save() -> None:
    from . import capacity

    has_cap = capacity.persist_enabled() and capacity.entries()
    if (autotune_enabled() and _stats) or has_cap:
        try:
            save_profile()
        except Exception:
            pass  # exit-time persistence must never traceback


def arm_persistence() -> None:
    """Load the profile once and register the exit-time merge-save.
    Runs at import when ``PYRUHVRO_TPU_AUTOTUNE=1`` is already set, or
    lazily on the first autotuned decide otherwise."""
    global _persist_armed
    with _lock:
        if _persist_armed:
            return
        _persist_armed = True
    p = profile_path()
    if p and os.path.exists(p):
        load_profile(p)
    import atexit

    atexit.register(_atexit_save)


def reset() -> None:
    """Clear the in-memory model, schedules and penalties (test
    isolation; called from ``telemetry.reset()``). Does not touch the
    on-disk profile."""
    with _lock:
        _stats.clear()
        _loaded.clear()
        _decides.clear()
        _penalties.clear()
        _arm_penalties.clear()
    from . import capacity

    capacity.reset()


# warm start: a process launched with autotune on picks its profile up
# before the first call (the load-at-import contract); capacity-persist
# processes need the same so a fresh process's first device
# call starts at the learned rung
def _capacity_persist() -> bool:
    from . import capacity

    return capacity.persist_enabled()


if autotune_enabled() or _capacity_persist():
    arm_persistence()
