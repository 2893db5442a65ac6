"""Routing: predict, act, observe, update, with a ledger (copy of the
routing core of ``pyruhvro_tpu/runtime/router.py``: ``RouteDecision``,
``_pools_for``, ``_nearest_arm``, ``decide``, ``observe``, the ledger
with ``last_entry``, ``snapshot_routing`` and ``reset``, and
``render_route_report`` / ``render_what_if``).

Every API call of the port goes through :func:`decide`, which returns a
:class:`RouteDecision`, and ends with :func:`observe`, which

* updates the :mod:`.costmodel` with the observed wall seconds,
* appends a **ledger entry** (features, chosen arm, mode: static /
  cold_start / model / explore, predicted cost, observed cost, and the
  predictions for the arms not taken) to a ring surfaced through
  ``telemetry.snapshot()["routing"]``,
* annotates the call's root span with the arm and both costs.

``api._route_candidates``'s static verdict is the cold-start policy and
the ``PYRUHVRO_TPU_AUTOTUNE``-off behaviour. With autotune on the router
picks the predicted-cheapest candidate arm (tier x pool at the call's
chunk count); every ``round(1/PYRUHVRO_TPU_EXPLORE)``-th call per
feature tries the least-observed arm instead. Unobserved arms are never
chosen greedily. A schema under a recompile-storm penalty
(:func:`.costmodel.penalize`, fed by ``device_obs``) has its device arm
withheld.

The arm space departs from the reference in one place (``ROADMAP.md``
(c) 9): the port's native tier has no per-chunk thread loop, so its
pools are ``shard`` and, when the spawn pool is available, ``process``,
never ``thread``. A deep-sampled call (:mod:`.sampling`) carries
``RouteDecision.sampled``; :func:`observe` tells the sampler which arm
served it (``sampling.note_arm``) and divides the deep path's estimated
overhead out of its seconds (``sampling.corrected_seconds``) before the
cost model learns them, as in the reference. The ``routing`` probe of
:mod:`.memacct` reports the ledger's and the cost model's bytes
(stated estimates a row, the reference's ``router.py:390-414``).

``python -m pyruhvro_tpu_torch.telemetry route-report <snapshot>``
renders the ledger and the model; ``what-if <snapshot>`` replays the
ledger and shows where another arm would have won.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import (breaker, costmodel, deadline, drift, knobs, memacct, metrics,
               sampling, telemetry)

__all__ = [
    "RouteDecision",
    "decide",
    "observe",
    "last_entry",
    "snapshot_routing",
    "reset",
    "render_route_report",
    "render_what_if",
]


_LEDGER_N = max(1, knobs.get_int("PYRUHVRO_TPU_LEDGER_N"))

_lock = threading.Lock()
_ledger: deque = deque(maxlen=_LEDGER_N)  # guarded-by: _lock
_entries_seen = 0  # guarded-by: _lock


class RouteDecision:
    """One routed call: where it went, why, and what was predicted."""

    __slots__ = ("tier", "impl", "reason", "pool", "arm", "mode",
                 "explore", "autotune", "schema", "op", "band", "rows",
                 "chunks", "predicted", "degraded", "sampled", "_t0",
                 "_done")

    def __init__(self, *, tier, impl, reason, pool, arm, mode, explore,
                 autotune, schema, op, band, rows, chunks, predicted):
        # set True by the API body when execution diverged from the
        # decided arm (a process fan-out that degraded to threads): the
        # observation then must NOT teach the model that arm's cost
        self.degraded = False
        # set by the API body from its sampling.call_scope: this call
        # ran the deep path (its seconds are corrected in observe)
        self.sampled = False
        self.tier = tier
        self.impl = impl
        self.reason = reason
        self.pool = pool
        self.arm = arm
        self.mode = mode
        self.explore = explore
        self.autotune = autotune
        self.schema = schema
        self.op = op
        self.band = band
        self.rows = rows
        self.chunks = chunks
        self.predicted = predicted  # arm -> predicted seconds | None
        self._t0 = time.perf_counter()
        self._done = False


def _pools_for(tier: str, chunks: int, proc_ok: bool,
               shard_ok: bool = False) -> Tuple[str, ...]:
    """Pool component of the arm space: the device tier's chunk axis is
    the card, and a single chunk has nothing to fan out. The oracle
    fans out on ``thread`` or ``process``; the native tier on ``shard``
    (the one-call C++ shard runner, whenever its module is loaded) and
    ``process`` (``ROADMAP.md`` (c) 9: it has no ``thread`` loop)."""
    if tier == "device" or chunks <= 1:
        return ("none",)
    if tier == "native":
        pools = ("shard",) if shard_ok else ()
        return pools + (("process",) if proc_ok else ())
    return ("thread", "process") if proc_ok else ("thread",)


def _nearest_arm(offered: Dict[str, Any], static_tier: str,
                 chunks: int) -> str:
    """Cold-start fallback when the static arm itself is withheld
    (storm penalty, broken pool): the closest SAFE arm to the static
    verdict — same tier on the default pool, then any host arm off the
    process pool — never an arbitrary lexicographic pick (which would
    route to the device or the spawn pool with zero evidence)."""
    for cand in (costmodel.arm_key(static_tier, chunks, "shard"),
                 costmodel.arm_key(static_tier, chunks, "thread"),
                 costmodel.arm_key(static_tier, chunks, "none")):
        if cand in offered:
            return cand
    safe = [a for a in offered
            if not a.startswith("device/") and not a.endswith("/process")]
    if safe:
        return min(safe)
    return min(offered)


def decide(entry, backend: str, n_rows: int, *, op: str, chunks: int,
           candidates: Dict[str, Any],
           static: Tuple[str, Any, Optional[str]]) -> RouteDecision:
    """Resolve this call's arm. ``candidates`` maps each AVAILABLE tier
    to its impl (built by ``api._route_candidates``); ``static`` is the
    static-gate verdict ``(tier, impl, reason)`` — the autotune-off
    behavior and the cold-start policy."""
    from .pool import pool_mode, process_available, shard_available

    tier_s, impl_s, reason_s = static
    schema = entry.fingerprint
    band = costmodel.row_band(n_rows)
    autotune = costmodel.autotune_enabled()
    proc_ok = process_available()
    shard_ok = shard_available()
    static_pool = "none"
    if tier_s != "device" and chunks > 1:
        static_pool = pool_mode()
        # the shard runner is the native tier's fan-out (it has no
        # thread loop); an explicit PYRUHVRO_TPU_POOL=process keeps the
        # operator's spawn-pool choice
        if tier_s == "native" and static_pool == "thread":
            static_pool = "shard"
    static_arm = costmodel.arm_key(tier_s, chunks, static_pool)

    arms: Dict[str, Tuple[str, Any, str]] = {}
    for tier, impl in candidates.items():
        for p in _pools_for(tier, chunks, proc_ok, shard_ok):
            arms[costmodel.arm_key(tier, chunks, p)] = (tier, impl, p)
    arms.setdefault(static_arm, (tier_s, impl_s, static_pool))
    predicted = {a: costmodel.predict(schema, op, band, a, n_rows)
                 for a in arms}

    chosen, mode, reason, explore = static_arm, "static", reason_s, False
    if autotune:
        costmodel.arm_persistence()
        count = costmodel.tick(schema, op, band)
        rate = costmodel.explore_rate()
        period = int(round(1.0 / rate)) if rate > 0 else 0
        explore_tick = bool(period and count % period == 0)
        offered = dict(arms)
        if not proc_ok:
            # the static-arm seed can re-insert a */process arm even
            # after the spawn pool's breaker opened; never offer an arm
            # every attempt of which degrades to threads
            for a in [a for a in offered if a.endswith("/process")]:
                if len(offered) > 1:
                    del offered[a]
        elif breaker.get("process_pool").state() == "half_open":
            # recovering spawn pool: half-open probes ride the explore
            # schedule — greedy traffic stays on the proven arms, and
            # the scheduled explore call (which favors the now-least-
            # observed arm) is the one that probes the pool back in
            for a in [a for a in offered if a.endswith("/process")]:
                if not explore_tick and len(offered) > 1:
                    del offered[a]
                    metrics.inc("router.halfopen_defer")
        if costmodel.device_penalized(schema):
            # recompile storm: the guard's verdict is a hard penalty —
            # the device arm is not offered at all this window. Unless
            # it is the ONLY option (backend="tpu"): a forced backend
            # must still run, penalty or not.
            dropped = [a for a in offered if a.startswith("device/")]
            if dropped and len(dropped) < len(offered):
                for a in dropped:
                    del offered[a]
                metrics.inc("router.storm_skip")
        # latency drift (runtime/drift.py) needs no drop here: a
        # drifted arm's predictions arrive INFLATED by the measured
        # regression ratio (costmodel.predict x arm_penalty), so the
        # greedy pick leaves it exactly when an alternative is
        # predicted cheaper even against the inflated figure
        rem = deadline.remaining()
        if rem is not None:
            # a deadline-bounded call skips arms already predicted to
            # blow the remaining budget (kept only when NOTHING fits:
            # the least-bad arm still serves, and the checkpoint layer
            # bounds the damage)
            over = [a for a in offered
                    if predicted.get(a) is not None and predicted[a] > rem]
            if over and len(over) < len(offered):
                for a in over:
                    del offered[a]
                metrics.inc("router.deadline_skip", float(len(over)))
        known = {a: p for a, p in predicted.items()
                 if a in offered and p is not None}
        if explore_tick and len(offered) > 1:
            chosen = min(offered, key=lambda a: (
                costmodel.obs_count(schema, op, band, a), a))
            mode, explore = "explore", True
        elif known:
            chosen = min(known, key=lambda a: (known[a], a))
            mode = "model"
        else:
            chosen = (static_arm if static_arm in offered
                      else _nearest_arm(offered, tier_s, chunks))
            mode = "cold_start"
        if chosen != static_arm:
            metrics.inc("router.override")
            reason = "autotune_explore" if explore else "autotune_model"
    tier, impl, pool = arms.get(chosen, (tier_s, impl_s, static_pool))
    return RouteDecision(
        tier=tier, impl=impl, reason=reason, pool=pool, arm=chosen,
        mode=mode, explore=explore, autotune=autotune, schema=schema,
        op=op, band=band, rows=n_rows, chunks=chunks,
        predicted=predicted,
    )


def observe(dec: Optional[RouteDecision],
            error: Optional[BaseException] = None) -> None:
    """Close the loop on one decision: observed wall seconds into the
    model (clean calls only — an errored call teaches nothing about
    throughput), a ledger entry into the ring, the arm + predicted vs
    observed cost onto the call's root span. Idempotent per decision."""
    global _entries_seen
    if dec is None or dec._done:
        return
    dec._done = True
    dt = time.perf_counter() - dec._t0
    # a deep-sampled call's wall time includes the deep path's tax:
    # divide the estimated overhead back out so the model learns the
    # arm's true cost. Only calls whose deep path actually ran need the
    # correction, and until the sampler has measured the overhead once
    # a deep call is ledgered but teaches nothing
    ran_deep = dec.sampled and sampling.deep_ran()
    uncorrectable = ran_deep and not sampling.overhead_known()
    # the sampler's overhead EWMAs key by the arm that served the call;
    # a degraded call's labeled arm did not run
    arm = None if dec.degraded else dec.arm
    sampling.note_arm(arm)
    if ran_deep and not uncorrectable:
        dt = sampling.corrected_seconds(dt, dec.schema, dec.op,
                                        dec.band, arm)
    metrics.inc("router.calls")
    if dec.explore:
        metrics.inc("router.explored")
    if dec.degraded:
        # executed on a different path than the arm label says (pool
        # degradation): ledger it, but a mislabeled observation would
        # poison the model's estimate for the arm that did NOT run
        metrics.inc("router.degraded")
    elif error is None and not uncorrectable:
        costmodel.observe(dec.schema, dec.op, dec.band, dec.arm,
                          dec.rows, dt)
        if dec.rows > 0:
            # the EWMA drift detector watches the same clean stream,
            # keyed by the same (schema, op, band, arm) feature
            drift.observe(dec.schema, dec.op, dec.band, dec.arm,
                          dt / dec.rows)
    elif error is not None:
        metrics.inc("router.call_error")
        if isinstance(error, deadline.DeadlineExceeded):
            # unlike other errors (which teach nothing about
            # throughput), a blown deadline IS a cost observation: the
            # arm spent at least the budget and delivered NOTHING. The
            # elapsed wall seconds are capped at the budget though — a
            # figure strictly BELOW the arm's true cost — so teaching
            # them raw would make the failing arm look CHEAPER than an
            # honest alternative (true cost 10s, budget 5s: every
            # expiry records 5s and greedy keeps picking the arm that
            # keeps blowing deadlines). Record an inflated lower bound
            # instead: repeated expiries price the arm out, one real
            # success re-teaches the true cost. A timeout_s=0 probe
            # (budget 0, ~µs elapsed) teaches nothing — its near-zero
            # figure would poison the estimate toward free.
            metrics.inc("router.deadline_exceeded")
            budget = getattr(error, "budget_s", None) or 0.0
            if budget > 0:
                costmodel.observe(dec.schema, dec.op, dec.band, dec.arm,
                                  dec.rows, max(dt, budget) * 4.0)
    pred = dec.predicted.get(dec.arm)
    entry: Dict[str, Any] = {
        "ts": round(time.time(), 6),
        "op": dec.op,
        "schema": dec.schema,
        "rows": dec.rows,
        "band": dec.band,
        "chunks": dec.chunks,
        "arm": dec.arm,
        "tier": dec.tier,
        "pool": dec.pool,
        "mode": dec.mode,
        "reason": dec.reason,
        "autotune": dec.autotune,
        "predicted_s": None if pred is None else round(pred, 9),
        "observed_s": round(dt, 9),
        "counterfactual_s": {
            a: (None if p is None else round(p, 9))
            for a, p in sorted(dec.predicted.items()) if a != dec.arm
        },
    }
    if dec.degraded:
        entry["degraded"] = True
    if dec.sampled:
        entry["sampled"] = True
    if error is not None:
        entry["error"] = type(error).__name__
    with _lock:
        _ledger.append(entry)
        _entries_seen += 1
    attrs = {"route_arm": dec.arm, "route_obs_s": entry["observed_s"],
             "route_mode": dec.mode}
    if pred is not None:
        attrs["route_pred_s"] = entry["predicted_s"]
    telemetry.annotate(**attrs)


def last_entry() -> Optional[Dict[str, Any]]:
    """The most recent ledger entry (a copy), or None — the cheap
    accessor for harnesses that attribute per-call decisions without
    serializing a whole snapshot."""
    with _lock:
        return dict(_ledger[-1]) if _ledger else None


def snapshot_routing() -> Dict[str, Any]:
    """The ``routing`` section of ``telemetry.snapshot()``: ledger ring,
    model export, knob state. Empty dict when nothing ever routed, so
    snapshots stay shape-compatible with pre-router consumers."""
    with _lock:
        ledger = list(_ledger)
        seen = _entries_seen
    model = costmodel.snapshot()
    if not ledger and not model.get("entries"):
        return {}
    return {
        "autotune": costmodel.autotune_enabled(),
        "explore_rate": costmodel.explore_rate(),
        "profile_path": costmodel.profile_path(),
        "ledger": ledger,
        "ledger_dropped": seen - len(ledger),
        "model": model,
    }


def reset() -> None:
    """Clear the ledger and the in-memory model (test isolation; called
    from ``telemetry.reset()``)."""
    global _entries_seen
    with _lock:
        _ledger.clear()
        _entries_seen = 0
    costmodel.reset()


# ---------------------------------------------------------------------------
# CLI renderers (telemetry route-report / what-if)
# ---------------------------------------------------------------------------


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v * 1e3:.3f}ms"


def _routing_of(data: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    r = data.get("routing")
    return r if isinstance(r, dict) else None


def render_route_report(data: Dict[str, Any]) -> str:
    """Human-readable routing story of a snapshot: knob state, chosen-
    arm distribution per (schema, op, band), prediction calibration and
    the learned per-arm costs."""
    r = _routing_of(data)
    out: List[str] = []
    if not r:
        return ("no routing section in this snapshot (no calls routed, "
                "or it predates the router)\n")
    out.append("== routing ==")
    out.append(
        f"autotune={'on' if r.get('autotune') else 'off'} "
        f"explore_rate={r.get('explore_rate')} "
        f"profile={r.get('profile_path') or '(persistence off)'}")
    ledger = r.get("ledger") or []
    dropped = r.get("ledger_dropped") or 0
    out.append(f"ledger: {len(ledger)} entr{'y' if len(ledger) == 1 else 'ies'}"
               + (f" (+{dropped} aged out)" if dropped else ""))
    # chosen-arm distribution + calibration per feature
    by_feat: Dict[tuple, List[dict]] = {}
    for e in ledger:
        by_feat.setdefault(
            (e.get("schema"), e.get("op"), e.get("band")), []).append(e)
    for (schema, op, band), es in sorted(by_feat.items(),
                                         key=lambda kv: str(kv[0])):
        out.append("")
        out.append(f"{schema} {op} rows~{costmodel.band_label(band or 0)} "
                   f"({len(es)} call(s))")
        arms: Dict[str, List[dict]] = {}
        for e in es:
            arms.setdefault(e.get("arm", "?"), []).append(e)
        for arm, aes in sorted(arms.items()):
            obs = [e["observed_s"] for e in aes
                   if e.get("observed_s") is not None]
            preds = [(e["predicted_s"], e["observed_s"]) for e in aes
                     if e.get("predicted_s") and e.get("observed_s")]
            med = sorted(obs)[len(obs) // 2] if obs else None
            modes = sorted({e.get("mode", "?") for e in aes})
            line = (f"  {arm:<28} {len(aes):>4} call(s)  "
                    f"median {_fmt_s(med):>10}  mode={','.join(modes)}")
            if preds:
                ratio = sum(o / p for p, o in preds if p) / len(preds)
                line += f"  obs/pred={ratio:.2f}"
            out.append(line)
        errs = sum(1 for e in es if e.get("error"))
        if errs:
            out.append(f"  errors: {errs}")
    model = (r.get("model") or {}).get("entries") or []
    if model:
        out += ["", "== learned model (s/row) =="]
        for e in model:
            out.append(
                f"  {e.get('schema')} {e.get('op')} "
                f"rows~{costmodel.band_label(e.get('band') or 0):<16} "
                f"{e.get('arm'):<28} n={e.get('n'):>7} "
                f"{(e.get('s_per_row') or 0) * 1e9:>10.1f} ns/row")
    pen = (r.get("model") or {}).get("device_penalties_s") or {}
    if pen:
        out += ["", "storm penalties (device arms withheld):"]
        out += [f"  {k}: {v:.1f}s remaining" for k, v in sorted(pen.items())]
    apen = (r.get("model") or {}).get("arm_penalties") or {}
    if apen:
        out += ["", "drift penalties (predictions inflated):"]
        out += [
            f"  {k}: x{v.get('factor', 0):.2f} for "
            f"{v.get('remaining_s', 0):.1f}s"
            for k, v in sorted(apen.items()) if isinstance(v, dict)
        ]
    return "\n".join(out) + "\n"


def render_what_if(data: Dict[str, Any]) -> str:
    """Replay the ledger: for each entry, would a different arm
    (by the counterfactual predictions recorded AT DECISION TIME) have
    beaten the observed cost? Aggregates the estimated saving per
    (feature, chosen arm → better arm) switch."""
    r = _routing_of(data)
    if not r:
        return ("no routing section in this snapshot (no calls routed, "
                "or it predates the router)\n")
    ledger = r.get("ledger") or []
    out: List[str] = ["== what-if (ledger replay) =="]
    if not ledger:
        return out[0] + "\nledger is empty\n"
    switches: Dict[tuple, Dict[str, float]] = {}
    total_obs = 0.0
    total_save = 0.0
    for e in ledger:
        obs = e.get("observed_s")
        if obs is None:
            continue
        total_obs += obs
        cf = {a: p for a, p in (e.get("counterfactual_s") or {}).items()
              if p is not None}
        if not cf:
            continue
        best_arm = min(cf, key=lambda a: (cf[a], a))
        if cf[best_arm] >= obs:
            continue
        key = (e.get("schema"), e.get("op"), e.get("band"),
               e.get("arm"), best_arm)
        s = switches.setdefault(key, {"calls": 0.0, "saved_s": 0.0})
        s["calls"] += 1
        s["saved_s"] += obs - cf[best_arm]
        total_save += obs - cf[best_arm]
    if not switches:
        out.append(f"{len(ledger)} call(s), "
                   f"{total_obs * 1e3:.3f} ms observed — no arm switch "
                   "was predicted to win; the router's choices stand")
        return "\n".join(out) + "\n"
    out.append(f"{len(ledger)} call(s), {total_obs * 1e3:.3f} ms observed; "
               f"estimated {total_save * 1e3:.3f} ms "
               f"({total_save / total_obs * 100:.1f}%) left on the table:")
    rows = sorted(switches.items(), key=lambda kv: -kv[1]["saved_s"])
    for (schema, op, band, arm, better), s in rows:
        out.append(
            f"  {schema} {op} rows~{costmodel.band_label(band or 0)}: "
            f"{arm} -> {better}  {s['calls']:.0f} call(s), "
            f"est. {s['saved_s'] * 1e3:.3f} ms saved")
    out.append("(estimates use the model AS OF each decision; rerun with "
               "the warm profile to act on them)")
    return "\n".join(out) + "\n"


# the memory probe's estimates: a ledger entry is a small dict of scalars
# (about 400 B with its overhead), a cost-model row a short list of
# floats under a 4-tuple key (about 250 B)
_LEDGER_ENTRY_EST_BYTES = 400
_MODEL_ROW_EST_BYTES = 250


def _probe():
    with _lock:
        n_ledger = len(_ledger)
    n_model = len(costmodel._stats) + len(costmodel._loaded)
    return {
        "bytes": float(n_ledger * _LEDGER_ENTRY_EST_BYTES
                       + n_model * _MODEL_ROW_EST_BYTES),
        "items": float(n_ledger + n_model),
    }


memacct.register_probe("routing", _probe)
