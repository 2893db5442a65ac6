"""The differential audit: production shadow re-execution (copy of
``pyruhvro_tpu/runtime/audit.py``, whole).

It watches the running system for silent wrong answers. About one
public API call in ``ratio / budget`` (``PYRUHVRO_TPU_AUDIT_BUDGET``,
default 0.005 of wall time, <= 0 off; ``PYRUHVRO_TPU_NO_AUDIT=1`` off;
``PYRUHVRO_TPU_AUDIT_TIERS`` a comma list of the tiers it shadows) is
re-executed through an independent tier: a decode re-decodes through
the pure-Python oracle (:mod:`..fallback`), an encode round-trips
``decode(encode(x)) == x`` through it. The two results are compared by
the canonical per-column digests of :mod:`.coldigest`. On the card's
tier that holds K1/K2's and K3's output against the oracle.

A mismatch is an incident:

* ``audit.mismatch.<column-path>`` and ``audit.mismatches`` count, and
  the ``audit_mismatch`` mark sets the ``/healthz`` bit
  (:mod:`.obs_server`) that outranks every other;
* an ``audit.mismatch`` incident event on :mod:`.timeline`;
* an :class:`AuditMismatch` record (schema fingerprint, arm, column,
  the first row that differs, found by re-auditing halves, both
  digests) in a ring, published on the quarantine channel, and a
  flight-recorder auto-dump;
* :func:`.costmodel.penalize_arm` on the arm and, for a ``device/``
  arm, :func:`.costmodel.penalize` on the schema's device tier. These
  reprice the arm for the router's ``backend="auto"`` under autotune;
  ``backend="device"`` still runs on the card (``ROADMAP.md`` (c) 9).

Coverage is observable: per-(schema, arm) call and row tallies, decayed
by age, feed the ``audit.coverage`` gauge, the ``audit`` section of
``telemetry.snapshot()`` (left out while empty), ``telemetry
audit-report`` and ``/audit``. Per-(schema, input digest) result
digests are exported (:func:`export_digests`).

The shadow never hurts the caller: it runs after the result is complete
and ``router.observe`` has fed the cost model; its wall seconds are
subtracted from the sampler's EWMAs and the SLO feed
(:func:`tls_shadow_seconds` / :func:`consume_shadow_seconds`); its
counter deltas are recorded and undone, so shadow work never reads as
traffic; and a shadow that fails (fault site ``audit_shadow``; the
call's deadline still applies inside it) counts ``audit.shadow_error``
and goes on. It never changes the caller's result or its tier.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import pyarrow as pa

from . import coldigest, knobs, metrics

__all__ = [
    "AuditMismatch",
    "enabled",
    "set_enabled",
    "budget",
    "force_next",
    "maybe_audit",
    "tls_shadow_seconds",
    "consume_shadow_seconds",
    "mismatches",
    "export_digests",
    "snapshot_audit",
    "render_audit_report",
    "reset",
]


class AuditMismatch(NamedTuple):
    """One detected divergence between a primary result and its shadow
    re-execution — the evidence record of a silent wrong answer."""

    schema: str           # schema fingerprint
    op: str               # "decode" | "encode"
    arm: str              # the routing arm that produced the primary
    column: str           # column path ("#rows" for a row-count split)
    row_index: int        # first divergent row (binary-search re-audit)
    primary_digest: str
    shadow_digest: str
    trace_id: Optional[str] = None


_ASSUMED_RATIO = 10.0   # shadow/primary cost prior until measured
_RATIO_ALPHA = 0.3
_PERIOD_MIN = 1
_PERIOD_MAX = 1_000_000
_COVERAGE_HALF_LIFE_S = 600.0
_PENALTY_WINDOW_S = 300.0
_PENALTY_FACTOR = 1e6   # effectively removes the arm for the window
_MISMATCH_RING = 64
_EXPORTS_PER_SCHEMA = 8

_lock = threading.Lock()
_tls = threading.local()
# (schema, arm) -> [calls, rows, audited_calls, audited_rows, last_ts]
# (age-decayed tallies)
_coverage: Dict[tuple, List[float]] = {}  # guarded-by: _lock
_calls_since = 0  # calls since the last audit slot; guarded-by: _lock
_pending = False  # force_next() latch; guarded-by: _lock
_period = 0  # 0 = recompute from budget; guarded-by: _lock
_ratio = _ASSUMED_RATIO  # shadow/primary cost EWMA; guarded-by: _lock
_calls = 0  # lifetime calls seen while enabled; guarded-by: _lock
_audited = 0  # guarded-by: _lock
_shadow_errors = 0  # guarded-by: _lock
_mismatch_ring: deque = deque(maxlen=_MISMATCH_RING)  # guarded-by: _lock
# schema -> deque of {"op", "input", "chunks", "result"}
_exports: Dict[str, deque] = {}  # guarded-by: _lock


def budget() -> float:
    """The audit overhead budget as a wall-time fraction (<= 0 off)."""
    return knobs.get_float("PYRUHVRO_TPU_AUDIT_BUDGET")


# lock-free-ok(single GIL-atomic store; any thread may flip it and
# readers tolerate staleness — one extra/missing shadow either side of
# the flip is harmless)
_forced: Optional[bool] = None


def set_enabled(flag: Optional[bool]) -> None:
    """Force the audit plane on/off in-process regardless of the env
    knobs; ``None`` restores knob-driven behavior (mirrors
    ``sampling.set_enabled``; the reference's serving plane sheds the
    audit through it, ``ROADMAP.md`` (a) 8.9)."""
    global _forced
    _forced = flag


def enabled() -> bool:
    if _forced is not None:
        return _forced
    return (budget() > 0
            and not knobs.get_bool("PYRUHVRO_TPU_NO_AUDIT"))


def _tier_enabled(tier: str) -> bool:
    raw = knobs.get_raw("PYRUHVRO_TPU_AUDIT_TIERS") or ""
    if not raw.strip():
        return True
    return tier in {t.strip() for t in raw.split(",") if t.strip()}


def force_next() -> None:
    """Arm the next eligible call to audit regardless of the period —
    the test/ops hook (mirrors ``sampling``'s pending-resample latch)."""
    global _pending
    with _lock:
        _pending = True


def tls_shadow_seconds() -> float:
    """Shadow wall seconds accumulated on THIS thread's current call —
    non-destructive peek for ``sampling.call_scope`` (which must keep
    shadow time out of its per-feature EWMAs)."""
    return float(getattr(_tls, "shadow_s", 0.0))


def consume_shadow_seconds() -> float:
    """Destructive read for the root span's SLO feed: the caller's
    latency objective judges the call, not the audit plane's tax."""
    v = float(getattr(_tls, "shadow_s", 0.0))
    _tls.shadow_s = 0.0
    return v


def _period_locked() -> int:
    b = budget()
    if b <= 0:
        return _PERIOD_MAX
    return int(min(_PERIOD_MAX, max(_PERIOD_MIN, round(_ratio / b))))


def _decay(st: List[float], now: float) -> None:
    dt = max(0.0, now - st[4])
    if dt > 0:
        f = 0.5 ** (dt / _COVERAGE_HALF_LIFE_S)
        st[0] *= f
        st[1] *= f
        st[2] *= f
        st[3] *= f
    st[4] = now


def _coverage_locked() -> float:
    rows = sum(st[1] for st in _coverage.values())
    aud = sum(st[3] for st in _coverage.values())
    return aud / rows if rows > 0 else 0.0


def maybe_audit(dec, op: str, *,
                expected: Callable[[], List[pa.RecordBatch]],
                shadow: Callable[[], List[pa.RecordBatch]],
                input_fn: Optional[Callable[[], str]] = None,
                result_fn: Optional[Callable[[], str]] = None,
                chunks: int = 1,
                skip_reason: Optional[str] = None) -> None:
    """The per-call seam (:mod:`..api` calls it right after
    ``router.observe`` so the cost model never sees shadow seconds).
    Tallies coverage, decides whether THIS call audits, and runs the
    shadow comparison when it does. Never raises; never changes the
    caller's result."""
    global _calls, _calls_since, _pending, _period
    if not enabled() or not _tier_enabled(dec.tier):
        return
    now = time.monotonic()
    take = False
    with _lock:
        key = (dec.schema, dec.arm)
        st = _coverage.get(key)
        if st is None:
            st = _coverage[key] = [0.0, 0.0, 0.0, 0.0, now]
        _decay(st, now)
        st[0] += 1.0
        st[1] += float(dec.rows)
        _calls += 1
        if skip_reason is None and not getattr(dec, "degraded", False):
            _calls_since += 1
            if _period <= 0:
                _period = _period_locked()
            if _pending or _calls_since >= _period:
                take = True
                _pending = False
                _calls_since = 0
    if not take:
        if skip_reason:
            # structurally incomparable call (tolerant encode that
            # quarantined rows, caller-typed batch): visible, not
            # silently shrinking coverage
            # metric-key: audit.skipped_<reason>
            metrics.inc("audit.skipped_" + skip_reason)
        return
    try:
        _run_shadow(dec, op, expected, shadow, input_fn, result_fn,
                    chunks, now)
    except Exception:
        # the audit plane is observability: a bug in it must never
        # fail a caller whose result is already computed
        global _shadow_errors
        metrics.inc("audit.shadow_error")
        with _lock:
            _shadow_errors += 1


def _run_shadow(dec, op, expected, shadow, input_fn, result_fn,
                chunks, now) -> None:
    global _ratio, _period, _audited, _shadow_errors
    from . import faults, telemetry, traceprop

    t0 = time.perf_counter()
    primary_s = max(t0 - getattr(dec, "_t0", t0), 1e-9)
    err: Optional[BaseException] = None
    mismatch: Optional[AuditMismatch] = None
    in_digest = res_digest = None
    try:
        # the chaos seam sits OUTSIDE the delta recorder so an injected
        # fault's counter/annotation survive the shadow-delta undo
        faults.fire("audit_shadow")
    except Exception as e:
        err = e
    if err is None:
        with metrics.record_deltas() as delta:
            try:
                with telemetry.phase("audit.shadow_s", rows=dec.rows):
                    act = shadow()
                exp = expected()
                exp_d = coldigest.column_digests(exp)
                act_d = coldigest.column_digests(act)
                in_digest = input_fn() if input_fn else None
                res_digest = (result_fn() if result_fn
                              else _fold_digests(exp_d))
                mismatch = _compare(dec, op, exp, act, exp_d, act_d)
            except Exception as e:
                err = e
        if delta:
            # shadow work must never read as traffic: undo its counter
            # increments (vm.op.*, fallback rows, ...) — the negative
            # merge also folds out of any enclosing worker recorder
            metrics.merge({k: -v for k, v in delta.items()})
    dt = time.perf_counter() - t0
    _tls.shadow_s = getattr(_tls, "shadow_s", 0.0) + dt
    with _lock:
        r = min(max(dt / primary_s, 0.01), 1e4)
        _ratio += _RATIO_ALPHA * (r - _ratio)
        _period = _period_locked()
        if err is None:
            _audited += 1
            st = _coverage.get((dec.schema, dec.arm))
            if st is not None:
                st[2] += 1.0
                st[3] += float(dec.rows)
            if in_digest is not None:
                ring = _exports.setdefault(
                    dec.schema, deque(maxlen=_EXPORTS_PER_SCHEMA))
                ring.append({"op": op, "input": in_digest,
                             "chunks": int(chunks),
                             "result": res_digest})
        else:
            _shadow_errors += 1
        cov = _coverage_locked()
    if err is not None:
        metrics.inc("audit.shadow_error")
        telemetry.annotate(audit_shadow_error=type(err).__name__)
        return
    metrics.inc("audit.audited")
    metrics.inc("audit.audited_rows", float(dec.rows))
    metrics.set_gauge("audit.coverage", cov)
    if mismatch is not None:
        _incident(mismatch._replace(
            trace_id=getattr(traceprop.current(), "trace_id", None)))


def _fold_digests(col_digests: Dict[str, str]) -> str:
    h = coldigest._new_hash()
    for name, d in col_digests.items():
        h.update(name.encode() + b"\x00" + d.encode())
    return h.hexdigest()


def _total_rows(batches: List[pa.RecordBatch]) -> int:
    return sum(b.num_rows for b in batches)


def _concat_column(batches: List[pa.RecordBatch], idx: int) -> pa.Array:
    chunks = [b.column(idx) for b in batches if b.num_rows]
    if not chunks:
        return batches[0].column(idx).slice(0, 0)
    if len(chunks) == 1:
        return chunks[0]
    return pa.concat_arrays([pa.concat_arrays([c]) if c.offset else c
                             for c in chunks])


def _bisect_row(a: pa.Array, b: pa.Array) -> int:
    """First divergent row by binary-search re-audit: the digest of a
    window is a function of its logical content, so whenever the whole
    differs one of its halves must — O(n log n) hashing, paid only on
    the (hopefully never) mismatch path."""
    lo, hi = 0, min(len(a), len(b))
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if (coldigest.array_digest(a.slice(lo, mid - lo))
                != coldigest.array_digest(b.slice(lo, mid - lo))):
            hi = mid
        else:
            lo = mid
    return lo


def _compare(dec, op, exp, act, exp_d, act_d) -> Optional[AuditMismatch]:
    exp = [b for b in exp]
    act = [b for b in act]
    n_exp, n_act = _total_rows(exp), _total_rows(act)
    if n_exp != n_act:
        return AuditMismatch(dec.schema, op, dec.arm, "#rows",
                             min(n_exp, n_act), str(n_exp), str(n_act))
    for idx, name in enumerate(exp[0].schema.names if exp else ()):
        if exp_d.get(name) == act_d.get(name):
            continue
        row = _bisect_row(_concat_column(exp, idx),
                          _concat_column(act, idx))
        return AuditMismatch(dec.schema, op, dec.arm, name, row,
                             exp_d.get(name, ""), act_d.get(name, ""))
    return None


def _incident(m: AuditMismatch) -> None:
    """Fire the full incident surface for one confirmed mismatch (the
    :mod:`.drift` idiom, but harder: a wrong arm is withheld outright,
    not merely repriced)."""
    from . import costmodel, quarantine, telemetry

    # metric-key: audit.mismatch.<column-path>
    metrics.inc("audit.mismatch." + m.column)
    metrics.inc("audit.mismatches")
    metrics.mark("audit_mismatch")  # the live /healthz bit
    from . import timeline

    timeline.event("audit.mismatch", severity="incident",
                   attrs={"schema": m.schema, "arm": m.arm,
                          "column": m.column, "row": m.row_index},
                   trace_id=m.trace_id)
    with _lock:
        _mismatch_ring.append(m._asdict())
    telemetry.annotate(audit_mismatch=m.column, audit_arm=m.arm)
    quarantine.publish(
        [quarantine.QuarantinedRecord(m.row_index, None,
                                      "audit_mismatch", m.arm,
                                      m.trace_id)],
        "audit", op="audit")
    telemetry._flight_autodump("audit")
    costmodel.penalize_arm(m.schema, m.arm, _PENALTY_WINDOW_S,
                           factor=_PENALTY_FACTOR)
    if m.arm.startswith("device/"):
        # a device arm producing wrong bytes is withheld wholesale,
        # like a recompile storm — but for the longer audit window
        costmodel.penalize(m.schema, _PENALTY_WINDOW_S)


def mismatches() -> List[Dict[str, Any]]:
    """The ring of structured mismatch records, oldest first."""
    with _lock:
        return [dict(m) for m in _mismatch_ring]


def export_digests() -> Dict[str, List[Dict[str, Any]]]:
    """Per-schema (input-digest -> result-digest) observations for the
    fleet merge: replicas that disagree on ``result`` for the same
    (schema, op, input, chunks) have diverged."""
    with _lock:
        return {s: [dict(e) for e in ring]
                for s, ring in _exports.items() if ring}


def snapshot_audit() -> Dict[str, Any]:
    """The ``audit`` section of ``telemetry.snapshot()`` — empty dict
    until the plane has seen traffic (shape-compatible snapshots)."""
    now = time.monotonic()
    with _lock:
        if not _calls and not _audited:
            return {}
        per_arm = []
        for (schema, arm), st in sorted(_coverage.items()):
            _decay(st, now)
            per_arm.append({
                "schema": schema,
                "arm": arm,
                "calls": round(st[0], 3),
                "rows": round(st[1], 3),
                "audited_calls": round(st[2], 3),
                "audited_rows": round(st[3], 3),
                "coverage": round(st[3] / st[1], 6) if st[1] > 0 else 0.0,
            })
        cov = _coverage_locked()
        out = {
            "enabled": enabled(),
            "budget": budget(),
            "period": _period or _period_locked(),
            "cost_ratio": round(_ratio, 4),
            "calls": _calls,
            "audited": _audited,
            "shadow_errors": _shadow_errors,
            "mismatches": len(_mismatch_ring),
            "coverage": round(cov, 6),
            "per_arm": per_arm,
            "mismatch_records": [dict(m) for m in _mismatch_ring],
            "digests": {s: [dict(e) for e in ring]
                        for s, ring in _exports.items() if ring},
        }
    metrics.set_gauge("audit.coverage", cov)
    return out


def render_audit_report(data: Dict[str, Any]) -> str:
    """Text report over a snapshot's ``audit`` section (the
    ``telemetry audit-report`` subcommand)."""
    a = data.get("audit") or {}
    if not a:
        return ("no audit section in this snapshot (audit plane "
                "disabled, or the snapshot predates it)")
    lines = ["== differential audit =="]
    lines.append(
        f"budget {a.get('budget', 0):.4f}  period {a.get('period', '-')}"
        f"  cost_ratio {a.get('cost_ratio', '-')}"
        f"  enabled {a.get('enabled')}")
    lines.append(
        f"calls {a.get('calls', 0)}  audited {a.get('audited', 0)}"
        f"  shadow_errors {a.get('shadow_errors', 0)}"
        f"  mismatches {a.get('mismatches', 0)}"
        f"  coverage {a.get('coverage', 0.0):.4%}")
    per_arm = a.get("per_arm") or []
    if per_arm:
        lines.append("-- per (schema, arm) --")
        for e in per_arm:
            lines.append(
                f"  {e['schema'][:12]} {e['arm']:<22}"
                f" calls {e['calls']:>8.1f} rows {e['rows']:>10.1f}"
                f" audited {e['audited_calls']:>7.1f}"
                f" coverage {e['coverage']:.4%}")
    recs = a.get("mismatch_records") or []
    if recs:
        lines.append("-- mismatches (newest last) --")
        for m in recs:
            lines.append(
                f"  {m.get('schema', '')[:12]} {m.get('op')}"
                f" arm={m.get('arm')} column={m.get('column')}"
                f" row={m.get('row_index')}"
                f" primary={str(m.get('primary_digest'))[:16]}"
                f" shadow={str(m.get('shadow_digest'))[:16]}")
    else:
        lines.append("no mismatches observed")
    digs = a.get("digests") or {}
    if digs:
        n = sum(len(v) for v in digs.values())
        lines.append(f"{n} exported result digest(s) across "
                     f"{len(digs)} schema(s) (fleet divergence keys)")
    return "\n".join(lines)


def reset() -> None:
    """Clear all audit state (test isolation; cascaded from
    ``telemetry.reset()``)."""
    global _calls_since, _pending, _period, _ratio, _calls, _audited
    global _shadow_errors, _forced
    _forced = None
    with _lock:
        _coverage.clear()
        _exports.clear()
        _mismatch_ring.clear()
        _calls_since = 0
        _pending = False
        _period = 0
        _ratio = _ASSUMED_RATIO
        _calls = 0
        _audited = 0
        _shadow_errors = 0
    _tls.shadow_s = 0.0
