"""Declarative SLOs with multi-window burn-rate evaluation (copy of
``pyruhvro_tpu/runtime/slo.py``).

``PYRUHVRO_TPU_SLO_FILE`` names a JSON document of objectives::

    {
      "version": 1,
      "objectives": [
        {
          "name": "decode-p-fast",
          "op": "decode",              // "decode" | "encode" | "*"
          "schema": "*",               // schema fingerprint or "*"
          "threshold_s": 0.050,        // a call is GOOD iff faster
          "target": 0.99,              // fraction of calls that must be good
          "error_target": 0.001,       // optional: max errored-call ratio
          "windows_s": [60, 600],      // multi-window burn evaluation
          "burn_threshold": 2.0,       // breach when EVERY window burns >= this
          "min_calls": 10,             // no verdict below this sample size
          "alert_command": "..."       // optional shell hook, fired once per breach
        }
      ]
    }

Every finished root span feeds :func:`record_root` (wired in
``telemetry.root_span.__exit__``, with the deep sampler's correction;
about a dict lookup when no SLO file is configured). Per objective,
calls land in coarse time buckets; the **burn rate** of a window is
``bad_fraction / (1 - target)``. A breach requires EVERY configured
window above ``burn_threshold`` (the short window proves it is happening
*now*, the long window proves it is not a blip).

On a breach transition: ``slo.breach`` counts, the flight recorder
auto-dumps (``PYRUHVRO_TPU_FLIGHT_DIR``), the objective's
``alert_command`` (if any) runs detached with
``PYRUHVRO_SLO_NAME``/``PYRUHVRO_SLO_BURN`` in its environment, through
the ``slo_alert`` fault seam (a failure counts ``slo.alert_error`` and
the call goes on). :func:`breached` lists the breached objectives, for
the obs server's ``/healthz`` (:mod:`.obs_server`). Recovery (shortest
window back under threshold) clears the bit and counts
``slo.recovered``. A breach publishes an ``slo.breach`` incident event
and a recovery an ``slo.recovered`` event on :mod:`.timeline`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import knobs, metrics

__all__ = [
    "active",
    "reload",
    "record_root",
    "record",
    "breached",
    "snapshot_slo",
    "render_slo_report",
    "reset",
]

_lock = threading.Lock()
_conf_key: Optional[str] = None  # guarded-by: _lock (loaded-config key)
_objectives: List["_Objective"] = []  # guarded-by: _lock
_load_error: Optional[str] = None  # guarded-by: _lock
# ingest-side evaluation throttle: burn windows are seconds long, so
# evaluating every objective's full window stats on EVERY call would
# put an O(windows x buckets) scan under the lock in the hot path for
# verdicts that cannot change faster than a bucket fills. Read paths
# (breached()/snapshot_slo) always evaluate — a scrape is rare.
_EVAL_INTERVAL_S = 0.25
_last_eval = 0.0  # guarded-by: _lock


def _as_float(v, default=None):
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


class _Objective:
    """One objective + its sliding time-bucketed call accounting."""

    __slots__ = ("name", "op", "schema", "threshold_s", "target",
                 "error_target", "windows_s", "burn_threshold",
                 "min_calls", "alert_command", "_buckets", "_bucket_w",
                 "breached", "breaches", "total", "bad", "errors")

    def __init__(self, d: Dict[str, Any], idx: int):
        self.name = str(d.get("name") or f"objective-{idx}")
        self.op = str(d.get("op") or "*")
        self.schema = str(d.get("schema") or "*")
        self.threshold_s = _as_float(d.get("threshold_s"))
        self.target = min(0.999999, max(0.0, _as_float(d.get("target"), 0.99)))
        self.error_target = _as_float(d.get("error_target"))
        ws = d.get("windows_s") or [60.0, 600.0]
        self.windows_s = sorted(
            w for w in (_as_float(x) for x in ws) if w and w > 0
        ) or [60.0, 600.0]
        self.burn_threshold = max(
            0.0, _as_float(d.get("burn_threshold"), 2.0))
        self.min_calls = max(1, int(_as_float(d.get("min_calls"), 10)))
        self.alert_command = d.get("alert_command") or None
        # ring of [bucket_start_monotonic, total, bad, errors]; bucket
        # width scales with the shortest window so memory stays bounded
        # (~120 buckets per longest window) at any call rate
        self._bucket_w = max(0.25, self.windows_s[0] / 30.0)
        self._buckets: deque = deque()
        self.breached = False
        self.breaches = 0
        self.total = 0
        self.bad = 0
        self.errors = 0

    def matches(self, op: str, schema: Optional[str]) -> bool:
        if self.op != "*" and self.op != op:
            return False
        if self.schema != "*" and self.schema != (schema or ""):
            return False
        return True

    # -- accounting (callers hold the module lock) -------------------------

    def _advance(self, now: float) -> None:
        w = self._bucket_w
        if not self._buckets or now - self._buckets[-1][0] >= w:
            self._buckets.append([now - (now % w), 0, 0, 0])
        horizon = now - self.windows_s[-1] - w
        while self._buckets and self._buckets[0][0] < horizon:
            self._buckets.popleft()

    def add(self, now: float, dur_s: float, error: bool) -> None:
        self._advance(now)
        b = self._buckets[-1]
        bad = error or (self.threshold_s is not None
                        and dur_s > self.threshold_s)
        b[1] += 1
        self.total += 1
        if bad:
            b[2] += 1
            self.bad += 1
        if error:
            b[3] += 1
            self.errors += 1

    def window_stats(self, now: float) -> List[Dict[str, Any]]:
        out = []
        lat_budget = 1.0 - self.target
        for w in self.windows_s:
            total = bad = errs = 0
            lo = now - w
            for ts, t, b, e in self._buckets:
                if ts + self._bucket_w >= lo:
                    total += t
                    bad += b
                    errs += e
            bad_frac = (bad / total) if total else 0.0
            err_frac = (errs / total) if total else 0.0
            burn = (bad_frac / lat_budget) if lat_budget > 0 else 0.0
            if self.error_target and self.error_target > 0:
                burn = max(burn, err_frac / self.error_target)
            out.append({
                "window_s": w,
                "total": total,
                "bad": bad,
                "errors": errs,
                "bad_frac": round(bad_frac, 6),
                "burn_rate": round(burn, 4),
            })
        return out

    def evaluate(self, now: float) -> Optional[bool]:
        """-> transition: True = newly breached, False = newly
        recovered, None = no change."""
        stats = self.window_stats(now)
        hot = all(
            s["total"] >= self.min_calls
            and s["burn_rate"] >= self.burn_threshold
            for s in stats
        )
        if hot and not self.breached:
            self.breached = True
            self.breaches += 1
            return True
        if self.breached and stats and (
            stats[0]["burn_rate"] < self.burn_threshold
        ):
            self.breached = False
            return False
        return None

    def export(self, now: float) -> Dict[str, Any]:
        return {
            "name": self.name,
            "op": self.op,
            "schema": self.schema,
            "threshold_s": self.threshold_s,
            "target": self.target,
            "error_target": self.error_target,
            "windows_s": list(self.windows_s),
            "burn_threshold": self.burn_threshold,
            "min_calls": self.min_calls,
            "total": self.total,
            "bad": self.bad,
            "errors": self.errors,
            "breached": self.breached,
            "breaches": self.breaches,
            "windows": self.window_stats(now),
        }


def _path() -> str:
    return knobs.get_raw("PYRUHVRO_TPU_SLO_FILE")


def _ensure_config() -> None:
    """(Re)load objectives when the env var changed since the last look.
    A missing/corrupt file is counted (``slo.config_error``) and leaves
    the engine inactive — an operator mistake must never fail calls."""
    global _conf_key, _objectives, _load_error
    path = _path()
    if path == _conf_key:
        return
    with _lock:
        if path == _conf_key:
            return
        _objectives = []
        _load_error = None
        _conf_key = path
        if not path:
            return
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError("SLO file must hold a JSON object")
            objs = doc.get("objectives")
            if not isinstance(objs, list):
                raise ValueError("SLO file needs an 'objectives' list")
            _objectives = [_Objective(d, i) for i, d in enumerate(objs)
                           if isinstance(d, dict)]
        except (OSError, ValueError) as e:
            _load_error = str(e)
            metrics.inc("slo.config_error")
            return
    metrics.inc("slo.config_loaded")


def reload() -> int:
    """Force a config re-read (tests; operators after editing the SLO
    file in place). Returns the number of objectives loaded."""
    global _conf_key
    with _lock:
        _conf_key = None
    _ensure_config()
    return len(_objectives)


def active() -> bool:
    _ensure_config()
    return bool(_objectives)


_ROOT_OPS = {
    "api.deserialize_array": "decode",
    "api.deserialize_array_threaded": "decode",
    "api.serialize_record_batch": "encode",
    # the serving plane's end-to-end latency, fed by serving._resolve
    "serve.request": "serve",
}


def record_root(name: str, schema: Optional[str], dur_s: float,
                error: bool) -> None:
    """Feed one finished API root span (called from
    ``telemetry.root_span.__exit__``; must never raise)."""
    try:
        _ensure_config()
        if not _objectives:
            return
        op = _ROOT_OPS.get(name)
        if op is None:
            return
        record(op, schema, dur_s, error)
    except Exception:
        metrics.inc("slo.record_error")


def record(op: str, schema: Optional[str], dur_s: float,
           error: bool = False) -> None:
    """Fold one call into every matching objective and evaluate the
    burn windows. Breach transitions fire the side effects (counters,
    flight dump, alert command) OUTSIDE the lock."""
    _ensure_config()
    if not _objectives:
        return
    global _last_eval
    now = time.monotonic()
    matched = False
    fired: List[tuple] = []
    recovered = 0
    with _lock:
        for o in _objectives:
            if not o.matches(op, schema):
                continue
            matched = True
            o.add(now, dur_s, error)
        if now - _last_eval >= _EVAL_INTERVAL_S:
            _last_eval = now
            fired, recovered = _evaluate_locked(now)
    if matched:
        metrics.inc("slo.calls")
        if error:
            metrics.inc("slo.errors")
    _fire_transitions(fired, recovered)


def _evaluate_locked(now: float) -> tuple:
    """Evaluate every objective's burn windows against ``now``; callers
    hold ``_lock``. Returns (fired, recovered) where ``fired`` pairs
    each newly-breached objective with its window stats captured HERE,
    under the lock — the side effects run unlocked, and iterating the
    live bucket deque there would race a concurrent record()."""
    fired: List[tuple] = []
    recovered = 0
    for o in _objectives:
        tr = o.evaluate(now)
        if tr is True:
            fired.append((o, o.window_stats(now)))
        elif tr is False:
            recovered += 1
    return fired, recovered


def _sweep() -> None:
    """Time-based re-evaluation with NO new events — called from the
    read paths (:func:`breached` / :func:`snapshot_slo`). Without it a
    breached objective would latch /healthz at 503 forever once the
    503 itself drains the matching traffic (readiness-probe death
    spiral): events must age OUT of the burn windows even when nothing
    ages in."""
    now = time.monotonic()
    with _lock:
        if not _objectives:
            return
        fired, recovered = _evaluate_locked(now)
    _fire_transitions(fired, recovered)


def _fire_transitions(fired: List[tuple], recovered: int) -> None:
    if recovered:
        metrics.inc("slo.recovered", float(recovered))
        from . import timeline

        timeline.event("slo.recovered",
                       attrs={"objectives": recovered})
    for o, stats in fired:
        _on_breach(o, stats)


def _on_breach(o: _Objective, stats: List[Dict[str, Any]]) -> None:
    # no metrics.mark here: a health bit comes from the live
    # breached() list (which auto-recovers by time decay)
    metrics.inc("slo.breach")
    metrics.inc(f"slo.breach.{o.name}")
    from . import telemetry, timeline

    timeline.event("slo.breach", severity="incident",
                   attrs={"objective": o.name,
                          "burn_rate": (stats[0].get("burn_rate")
                                        if stats else None)})
    telemetry.annotate(slo_breach=o.name)
    telemetry._flight_autodump("slo_breach")
    if o.alert_command:
        _run_alert(o, stats)


def _run_alert(o: _Objective, stats: List[Dict[str, Any]]) -> None:
    """Fire the objective's alert hook detached; a broken hook must
    never fail (or slow) the call that tripped the breach."""
    import subprocess

    env = dict(os.environ)
    env["PYRUHVRO_SLO_NAME"] = o.name
    env["PYRUHVRO_SLO_BURN"] = str(
        stats[0]["burn_rate"] if stats else "")
    try:
        from . import faults

        faults.fire("slo_alert")  # chaos seam -> the counted-error path
        subprocess.Popen(
            o.alert_command, shell=True, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True,
        )
        metrics.inc("slo.alert_fired")
    except Exception:
        metrics.inc("slo.alert_error")


def breached() -> List[str]:
    """Names of currently-breached objectives (the /healthz bit).
    Re-evaluates time decay first, so a breach clears on its own once
    the windows empty — even when the 503 itself stopped the traffic
    that would otherwise have driven re-evaluation."""
    _ensure_config()
    _sweep()
    with _lock:
        return [o.name for o in _objectives if o.breached]


def snapshot_slo() -> Dict[str, Any]:
    """The ``slo`` section of ``telemetry.snapshot()`` — empty dict when
    no SLO file is configured, so snapshots stay shape-compatible."""
    _ensure_config()
    _sweep()
    now = time.monotonic()
    with _lock:
        if not _objectives and not _load_error:
            return {}
        out: Dict[str, Any] = {
            "file": _path(),
            "objectives": [o.export(now) for o in _objectives],
            "breached": [o.name for o in _objectives if o.breached],
        }
        if _load_error:
            out["config_error"] = _load_error
        return out


def render_slo_report(data: Dict[str, Any]) -> str:
    """CLI renderer (``python -m pyruhvro_tpu_torch.telemetry
    slo-report``):
    the SLO story of a saved snapshot, degrading cleanly on snapshots
    without an ``slo`` section."""
    s = data.get("slo")
    if not isinstance(s, dict) or not s:
        return ("no slo section in this snapshot (no SLO file was "
                "configured, or it predates the SLO engine)\n")
    out: List[str] = ["== slo =="]
    out.append(f"file: {s.get('file') or '(unset)'}")
    if s.get("config_error"):
        out.append(f"CONFIG ERROR: {s['config_error']}")
    breached_names = s.get("breached") or []
    out.append("breached: " + (", ".join(breached_names) or "none"))
    for o in s.get("objectives") or []:
        out.append("")
        head = (f"{o.get('name')}  [{o.get('op')}/{o.get('schema')}] "
                f"target={o.get('target')}")
        if o.get("threshold_s") is not None:
            head += f" threshold={o['threshold_s'] * 1e3:.1f}ms"
        if o.get("error_target"):
            head += f" error_target={o['error_target']}"
        out.append(head)
        out.append(
            f"  calls={o.get('total', 0)} bad={o.get('bad', 0)} "
            f"errors={o.get('errors', 0)} breaches={o.get('breaches', 0)}"
            f"{'  ** BREACHED **' if o.get('breached') else ''}")
        for w in o.get("windows") or []:
            out.append(
                f"  window {w.get('window_s'):>8}s: "
                f"{w.get('total', 0):>7} call(s), "
                f"bad_frac={w.get('bad_frac', 0):.4f}, "
                f"burn={w.get('burn_rate', 0):.2f} "
                f"(threshold {o.get('burn_threshold')})")
    counters = data.get("counters") or {}
    slo_counts = {k: v for k, v in counters.items()
                  if k.startswith("slo.")}
    if slo_counts:
        out += ["", "counters:"]
        out.extend(f"  {k:<28} {v:>10.0f}"
                   for k, v in sorted(slo_counts.items()))
    return "\n".join(out) + "\n"


def reset() -> None:
    """Drop loaded objectives AND their accounting (test isolation;
    called from ``telemetry.reset()``). The next record/active() call
    re-reads the env."""
    global _conf_key, _objectives, _load_error, _last_eval
    with _lock:
        _conf_key = None
        _objectives = []
        _load_error = None
        _last_eval = 0.0
