"""Online EWMA latency-drift detector per (schema, op, row band, arm)
(copy of ``pyruhvro_tpu/runtime/drift.py``).

The cost model tracks the *level* of seconds per row per arm; a slow
regression hides inside its capped Welford mean. This detector keeps two
EWMAs of seconds per row per (schema fingerprint, op, log2 row band,
arm), the cost model's feature key: a **fast** one (the recent regime)
over a **slow** one (the baseline). When fast exceeds slow by
``PYRUHVRO_TPU_DRIFT_RATIO`` (default 1.5x) for
``PYRUHVRO_TPU_DRIFT_SUSTAIN`` observations in a row (default 5), the
key has **drifted**:

* ``drift.detected`` counts (with the running ``drift.checks`` /
  ``drift.suspect``), and ``latency_drift`` is marked;
* the arm goes to :func:`.costmodel.penalize_arm` with the measured
  ratio as its cost factor (and, for a device arm, the schema to the
  hard :func:`.costmodel.penalize`), so the router's predictions for it
  carry the regression for a cool-down window.

After a detection the slow EWMA adopts the fast one and the detector
re-arms. Fed by ``router.observe`` on clean calls only. A detection
auto-dumps the flight recorder (``PYRUHVRO_TPU_FLIGHT_DIR``) and
publishes a ``drift.detected`` incident event on :mod:`.timeline`.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple

from . import knobs, metrics

__all__ = ["observe", "snapshot_drift", "reset"]

_FAST_ALPHA = 0.30
_SLOW_ALPHA = 0.03
_WARMUP = 8          # observations before verdicts are armed
_PENALTY_WINDOW_S = 60.0

_lock = threading.Lock()
# (schema, op, band, arm) -> [fast, slow, n, sustain, detections]
_state: Dict[Tuple[str, str, int, str], List[float]] = {}  # guarded-by: _lock


def _ratio() -> float:
    return max(1.01, knobs.get_float("PYRUHVRO_TPU_DRIFT_RATIO"))


def _sustain() -> int:
    return max(1, knobs.get_int("PYRUHVRO_TPU_DRIFT_SUSTAIN"))


def observe(schema: str, op: str, band: int, arm: str,
            s_per_row: float) -> None:
    """Fold one clean call's seconds-per-row into the detector; fires
    the drift side effects on a sustained regression."""
    if s_per_row <= 0:
        return
    detected = False
    factor = 1.0
    key = (schema, op, int(band), arm)
    with _lock:
        st = _state.get(key)
        if st is None:
            st = _state[key] = [s_per_row, s_per_row, 0.0,
                                0.0, 0.0]
        fast, slow, n, sustain, dets = st
        fast += _FAST_ALPHA * (s_per_row - fast)
        slow += _SLOW_ALPHA * (s_per_row - slow)
        n += 1.0
        if n >= _WARMUP and slow > 0 and fast / slow >= _ratio():
            sustain += 1.0
            if sustain >= _sustain():
                detected = True
                dets += 1.0
                factor = fast / slow  # the measured regression ratio
                slow = fast  # the new regime becomes the baseline
                sustain = 0.0
        else:
            sustain = 0.0
        st[0], st[1], st[2], st[3], st[4] = fast, slow, n, sustain, dets
    metrics.inc("drift.checks")
    if not detected:
        if sustain:
            metrics.inc("drift.suspect")
        return
    metrics.inc("drift.detected")
    metrics.mark("latency_drift")
    from . import costmodel, telemetry, timeline

    timeline.event("drift.detected", severity="incident",
                   attrs={"schema": schema, "arm": arm,
                          "factor": round(factor, 3)})
    telemetry.annotate(drift_arm=arm)
    telemetry._flight_autodump("drift")
    costmodel.penalize_arm(schema, arm, _PENALTY_WINDOW_S,
                           factor=factor)
    if arm.startswith("device/"):
        # a drifting device arm is treated like a recompile storm:
        # withhold the whole device tier for this schema's window
        costmodel.penalize(schema, _PENALTY_WINDOW_S)


def snapshot_drift() -> Dict[str, Any]:
    """The ``drift`` section of ``telemetry.snapshot()`` — empty dict
    until the detector has seen traffic."""
    with _lock:
        if not _state:
            return {}
        entries = [
            {
                "schema": k[0],
                "op": k[1],
                "band": k[2],
                "arm": k[3],
                "fast_s_per_row": st[0],
                "slow_s_per_row": st[1],
                "n": int(st[2]),
                "sustain": int(st[3]),
                "detections": int(st[4]),
                "ratio": round(st[0] / st[1], 4) if st[1] > 0 else None,
            }
            for k, st in sorted(_state.items())
        ]
    return {"ratio_threshold": _ratio(), "sustain_threshold": _sustain(),
            "entries": entries}


def reset() -> None:
    """Clear detector state (test isolation; from ``telemetry.reset()``)."""
    with _lock:
        _state.clear()
