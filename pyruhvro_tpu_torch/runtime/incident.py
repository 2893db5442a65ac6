"""Incident bundles: one atomic JSON file per incident (copy of
``pyruhvro_tpu/runtime/incident.py``, whole).

Every unhealthy ``/healthz`` condition publishes a ``severity=
"incident"`` event on :mod:`.timeline`; this module then writes ONE
self-contained post-mortem bundle into ``PYRUHVRO_TPU_INCIDENT_DIR``:
the health view (:func:`.obs_server.health`), the timeline around the
trigger, the flight-recorder ring, the breakers, the gauges and
counters, the knobs that are set, the routing ledger's tail and the last
audit mismatches. Each section is built on its own: one that fails is
named under ``section_errors`` (``incident.section_error``) and the
others are kept.

* **Debounced.** One bundle per :data:`DEBOUNCE_S` window; a storm of
  incident events coalesces into the first pending capture
  (``incident.debounced`` counts the others).
* **Rotated.** Only ``incident_<pid>_<seq>_<tag>.json`` names are ever
  deleted (a hand-saved copy survives); the newest
  ``PYRUHVRO_TPU_INCIDENT_MAX_FILES`` (default 16, 0 = no limit) stay.
* **Off the call's path.** :func:`request` only queues; the timeline's
  tick thread captures. Nothing here runs in a signal handler.
* **Fault seam.** The write goes through the ``incident_capture`` site
  of :mod:`.faults` and :mod:`.fsio`'s atomic write; a failed write
  counts ``incident.capture_failed`` and the call it observes goes on.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import knobs, metrics

__all__ = [
    "DEBOUNCE_S",
    "request",
    "maybe_capture",
    "capture_now",
    "list_incidents",
    "render_incident_report",
    "incident_dir",
    "reset",
]

# minimum seconds between bundle writes; a module constant (not a knob)
# sized so one incident produces one bundle even when every healthz bit
# flips within the same storm
DEBOUNCE_S = 30.0

_NAME_RE = re.compile(r"^incident_\d+_\d+_\w+\.json$")

_lock = threading.Lock()
_pending: Optional[Tuple[str, Optional[Dict[str, Any]]]] = None  # guarded-by: _lock
_last_capture_mono: Optional[float] = None  # guarded-by: _lock
_seq = 0  # guarded-by: _lock


def incident_dir() -> str:
    """Bundle directory (``PYRUHVRO_TPU_INCIDENT_DIR``); empty string
    disables auto-capture entirely."""
    return knobs.get_str("PYRUHVRO_TPU_INCIDENT_DIR")


def _max_files() -> int:
    """Retention cap (``PYRUHVRO_TPU_INCIDENT_MAX_FILES``, default 16,
    0 = unlimited)."""
    return max(0, knobs.get_int("PYRUHVRO_TPU_INCIDENT_MAX_FILES"))


def request(trigger: str, attrs: Optional[Dict[str, Any]] = None) -> bool:
    """Queue an incident capture (called by ``timeline.event()`` for
    every ``severity="incident"`` event). Cheap by contract — callers
    sit on state-transition paths: a knob read, a lock, two dict ops.
    Returns True when a capture is now pending."""
    if not incident_dir():
        return False
    now = time.perf_counter()
    global _pending
    with _lock:
        debounced = (_last_capture_mono is not None
                     and now - _last_capture_mono < DEBOUNCE_S)
        coalesced = _pending is not None
        if not debounced and not coalesced:
            _pending = (str(trigger), dict(attrs) if attrs else None)
    if debounced or coalesced:
        metrics.inc("incident.debounced")
        return False
    metrics.inc("incident.requested")
    return True


def maybe_capture() -> Optional[str]:
    """Capture the pending incident, if any (the timeline tick thread's
    drain point; also callable synchronously from tests). Returns the
    bundle path, or None."""
    global _pending
    with _lock:
        pend = _pending
        _pending = None
    if pend is None:
        return None
    return capture_now(pend[0], pend[1])


def _section(doc: Dict[str, Any], key: str, fn: Callable[[], Any]) -> None:
    """One bundle section, individually fault-isolated: a broken plane
    must not cost the post-mortem the other planes' evidence."""
    try:
        doc[key] = fn()
    except Exception as e:  # noqa: BLE001 — capture what survives
        metrics.inc("incident.section_error")
        doc.setdefault("section_errors", {})[key] = repr(e)


def _build_bundle(trigger: str,
                  attrs: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    from . import audit, breaker, obs_server, router, telemetry, timeline

    doc: Dict[str, Any] = {
        "kind": "incident",
        "pid": os.getpid(),
        "time": round(time.time(), 6),
        "mono": time.perf_counter(),
        "trigger": str(trigger),
    }
    if attrs:
        doc["attrs"] = dict(attrs)
    _section(doc, "health", lambda: {
        "code": obs_server.health()[0], **obs_server.health()[1]})
    _section(doc, "timeline", timeline.snapshot_timeline)
    _section(doc, "flight", telemetry.flight_dump)
    _section(doc, "breakers", breaker.snapshot_breakers)
    _section(doc, "gauges", metrics.gauges)
    _section(doc, "counters", metrics.snapshot)
    _section(doc, "knobs", lambda: {
        name: knobs.get_raw(name) for name in knobs.registry()
        if knobs.get_raw(name)})
    _section(doc, "routing_tail", lambda: (
        router.snapshot_routing().get("ledger") or [])[-32:])
    _section(doc, "audit_mismatches", lambda: audit.mismatches()[-8:])
    return doc


def _rotate(d: str, keep: int) -> int:
    """Delete the oldest auto-shaped bundles past ``keep`` (0 =
    unlimited); each deletion counts ``incident.dropped``. Hand-saved
    files never match :data:`_NAME_RE` and so are never touched."""
    if keep <= 0:
        return 0
    try:
        names = [n for n in os.listdir(d) if _NAME_RE.match(n)]
    except OSError:
        return 0
    if len(names) <= keep:
        return 0

    def mtime(n: str) -> float:
        try:
            return os.path.getmtime(os.path.join(d, n))
        except OSError:
            return 0.0

    names.sort(key=mtime)
    dropped = 0
    for n in names[: len(names) - keep]:
        try:
            os.remove(os.path.join(d, n))
            dropped += 1
        except OSError:
            continue
    if dropped:
        metrics.inc("incident.dropped", dropped)
    return dropped


def capture_now(trigger: str,
                attrs: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Build and atomically write one bundle NOW (bypassing the debounce
    gate but arming it: failures debounce too, so a broken disk cannot
    turn an event storm into a write storm). Returns the path, or None
    when the directory knob is unset or the write failed (counted)."""
    from . import faults, fsio

    d = incident_dir()
    if not d:
        return None
    global _seq, _last_capture_mono
    with _lock:
        _last_capture_mono = time.perf_counter()
        _seq += 1
        seq = _seq
    doc = _build_bundle(trigger, attrs)
    tag = re.sub(r"\W+", "_", str(trigger)).strip("_")[:40] or "event"
    path = os.path.join(d, f"incident_{os.getpid()}_{seq}_{tag}.json")
    try:
        faults.fire("incident_capture")
        os.makedirs(d, exist_ok=True)
        fsio.atomic_write_json(path, doc)
    except (OSError, ValueError, faults.FaultInjected):
        metrics.inc("incident.capture_failed")
        return None
    metrics.inc("incident.captured")
    _rotate(d, _max_files())
    return path


# ---------------------------------------------------------------------------
# listing / rendering
# ---------------------------------------------------------------------------


def list_incidents() -> Dict[str, Any]:
    """The ``/incidents`` body: directory inventory (auto-shaped names
    only), newest last, filename-derived metadata — cheap enough to poll
    without parsing bundle contents."""
    d = incident_dir()
    out: Dict[str, Any] = {"dir": d or None, "incidents": []}
    if not d:
        out["note"] = "PYRUHVRO_TPU_INCIDENT_DIR is not set"
        return out
    try:
        names = [n for n in os.listdir(d) if _NAME_RE.match(n)]
    except OSError:
        return out
    entries: List[Dict[str, Any]] = []
    for n in names:
        p = os.path.join(d, n)
        try:
            st = os.stat(p)
        except OSError:
            continue
        parts = n[: -len(".json")].split("_", 3)
        entries.append({
            "file": n,
            "bytes": st.st_size,
            "mtime": round(st.st_mtime, 3),
            "pid": int(parts[1]) if len(parts) > 2 else None,
            "trigger": parts[3] if len(parts) > 3 else None,
        })
    entries.sort(key=lambda e: e["mtime"])
    out["incidents"] = entries
    return out


def _breach_interval(sec: Dict[str, Any]) -> Optional[str]:
    """Span of incident-severity events on the bundled timeline — the
    operator's first answer: when did it start, how long did it burn."""
    from . import timeline as tl

    evs = [e for e in (sec.get("events") or [])
           if e.get("severity") == "incident"]
    if not evs:
        return None
    first, last = float(evs[0]["ts"]), float(evs[-1]["ts"])
    return (f"{tl._fmt_ts(first)} .. {tl._fmt_ts(last)} "
            f"({last - first:.1f}s, {len(evs)} incident event(s))")


def render_incident_report(doc: Dict[str, Any]) -> str:
    """Text post-mortem of one bundle (``telemetry incident-report``).
    Plain snapshots degrade to their timeline section with a note;
    legacy snapshots degrade further inside :func:`render_timeline`."""
    from . import timeline as tl

    out: List[str] = []
    if doc.get("kind") == "incident":
        out.append("== incident bundle ==")
        out.append(f"trigger: {doc.get('trigger')}   "
                   f"time: {tl._fmt_date(float(doc.get('time') or 0.0))}"
                   f"   pid: {doc.get('pid')}")
        if doc.get("attrs"):
            out.append("attrs: " + " ".join(
                f"{k}={v}" for k, v in sorted(doc["attrs"].items())))
        h = doc.get("health") or {}
        bits = sorted(k for k, v in (h.get("unhealthy_bits") or {}).items()
                      if v)
        out.append(f"health: {h.get('code', '?')} {h.get('status', '?')}"
                   + (f" ({', '.join(bits)})" if bits else ""))
        brk = doc.get("breakers") or {}
        if brk:
            out.append("breakers: " + " ".join(
                f"{name}={b.get('state')}" for name, b in sorted(brk.items())))
        sec = doc.get("timeline") or {}
        interval = _breach_interval(sec)
        if interval:
            out.append("breach interval: " + interval)
        mem = sorted((k, v) for k, v in (doc.get("gauges") or {}).items()
                     if k.startswith("mem."))
        if mem:
            out.append("mem gauges: " + "  ".join(
                f"{k}={v}" for k, v in mem[:6]))
        tail = doc.get("routing_tail") or []
        if tail:
            out.append(f"routing ledger tail: {len(tail)} entr"
                       + ("y" if len(tail) == 1 else "ies"))
        mism = doc.get("audit_mismatches") or []
        if mism:
            out.append(f"audit mismatches: {len(mism)} "
                       "(answers may have been wrong)")
        if doc.get("section_errors"):
            out.append("section errors: " + ", ".join(
                sorted(doc["section_errors"])))
        out.append("")
        out.append(tl.render_timeline(sec))
        return "\n".join(out)
    out.append("== incident report ==")
    out.append("not an incident bundle; rendering the snapshot's "
               "timeline section")
    out.append("")
    out.append(tl.render_timeline(doc))
    return "\n".join(out)


def reset() -> None:
    """Drop the pending capture and disarm the debounce gate (test
    isolation; the sequence counter survives so filenames in a reused
    directory never collide)."""
    global _pending, _last_capture_mono
    with _lock:
        _pending = None
        _last_capture_mono = None
