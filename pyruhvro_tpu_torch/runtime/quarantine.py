"""The quarantine channel of the error policies (copy of
``pyruhvro_tpu/runtime/quarantine.py``: ``QuarantinedRecord``,
``collecting``, ``rebase``, ``extend_current``, ``publish`` and
``last``).

Under ``on_error="skip"`` or ``"null"`` (``api.py``) a corrupt datum no
longer aborts the batch: each offender is captured as a
:class:`QuarantinedRecord` — its global row index, its raw wire bytes
(``None`` on the encode side, where a row has no wire form), a short
error slug and the tier that found it. Callers read them through
:func:`last` (``pyruhvro_tpu_torch.last_quarantine``) or through
``return_errors=True``.

:func:`publish` stamps each entry with the call's trace id
(``traceprop.current()``), orders the entries, sets :func:`last`,
annotates the span with ``on_error`` and ``quarantined``, and counts
``<op>.quarantined``, ``<op>.quarantine.<slug>`` and, at
``PYRUHVRO_TPU_QUARANTINE_STORM`` entries (read at each call; its
default is :data:`STORM`), ``<op>.quarantine_storms`` with the
``quarantine_storm`` mark (``quarantine.py:133-182``), and auto-dumps
the flight recorder (``PYRUHVRO_TPU_FLIGHT_DIR``), and publishes a
``quarantine.storm`` incident event on :mod:`.timeline`.

A call that fans out to the process pool opens :func:`collecting`: the
workers' entries (re-based to the call's row indices by :func:`rebase`
in the worker) reach that list through ``telemetry.merge_worker`` and
:func:`extend_current`. The workers counted them already, so
:func:`publish` does not count them again. Every other tolerant call
collects into a plain list.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional

from . import knobs, metrics, telemetry, traceprop

__all__ = [
    "QuarantinedRecord",
    "collecting",
    "rebase",
    "extend_current",
    "last",
    "publish",
    "STORM",
]

# the default of PYRUHVRO_TPU_QUARANTINE_STORM: quarantined rows of one
# call that count as a storm
STORM = knobs.DEFAULTS["PYRUHVRO_TPU_QUARANTINE_STORM"]


def _storm_threshold() -> int:
    return knobs.get_int("PYRUHVRO_TPU_QUARANTINE_STORM")


class QuarantinedRecord(NamedTuple):
    """One dead-lettered row of a tolerant API call."""

    index: int              # global row index in the call's input
    datum: Optional[bytes]  # raw wire bytes (None for encode-side rows)
    error: str              # short slug, e.g. "overrun", "bad_branch"
    tier: str               # "fallback" | "native" | "device" | "policy"
    # the W3C trace id of the call that quarantined the row
    trace_id: Optional[str] = None


_tls = threading.local()


class collecting:
    """Open the quarantine collector of the current API call: the list is
    the context's value, and process-pool merges reach it through
    :func:`extend_current` on the calling thread."""

    __slots__ = ("entries", "_prev", "_prev_merged")

    def __enter__(self) -> List[QuarantinedRecord]:
        self._prev = getattr(_tls, "active", None)
        self._prev_merged = getattr(_tls, "merged", 0)
        self.entries: List[QuarantinedRecord] = []
        _tls.active = self.entries
        _tls.merged = 0
        return self.entries

    def __exit__(self, *exc):
        _tls.active = self._prev
        _tls.merged = self._prev_merged
        return False


def rebase(entries, base: int) -> List[QuarantinedRecord]:
    """Shift every entry's global row index by ``base`` (a process
    worker's chunk starts at its offset in the caller's input). Accepts
    records or plain tuples; always returns
    :class:`QuarantinedRecord`\\ s."""
    out: List[QuarantinedRecord] = []
    for e in entries:
        t = tuple(e)
        out.append(QuarantinedRecord(t[0] + base, *t[1:]))
    return out


def extend_current(entries) -> None:
    """Fold worker-shipped entries into the active collector (a no-op
    outside :func:`collecting`). The workers fed the quarantine counters
    in their own processes, and those deltas merge on their own, so the
    merged count is remembered for :func:`publish`."""
    active = getattr(_tls, "active", None)
    if active is None or not entries:
        return
    for e in entries:
        active.append(QuarantinedRecord(*e))
    _tls.merged = getattr(_tls, "merged", 0) + len(entries)


def last() -> List[QuarantinedRecord]:
    """The quarantine list of the most recent tolerant
    (``on_error="skip"``/``"null"``) API call on this thread — empty
    when that call was clean. ``"raise"`` calls leave it untouched, so
    read it right after the tolerant call it describes (or use
    ``return_errors=True``)."""
    return list(getattr(_tls, "last", ()))


def publish(entries: List[QuarantinedRecord], policy: str,
            op: str = "decode") -> None:
    """Close out one tolerant call: stamp the active trace id on the
    entries, order them by index, expose them through :func:`last`, and
    feed the ``<op>.quarantined`` counters and the span."""
    ctx = traceprop.current()
    if ctx is not None:
        tid = ctx.trace_id
        entries[:] = [e if e.trace_id else QuarantinedRecord(
            e.index, e.datum, e.error, e.tier, tid) for e in entries]
    entries.sort(key=lambda e: e.index)
    _tls.last = list(entries)
    telemetry.annotate(on_error=policy, quarantined=len(entries))
    if not entries:
        return
    # entries merged from process workers were counted in the worker
    # (and its deltas merged): only entries found here feed the counters
    merged = min(getattr(_tls, "merged", 0), len(entries))
    if merged == 0:
        # metric-key: <op>.quarantined
        metrics.inc(op + ".quarantined", float(len(entries)))
        for e in entries:
            # metric-key: <op>.quarantine.<slug>
            metrics.inc(f"{op}.quarantine.{e.error}")
    elif merged < len(entries):
        # mixed sources (no call of the port has both): count the rest
        # without their slugs
        metrics.inc(op + ".quarantined", float(len(entries) - merged))
    if len(entries) >= _storm_threshold():
        # metric-key: <op>.quarantine_storms
        metrics.inc(op + ".quarantine_storms")
        metrics.mark("quarantine_storm")  # the live /healthz bit
        from . import timeline

        timeline.event("quarantine.storm", severity="incident",
                       attrs={"op": op, "entries": len(entries),
                              "policy": policy})
        telemetry._flight_autodump("quarantine")
