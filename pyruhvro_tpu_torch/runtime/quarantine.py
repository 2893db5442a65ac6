"""The quarantine channel of the error policies (copy of
``pyruhvro_tpu/runtime/quarantine.py``: ``QuarantinedRecord``,
``rebase``, ``publish`` and ``last``).

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
:data:`STORM` entries (the reference's default of its
``PYRUHVRO_TPU_QUARANTINE_STORM``, a knob the port does not read),
``<op>.quarantine_storms`` with the ``quarantine_storm`` mark
(``quarantine.py:136-176``). The storm's flight dump and timeline event
wait for those planes (``ROADMAP.md`` (a) 8). The reference's
``collecting`` context, which makes a call's list the thread's active
collector for its process pool's merges, comes with that pool
(``ROADMAP.md`` (a) 6): a call here collects into a plain list.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional

from . import metrics, telemetry, traceprop

__all__ = [
    "QuarantinedRecord",
    "rebase",
    "last",
    "publish",
    "STORM",
]

# quarantined rows of one call that count as a storm
STORM = 100


class QuarantinedRecord(NamedTuple):
    """One dead-lettered row of a tolerant API call."""

    index: int              # global row index in the call's input
    datum: Optional[bytes]  # raw wire bytes (None for encode-side rows)
    error: str              # short slug, e.g. "overrun", "bad_branch"
    tier: str               # "fallback" | "native" | "device" | "policy"
    # the W3C trace id of the call that quarantined the row
    trace_id: Optional[str] = None


_tls = threading.local()


def rebase(entries, base: int) -> List[QuarantinedRecord]:
    """Shift every entry's global row index by ``base``. Accepts records
    or plain tuples; always returns :class:`QuarantinedRecord`\\ s. No
    call of the port needs it yet: it is the re-indexing rule of the
    reference's pool merge, kept (and held to the reference's) for the
    process pool of ``ROADMAP.md`` (a) 6, whose workers quarantine at
    chunk-local indices."""
    out: List[QuarantinedRecord] = []
    for e in entries:
        t = tuple(e)
        out.append(QuarantinedRecord(t[0] + base, *t[1:]))
    return out


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
    # metric-key: <op>.quarantined
    metrics.inc(op + ".quarantined", float(len(entries)))
    for e in entries:
        # metric-key: <op>.quarantine.<slug>
        metrics.inc(f"{op}.quarantine.{e.error}")
    if len(entries) >= STORM:
        # metric-key: <op>.quarantine_storms
        metrics.inc(op + ".quarantine_storms")
        metrics.mark("quarantine_storm")
        # not ported: the storm's timeline event and flight dump
        # (ROADMAP.md (a) 8)
