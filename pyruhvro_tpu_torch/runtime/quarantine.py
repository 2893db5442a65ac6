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

:func:`publish` orders the entries and sets :func:`last`. The
reference's publish also feeds counters, span attributes, the storm's
flight dump and the trace id stamp; those need the metrics, telemetry,
trace-propagation and timeline planes, which the port does not have yet
(``ROADMAP.md`` (a) 8), so ``trace_id`` stays ``None``. The reference's
``collecting`` context, which makes a call's list the thread's active
collector for its process pool's merges, comes with that pool
(``ROADMAP.md`` (a) 6): a call here collects into a plain list.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional

__all__ = [
    "QuarantinedRecord",
    "rebase",
    "last",
    "publish",
]


class QuarantinedRecord(NamedTuple):
    """One dead-lettered row of a tolerant API call."""

    index: int              # global row index in the call's input
    datum: Optional[bytes]  # raw wire bytes (None for encode-side rows)
    error: str              # short slug, e.g. "overrun", "bad_branch"
    tier: str               # "fallback" | "device" | "policy"
    # the W3C trace id of the call; None until trace propagation is ported
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


def publish(entries: List[QuarantinedRecord]) -> None:
    """Close out one tolerant call: order the entries by index and
    expose them through :func:`last`."""
    entries.sort(key=lambda e: e.index)
    _tls.last = list(entries)
