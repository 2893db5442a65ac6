"""W3C ``traceparent`` trace-context propagation (copy of
``pyruhvro_tpu/runtime/traceprop.py``, whole).

A call's identity is a 128-bit trace id and the 64-bit id of its
parent span, carried in the W3C wire shape

    00-<32 hex trace id>-<16 hex span id>-<2 hex flags>

so that one poison message can be followed from the caller that sent
the batch to the quarantine entry that names it.

Resolution order for a new root span (``telemetry.root_span``):

1. an explicit ``trace_ctx=`` argument on the API call,
2. the thread-local context (set by an enclosing root span, a pool
   ``attach``, or a ``with traceprop.activate(ctx)`` block),
3. the ``PYRUHVRO_TPU_TRACEPARENT`` knob,
4. a freshly generated 128-bit trace id (this process is the ingress).

Ids come from ``os.urandom``; nothing here imports outside the runtime
package.
"""

from __future__ import annotations

import os
import re
import threading
from typing import NamedTuple, Optional, Union

from . import knobs, metrics

__all__ = [
    "TraceContext", "parse", "coerce", "new_trace_id", "new_span_id",
    "current", "current_traceparent", "activate", "from_env", "resolve",
]

_TRACEPARENT_RX = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

# all-zero ids are invalid per the W3C spec (they mean "no trace")
_ZERO_TRACE = "0" * 32
_ZERO_SPAN = "0" * 16


class TraceContext(NamedTuple):
    """An immutable (trace id, parent span id, flags) triple. The
    ``span_id`` names the SENDER's span — a root span created under
    this context records it as its ``parent_span_id``."""

    trace_id: str          # 32 lowercase hex chars (128-bit)
    span_id: str           # 16 lowercase hex chars (64-bit)
    flags: str = "01"      # sampled by default

    def traceparent(self) -> str:
        """The W3C wire form (version 00)."""
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def parse(traceparent: str) -> Optional[TraceContext]:
    """Parse a ``traceparent`` header value; None (and a
    ``trace.parse_error`` count) on anything malformed. Version ``ff``
    and all-zero ids are rejected per the spec; future versions are
    accepted as long as the 00-shaped prefix parses."""
    m = _TRACEPARENT_RX.match(traceparent.strip().lower())
    if not m:
        metrics.inc("trace.parse_error")
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == _ZERO_TRACE or span_id == _ZERO_SPAN:
        metrics.inc("trace.parse_error")
        return None
    return TraceContext(trace_id, span_id, flags)


def coerce(trace_ctx: Union[None, str, TraceContext]) -> Optional[TraceContext]:
    """Normalize a user-supplied ``trace_ctx=`` value: an existing
    :class:`TraceContext`, a ``traceparent`` string, or None. Anything
    else (or a malformed string) coerces to None so a bad header can
    never fail the data-plane call it rode in on."""
    if trace_ctx is None:
        return None
    if isinstance(trace_ctx, TraceContext):
        return trace_ctx
    if isinstance(trace_ctx, str):
        return parse(trace_ctx) if trace_ctx.strip() else None
    if (isinstance(trace_ctx, tuple) and len(trace_ctx) in (2, 3)
            and all(isinstance(p, str) for p in trace_ctx)):
        return parse(TraceContext(*trace_ctx).traceparent())
    metrics.inc("trace.parse_error")
    return None


_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The context active on THIS thread, or None."""
    return getattr(_tls, "ctx", None)


def current_traceparent() -> Optional[str]:
    """The active context in wire form, or None — what the process
    pool ships to spawned workers."""
    ctx = current()
    return None if ctx is None else ctx.traceparent()


class activate:
    """``with activate(ctx): ...`` — push a context onto this thread
    (None explicitly clears it, isolating e.g. a detached worker
    thread). Restores the previous context on exit."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self) -> Optional[TraceContext]:
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def from_env() -> Optional[TraceContext]:
    """The ``PYRUHVRO_TPU_TRACEPARENT`` env ingress (spawned workers;
    batch jobs launched under an external trace). Counts
    ``trace.env_ingress`` on each successful adoption."""
    raw = knobs.get_str("PYRUHVRO_TPU_TRACEPARENT")
    if not raw or not raw.strip():
        return None
    ctx = parse(raw)
    if ctx is not None:
        metrics.inc("trace.env_ingress")
    return ctx


def resolve(explicit: Union[None, str, TraceContext] = None,
            ) -> Optional[TraceContext]:
    """The parent context a NEW root span should join: explicit arg >
    thread-local > env ingress > None (caller mints a fresh trace)."""
    ctx = coerce(explicit)
    if ctx is not None:
        return ctx
    ctx = current()
    if ctx is not None:
        return ctx
    return from_env()
