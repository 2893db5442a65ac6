"""Overload-hardened micro-batching serving plane (copy of
``pyruhvro_tpu/serving/__init__.py``, whole but the departures below).

The one-shot API defends nothing when offered load exceeds capacity.
This is the front door that *stays up under overload*, and the layer
that drives the card in production: many small requests (a Kafka
consumer's polls) coalesced into one K1/K2 (or K3) launch sequence.

* **Bounded queues**, one per (op, schema fingerprint, tenant,
  on_error, backend, device) — the coalescing key — each capped at
  ``PYRUHVRO_TPU_SERVE_QUEUE`` requests. Worker threads drain the
  queue whose head deadline is tightest and coalesce whole requests
  into ONE ``api.deserialize_array`` call (micro-batching keeps the
  launch buckets, the specialiser and the arenas warm and amortizes
  per-call overhead);
  results are split back per request and quarantine indices are
  re-based to each caller's own record indices
  (:func:`..runtime.quarantine.rebase`).
* **Deadlines measured from enqueue**: a request's ``timeout_s``
  starts burning when :meth:`ServePlane.submit` accepts it, so queue
  wait counts against the budget. Requests that expire while still
  queued are shed with a structured ``DeadlineExceeded`` WITHOUT
  running the decode.
* **Backpressure policies** (``PYRUHVRO_TPU_SERVE_POLICY``):
  ``block`` waits up to the enqueue deadline for queue space; ``shed``
  rejects immediately with :class:`Overloaded` carrying a retry-after
  hint derived from the cost model's predicted drain time of the
  backlog (:func:`..runtime.costmodel.predict_drain`).
* **Per-tenant admission control** fed by the heavy-hitter
  sketch (:func:`..runtime.memacct.tenant_hotlist`) plus live queue
  occupancy: once the plane is over half full, no tenant may hold more
  than ``PYRUHVRO_TPU_SERVE_TENANT_SHARE`` of the queued requests —
  one tenant's flood cannot starve others.
* **Brownout degradation ladder** under sustained pressure: rungs shed
  audit shadowing → deep sampling → explore arms → flood tenants, in
  that order, each engagement counted (``serve.brownout.<rung>``) and
  reflected in ``/healthz`` degraded bits; rungs auto-release (with
  hysteresis) when pressure clears.
* **Zero-loss graceful drain**: :meth:`ServePlane.drain` stops intake,
  flushes every queued request to a terminal state (result or
  structured error — none silently dropped), restores the brownout
  overrides and flushes telemetry/profile persistence.
  :func:`install_drain_signal` arms the same drain on SIGTERM/SIGINT,
  obeying the signal-safety rules (the handler only bumps a
  :class:`..runtime.metrics.DeferredCount` and sets an Event; the
  drain itself runs on a normal thread).
* **Chaos seams** (:mod:`..runtime.faults`): ``serve_enqueue``
  degrades admission to a direct synchronous call (byte-identical,
  queue bypassed); ``serve_worker`` fires inside the coalesced batch
  attempt — failures and stalls trip the ``serve_worker`` breaker and
  drain to the per-request serial path, byte-identical by
  construction. The optional Arrow Flight endpoint lives in
  :mod:`.flight` and degrades to a counted no-op without
  ``pyarrow.flight``.

Synchronization: one :class:`threading.Condition` per plane guards all
queue/accounting state (a rendezvous, not a data lock held across
blocking calls); the module-level singleton is guarded by ``_lock``.

Departures from the reference (``ROADMAP.md`` (c) 11):

* **Device.** :meth:`ServePlane.submit`, :meth:`ServePlane.call` and the
  Flight spec carry the port's ``device=`` keyword (default ``"cuda"``)
  to every API call, and the coalescing key ends with the device, so
  requests for different cards never share a batch.
* **Default backend** ``"device"``, as the port's API has it
  (``ROADMAP.md`` (c) 9); the reference's is ``"auto"``.
* **Fault classification.** The port has no ``faults.degradable``. The
  serving seams keep the reference's behaviour, since every degraded
  path runs the same API call on the same backend and card: a
  ``serve_enqueue`` fault serves the request by a direct call, a failed
  coalesced batch goes to the per-request serial path, and a
  ``serve_flight`` fault fails one RPC. :func:`_degradable`, a private
  copy of the reference's taxonomy
  (``pyruhvro_tpu/runtime/faults.py:57-69``), only picks the counter
  (``serve.worker_degraded`` with a breaker failure, or
  ``serve.batch_isolate``), never a tier: a failed ``nvcc``
  build or kernel launch inside a coalesced batch reaches each member
  through its own serial call on the card and ends in that member's
  future. Nothing is answered by the host tier or the oracle.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..runtime import (
    breaker,
    costmodel,
    deadline,
    faults,
    knobs,
    memacct,
    metrics,
    slo,
    telemetry,
)
from ..runtime import audit as _audit
from ..runtime import deadline as _deadline
from ..runtime import quarantine as _quarantine
from ..runtime import sampling as _sampling
from ..runtime import timeline

__all__ = [
    "Overloaded",
    "ServePlane",
    "start",
    "plane",
    "stop",
    "install_drain_signal",
    "snapshot_serving",
    "engaged_rungs",
    "render_serve_report",
    "reset",
]


def _degradable(e: BaseException) -> bool:
    """The reference's fault taxonomy (``faults.degradable``): a backend
    or runtime fault (a ``RuntimeError`` such as a failed build or
    launch or an injected :class:`..runtime.faults.FaultInjected`, a
    transport ``OSError``, a ``MemoryError``) as against a data error, a
    capacity condition or a deadline, which are contracts. Here it picks
    a counter and a breaker verdict only; both kinds go to the same
    serial path."""
    return (isinstance(e, (RuntimeError, OSError, MemoryError))
            and not isinstance(e, _deadline.DeadlineExceeded))


class Overloaded(Exception):
    """Structured admission rejection: the serving plane refused this
    request (full queue, enqueue-deadline expiry, tenant fairness cap,
    brownout tenant shedding, or drain in progress). A capacity
    CONTRACT like ``BatchTooLarge`` — deliberately not a
    ``RuntimeError``, so no degrade seam ever swallows it.

    ``retry_after_s`` (when known) is the cost model's predicted drain
    time of the backlog that caused the rejection — the client's
    Retry-After header."""

    def __init__(self, message: str, *, reason: str,
                 tenant: Optional[str] = None,
                 retry_after_s: Optional[float] = None,
                 queued: Optional[int] = None):
        super().__init__(message)
        self.reason = reason
        self.tenant = tenant
        self.retry_after_s = retry_after_s
        self.queued = queued


class _Request:
    """One accepted (or about-to-be-accepted) serving request."""

    __slots__ = ("op", "data", "schema", "fp", "tenant", "backend",
                 "device", "on_error", "return_errors", "num_chunks",
                 "n_rows", "timeout_s", "enqueue_t", "deadline_t",
                 "trace_ctx", "future", "done", "coalescable")

    def __init__(self, op, data, schema, fp, tenant, backend, device,
                 on_error, return_errors, num_chunks, n_rows, timeout_s,
                 enqueue_t, trace_ctx):
        import concurrent.futures

        self.op = op
        self.data = data
        self.schema = schema
        self.fp = fp
        self.tenant = tenant          # None = untagged
        self.backend = backend
        self.device = device          # as the caller gave it
        self.on_error = on_error
        self.return_errors = return_errors
        self.num_chunks = num_chunks
        self.n_rows = n_rows
        self.timeout_s = timeout_s
        self.enqueue_t = enqueue_t
        self.deadline_t = (enqueue_t + timeout_s
                           if timeout_s is not None else None)
        self.trace_ctx = trace_ctx
        self.future = concurrent.futures.Future()
        self.done = False
        # only plain datum sequences coalesce; arrow-array inputs keep
        # their zero-copy ingestion lane by running uncoalesced
        self.coalescable = (op == "decode"
                            and isinstance(data, (list, tuple)))

    @property
    def tenant_key(self) -> str:
        return self.tenant or "-"

    def remaining(self, now: Optional[float] = None) -> Optional[float]:
        if self.deadline_t is None:
            return None
        return max(0.0, self.deadline_t - (now or time.monotonic()))


# the ladder, least- to most-intrusive: each rung trades a little
# observability/fairness for capacity, and the order is the promise —
def _schema_has_union(schema) -> bool:
    """True when any column type (recursively) is a union — those
    cannot be zero-copy sliced at a non-zero offset without value
    corruption in downstream conversions (see _split_decode)."""
    import pyarrow.types as pt

    def walk(t):
        if pt.is_union(t):
            return True
        return any(walk(t.field(i).type)
                   for i in range(getattr(t, "num_fields", 0) or 0))

    return any(walk(f.type) for f in schema)


# correctness shadowing goes first, paying tenants go last
BROWNOUT_RUNGS = ("audit", "sampling", "explore", "tenant")
_RUNG_STEP = 0.08       # pressure headroom between consecutive rungs
_RUNG_HYSTERESIS = 0.15  # release this far below the engage threshold
_TICK_INTERVAL_S = 0.02


class _Brownout:
    """The degradation ladder. All state is instance-held and guarded
    by the owning plane's condition; the engage/release side effects
    flip process-wide overrides (audit/sampling/explore) that
    :meth:`release_all` and :func:`reset` restore."""

    def __init__(self, plane: "ServePlane"):
        self._plane = plane
        self._engaged_at: Dict[str, float] = {}
        self._over: Dict[str, int] = {r: 0 for r in BROWNOUT_RUNGS}
        self._occupancy: Dict[str, float] = {r: 0.0
                                             for r in BROWNOUT_RUNGS}
        self._last_tick = 0.0

    # -- queries (call under the plane cond or tolerate staleness) ----------

    def engaged(self) -> Tuple[str, ...]:
        return tuple(r for r in BROWNOUT_RUNGS if r in self._engaged_at)

    def occupancy(self) -> Dict[str, float]:
        now = time.monotonic()
        out = dict(self._occupancy)
        for r, t0 in self._engaged_at.items():
            out[r] += now - t0
        return out

    # -- evaluation ---------------------------------------------------------

    def tick_locked(self, pressure: float, now: float) -> None:
        if now - self._last_tick < _TICK_INTERVAL_S:
            return
        self._last_tick = now
        base = knobs.get_float("PYRUHVRO_TPU_SERVE_BROWNOUT")
        if base is None or base > 1.0:
            return
        sustain = max(1, knobs.get_int(
            "PYRUHVRO_TPU_SERVE_BROWNOUT_SUSTAIN"))
        for i, rung in enumerate(BROWNOUT_RUNGS):
            thr = min(0.97, base + _RUNG_STEP * i)
            rel = max(0.0, thr - _RUNG_HYSTERESIS)
            if rung in self._engaged_at:
                if pressure <= rel:
                    self._release_locked(rung, now)
            elif pressure >= thr:
                self._over[rung] += 1
                if self._over[rung] >= sustain:
                    self._engage_locked(rung, now)
            else:
                self._over[rung] = 0

    def _engage_locked(self, rung: str, now: float) -> None:
        self._engaged_at[rung] = now
        self._over[rung] = 0
        # metric-key: serve.brownout.<rung>
        metrics.inc("serve.brownout." + rung)
        metrics.mark("serve_brownout")  # the /healthz degraded bit
        timeline.event("serve.brownout", severity="warn",
                       attrs={"rung": rung})
        if rung == "audit":
            _audit.set_enabled(False)
        elif rung == "sampling":
            _sampling.set_enabled(False)
        elif rung == "explore":
            costmodel.set_explore_override(0.0)
        # "tenant" is a flag the admission path reads via engaged()

    def _release_locked(self, rung: str, now: float) -> None:
        t0 = self._engaged_at.pop(rung, None)
        if t0 is not None:
            self._occupancy[rung] += now - t0
        metrics.inc("serve.brownout_release." + rung)  # metric-key: serve.brownout_release.<rung>
        timeline.event("serve.brownout_release", attrs={"rung": rung})
        if rung == "audit":
            _audit.set_enabled(None)
        elif rung == "sampling":
            _sampling.set_enabled(None)
        elif rung == "explore":
            costmodel.set_explore_override(None)

    def release_all(self) -> None:
        now = time.monotonic()
        for rung in list(self._engaged_at):
            self._release_locked(rung, now)


class ServePlane:
    """The micro-batching front door over the one-shot API.

    One instance per service process (module-level :func:`start` keeps
    the singleton); tests may build private instances with
    ``autostart=False`` to control worker scheduling explicitly."""

    def __init__(self, *, workers: Optional[int] = None,
                 autostart: bool = True):
        self._cond = threading.Condition()
        # everything below is guarded by _cond (instance state; the
        # condition is the plane's single rendezvous + data guard)
        self._queues: Dict[tuple, Deque[_Request]] = {}
        self._schemas: Dict[tuple, str] = {}   # key -> schema string
        self._queued_total = 0
        self._tenant_queued: Dict[str, int] = {}
        self._inflight = 0
        self._accepted = 0
        self._shed = 0
        self._completed = 0
        self._failed = 0
        self._drained = 0
        self._draining = False
        self._closed = False
        self._running = False
        self._threads: List[threading.Thread] = []
        self._workers = (workers if workers is not None
                         else max(1, knobs.get_int(
                             "PYRUHVRO_TPU_SERVE_WORKERS")))
        self._brownout = _Brownout(self)
        # (op, fp) -> EWMA seconds/row from completed work: the drain
        # estimator's fallback when the cost model has no observation
        self._spr: Dict[tuple, float] = {}
        # per-name re-arm stamps for onset timeline events: shedding /
        # saturation fire per REQUEST, but the timeline wants the
        # episode boundary, not a per-call flood of the event ring
        self._evt_mono: Dict[str, float] = {}
        self._started_at = time.time()
        if autostart:
            self.start_workers()

    # ------------------------------------------------------------------
    # knobs (read per call so tests can flip them in-process)
    # ------------------------------------------------------------------

    _EVENT_REARM_S = 5.0

    def _onset_event(self, name: str, severity: str,
                     attrs: Dict[str, Any]) -> None:
        """Publish a timeline event for a per-request condition at most
        once per :data:`_EVENT_REARM_S` — the timeline wants the
        episode onset, not one event per shed request."""
        now = time.monotonic()
        if now - self._evt_mono.get(name, -1e9) < self._EVENT_REARM_S:
            return
        self._evt_mono[name] = now
        timeline.event(name, severity=severity, attrs=attrs)

    @staticmethod
    def _depth() -> int:
        return max(1, knobs.get_int("PYRUHVRO_TPU_SERVE_QUEUE"))

    @staticmethod
    def _policy() -> str:
        return knobs.get_enum("PYRUHVRO_TPU_SERVE_POLICY")

    @staticmethod
    def _max_batch_rows() -> int:
        return max(1, knobs.get_int("PYRUHVRO_TPU_SERVE_MAX_BATCH_ROWS"))

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, op: str, data, schema: str, *,
               backend: str = "device", device="cuda",
               on_error: str = "raise",
               return_errors: bool = False,
               timeout_s: Optional[float] = None,
               tenant: Optional[str] = None, trace_ctx=None,
               num_chunks: int = 1):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        resolving to exactly what the corresponding one-shot API call
        would return (or raising its structured error). ``op`` is
        ``"decode"`` (→ :func:`..api.deserialize_array`) or
        ``"encode"`` (→ :func:`..api.serialize_record_batch`), on
        ``backend`` and ``device`` as those take them.
        ``timeout_s`` starts burning NOW — queue wait counts."""
        if op not in ("decode", "encode"):
            raise ValueError(f"op must be 'decode' or 'encode', "
                             f"got {op!r}")
        t0 = time.monotonic()
        metrics.inc("serve.submitted")
        # chaos seam: a degradable admission fault bypasses the queue
        # and serves the call directly (the pre-serving path — byte-
        # identical results; a hang here burns the caller's budget,
        # exactly as a slow admission would)
        try:
            faults.fire("serve_enqueue")
        except Exception as e:
            if not _degradable(e):
                raise
            metrics.inc("serve.enqueue_degraded")
            return self._direct_future(op, data, schema, backend, device,
                                       on_error, return_errors,
                                       timeout_s, tenant, trace_ctx,
                                       num_chunks, t0)
        from .. import api  # lazy: importing serving loads no codec

        entry = api.get_or_parse_schema(schema)
        if timeout_s is None:
            timeout_s = deadline.default_timeout_s()
        n_rows = (len(data) if op == "decode" else data.num_rows)
        r = _Request(op, data, schema, entry.fingerprint, tenant,
                     backend, device, on_error, return_errors, num_chunks,
                     n_rows, timeout_s, t0, trace_ctx)
        # requests for different cards never share a batch
        key = (op, r.fp, r.tenant_key, on_error, backend, str(device))
        with self._cond:
            self._brownout.tick_locked(self._pressure_locked(), t0)
            reason = self._admit_locked(r, key)
            if reason == "queue_full" and self._policy() == "block":
                reason = self._block_for_space_locked(r, key)
            if reason is not None:
                self._shed += 1
                # metric-key: serve.shed.<reason>
                metrics.inc("serve.shed." + reason)
                metrics.inc("serve.shed")
                metrics.mark("serve_shed")  # /healthz degraded bit
                self._onset_event("serve.shed", "warn",
                                  {"reason": reason, "tenant": tenant,
                                   "queued": self._queued_total})
                raise Overloaded(
                    f"request shed at admission ({reason})",
                    reason=reason, tenant=tenant,
                    retry_after_s=self._retry_after_locked(r, key),
                    queued=self._queued_total)
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
                self._schemas[key] = schema
            q.append(r)
            self._queued_total += 1
            self._tenant_queued[r.tenant_key] = (
                self._tenant_queued.get(r.tenant_key, 0) + 1)
            self._accepted += 1
            metrics.inc("serve.accepted")
            self._cond.notify_all()
        return r.future

    def call(self, op: str, data, schema: str, **kw):
        """Synchronous convenience: submit + wait."""
        return self.submit(op, data, schema, **kw).result()

    def _admit_locked(self, r: _Request, key: tuple) -> Optional[str]:
        """None = admit; else the shed reason."""
        if self._closed or self._draining:
            return "draining"
        # brownout rung 4: flood tenants (heavy hitters by attributed
        # bytes) are shed entirely while the rung is engaged
        if ("tenant" in self._brownout.engaged()
                and r.tenant_key in _flood_tenants()):
            return "tenant_flood"
        # fairness cap: past half-full, one TAGGED tenant may not hold
        # more than its share of all queued requests (untagged traffic
        # is exempt — there is no tenant to be fair between)
        share = knobs.get_float("PYRUHVRO_TPU_SERVE_TENANT_SHARE")
        if (share and share > 0 and r.tenant is not None
                and self._queued_total > 0):
            capacity = self._depth() * max(1, len(self._queues))
            mine = self._tenant_queued.get(r.tenant_key, 0)
            if (self._queued_total >= 0.5 * capacity
                    and (mine + 1) > share * (self._queued_total + 1)):
                return "tenant_share"
        q = self._queues.get(key)
        if q is not None and len(q) >= self._depth():
            metrics.mark("queue_saturated")  # /healthz unhealthy bit
            self._onset_event("serve.queue_saturated", "incident",
                              {"depth": len(q),
                               "queued": self._queued_total})
            return "queue_full"
        return None

    def _block_for_space_locked(self, r: _Request,
                                key: tuple) -> Optional[str]:
        """'block' policy: wait for space up to the enqueue deadline
        (bounded by the request's own remaining budget). Returns None
        once admitted, or the terminal shed reason."""
        limit = max(0.0, knobs.get_float(
            "PYRUHVRO_TPU_SERVE_ENQUEUE_WAIT_S"))
        rem = r.remaining()
        if rem is not None:
            limit = min(limit, rem)
        until = time.monotonic() + limit
        while True:
            left = until - time.monotonic()
            if left <= 0:
                return "enqueue_timeout"
            self._cond.wait(min(left, 0.05))
            if self._closed or self._draining:
                return "draining"
            reason = self._admit_locked(r, key)
            if reason is None:
                return None
            if reason != "queue_full":
                return reason

    def _retry_after_locked(self, r: _Request,
                            key: tuple) -> Optional[float]:
        """Predicted drain time of the backlog the request would have
        joined — cost model first, the plane's own service-rate EWMA
        as fallback."""
        q = self._queues.get(key)
        backlog_rows = sum(x.n_rows for x in q) if q else 0
        backlog_rows += r.n_rows
        est = costmodel.predict_drain(r.fp, r.op, backlog_rows)
        if est is None:
            spr = self._spr.get((r.op, r.fp))
            est = spr * backlog_rows if spr else None
        if est is None:
            return None
        workers = max(1, self._workers)
        return round(est / workers, 6)

    def _pressure_locked(self) -> float:
        if not self._queues:
            return 0.0
        depth = self._depth()
        return max(len(q) for q in self._queues.values()) / depth

    def _direct_future(self, op, data, schema, backend, device, on_error,
                       return_errors, timeout_s, tenant, trace_ctx,
                       num_chunks, t0):
        """The serve_enqueue degrade path: run synchronously on the
        caller thread (byte-identical to the one-shot API) and hand
        back an already-resolved future."""
        import concurrent.futures

        from .. import api

        fut: Any = concurrent.futures.Future()
        rem = timeout_s
        if rem is not None:
            rem = max(0.0, rem - (time.monotonic() - t0))
        try:
            if op == "decode":
                res = api.deserialize_array(
                    data, schema, backend=backend, device=device,
                    on_error=on_error, return_errors=return_errors,
                    timeout_s=rem, tenant=tenant, trace_ctx=trace_ctx)
            else:
                res = api.serialize_record_batch(
                    data, schema, num_chunks, backend=backend,
                    device=device, on_error=on_error,
                    return_errors=return_errors, timeout_s=rem,
                    tenant=tenant, trace_ctx=trace_ctx)
            fut.set_result(res)
        except BaseException as e:  # noqa: BLE001 — future carries it
            fut.set_exception(e)
        return fut

    # ------------------------------------------------------------------
    # workers
    # ------------------------------------------------------------------

    def start_workers(self) -> None:
        with self._cond:
            if self._running or self._closed:
                return
            self._running = True
            for i in range(self._workers):
                t = threading.Thread(target=self._worker_loop,
                                     name=f"pyruhvro-serve-{i}",
                                     daemon=True)
                self._threads.append(t)
                t.start()

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while (self._running and self._queued_total == 0
                       and not (self._draining and self._inflight == 0)):
                    self._cond.wait(0.1)
                    self._brownout.tick_locked(self._pressure_locked(),
                                               time.monotonic())
                if not self._running or (self._draining
                                         and self._queued_total == 0):
                    return
                picked = self._pop_batch_locked()
                if picked is None:
                    continue
                key, reqs = picked
                self._inflight += 1
            try:
                self._run_requests(key, reqs)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._brownout.tick_locked(self._pressure_locked(),
                                               time.monotonic())
                    self._cond.notify_all()

    def _pop_batch_locked(self) -> Optional[tuple]:
        """Deadline-aware pick: drain the queue whose HEAD is most
        urgent (earliest absolute deadline, FIFO within a queue), then
        coalesce whole requests up to the batch row cap."""
        best_key = None
        best_rank: Tuple[float, float] = (float("inf"), float("inf"))
        for key, q in self._queues.items():
            if not q:
                continue
            head = q[0]
            rank = (head.deadline_t if head.deadline_t is not None
                    else float("inf"), head.enqueue_t)
            if rank < best_rank:
                best_rank, best_key = rank, key
        if best_key is None:
            return None
        q = self._queues[best_key]
        cap = self._max_batch_rows()
        # optional coalescing window: let a micro-batch form behind a
        # lone head before dispatching (skipped when draining — flush
        # beats batching on the way down)
        wait = knobs.get_float("PYRUHVRO_TPU_SERVE_COALESCE_S")
        if (wait and wait > 0 and not self._draining and len(q) == 1
                and q[0].coalescable and q[0].n_rows < cap):
            self._cond.wait(wait)
            q = self._queues.get(best_key)
            if q is None or not q:
                return None
        reqs: List[_Request] = [q.popleft()]
        rows = reqs[0].n_rows
        while (q and reqs[0].coalescable and q[0].coalescable
               and rows + q[0].n_rows <= cap):
            nxt = q.popleft()
            reqs.append(nxt)
            rows += nxt.n_rows
        self._queued_total -= len(reqs)
        for r in reqs:
            n = self._tenant_queued.get(r.tenant_key, 0) - 1
            if n <= 0:
                self._tenant_queued.pop(r.tenant_key, None)
            else:
                self._tenant_queued[r.tenant_key] = n
        self._cond.notify_all()  # wake block-policy space waiters
        return best_key, reqs

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _run_requests(self, key: tuple, reqs: List[_Request]) -> None:
        now = time.monotonic()
        live: List[_Request] = []
        for r in reqs:
            if r.deadline_t is not None and now >= r.deadline_t:
                # expired while queued: shed WITHOUT running the decode
                metrics.inc("serve.expired")
                self._resolve(r, exc=deadline.DeadlineExceeded(
                    "expired in serving queue",
                    op="serve." + r.op, budget_s=r.timeout_s,
                    elapsed_s=now - r.enqueue_t, site="serve_queue"))
            else:
                live.append(r)
        if not live:
            return
        metrics.inc("serve.batches")
        if len(live) > 1:
            br = breaker.get("serve_worker")
            if br.acquire():
                try:
                    self._exec_coalesced(key, live)
                    br.record_success()
                    metrics.inc("serve.coalesced", float(len(live)))
                    return
                except deadline.DeadlineExceeded as e:
                    now = time.monotonic()
                    survivors = [r for r in live
                                 if r.deadline_t is None
                                 or now < r.deadline_t]
                    for r in live:
                        if r not in survivors:
                            self._resolve(r, exc=e)
                    if survivors:
                        # the batch died while members still had
                        # budget: the wedged-batch signature (an
                        # injected hang, a stalled tier) — trip the
                        # breaker, drain survivors to the serial path
                        br.record_failure()
                        metrics.inc("serve.worker_degraded")
                    live = survivors
                except Exception as e:  # noqa: BLE001 — classified below
                    # a counter and a breaker verdict only: every member
                    # re-runs on its own backend and card below
                    if _degradable(e):
                        br.record_failure()
                        metrics.inc("serve.worker_degraded")
                    else:
                        # a data error poisons a coalesced batch; the
                        # serial path isolates it to the guilty
                        # request(s)
                        metrics.inc("serve.batch_isolate")
            else:
                metrics.inc("serve.breaker_serial")
        for r in live:
            self._exec_serial(r)

    def _exec_coalesced(self, key: tuple, reqs: List[_Request]) -> None:
        """One API call for the whole micro-batch, bounded by the
        tightest member deadline AND the batch stall watchdog; the
        chaos seam fires inside the bound so an injected hang is
        indistinguishable from a stalled tier."""
        op, fp, tenant_key, on_error, backend, _dev = key
        from .. import api

        r0 = reqs[0]
        now = time.monotonic()
        budget = knobs.get_float("PYRUHVRO_TPU_SERVE_BATCH_TIMEOUT_S")
        budget = budget if budget and budget > 0 else None
        tight = min((r.deadline_t for r in reqs
                     if r.deadline_t is not None), default=None)
        if tight is not None:
            rem = max(0.0, tight - now)
            budget = rem if budget is None else min(budget, rem)
        combined: List[bytes] = []
        for r in reqs:
            combined.extend(r.data)
        with deadline.scope(budget, op="serve.batch"):
            faults.fire("serve_worker")
            batch, quar = api.deserialize_array(
                combined, self._schemas[key], backend=backend,
                device=r0.device, on_error=on_error, return_errors=True,
                timeout_s=None,
                tenant=None if tenant_key == "-" else tenant_key,
                trace_ctx=r0.trace_ctx)
        self._note_spr(op, fp, len(combined), time.monotonic() - now)
        self._split_decode(reqs, batch, quar)

    def _split_decode(self, reqs: List[_Request], batch, quar) -> None:
        """Slice the coalesced result back per request and re-base
        quarantine indices to each caller's OWN record indices."""
        import pyarrow as pa

        total = sum(r.n_rows for r in reqs)
        preserved = batch.num_rows == total  # raise/null keep rows
        # pyarrow's zero-copy slice is value-corrupting on union
        # columns at non-zero offsets (the type_ids offset is dropped
        # in conversions) — for union-bearing schemas, materialize the
        # split with take() instead
        gather = _schema_has_union(batch.schema)
        qs = sorted(quar, key=lambda q: q.index)
        base = 0
        out_off = 0
        qpos = 0
        for r in reqs:
            mine = []
            while qpos < len(qs) and qs[qpos].index < base + r.n_rows:
                mine.append(qs[qpos])
                qpos += 1
            local = _quarantine.rebase(mine, -base)
            keep = r.n_rows if preserved else r.n_rows - len(mine)
            if gather and out_off:
                sl = batch.take(pa.array(
                    range(out_off, out_off + keep), type=pa.int64()))
            else:
                sl = batch.slice(out_off, keep)
            out_off += keep
            self._resolve(r, result=(sl, local) if r.return_errors
                          else sl)
            base += r.n_rows

    def _exec_serial(self, r: _Request) -> None:
        """The surviving path: one direct API call per request —
        byte-identical to what the caller would have gotten from the
        one-shot API, still under the from-enqueue deadline."""
        from .. import api

        metrics.inc("serve.serial_calls")
        t0 = time.monotonic()
        try:
            kw = dict(backend=r.backend, device=r.device,
                      on_error=r.on_error,
                      return_errors=r.return_errors,
                      timeout_s=r.remaining(), tenant=r.tenant,
                      trace_ctx=r.trace_ctx)
            if r.op == "decode":
                res = api.deserialize_array(r.data, r.schema, **kw)
            else:
                res = api.serialize_record_batch(
                    r.data, r.schema, r.num_chunks, **kw)
        except BaseException as e:  # noqa: BLE001 — future carries it
            self._resolve(r, exc=e)
            return
        self._note_spr(r.op, r.fp, r.n_rows, time.monotonic() - t0)
        self._resolve(r, result=res)

    def _note_spr(self, op: str, fp: str, rows: int,
                  seconds: float) -> None:
        if rows <= 0 or seconds <= 0:
            return
        spr = seconds / rows
        with self._cond:
            prev = self._spr.get((op, fp))
            self._spr[(op, fp)] = (spr if prev is None
                                   else 0.8 * prev + 0.2 * spr)

    def _resolve(self, r: _Request, result=None, exc=None) -> None:
        """The single terminal gate: every accepted request passes here
        EXACTLY once (double resolution would double-answer a caller;
        the guard makes the zero-loss invariant checkable)."""
        with self._cond:
            if r.done:
                metrics.inc("serve.double_resolve")  # should stay 0
                return
            r.done = True
            if exc is None:
                self._completed += 1
            else:
                self._failed += 1
            if self._draining:
                self._drained += 1
                metrics.inc("serve.drained")
            self._cond.notify_all()
        e2e = time.monotonic() - r.enqueue_t
        if exc is None:
            metrics.inc("serve.completed")
            r.future.set_result(result)
        else:
            metrics.inc("serve.failed")
            r.future.set_exception(exc)
        telemetry.observe("serve.e2e_s", e2e)
        slo.record_root("serve.request", r.fp, e2e,
                        error=exc is not None)

    # ------------------------------------------------------------------
    # drain / shutdown
    # ------------------------------------------------------------------

    def drain(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Zero-loss graceful shutdown: stop intake, flush every queued
        request to a terminal state, stop the workers, restore the
        brownout overrides and flush telemetry/profile saves. Every
        accepted request completes or fails STRUCTURED — none silently
        dropped. Idempotent; returns the accounting report."""
        t0 = time.monotonic()
        with self._cond:
            already = self._closed
            self._draining = True
            self._cond.notify_all()
            had_workers = bool(self._threads)
        if not already:
            metrics.inc("serve.drain")
        until = t0 + timeout_s if timeout_s is not None else None
        if not had_workers:
            # no workers were ever started (tests; a plane built with
            # autostart=False): flush inline, serially
            while True:
                with self._cond:
                    picked = self._pop_batch_locked()
                if picked is None:
                    break
                self._run_requests(*picked)
        with self._cond:
            while self._queued_total > 0 or self._inflight > 0:
                if until is not None and time.monotonic() >= until:
                    break
                self._cond.wait(0.1)
            self._running = False
            self._cond.notify_all()
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=5.0)
        # a timed-out drain still resolves the leftovers — structured,
        # never silent
        leftovers: List[_Request] = []
        with self._cond:
            for key, q in self._queues.items():
                while q:
                    r = q.popleft()
                    leftovers.append(r)
            self._queued_total = 0
            self._tenant_queued.clear()
        for r in leftovers:
            metrics.inc("serve.drain_aborted")
            self._resolve(r, exc=Overloaded(
                "drain timed out before this request ran",
                reason="drain_aborted", tenant=r.tenant))
        with self._cond:
            self._brownout.release_all()
            self._closed = True
            self._draining = False
        _flush_saves()
        telemetry.observe("serve.drain_s", time.monotonic() - t0)
        return self.report()

    def report(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "accepted": self._accepted,
                "shed": self._shed,
                "completed": self._completed,
                "failed": self._failed,
                "drained": self._drained,
                "queued": self._queued_total,
                "inflight": self._inflight,
                "closed": self._closed,
            }

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._cond:
            depth = self._depth()
            queues = [{
                "op": key[0], "schema": key[1], "tenant": key[2],
                "on_error": key[3], "backend": key[4], "device": key[5],
                "queued": len(q), "depth": depth,
            } for key, q in sorted(self._queues.items()) if q]
            doc = {
                "active": not self._closed,
                "policy": self._policy(),
                "workers": self._workers,
                "queue_depth": depth,
                "queued": self._queued_total,
                "inflight": self._inflight,
                "pressure": round(self._pressure_locked(), 4),
                "accepted": self._accepted,
                "shed": self._shed,
                "completed": self._completed,
                "failed": self._failed,
                "drained": self._drained,
                "draining": self._draining,
                "queues": queues,
                "tenants_queued": dict(self._tenant_queued),
                "brownout": {
                    "engaged": list(self._brownout.engaged()),
                    "occupancy_s": {
                        k: round(v, 4) for k, v in
                        self._brownout.occupancy().items()},
                },
            }
        return doc

    def engaged_rungs(self) -> Tuple[str, ...]:
        with self._cond:
            return self._brownout.engaged()


# ---------------------------------------------------------------------------
# flood-tenant detection (heavy-hitter sketch, cached briefly)
# ---------------------------------------------------------------------------

_flood_lock = threading.Lock()
_flood_memo: Tuple[float, frozenset] = (0.0, frozenset())  # guarded-by: _flood_lock
_FLOOD_TTL_S = 0.25


def _flood_tenants() -> frozenset:
    """Tenants holding more than the fairness share of all attributed
    bytes in the heavy-hitter sketch — the brownout ladder's
    shed set. Cached briefly: this runs on the admission path."""
    global _flood_memo
    now = time.monotonic()
    with _flood_lock:
        ts, memo = _flood_memo
        if now - ts <= _FLOOD_TTL_S:
            return memo
    share = knobs.get_float("PYRUHVRO_TPU_SERVE_TENANT_SHARE")
    share = share if share and share > 0 else 0.5
    rows = memacct.tenant_hotlist()
    # weight by attributed bytes; rows when no payload was ever sized
    # (the sketch can't size opaque inputs)
    field = ("bytes" if any(row["bytes"] for row in rows) else "rows")
    per_tenant: Dict[str, float] = {}
    for row in rows:
        per_tenant[row["tenant"]] = (per_tenant.get(row["tenant"], 0.0)
                                     + row[field])
    total = sum(per_tenant.values())
    floods = frozenset(t for t, b in per_tenant.items()
                       if t != "-" and total > 0 and b / total > share)
    with _flood_lock:
        _flood_memo = (now, floods)
    return floods


# ---------------------------------------------------------------------------
# drain-time persistence flush
# ---------------------------------------------------------------------------


def _flush_saves() -> None:
    """Drain-time flush of everything that persists: the learned
    routing profile (only when persistence was armed — never creating
    files nobody asked for) and a flight-recorder dump (only when
    ``PYRUHVRO_TPU_FLIGHT_DIR`` is configured). Best-effort and
    counted: a failed flush must never fail the drain."""
    try:
        if costmodel.persistence_armed():
            costmodel.save_profile()
    except Exception:  # noqa: BLE001 — drain must complete
        metrics.inc("serve.flush_error")
    try:
        telemetry._flight_autodump("serve_drain")
    except Exception:  # noqa: BLE001
        metrics.inc("serve.flush_error")


# ---------------------------------------------------------------------------
# module-level singleton + helpers
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_plane: Optional[ServePlane] = None  # guarded-by: _lock


def start(**kw) -> ServePlane:
    """Start (or return) the process-wide serving plane."""
    global _plane
    with _lock:
        if _plane is None or _plane.report()["closed"]:
            _plane = ServePlane(**kw)
            metrics.inc("serve.plane_started")
    return _plane


def plane() -> Optional[ServePlane]:
    return _plane


def stop(timeout_s: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """Drain and discard the process-wide plane."""
    global _plane
    with _lock:
        p, _plane = _plane, None
    return p.drain(timeout_s=timeout_s) if p is not None else None


def engaged_rungs() -> Tuple[str, ...]:
    """Currently-engaged brownout rungs (the /healthz degraded bit);
    empty when no plane is running."""
    p = _plane
    return p.engaged_rungs() if p is not None else ()


def snapshot_serving() -> Dict[str, Any]:
    """The ``serving`` section of ``telemetry.snapshot()`` — empty dict
    when no plane ever started (snapshots stay shape-compatible)."""
    p = _plane
    return p.snapshot() if p is not None else {}


def reset() -> None:
    """Test isolation: hard-stop any plane, resolving still-pending
    requests structured, and restore every brownout override."""
    global _plane
    with _lock:
        p, _plane = _plane, None
    if p is not None:
        p.drain(timeout_s=0.0)
    # restore overrides even if a test used a private plane and leaked
    # an engaged rung
    _audit.set_enabled(None)
    _sampling.set_enabled(None)
    costmodel.set_explore_override(None)
    with _flood_lock:
        global _flood_memo
        _flood_memo = (0.0, frozenset())


# ---------------------------------------------------------------------------
# SIGTERM/SIGINT graceful drain
# ---------------------------------------------------------------------------

# bumped from signal context (increment-only; flushed on the drainer
# thread) — the one counter allowed inside a handler
_signal_drains = metrics.DeferredCount("serve.signal_drain")
# lock-free-ok(main-thread-only install flag — signal.signal itself
# enforces main-thread, so there is no racing writer)
_drain_signal_installed = False


def install_drain_signal(exit_after: bool = True) -> bool:
    """Arm zero-loss drain on SIGTERM/SIGINT. The handler itself only
    bumps a :class:`DeferredCount` and sets an Event (signal-safe); a
    pre-spawned waiter thread performs the actual drain + flush. With ``exit_after`` (the service default) the
    original disposition is restored and the signal re-raised once the
    drain completes, so the process still terminates; tests pass
    ``exit_after=False`` and assert on the drained plane. Returns False
    off the main thread."""
    global _drain_signal_installed
    if _drain_signal_installed:
        return True
    import signal

    fired = threading.Event()
    received: List[int] = []
    prev = {s: signal.getsignal(s)
            for s in (signal.SIGTERM, signal.SIGINT)}

    def handler(signum, frame):
        _signal_drains.bump()
        received.append(signum)
        fired.set()

    def drainer():
        fired.wait()
        _signal_drains.flush()  # normal thread: safe to take the lock
        try:
            stop(timeout_s=30.0)
        finally:
            if exit_after and received:
                import os as _os

                signum = received[-1]
                try:
                    signal.signal(signum, prev.get(signum,
                                                   signal.SIG_DFL))
                except (ValueError, TypeError):
                    pass
                _os.kill(_os.getpid(), signum)

    try:
        for s in (signal.SIGTERM, signal.SIGINT):
            signal.signal(s, handler)
    except ValueError:  # not the main thread
        return False
    threading.Thread(target=drainer, name="pyruhvro-serve-drain",
                     daemon=True).start()
    _drain_signal_installed = True
    return True


# ---------------------------------------------------------------------------
# serve-report renderer (the telemetry CLI subcommand)
# ---------------------------------------------------------------------------


def render_serve_report(snap: Dict[str, Any]) -> str:
    """Text report of the ``serving`` section of a saved snapshot.
    Legacy snapshots (pre-serving-plane) degrade to a note, matching
    every other report subcommand."""
    out: List[str] = ["== serving plane =="]
    sv = snap.get("serving")
    counters = snap.get("counters") or {}
    if not sv:
        out.append("no serving section in this snapshot (predates the "
                   "serving plane, or no plane ran)")
        shed = counters.get("serve.shed")
        if shed:
            out.append(f"(counters still show {shed:.0f} shed "
                       "request(s))")
        return "\n".join(out) + "\n"
    out.append(
        f"policy {sv.get('policy')}, {sv.get('workers')} worker(s), "
        f"queue depth {sv.get('queue_depth')}, "
        f"{'active' if sv.get('active') else 'closed'}")
    out.append(
        f"accepted {sv.get('accepted', 0)}  shed {sv.get('shed', 0)}  "
        f"completed {sv.get('completed', 0)}  "
        f"failed {sv.get('failed', 0)}  drained {sv.get('drained', 0)}")
    out.append(f"queued {sv.get('queued', 0)} "
               f"(pressure {sv.get('pressure', 0):.2f}), "
               f"inflight {sv.get('inflight', 0)}")
    sheds = {k: v for k, v in counters.items()
             if k.startswith("serve.shed.")}
    if sheds:
        out.append("shed by reason:")
        out.extend(f"  {k[len('serve.shed.'):]:<18} {v:>10.0f}"
                   for k, v in sorted(sheds.items()))
    bo = sv.get("brownout") or {}
    engaged = bo.get("engaged") or []
    occ = bo.get("occupancy_s") or {}
    out.append(f"brownout rungs engaged: {', '.join(engaged) or 'none'}")
    hot = {k: v for k, v in occ.items() if v}
    if hot:
        out.extend(f"  {k:<10} {v:>9.3f}s occupied"
                   for k, v in sorted(hot.items()))
    queues = sv.get("queues") or []
    if queues:
        out.append(f"{len(queues)} non-empty queue(s):")
        for q in queues[:16]:
            out.append(
                f"  {q['op']:<6} {q['schema'][:16]:<16} "
                f"tenant={q['tenant']:<10} {q['queued']}/{q['depth']}")
    hists = snap.get("histograms") or {}
    e2e = hists.get("serve.e2e_s")
    if e2e:
        out.append(
            f"e2e latency: p50 {e2e.get('p50', 0) * 1e3:.2f} ms  "
            f"p99 {e2e.get('p99', 0) * 1e3:.2f} ms  "
            f"({e2e.get('count', 0):.0f} request(s))")
    return "\n".join(out) + "\n"
