"""Optional Arrow Flight front end for the serving plane (copy of
``pyruhvro_tpu/serving/flight.py``, whole but the departures at the
end).

The wire contract is deliberately tiny:

* **DoPut** — the descriptor ``command`` is a JSON document
  ``{"schema": <avro schema json>, "tenant": ..., "traceparent": ...,
  "timeout_s": ...}`` and the uploaded stream is record batches with a
  single binary column (any name) of Avro wire bytes. The handler
  submits the rows to the process serving plane (starting it on
  demand) and writes back one metadata message: the ticket (a UTF-8
  token) under which the decode result is retrievable.
* **DoGet** — exchanging that ticket returns the decoded Arrow
  ``RecordBatch`` stream, or raises ``FlightServerError`` carrying the
  structured failure (``Overloaded`` rejections include the
  ``retry_after_s`` hint in the message).

``tenant`` feeds per-tenant accounting/admission and ``traceparent``
joins the fleet trace exactly as the one-shot API's ``trace_ctx``
would. Everything here degrades: without ``pyarrow.flight`` in the
environment, :func:`start_flight_server` is a counted
(``serve.flight_unavailable``) no-op returning ``None`` — the rest of
the serving plane is unaffected. The ``serve_flight`` chaos seam fires
in both handlers; degradable faults fail ONLY the affected RPC with a
structured Flight error, never the server.

Departures (``ROADMAP.md`` (c) 11): the spec's ``backend`` defaults to
``"device"`` (the reference's to ``"auto"``) and a ``device`` key
(default ``"cuda"``) picks the card, as the API's keywords do; the
failure shaping counts ``serve.flight_degraded`` by the serving plane's
private copy of the reference's taxonomy (:func:`._degradable`), since
the port has no ``faults.degradable``.
"""

from __future__ import annotations

import json
import threading
import uuid
from typing import Any, Dict, Optional

from ..runtime import faults, metrics

__all__ = ["flight_available", "start_flight_server", "FlightFrontDoor"]


def flight_available() -> bool:
    try:
        import pyarrow.flight  # noqa: F401
    except Exception:  # noqa: BLE001 — absence is the signal
        return False
    return True


def _make_server_cls():
    import pyarrow as pa
    import pyarrow.flight as fl

    from . import Overloaded, _degradable, start

    class FlightFrontDoor(fl.FlightServerBase):
        """DoPut wire bytes in → DoGet decoded RecordBatch out."""

        def __init__(self, location: str = "grpc://127.0.0.1:0",
                     **server_kw):
            super().__init__(location, **server_kw)
            self._lock = threading.Lock()
            self._pending: Dict[str, Any] = {}  # ticket -> (future, req)

        # -- ingest -------------------------------------------------------

        def do_put(self, context, descriptor, reader, writer):
            metrics.inc("serve.flight_put")
            try:
                faults.fire("serve_flight")
                spec = json.loads(descriptor.command.decode("utf-8"))
                schema = spec["schema"]
                data = []
                for chunk in reader:
                    batch = chunk.data
                    if batch.num_columns != 1:
                        raise ValueError(
                            "DoPut expects one binary column of Avro "
                            "wire bytes")
                    data.extend(batch.column(0).to_pylist())
                fut = start().submit(
                    "decode", data, schema,
                    backend=spec.get("backend", "device"),
                    device=spec.get("device", "cuda"),
                    on_error=spec.get("on_error", "raise"),
                    timeout_s=spec.get("timeout_s"),
                    tenant=spec.get("tenant"),
                    trace_ctx=spec.get("traceparent"))
            except Exception as e:  # noqa: BLE001 — RPC-scoped failure
                self._rpc_fail(e)
            else:
                ticket = uuid.uuid4().hex
                with self._lock:
                    self._pending[ticket] = fut
                writer.write(ticket.encode("utf-8"))

        # -- retrieve -----------------------------------------------------

        def do_get(self, context, ticket):
            metrics.inc("serve.flight_get")
            try:
                faults.fire("serve_flight")
                token = ticket.ticket.decode("utf-8")
                with self._lock:
                    fut = self._pending.pop(token, None)
                if fut is None:
                    raise KeyError(f"unknown ticket {token!r}")
                batch = fut.result()
            except Exception as e:  # noqa: BLE001 — RPC-scoped failure
                self._rpc_fail(e)
            return fl.RecordBatchStream(
                pa.Table.from_batches([batch]))

        # -- failure shaping ---------------------------------------------

        @staticmethod
        def _rpc_fail(e: BaseException) -> None:
            if _degradable(e):
                metrics.inc("serve.flight_degraded")
            if isinstance(e, Overloaded):
                hint = (f" retry_after_s={e.retry_after_s:.3f}"
                        if e.retry_after_s is not None else "")
                raise fl.FlightUnavailableError(
                    f"overloaded ({e.reason}){hint}")
            raise fl.FlightServerError(
                f"{type(e).__name__}: {e}")

    return FlightFrontDoor


# resolved lazily so importing pyruhvro_tpu_torch.serving.flight never
# pulls grpc; None until first successful _make_server_cls()
# lock-free-ok(idempotent memo of a pure class object — racing writers
# store the same value; readers see None or the class, never torn state)
FlightFrontDoor = None


def start_flight_server(location: str = "grpc://127.0.0.1:0",
                        **server_kw) -> Optional[Any]:
    """Start the Flight front door, or count+skip when the optional
    ``pyarrow.flight`` extra is missing (the documented degrade: the
    plane still serves the in-process and HTTP surfaces)."""
    global FlightFrontDoor
    if not flight_available():
        metrics.inc("serve.flight_unavailable")
        return None
    if FlightFrontDoor is None:
        FlightFrontDoor = _make_server_cls()
    server = FlightFrontDoor(location, **server_kw)
    metrics.inc("serve.flight_started")
    return server
