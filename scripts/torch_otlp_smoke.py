#!/usr/bin/env python
"""OTLP trace round-trip smoke of the port (counterpart of
``scripts/otlp_smoke.py``).

Stands up a local stub OTLP/HTTP collector (stdlib HTTP server on
127.0.0.1 recording every ``/v1/traces`` + ``/v1/metrics`` POST),
injects a W3C ``traceparent`` via the ``PYRUHVRO_TPU_TRACEPARENT`` env
knob, and runs, in a fresh subprocess with the exporter enabled
(``PYRUHVRO_TPU_OTLP_ENDPOINT``), a chunked decode on the card
(``--device``, default ``cuda``) and a SPAWN-POOL chunked decode on the
host tier (the pool serves ``backend="host"`` only). Asserts:

* the collector received exactly ONE trace id — the injected one: the
  API root span joined the ingress context, and every process-pool
  chunk span re-parented under it (no synthetic per-pid roots);
* the ``pool.worker`` chunk spans are present with parents, i.e. the
  context crossed the spawn boundary;
* the metrics POSTs carry the counter sums and histogram exemplars
  whose trace id is, again, the injected one;
* a quarantined row (tolerant decode leg, on the card) carries the
  injected trace id end-to-end.

Exit 0 = all assertions hold; any failure raises. Usage::

    python scripts/torch_otlp_smoke.py [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_soaklib as soak  # noqa: E402

REPO = str(soak.REPO)

TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"  # the W3C spec example
PARENT_SPAN = "00f067aa0ba902b7"
TRACEPARENT = f"00-{TRACE_ID}-{PARENT_SPAN}-01"

_WORKLOAD = r"""
import json, sys
import pyruhvro_tpu_torch as p
from pyruhvro_tpu_torch.runtime import otel
from pyruhvro_tpu_torch.utils.datagen import (
    KAFKA_SCHEMA_JSON as K, kafka_style_datums)

device = sys.argv[1]
datums = kafka_style_datums(2000, seed=13)
p.deserialize_array_threaded(datums, K, 4, device=device)
p.deserialize_array_threaded(datums, K, 4, backend="host")
bad = list(datums)
bad[7] = bad[7][:2]
batch, errs = p.deserialize_array_threaded(
    bad, K, 4, device=device, on_error="skip", return_errors=True)
if not errs:
    raise SystemExit("expected a quarantined row")
print(json.dumps({"quarantine_trace": errs[0].trace_id}))
otel.stop()  # final flush before exit
"""


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = soak.parser(__doc__, "otlp_smoke.json").parse_args(argv)
    card = soak.card(args.device)
    reqs = []

    class Collector(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            reqs.append((self.path, json.loads(self.rfile.read(n))))
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(b"{}")

        def log_message(self, *a):  # noqa: N802 — http.server hook
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Collector)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    endpoint = f"http://127.0.0.1:{srv.server_address[1]}"
    _log(f"[otlp-smoke] stub collector at {endpoint}")

    env = dict(
        os.environ,
        PYRUHVRO_TPU_POOL="process",
        PYRUHVRO_TPU_TRACEPARENT=TRACEPARENT,
        PYRUHVRO_TPU_OTLP_ENDPOINT=endpoint,
        PYRUHVRO_TPU_OTLP_INTERVAL_S="0.5",
    )
    out = subprocess.run([sys.executable, "-c", _WORKLOAD, args.device],
                         capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=600)
    srv.shutdown()
    if out.returncode != 0:
        _log(out.stdout)
        _log(out.stderr)
        raise SystemExit(f"workload failed rc={out.returncode}")

    # the quarantined row carried the ingress trace id end-to-end
    q = json.loads(out.stdout.strip().splitlines()[-1])
    if q["quarantine_trace"] != TRACE_ID:
        raise soak.Divergence(q)
    _log("[otlp-smoke] quarantined row carries the injected trace id")

    spans = [s
             for path, body in reqs if path.endswith("/v1/traces")
             for rs in body["resourceSpans"]
             for ss in rs["scopeSpans"]
             for s in ss["spans"]]
    if not spans:
        raise soak.Divergence("collector saw no spans")
    trace_ids = {s["traceId"] for s in spans}
    if trace_ids != {TRACE_ID}:
        raise soak.Divergence(trace_ids)
    roots = [s for s in spans
             if s["name"] == "api.deserialize_array_threaded"]
    if not roots or any(s.get("parentSpanId") != PARENT_SPAN
                        for s in roots):
        raise soak.Divergence(roots)
    workers = [s for s in spans if s["name"] == "pool.worker"]
    if len(workers) < 4:
        raise soak.Divergence([s["name"] for s in spans])
    if not all(s.get("parentSpanId") for s in workers):
        raise soak.Divergence(workers)
    _log(f"[otlp-smoke] {len(spans)} spans, single trace {TRACE_ID}, "
         f"{len(workers)} pool.worker chunk spans re-parented")

    metrics_posts = [body for path, body in reqs
                     if path.endswith("/v1/metrics")]
    if not metrics_posts:
        raise soak.Divergence("collector saw no metrics")
    mets = [m
            for body in metrics_posts
            for rm in body["resourceMetrics"]
            for sm in rm["scopeMetrics"]
            for m in sm["metrics"]]
    names = {m["name"] for m in mets}
    if "pool.proc_chunks" not in names:
        raise soak.Divergence(sorted(names))
    exemplars = [e
                 for m in mets if "histogram" in m
                 for dp in m["histogram"]["dataPoints"]
                 for e in dp.get("exemplars", [])]
    if not exemplars or any(e["traceId"] != TRACE_ID for e in exemplars):
        raise soak.Divergence(exemplars[:3])
    _log(f"[otlp-smoke] {len(names)} metric families, "
         f"{len(exemplars)} exemplars carry the injected trace id")
    card_spans = [s for s in spans if s["name"].startswith("device.")]
    if args.device != "cpu":
        if not card_spans:
            raise soak.Divergence("no device span reached the collector")
    doc = {"metric": "otlp_smoke", "pass": True, "card": card,
           "spans": len(spans), "device_spans": len(card_spans),
           "workers": len(workers), "metric_families": len(names)}
    soak.write_report(args.out, doc)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
