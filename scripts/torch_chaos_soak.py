#!/usr/bin/env python
"""Chaos soak of the port on the card (counterpart of
``scripts/chaos_soak.py``).

Every (seam x kind) cell of ``pyruhvro_tpu_torch/runtime/faults.py``
(``error`` and ``hang``; ``exit`` at ``pool_worker``) through the public
API, the decode seams under every ``on_error`` policy, with a deadline
(``hang``: 2 s) and without (``error``). The invariants per cell follow
the port's contract (``ROADMAP.md`` (c) 4, 7, 9 and 11), where the
reference's expect a degraded serve:

* the device seams (``device_compile``, ``device_launch``, ``h2d``) and
  the native ones (``native_build``, ``vm_decode``, ``shard_worker``,
  ``native_extract``) raise ``FaultInjected`` into the call (or, under a
  deadline, ``DeadlineExceeded``), never a quiet serve by the host tier
  or the oracle: a cell whose call returns must equal the healthy call
  and count no route to another tier;
* the best-effort and observer seams (``profile_save``,
  ``profile_load``, ``flight_dump``, ``slo_alert``, ``audit_shadow``,
  ``obs_handler``, ``incident_capture``) count their failure and leave
  the call's result as it was;
* the serving seams keep the reference's degraded paths on the same
  backend and card: ``serve_enqueue`` serves by a direct call,
  ``serve_worker`` drains a coalesced batch to the per-request serial
  path, byte-identical, and ``serve_flight`` fails one Flight RPC;
* ``pool_worker:exit`` kills a spawned worker: the call is served on the
  parent's shard arm and the ``process_pool`` breaker opens;
* no hang (a ``faulthandler`` watchdog over the whole run; a bounded
  cell returns inside its budget), no crash, no exception outside
  ``FaultInjected`` / ``DeadlineExceeded`` / ``MalformedAvro``;
* recovery: after the spec clears, every breaker-owned seam the port
  kept (``serve_worker``, ``process_pool``) re-admits its arm.

Each cell is a record of the ledger (the spec string alone replays it:
injection is counter-based). Usage::

    python scripts/torch_chaos_soak.py [--rounds 3] [--skip-pool]
        [--device cuda|cpu] [--out FILE]

Exit 1 on any invariant violation.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import traceback
import urllib.error
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_soaklib as soak  # noqa: E402

WATCHDOG_S = 600  # any wedged cell dumps all stacks and kills the run
DEADLINE_S = 2.0  # the hang cells' per-call budget
POLICIES = ("raise", "skip", "null")
ROWS = 400
DEV_ROWS = 64

DEV_SCHEMA = {
    "type": "record", "name": "ChaosSoak",
    "fields": [
        {"name": "a", "type": "long"},
        {"name": "b", "type": "string"},
        {"name": "c", "type": {"type": "array", "items": "int"}},
    ],
}


def schema_of(base, doc: str) -> str:
    """``base`` (a schema string or dict) under a doc of its own: a fresh
    schema entry, codec and bucket, so a first launch or a first native
    load happens in the cell."""
    d = json.loads(base) if isinstance(base, str) else dict(base)
    d["doc"] = doc
    return json.dumps(d)


def host_routed(counters) -> list:
    """The counters that would say a card call reached another tier."""
    return sorted(k for k in counters if k.startswith((
        "route.native", "route.fallback", "route.host",
        "device.host_answer")))


class Cell:
    """One matrix cell: run ``fn`` under ``site:kind:1``, classify the
    outcome, append the record to the ledger."""

    def __init__(self, ledger, site, kind, op, policy="-", deadline_s=None):
        self.ledger = ledger
        self.rec = {"site": site, "kind": kind, "op": op, "policy": policy,
                    "deadline_s": deadline_s, "spec": f"{site}:{kind}:1"}

    def run(self, fn, check=None, expect_raise=False) -> bool:
        """``check(out)`` must hold when the call returns; under
        ``expect_raise`` the seam must raise a structured error (an
        ``error`` fault of a seam that raises in the port)."""
        from pyruhvro_tpu_torch import MalformedAvro
        from pyruhvro_tpu_torch.runtime import faults, metrics
        from pyruhvro_tpu_torch.runtime.deadline import DeadlineExceeded
        from pyruhvro_tpu_torch.runtime.faults import FaultInjected

        faults.reset()
        c0 = metrics.snapshot()
        os.environ["PYRUHVRO_TPU_FAULTS"] = self.rec["spec"]
        budget = self.rec["deadline_s"]
        t0 = time.monotonic()
        ok, outcome, err = True, None, None
        try:
            out = fn()
            outcome = "served"
            if expect_raise:
                ok, outcome = False, "SERVED_WHERE_IT_MUST_RAISE"
            elif check is not None and not check(out):
                ok, outcome = False, "WRONG_OUTPUT"
        except (FaultInjected, DeadlineExceeded, MalformedAvro) as e:
            outcome, err = "structured_error", type(e).__name__
            if isinstance(e, DeadlineExceeded) and budget is None:
                ok, outcome = False, "UNEXPECTED_DEADLINE"
        except Exception as e:  # noqa: BLE001 — the invariant breaker
            ok, outcome, err = False, "UNSTRUCTURED_ERROR", repr(e)
            traceback.print_exc()
        finally:
            os.environ["PYRUHVRO_TPU_FAULTS"] = ""
        dt = time.monotonic() - t0
        if budget is not None and dt > budget + 1.0 + 10.0:
            ok, outcome = False, "OVERRAN_BUDGET"
        c1 = metrics.snapshot()
        routed = [k for k in host_routed(c1) if c1[k] != c0.get(k, 0)]
        if self.rec["op"].startswith("card") and routed:
            ok, outcome = False, f"REACHED_ANOTHER_TIER {routed}"
        self.rec.update({
            "outcome": outcome, "error": err, "wall_s": round(dt, 4),
            "injected": c1.get("fault.injected." + self.rec["site"], 0.0),
            "pass": ok})
        self.ledger.append(self.rec)
        print(f"[{'ok' if ok else 'FAIL'}] {self.rec['site']}:"
              f"{self.rec['kind']} op={self.rec['op']} policy="
              f"{self.rec['policy']} dl={budget} -> {outcome} ({dt:.2f}s)",
              flush=True)
        return ok


def recover(name: str) -> bool:
    """After the spec cleared: the named breaker re-admits its seam
    (closed already, or half-open so that the next probe closes it)."""
    from pyruhvro_tpu_torch.runtime import breaker

    br = breaker.get(name)
    until = time.monotonic() + 10.0
    while time.monotonic() < until:
        if br.state() in ("closed", "half_open"):
            return True
        time.sleep(0.05)
    print(f"[FAIL] breaker {name} stuck {br.state()} after the fault "
          f"cleared", flush=True)
    return False


def decode_cells(ledger, p, kind, dl, rnd, device, data, bad, ref,
                 dev_data, dev_ref, kafka) -> bool:
    """The seams of a decode or encode call: native and device."""
    from pyruhvro_tpu_torch.hostpath.codec import NativeHostCodec

    ok = True
    skip_rows = (ref.num_rows - 3, ref.num_rows)
    for policy in POLICIES:
        corpus = data if policy == "raise" else bad

        def check(out, po=policy):
            return out.equals(ref) if po == "raise" else \
                out.num_rows in skip_rows

        ok &= Cell(ledger, "vm_decode", kind, "host_decode", policy,
                   dl).run(
            lambda c=corpus, po=policy: p.deserialize_array(
                c, kafka, backend="host", on_error=po, timeout_s=dl),
            check, expect_raise=kind == "error")
        for site in ("device_compile", "device_launch", "h2d"):
            schema = schema_of(DEV_SCHEMA, f"{site}-{kind}-{policy}-{rnd}")
            ok &= Cell(ledger, site, kind, "card_decode", policy, dl).run(
                lambda s=schema, po=policy: p.deserialize_array(
                    dev_data, s, device=device, on_error=po, timeout_s=dl),
                lambda out: out.equals(dev_ref),
                expect_raise=kind == "error")
        schema = schema_of(kafka, f"native_build-{kind}-{policy}-{rnd}")
        ok &= Cell(ledger, "native_build", kind, "host_decode", policy,
                   dl).run(
            lambda s=schema, c=corpus, po=policy: p.deserialize_array(
                c, s, backend="host", on_error=po, timeout_s=dl),
            check, expect_raise=kind == "error")
    ok &= Cell(ledger, "vm_decode", kind, "host_decode_threaded", "raise",
               dl).run(
        lambda: p.deserialize_array_threaded(data, kafka, 4,
                                             backend="host", timeout_s=dl),
        lambda out: sum(b.num_rows for b in out) == len(data),
        expect_raise=kind == "error")
    chunk = NativeHostCodec._PER_CHUNK_ROWS
    NativeHostCodec._PER_CHUNK_ROWS = 64  # the one-call shard fan-out
    try:
        ok &= Cell(ledger, "shard_worker", kind, "host_decode_threaded",
                   "raise", dl).run(
            lambda: p.deserialize_array_threaded(
                data, kafka, 4, backend="host", timeout_s=dl),
            lambda out: sum(b.num_rows for b in out) == len(data),
            expect_raise=kind == "error")
        ok &= Cell(ledger, "shard_worker", kind, "host_encode_threaded",
                   "raise", dl).run(
            lambda: p.serialize_record_batch(ref, kafka, 4,
                                             backend="host", timeout_s=dl),
            lambda out: sum(len(a) for a in out) == len(data),
            expect_raise=kind == "error")
    finally:
        NativeHostCodec._PER_CHUNK_ROWS = chunk
    [enc_ref] = p.serialize_record_batch(ref, kafka, 1, backend="host")
    ok &= Cell(ledger, "native_extract", kind, "host_encode", "raise",
               dl).run(
        lambda: p.serialize_record_batch(ref, kafka, 1, backend="host",
                                         timeout_s=dl)[0],
        lambda out: out.equals(enc_ref), expect_raise=kind == "error")
    dev_wire = p.serialize_record_batch(dev_ref, json.dumps(DEV_SCHEMA), 1,
                                        device=device)[0]
    for site in ("device_compile", "device_launch"):
        schema = schema_of(DEV_SCHEMA, f"enc-{site}-{kind}-{rnd}")
        ok &= Cell(ledger, site, kind, "card_encode", "raise", dl).run(
            lambda s=schema: p.serialize_record_batch(
                dev_ref, s, 1, device=device, timeout_s=dl)[0],
            lambda out: out.equals(dev_wire), expect_raise=kind == "error")
    return ok


def observer_cells(ledger, p, kind, dl, device, data, ref, kafka,
                   tmp) -> bool:
    """The best-effort and observer seams: counted, the call unchanged."""
    from pyruhvro_tpu_torch.runtime import (
        audit,
        costmodel,
        incident,
        metrics,
        obs_server,
        slo,
    )

    ok = True
    prof = os.path.join(tmp, "profile.json")
    costmodel.observe("fp", "decode", 8, "native/c1/shard", 100, 0.01)
    ok &= Cell(ledger, "profile_save", kind, "save_profile", "-", dl).run(
        lambda: costmodel.save_profile(prof),
        lambda out: (out is None) if kind == "error" else out == prof)
    costmodel.save_profile(prof)
    ok &= Cell(ledger, "profile_load", kind, "load_profile", "-", dl).run(
        lambda: costmodel.load_profile(prof),
        lambda out: out is (kind != "error"))

    def counted(key):
        before = metrics.snapshot().get(key, 0)
        return lambda: kind != "error" or \
            metrics.snapshot().get(key, 0) > before

    # flight_dump: a quarantine storm writes a dump; the call survives
    bad = list(data)
    for i in (1, 2, 3):
        bad[i] = b"\xff\xff\xff"
    want = p.deserialize_array(bad, kafka, device=device, on_error="skip")
    os.environ["PYRUHVRO_TPU_FLIGHT_DIR"] = os.path.join(tmp, "flight")
    os.environ["PYRUHVRO_TPU_QUARANTINE_STORM"] = "2"
    try:
        os.makedirs(os.environ["PYRUHVRO_TPU_FLIGHT_DIR"], exist_ok=True)
        seen = counted("flight.dump_error")
        ok &= Cell(ledger, "flight_dump", kind, "card_decode", "skip",
                   dl).run(
            lambda: p.deserialize_array(bad, kafka, device=device,
                                        on_error="skip", timeout_s=dl),
            lambda out: out.equals(want) and seen())
    finally:
        os.environ.pop("PYRUHVRO_TPU_FLIGHT_DIR")
        os.environ.pop("PYRUHVRO_TPU_QUARANTINE_STORM")
    # slo_alert: an unmeetable objective breaches at once; its alert hook
    # fails, the call does not
    path = os.path.join(tmp, "slo.json")
    soak.write_report(path, {"version": 1, "objectives": [{
        "name": "chaos", "op": "decode", "schema": "*",
        "threshold_s": 1e-9, "target": 0.5, "windows_s": [3600],
        "min_calls": 1, "alert_command": "true"}]})
    os.environ["PYRUHVRO_TPU_SLO_FILE"] = path
    try:
        slo.reset()
        seen = counted("slo.alert_error")
        ok &= Cell(ledger, "slo_alert", kind, "card_decode", "raise",
                   dl).run(
            lambda: p.deserialize_array(data, kafka, device=device,
                                        timeout_s=dl),
            lambda out: out.equals(ref) and seen())
    finally:
        os.environ.pop("PYRUHVRO_TPU_SLO_FILE")
        slo.reset()
    # audit_shadow: the shadow through the oracle fails; the primary
    # call's result stands
    audit.force_next()
    seen = counted("audit.shadow_error")
    ok &= Cell(ledger, "audit_shadow", kind, "card_decode", "raise",
               dl).run(
        lambda: p.deserialize_array(data, kafka, device=device,
                                    timeout_s=dl),
        lambda out: out.equals(ref) and seen())
    # obs_handler: a scrape answers 500 (error) or late (hang)
    srv = obs_server.ObsServer(port=0).start()
    try:
        def scrape():
            try:
                with urllib.request.urlopen(srv.url + "/metrics",
                                            timeout=30) as r:
                    return r.status
            except urllib.error.HTTPError as e:
                return e.code
        ok &= Cell(ledger, "obs_handler", kind, "scrape", "-", dl).run(
            scrape, lambda code: code == (500 if kind == "error" else 200))
    finally:
        srv.stop()
    # incident_capture: a failed bundle write is counted; the live call
    # beside it is untouched
    os.environ["PYRUHVRO_TPU_INCIDENT_DIR"] = os.path.join(tmp, "incident")
    try:
        os.makedirs(os.environ["PYRUHVRO_TPU_INCIDENT_DIR"], exist_ok=True)
        seen = counted("incident.capture_failed")

        def capture():
            path = incident.capture_now("chaos_soak")
            return path, p.deserialize_array(data, kafka, device=device)

        def check(pair):
            path, out = pair
            if not out.equals(ref):
                return False
            return (path is None and seen()) if kind == "error" else (
                path is not None and os.path.exists(path))

        ok &= Cell(ledger, "incident_capture", kind, "incident_bundle",
                   "-", dl).run(capture, check)
    finally:
        os.environ.pop("PYRUHVRO_TPU_INCIDENT_DIR")
    return ok


def serve_cells(ledger, p, device, kafka) -> bool:
    """The serving seams: a crashing coalesced batch under the shed
    policy and a wedged one under block, drained to the serial path
    byte-identical; the enqueue bypass; a failed Flight RPC."""
    from pyruhvro_tpu_torch.runtime import breaker, faults, metrics
    from pyruhvro_tpu_torch.serving import ServePlane
    from pyruhvro_tpu_torch.utils.datagen import kafka_style_datums

    corpora = [kafka_style_datums(8, seed=40 + i) for i in range(3)]
    refs = [p.deserialize_array(c, kafka, device=device) for c in corpora]
    ok = True
    for kind, policy in (("error", "shed"), ("hang", "block")):
        faults.reset()
        breaker.reset()  # a tripped serve_worker from the error cell
        os.environ["PYRUHVRO_TPU_SERVE_POLICY"] = policy
        if kind == "hang":
            os.environ["PYRUHVRO_TPU_SERVE_BATCH_TIMEOUT_S"] = "0.05"

        def run_cell():
            plane = ServePlane(autostart=False)
            futs = [plane.submit("decode", c, kafka, device=device,
                                 timeout_s=30.0) for c in corpora]
            plane.drain()
            return [f.result(timeout=0) for f in futs]

        try:
            ok &= Cell(ledger, "serve_worker", kind, "serve_decode", policy,
                       30.0).run(run_cell, lambda out: all(
                           b.equals(r) for b, r in zip(out, refs)))
        finally:
            os.environ.pop("PYRUHVRO_TPU_SERVE_POLICY", None)
            os.environ.pop("PYRUHVRO_TPU_SERVE_BATCH_TIMEOUT_S", None)
    ok &= recover("serve_worker")
    for kind in ("error", "hang"):
        before = metrics.snapshot().get("serve.enqueue_degraded", 0)

        def enqueue():
            plane = ServePlane(autostart=False)
            f = plane.submit("decode", corpora[0], kafka, device=device,
                             timeout_s=30.0)
            plane.drain()
            return f.result(timeout=0)

        ok &= Cell(ledger, "serve_enqueue", kind, "serve_decode", "-",
                   30.0).run(enqueue, lambda out, k=kind: out.equals(
                       refs[0]) and (k != "error" or metrics.snapshot().get(
                           "serve.enqueue_degraded", 0) > before))
    ok &= flight_cells(ledger, device, kafka, corpora[0], refs[0])
    return ok


def flight_cells(ledger, device, kafka, data, ref) -> bool:
    """``serve_flight``: one RPC fails (error) or answers late (hang)."""
    import pyarrow as pa

    from pyruhvro_tpu_torch import serving
    from pyruhvro_tpu_torch.serving.flight import start_flight_server

    server = start_flight_server("grpc://127.0.0.1:0")
    if server is None:  # the optional pyarrow.flight extra is missing
        ledger.append({"site": "serve_flight", "kind": "-",
                       "op": "flight_decode", "outcome": "not_run: no "
                       "pyarrow.flight", "pass": True})
        print("[--] serve_flight: pyarrow.flight is not installed",
              flush=True)
        return True
    import pyarrow.flight as fl

    client = fl.connect(f"grpc://127.0.0.1:{server.port}")
    cmd = {"schema": kafka, "timeout_s": 30.0, "device": device}
    wire = pa.record_batch([pa.array(data, type=pa.binary())],
                           names=["wire"])

    def rpc():
        writer, meta = client.do_put(
            fl.FlightDescriptor.for_command(json.dumps(cmd).encode()),
            wire.schema)
        writer.write_batch(wire)
        writer.done_writing()
        ticket = meta.read()
        writer.close()  # raises the server's error
        return client.do_get(fl.Ticket(ticket.to_pybytes())).read_all()

    ok = True
    try:
        for kind in ("error", "hang"):
            cell = Cell(ledger, "serve_flight", kind, "flight_decode", "-",
                        30.0)
            if kind == "error":
                # a failed RPC is the structured outcome of this seam
                ok &= cell.run(lambda: _flight_error(rpc, fl),
                               lambda out: out == "FlightError")
            else:
                ok &= cell.run(rpc, lambda t: t.num_rows == ref.num_rows
                               and t.to_batches()[0].equals(ref))
    finally:
        server.shutdown()
        serving.stop()
    return ok


def _flight_error(rpc, fl):
    try:
        rpc()
    except fl.FlightError:
        return "FlightError"
    return "served"


def pool_leg(ledger, p, kafka) -> bool:
    """A spawned worker dies mid-fan-out (``pool_worker:exit``): the
    call is served on the parent's shard arm and the ``process_pool``
    breaker opens; after its backoff the half-open probe re-admits the
    pool."""
    from pyruhvro_tpu_torch.runtime import breaker, metrics, pool, telemetry
    from pyruhvro_tpu_torch.utils.datagen import kafka_style_datums

    data = kafka_style_datums(200, seed=13)
    telemetry.reset()
    breaker.reset()
    rec = {"site": "pool_worker", "kind": "exit", "op": "host_decode_threaded",
           "policy": "raise", "spec": "pool_worker:exit:1"}
    os.environ["PYRUHVRO_TPU_POOL"] = "process"
    ok = True
    try:
        os.environ["PYRUHVRO_TPU_FAULTS"] = "pool_worker:exit:1"
        out = p.deserialize_array_threaded(data, kafka, 2, backend="host")
        if sum(b.num_rows for b in out) != len(data):
            raise soak.Divergence("rows lost with a dead worker")
        if breaker.get("process_pool").state() != "open":
            raise soak.Divergence(breaker.get("process_pool").state())
        os.environ["PYRUHVRO_TPU_FAULTS"] = ""
        time.sleep(0.3)  # backoff expires -> half-open
        if not recover("process_pool"):
            raise soak.Divergence("process_pool never re-admitted")
        out = p.deserialize_array_threaded(data, kafka, 2, backend="host")
        if sum(b.num_rows for b in out) != len(data):
            raise soak.Divergence("rows lost after the recovery")
        if breaker.get("process_pool").state() != "closed":
            raise soak.Divergence(breaker.get("process_pool").state())
        if metrics.snapshot().get("pool.proc_chunks", 0) < 2:
            raise soak.Divergence("the pool served no chunk")
        rec.update({"outcome": "recovered", "pass": True})
        print("[ok] pool_worker:exit -> shard arm -> breaker re-admits",
              flush=True)
    except Exception as e:  # noqa: BLE001 — the invariant breaker
        traceback.print_exc()
        rec.update({"outcome": "FAILED", "error": repr(e), "pass": False})
        ok = False
    finally:
        os.environ["PYRUHVRO_TPU_FAULTS"] = ""
        os.environ.pop("PYRUHVRO_TPU_POOL", None)
        pool.shutdown_process_pool()
    ledger.append(rec)
    return ok


def main(argv=None) -> int:
    ap = soak.parser(__doc__, "chaos_ledger.json")
    ap.add_argument("--rounds", type=int, default=3,
                    help="matrix passes (default 3)")
    ap.add_argument("--skip-pool", action="store_true",
                    help="skip the spawn-pool worker-death leg")
    args = ap.parse_args(argv)
    card = soak.card(args.device)
    for name in ("PYRUHVRO_TPU_PALLAS", "PYRUHVRO_TPU_NO_NATIVE",
                 "PYRUHVRO_TPU_POOL", "PYRUHVRO_TPU_AUTOTUNE"):
        os.environ.pop(name, None)
    os.environ["PYRUHVRO_TPU_ROUTING_PROFILE"] = ""
    os.environ["PYRUHVRO_TPU_SAMPLE_BUDGET"] = "0"
    # a soak must see its own chaos clearly: short hangs, fast breakers
    os.environ.setdefault("PYRUHVRO_TPU_FAULT_HANG_S", "0.4")
    os.environ.setdefault("PYRUHVRO_TPU_BREAKER_BACKOFF", "0.1")
    with soak.watchdog(WATCHDOG_S):
        return run(args, card)


def run(args, card) -> int:
    import pyruhvro_tpu_torch as p
    from pyruhvro_tpu_torch.runtime import breaker, telemetry
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema
    from pyruhvro_tpu_torch.utils.datagen import (
        KAFKA_SCHEMA_JSON as kafka,
        kafka_style_datums,
        random_datums,
    )

    data = kafka_style_datums(ROWS, seed=11)
    bad = list(data)
    for i in (7, 123, 300):
        bad[i] = b"\xff\xff\xff"
    dev_schema = json.dumps(DEV_SCHEMA)
    dev_data = random_datums(get_or_parse_schema(dev_schema).ir, DEV_ROWS,
                             seed=11)
    ref = p.deserialize_array(data, kafka, backend="host")
    dev_ref = p.deserialize_array(dev_data, dev_schema, backend="host")
    if not p.deserialize_array(data, kafka, device=args.device).equals(ref):
        raise soak.Divergence("the healthy card call differs from the host "
                              "tier's")

    ledger: list = []
    ok = True
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for rnd in range(args.rounds):
            print(f"--- round {rnd} ---", flush=True)
            telemetry.reset()
            for kind in ("error", "hang"):
                dl = DEADLINE_S if kind == "hang" else None
                ok &= decode_cells(ledger, p, kind, dl, rnd, args.device,
                                   data, bad, ref, dev_data, dev_ref, kafka)
                ok &= observer_cells(ledger, p, kind, dl, args.device, data,
                                     ref, kafka, tmp)
            ok &= serve_cells(ledger, p, args.device, kafka)
        if not args.skip_pool:
            ok &= pool_leg(ledger, p, kafka)
    seconds = time.perf_counter() - t0
    doc = {"generated_by": "scripts/torch_chaos_soak.py",
           "device": args.device, "card": card, "rounds": args.rounds,
           "cells": len(ledger),
           "sites": sorted({r["site"] for r in ledger}),
           "failed": sum(1 for r in ledger if not r["pass"]),
           "seconds": seconds,
           "breakers_final": breaker.snapshot_breakers(),
           "ledger": ledger}
    soak.write_report(args.out, doc)
    print(f"chaos soak: {len(ledger)} cells over {len(doc['sites'])} sites "
          f"on {card}, {doc['failed']} failed, {seconds:.1f} s -> "
          f"{args.out}", flush=True)
    return 0 if ok and not doc["failed"] else 1


if __name__ == "__main__":
    sys.exit(main())
