#!/usr/bin/env python
"""Sustained-overload serving soak of the port on the card (counterpart
of ``scripts/serve_soak.py``).

Measures the capacity of the port's ``ServePlane`` over the card, then
offers a sustained multiple of it (``--overload``, the reference's
default 8, at least twice capacity) from two tenants — one well-behaved,
one flooding — with ``serve_worker`` chaos injected, every request
decoded on the card (``device=``), and asserts the overload contract end
to end:

  * **shed, never die** — at >= 2x capacity the plane sheds the excess
    with structured :class:`Overloaded` rejections; the process never
    crashes, deadlocks, or wedges (faulthandler watchdog);
  * **admitted traffic stays fast** — the e2e p99 of ADMITTED requests
    stays within the soak SLO even while the queues are saturated
    (admission control is doing its job: latency is bounded by queue
    depth, not offered load);
  * **tenant isolation** — the flood tenant cannot push the
    well-behaved tenant's admitted p99 past 2x its solo baseline;
  * **brownout ladder engages** — sustained pressure walks the rungs
    (audit -> sampling -> explore -> tenant) and every engagement is
    counted with occupancy recorded;
  * **zero-loss mid-load drain** — a drain issued while requests are
    still in flight resolves EVERY accepted request exactly once
    (result or structured error): none lost, none double-answered.

Writes its report (atomic; ``build/pyruhvro_tpu_torch/serve_soak.json``
by default) with per-phase latency summaries, shed accounting, brownout
occupancy and the drain verdict.

Usage::

    python scripts/torch_serve_soak.py [--duration 8] [--overload 8]
        [--fault-rate 0.05] [--device cuda|cpu] [--out FILE]

Exit 1 on any invariant violation.
"""

from __future__ import annotations

import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_soaklib as soak  # noqa: E402

# soak defaults: bounded queues small enough to saturate quickly, shed
# policy so overload is visible as rejections (not blocking callers),
# and a brownout ladder that engages within the run (set in main)
SOAK_ENV = {
    "PYRUHVRO_TPU_SERVE_POLICY": "shed",
    "PYRUHVRO_TPU_SERVE_QUEUE": "32",
    "PYRUHVRO_TPU_SERVE_WORKERS": "2",
    "PYRUHVRO_TPU_SERVE_BROWNOUT": "0.5",
    "PYRUHVRO_TPU_SERVE_BROWNOUT_SUSTAIN": "2",
    "PYRUHVRO_TPU_SERVE_COALESCE_S": "0.001",
}

WATCHDOG_S = 420
ROWS_PER_REQ = 32
SLO_P99_S = 1.5       # admitted traffic must beat this even overloaded
ISOLATION_FACTOR = 2.0  # wb overload p99 <= factor * wb solo p99 (floored)
ISOLATION_FLOOR_S = 0.5


def pct(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def summary(lat):
    return {
        "count": len(lat),
        "p50_s": pct(lat, 0.50),
        "p90_s": pct(lat, 0.90),
        "p99_s": pct(lat, 0.99),
        "max_s": max(lat) if lat else None,
    }


class TenantLoad:
    """One tenant's open-loop submission thread at a fixed offered
    rate; every outcome is accounted (admitted future / shed)."""

    def __init__(self, plane, tenant, rate_rps, data, schema, device):
        from pyruhvro_tpu_torch.serving import Overloaded

        self._Overloaded = Overloaded
        self.plane = plane
        self.tenant = tenant
        self.rate = rate_rps
        self.data = data
        self.schema = schema
        self.device = device
        self.futures = []
        self.latencies = []
        self.shed = 0
        self.submit_errors = 0
        self.submitted = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"soak-{tenant}")

    def _run(self):
        period = 1.0 / self.rate
        next_t = time.monotonic()
        while not self._stop.is_set():
            now = time.monotonic()
            if now < next_t:
                time.sleep(min(period, next_t - now))
                continue
            if now - next_t > 10 * period:
                # fell behind (GIL/scheduler): drop the missed ticks
                # rather than replaying them as a burst — an open-loop
                # client with a bounded send buffer does the same
                next_t = now
            next_t += period
            self.submitted += 1
            t0 = time.monotonic()
            try:
                f = self.plane.submit(
                    "decode", self.data, self.schema, timeout_s=10.0,
                    tenant=self.tenant, device=self.device)
            except self._Overloaded:
                self.shed += 1
                continue
            except Exception:  # noqa: BLE001 — drain racing submit
                self.submit_errors += 1
                continue
            f.add_done_callback(
                lambda fut, t=t0: self.latencies.append(
                    time.monotonic() - t)
                if fut.exception() is None else None)
            self.futures.append(f)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)

    def account(self):
        """(results, structured_failures, unresolved) over admitted."""
        res = fail = pending = 0
        for f in self.futures:
            if not f.done():
                pending += 1
            elif f.exception() is None:
                res += 1
            else:
                fail += 1
        return res, fail, pending


def main(argv=None) -> int:
    ap = soak.parser(__doc__, "serve_soak.json")
    ap.add_argument("--duration", type=float, default=8.0,
                    help="seconds per load phase (default 8)")
    ap.add_argument("--overload", type=float, default=8.0,
                    help="offered load as a multiple of measured "
                         "capacity (default 8; the closed-loop probe "
                         "understates coalesced throughput, so a high "
                         "multiple is needed to genuinely saturate)")
    ap.add_argument("--fault-rate", type=float, default=0.05,
                    help="serve_worker error rate during overload "
                         "(default 0.05)")
    args = ap.parse_args(argv)
    card = soak.card(args.device)
    os.environ.pop("PYRUHVRO_TPU_PALLAS", None)
    for k, v in SOAK_ENV.items():
        os.environ.setdefault(k, v)
    with soak.watchdog(WATCHDOG_S):
        return run(args, card)


def run(args, card) -> int:
    dev = args.device

    import pyruhvro_tpu_torch as p
    from pyruhvro_tpu_torch import serving
    from pyruhvro_tpu_torch.runtime import faults, knobs, metrics, telemetry
    from pyruhvro_tpu_torch.utils.datagen import (
        KAFKA_SCHEMA_JSON,
        kafka_style_datums,
    )

    data = kafka_style_datums(ROWS_PER_REQ, seed=11)
    ref = p.deserialize_array(data, KAFKA_SCHEMA_JSON, device=dev)
    if ref.num_rows != ROWS_PER_REQ:
        raise soak.Divergence(f"the one-shot call gave {ref.num_rows} rows")
    workers = knobs.get_int("PYRUHVRO_TPU_SERVE_WORKERS")

    # -- capacity probe: closed-loop through the PLANE, so the number
    # includes queue/lock/coalesce overhead and GIL contention with the
    # submitting threads — the raw API in a tight loop overstates what
    # the serving path can actually sustain
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        p.deserialize_array(data, KAFKA_SCHEMA_JSON, device=dev)
    per_call = (time.perf_counter() - t0) / reps

    plane = serving.start()
    done = [0, 0, 0, 0]  # one slot per thread: no shared counter
    cal_stop = time.monotonic() + 1.5

    def _closed_loop(slot):
        while time.monotonic() < cal_stop:
            plane.call("decode", data, KAFKA_SCHEMA_JSON,
                       timeout_s=10.0, tenant="cal", device=dev)
            done[slot] += 1

    cal_threads = [threading.Thread(target=_closed_loop, args=(i,),
                                    daemon=True)
                   for i in range(len(done))]
    t0 = time.monotonic()
    for t in cal_threads:
        t.start()
    for t in cal_threads:
        t.join(timeout=20)
    capacity_rps = sum(done) / max(1e-6, time.monotonic() - t0)
    plane.drain()
    serving.stop()
    telemetry.reset()
    print(f"capacity probe: {per_call * 1e3:.2f} ms/call raw; "
          f"plane sustains ~{capacity_rps:.0f} req/s "
          f"({workers} worker(s)) on {card}", flush=True)

    doc = {
        "generated_by": "scripts/torch_serve_soak.py",
        "device": dev, "card": card,
        "per_call_s": per_call,
        "rows_per_request": ROWS_PER_REQ,
        "workers": workers,
        "capacity_rps": round(capacity_rps, 1),
        "offered_multiple": args.overload,
        "fault_rate": args.fault_rate,
        "phases": {},
        "violations": [],
    }

    def violate(msg):
        print(f"[FAIL] {msg}", flush=True)
        doc["violations"].append(msg)

    # -- phase 1: solo baseline (well-behaved tenant only, 40% cap) ----
    plane = serving.start()
    wb = TenantLoad(plane, "wb", max(2.0, 0.4 * capacity_rps), data,
                    KAFKA_SCHEMA_JSON, dev).start()
    time.sleep(args.duration)
    wb.stop()
    plane.drain()
    serving.stop()
    solo = summary(wb.latencies)
    doc["phases"]["solo"] = {
        "offered_rps": round(wb.rate, 1), "submitted": wb.submitted,
        "shed": wb.shed, "latency": solo,
    }
    print(f"solo: {wb.submitted} submitted, {wb.shed} shed, "
          f"p99 {solo['p99_s'] * 1e3:.1f} ms", flush=True)
    if wb.shed:
        violate("solo phase shed traffic at 40% of measured capacity")
    telemetry.reset()

    # -- phase 2: sustained overload + chaos + flood tenant ------------
    os.environ["PYRUHVRO_TPU_FAULTS"] = (
        f"serve_worker:error:{args.fault_rate:g}")
    faults.reset()  # drop the parsed-plan memo so the spec is re-read
    serving.reset()  # fresh plane, fresh accounting
    plane = serving.start()
    wb2 = TenantLoad(plane, "wb", max(2.0, 0.4 * capacity_rps), data,
                     KAFKA_SCHEMA_JSON, dev).start()
    flood = TenantLoad(
        plane, "flood",
        max(4.0, args.overload * capacity_rps), data,
        KAFKA_SCHEMA_JSON, dev).start()
    rungs_seen = set()
    t_end = time.monotonic() + args.duration
    while time.monotonic() < t_end:
        rungs_seen.update(plane.engaged_rungs())
        time.sleep(0.05)
    wb2.stop()
    flood.stop()

    # -- phase 3: MID-LOAD drain (submissions were just stopped, the
    # backlog is still deep) — the zero-loss verdict ------------------
    snap_before = plane.snapshot()
    rep = plane.drain(timeout_s=60.0)
    serving.stop()
    os.environ["PYRUHVRO_TPU_FAULTS"] = ""
    faults.reset()

    over_wb = summary(wb2.latencies)
    over_fl = summary(flood.latencies)
    c = metrics.snapshot()
    occupancy = snap_before["brownout"]["occupancy_s"]
    admitted = len(wb2.futures) + len(flood.futures)
    shed_total = wb2.shed + flood.shed
    offered = wb2.submitted + flood.submitted
    doc["phases"]["overload"] = {
        "offered_rps": round(wb2.rate + flood.rate, 1),
        "submitted": offered,
        "admitted": admitted,
        "shed": shed_total,
        "shed_ratio": round(shed_total / max(1, offered), 4),
        "submit_errors": wb2.submit_errors + flood.submit_errors,
        "worker_faults_injected": c.get(
            "fault.injected.serve_worker", 0),
        "worker_degraded": c.get("serve.worker_degraded", 0),
        "latency_wb": over_wb,
        "latency_flood": over_fl,
        "brownout_rungs_seen": sorted(rungs_seen),
        "brownout_occupancy_s": {k: round(v, 3)
                                 for k, v in occupancy.items()},
        "brownout_engagements": {
            r: c.get("serve.brownout." + r, 0)
            for r in serving.BROWNOUT_RUNGS},
    }

    wb_res, wb_fail, wb_pend = wb2.account()
    fl_res, fl_fail, fl_pend = flood.account()
    doc["drain"] = {
        "report": rep,
        "admitted": admitted,
        "results": wb_res + fl_res,
        "structured_failures": wb_fail + fl_fail,
        "unresolved": wb_pend + fl_pend,
        "double_resolve": c.get("serve.double_resolve", 0),
        "drain_aborted": c.get("serve.drain_aborted", 0),
    }

    # -- the contract --------------------------------------------------
    if shed_total == 0:
        violate("overload at "
                f"{args.overload:g}x capacity shed nothing — "
                "backpressure never engaged")
    if wb_pend + fl_pend:
        violate(f"{wb_pend + fl_pend} admitted request(s) never "
                "resolved — requests were LOST in the drain")
    if c.get("serve.double_resolve", 0):
        violate("a request was resolved twice")
    if rep["accepted"] != rep["completed"] + rep["failed"]:
        violate("plane accounting does not balance: "
                f"{rep}")
    if over_wb["p99_s"] is not None and over_wb["p99_s"] > SLO_P99_S:
        violate(f"admitted wb p99 {over_wb['p99_s']:.3f}s breaches the "
                f"soak SLO {SLO_P99_S}s under overload")
    if over_wb["p99_s"] is not None and solo["p99_s"] is not None:
        bound = max(ISOLATION_FACTOR * solo["p99_s"], ISOLATION_FLOOR_S)
        if over_wb["p99_s"] > bound:
            violate("flood tenant pushed wb admitted p99 to "
                    f"{over_wb['p99_s']:.3f}s (> {bound:.3f}s = "
                    f"max({ISOLATION_FACTOR:g} x solo, floor))")
    if not rungs_seen:
        violate("brownout ladder never engaged under sustained "
                "overload")

    # every admitted result is the one-shot call's
    wrong = sum(1 for f in wb2.futures + flood.futures
                if f.done() and f.exception() is None
                and not f.result().equals(ref))
    if wrong:
        violate(f"{wrong} admitted result(s) differ from the one-shot "
                f"call")

    doc["pass"] = not doc["violations"]
    soak.write_report(args.out, doc)
    print(f"serve soak: offered {offered}, admitted {admitted}, shed "
          f"{shed_total} ({doc['phases']['overload']['shed_ratio']:.1%})"
          f", rungs {sorted(rungs_seen)}, "
          f"drain unresolved={wb_pend + fl_pend} -> {args.out}",
          flush=True)
    return 0 if doc["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
