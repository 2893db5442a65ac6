"""What the port's telemetry costs, and whether its launch times are device
times: a parent tree against this one, in turns, on the card.

    python3 scripts/torch_telemetry_ab.py --parent DIR [--rows 1000000]

Two worker processes, one per tree (this checkout and ``DIR``, e.g. an
earlier commit unpacked by ``git archive``), each import their own
``pyruhvro_tpu_torch`` and make the same 1M Kafka records
(``utils/datagen.py``, seed 0). Three cases, each a warm call of the
public API at ``chip_smoke.py``'s sizes: path 1
(``deserialize_array_threaded(data, schema, 8)``), P1 (the same with
one row in 100 replaced by ``b"\\x01"``, ``on_error="skip"``) and path 5
(``serialize_record_batch(batch, schema, 8)``). It prints:

* **A/B**: per case, the call's host seconds in turns parent, this,
  this, parent (``--rounds`` times), and the interpreter's collector
  seconds within each call (``gc.callbacks``);
* **on/off**: the same cases in this tree with telemetry on and off in
  turns (on, off, off, on);
* **gc**: P1 in this tree with telemetry on, off, on with the span ring
  emptied before each call (``telemetry.reset()``) and on under
  ``PYRUHVRO_TPU_DEVICE_SYNC=0`` (no launch events), in turns: seconds,
  the collector's seconds and full collections, the tracked objects
  after the call;
* **gcstats**: P1 on, off, off, on with ``gc.DEBUG_STATS``: per
  generation the collections, their seconds and the generation sizes
  they met;
* **cprofile**: P1 once under ``cProfile`` with telemetry on and once
  off in this tree (all its work runs on the calling thread), the
  functions whose own seconds differ most;
* **kernels**: one warm path 1 call in this tree under
  ``torch.profiler`` (CUDA activity): each kernel's device time and
  launches from the trace, beside the launch registry's
  ``device.launch_s`` per kernel kind for a call without the profiler
  and for the profiled call itself.

* **seams**: the per-call work of the fault, sampling, SLO, flight,
  audit and memory seams in this tree: how often each runs in one path 5
  call, and its microseconds alone, each over a loop of 100,000; beside
  them a timeline event's microseconds (one per state change, not per
  call), ``memacct.attribute`` of path 5's batch, a throttled
  ``memacct.tick`` and ``OtlpExporter.enqueue`` of path 5's root span
  (the last only with OTLP on).

``--cases`` picks the cases of A/B and on/off. ``--aa DIR`` adds a third
worker on a second copy of the parent to the A/B turns, so that one call
shows the harness's own bias between two processes of the same code;
``--sample-off`` adds a leg of this tree's worker under
``PYRUHVRO_TPU_SAMPLE_BUDGET=0``. Each round runs the legs in order and
then mirrored (parent, aa, this, sample-off, sample-off, this, aa,
parent). ``--this DIR`` tests another tree than this checkout.

Everything goes to stdout and to ``--out`` (by default
``build/telemetry_ab.json``; ``build/`` is git-ignored).
``--device cpu`` and a few thousand ``--rows`` rehearse it without a
card (no kernels mode). Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

WORKER = r'''
import cProfile, gc, io, json, os, pstats, sys, time
root, rows, device = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, root)
os.chdir(root)
import pyruhvro_tpu_torch as port
from pyruhvro_tpu_torch.utils import datagen
try:
    from pyruhvro_tpu_torch.runtime import telemetry
except ImportError:
    telemetry = None
schema = datagen.KAFKA_SCHEMA_JSON
data = datagen.kafka_style_datums(rows, seed=0)
poisoned = list(data)
for i in range(37, rows, 100):
    poisoned[i] = b"\x01"
kw = {} if device == "cuda" else {"device": "cpu"}
batch5 = port.deserialize_array(data, schema, **kw)
CASES = {
    "path1": lambda: port.deserialize_array_threaded(data, schema, 8, **kw),
    "P1": lambda: port.deserialize_array_threaded(
        poisoned, schema, 8, on_error="skip", **kw),
    "path5": lambda: port.serialize_record_batch(batch5, schema, 8, **kw),
}
gc_clock = {"t": 0.0, "s": 0.0, "n": 0, "full": 0, "full_s": 0.0}


def on_gc(phase, info):
    if phase == "start":
        gc_clock["t"] = time.perf_counter()
    else:
        dt = time.perf_counter() - gc_clock["t"]
        gc_clock["s"] += dt
        gc_clock["n"] += 1
        if info["generation"] == 2:
            gc_clock["full"] += 1
            gc_clock["full_s"] += dt


gc.callbacks.append(on_gc)


def timed(fn):
    gc_clock.update(s=0.0, n=0, full=0, full_s=0.0)
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    del out
    return {"s": wall, "gc_s": gc_clock["s"], "gc_n": gc_clock["n"],
            "gc_full": gc_clock["full"], "gc_full_s": gc_clock["full_s"],
            "tracked": len(gc.get_objects())}


def cprofile(fn):
    pr = cProfile.Profile()
    pr.enable()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    pr.disable()
    del out
    st = pstats.Stats(pr, stream=io.StringIO())
    rows = []
    for (f, line, name), (cc, nc, tt, ct, _callers) in st.stats.items():
        rows.append([f"{os.path.basename(f)}:{line}:{name}", nc, tt, ct])
    rows.sort(key=lambda r: -r[2])
    return {"s": wall, "functions": rows}


def gc_stats(fn):
    """One call with the collector's own statistics: per generation the
    collections, their seconds and the mean sizes of the generations
    they met (``gc.DEBUG_STATS``)."""
    import re

    buf, err = io.StringIO(), sys.stderr
    sys.stderr = buf
    gc.set_debug(gc.DEBUG_STATS)
    try:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    finally:
        gc.set_debug(0)
        sys.stderr = err
    del out
    per, gen, sizes = {}, None, None
    for line in buf.getvalue().splitlines():
        m = re.search(r"collecting generation (\d)", line)
        if m:
            gen = int(m.group(1))
            continue
        m = re.search(r"objects in each generation: (\d+) (\d+) (\d+)",
                      line)
        if m:
            sizes = [int(x) for x in m.groups()]
            continue
        m = re.search(r"done, .*?([0-9.]+)s elapsed", line)
        if m and gen is not None:
            k = per.setdefault(str(gen), {"n": 0, "s": 0.0,
                                          "sizes": [0, 0, 0]})
            k["n"] += 1
            k["s"] += float(m.group(1))
            if sizes:
                k["sizes"] = [a + b for a, b in zip(k["sizes"], sizes)]
            gen, sizes = None, None
    for k in per.values():
        k["sizes"] = [x // max(k["n"], 1) for x in k["sizes"]]
    return {"s": wall, "gens": per}


def registry():
    snap = telemetry.snapshot()
    per = {}
    for e in ((snap.get("device") or {}).get("jit_cache") or {}).values():
        k = per.setdefault(e["kind"], {"launches": 0, "launch_s": 0.0})
        k["launches"] += e["launches"]
        k["launch_s"] += e["launch_s"]
    return per


def kernels():
    import torch
    from torch.profiler import ProfilerActivity, profile

    telemetry.set_enabled(True)
    telemetry.reset()
    CASES["path1"]()
    plain = registry()
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        CASES["path1"]()
        torch.cuda.synchronize()
    traced = registry()
    per = {}
    for e in prof.events():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = e.time_range.elapsed_us()
        k = per.setdefault(e.name, {"launches": 0, "us": 0.0, "each": []})
        k["launches"] += 1
        k["us"] += us
        if len(k["each"]) < 64:
            k["each"].append(us)
    return {"registry": plain, "registry_traced": traced, "trace": per}


def seams():
    """The per-call work of the fault, sampling, SLO, flight and audit
    seams in one path 5 call: how often each runs (``faults.fire``
    counted by site through one call), and its microseconds alone, over
    a loop; and a timeline event's microseconds."""
    from pyruhvro_tpu_torch.runtime import (audit, device_obs, faults, knobs,
                                            router, sampling, slo, timeline)
    try:  # the memory and OTLP seams, in trees that have them
        from pyruhvro_tpu_torch.runtime import memacct, otel
    except ImportError:
        memacct = otel = None
    fired = {}
    fire = faults.fire

    def counting(site):
        fired[site] = fired.get(site, 0) + 1
        return fire(site)

    faults.fire = counting
    try:
        CASES["path5"]()
    finally:
        faults.fire = fire
    root = telemetry._spans[-1]
    n = 100_000

    def us(fn, loops=n):
        t0 = time.perf_counter()
        for _ in range(loops):
            fn()
        return (time.perf_counter() - t0) / loops * 1e6

    def scope():
        with sampling.call_scope("encode", schema, rows):
            pass

    entry = port.api.get_or_parse_schema(schema)
    dec = router.RouteDecision(
        tier="device", impl=None, reason="backend_device", pool="none",
        arm="device/c8/none", mode="static", explore=False, autotune=False,
        schema=entry.fingerprint, op="encode", band=6, rows=rows, chunks=8,
        predicted={})
    # an audit tally that does not audit: the period far past the loop
    audit.reset()
    audit._period = 1 << 40
    never = lambda: []  # noqa: E731

    def tally():
        audit.maybe_audit(dec, "encode", expected=never, shadow=never)

    got = {
        "fired": fired,
        "root_children": len(root.children),
        "fire_us": us(lambda: faults.fire("device_launch")),
        "sync_knob_us": us(lambda: knobs.get_tristate(
            "PYRUHVRO_TPU_DEVICE_SYNC")),
        "sync_mode_us": us(device_obs.sync_mode),
        "call_scope_us": us(scope),
        "slo_record_root_us": us(lambda: slo.record_root(
            root.name, schema, 0.5, False)),
        "flight_record_us": us(lambda: telemetry._flight_record(root)),
        "audit_tally_us": us(tally),
        "timeline_event_us": us(lambda: timeline.event(
            "seam.probe", attrs={"k": 1})),
    }
    if memacct is not None:
        memacct.reset()
        memacct.tick()  # the loop's ticks all fall inside the throttle
        # an exporter whose queue is drained by hand (no thread, no POST)
        ex = otel.OtlpExporter("http://127.0.0.1:9", interval_s=3600)

        def enqueue():
            ex.enqueue(root)
            if len(ex._q) > 1024:
                ex._q.clear()

        import numpy as np
        import pyarrow as pa
        from pyruhvro_tpu_torch.runtime.ingest import as_datum_input

        view = as_datum_input(pa.array(data, pa.binary()))
        got.update(
            attribute_us=us(lambda: memacct.attribute(
                "tenant", entry.fingerprint, "encode", rows, batch5)),
            # path 1's records as a BinaryArray (P2's input): read off
            # the end offsets, and the reference's pass over the lengths
            attribute_arrow_us=us(lambda: memacct.attribute(
                "tenant", entry.fingerprint, "decode", rows, view)),
            lens_sum_us=us(lambda: int(np.diff(view.offsets()).sum()),
                           loops=100),
            tick_us=us(memacct.tick),
            otlp_enqueue_us=us(enqueue))
        memacct.reset()
    audit.reset()
    timeline.reset()
    sampling.reset()
    return got


print(json.dumps({"ready": True, "telemetry": telemetry is not None}),
      flush=True)
for line in sys.stdin:
    cmd = json.loads(line)
    for name, value in cmd.get("env", {}).items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
    if telemetry is not None:
        telemetry.set_enabled(cmd.get("telemetry", True))
        if cmd.get("reset"):
            telemetry.reset()
    if cmd["mode"] == "time":
        got = timed(CASES[cmd["case"]])
    elif cmd["mode"] == "gcstats":
        got = gc_stats(CASES[cmd["case"]])
    elif cmd["mode"] == "cprofile":
        got = cprofile(CASES[cmd["case"]])
    elif cmd["mode"] == "seams":
        got = seams()
    else:
        got = kernels()
    if telemetry is not None:
        telemetry.set_enabled(True)
    print(json.dumps(got), flush=True)
'''


class Worker:
    def __init__(self, label: str, root: Path, rows: int, device: str):
        self.label = label
        self.proc = subprocess.Popen(
            [sys.executable, "-c", WORKER, str(root), str(rows), device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=root)
        self.root = root

    def ready(self) -> dict:
        return self._read()

    def ask(self, **cmd) -> dict:
        self.proc.stdin.write(json.dumps(cmd) + "\n")
        self.proc.stdin.flush()
        return self._read()

    def _read(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise SystemExit(f"the {self.label} worker exited "
                             f"{self.proc.wait()}")
        return json.loads(line)

    def close(self) -> None:
        self.proc.stdin.close()
        self.proc.wait(timeout=120)


def med(xs):
    return statistics.median(xs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--this", type=Path, default=HERE,
                    help="the tree under test (default: this checkout)")
    ap.add_argument("--aa", type=Path, default=None,
                    help="a copy of the parent, run as a third worker in "
                    "the A/B turns (the harness's own bias)")
    ap.add_argument("--sample-off", action="store_true",
                    help="add an A/B leg of this tree under "
                    "PYRUHVRO_TPU_SAMPLE_BUDGET=0 (no deep sampling)")
    ap.add_argument("--cases", default="path1,P1,path5",
                    help="comma-separated cases for ab and onoff")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sections", default="ab,onoff,gc,cprofile,kernels",
                    help="comma-separated sections to run (and seams)")
    ap.add_argument("--out", type=Path,
                    default=HERE / "build" / "telemetry_ab.json")
    args = ap.parse_args(argv)
    card = ""
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
    t_start = time.perf_counter()
    workers = {"parent": Worker("parent", args.parent.resolve(), args.rows,
                                args.device)}
    if args.aa is not None:
        workers["aa"] = Worker("aa", args.aa.resolve(), args.rows,
                               args.device)
    workers["this"] = Worker("this", args.this.resolve(), args.rows,
                             args.device)
    try:
        for w in workers.values():
            w.ready()
        print(f"workers ready in {time.perf_counter() - t_start:.1f} s",
              flush=True)
        out = {"card": card, "rows": args.rows, "ab": {}, "on_off": {}}
        cases = tuple(args.cases.split(","))
        for case in cases:
            for w in workers.values():
                for _ in range(2):
                    w.ask(mode="time", case=case)
        sections = set(args.sections.split(","))
        # legs: (label, worker, env); the order is mirrored in each round
        off = {"PYRUHVRO_TPU_SAMPLE_BUDGET": "0"}
        on = {"PYRUHVRO_TPU_SAMPLE_BUDGET": None}
        legs_order = [("parent", "parent", on)]
        if "aa" in workers:
            legs_order.append(("aa", "aa", on))
        legs_order.append(("this", "this", on))
        if args.sample_off:
            legs_order.append(("this_sample_off", "this", off))
        for case in cases if "ab" in sections else ():
            legs = {label: [] for label, _w, _e in legs_order}
            for _ in range(args.rounds):
                for label, w, env in legs_order + legs_order[::-1]:
                    legs[label].append(workers[w].ask(mode="time",
                                                      case=case, env=env))
            workers["this"].ask(mode="time", case=case, env=on)
            out["ab"][case] = legs
            p = [x["s"] for x in legs["parent"]]
            print(f"A/B {case}: parent median {med(p):.4f} s "
                  f"{[round(x, 4) for x in p]} {card}", flush=True)
            for label in legs:
                if label == "parent":
                    continue
                t = [x["s"] for x in legs[label]]
                # each leg against the parent legs of its own rounds
                pairs = [b / a - 1 for a, b in zip(p, t)]
                print(f"A/B {case}: {label} median {med(t):.4f} s "
                      f"{[round(x, 4) for x in t]}; {label} - parent "
                      f"{med(t) - med(p):+.4f} s "
                      f"({(med(t) / med(p) - 1) * 100:+.2f} %); median of "
                      f"the {len(pairs)} paired ratios "
                      f"{med(pairs) * 100:+.2f} %, {label} slower in "
                      f"{sum(r > 0 for r in pairs)}; collector s per call "
                      f"{med([x['gc_s'] for x in legs[label]]):.4f} {card}",
                      flush=True)
        if "seams" in sections:
            sm = out["seams"] = workers["this"].ask(mode="seams")
            launches = sm["fired"].get("device_launch", 0)
            per_call = (launches * (sm["fire_us"] + sm["sync_mode_us"])
                        + sm["call_scope_us"] + sm["slo_record_root_us"]
                        + sm.get("audit_tally_us", 0.0)
                        + sm.get("attribute_us", 0.0)
                        + sm.get("tick_us", 0.0))
            print(f"seams path5: per call {sm['fired']} fault seams, "
                  f"{sm['root_children']} child spans; us each: "
                  f"faults.fire {sm['fire_us']:.3f}, the sync knob "
                  f"{sm['sync_knob_us']:.3f}, sync_mode outside a launch "
                  f"{sm['sync_mode_us']:.3f}, call_scope "
                  f"{sm['call_scope_us']:.3f}, slo.record_root "
                  f"{sm['slo_record_root_us']:.3f}, a flight record (read "
                  f"time) {sm['flight_record_us']:.3f}, the audit's "
                  f"tally {sm.get('audit_tally_us', float('nan')):.3f}, "
                  f"memacct.attribute "
                  f"{sm.get('attribute_us', float('nan')):.3f} (of path 1's "
                  f"records as a BinaryArray "
                  f"{sm.get('attribute_arrow_us', float('nan')):.3f}; the "
                  f"reference's lens().sum() "
                  f"{sm.get('lens_sum_us', float('nan')):.3f}), a throttled "
                  f"memacct.tick {sm.get('tick_us', float('nan')):.3f}; at "
                  f"most {per_call:.1f} us a call; with OTLP on "
                  f"OtlpExporter.enqueue "
                  f"{sm.get('otlp_enqueue_us', float('nan')):.3f} more; a "
                  f"timeline event "
                  f"{sm.get('timeline_event_us', float('nan')):.3f} us "
                  f"{card}", flush=True)
        this = workers["this"]
        for case in cases if "onoff" in sections else ():
            legs = {"on": [], "off": []}
            for _ in range(args.rounds):
                for leg in ("on", "off", "off", "on"):
                    legs[leg].append(this.ask(mode="time", case=case,
                                              telemetry=leg == "on"))
            out["on_off"][case] = legs
            on = [x["s"] for x in legs["on"]]
            off = [x["s"] for x in legs["off"]]
            print(f"on/off {case}: on median {med(on):.4f} s "
                  f"{[round(x, 4) for x in on]}, off {med(off):.4f} s "
                  f"{[round(x, 4) for x in off]}; on - off "
                  f"{med(on) - med(off):+.4f} s; collector s per call on "
                  f"{med([x['gc_s'] for x in legs['on']]):.4f}, off "
                  f"{med([x['gc_s'] for x in legs['off']]):.4f} {card}",
                  flush=True)
        # P1's collector: telemetry on, off, on with the span ring
        # emptied before each call, on with no launch events
        variants = {"on": {}, "off": {"telemetry": False},
                    "on_ring_empty": {"reset": True},
                    "on_no_events": {"env": {"PYRUHVRO_TPU_DEVICE_SYNC":
                                             "0"}}}
        legs = {k: [] for k in variants}
        for _ in range(args.rounds if "gc" in sections else 0):
            for k in list(variants) + list(variants)[::-1]:
                legs[k].append(this.ask(mode="time", case="P1",
                                        **variants[k]))
                this.ask(mode="time", case="path5",
                         env={"PYRUHVRO_TPU_DEVICE_SYNC": None})
        out["gc_P1"] = legs
        for k, xs in legs.items() if "gc" in sections else ():
            print(f"gc P1 {k}: median {med([x['s'] for x in xs]):.4f} s, "
                  f"collector {med([x['gc_s'] for x in xs]):.4f} s of which"
                  f" full {med([x['gc_full_s'] for x in xs]):.4f} s in "
                  f"{[x['gc_full'] for x in xs]} full collections, tracked "
                  f"objects after {[x['tracked'] for x in xs]} {card}",
                  flush=True)
        if "gcstats" in sections:
            for leg in ("on", "off", "off", "on"):
                g = this.ask(mode="gcstats", case="P1",
                             telemetry=leg == "on")
                out.setdefault("gcstats_P1", {}).setdefault(leg, []).append(g)
                print(f"gcstats P1 {leg}: {g['s']:.4f} s; per generation "
                      f"collections, seconds, mean sizes met: "
                      + "; ".join(f"gen{k} {v['n']} {v['s']:.4f} s "
                                  f"{v['sizes']}"
                                  for k, v in sorted(g["gens"].items())),
                      flush=True)
        if "cprofile" in sections:
            prof = out["cprofile_P1"] = {
                leg: this.ask(mode="cprofile", case="P1",
                              telemetry=leg == "on") for leg in ("on", "off")}
            own = {leg: {r[0]: r for r in p["functions"]}
                   for leg, p in prof.items()}
            none = [None, 0, 0.0, 0.0]
            diff = sorted(set(own["on"]) | set(own["off"]), key=lambda f: -abs(
                own["on"].get(f, none)[2] - own["off"].get(f, none)[2]))
            print(f"cprofile P1: on {prof['on']['s']:.4f} s, off "
                  f"{prof['off']['s']:.4f} s; own seconds on / off (calls):",
                  flush=True)
            for f in diff[:30]:
                a, b = own["on"].get(f, none), own["off"].get(f, none)
                print(f"  {f}: {a[2]:.4f} / {b[2]:.4f} ({a[1]} / {b[1]})")
            by_file = {}
            for leg, rows in own.items():
                for f, r in rows.items():
                    key = f.split(":")[0]
                    by_file.setdefault(key, {"on": 0.0, "off": 0.0})
                    by_file[key][leg] += r[2]
            print("cprofile P1: own seconds per file on / off:")
            for key, v in sorted(by_file.items(), key=lambda kv: -abs(
                    kv[1]["on"] - kv[1]["off"]))[:15]:
                print(f"  {key}: {v['on']:.4f} / {v['off']:.4f}")
        if args.device == "cuda" and "kernels" in sections:
            k = out["kernels"] = this.ask(mode="kernels")
            for kind, r in k["registry"].items():
                t = k["registry_traced"].get(kind, {})
                print(f"kernels: registry {kind} {r['launches']} launches, "
                      f"{r['launch_s'] / max(r['launches'], 1) * 1e3:.4f} "
                      f"ms per launch (under the profiler "
                      f"{t.get('launch_s', 0) / max(t.get('launches', 1), 1) * 1e3:.4f})"
                      f" {card}")
            for name, r in sorted(k["trace"].items(), key=lambda kv:
                                  -kv[1]["us"]):
                print(f"kernels: trace {name[:90]} {r['launches']} "
                      f"launches, {r['us'] / r['launches'] / 1e3:.4f} ms "
                      f"each, first {[round(x / 1e3, 4) for x in r['each'][:8]]}"
                      f" {card}")
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out))
        print(f"done in {time.perf_counter() - t_start:.1f} s; "
              f"{args.out}", flush=True)
    finally:
        for w in workers.values():
            try:
                w.close()
            finally:
                if w.proc.poll() is None:
                    w.proc.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
