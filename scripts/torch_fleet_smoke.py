#!/usr/bin/env python
"""Fleet-aggregation smoke of the port (counterpart of
``scripts/fleet_smoke.py``).

Spawns THREE real replica processes, each decoding and encoding on the
card (``--device``, default ``cuda``). Each replica runs its own traffic
mix (decode / tolerant decode with corrupt rows / encode), freezes its
``telemetry.snapshot()``, and serves that frozen document from an
in-process obs server on a free port — frozen so every scrape of one
replica returns identical bytes, which is what makes the reconciliation
below exact rather than racy. Replica r0 additionally runs under a
deliberately-unmeetable SLO file, seeding a breach the merged fleet
view must surface.

The gate then:

* merges the three live endpoints via the real CLI
  (``python -m pyruhvro_tpu_torch.telemetry fleet --scrape ...``);
* re-fetches each replica's snapshot directly and asserts every merged
  counter equals the left-fold sum of the per-replica values EXACTLY
  (``==`` on the floats — the merge is sum-in-input-order, so the gate
  reproduces the identical fold), histogram counts/buckets sum, and the
  ``fleet`` section names all three replicas;
* asserts the seeded r0 SLO breach appears (replica-tagged) in the
  merged snapshot and in ``telemetry slo-report`` over it;
* asserts the fleet/diff CLI exit-2 contract on unreachable targets and
  empty input.

Exit 0 = all assertions hold; any failure raises. Artifacts, under
``build/pyruhvro_tpu_torch/`` by default: ``fleet_snapshot.json`` (the
merged view) and ``fleet_report_smoke.txt``. Usage::

    python scripts/torch_fleet_smoke.py [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_soaklib as soak  # noqa: E402

REPO = str(soak.REPO)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- replica side -----------------------------------------------------------


def run_replica(index: int, device: str) -> None:
    """Traffic on the card -> frozen snapshot -> static obs server;
    announce the port on stdout and hold until the parent closes
    stdin."""
    from pyruhvro_tpu_torch.api import (
        deserialize_array,
        serialize_record_batch,
    )
    from pyruhvro_tpu_torch.runtime import obs_server, telemetry
    from pyruhvro_tpu_torch.utils.datagen import (
        KAFKA_SCHEMA_JSON as K,
        kafka_style_datums,
    )

    rows = 400 * (index + 1)  # distinct per replica: sums are non-trivial
    datums = kafka_style_datums(rows, seed=100 + index)
    batch = deserialize_array(datums, K, device=device,
                              tenant=f"replica-{index}")
    serialize_record_batch(batch, K, 2, device=device)
    # tolerant traffic: every replica quarantines a few corrupt rows so
    # the merged quarantine/error counters exercise the sum path
    bad = [d[:2] for d in datums[: 3 + index]]
    deserialize_array(bad, K, device=device, on_error="skip")

    doc = telemetry.snapshot()
    srv = obs_server.ObsServer(port=0, snapshot=doc).start()
    print(f"PORT={srv.port}", flush=True)
    sys.stdin.readline()  # parent closes stdin -> exit
    srv.stop()


# -- parent side ------------------------------------------------------------


def _spawn_replicas(n: int, slo_file: str, device: str):
    procs = []
    for i in range(n):
        env = dict(os.environ)
        if i == 0:
            # r0 runs under an unmeetable latency objective: the breach
            # must survive the merge, replica-tagged
            env["PYRUHVRO_TPU_SLO_FILE"] = slo_file
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--replica", str(i), "--device", device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            text=True)
        procs.append(p)
    endpoints = []
    for i, p in enumerate(procs):
        line = p.stdout.readline().strip()
        if not line.startswith("PORT="):
            raise soak.Divergence((i, line))
        endpoints.append(f"127.0.0.1:{line.split('=', 1)[1]}")
        _log(f"[fleet-smoke] replica r{i} up at {endpoints[-1]}")
    return procs, endpoints


def main(argv=None) -> int:
    import argparse

    ap = soak.parser(__doc__, "fleet_snapshot.json")
    ap.add_argument("--replica", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    card = soak.card(args.device)
    if args.replica is not None:
        run_replica(args.replica, args.device)
        return 0

    from pyruhvro_tpu_torch.runtime import fleet, fsio, metrics
    from pyruhvro_tpu_torch.runtime.telemetry import main as telemetry_cli

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    slo_file = os.path.join(tempfile.gettempdir(),
                            f"fleet_smoke_slo_{os.getpid()}.json")
    fsio.atomic_write_json(slo_file, {"version": 1, "objectives": [{
        "name": "decode-latency", "op": "decode", "schema": "*",
        "threshold_s": 1e-9,  # unmeetable: every call is "bad"
        "target": 0.99, "windows_s": [3600], "min_calls": 1,
    }]})

    procs, endpoints = _spawn_replicas(3, slo_file, args.device)
    try:
        # the real CLI over the three live endpoints
        rc = telemetry_cli(["fleet", "-o", args.out]
                           + [x for ep in endpoints
                              for x in ("--scrape", ep)])
        if rc not in (0, None):
            raise soak.Divergence(rc)
        with open(args.out, encoding="utf-8") as f:
            merged = json.load(f)

        # the replicas serve FROZEN documents, so direct re-fetches see
        # the exact bytes the CLI scraped
        snaps = [fleet.fetch_snapshot(ep) for ep in endpoints]

        # 1) counters reconcile exactly: same left-fold float addition
        union = set()
        for s in snaps:
            union.update(s["counters"])
        if set(merged["counters"]) != union:
            raise soak.Divergence("counter key drift")
        for k in sorted(union):
            acc = 0.0
            for s in snaps:
                if k in s["counters"]:
                    acc += float(s["counters"][k])
            if merged["counters"][k] != acc:
                raise soak.Divergence((k, merged["counters"][k], acc))
        _log(f"[fleet-smoke] {len(union)} merged counters reconcile "
             f"exactly against per-replica sums")

        # 2) histograms: counts and per-bucket cumulative counts sum
        for k, h in merged["histograms"].items():
            per = [s["histograms"][k] for s in snaps
                   if k in s.get("histograms", {})]
            if h["count"] != sum(p["count"] for p in per):
                raise soak.Divergence(k)
        _log(f"[fleet-smoke] {len(merged['histograms'])} merged "
             f"histograms reconcile")

        # 3) gauge merge kinds: every merged gauge obeys its declared
        # sum-or-max fold
        for k, v in merged.get("gauges", {}).items():
            vals = [float(s["gauges"][k]) for s in snaps
                    if k in s.get("gauges", {})]
            if metrics.gauge_kind(k) == "max":
                if v != max(vals):
                    raise soak.Divergence((k, v, vals))
            else:
                acc = 0.0
                for x in vals:
                    acc += x
                if v != acc:
                    raise soak.Divergence((k, v, vals))

        # 4) fleet section: all three replicas named (scraped replicas
        # are tagged by their endpoint)
        if merged["fleet"]["count"] != 3:
            raise soak.Divergence(merged["fleet"])
        tags = [r["tag"] for r in merged["fleet"]["replicas"]]
        if tags != endpoints:
            raise soak.Divergence((tags, endpoints))

        # 5) the seeded r0 breach survives the merge, replica-tagged
        r0 = f"[{endpoints[0]}] "
        breached = (merged.get("slo") or {}).get("breached") or []
        if not any(b.startswith(r0) for b in breached):
            raise soak.Divergence(breached)
        report = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                              "fleet_report_smoke.txt")
        # slo-report prints to stdout; capture via subprocess for the
        # artifact (the CLI contract under test is the rendering)
        out = subprocess.run(
            [sys.executable, "-m", "pyruhvro_tpu_torch.telemetry",
             "slo-report", args.out],
            capture_output=True, text=True, check=True, cwd=REPO)
        if r0 + "decode-latency" not in out.stdout:
            raise soak.Divergence(out.stdout)
        with open(report, "w", encoding="utf-8") as f:
            f.write(out.stdout)
        _log("[fleet-smoke] r0 SLO breach visible in merged slo-report")

        # 6) report rendering over the merged view stays green
        out = subprocess.run(
            [sys.executable, "-m", "pyruhvro_tpu_torch.telemetry",
             "report", args.out],
            capture_output=True, text=True, check=True, cwd=REPO)
        if "phase breakdown" not in out.stdout:
            raise soak.Divergence(out.stdout[:400])
    finally:
        for p in procs:
            try:
                p.stdin.close()
                p.wait(timeout=10)
            except Exception:
                p.kill()
        try:
            os.remove(slo_file)
        except OSError:
            pass

    # 7) exit-2 contract: unreachable scrape target, empty input
    if telemetry_cli(["fleet", "--scrape", "127.0.0.1:1"]) != 2:
        raise soak.Divergence("an unreachable replica must exit 2")
    if telemetry_cli(["fleet"]) != 2:
        raise soak.Divergence("no input must exit 2")
    _log("[fleet-smoke] exit-2 contract holds")
    print(json.dumps({"metric": "fleet_smoke", "pass": True,
                      "card": card, "replicas": 3,
                      "counters": len(merged["counters"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
