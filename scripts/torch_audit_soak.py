#!/usr/bin/env python
"""Audit soak of the port on the card (counterpart of
``scripts/audit_soak.py``).

``--rows`` (100,000) Kafka rows through the card in calls of
``--rows-per-call`` (500) at a ``--budget`` (5 %) audit budget:
``deserialize_array``, ``deserialize_array_threaded`` and
``serialize_record_batch`` in a fixed mix, with the audit plane's
force-next latch armed every fourth call, so that dozens of calls are
shadowed through the pure-Python oracle whatever the measured cost
ratio. The gate:

* **zero mismatches**: every audited call's column digests agree between
  the card and the oracle's re-execution;
* **audits fired** and the age-decayed **coverage is positive**;
* **no shadow errors** (nothing chaotic is injected here);
* the plane's amortised shadow fraction (cost ratio over period) within
  the budget.

Usage::

    python scripts/torch_audit_soak.py [--rows 100000]
        [--rows-per-call 500] [--budget 0.05] [--device cuda|cpu]
        [--out FILE]

Exit 1 on any invariant violation.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_soaklib as soak  # noqa: E402

WATCHDOG_S = 900


def main(argv=None) -> int:
    ap = soak.parser(__doc__, "audit_report.json")
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--rows-per-call", type=int, default=500)
    ap.add_argument("--budget", type=float, default=0.05)
    args = ap.parse_args(argv)
    card = soak.card(args.device)
    os.environ.pop("PYRUHVRO_TPU_PALLAS", None)
    os.environ["PYRUHVRO_TPU_AUDIT_BUDGET"] = str(args.budget)
    with soak.watchdog(WATCHDOG_S):
        return run(args, card)


def run(args, card) -> int:
    import pyruhvro_tpu_torch as p
    from pyruhvro_tpu_torch.runtime import audit, metrics, telemetry
    from pyruhvro_tpu_torch.utils.datagen import (
        KAFKA_SCHEMA_JSON,
        kafka_style_datums,
    )

    dev = args.device
    calls = max(1, args.rows // args.rows_per_call)
    print(f"[audit-soak] {calls} calls x {args.rows_per_call} rows at "
          f"budget {args.budget} on {card}", flush=True)
    # a few distinct corpora, so that decode and encode both see audits
    corpora = [kafka_style_datums(args.rows_per_call, seed=s)
               for s in range(8)]
    batches = [p.deserialize_array(c, KAFKA_SCHEMA_JSON, device=dev)
               for c in corpora]
    telemetry.reset()
    audit.reset()
    t0 = time.perf_counter()
    rows = 0
    for i in range(calls):
        if i % 4 == 0:
            audit.force_next()  # taken by the next eligible call
        if i % 5 == 4:
            p.serialize_record_batch(batches[i % len(batches)],
                                     KAFKA_SCHEMA_JSON, 2, device=dev)
        elif i % 3 == 2:
            p.deserialize_array_threaded(corpora[i % len(corpora)],
                                         KAFKA_SCHEMA_JSON, 2, device=dev)
        else:
            p.deserialize_array(corpora[i % len(corpora)],
                                KAFKA_SCHEMA_JSON, device=dev)
        rows += args.rows_per_call
    wall_s = time.perf_counter() - t0

    snap = telemetry.snapshot()
    aud = snap.get("audit") or {}
    counters = metrics.snapshot()
    period = max(1, int(aud.get("period") or 1))
    amortized = float(aud.get("cost_ratio") or 0.0) / period
    checks = {
        "zero_mismatches": int(aud.get("mismatches") or 0) == 0,
        "audits_fired": int(aud.get("audited") or 0) > 0,
        "coverage_positive": float(aud.get("coverage") or 0.0) > 0.0,
        "no_shadow_errors": int(aud.get("shadow_errors") or 0) == 0,
        "amortized_within_budget": amortized <= args.budget + 0.005,
    }
    ok = all(checks.values())
    report = {
        "generated_by": "scripts/torch_audit_soak.py",
        "device": dev, "card": card, "rows": rows, "calls": calls,
        "budget": args.budget, "wall_s": wall_s,
        "amortized_shadow_frac": amortized, "checks": checks, "ok": ok,
        "audit": aud,
        "mismatch_counters": {k: v for k, v in counters.items()
                              if k.startswith("audit.mismatch")},
        "rendered": audit.render_audit_report(snap),
    }
    soak.write_report(args.out, report)
    print(report["rendered"], flush=True)
    for name, passed in checks.items():
        print(f"[audit-soak] {'PASS' if passed else 'FAIL'} {name}",
              flush=True)
    print(f"[audit-soak] {'OK' if ok else 'FAILED'}: {rows} rows on {card}, "
          f"{aud.get('audited')} audited, {aud.get('mismatches')} "
          f"mismatches, coverage {aud.get('coverage')}, wall {wall_s:.1f}s "
          f"-> {args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
