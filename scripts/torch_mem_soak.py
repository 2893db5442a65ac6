#!/usr/bin/env python
"""Bounded-memory soak of the port on the card (counterpart of
``scripts/mem_soak.py``).

Two legs, one report:

1. **decompose**: the Kafka 10k case decoded on the card again and
   again. After a warm-up, steady-state RSS growth must be explained
   (at least 90 %) by the tracked cache footprints of
   ``snapshot()["memory"]``, or stay below the noise floor (nothing
   grows unseen).
2. **churn**: ``--schemas`` (2,000) distinct ``synthetic_schema_variant``
   schemas stream through the card around a hot set of ``--hot`` (64),
   under the schema-cache cap and the RSS high-water mark. Each schema
   builds its codec, arenas, buckets and K2 tables on the card, which the
   cache lifecycle must evict. RSS must stay under the mark (sampled
   every 50 schemas) and the hot set must keep a warm-hit rate of at
   least 95 %.

Beside RSS the report gives the card's ``torch.cuda.memory_allocated``
and ``memory_reserved``, read after a synchronise as the smoke's
``memory`` phase reads them in G1: the counterpart of the reference's
device accounting, not a criterion. The soak pins
``PYRUHVRO_TPU_SAMPLE_BUDGET=0`` (no background profiled build mid
measurement), and ``PYRUHVRO_TPU_NO_SPECIALIZE=1`` in the churn leg.
Usage::

    python scripts/torch_mem_soak.py [--schemas 2000] [--hot 64]
        [--decompose-rows 10000] [--decompose-calls 40]
        [--device cuda|cpu] [--out FILE]

Exit 1 when a leg misses its criterion.
"""

from __future__ import annotations

import gc
import os
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_soaklib as soak  # noqa: E402

NOISE_FLOOR_BYTES = 8 << 20  # RSS wobble below this is allocator noise


def _mb(v: float) -> float:
    return round(v / (1 << 20), 2)


def card_memory(device: str) -> dict:
    """The card's allocator after a synchronise (empty on the CPU)."""
    import torch

    if device == "cpu":
        return {}
    torch.cuda.synchronize()
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved()}


def leg_decompose(rows: int, calls: int, device: str) -> dict:
    """Steady-state RSS growth against the tracked footprint on Kafka
    ``rows``, on the card."""
    import pyruhvro_tpu_torch as p
    from pyruhvro_tpu_torch.runtime import memacct
    from pyruhvro_tpu_torch.utils.datagen import (
        KAFKA_SCHEMA_JSON,
        kafka_style_datums,
    )

    data = kafka_style_datums(rows, seed=7)
    # warm-up: schema parse, kernel builds, arenas and buckets, the
    # allocators' high water settling
    for _ in range(4):
        p.deserialize_array(data, KAFKA_SCHEMA_JSON, device=device)
    gc.collect()
    rss0 = memacct.rss_bytes()
    tracked0 = memacct.tracked_bytes()
    card0 = card_memory(device)
    for _ in range(calls):
        p.deserialize_array(data, KAFKA_SCHEMA_JSON, device=device)
    gc.collect()
    rss1 = memacct.rss_bytes()
    tracked1 = memacct.tracked_bytes()
    card1 = card_memory(device)
    rss_growth = rss1 - rss0
    tracked_growth = tracked1 - tracked0
    if rss_growth <= NOISE_FLOOR_BYTES:
        ratio = 1.0
        note = ("steady-state RSS growth below the noise floor: nothing "
                "untracked is accumulating")
    else:
        ratio = max(0.0, tracked_growth) / rss_growth
        note = "tracked cache growth over RSS growth"
    return {
        "rows": rows, "calls": calls,
        "rss_warm_mb": _mb(rss0), "rss_end_mb": _mb(rss1),
        "rss_growth_bytes": rss_growth,
        "tracked_warm_bytes": tracked0, "tracked_end_bytes": tracked1,
        "tracked_growth_bytes": tracked_growth,
        "card_warm": card0, "card_end": card1,
        "noise_floor_bytes": NOISE_FLOOR_BYTES,
        "decomposition": round(ratio, 4),
        "decomposed_90pct": ratio >= 0.9,
        "note": note,
    }


def leg_churn(schemas: int, hot: int, hot_rows: int, churn_rows: int,
              high_water_mb: int, max_schemas: int, device: str) -> dict:
    """``schemas`` distinct schemas around a hot working set under the
    high-water mark: RSS bounded, hot set warm."""
    os.environ["PYRUHVRO_TPU_NO_SPECIALIZE"] = "1"
    os.environ["PYRUHVRO_TPU_CACHE_MAX_SCHEMAS"] = str(max_schemas)
    import pyruhvro_tpu_torch as p
    from pyruhvro_tpu_torch.runtime import memacct, metrics
    from pyruhvro_tpu_torch.schema import cache as scache
    from pyruhvro_tpu_torch.schema.parser import parse_schema
    from pyruhvro_tpu_torch.utils.datagen import (
        random_datums,
        synthetic_schema_variant,
    )

    rng = random.Random(42)
    hot_set = [synthetic_schema_variant(i) for i in range(hot)]
    hot_data = {s: random_datums(parse_schema(s), hot_rows, seed=i)
                for i, s in enumerate(hot_set)}
    for s in hot_set:  # prewarm the working set
        p.deserialize_array(hot_data[s], s, device=device,
                            tenant="hot-tenant")
    gc.collect()
    base_rss = memacct.rss_bytes()
    card0 = card_memory(device)
    high_water = base_rss + (high_water_mb << 20)
    os.environ["PYRUHVRO_TPU_MEM_HIGH_WATER"] = str(high_water)
    c0 = metrics.snapshot()
    hot_calls = hot_hits = 0
    max_rss = base_rss
    max_card = dict(card0)
    t0 = time.perf_counter()
    for i in range(hot, schemas):
        s = synthetic_schema_variant(i)
        data = random_datums(parse_schema(s), churn_rows, seed=i)
        got = p.deserialize_array(data, s, device=device,
                                  tenant=f"churn-{i % 8}")
        if got.num_rows != churn_rows:
            raise soak.Divergence((i, got.num_rows))
        # interleaved hot traffic: the LRU must keep these resident
        hs = rng.choice(hot_set)
        hot_calls += 1
        if hs in scache._cache:
            hot_hits += 1
        p.deserialize_array(hot_data[hs], hs, device=device,
                            tenant="hot-tenant")
        if i % 50 == 0:
            gc.collect()
            max_rss = max(max_rss, memacct.rss_bytes())
            for k, v in card_memory(device).items():
                max_card[k] = max(max_card.get(k, 0), v)
    gc.collect()
    max_rss = max(max_rss, memacct.rss_bytes())
    elapsed = time.perf_counter() - t0
    c1 = metrics.snapshot()
    card1 = card_memory(device)

    def delta(key: str) -> float:
        return c1.get(key, 0.0) - c0.get(key, 0.0)

    warm_hit_rate = hot_hits / hot_calls if hot_calls else 0.0
    mem = memacct.snapshot_memory()
    for k in ("PYRUHVRO_TPU_MEM_HIGH_WATER", "PYRUHVRO_TPU_NO_SPECIALIZE",
              "PYRUHVRO_TPU_CACHE_MAX_SCHEMAS"):
        os.environ.pop(k, None)
    return {
        "schemas": schemas, "hot_set": hot, "hot_rows": hot_rows,
        "churn_rows": churn_rows, "max_schemas_cap": max_schemas,
        "elapsed_s": round(elapsed, 2),
        "base_rss_mb": _mb(base_rss),
        "high_water_mb_over_base": high_water_mb,
        "high_water_bytes": high_water,
        "max_rss_mb": _mb(max_rss),
        "rss_under_high_water": max_rss <= high_water,
        "card_base": card0, "card_max": max_card, "card_end": card1,
        "warm_hit_rate": round(warm_hit_rate, 4),
        "warm_hit_95pct": warm_hit_rate >= 0.95,
        "live_schema_entries": len(scache._cache),
        "evictions": {
            "lru": delta("cache.evict.schema.lru"),
            "ttl": delta("cache.evict.schema.ttl"),
            "pressure": delta("cache.evict.schema.pressure"),
            "arenas": delta("cache.evict.arenas.lru"),
            "executables": delta("cache.evict.executables.lru"),
        },
        "pressure_events": delta("mem.pressure"),
        "schema_cache": {"hits": delta("schema_cache.hits"),
                         "misses": delta("schema_cache.misses")},
        "memory_section": {
            "tracked_bytes": mem["tracked_bytes"],
            "caches": mem["caches"],
            "top_tenants": (mem.get("tenants") or [])[:4],
        },
    }


def main(argv=None) -> int:
    ap = soak.parser(__doc__, "mem_report.json")
    ap.add_argument("--schemas", type=int, default=2000)
    ap.add_argument("--hot", type=int, default=64)
    ap.add_argument("--hot-rows", type=int, default=64)
    ap.add_argument("--churn-rows", type=int, default=32)
    ap.add_argument("--high-water-mb", type=int, default=256,
                    help="high-water mark above the post-prewarm RSS")
    ap.add_argument("--max-schemas", type=int, default=512,
                    help="schema-cache cap during the churn leg (with cap "
                         "C and hot H, a hot entry must be touched again "
                         "within C-H churn admissions)")
    ap.add_argument("--decompose-rows", type=int, default=10_000)
    ap.add_argument("--decompose-calls", type=int, default=40)
    ap.add_argument("--skip-decompose", action="store_true")
    ap.add_argument("--skip-churn", action="store_true")
    args = ap.parse_args(argv)
    card = soak.card(args.device)
    os.environ.pop("PYRUHVRO_TPU_PALLAS", None)
    # no background profiled build mid measurement
    os.environ["PYRUHVRO_TPU_SAMPLE_BUDGET"] = "0"

    from pyruhvro_tpu_torch.runtime import memacct

    report = {"generated_by": "scripts/torch_mem_soak.py",
              "device": args.device, "card": card,
              "argv": list(argv if argv is not None else sys.argv[1:]),
              "cpus": os.cpu_count(),
              "baseline_rss_mb": _mb(memacct.rss_bytes())}
    ok = True
    if not args.skip_decompose:
        leg = leg_decompose(args.decompose_rows, args.decompose_calls,
                            args.device)
        report["decompose"] = leg
        ok = ok and leg["decomposed_90pct"]
        print(f"[mem_soak] decompose on {card}: rss growth "
              f"{leg['rss_growth_bytes']} B, tracked growth "
              f"{leg['tracked_growth_bytes']} B -> "
              f"{leg['decomposition']:.2%} "
              f"({'OK' if leg['decomposed_90pct'] else 'FAIL'}); card "
              f"{leg['card_warm']} -> {leg['card_end']}", flush=True)
    if not args.skip_churn:
        leg = leg_churn(args.schemas, args.hot, args.hot_rows,
                        args.churn_rows, args.high_water_mb,
                        args.max_schemas, args.device)
        report["churn"] = leg
        ok = ok and leg["rss_under_high_water"] and leg["warm_hit_95pct"]
        print(f"[mem_soak] churn on {card}: {args.schemas} schemas in "
              f"{leg['elapsed_s']}s, max rss {leg['max_rss_mb']} MB (high "
              f"water base+{args.high_water_mb} MB: "
              f"{'under' if leg['rss_under_high_water'] else 'OVER'}), "
              f"warm-hit {leg['warm_hit_rate']:.2%} "
              f"({'OK' if leg['warm_hit_95pct'] else 'FAIL'}), lru "
              f"evictions {leg['evictions']['lru']:.0f}; card "
              f"{leg['card_base']} -> max {leg['card_max']}", flush=True)
    report["pass"] = ok
    soak.write_report(args.out, report)
    print(f"[mem_soak] report -> {args.out}", flush=True)
    if not ok:
        print("[mem_soak] GATE FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
