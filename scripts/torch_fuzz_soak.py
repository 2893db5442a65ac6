#!/usr/bin/env python
"""Differential fuzz soak of the port on the card (counterpart of
``scripts/fuzz_soak.py``).

Random schemas (``utils.datagen.random_schema``: unions, maps of
records, decimals, fixed, enums, uuid, nested up to depth 3) with random
records, through every tier of the port against its pure-Python oracle
(``fallback/decoder.py``):

* the card's pipeline decoder, K1 + K2 (``deserialize_array``), and its
  encoder, K3 (``serialize_record_batch``), on every seed, called with
  ``backend="device"`` and held to the device tier (a device limit
  raises, no host tier answers in the card's place): the kernels
  are schema-generic and built once, so the reference's every-fifth-seed
  sampling (an XLA compile per schema) has no counterpart;
* the K4 engine (``WalkDecoder``, what ``PYRUHVRO_TPU_PALLAS=1`` serves)
  on the seeds whose schema it takes; the ``UnsupportedOnDevice`` it
  raises on the others is counted, never hidden;
* the native VM (``backend="host"``), decode and encode;
* truncation: the first records cut in half, where every tier must
  reject as the oracle does or decode as it does.

Every decode must equal the oracle's batch and every encode give back
the input wire. K2's launch takes its 64-pointer parameter block up to
64 walk buffers and its 4,000-pointer block past them; a random schema
has at most about 40, so every ``--wide``-th seed also runs a composite
schema, the fields of that seed's and the next ``--wide`` - 1 seeds'
schemas in one record (about 150 buffers). The output counts the
schemas of each block and those past its 3,999 sources, which the card
cannot take (``ROADMAP.md`` (c) 15) and which run on the host tier
only. Usage::

    python scripts/torch_fuzz_soak.py [--first 100] [--count 250]
        [--rows 40] [--wide 10] [--device cuda|cpu] [--out FILE]

Exit 1 on any divergence (the report names the seed and the leg).
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_soaklib as soak  # noqa: E402

TRUNCATED = 4  # records cut in half per seed


def launches():
    """Each kernel's launch count (its wrapper's counter; the plain
    versions on the CPU count nothing)."""
    from pyruhvro_tpu_torch.ops import decode as dm
    from pyruhvro_tpu_torch.ops import encode as em
    from pyruhvro_tpu_torch.ops import walk_decode as wd

    return {"decode_walk": dm.walk_kernel.launches,
            "decode_finalize": dm.finalize_kernel.launches,
            "walk_decode": wd.walk_kernel.launches,
            "encode_rows": em.encode_kernel.rows.launches,
            "encode_strings": em.encode_kernel.strings.launches}


def wire(arrays):
    return [bytes(x) for a in arrays for x in a.to_pylist()]


def composite_schema(seeds) -> str:
    """One record holding the fields of ``random_schema(s)`` for every
    seed ``s``, each field and named type prefixed by its seed."""
    import json

    from pyruhvro_tpu_torch.utils.datagen import random_schema

    def rename(t, s):
        if isinstance(t, list):
            return [rename(v, s) for v in t]
        if not isinstance(t, dict):
            return t
        t = dict(t)
        if t.get("type") in ("record", "enum", "fixed"):
            t["name"] = f"S{s}{t['name']}"
        for key in ("items", "values"):
            if key in t:
                t[key] = rename(t[key], s)
        if "fields" in t:
            t["fields"] = [{**f, "type": rename(f["type"], s)}
                           for f in t["fields"]]
        return t

    fields = [{"name": f"s{s}_{f['name']}", "type": rename(f["type"], s)}
              for s in seeds
              for f in json.loads(random_schema(s))["fields"]]
    return json.dumps({"type": "record", "name": f"Wide{seeds[0]}",
                       "fields": fields})


def check_seed(seed: int, rows: int, device: str, tally: dict,
               schema: str = None):
    """One schema (``random_schema(seed)`` unless given) through every
    tier; raises ``Divergence`` naming the leg that differs. The card's
    calls are made with ``backend="device"`` and held there
    (:func:`torch_soaklib.on_device`), so a device limit raises and no
    host tier answers in the card's place. Returns ``(entry, datums,
    oracle batch, whether K4 took the schema)``, or None for a schema
    past K2's sources."""
    import pyruhvro_tpu_torch as p
    from pyruhvro_tpu_torch import UnsupportedOnDevice
    from pyruhvro_tpu_torch.ops.arrow_build import build_record_batch
    from pyruhvro_tpu_torch.ops.decode import FIN_SRC_MAX
    from pyruhvro_tpu_torch.ops.fieldprog import lower
    from pyruhvro_tpu_torch.ops.walk_decode import WalkDecoder
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema
    from pyruhvro_tpu_torch.utils.datagen import random_datums, random_schema

    schema = schema or random_schema(seed)
    e = get_or_parse_schema(schema)
    datums = random_datums(e.ir, rows, seed=seed + 9000)
    want = soak.oracle(datums, e)
    card = {"backend": "device", "device": device}

    got = p.deserialize_array(datums, schema, backend="host")
    if not got.equals(want):
        raise soak.Divergence("host decode mismatch")
    if wire(p.serialize_record_batch(want, schema, 1,
                                     backend="host")) != datums:
        raise soak.Divergence("host encode")

    n_src = len(lower(e.ir).out_keys) + 1
    tally["max_sources"] = max(tally["max_sources"], n_src)
    on_card = n_src <= FIN_SRC_MAX
    k4_took = False
    if not on_card:
        tally["past_k2_sources"] += 1  # the host tier's only
    else:
        tally["k2_large_block" if n_src > 64 else "k2_small_block"] += 1
        got = soak.on_device(lambda: p.deserialize_array(datums, schema,
                                                         **card))
        if not got.equals(want):
            raise soak.Divergence("card decode mismatch")
        if wire(soak.on_device(lambda: p.serialize_record_batch(
                want, schema, 1, **card))) != datums:
            raise soak.Divergence("card encode")
        try:
            k4 = WalkDecoder(e.ir, device, fingerprint=e.fingerprint)
            host, n, meta = k4.decode_to_columns(datums)
        except UnsupportedOnDevice as ex:
            tally["k4_declined"] += 1
            why = tally["k4_declined_why"]
            why[str(ex)[:60]] = why.get(str(ex)[:60], 0) + 1
        else:
            tally["k4_seeds"] += 1
            k4_took = True
            got = build_record_batch(e.ir, e.arrow_schema, host, n, meta)
            if not got.equals(want):
                raise soak.Divergence("K4 decode mismatch")

    for d in datums[:TRUNCATED]:
        if not d:
            continue
        cut = [d[: len(d) // 2]]
        ok, ref = soak.verdict(lambda: soak.oracle(cut, e))
        legs = {"host": lambda: p.deserialize_array(cut, schema,
                                                    backend="host")}
        if on_card:
            legs["card"] = lambda: soak.on_device(
                lambda: p.deserialize_array(cut, schema, **card))
        for leg, fn in legs.items():
            got_ok, got = soak.verdict(fn)
            if got_ok != ok:
                raise soak.Divergence(
                    f"truncation: {leg} {'accepts' if got_ok else 'rejects'}"
                    f" where the oracle {'accepts' if ok else 'rejects'}: "
                    f"{got if not got_ok else ref!r}")
            if ok and not got.equals(ref):
                raise soak.Divergence(f"truncation: {leg} values differ")
        tally["truncations"] += 1
    return (e, datums, want, k4_took) if on_card else None


def main(argv=None) -> int:
    ap = soak.parser(__doc__, "fuzz_soak.json")
    ap.add_argument("--first", type=int, default=100)
    ap.add_argument("--count", type=int, default=250)
    ap.add_argument("--rows", type=int, default=40)
    ap.add_argument("--wide", type=int, default=10,
                    help="a composite schema every this many seeds "
                         "(0: none)")
    args = ap.parse_args(argv)
    card = soak.card(args.device)
    os.environ.pop("PYRUHVRO_TPU_PALLAS", None)
    os.environ.setdefault("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")

    tally = {"max_sources": 0, "k2_small_block": 0, "k2_large_block": 0,
             "past_k2_sources": 0, "composite_schemas": 0,
             "k4_seeds": 0, "k4_declined": 0, "k4_declined_why": {},
             "truncations": 0}
    before = launches()
    failed = []
    t0 = time.perf_counter()
    for seed in range(args.first, args.first + args.count):
        try:
            check_seed(seed, args.rows, args.device, tally)
            if args.wide and (seed - args.first) % args.wide == 0:
                tally["composite_schemas"] += 1
                check_seed(seed, args.rows, args.device, tally,
                           composite_schema(range(seed, seed + args.wide)))
        except Exception as ex:  # noqa: BLE001 — reported, then exit 1
            failed.append({"seed": seed, "error": repr(ex)})
            print(f"SEED {seed} FAILED: {ex!r}", flush=True)
            traceback.print_exc()
            if len(failed) > 3:
                break
        if seed % 25 == 0:
            print(f"seed {seed} ok", flush=True)
    seconds = time.perf_counter() - t0
    after = launches()
    doc = {"generated_by": "scripts/torch_fuzz_soak.py",
           "device": args.device, "card": card,
           "seeds": [args.first, args.first + args.count - 1],
           "schemas": args.count + tally["composite_schemas"],
           "records": (args.count + tally["composite_schemas"]) * args.rows,
           **tally,
           "launches": {k: after[k] - before[k] for k in after},
           "failures": len(failed), "failed": failed,
           "seconds": seconds}
    if args.device != "cpu":
        idle = [k for k, v in doc["launches"].items() if not v]
        if idle:
            doc["failures"] += 1
            doc["failed"].append({"error": f"kernels never launched: {idle}"})
    soak.write_report(args.out, doc)
    print(f"fuzz soak: {doc['schemas']} schemas ({tally['composite_schemas']}"
          f" composite) x {args.rows} records on {card}: {doc['failures']} "
          f"failures; K4 took {tally['k4_seeds']} and declined "
          f"{tally['k4_declined']}; K2 64-pointer block "
          f"{tally['k2_small_block']}, 4,000-pointer block "
          f"{tally['k2_large_block']}, past its sources "
          f"{tally['past_k2_sources']} (max {tally['max_sources']}); "
          f"launches {doc['launches']}; {seconds:.1f} s -> {args.out}",
          flush=True)
    return 1 if doc["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
