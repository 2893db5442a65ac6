#!/usr/bin/env python
"""Malformed-bytes soak of the port on the card (counterpart of
``scripts/malformed_soak.py``).

Random schemas x mutated corpora (``utils.datagen.mutate_corpus``:
truncations, bit flips, splices) through the card's device tier and the
native VM (``backend="host"``) against the pure-Python oracle:

* per record, accept against reject: every record either decodes equal
  to the oracle or raises a data error (``MalformedAvro`` and the
  ValueError family) where the oracle does; a device limit
  (``UnsupportedOnDevice``, ``DeviceCapacityExceeded``,
  ``BatchTooLarge``) or any other exception fails the seed. The card's
  calls are made with ``backend="device"`` and held there
  (``torch_soaklib.on_device``: no host tier answers in its place);
* under ``on_error="skip"``: the oracle (``PYRUHVRO_TPU_NO_NATIVE=1``),
  the VM and the card return equal surviving rows and quarantine the
  oracle's rejects, index by index; under ``on_error="raise"`` each
  raises exactly when the oracle rejects a record;
* on the card, each quarantine entry's index and slug, the batch, and
  the raised error's type, message and index also equal the kernels'
  plain versions' (``backend="device", device="cpu"``): a slug names
  what the tier's own walk found, so the tiers' slugs may differ
  (``neg_len`` against ``overrun``), and the tier field keeps the port's
  departures (``ROADMAP.md`` (c) 4 and 5).

Usage::

    python scripts/torch_malformed_soak.py [--first 200] [--count 40]
        [--rows 40] [--device cuda|cpu] [--out FILE]

Exit 1 on any divergence.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_soaklib as soak  # noqa: E402


def raised(fn):
    """``(type name, message, index)`` of the data error ``fn`` raises,
    or None."""
    ok, got = soak.verdict(fn)
    return None if ok else (type(got).__name__, str(got),
                            getattr(got, "index", None))


def check_seed(seed: int, rows: int, device: str, tally: dict, *,
               batch_only: bool = False):
    """``random_schema(seed)``'s mutated corpus of ``rows`` records through
    the card (``backend="device"``, held there by
    :func:`torch_soaklib.on_device`) and the VM against the oracle;
    raises ``Divergence`` naming the leg that differs. Unless
    ``batch_only`` (``chip_smoke.py``'s ``fuzz`` phase, which holds each
    kernel against its plain version itself), every tier is also called
    on each record alone, and the card is held against the kernels'
    plain versions (``backend="device", device="cpu"``; not when
    ``device`` is the CPU, where the card leg is those versions).
    Returns ``(schema, entry, corpus)``."""
    import pyruhvro_tpu_torch as p
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema
    from pyruhvro_tpu_torch.utils.datagen import (
        mutate_corpus,
        random_datums,
        random_schema,
    )

    schema = random_schema(seed)
    e = get_or_parse_schema(schema)
    corpus = mutate_corpus(random_datums(e.ir, rows, seed=seed + 5000), seed)
    card = {"backend": "device", "device": device}
    tiers = {"card": lambda f: soak.on_device(f), "host": lambda f: f()}
    kw = {"card": card, "host": {"backend": "host"}}

    # the oracle's verdicts: its tolerant call (the VM switched off)
    os.environ["PYRUHVRO_TPU_NO_NATIVE"] = "1"
    try:
        fb, fq = soak.tolerant(corpus, schema, backend="host")
    finally:
        del os.environ["PYRUHVRO_TPU_NO_NATIVE"]
    rejects = [i for i, _ in fq]
    if not batch_only:
        for j, d in enumerate(corpus):
            ok, want = soak.verdict(lambda: soak.oracle([d], e))
            if ok == (j in rejects):
                raise soak.Divergence(
                    f"record {j}: the oracle's tolerant call and its "
                    f"one-record call disagree")
            for tier, held in tiers.items():
                got_ok, got = soak.verdict(lambda: held(
                    lambda: p.deserialize_array([d], schema, **kw[tier])))
                if got_ok != ok:
                    raise soak.Divergence(
                        f"record {j}: {tier} "
                        f"{'accepts' if got_ok else 'rejects'} where the "
                        f"oracle {'accepts' if ok else 'rejects'} "
                        f"({got if not got_ok else want!r}); datum={d!r}")
                if ok and not got.equals(want):
                    raise soak.Divergence(f"record {j}: {tier} values "
                                          f"differ")
    for tier, held in tiers.items():
        got, q = held(lambda: soak.tolerant(corpus, schema, **kw[tier]))
        if [i for i, _ in q] != rejects:
            raise soak.Divergence(
                f"skip: {tier} quarantined {[i for i, _ in q]}, the oracle "
                f"{rejects}")
        if not got.equals(fb):
            raise soak.Divergence(f"skip: {tier}'s surviving rows differ")
        err = raised(lambda: held(lambda: p.deserialize_array(
            corpus, schema, **kw[tier])))
        if (err is not None) != bool(rejects):
            raise soak.Divergence(f"raise: {tier} raised {err}")
    if not batch_only and device != "cpu":
        # the card against its plain versions: each entry's slug too
        cpu = {"backend": "device", "device": "cpu"}
        pb, pq = soak.on_device(lambda: soak.tolerant(corpus, schema, **cpu))
        got, q = soak.on_device(lambda: soak.tolerant(corpus, schema,
                                                      **card))
        if q != pq:
            raise soak.Divergence(f"skip: card entries {q}, plain "
                                  f"versions' {pq}")
        if not got.equals(pb):
            raise soak.Divergence("skip: card and plain versions differ")
        want = raised(lambda: soak.on_device(lambda: p.deserialize_array(
            corpus, schema, **cpu)))
        err = raised(lambda: soak.on_device(lambda: p.deserialize_array(
            corpus, schema, **card)))
        if err != want:
            raise soak.Divergence(f"raise: card {err}, plain versions {want}")
    tally["records"] += len(corpus)
    tally["rejects"] += len(rejects)
    tally["quarantined"] += len(fq)
    return schema, e, corpus


def main(argv=None) -> int:
    ap = soak.parser(__doc__, "malformed_soak.json")
    ap.add_argument("--first", type=int, default=200)
    ap.add_argument("--count", type=int, default=40)
    ap.add_argument("--rows", type=int, default=40)
    args = ap.parse_args(argv)
    card = soak.card(args.device)
    for name in ("PYRUHVRO_TPU_PALLAS", "PYRUHVRO_TPU_NO_NATIVE"):
        os.environ.pop(name, None)
    os.environ.setdefault("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")

    tally = {"records": 0, "rejects": 0, "quarantined": 0}
    failed = []
    t0 = time.perf_counter()
    for seed in range(args.first, args.first + args.count):
        try:
            check_seed(seed, args.rows, args.device, tally)
        except Exception as ex:  # noqa: BLE001 — reported, then exit 1
            failed.append({"seed": seed, "error": repr(ex)})
            print(f"SEED {seed} FAILED: {ex!r}", flush=True)
            traceback.print_exc()
            if len(failed) > 3:
                break
        if seed % 10 == 0:
            print(f"seed {seed} ok", flush=True)
    seconds = time.perf_counter() - t0
    doc = {"generated_by": "scripts/torch_malformed_soak.py",
           "device": args.device, "card": card,
           "seeds": [args.first, args.first + args.count - 1],
           "schemas": args.count, **tally, "failures": len(failed),
           "failed": failed, "seconds": seconds}
    soak.write_report(args.out, doc)
    print(f"malformed soak: {args.count} schemas, {tally['records']} "
          f"records ({tally['rejects']} rejected) on {card}: "
          f"{len(failed)} failures; {seconds:.1f} s -> {args.out}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
