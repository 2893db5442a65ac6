"""What K2's launch parameter block costs: ``decode_finalize`` as it ships
(room for 64 source pointers where a schema has at most 64) against a
build that always takes room for 4,000, in turns, on the card.

    python3 scripts/k2_param_block.py [--rounds 4] [--rows 1000000]

The walk buffers' pointers travel by value in each launch's parameter
block (``Call`` in ``pyruhvro_tpu_torch/csrc/decode_finalize.cu``: 32,040
bytes at 4,000 pointers, 552 at 64). The script builds that source twice
with ``nvcc`` and the flags of ``ops/_build.py``, once as it ships and
once with ``-DFIN_SRC_SMALL=4000``, both builds at once, into
``build/k2_param_block/``, and prints each build's seconds and its
``ptxas`` register lines. It makes ``--rows`` Kafka records
(``utils/datagen.py``, seed 0) and decodes them once, overlapped and as
one launch, to settle the ladder's caps. Then, at path 1's chunk shapes
(its largest chunk of ``overlap_chunks(rows)``) and at its one-launch
shapes, it runs K1 once and times one K2 run with each build in turns
(64, 4000, 4000, 64; ``--rounds`` times; a Kafka launch has 34
sources): CUDA events on an idle stream and back to back behind a spin
(``chip_smoke.cuda_ms`` / ``queued_ms``, best of 5 each), and the
host's enqueue of the run (``perf_counter``, median of 5). Both builds' blobs must be bit-equal to
the plain finalize. It prints the card's name and power limit, one line
per shape with the medians over the rounds, and writes everything to
``--out`` (by default ``build/k2_param_block.json``). Needs one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# the room for source pointers a Kafka launch gets -> nvcc's extra flags
VARIANTS = {64: [], 4000: ["-DFIN_SRC_SMALL=4000"]}


def build(_build, out_dir: Path) -> dict:
    """Both builds of ``decode_finalize.cu``, at once: ``{n: (path,
    seconds, nvcc log)}``."""
    src = Path(_build.CSRC) / "decode_finalize.cu"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, flags in VARIANTS.items():
        out = out_dir / f"decode_finalize-{n}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
               str(src)]
        procs[n] = (out, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for n, (out, t0, proc) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed ({proc.returncode}) for "
                             f"{n} pointers:\n{log}")
        built[n] = (out, seconds, log)
    return built


def kernel_of(dm, _build, path: Path, seconds: float, log: str):
    """A ``_FinalizeKernel`` that launches the library at ``path``."""
    import ctypes

    lib = _build.KernelLibrary(ctypes.CDLL(str(path)), path, seconds, log)

    class Build(dm._FinalizeKernel):
        def library(self):
            real = _build.load_kernel_library
            _build.load_kernel_library = lambda source: lib
            try:
                return super().library()
            finally:
                _build.load_kernel_library = real

    return Build()


def shape_inputs(dm, dec, rows):
    """K1's outputs at the rung ``dec`` settled for ``rows``: ``(bufs,
    err, R, B, item_caps, tot_caps, compact)``."""
    flat, lanes, n, R, B = dec.pack(rows)
    packed = dec.launch_buffer(flat, lanes, B, "cuda")
    item_caps, tot_caps = dec.caps_snapshot(R)
    compact = (R, B) not in dec._str_full
    words, starts, lengths = dec.launch_views(packed, R, B)
    L = dm.WalkLaunch(words, starts, lengths, n, dec.prog, item_caps)
    bufs, err = dm.walk_kernel.run(L)
    return bufs, err, R, B, item_caps, tot_caps, compact


def time_shape(torch, dm, kernels, prog, inputs, rounds: int) -> dict:
    bufs, err, R, B, item_caps, tot_caps, compact = inputs
    want = dm.finalize_plain(bufs, err, prog, R, B, item_caps, tot_caps,
                             compact)
    plans = {}
    for n, k in kernels.items():
        plans[n] = dm.FinalizePlan(bufs, err, prog, R, B, item_caps,
                                   tot_caps, compact, dm.FinalizeCache())
        blob = k.run(plans[n])
        torch.cuda.synchronize()
        if not torch.equal(blob, want):
            raise SystemExit(f"{n} pointers: blob != plain finalize")
    got = {n: {"ms": [], "queued_ms": [], "enqueue_ms": []}
           for n in kernels}
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for _ in range(rounds):
        for n in order:
            k, plan = kernels[n], plans[n]
            got[n]["ms"].append(chip_smoke.cuda_ms(
                torch, lambda: k.run(plan), 5))
            got[n]["queued_ms"].append(chip_smoke.queued_ms(
                torch, lambda: k.run(plan), 5))
            enqueue = []
            for _i in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                k.run(plan)
                enqueue.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            got[n]["enqueue_ms"].append(statistics.median(enqueue[1:]))
    plan = next(iter(plans.values()))
    return {"R": R, "B": B, "launches": plan.tables.launches,
            "n_src": len(plan.srcs), "runs": got}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--rows", type=int, default=chip_smoke.MAIN_ROWS)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "k2_param_block.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k2_param_block: needs a CUDA card", file=sys.stderr)
        return 2
    from pyruhvro_tpu_torch.ops import _build
    from pyruhvro_tpu_torch.ops import decode as dm
    from pyruhvro_tpu_torch.runtime.chunking import chunk_bounds
    from pyruhvro_tpu_torch.schema.parser import parse_schema
    from pyruhvro_tpu_torch.utils import datagen

    card = chip_smoke.smi_name_power()
    print(card, flush=True)
    built = build(_build, ROOT / "build" / "k2_param_block")
    report = {"card": card, "builds": {}, "shapes": {}}
    for n, (path, seconds, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "bytes stack frame" in ln]
        report["builds"][n] = {"seconds": seconds, "ptxas": regs}
        print(f"{n} pointers: built in {seconds:.1f} s; " +
              " | ".join(regs), flush=True)
    kernels = {n: kernel_of(dm, _build, p, s, log)
               for n, (p, s, log) in built.items()}

    rows = datagen.kafka_style_datums(args.rows, seed=0)
    schema = parse_schema(datagen.KAFKA_SCHEMA_JSON)
    n_chunks = dm.overlap_chunks(len(rows))
    bounds = chunk_bounds(len(rows), n_chunks)
    a, b = max(bounds, key=lambda ab: sum(map(len, rows[ab[0]:ab[1]])))
    chunked = dm.DeviceDecoder(schema, "cuda")
    chunked.decode_to_columns_overlapped(rows, n_chunks)
    whole = dm.DeviceDecoder(schema, "cuda")
    whole.decode_to_columns(rows)
    for label, dec, part in (("path 1's chunk shapes", chunked, rows[a:b]),
                             ("path 1's one-launch shapes", whole, rows)):
        res = time_shape(torch, dm, kernels, dec.prog,
                         shape_inputs(dm, dec, part), args.rounds)
        report["shapes"][label] = res
        med = {n: {k: statistics.median(v) for k, v in r.items()}
               for n, r in res["runs"].items()}
        print(f"K2 at {label} (R={res['R']}, {res['n_src']} sources, "
              f"{res['launches']} launches a run), medians of "
              f"{args.rounds} rounds in turns 64/4000/4000/64, ms: " +
              "; ".join(f"{n} pointers: idle {m['ms']:.4f}, queued "
                        f"{m['queued_ms']:.4f}, host enqueue "
                        f"{m['enqueue_ms']:.4f}" for n, m in med.items()) +
              f"; all runs {json.dumps(res['runs'])} {card}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
