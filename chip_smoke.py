#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pyruhvro_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; without a card, or away from the
repository's package, it exits non-zero and prints no result. It imports
nothing of JAX or of ``pyruhvro_tpu``. Phases, in order — any failure
exits non-zero before the last line:

1. device: name, capability, versions, ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` of ``pyruhvro_tpu_torch/csrc/walk_decode.cu`` (sm_90a);
3. the kernel against the plain PyTorch walk, on the card, per fixture:
   every output buffer and ``#err`` bit-equal at every rung of the item-cap
   ladder, under each shared-memory plan (``PLANS``); the decoded columns
   equal to the CPU decode's; malformed
   batches raising the same message on both. Two fixtures take the
   kernel's device-memory paths: ``oversized_block`` (a block whose
   records span more than the input staging budget) and
   ``item_staging_overflow`` (rungs whose item slices exceed the output
   staging budget);
4. the main path: ``deserialize_array_threaded`` of 1,000,000 Kafka-style
   records in 8 chunks on the card, its kernel launches counted, its
   batches equal to the same call on the CPU (whole batches with
   ``.equals()``, a fixed 10,000-row sample with ``to_pylist()``), then
   its timings (median of several warm calls) and the kernel's, with the
   kernel's buffers at those shapes bit-equal to the plain walk's, its
   shared-memory plan, and the same launch with the input or the outputs
   kept out of shared memory;
5. one ``{"kernels": [...]}`` JSON line, then
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import random
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

DEVICE = "cuda"
MAIN_ROWS = 1_000_000
MAIN_CHUNKS = 8
SAMPLE_ROWS = 10_000
# shared-memory plans every fixture runs under: the launch's own, nothing
# staged, and the output slices staged up to 48 KiB
PLANS = {"default": {}, "unstaged": {"in_max": 0, "out_max": 0},
         "staged": {"out_max": 48 << 10}}
WARM_CALLS = 5              # timed warm calls of the main path
PHASE_RUNS = 3              # decodes whose phase times give the medians
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate

LADDER_SCHEMA = """{"type":"record","name":"Big","fields":[
  {"name":"xs","type":{"type":"array","items":"long"}}]}"""
NULLS_SCHEMA = """{"type":"record","name":"Nulls","fields":[
  {"name":"xs","type":{"type":"array","items":"null"}},
  {"name":"s","type":"string"}]}"""
# the rest of the device type surface: bytes, fixed, uuid, decimals, float,
# enum, a 5-way union, a map of records with a nullable int and a date
WIDE_SCHEMA = """{"type":"record","name":"Wide","fields":[
  {"name":"b","type":"bytes"},
  {"name":"f","type":{"type":"fixed","name":"F8","size":8}},
  {"name":"u","type":{"type":"string","logicalType":"uuid"}},
  {"name":"d","type":{"type":"bytes","logicalType":"decimal",
                      "precision":20,"scale":4}},
  {"name":"df","type":{"type":"fixed","name":"DF","size":9,
                       "logicalType":"decimal","precision":16,"scale":2}},
  {"name":"x","type":"float"},
  {"name":"e","type":{"type":"enum","name":"E","symbols":["A","B","C"]}},
  {"name":"v","type":["null","long","string","double","boolean"]},
  {"name":"m","type":{"type":"map","values":{"type":"record","name":"R",
    "fields":[{"name":"a","type":["null","int"]},
              {"name":"t","type":{"type":"int","logicalType":"date"}}]}}},
  {"name":"ab","type":{"type":"array","items":"bytes"}}]}"""


def zz(v: int) -> bytes:
    """Avro long wire bytes of ``v``."""
    z = ((v << 1) ^ (v >> 63)) & ((1 << 64) - 1)
    out = bytearray()
    while z >= 0x80:
        out.append((z & 0x7F) | 0x80)
        z >>= 7
    out.append(z)
    return bytes(out)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise SystemExit(f"nvidia-smi failed ({out.returncode}): "
                         f"{out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def fixtures(datagen, parse_schema):
    """(name, schema, datums, must_fail) for the kernel-vs-plain phase."""
    kafka = datagen.KAFKA_SCHEMA_JSON
    flat = datagen.CRITERION_SHAPES["flat_primitives"]
    cases = [("kafka_20k", kafka, datagen.kafka_style_datums(20_000, seed=1),
              False)]
    for name in sorted(datagen.CRITERION_SHAPES):
        schema = datagen.CRITERION_SHAPES[name]
        cases.append((name, schema, datagen.random_datums(
            parse_schema(schema), 2_000, seed=11), False))
    rng = random.Random(6)
    ladder = []
    for _ in range(5_000):
        xs = [rng.randrange(-1000, 1000) for _ in range(rng.randrange(0, 41))]
        ladder.append((zz(len(xs)) + b"".join(map(zz, xs)) if xs else b"")
                      + zz(0))
    cases.append(("cap_ladder", LADDER_SCHEMA, ladder, False))
    cases.append(("multi_block", flat, datagen.random_datums(
        parse_schema(flat), 2_500, seed=5), False))
    cases.append(("widened_types", WIDE_SCHEMA, datagen.random_datums(
        parse_schema(WIDE_SCHEMA), 2_000, seed=13), False))

    trunc = datagen.random_datums(parse_schema(flat), 64, seed=3)
    trunc[17] = b"\x82"
    cases.append(("truncated_varint", flat, trunc, True))
    trailing = datagen.random_datums(parse_schema(flat), 16, seed=9)
    trailing[4] = trailing[4] + b"\x00"
    cases.append(("trailing_bytes", flat, trailing, True))
    flipped = datagen.kafka_style_datums(2_000, seed=7)
    for i in rng.sample(range(len(flipped)), 300):
        d = bytearray(flipped[i])
        d[rng.randrange(len(d))] ^= 1 << rng.randrange(8)
        flipped[i] = bytes(d)
    cases.append(("bit_flipped", kafka, flipped, True))
    huge = datagen.kafka_style_datums(64, seed=5)
    huge[3] = b"\x02" + zz(1 << 31) + huge[3][1:]
    huge[9] = b"\x02" + zz((1 << 31) - 1) + b"abc"
    cases.append(("string_len_2^31", kafka, huge, True))
    # zero-byte items: only the tile's loop bound ends them, so lanes cut
    # by their own bound make the wrapper relaunch with the tile bounds
    nulls = [zz(50) + zz(0) + zz(0), zz(0) + zz(200) + b"x" * 200,
             zz(5000) + zz(0) + zz(0), zz(-3) + zz(0) + zz(0) + zz(0)]
    cases.append(("zero_byte_items", NULLS_SCHEMA, nulls * 40, True))
    # records of 1.9 to 2 KiB: the first blocks span ~250 KB, past the
    # input staging budget, and read flat in device memory; the small
    # records after them are staged
    big = [zz(1) + zz(2) + bytes(8) + bytes(4) + b"\x01" + zz(n) + b"q" * n
           for n in (rng.randrange(1880, 2020) for _ in range(300))]
    cases.append(("oversized_block", flat, big + datagen.random_datums(
        parse_schema(flat), 700, seed=17), False))
    # up to 200 items: at caps 64 and above the item slices outgrow the
    # output staging budget and the kernel stores them in device memory
    deep = []
    for _ in range(1_500):
        xs = [rng.randrange(-10**9, 10**9)
              for _ in range(rng.randrange(0, 201))]
        deep.append((zz(len(xs)) + b"".join(map(zz, xs)) if xs else b"")
                    + zz(0))
    cases.append(("item_staging_overflow", LADDER_SCHEMA, deep, False))
    return cases


def outcome(dec, datums, errors):
    """``("ok", (host, n, meta))`` or ``("error", message)``."""
    try:
        return "ok", dec.decode_to_columns(datums)
    except errors as e:
        return "error", f"{type(e).__name__}: {e}"


def max_abs_diff(torch, a, b) -> int:
    """Largest difference of two equal-shape buffers, as integers (4-byte
    buffers hold bit patterns, so floats compare bit by bit)."""
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_fixture(torch, np, wd, name, schema, datums, must_fail, parse_schema,
                  errors):
    """Kernel against plain walk at every ladder rung, then the decode on
    the card against the decode on the CPU."""
    ir = parse_schema(schema)
    card = wd.WalkDecoder(ir, DEVICE)
    cpu = wd.WalkDecoder(ir, "cpu")
    prog, n = card.prog, len(datums)
    caps = card.first_caps()
    worst, rungs = 0, []
    launches0 = wd.walk_kernel.launches
    # per plan: blocks that staged their records / read them in device
    # memory, output buffers staged / stored directly (summed over rungs)
    seen = {pname: [0, 0, 0, 0] for pname in PLANS}
    while True:
        *args, tile_r = card.launch_inputs(datums, caps)
        pb, pe = wd.walk_plain(*args, prog, caps, tile_r)
        for pname, budgets in PLANS.items():
            L = wd.KernelLaunch(*args, prog, caps, tile_r, **budgets)
            for i, v in enumerate((L.blocks_staged, L.blocks_global,
                                   sum(x >= 0 for x in L.stage),
                                   sum(x < 0 for x in L.stage))):
                seen[pname][i] += v
            kb, ke = wd.walk_kernel.run(L)
            torch.cuda.synchronize()
            for key, k, p in zip(prog.out_keys + ["#err"], kb + [ke],
                                 pb + [pe]):
                diff = max_abs_diff(torch, k, p)
                if diff:
                    raise SystemExit(f"{name}: kernel ({pname} plan) != plain "
                                     f"walk in {key!r} at caps {caps} (max "
                                     f"abs diff {diff})")
                worst = max(worst, diff)
        rungs.append(max(caps))
        err = pe[:n].cpu().numpy().view(np.uint32)
        if not (err & wd.ERR_ITEM_OVERFLOW).any() or max(caps) >= wd._MAX_CAP:
            break
        caps = tuple(0 if c == 0 else 2 * c for c in caps)
    got, want = outcome(card, datums, errors), outcome(cpu, datums, errors)
    if got[0] != want[0]:
        raise SystemExit(f"{name}: card {got[0]} but CPU {want[0]}")
    if got[0] == "error":
        if got[1] != want[1]:
            raise SystemExit(f"{name}: card raised {got[1]!r}, CPU {want[1]!r}")
        detail = got[1]
    else:
        if must_fail:
            raise SystemExit(f"{name}: malformed fixture decoded cleanly")
        (hg, ng, mg), (hc, nc, mc) = got[1], want[1]
        if ng != nc or set(hg) != set(hc) or \
                mg["item_totals"] != mc["item_totals"]:
            raise SystemExit(f"{name}: decoded columns differ in shape")
        for key in hc:
            a, b = hg[key], hc[key]
            if key in prog.buffers and prog.buffers[key].region == 0:
                a, b = a[:n], b[:n]
            if a.dtype != b.dtype or not np.array_equal(
                    a.view(np.uint8), b.view(np.uint8)):
                raise SystemExit(f"{name}: decoded column {key!r} differs")
        detail = f"item_totals={mg['item_totals']}"
    default, full = seen["default"], seen["staged"]
    if name == "oversized_block" and not (default[0] and default[1]):
        raise SystemExit(f"{name}: expected staged and unstaged blocks, got "
                         f"{default[:2]}")
    if name == "item_staging_overflow" and not (full[2] and full[3]):
        raise SystemExit(f"{name}: expected staged and direct item slices "
                         f"under the staged plan, got {full[2:]}")
    print(f"fixture {name}: rows={n} rungs={rungs} kernel_launches="
          f"{wd.walk_kernel.launches - launches0} exact=True "
          f"max_abs_err={worst} blocks staged/global, buffers staged/direct "
          + " ".join(f"{k}={v[0]}/{v[1]},{v[2]}/{v[3]}" for k, v in
                     seen.items()) + f" -> {detail}")
    return worst


def take_sample(pa, batch, idx):
    return batch.take(pa.array(idx, pa.int64())).to_pylist()


def spread(xs) -> str:
    """``median (min .. max)`` of seconds, in ms."""
    return (f"{statistics.median(xs) * 1e3:.1f} ({min(xs) * 1e3:.1f} .. "
            f"{max(xs) * 1e3:.1f})")


def cuda_ms(torch, fn, repeats: int, prepare=None) -> float:
    """Best device time of ``fn`` over ``repeats`` runs, by CUDA events,
    after one warm run; ``prepare`` runs before each, untimed."""
    best = float("inf")
    for i in range(repeats + 1):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i:
            best = min(best, start.elapsed_time(end))
    return best


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    import pyarrow as pa

    from pyruhvro_tpu_torch import (
        MalformedAvro,
        UnsupportedOnDevice,
        deserialize_array_threaded,
    )
    from pyruhvro_tpu_torch.ops import walk_decode as wd
    from pyruhvro_tpu_torch.ops.arrow_build import build_record_batch
    from pyruhvro_tpu_torch.ops.codec import get_device_codec
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema
    from pyruhvro_tpu_torch.schema.parser import parse_schema
    from pyruhvro_tpu_torch.utils import datagen

    # 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = smi_name_power()
    print(f"device: {name} capability={cap} torch={torch.__version__} "
          f"cuda={torch.version.cuda} count={torch.cuda.device_count()}")
    print(smi)
    card = f"[{smi}]"

    # 2. build
    t0 = time.perf_counter()
    lib = wd.walk_kernel.library()
    print(f"build: nvcc {wd.walk_kernel.source} -> {lib.path.name} (sm_90a) "
          f"in {lib.build_s:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel against the plain walk
    errors = (MalformedAvro, UnsupportedOnDevice)
    worst = 0
    for fx in fixtures(datagen, parse_schema):
        worst = max(worst, check_fixture(torch, np, wd, *fx, parse_schema,
                                         errors))

    # 4. the main path
    schema = datagen.KAFKA_SCHEMA_JSON
    t0 = time.perf_counter()
    data = datagen.kafka_style_datums(MAIN_ROWS, seed=0)
    gen_s = time.perf_counter() - t0
    wd.walk_kernel.launches = 0
    t0 = time.perf_counter()
    batches = deserialize_array_threaded(data, schema, MAIN_CHUNKS)
    cold_s = time.perf_counter() - t0
    launches = wd.walk_kernel.launches
    if launches < 1:
        raise SystemExit("main path ran without launching walk_decode")
    warm = []
    for _ in range(WARM_CALLS):
        del batches
        t0 = time.perf_counter()
        batches = deserialize_array_threaded(data, schema, MAIN_CHUNKS)
        warm.append(time.perf_counter() - t0)
    warm_s = statistics.median(warm)
    t0 = time.perf_counter()
    expect = deserialize_array_threaded(data, schema, MAIN_CHUNKS,
                                        device="cpu")
    cpu_s = time.perf_counter() - t0
    if len(batches) != MAIN_CHUNKS or len(expect) != MAIN_CHUNKS:
        raise SystemExit(f"expected {MAIN_CHUNKS} batches")
    if sum(b.num_rows for b in batches) != MAIN_ROWS:
        raise SystemExit("row count differs from the input")
    rng = random.Random(0)
    for i, (got, want) in enumerate(zip(batches, expect)):
        if not got.equals(want):
            raise SystemExit(f"main path batch {i} differs from the CPU decode")
        idx = sorted(rng.sample(range(got.num_rows),
                                SAMPLE_ROWS // MAIN_CHUNKS))
        if take_sample(pa, got, idx) != take_sample(pa, want, idx):
            raise SystemExit(f"main path batch {i}: sampled rows differ")
    print(f"main path: deserialize_array_threaded({MAIN_ROWS} Kafka records, "
          f"{MAIN_CHUNKS}) walk_decode launches={launches}; cold "
          f"{cold_s:.3f} s, warm median of {WARM_CALLS} {warm_s:.3f} s "
          f"({min(warm):.3f} .. {max(warm):.3f}) = {MAIN_ROWS / warm_s:,.0f} "
          f"rec/s end to end (data generation {gen_s:.1f} s excluded); "
          f"equal to the CPU call ({cpu_s:.1f} s) on all {MAIN_CHUNKS} batches "
          f"and {SAMPLE_ROWS} sampled rows {card}")

    codec = get_device_codec(get_or_parse_schema(schema), DEVICE)
    dec = codec.decoder
    phases = {k: [] for k in ("pack_s", "h2d_s", "walk_s", "d2h_s",
                              "compact_s", "assembly_s")}
    for _ in range(PHASE_RUNS):
        host, n, meta = dec.decode_to_columns(data)
        t0 = time.perf_counter()
        build_record_batch(codec.ir, codec.arrow_schema, host, n, meta)
        meta["timings"]["assembly_s"] = time.perf_counter() - t0
        for k, xs in phases.items():
            xs.append(meta["timings"][k])
        del host, meta
    print(f"phases, ms, median (min .. max) of {PHASE_RUNS}: pack "
          f"(concatenate) {spread(phases['pack_s'])}, h2d "
          f"{spread(phases['h2d_s'])}, "
          f"walk+#err readback {spread(phases['walk_s'])}, d2h "
          f"{spread(phases['d2h_s'])}, host compaction "
          f"{spread(phases['compact_s'])}, Arrow assembly "
          f"{spread(phases['assembly_s'])} {card}")

    caps = dec.first_caps()
    *args, tile_r = dec.launch_inputs(data, caps)
    flat, offs, act, BW, base = args
    launch = wd.KernelLaunch(*args, dec.prog, caps, tile_r)
    # the same launch with the record spans read from device memory, with
    # the outputs stored there directly, and with neither staged
    variants = {
        "default": launch,
        "input from global": wd.KernelLaunch(*args, dec.prog, caps, tile_r,
                                             in_max=0),
        "outputs direct": wd.KernelLaunch(*args, dec.prog, caps, tile_r,
                                          out_max=0),
        "outputs staged": wd.KernelLaunch(*args, dec.prog, caps, tile_r,
                                          out_max=48 << 10),
        "neither staged": wd.KernelLaunch(*args, dec.prog, caps, tile_r,
                                          in_max=0, out_max=0),
    }
    # every row inactive: the blocks' copies, zero-fills and flushes alone
    idle = wd.KernelLaunch(flat, offs, torch.zeros_like(act), BW, base,
                           dec.prog, caps, tile_r)
    timed = {**variants, "walk skipped": idle}
    variant_ms = {}
    for key in list(timed) + list(timed)[::-1]:  # in turns
        L = timed[key]
        ms = cuda_ms(torch, lambda: wd.walk_kernel.launch(L), 5,
                     prepare=L.reset)
        variant_ms[key] = min(ms, variant_ms.get(key, ms))
    kernel_ms = variant_ms["default"]
    del idle, timed
    for key, L in variants.items():
        cut = L.cut.cpu().tolist()
        if any(cut[1:]):
            raise SystemExit(f"timed launch ({key}) cut lanes short: {cut}")
    plain = []

    def run_plain():
        plain[:] = [wd.walk_plain(*args, dec.prog, caps, tile_r)]

    plain_ms = cuda_ms(torch, run_plain, 2)
    pb, pe = plain[0]
    for vkey, L in variants.items():
        for key, k, p in zip(dec.prog.out_keys + ["#err"], L.bufs + [L.err],
                             pb + [pe]):
            diff = max_abs_diff(torch, k, p)
            if diff:
                raise SystemExit(f"main path shapes ({vkey}): kernel != plain "
                                 f"walk in {key!r} (max abs diff {diff})")
    del plain, pb, pe
    # what a launch must move: every record's bytes once (contiguous), offs,
    # act and base once, and every output element once
    R = act.numel()
    read = int(offs[-1] - offs[0]) + offs.numel() * 8 + R * 4 + R * 4
    moved = read + launch.output_bytes()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    occupancy = wd.walk_kernel.library().cdll.walk_decode_blocks_per_sm
    regs = re.findall(r"Used (\d+) registers", lib.log)
    for key, L in variants.items():
        smem = L.smem_bytes()
        print(f"walk_decode staging ({key}) at the main path's shapes: "
              f"input budget {L.in_budget} B, blocks staged "
              f"{L.blocks_staged} / read from device memory "
              f"{L.blocks_global}, output staging {L.out_bytes} B "
              f"({sum(x >= 0 for x in L.stage)} of {len(L.stage)} buffers; "
              f"the rest stored directly), shared memory {smem} B per "
              f"block, {occupancy(smem)} blocks per SM, ptxas registers "
              f"{'/'.join(regs) or 'not reported (cached build)'}")
    smem = launch.smem_bytes()
    per_sm = occupancy(smem)
    print(f"walk_decode at the main path's shapes (R={R}, BW={BW}, "
          f"caps={caps}, tile_r={tile_r}): launch {kernel_ms:.3f} ms (best "
          f"of 5 twice, in turns, CUDA events; no zero-fill: the kernel "
          f"writes every output), bit-equal to the plain walk "
          f"({plain_ms:.1f} ms); bound {bound_ms:.3f} ms ({read / 1e6:.1f} MB "
          f"read + {launch.output_bytes() / 1e6:.1f} MB written at 3.35 "
          f"TB/s), {kernel_ms / bound_ms:.2f}x the bound; variants "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in variant_ms.items())
          + f" {card}")

    kernels = [{
        "name": "walk_decode",
        "route": "cuda",
        "source": "pyruhvro_tpu_torch/csrc/walk_decode.cu",
        "replaces": "pyruhvro_tpu/ops/pallas_decode.py:256",
        "replaces_function": "PallasKernelDecoder._build",
        "launches": launches,
        "max_abs_err": worst,
        "exact": worst == 0,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        # integer byte walking: no float or tensor-core work to bound it
        "bound_by": "bytes",
        "library_ms": None,
        "variant_ms": variant_ms,
        "smem_bytes": smem,
        "blocks_per_sm": per_sm,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
