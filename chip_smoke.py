#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pyruhvro_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; without a card, or away from the
repository's package, it exits non-zero and prints no result. It imports
nothing of JAX or of ``pyruhvro_tpu``. Phases, in order — any failure
exits non-zero before the last line:

1. device: name, capability, versions, ``nvidia-smi`` name and power limit;
2. build: one ``nvcc`` (sm_90a) per source of ``pyruhvro_tpu_torch/csrc``
   (``walk_decode.cu``, ``decode_walk.cu``, ``decode_finalize.cu``,
   ``encode.cu``) and one ``g++`` for the native record pack
   (``packer.cpp``), all started together, with ptxas registers and
   spills, and the ``g++`` command and its seconds;
3. ``walk_decode`` (K4, the ``PYRUHVRO_TPU_PALLAS`` engine) against its
   plain walk on 15 fixtures: every buffer and ``#err`` bit-equal at every
   rung of the item-cap ladder under each shared-memory plan (``PLANS``),
   the card's decode equal to the CPU's, malformed batches raising the
   same message on both;
4. ``decode_walk`` (K1) and ``decode_finalize`` (K2, the default engine)
   against their plain versions on ``pipeline_fixtures`` at every rung the
   card decoder's ladder visits, and on ``block_edge_fixtures`` (reads
   that leave a K1 block's staged span, a block over its staging budget):
   every buffer, ``#err`` and the blob bit-equal (K2's blob filled with
   0xA5 first), the blocks K1 counts staged and reading device memory
   equal to its host mirror's plan at every launch (both kinds must
   occur); the card's decode equal to the CPU's, or the same message and
   bad-row indices; then ``encode_rows`` and ``encode_strings`` (K3)
   against the plain encode on ``encode_fixtures`` (row sizes, every
   ``#dst`` lane and ``[0, total)`` bit-equal), the card's encode equal
   to the CPU's and the wire a fixed point of decode and encode;
5. four decode main paths through ``deserialize_array_threaded(..., 8)``,
   each with every launch count set to 0 before its cold call and read
   after it, and its batches equal to the same call on the CPU by value:
   (1) 1,000,000 Kafka records on the default engine, (2) the same under
   ``PYRUHVRO_TPU_PALLAS=1``, (3) 262,144 nested ``arr_rec_arr`` records,
   (4) 16,384 Kafka records of 4 to 16 KiB; paths 1, 3 and 4 run the
   overlapped chunk path (8, 8 and 4 chunks; path 1's warm call must
   launch ``decode_walk`` once per chunk), and path 1 runs once more on
   one launch under ``PYRUHVRO_TPU_OVERLAP=0`` (1s), its warm calls in
   turns with the overlapped ones, equal to the CPU call too; then the
   encode main path (5)
   ``serialize_record_batch(batch, schema, 8)`` of path 1's records
   decoded on the card into one batch, and the same re-encode of paths 3
   and 4 (3e, 4e), the chunks equal to the input datums and to the CPU
   call; the cold call and the median of ``WARM_CALLS`` warm calls of
   each; then the ``policy`` phase, each case held against the same call
   with ``device="cpu"``: P1 ``on_error="skip"`` on path 1's records with
   one row in every ``POLICY_EVERY`` replaced by ``b"\\x01"`` (every
   planted row quarantined with ``tier="device"``, the batches and entries
   equal to the CPU call's, K1 and K2 launches counted from 0, the cold
   and warm calls, the warm calls in turns with clean path 1, and once on
   the K4 engine), P2 the records as a ``BinaryArray`` (equal batches,
   ``pack_s`` in turns with the list), P3 ``timeout_s=0`` (raises before
   any launch) and ``timeout_s=600`` (P1's result), P4 ``backend="host"``
   on ``POLICY_HOST_ROWS`` records (decode and encode equal to the
   card's), P5 the encode bisect on ``POLICY_ENCODE_ROWS`` one-byte
   decimals with 4 that do not fit under ``"skip"`` and ``"null"`` (the
   planted rows quarantined, the wire equal to the CPU call's, the
   ``encode_rows`` launches it took);
6. per path, the phases (pack, h2d, walk, finalize or compaction, d2h,
   Arrow assembly; for encode extract, pack, h2d, size, cumsum, write,
   strings, d2h, wrap); on the overlapped paths the native pack against
   the Python join on the same records, each copy's device time (pinned
   h2d, blob d2h), ``overlap_s`` and ``overlap_frac``, the assembly of
   each chunk and the concatenation of the chunks' batches, and the cold
   call of a fresh decoder without and with a capacity-planner hit; K1
   and K2 bit-equal to their plain versions at every rung of every
   chunk of a fresh decoder on paths 1, 3 and 4's data (and of path 1's
   one launch); K1 and K2 at each overlapped path's chunk shapes and at
   path 1's one-launch shape: CUDA-event time, bound, plain version,
   ``torch.take``; each kernel at main path 1's, 2's or 5's shapes: its
   CUDA-event time,
   bit-equal to its plain version, its bound, and ``torch.take`` over the
   finalize's slot maps and over the encode's payload byte map; K1 at
   path 1's shapes under its input budgets, loop stacks and key folding
   (``k1_kernel``: each in turns, bit-equal, with the blocks it counted
   staged and reading device memory, its shared memory and blocks per
   SM; ptxas per instantiation; the host's enqueue), and on path 3's
   shapes on each loop stack (``walk_stacks``);
   K2's breakdown at path 1's shapes (each pass, each item region's
   offsets, the epilogue, the host's enqueue, ``torch.take`` per item
   pass); the string copy's two modes in turns on paths 5 and 4e;
7. ``{"paths": ...}`` and ``{"kernels": [...]}`` JSON lines, then
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
# shared-memory plans every fixture runs under: the launch's own, nothing
# staged, and the output slices staged up to 48 KiB
PLANS = {"default": {}, "unstaged": {"in_max": 0, "out_max": 0},
         "staged": {"out_max": 48 << 10}}
NESTED_ROWS = 262_144       # main path 3 (Python data generation bounds it)
LARGE_ROWS = 16_384         # main path 4: records of 4 to 16 KiB
PIPELINE_ROWS = 2_000       # rows of the pipeline engine's fixtures
WARM_CALLS = 5              # timed warm calls of each main path
PHASE_RUNS = 3              # decodes whose phase times give the medians
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
POLICY_EVERY = 100          # P1: one row in every 100 poisoned with b"\x01"
POLICY_HOST_ROWS = 10_000   # P4: records through the host oracle
POLICY_ENCODE_ROWS = 65_536  # P5: rows of the encode bisect

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

# more job descriptors in one gather pass than K2's blocks resolve at once
# (kJobChunk = 32 in csrc/decode_finalize.cu): 36 longs in the row pass,
# a record of 20 longs in an item pass
MANY_FIELDS_SCHEMA = json.dumps({"type": "record", "name": "Many", "fields": [
    *({"name": f"l{i}", "type": "long"} for i in range(36)),
    {"name": "rs", "type": {"type": "array", "items": {
        "type": "record", "name": "M", "fields": [
            {"name": f"m{i}", "type": "long"} for i in range(20)]}}}]})


# the pipeline engine's fixture shapes: every shape of the reference's
# device-decode tests (tests/test_device_decode.py SHAPES, kept equal by
# tests/test_torch_decode.py) and three levels of nesting
PIPELINE_SHAPES = {
    "flat": """{"type":"record","name":"F","fields":[
        {"name":"a","type":"long"},{"name":"b","type":"int"},
        {"name":"c","type":"double"},{"name":"d","type":"float"},
        {"name":"e","type":"boolean"},{"name":"s","type":"string"}]}""",
    "nullable": """{"type":"record","name":"N","fields":[
        {"name":"a","type":["null","long"]},{"name":"b","type":["string","null"]},
        {"name":"c","type":["null","double"]},{"name":"d","type":["null","boolean"]}]}""",
    "logical": """{"type":"record","name":"L","fields":[
        {"name":"d","type":{"type":"int","logicalType":"date"}},
        {"name":"tm","type":{"type":"long","logicalType":"timestamp-millis"}},
        {"name":"tu","type":{"type":"long","logicalType":"timestamp-micros"}},
        {"name":"e","type":{"type":"enum","name":"E","symbols":["RED","GREEN","BLUE"]}}]}""",
    "nested": """{"type":"record","name":"O","fields":[
        {"name":"x","type":"long"},
        {"name":"r","type":{"type":"record","name":"I","fields":[
            {"name":"p","type":"string"},{"name":"q","type":["null","int"]}]}},
        {"name":"nr","type":["null",{"type":"record","name":"I2","fields":[
            {"name":"u","type":"double"},{"name":"v","type":["null","string"]}]}]}]}""",
    "union": """{"type":"record","name":"U","fields":[
        {"name":"u","type":["null","string","int","boolean"]},
        {"name":"w","type":["long","string"]}]}""",
    "arr": """{"type":"record","name":"A","fields":[
        {"name":"xs","type":{"type":"array","items":"string"}},
        {"name":"ys","type":{"type":"array","items":"long"}},
        {"name":"na","type":["null",{"type":"array","items":"int"}]}]}""",
    "map": """{"type":"record","name":"M","fields":[
        {"name":"m","type":{"type":"map","values":"string"}},
        {"name":"md","type":{"type":"map","values":"double"}}]}""",
    "arr_rec": """{"type":"record","name":"AR","fields":[
        {"name":"rs","type":{"type":"array","items":{"type":"record","name":"P",
            "fields":[{"name":"k","type":"string"},
                      {"name":"v","type":["null","long"]}]}}}]}""",
    "arr_arr": """{"type":"record","name":"AA","fields":[
        {"name":"aa","type":{"type":"array","items":
            {"type":"array","items":"int"}}},
        {"name":"ms","type":{"type":"map","values":
            {"type":"array","items":"string"}}}]}""",
    "arr_rec_arr": """{"type":"record","name":"ARA","fields":[
        {"name":"rs","type":{"type":"array","items":{"type":"record",
            "name":"Q","fields":[
                {"name":"name","type":"string"},
                {"name":"vals","type":{"type":"array","items":"long"}},
                {"name":"nm","type":["null",{"type":"map",
                    "values":"double"}]}]}}}]}""",
    "NR3": """{"type":"record","name":"NR3","fields":[{"name":"aaa","type":{
        "type":"array","items":{"type":"array","items":{"type":"array",
        "items":"int"}}}}]}""",
}
# zero-byte items inside a nested loop, and a string after them: a lane's
# own span is far below the span of another lane at the same loop entry
GLOBAL_BOUND_SCHEMA = """{"type":"record","name":"GB","fields":[
  {"name":"aa","type":{"type":"array","items":{"type":"array",
                                               "items":"null"}}},
  {"name":"s","type":"string"}]}"""


# P5: one byte of decimal, so 200..999 do not fit
# (``tests/test_error_policy.py:205-223``); and a nullable copy for "null"
DECIMAL_SCHEMA = ('{"type":"record","name":"D","fields":[{"name":"d","type":'
                  '{"type":"fixed","name":"Fx","size":1,"logicalType":'
                  '"decimal","precision":3,"scale":0}}]}')
NULL_DECIMAL_SCHEMA = ('{"type":"record","name":"ND","fields":[{"name":"d",'
                       '"type":["null",{"type":"fixed","name":"Fx","size":1,'
                       '"logicalType":"decimal","precision":3,"scale":0}]}]}')

# encode fixtures: every extra logical type (uuid text, duration, fixed,
# enum, decimals over bytes and over a 16-byte fixed; the int128 minimum
# and maximum replace two rows, the minimum's bytes decimal takes 17 bytes)
LOGICAL_SCHEMA = """{"type":"record","name":"Lg","fields":[
  {"name":"u","type":{"type":"string","logicalType":"uuid"}},
  {"name":"du","type":{"type":"fixed","name":"Du","size":12,
                       "logicalType":"duration"}},
  {"name":"f","type":{"type":"fixed","name":"F5","size":5}},
  {"name":"e","type":{"type":"enum","name":"E3","symbols":["X","Y","Z"]}},
  {"name":"d","type":{"type":"bytes","logicalType":"decimal",
                      "precision":38,"scale":2}},
  {"name":"df","type":{"type":"fixed","name":"D16","size":16,
                       "logicalType":"decimal","precision":38,"scale":2}},
  {"name":"nd","type":["null",{"type":"bytes","logicalType":"decimal",
                               "precision":12,"scale":3}]},
  {"name":"nf","type":["null",{"type":"fixed","name":"F2","size":2}]}]}"""


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


def pipeline_fixtures(datagen, parse_schema, rows: int):
    """(name, schema, datums, must_fail) for the pipeline engine's kernels
    against their plain versions; ``rows`` sizes the generated batches
    (the CPU tests pass a small number, the card a larger one)."""
    rng = random.Random(21)
    shapes = PIPELINE_SHAPES
    kafka = datagen.KAFKA_SCHEMA_JSON

    def writer(schema):
        w = datagen.compile_writer(parse_schema(schema))

        def encode(value) -> bytes:
            out = bytearray()
            w(out, value)
            return bytes(out)
        return encode

    cases = [(name, shapes[name], datagen.random_datums(
        parse_schema(shapes[name]), rows, seed=11), False)
        for name in sorted(shapes)]
    cases.append(("kafka", kafka, datagen.kafka_style_datums(rows, seed=5),
                  False))
    cases.append(("many_fields", MANY_FIELDS_SCHEMA, datagen.random_datums(
        parse_schema(MANY_FIELDS_SCHEMA), rows, seed=13), False))
    # every region past the first rung's 8 items: items under a dropped
    # item wrap into the first record's slots until the ladder climbs
    ara = writer(shapes["arr_rec_arr"])
    cases.append(("nested_overflow", shapes["arr_rec_arr"], [ara({"rs": [{
        "name": "n" * rng.randrange(0, 6),
        "vals": [rng.randrange(-10**6, 10**6)
                 for _ in range(rng.randrange(0, 21))],
        "nm": None if rng.random() < 0.3 else (1, [
            (f"k{j}", rng.random()) for j in range(rng.randrange(0, 11))]),
    } for _ in range(rng.randrange(0, 13))]}) for _ in range(rows)], False))
    nr3 = writer(shapes["NR3"])
    cases.append(("NR3_overflow", shapes["NR3"], [nr3({"aaa": [[[
        rng.randrange(-99, 99) for _ in range(rng.randrange(0, 11))]
        for _ in range(rng.randrange(0, 11))]
        for _ in range(rng.randrange(0, 11))]}) for _ in range(rows)], False))
    # records of 8 KiB and 64 KiB: their string lengths overflow the
    # compact descriptors (sl32, then len16 once the batch passes 1 MiB)
    flat = writer(shapes["flat"])

    def flat_row(n):
        return flat({"a": rng.randrange(-2**40, 2**40), "b": rng.randrange(
            -2**20, 2**20), "c": rng.random(), "d": 0.5, "e": rng.random() < .5,
            "s": "q" * n})
    small = [flat_row(rng.randrange(0, 40)) for _ in range(rows)]
    cases.append(("record_8KiB", shapes["flat"],
                  small[:rows // 2] + [flat_row(8192)] + small[rows // 2:],
                  False))
    wide = [flat_row(rng.randrange(16_000, 24_000)) for _ in range(64)]
    cases.append(("len16", shapes["flat"], wide, False))
    cases.append(("record_64KiB_len16", shapes["flat"],
                  wide[:32] + [flat_row(65536)] + wide[32:], False))
    # more than 1024 zero-byte items in one record: no byte bounds them,
    # and the ladder climbs one doubling per rung
    nulls = [zz(3) + zz(0) + zz(2) + b"ab"] * rows
    nulls[rows // 3] = zz(1100) + zz(0) + zz(0)
    cases.append(("zero_byte_items", NULLS_SCHEMA, nulls, False))
    # a lane cut by the global bound inside a nested loop: its own span at
    # the inner loop's entry is 5 bytes, the other lane's over 100
    gb = writer(GLOBAL_BOUND_SCHEMA)
    cases.append(("nested_global_bound", GLOBAL_BOUND_SCHEMA, [
        gb({"aa": [[None] * 3], "s": "x" * 100}),
        gb({"aa": [[None] * 300], "s": ""}),
        gb({"aa": [[None], [None] * 2000], "s": "y" * 3}),
    ] + [gb({"aa": [[None] * rng.randrange(0, 4)], "s": "z"})
         for _ in range(rows)], False))
    # negative block counts: item count and byte size, then the items
    block = b"".join(zz(2) + b"ab" for _ in range(3))
    neg = zz(-3) + zz(len(block)) + block + zz(0) + zz(0) + zz(0)
    arr = datagen.random_datums(parse_schema(shapes["arr"]), rows, seed=4)
    cases.append(("negative_block_counts", shapes["arr"],
                  [neg] + arr + [neg], False))
    # malformed batches: the same message and indices on card and CPU
    trunc = datagen.random_datums(parse_schema(shapes["flat"]), rows, seed=3)
    trunc[rows // 2] = b"\x82"
    cases.append(("truncated_varint", shapes["flat"], trunc, True))
    trailing = datagen.random_datums(parse_schema(shapes["flat"]), rows,
                                     seed=9)
    trailing[1] = trailing[1] + b"\x00"
    cases.append(("trailing_bytes", shapes["flat"], trailing, True))
    flipped = datagen.kafka_style_datums(rows, seed=7)
    for i in rng.sample(range(rows), max(1, rows // 7)):
        d = bytearray(flipped[i])
        d[rng.randrange(len(d))] ^= 1 << rng.randrange(8)
        flipped[i] = bytes(d)
    cases.append(("bit_flipped", kafka, flipped, True))
    huge = datagen.kafka_style_datums(rows, seed=5)
    huge[3] = b"\x02" + zz(1 << 31) + huge[3][1:]
    huge[rows - 2] = b"\x02" + zz((1 << 31) - 1) + b"abc"
    cases.append(("string_len_2^31", kafka, huge, True))
    nested_bad = [ara({"rs": [{"name": "x", "vals": [1, 2], "nm": None}]})
                  for _ in range(rows)]
    nested_bad[rows // 4] = nested_bad[rows // 4][:-3]
    cases.append(("nested_truncated", shapes["arr_rec_arr"], nested_bad,
                  True))
    return cases


def block_edge_fixtures(datagen, parse_schema, rows: int):
    """(name, schema, datums, must_fail) of Kafka batches whose reads leave
    a ``decode_walk`` block's staged span (blocks of 128 lanes; ``rows``
    under a power of two, so lanes past ``n`` are inactive): a record at a
    block's last lane reading into the next block's records, a string
    length of 2^31-1 wrapping the cursor in a staged block, the launch's
    last record reading past the words into the clip, and a record too
    long for any block's staging budget beside staged blocks."""
    kafka = datagen.KAFKA_SCHEMA_JSON
    w = datagen.compile_writer(parse_schema(kafka))

    def named(n: int) -> bytes:
        out = bytearray()
        w(out, {"name": (1, "n" * n), "age": None, "emails": [],
                "address": None, "phone_numbers": [], "preferences": None,
                "status": None, "created_at": 0, "class": "A"})
        return bytes(out)

    cases = []
    edge = datagen.kafka_style_datums(rows, seed=17)
    for row in range(127, rows - 1, 128):  # each block's last lane
        # a name of 40 bytes that are not there: the next field's read
        # lies 42 bytes past the record's start, in the next block
        edge[row] = b"\x02" + zz(40)
    cases.append(("block_last_lane_overrun", kafka, edge, True))
    wrap = datagen.kafka_style_datums(rows, seed=19)
    wrap[5] = wrap[rows // 2] = b"\x02" + zz((1 << 31) - 1) + b"abc"
    cases.append(("string_len_2^31-1_staged", kafka, wrap, True))
    # the words end exactly at the last record (B = the total bytes, a
    # power of two): its unterminated varints read on past B, and the
    # reads clip to the last word. A filler record before it sets the
    # total; the filler's own block is over any staging budget.
    clip = datagen.kafka_style_datums(rows - 2, seed=23)
    head = sum(map(len, clip))
    B = 16
    while B < head + 320:  # room for a filler of 256 bytes or more
        B <<= 1
    fill = named(B - head - 30 - 8)
    last = B - head - len(fill)
    assert 20 <= last <= 40, last
    cases.append(("last_record_to_the_clip", kafka,
                  clip + [fill, b"\x82" * last], True))
    big = datagen.kafka_style_datums(rows, seed=29)
    big[200 % rows] = named(40_000)
    cases.append(("record_over_the_staging_budget", kafka, big, False))
    return cases


def int128_extremes(pa, batch, names):
    """``batch`` with rows 0 and 1 of each decimal column ``names`` set to
    the int128 minimum and maximum (raw Decimal128 buffers: the values lie
    past the declared precision, as the wire allows)."""
    import numpy as np

    cols = list(batch.columns)
    for name in names:
        i = batch.schema.get_field_index(name)
        col = cols[i]
        raw = np.frombuffer(col.buffers()[1], np.uint8,
                            count=16 * len(col)).copy().reshape(-1, 16)
        raw[0], raw[1] = 0, 0xFF
        raw[0, 15], raw[1, 15] = 0x80, 0x7F
        cols[i] = pa.Array.from_buffers(col.type, len(col), [
            col.buffers()[0], pa.py_buffer(raw.reshape(-1))])
    return pa.RecordBatch.from_arrays(cols, schema=batch.schema)


def encode_fixtures(pa, datagen, parse_schema, decode, rows: int):
    """(name, schema, batch) for K3 against its plain version: the CPU
    decodes of the well-formed pipeline fixtures, every extra logical
    type, extreme varints, empty and long collections, a sliced batch
    (its sparse union at a non-zero offset) and an empty batch.
    ``decode(datums, schema)`` gives one RecordBatch."""
    def written(writer, values):
        out = []
        for v in values:
            buf = bytearray()
            writer(buf, v)
            out.append(bytes(buf))
        return out

    cases = []
    for name, schema, datums, bad in pipeline_fixtures(datagen, parse_schema,
                                                       rows):
        # arrays of null items do not encode: the extractor rejects their
        # null values at a non-nullable position, as the reference's does
        if not bad and schema not in (NULLS_SCHEMA, GLOBAL_BOUND_SCHEMA):
            cases.append((name, schema, decode(datums, schema)))
    lir = parse_schema(LOGICAL_SCHEMA)
    wl, rng = datagen.compile_writer(lir), random.Random(19)
    values = []
    for _ in range(max(rows, 2)):
        v = datagen.random_value(lir, rng)
        # a duration whose months, days and ms fit Duration(ms) int64
        v["du"] = b"".join(rng.randrange(k).to_bytes(4, "little")
                           for k in (1200, 40_000, 86_400_000))
        values.append(v)
    logical = int128_extremes(pa, decode(written(wl, values),
                                         LOGICAL_SCHEMA), ("d", "df"))
    cases.append(("logical_types", LOGICAL_SCHEMA, logical))
    flat = PIPELINE_SHAPES["flat"]
    w = datagen.compile_writer(parse_schema(flat))
    cases.append(("extreme_varints", flat, decode(written(w, [
        {"a": a, "b": b, "c": c, "d": d, "e": e, "s": s}
        for a, b, c, d, e, s in [
            ((1 << 63) - 1, (1 << 31) - 1, 1e308, 3.4e38, True, ""),
            (-(1 << 63), -(1 << 31), -1e-308, -1.2e-38, False, "x" * 300),
            (0, 0, 0.0, -0.0, False, "h\u00e9llo w\u00f6rld \u4e2d\u6587"),
            (-1, -1, float("inf"), float("-inf"), True, "y"),
            (1, 1, float("nan"), 0.0, False, ""),
        ]]), flat)))
    arr = PIPELINE_SHAPES["arr"]
    wa = datagen.compile_writer(parse_schema(arr))
    cases.append(("empty_and_long_collections", arr, decode(written(wa, [
        {"xs": [], "ys": [], "na": None},
        {"xs": [f"item-{j}" for j in range(200)], "ys": list(range(100)),
         "na": (1, [])},
        {"xs": [""], "ys": [0], "na": (1, [1, -1])},
    ]), arr)))
    kafka = datagen.KAFKA_SCHEMA_JSON
    whole = decode(datagen.kafka_style_datums(max(rows, 60), seed=73), kafka)
    cases.append(("sliced", kafka, whole.slice(17, max(rows, 60) // 2)))
    cases.append(("empty", kafka, decode([], kafka)))
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


def pipeline_outcome(dec, datums, errors):
    """``("ok", (host, n, meta))`` or ``("error", (message, indices))``."""
    try:
        return "ok", dec.decode_to_columns(datums)
    except errors as e:
        return "error", (f"{type(e).__name__}: {e}",
                         getattr(e, "indices", None))


def check_walk_blocks(L, label) -> None:
    """Fail unless the blocks ``decode_walk`` counted in its last launch,
    staged and reading device memory, are those its host mirror
    ``walk_input_staging`` plans."""
    _a, _s, staged, covers = L.input_staging()
    want = (int(staged.sum()), int((covers & ~staged).sum()))
    if L.blocks != want:
        raise SystemExit(f"{label}: decode_walk counted {L.blocks} blocks "
                         f"(staged, device memory), its staging plan "
                         f"{want}")


def hold_kernels(torch, dm, dec, label):
    """Make every rung of ``dec``'s ladder run K1 and K2 beside their plain
    versions on the same inputs first, and fail unless every buffer,
    ``#err`` and the blob are bit-equal. Returns the list it appends each
    checked rung to, as (largest item cap, compact), and K1's blocks over
    those rungs ``[staged, reading device memory]`` as the kernel counted
    them; fail unless they are the ones ``walk_input_staging`` plans."""
    blocks = [0, 0]
    prog, real, rungs = dec.prog, dec.pipeline, []

    def checked(packed, R, B, n_act, item_caps, tot_caps, compact, *args,
                **kwargs):
        words, starts, lengths = dec.launch_views(packed, R, B)
        L = dm.WalkLaunch(words, starts, lengths, n_act, prog, item_caps)
        kb, ke = dm.walk_kernel.run(L)
        check_walk_blocks(L, f"{label} (R={R}, caps {item_caps})")
        blocks[0] += L.blocks[0]
        blocks[1] += L.blocks[1]
        pb, pe = dm.walk_plain(words, starts, lengths, n_act, prog,
                               item_caps)
        plan = dm.FinalizePlan(kb, ke, prog, R, B, item_caps, tot_caps,
                               compact)
        plan.blob.fill_(0xA5)  # every byte must be written by K2
        kblob = dm.finalize_kernel.run(plan)
        pblob = dm.finalize_plain(pb, pe, prog, R, B, item_caps, tot_caps,
                                  compact)
        torch.cuda.synchronize()
        for key, k, p in zip(prog.out_keys + ["#err", "blob"],
                             list(kb) + [ke, kblob], list(pb) + [pe, pblob]):
            diff = max_abs_diff(torch, k, p)
            if diff:
                raise SystemExit(f"{label}: kernel != plain in {key!r} at "
                                 f"caps {item_caps}, totals {tot_caps}, "
                                 f"compact={compact} (max abs diff {diff})")
        rungs.append((max(item_caps[1:], default=0), compact))
        del L, kb, ke, pb, pe, plan, kblob, pblob
        return real(packed, R, B, n_act, item_caps, tot_caps, compact,
                    *args, **kwargs)

    dec.pipeline = checked
    return rungs, blocks


def check_pipeline_fixture(torch, np, dm, name, schema, datums, must_fail,
                           parse_schema, errors):
    """K1 and K2 against their plain versions on the card at every rung the
    card decoder's ladder visits (every buffer, ``#err`` and the blob
    bit-equal), then the decode on the card against the decode on the
    CPU (every host column, or the same error message and indices)."""
    ir = parse_schema(schema)
    card = dm.DeviceDecoder(ir, DEVICE)
    cpu = dm.DeviceDecoder(ir, "cpu")
    n, worst = len(datums), 0
    walk0, fin0 = dm.walk_kernel.launches, dm.finalize_kernel.launches
    rungs, blocks = hold_kernels(torch, dm, card, name)
    got = pipeline_outcome(card, datums, errors)
    want = pipeline_outcome(cpu, datums, errors)
    if got[0] != want[0]:
        raise SystemExit(f"{name}: card {got[0]} but CPU {want[0]}")
    if got[0] == "error":
        if got[1] != want[1] or not must_fail:
            raise SystemExit(f"{name}: card raised {got[1]!r}, CPU "
                             f"{want[1]!r}")
        msg, indices = got[1]
        detail = f"{msg} ({len(indices or [])} bad rows)"
    else:
        if must_fail:
            raise SystemExit(f"{name}: malformed fixture decoded cleanly")
        (hg, ng, mg), (hc, nc, mc) = got[1], want[1]
        if ng != nc or set(hg) != set(hc) or \
                mg["item_totals"] != mc["item_totals"]:
            raise SystemExit(f"{name}: decoded columns differ in shape")
        for key in hc:
            if hg[key].dtype != hc[key].dtype or not np.array_equal(
                    hg[key].view(np.uint8), hc[key].view(np.uint8)):
                raise SystemExit(f"{name}: decoded column {key!r} differs")
        detail = f"item_totals={mg['item_totals']}"
    print(f"pipeline fixture {name}: rows={n} rungs (max cap, compact)="
          f"{rungs} decode_walk launches={dm.walk_kernel.launches - walk0} "
          f"(blocks staged/device memory {blocks[0]}/{blocks[1]}) "
          f"decode_finalize launches={dm.finalize_kernel.launches - fin0} "
          f"exact=True max_abs_err={worst} -> {detail}")
    return worst, blocks


def large_kafka_datums(datagen, parse_schema, n: int, seed: int):
    """Kafka-schema records of 4 to 16 KiB: long names, streets and
    e-mail addresses; the name pads each record to its drawn size (to
    within the one byte its length's varint may grow)."""
    rng = random.Random(seed)
    w = datagen.compile_writer(parse_schema(datagen.KAFKA_SCHEMA_JSON))
    out = []
    for _ in range(n):
        size = rng.randrange(4096, 16383)
        rec = {
            "name": (1, "n" * (size // 2)),
            "age": (1, rng.randint(18, 80)) if rng.random() < .5 else None,
            "emails": [f"{'e' * (size // 8)}{i}@example.com"
                       for i in range(2)],
            "address": (1, {"street": "s" * (size // 8), "city": "c",
                            "zipcode": f"{rng.randint(10000, 99999)}"}),
            "phone_numbers": [("home", "+1-555-0100")],
            "preferences": None,
            "status": (1, "active"),
            "created_at": rng.randint(1_600_000_000, 1_800_000_000),
            "class": rng.choice(["A", "B", "C"]),
        }
        buf = bytearray()
        w(buf, rec)
        rec["name"] = (1, "n" * (size // 2 + size - len(buf)))
        buf = bytearray()
        w(buf, rec)
        out.append(bytes(buf))
    return out


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


def drive(label, data, schema, counters, deserialize, card):
    """One main path: every count set to 0, the cold call, the counts read,
    then the warm calls. Fails if a kernel of the path did not launch."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    batches = deserialize(data, schema, MAIN_CHUNKS)
    cold = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for k, v in launches.items():
        if v < 1:
            raise SystemExit(f"{label}: the main path ran without launching "
                             f"{k}")
    warm = []
    for c in counters.values():
        c.launches = 0
    for _ in range(WARM_CALLS):
        del batches
        t0 = time.perf_counter()
        batches = deserialize(data, schema, MAIN_CHUNKS)
        warm.append(time.perf_counter() - t0)
    warm_launches = {k: c.launches / WARM_CALLS for k, c in counters.items()}
    rows = sum(b.num_rows for b in batches)
    if rows != len(data) or len(batches) != MAIN_CHUNKS:
        raise SystemExit(f"{label}: {len(batches)} batches of {rows} rows")
    med = statistics.median(warm)
    print(f"main path {label}: deserialize_array_threaded({len(data)} "
          f"records, {MAIN_CHUNKS}) launches: cold call {launches}, per "
          f"warm call {warm_launches}; cold "
          f"{cold:.3f} s, warm median of {WARM_CALLS} {med:.3f} s "
          f"({min(warm):.3f} .. {max(warm):.3f}) = {len(data) / med:,.0f} "
          f"rec/s {card}")
    return batches, {"launches": launches, "warm_launches": warm_launches,
                     "cold_s": cold, "warm_s": warm}


def same_values(label, got, want):
    """Every batch equal to the CPU call's, value by value."""
    for i, (g, w) in enumerate(zip(got, want)):
        if not g.equals(w) or g.to_pylist() != w.to_pylist():
            raise SystemExit(f"{label}: batch {i} differs from the CPU call")


def phases(dec, data, build_record_batch, codec, card, label):
    """Median per phase of ``PHASE_RUNS`` decodes (host clock, each phase
    ending in a synchronise or a copy)."""
    order = ("pack_s", "h2d_s", "walk_s", "finalize_s", "d2h_s", "compact_s",
             "assembly_s")
    got, rungs = {}, set()
    for _ in range(PHASE_RUNS):
        host, n, meta = dec.decode_to_columns(data)
        t0 = time.perf_counter()
        build_record_batch(codec.ir, codec.arrow_schema, host, n, meta)
        meta["timings"]["assembly_s"] = time.perf_counter() - t0
        for k in order:
            if k in meta["timings"]:
                got.setdefault(k, []).append(meta["timings"][k])
        rungs.add(meta["timings"].get("rungs", 1))
        del host, meta
    print(f"phases {label}, ms, median (min .. max) of {PHASE_RUNS}: "
          + ", ".join(f"{k[:-2]} {spread(v)}" for k, v in got.items())
          + f"; rungs per decode {sorted(rungs)} {card}")
    return {k: statistics.median(v) for k, v in got.items()}


def overlap_phases(dm, pack, codec, data, build_record_batch, concat, card,
                   label):
    """The overlapped path's phases: the record pack, native and the
    Python join, on the same records (best of ``PHASE_RUNS``); then
    medians of ``PHASE_RUNS`` decodes through
    ``decode_to_columns_overlapped``: host seconds of pack, h2d (enqueue
    of each chunk's copy), walk (launch and status read), finalize
    (enqueue), d2h (waits for the blobs), the device ms of all pinned
    h2d copies and of all blob copies (CUDA events), ``overlap_s`` and
    ``overlap_frac``, the assembly of the chunks' batches and their
    concatenation."""
    dec = codec.decoder
    k = dm.overlap_chunks(len(data))
    native_s, join_s = [], []
    for _ in range(PHASE_RUNS):
        t0 = time.perf_counter()
        pack.concat_records(data, native=True)
        native_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        pack.concat_records(data)
        join_s.append(time.perf_counter() - t0)
    got = {}
    for _ in range(PHASE_RUNS):
        triples = dec.decode_to_columns_overlapped(data, k)
        t = triples[0][2]["timings"]
        batches, assembly = [], []
        for host, n, meta in triples:
            t0 = time.perf_counter()
            batches.append(build_record_batch(codec.ir, codec.arrow_schema,
                                              host, n, meta))
            assembly.append(time.perf_counter() - t0)
        t1 = time.perf_counter()
        concat(batches)
        t2 = time.perf_counter()
        row = {key: t[key] for key in ("pack_s", "h2d_s", "walk_s",
                                        "finalize_s", "d2h_s", "overlap_s",
                                        "overlap_frac", "rungs", "reruns")}
        row.update(h2d_ms=sum(t["h2d_ms"]), d2h_ms=sum(t["d2h_ms"]),
                   assembly_s=sum(assembly), concat_s=t2 - t1)
        for key, v in row.items():
            got.setdefault(key, []).append(v)
        per_chunk = {"h2d_ms": t["h2d_ms"], "d2h_ms": t["d2h_ms"],
                     "assembly_ms": [x * 1e3 for x in assembly]}
        del triples, batches
    out = {key: statistics.median(v) for key, v in got.items()}
    out.update(chunks=k, native_pack_s=min(native_s), join_pack_s=min(join_s),
               per_chunk_ms=per_chunk)
    print(f"overlapped phases {label} ({k} chunks), ms, median of "
          f"{PHASE_RUNS}: pack {out['pack_s'] * 1e3:.1f}, h2d enqueue "
          f"{out['h2d_s'] * 1e3:.1f} (device {out['h2d_ms']:.2f}), walk "
          f"{out['walk_s'] * 1e3:.1f}, finalize {out['finalize_s'] * 1e3:.1f}"
          f", d2h wait {out['d2h_s'] * 1e3:.1f} (device "
          f"{out['d2h_ms']:.2f}), overlap_s {out['overlap_s'] * 1e3:.2f} "
          f"overlap_frac {out['overlap_frac']:.4f}, assembly "
          f"{out['assembly_s'] * 1e3:.1f}, concat "
          f"{out['concat_s'] * 1e3:.1f}; rungs {out['rungs']}, reruns "
          f"{out['reruns']}; per chunk h2d ms "
          f"{[round(x, 3) for x in per_chunk['h2d_ms']]}, d2h ms "
          f"{[round(x, 3) for x in per_chunk['d2h_ms']]}, assembly ms "
          f"{[round(x, 1) for x in per_chunk['assembly_ms']]}; record pack of "
          f"{len(data)} records: native {min(native_s) * 1e3:.1f}, Python "
          f"join {min(join_s) * 1e3:.1f} (best of {PHASE_RUNS}) {card}")
    return out


def planner_cold(dm, capacity, dec, data, card, label):
    """The cold ``decode_to_columns_overlapped`` of a fresh decoder of the
    path's schema with the capacity planner empty, then of a second fresh
    decoder, which starts from the first one's learned rung."""
    capacity.reset()
    k = dm.overlap_chunks(len(data))
    out = {}
    for key in ("planner_miss", "planner_hit"):
        fresh = dm.DeviceDecoder(dec.prog.ir, DEVICE,
                                 fingerprint=dec.fingerprint)
        t0 = time.perf_counter()
        triples = fresh.decode_to_columns_overlapped(data, k)
        t = triples[0][2]["timings"]
        out[key] = {"cold_s": time.perf_counter() - t0, "rungs": t["rungs"],
                    "reruns": t["reruns"]}
        del triples, fresh
    print(f"cold call {label} (fresh decoder, {k} chunks, no assembly): "
          + ", ".join(f"{key} {v['cold_s']:.3f} s, {v['rungs']} rungs, "
                      f"{v['reruns']} reruns" for key, v in out.items())
          + f" {card}")
    return out


def warm_turns(label, data, schema, deserialize, card):
    """Warm calls of a path overlapped (default) and on one launch
    (``PYRUHVRO_TPU_OVERLAP=0``) in turns, A B B A twice."""
    import os

    times = {"overlapped": [], "single": []}
    for leg in ["overlapped", "single", "single", "overlapped"] * 2:
        if leg == "single":
            os.environ["PYRUHVRO_TPU_OVERLAP"] = "0"
        t0 = time.perf_counter()
        batches = deserialize(data, schema, MAIN_CHUNKS)
        times[leg].append(time.perf_counter() - t0)
        os.environ.pop("PYRUHVRO_TPU_OVERLAP", None)
        del batches
    print(f"main path {label} warm calls in turns (A B B A twice), s: "
          + "; ".join(f"{k} median {statistics.median(v):.3f} "
                      f"{[round(x, 3) for x in v]}" for k, v in times.items())
          + f" {card}")
    return times


def k4_kernel(torch, wd, dec, data, lib, card):
    """``walk_decode`` (K4) at the main path's shapes: its shared-memory
    plans, its time beside its variants', bit-equal to the plain walk."""
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
    print(f"walk_decode at the main path's shapes (R={R}, BW={BW}, "
          f"caps={caps}, tile_r={tile_r}): launch {kernel_ms:.3f} ms (best "
          f"of 5 twice, in turns, CUDA events; no zero-fill: the kernel "
          f"writes every output), bit-equal to the plain walk "
          f"({plain_ms:.1f} ms); bound {bound_ms:.3f} ms ({read / 1e6:.1f} MB "
          f"read + {launch.output_bytes() / 1e6:.1f} MB written at 3.35 "
          f"TB/s), {kernel_ms / bound_ms:.2f}x the bound; variants "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in variant_ms.items())
          + f" {card}")
    return {"ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "variant_ms": variant_ms,
            "smem_bytes": smem, "blocks_per_sm": occupancy(smem)}


def walk_ptxas(log: str):
    """``{stack: {registers, stack, spill_stores, spill_loads}}`` of each
    loop-stack instantiation of ``decode_walk_kernel`` in nvcc's
    ``-Xptxas -v`` output (empty for a build reused from the cache)."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"(Compiling entry function|Function properties for)"
                      r" '?([\w$]+)", line)
        if m:
            k = re.search(r"decode_walk_kernelILi(\d+)E", m.group(2))
            key = int(k.group(1)) if k else None
            if m.group(1).startswith("Compiling"):
                entry = key
            else:
                props = key
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None:
            out.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            props = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
            entry = None
    return out


def k1_kernel(torch, dm, dec, data, lib, card):
    """``decode_walk`` (K1) at main path 1's shapes under its input
    budgets, loop-stack instantiations and key folding, timed in turns
    (CUDA events, status reset included), each bit-equal to the plain
    walk; for each, the blocks the kernel counted staged and reading
    device memory, shared memory per block and blocks per SM; the host's
    enqueue of one launch and the host time of ``run`` (launch, status
    read, settle); ptxas registers, stack frame and spills of every
    instantiation."""
    wk = dm.walk_kernel
    flat, lanes, n, R, B = dec.pack(data)
    packed = dec.launch_buffer(flat, lanes, B, DEVICE)
    caps, _tot = dec.caps_snapshot(R)
    prog = dec.prog
    words, starts, lengths = dec.launch_views(packed, R, B)

    def make(n_act=n, **plan):
        return dm.WalkLaunch(words, starts, lengths, n_act, prog, caps,
                             **plan)

    # the same launch with the record spans read from device memory, on
    # the deepest loop stack, and with no key folded per block
    default = make()
    variants = {
        "default": default,
        "input from global": make(in_max=0),
        "stack 8": make(_stack=8),
        "keys unfolded": make(_fold=0),
    }
    for key, L in variants.items():
        launches = wk.launches
        wk.run(L)
        if wk.launches - launches != 1:
            raise SystemExit(f"decode_walk ({key}) took "
                             f"{wk.launches - launches} launches to settle")
    # no active lane: the blocks' tables and zero-fills alone
    timed = {**variants, "walk skipped": make(n_act=0)}
    variant_ms = {}
    for key in list(timed) + list(timed)[::-1]:  # in turns
        L = timed[key]
        ms = cuda_ms(torch, lambda: wk.launch(L), 5)
        variant_ms[key] = min(ms, variant_ms.get(key, ms))
    del timed
    pb, pe = dm.walk_plain(words, starts, lengths, n, prog, caps)
    for vkey, L in variants.items():
        if not L.settle():
            raise SystemExit(f"decode_walk ({vkey}): the timed launch did "
                             f"not settle: {L.unsettled}")
        check_walk_blocks(L, f"main path shapes ({vkey})")
        for key, k, p in zip(prog.out_keys + ["#err"], L.bufs + [L.err],
                             list(pb) + [pe]):
            diff = max_abs_diff(torch, k, p)
            if diff:
                raise SystemExit(f"main path shapes ({vkey}): decode_walk != "
                                 f"plain walk in {key!r} (max abs diff "
                                 f"{diff})")
    del pb, pe
    enqueue, host_run = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wk.launch(default)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wk.run(default)
        host_run.append((time.perf_counter() - t2) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
    ptx = walk_ptxas(lib.log)
    for key, L in variants.items():
        smem = wk.smem_bytes(prog, L.in_budget)
        print(f"decode_walk plan ({key}) at path 1's one-launch shapes: input "
              f"budget {L.in_budget} B, blocks the kernel counted staged "
              f"{L.blocks[0]} / reading device memory {L.blocks[1]}, loop "
              f"stack {L.stack}, keys folded per block {L.fold}, shared "
              f"memory {smem} B per block, "
              f"{wk.blocks_per_sm(L.stack, smem)} blocks per SM: "
              f"{variant_ms[key]:.3f} ms")
    print("decode_walk ptxas per loop-stack instantiation: " + (", ".join(
        f"stack {k}: {v.get('registers')} registers, {v.get('stack')} B "
        f"stack frame, {v.get('spill_stores')} B spill stores, "
        f"{v.get('spill_loads')} B spill loads"
        for k, v in sorted(ptx.items())) or "not reported (cached build)"))
    out = {"variant_ms": variant_ms,
           "enqueue_ms": statistics.median(enqueue[1:]),
           "run_host_ms": statistics.median(host_run[1:]),
           "blocks_staged": default.blocks[0],
           "blocks_global": default.blocks[1],
           "ptxas": {str(k): v for k, v in sorted(ptx.items())}}
    print(f"decode_walk variants at path 1's one-launch shapes (R={R}, B={B}, "
          f"caps={caps}), ms, best of 5 twice, in turns, CUDA events: "
          + ", ".join(f"{k} {v:.3f}" for k, v in variant_ms.items())
          + f"; host enqueue of launch(L) {out['enqueue_ms']:.4f} ms, host "
          f"time of run(L) (launch, status read, settle) "
          f"{out['run_host_ms']:.4f} ms (medians of 5) {card}")
    return out


def walk_stacks(torch, dm, dec, data, label, card):
    """``decode_walk`` at a path's first-rung shapes on every loop-stack
    instantiation that holds its schema's depth, timed in turns (CUDA
    events, best of 5 twice), each settled and bit-equal to the plain
    walk: ``{stack: ms}``."""
    wk = dm.walk_kernel
    flat, lanes, n, R, B = dec.pack(data)
    packed = dec.launch_buffer(flat, lanes, B, DEVICE)
    caps, _tot = dec.caps_snapshot(R)
    prog = dec.prog
    words, starts, lengths = dec.launch_views(packed, R, B)
    stacks = [k for k in dm.WALK_STACKS if k >= max(prog.depth, 1)]
    launches = {k: dm.WalkLaunch(words, starts, lengths, n, prog, caps,
                                 _stack=k) for k in stacks}
    for L in launches.values():
        wk.run(L)
    got = {}
    for k in stacks + stacks[::-1]:  # in turns
        ms = cuda_ms(torch, lambda: wk.launch(launches[k]), 5)
        got[k] = min(ms, got.get(k, ms))
    pb, pe = dm.walk_plain(words, starts, lengths, n, prog, caps)
    for k, L in launches.items():
        if not L.settle():
            raise SystemExit(f"{label}: decode_walk (stack {k}) did not "
                             f"settle: {L.unsettled}")
        for key, kb, p in zip(prog.out_keys + ["#err"], L.bufs + [L.err],
                              list(pb) + [pe]):
            if max_abs_diff(torch, kb, p):
                raise SystemExit(f"{label}: decode_walk (stack {k}) != plain "
                                 f"walk in {key!r}")
    print(f"decode_walk loop stacks at {label}'s shapes (R={R}, B={B}, "
          f"caps={caps}, depth {prog.depth}), ms, best of 5 twice, in turns, "
          f"CUDA events, each bit-equal to the plain walk: "
          + ", ".join(f"stack {k} {v:.3f}" for k, v in got.items())
          + f" {card}")
    return got


def finalize_pass_bytes(dm, plan, p, written: bool = True) -> int:
    """What one gather pass must move: each source element it copies or
    reduces read once, over the row region's ``R`` lanes or the item
    region's actual item total (the positions past it read nothing), and,
    if ``written``, the blob bytes it writes once (an item pass's
    ``#offsets`` included). Its intermediates (the int64 offsets, the slot
    maps, the children's gathered counts) are not the function's."""
    read = {dm.J_COPY32: 4, dm.J_BITS8: 1, dm.J_SL32: 8,
            dm.J_START_LENC: 8, dm.J_REDUCE: 4, dm.J_ERRFLAG: 4}
    bits_out = {dm.J_COPY32: 32, dm.J_BITS8: 1, dm.J_SL32: 32,
                dm.J_START_LENC: 48, dm.J_REDUCE: 0, dm.J_ERRFLAG: 0}
    n_pos = p["n_pos"]
    n_read = n_pos if p["rid"] == 0 else \
        min(n_pos, int(plan.offsets[p["rid"]][-1]))
    moved = sum(n_read * read[j[0]] for j in p["jobs"])
    if written:
        moved += sum(n_pos * bits_out[j[0]] // 8 for j in p["jobs"])
        moved += 4 * (p["n_entries"] + 1) if p["rid"] else 0
    return moved


def finalize_moved_bytes(dm, plan) -> int:
    """What the finalize run just made must move: the blob written once,
    and what each pass reads (:func:`finalize_pass_bytes`)."""
    return plan.blob.numel() + sum(
        finalize_pass_bytes(dm, plan, p, written=False) for p in plan.passes)


def finalize_breakdown(torch, dm, plan, takes, card):
    """K2's parts at one plan's shapes, each by CUDA events (best of 5):
    the reduction slots' zero-fill, the row pass, each item pass's offsets
    (fill + ``torch.cumsum``) and its gather pass, the epilogue; the host's
    enqueue of ``finalize_kernel.run(plan)`` (``perf_counter``, no
    synchronise inside); ``torch.take`` over each item pass's own gathers
    (``takes``: region id -> [(source, index), ...])."""
    fk = dm.finalize_kernel
    out = {"zero_red": cuda_ms(torch, plan.red.zero_, 5)}
    passes, jobs = {}, {}
    for p in plan.passes:
        rid = p["rid"]
        name = "rows" if rid == 0 else plan.prog.regions[rid]
        got = {"ms": cuda_ms(torch, lambda: fk.launch_pass(plan, p), 5),
               "bound_ms": finalize_pass_bytes(dm, plan, p)
               / HBM_BYTES_PER_S * 1e3}
        if rid:
            got["offsets_ms"] = cuda_ms(
                torch, lambda: fk.prepare_offsets(plan, p), 5)
            got["take_ms"] = cuda_ms(torch, lambda: [
                torch.take(src, idx) for src, idx in takes[rid]], 5)
        passes[name] = got
        jobs[name] = len(p["jobs"])
    out["passes"] = passes
    out["epilogue"] = cuda_ms(torch, lambda: fk.launch_epilogue(plan), 5)
    enqueue = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fk.run(plan)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    out["enqueue_ms"] = statistics.median(enqueue[1:])
    out["parts_ms"] = out["zero_red"] + out["epilogue"] + sum(
        v["ms"] + v.get("offsets_ms", 0.0) for v in passes.values())
    print("decode_finalize breakdown at path 1's chunk shapes, ms (CUDA "
          "events, best of 5): zero red " + f"{out['zero_red']:.4f}; "
          + "; ".join(
              f"pass {k} {v['ms']:.4f} ({jobs[k]} jobs, bound "
              f"{v['bound_ms']:.4f}"
              + (f"; offsets fill + cumsum {v['offsets_ms']:.4f}, "
                 f"torch.take over its gathers {v['take_ms']:.4f}"
                 if "take_ms" in v else "") + ")"
              for k, v in passes.items())
          + f"; epilogue {out['epilogue']:.4f}; parts summed "
          f"{out['parts_ms']:.4f}; host enqueue of run(plan) "
          f"{out['enqueue_ms']:.4f} (median of 5, host clock) {card}")
    return out


def pipeline_kernels(torch, dm, dec, data, card, label, breakdown=False):
    """``decode_walk`` (K1) and ``decode_finalize`` (K2) at the shapes of
    one launch over ``data`` (a whole batch, or the largest chunk of an
    overlapped path): CUDA-event times, bit-equal to their plain versions,
    their bounds, ``torch.take`` over the finalize's slot maps, and with
    ``breakdown`` K2's parts."""
    flat, lanes, n, R, B = dec.pack(data)
    packed = dec.launch_buffer(flat, lanes, B, DEVICE)
    item_caps, tot_caps = dec.caps_snapshot(R)
    compact = (R, B) not in dec._str_full
    prog = dec.prog
    words, starts, lengths = dec.launch_views(packed, R, B)
    L = dm.WalkLaunch(words, starts, lengths, n, prog, item_caps)
    walk0 = dm.walk_kernel.launches
    dm.walk_kernel.run(L)
    walk_launches = dm.walk_kernel.launches - walk0
    check_walk_blocks(L, label)
    walk_ms = cuda_ms(torch, lambda: dm.walk_kernel.launch(L), 5)
    plain = []
    plain_walk_ms = cuda_ms(torch, lambda: plain.__setitem__(
        slice(None), [dm.walk_plain(words, starts, lengths, n, prog,
                                    item_caps)]), 2)
    pb, pe = plain[0]
    for key, k, p in zip(prog.out_keys + ["#err"], L.bufs + [L.err],
                         list(pb) + [pe]):
        if max_abs_diff(torch, k, p):
            raise SystemExit(f"{label}: decode_walk != plain walk in "
                             f"{key!r}")
    plan = dm.FinalizePlan(L.bufs, L.err, prog, R, B, item_caps, tot_caps,
                           compact)
    fin_ms = cuda_ms(torch, lambda: dm.finalize_kernel.run(plan), 5)
    fin_launches = len(plan.passes) + 1
    kblob = plan.blob.clone()
    pblob = []
    plain_fin_ms = cuda_ms(torch, lambda: pblob.__setitem__(
        slice(None), [dm.finalize_plain(L.bufs, L.err, prog, R, B, item_caps,
                                        tot_caps, compact)]), 2)
    if max_abs_diff(torch, kblob, pblob[0]):
        raise SystemExit(f"{label}: decode_finalize != plain finalize")
    # torch.take over the same slot maps: the one PyTorch call that
    # gathers what the passes gather
    key_of = {k: i for i, k in enumerate(prog.out_keys)}
    gathers, slot_maps, takes = [], {}, {}
    for rid in range(1, len(prog.regions)):
        parent = prog.region_parents[rid]
        counts = L.bufs[key_of[prog.regions[rid] + "#count"]].to(torch.int64)
        if parent == 0:
            pslot = torch.arange(R, device=counts.device)
        else:
            pslot, pin = slot_maps[parent]
            counts = torch.where(pin, dm._take_clip(counts, pslot), 0)
        offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        j = torch.arange(tot_caps[rid], device=counts.device)
        ent = dm._row_of(offsets, counts.numel(), tot_caps[rid])
        slot = (pslot[ent] * item_caps[rid] + j - offsets[ent])
        slot_maps[rid] = (slot, j < offsets[-1])
        for k, s in prog.buffers.items():
            if s.region == rid:
                src = L.bufs[key_of[k]]
                gathers.append((src, slot.clamp(0, src.numel() - 1)))
                takes.setdefault(rid, []).append(gathers[-1])
    take_ms = cuda_ms(torch, lambda: [torch.take(src, idx)
                                      for src, idx in gathers], 5)
    walk_read = int(lengths.to(torch.int64).sum()) + 8 * R
    walk_written = sum(b.numel() * b.element_size() for b in L.bufs) + 4 * R
    walk_bound = (walk_read + walk_written) / HBM_BYTES_PER_S * 1e3
    fin_moved = finalize_moved_bytes(dm, plan)
    fin_bound = fin_moved / HBM_BYTES_PER_S * 1e3
    parts = finalize_breakdown(torch, dm, plan, takes, card) \
        if breakdown else None
    print(f"decode_walk at {label} (R={R}, B={B}, caps="
          f"{item_caps}, {walk_launches} launch(es) to settle): launch "
          f"{walk_ms:.3f} ms (best of 5, CUDA events, status reset "
          f"included), bit-equal to the plain walk ({plain_walk_ms:.1f} "
          f"ms); bound {walk_bound:.3f} ms ({walk_read / 1e6:.1f} MB read + "
          f"{walk_written / 1e6:.1f} MB written at 3.35 TB/s), "
          f"{walk_ms / walk_bound:.2f}x the bound {card}")
    print(f"decode_finalize at {label} (totals {tot_caps}, "
          f"compact={compact}, {len(plan.passes)} passes + epilogue = "
          f"{fin_launches} launches, cumsums included): {fin_ms:.3f} ms "
          f"(best of 5), bit-equal to the plain finalize ({plain_fin_ms:.1f} "
          f"ms); bound {fin_bound:.3f} ms ({fin_moved / 1e6:.1f} MB moved), "
          f"{fin_ms / fin_bound:.2f}x the bound; torch.take over the same "
          f"slot maps ({len(gathers)} buffers) {take_ms:.3f} ms; blob "
          f"{plan.nbytes / 1e6:.1f} MB {card}")
    shape = {"R": R, "B": B, "rows": n}
    return ({"ms": walk_ms, "plain_ms": plain_walk_ms, "bound_ms": walk_bound,
             "library_ms": None, "shape": shape},
            {"ms": fin_ms, "plain_ms": plain_fin_ms, "bound_ms": fin_bound,
             "library_ms": take_ms, "shape": shape,
             **({"parts": parts} if breakdown else {})})


def wire_of(arrays):
    """The datums of a list of BinaryArrays, concatenated."""
    out = []
    for a in arrays:
        out.extend(a.to_pylist())
    return out


def check_encode_fixture(torch, em, name, schema, batch, parse_schema,
                         decode):
    """K3 (``encode_rows``, ``encode_strings``) against the plain version
    on the same launch buffer on the card: the row sizes, every ``#dst``
    lane and ``[0, total)`` bit-equal; then the card's encode equal to
    the CPU's, and the wire a fixed point of decode and encode."""
    ir = parse_schema(schema)
    from pyruhvro_tpu_torch.schema.arrow_map import to_arrow_schema

    card = em.DeviceEncoder(ir, to_arrow_schema(ir), DEVICE)
    cpu = em.DeviceEncoder(ir, to_arrow_schema(ir), "cpu")
    rows0 = em.encode_kernel.rows.launches
    strings0 = em.encode_kernel.strings.launches
    worst, spans, windows = 0, (0, 0), 0
    if batch.num_rows:
        L = card.launch(batch)
        dv = L.dv()
        p_out, p_sizes, p_dst = em.rows_plain(dv, card.prog, L.cap)
        em.strings_plain(p_out, dv, card.prog, p_dst)
        k_out, k_sizes = em.encode_kernel.run(L)
        torch.cuda.synchronize()
        spans = em.span_plan(k_sizes, L.n, L.span_budget)
        windows = L.n_windows
        worst = max_abs_diff(torch, k_sizes, p_sizes)
        for path, dst in L.dst().items():
            worst = max(worst, max_abs_diff(torch, dst, p_dst[path]))
        total = int(p_sizes.to(torch.int64).sum())
        worst = max(worst, max_abs_diff(torch, k_out[:total], p_out[:total]))
        if worst:
            raise SystemExit(f"encode fixture {name}: kernel != plain "
                             f"(max abs diff {worst})")
        del L, dv, p_out, k_out
    got, want = card.encode(batch), cpu.encode(batch)
    if not got.equals(want):
        raise SystemExit(f"encode fixture {name}: card encode != CPU encode")
    wire = got.to_pylist()
    back = batch.slice(2) if name == "logical_types" else batch
    once = card.encode(back)
    again = card.encode(decode(once.to_pylist(), schema))
    if not again.equals(once):
        raise SystemExit(f"encode fixture {name}: the wire is not a fixed "
                         f"point of decode and encode")
    print(f"encode fixture {name}: rows={batch.num_rows} encode_rows "
          f"launches={em.encode_kernel.rows.launches - rows0} (write blocks: "
          f"{spans[0]} staged, {spans[1]} direct) encode_strings "
          f"launches={em.encode_kernel.strings.launches - strings0} "
          f"({windows} windows) exact=True max_abs_err={worst} "
          f"bytes={sum(map(len, wire))}, card == CPU, fixed point")
    return worst, spans


def drive_encode(label, batch, datums, schema, counters, serialize, card):
    """One encode main path: every count set to 0, the cold call, the
    counts read, then the warm calls; the chunks' datums must equal
    ``datums`` (the canonical input wire)."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    arrays = serialize(batch, schema, MAIN_CHUNKS)
    cold = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for k, v in launches.items():
        if v < 1:
            raise SystemExit(f"{label}: the main path ran without launching "
                             f"{k}")
    for c in counters.values():
        c.launches = 0
    warm = []
    for _ in range(WARM_CALLS):
        del arrays
        t0 = time.perf_counter()
        arrays = serialize(batch, schema, MAIN_CHUNKS)
        warm.append(time.perf_counter() - t0)
    warm_launches = {k: c.launches / WARM_CALLS for k, c in counters.items()}
    if len(arrays) != MAIN_CHUNKS or wire_of(arrays) != datums:
        raise SystemExit(f"{label}: the encoded chunks differ from the "
                         f"input datums")
    med = statistics.median(warm)
    print(f"main path {label}: serialize_record_batch({batch.num_rows} "
          f"rows, {MAIN_CHUNKS}) launches: cold call {launches}, per warm "
          f"call {warm_launches}; cold {cold:.3f} s, warm median of "
          f"{WARM_CALLS} {med:.3f} s ({min(warm):.3f} .. {max(warm):.3f}) = "
          f"{batch.num_rows / med:,.0f} rec/s; chunks equal the input "
          f"datums {card}")
    return arrays, {"launches": launches, "warm_launches": warm_launches,
                    "cold_s": cold, "warm_s": warm}


def encode_phases(encoder, batch, card, label):
    """Median per phase of ``PHASE_RUNS`` encodes (host clock, each
    device phase ending in a synchronise)."""
    order = ("extract_s", "pack_s", "h2d_s", "size_s", "cumsum_s",
             "write_s", "strings_s", "d2h_s", "wrap_s")
    got = {}
    for _ in range(PHASE_RUNS):
        timings = {}
        encoder.encode(batch, timings)
        for k in order:
            got.setdefault(k, []).append(timings[k])
    print(f"encode phases {label}, ms, median (min .. max) of {PHASE_RUNS}: "
          + ", ".join(f"{k[:-2]} {spread(v)}" for k, v in got.items())
          + f" {card}")
    return {k: statistics.median(v) for k, v in got.items()}


def rows_traffic(np, em, L):
    """The bytes ``encode_rows`` must move on ``L``'s data, by a walk of
    the encode code with one mask per axis (the rows below ``n``, then
    each collection's items under its parent's mask): ``"lanes"``, each
    extractor lane entry the code reaches, read once; ``"off"``, the
    ``#off`` entry of each non-empty collection reached; ``"dst"``, 4 B
    of ``#dst`` per payload placed."""
    prog, dv = L.prog, L.dv_np
    code = prog.code.tolist()
    moved = {"lanes": 0, "off": 0, "dst": 0}

    def read(lane, mask):
        key = prog.lanes[lane]
        width = 16 if key.endswith("#dec") else dv[key].itemsize
        moved["lanes"] += width * int(np.count_nonzero(mask))

    def block(pc, stop, mask):
        """From ``pc`` to ``stop`` or the JUMP, LOOP or END that closes
        the block; returns where it stopped."""
        while pc != stop and code[pc] not in (em.OP_JUMP, em.OP_LOOP,
                                              em.OP_END):
            op = code[pc]
            if op in (em.OP_VARINT32, em.OP_F32, em.OP_BOOL):
                read(code[pc + 1], mask)
                pc += 2
            elif op in (em.OP_VARINT64, em.OP_F64, em.OP_DEC_BYTES):
                read(code[pc + 1], mask)
                read(code[pc + 2], mask)
                pc += 3
            elif op in (em.OP_STRING, em.OP_PAYLOAD):
                if op == em.OP_STRING:
                    read(code[pc + 1], mask)
                moved["dst"] += 4 * int(np.count_nonzero(mask))
                pc += 3
            elif op == em.OP_DEC_FIXED:
                read(code[pc + 2], mask)
                pc += 3
            elif op == em.OP_NULLABLE:
                read(code[pc + 1], mask)
                valid = dv[prog.lanes[code[pc + 1]]] != 0
                pc = block(pc + 4, code[pc + 3], mask & valid)
            elif op == em.OP_UNION:
                read(code[pc + 1], mask)
                tid = dv[prog.lanes[code[pc + 1]]]
                for k in range(code[pc + 2]):
                    if code[pc + 4 + k] >= 0:
                        block(code[pc + 4 + k], code[pc + 3],
                              mask & (tid == k))
                pc = code[pc + 3]
            elif op == em.OP_REPEATED:
                read(code[pc + 1], mask)
                counts = dv[prog.lanes[code[pc + 1]]]
                nonempty = mask & (counts > 0)
                moved["off"] += 4 * int(np.count_nonzero(nonempty))
                rid = prog.regions.index(prog.lanes[code[pc + 2]][:-4])
                items = np.zeros(dv["#active:%d" % rid].shape[0], bool)
                spread = np.repeat(nonempty, np.maximum(counts, 0))
                items[:spread.size] = spread
                block(pc + 4, code[pc + 3], items)
                pc = code[pc + 3]
            else:
                raise AssertionError(f"opcode {op} at {pc}")
        return pc

    block(0, len(code), np.arange(L.R) < L.n)
    return moved


def encode_kernels(torch, np, em, encoder, batch, card, fixture_err):
    """K3 at the main path's shapes: CUDA-event times of each entry and of
    the whole program, bit-equal to the plain version, the byte bounds
    of what this data needs moved, and ``torch.take`` over the payload
    byte map (the copy alone). ``max_abs_err`` also covers the fixtures'
    ``fixture_err``."""
    L = encoder.launch(batch)
    prog, R = encoder.prog, L.R
    dev = L.buf.device
    out, sizes = em.encode_kernel.run(L)
    cum = torch.cumsum(sizes, 0, dtype=torch.int32)
    total = int(sizes.to(torch.int64).sum())
    k3_ms = cuda_ms(torch, lambda: em.encode_kernel.run(L), 5)
    size_ms = cuda_ms(torch, lambda: em.encode_kernel.launch_rows(
        L, False, sizes), 5)
    write_ms = cuda_ms(torch, lambda: em.encode_kernel.launch_rows(
        L, True, sizes, cum, out), 5, prepare=L.clear_dst)
    strings_ms = cuda_ms(torch, lambda: em.encode_kernel.launch_strings(
        L, out), 5)
    dv = L.dv()
    plain = []
    rows_plain_ms = cuda_ms(torch, lambda: plain.__setitem__(
        slice(None), [em.rows_plain(dv, prog, L.cap)]), 2)
    p_out, p_sizes, p_dst = plain[0]
    strings_plain_ms = cuda_ms(torch, lambda: em.strings_plain(
        p_out, dv, prog, p_dst), 2)
    worst = max(max_abs_diff(torch, sizes, p_sizes),
                max_abs_diff(torch, out[:total], p_out[:total]))
    dst = L.dst()
    for path, d in dst.items():
        worst = max(worst, max_abs_diff(torch, d, p_dst[path]))
    if worst:
        raise SystemExit(f"main path shapes: encode kernels != plain "
                         f"(max abs diff {worst})")
    del plain, p_out, p_dst
    want = out[:total].clone()
    want_dst = {path: d.clone() for path, d in dst.items()}
    spans = em.span_plan(sizes, L.n, L.span_budget)
    # the write pass at other budgets, in turns (each bit-equal): none
    # staged, what costs no resident block, the launch's (at least the
    # floor), then back
    free = em.encode_kernel.free_span_bytes(L)
    budgets = {"none": 0, "free": max(free, 16), "launch": L.span_budget}
    write_variants = {}
    for key in ("launch", "free", "none", "none", "free", "launch"):
        b = budgets[key]
        t = cuda_ms(torch, lambda: em.encode_kernel.launch_rows(
            L, True, sizes, cum, out, budget=b), 5, prepare=L.clear_dst)
        write_variants[key] = min(t, write_variants.get(key, t))
    em.encode_kernel.launch_strings(L, out)
    torch.cuda.synchronize()
    if max_abs_diff(torch, out[:total], want) or any(
            max_abs_diff(torch, d, want_dst[path]) for path, d in dst.items()):
        raise SystemExit("main path shapes: encode_rows at another span "
                         "budget differs")
    del want, want_dst
    write_note = ", ".join(
        f"{k} ({budgets[k]} B: {'/'.join(map(str, em.span_plan(sizes, L.n, budgets[k])))} "
        f"staged/direct) {v:.3f} ms" for k, v in write_variants.items())
    idx, payload, placed = payload_map(torch, L)
    take_ms = cuda_ms(torch, lambda: torch.take(L.buf, idx), 5)
    traffic = rows_traffic(np, em, L)
    # encode_rows: the lane entries its code reaches and #off in, the
    # non-payload bytes, #dst and the row sizes out; encode_strings:
    # #src, #len and #dst of each placed payload in, its bytes in and
    # out; all of K3: the lane entries and #src in, the payload, the
    # rows' other bytes and the row sizes out (#off and #dst are its own
    # scratch)
    rows_moved = (traffic["lanes"] + traffic["off"] + traffic["dst"]
                  + (total - payload) + 4 * R)
    strings_moved = 12 * placed + 2 * payload
    k3_moved = traffic["lanes"] + 4 * placed + payload + total + 4 * R
    hbm = HBM_BYTES_PER_S / 1e3
    rows_bound, strings_bound, k3_bound = (rows_moved / hbm,
                                           strings_moved / hbm,
                                           k3_moved / hbm)
    print(f"encode at the main path's shapes (R={R}, rows={L.n}, cap="
          f"{L.cap}, {len(prog.string_cols)} payload columns, "
          f"{L.n_elems} payload lanes, {payload:,} payload bytes, "
          f"{L.n_windows} string windows, write blocks {spans[0]} staged "
          f"and {spans[1]} direct at a {L.span_budget} B span budget, total "
          f"{total:,} B): all of K3 (cumsums, fill, 3 launches) "
          f"{k3_ms:.3f} ms, bound {k3_bound:.3f} ms ({k3_moved / 1e6:.1f} "
          f"MB at 3.35 TB/s: {traffic['lanes'] / 1e6:.1f} MB of lane "
          f"entries reached of the {L.input_bytes() / 1e6:.1f} MB packed, "
          f"{4 * placed / 1e6:.1f} MB of #src, {payload / 1e6:.1f} MB of "
          f"payload, {(total + 4 * R) / 1e6:.1f} MB written), "
          f"{k3_ms / k3_bound:.2f}x; encode_rows size {size_ms:.3f} "
          f"ms + write {write_ms:.3f} ms, bound {rows_bound:.3f} ms "
          f"({rows_moved / 1e6:.1f} MB), the write pass at span budgets "
          f"in turns (best of 5 each, bit-equal): {write_note}; "
          f"encode_strings {strings_ms:.3f} "
          f"ms, bound {strings_bound:.3f} ms ({strings_moved / 1e6:.1f} "
          f"MB, {placed:,} payloads placed), torch.take over the payload byte map {take_ms:.3f} ms; "
          f"plain rows {rows_plain_ms:.1f} ms, plain strings "
          f"{strings_plain_ms:.1f} ms; bit-equal (sizes, #dst, [0, total)) "
          f"{card}")
    del L, out, idx
    err = max(worst, fixture_err)
    return ({"ms": size_ms + write_ms, "size_ms": size_ms,
             "write_ms": write_ms, "staged_blocks": spans[0],
             "direct_blocks": spans[1], "span_budget": budgets["launch"],
             "free_span_bytes": free,
             "write_ms_by_budget": write_variants, "plain_ms": rows_plain_ms,
             "bound_ms": rows_bound, "library_ms": None,
             "max_abs_err": err},
            {"ms": strings_ms, "plain_ms": strings_plain_ms,
             "bound_ms": strings_bound, "library_ms": take_ms,
             "max_abs_err": err},
            {"k3_ms": k3_ms, "k3_bound_ms": k3_bound,
             "k3_plain_ms": rows_plain_ms + strings_plain_ms,
             "payload_bytes": payload, "total_bytes": total})


def payload_map(torch, L):
    """``(idx, payload, placed)``: each placed payload byte's position in
    the launch buffer, in output order (what one ``torch.take`` gathers
    to do ``encode_strings``' work), the payload bytes and the payloads
    placed."""
    pieces, placed = [], 0
    for col in L.prog.string_cols:
        d = L.view(col.path + "#dst")
        keep = d >= 0
        placed += int(keep.sum())
        src = L.view(col.path + "#src")[keep].to(torch.int64)
        lens = L.view(col.path + "#len")[keep].to(torch.int64)
        base = L.layout[col.path + "#bytes"][0]
        starts = torch.repeat_interleave(base + src, lens)
        within = torch.arange(starts.numel(), device=L.buf.device) - \
            torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
        pieces.append(starts + within)
    idx = torch.cat(pieces) if pieces else torch.zeros(
        0, dtype=torch.int64, device=L.buf.device)
    return idx, idx.numel(), placed


def hold_encode_path(torch, em, encoder, batch, card, label):
    """K3 against its plain version on one encode main path's launch (row
    sizes, every ``#dst``, ``[0, total)`` bit-equal), the ``encode_rows``
    write blocks that staged their span and those that stored directly,
    and ``encode_strings`` beside ``torch.take`` over this path's payload
    byte map, timed in turns (strings, take, take, strings; best of 5
    each), the copy bit-equal after every turn."""
    L = encoder.launch(batch)
    out, sizes = em.encode_kernel.run(L)
    dv = L.dv()
    p_out, p_sizes, p_dst = em.rows_plain(dv, L.prog, L.cap)
    em.strings_plain(p_out, dv, L.prog, p_dst)
    total = int(p_sizes.to(torch.int64).sum())
    worst = max(max_abs_diff(torch, sizes, p_sizes),
                max_abs_diff(torch, out[:total], p_out[:total]))
    for path, d in L.dst().items():
        worst = max(worst, max_abs_diff(torch, d, p_dst[path]))
    if worst:
        raise SystemExit(f"{label}: encode kernels != plain (max abs diff "
                         f"{worst})")
    want = p_out[:total]
    del p_out, p_dst, dv
    spans = em.span_plan(sizes, L.n, L.span_budget)
    idx, payload, placed = payload_map(torch, L)
    ms = {}
    for key in ("strings", "take", "take", "strings"):
        fn = (lambda: em.encode_kernel.launch_strings(L, out)) \
            if key == "strings" else (lambda: torch.take(L.buf, idx))
        t = cuda_ms(torch, fn, 5)
        ms[key] = min(t, ms.get(key, t))
        if not torch.equal(out[:total], want):
            raise SystemExit(f"{label}: encode_strings differs after "
                             f"repeated launches")
    moved = 12 * placed + 2 * payload
    bound = moved / (HBM_BYTES_PER_S / 1e3)
    print(f"encode kernels {label}: bit-equal to the plain version (sizes, "
          f"#dst, [0, total), {total:,} B); encode_rows write blocks "
          f"{spans[0]} staged, {spans[1]} direct (span budget "
          f"{L.span_budget} B); encode_strings {L.n_windows} windows "
          f"{ms['strings']:.3f} ms, torch.take over the payload byte map "
          f"({payload:,} B, {placed:,} payloads) {ms['take']:.3f} ms (best "
          f"of 5, in turns), bound {bound:.3f} ms {card}")
    windows = L.n_windows
    del L, out, want, idx
    return {"staged_blocks": spans[0], "direct_blocks": spans[1],
            "windows": windows, "strings_ms": ms["strings"],
            "take_ms": ms["take"], "strings_bound_ms": bound,
            "payload_bytes": payload, "max_abs_err": worst}


def poison(data, every: int, offset: int = 37):
    """``data`` with one row in every ``every`` replaced by ``b"\\x01"`` (a
    union branch or a long of -1 that runs past its datum: every tier
    rejects it), and the rows replaced."""
    bad = list(range(offset, len(data), every))
    out = list(data)
    for i in bad:
        out[i] = b"\x01"
    return out, bad


def same_columns(label, got, want):
    """Every batch equal to ``want``'s: ``equals()`` batch by batch, and
    ``to_pylist()`` too on the columns that hold a union (a sliced sparse
    union can pass ``equals()`` with wrong values). A cheaper
    :func:`same_values` for comparisons between two card calls."""
    from pyruhvro_tpu_torch.ops.arrow_build import _contains_union

    if len(got) != len(want):
        raise SystemExit(f"{label}: {len(got)} batches, not {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if not g.equals(w) or any(
                _contains_union(f.type)
                and g.column(j).to_pylist() != w.column(j).to_pylist()
                for j, f in enumerate(g.schema)):
            raise SystemExit(f"{label}: batch {i} differs")


def entry_fields(entries):
    return [(q.index, q.datum, q.error, q.tier) for q in entries]


def zero(counters) -> None:
    for c in counters.values():
        c.launches = 0


def launched(label, counters):
    """The counts since the last :func:`zero`; fails if one is 0."""
    counts = {k: c.launches for k, c in counters.items()}
    for k, v in counts.items():
        if v < 1:
            raise SystemExit(f"{label}: ran without launching {k}")
    return counts


def check_quarantine(label, entries, bad, want=None):
    """Every planted row quarantined by the device tier, nothing else; the
    same entries as the CPU call's when given."""
    if [q.index for q in entries] != bad:
        raise SystemExit(f"{label}: quarantined {len(entries)} rows, not the "
                         f"{len(bad)} planted ones")
    tiers = {q.tier for q in entries}
    if tiers != {"device"}:
        raise SystemExit(f"{label}: quarantine tiers {tiers}, not device")
    if want is not None and entry_fields(entries) != entry_fields(want):
        raise SystemExit(f"{label}: quarantine differs from the CPU call's")


def policy_phase(api, pa, np, dm, wd, em, ingest, data, schema, card):
    """The public call contract on the card, each case against the same
    call with ``device="cpu"``: P1 ``on_error="skip"`` on path 1's records
    with one row in every ``POLICY_EVERY`` poisoned (K1 and K2, once more
    on K4), P2 BinaryArray input, P3 ``timeout_s``, P4 ``backend="host"``,
    P5 the encode bisect under ``"skip"`` and ``"null"``."""
    pipe = {"decode_walk": dm.walk_kernel,
            "decode_finalize": dm.finalize_kernel}
    every = {**pipe, "walk_decode": wd.walk_kernel,
             "encode_rows": em.encode_kernel.rows,
             "encode_strings": em.encode_kernel.strings}
    out = {}
    poisoned, bad = poison(data, POLICY_EVERY)

    def skip(rows, **kw):
        return api.deserialize_array_threaded(
            rows, schema, MAIN_CHUNKS, on_error="skip", return_errors=True,
            **kw)

    # P1: the cold call, the warm calls, then in turns with clean path 1
    zero(pipe)
    t0 = time.perf_counter()
    got, quar = skip(poisoned)
    cold = time.perf_counter() - t0
    launches = launched("P1", pipe)
    check_quarantine("P1", quar, bad)
    rows = sum(b.num_rows for b in got)
    if len(got) != MAIN_CHUNKS or rows != len(data) - len(bad):
        raise SystemExit(f"P1: {len(got)} batches of {rows} rows")
    zero(pipe)
    warm = []
    for _ in range(WARM_CALLS):
        t0 = time.perf_counter()
        skip(poisoned)
        warm.append(time.perf_counter() - t0)
    warm_launches = {k: c.launches / WARM_CALLS for k, c in pipe.items()}
    turns = {"poisoned": [], "clean": []}
    for leg in ("poisoned", "clean", "clean", "poisoned"):
        t0 = time.perf_counter()
        if leg == "poisoned":
            skip(poisoned)
        else:
            api.deserialize_array_threaded(data, schema, MAIN_CHUNKS)
        turns[leg].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    want, want_q = skip(poisoned, device="cpu")
    cpu_s = time.perf_counter() - t0
    same_values("P1", got, want)
    check_quarantine("P1", quar, bad, want_q)
    import os

    os.environ["PYRUHVRO_TPU_PALLAS"] = "1"
    zero({"walk_decode": wd.walk_kernel})
    t0 = time.perf_counter()
    got4, quar4 = skip(poisoned)
    k4_s = time.perf_counter() - t0
    os.environ.pop("PYRUHVRO_TPU_PALLAS")
    k4_launches = launched("P1 (PYRUHVRO_TPU_PALLAS=1)",
                           {"walk_decode": wd.walk_kernel})
    same_columns("P1 (PYRUHVRO_TPU_PALLAS=1)", got4, want)
    check_quarantine("P1 (PYRUHVRO_TPU_PALLAS=1)", quar4, bad)
    del got4, quar4
    slugs = sorted({q.error for q in quar})
    med = statistics.median(warm)
    price = (statistics.median(turns["poisoned"])
             - statistics.median(turns["clean"]))
    print(f"policy P1: deserialize_array_threaded({len(data)} records, "
          f"{len(bad)} poisoned, {MAIN_CHUNKS}, on_error='skip') quarantined "
          f"{len(quar)} rows {slugs}, every entry tier 'device', batches and "
          f"entries equal to the CPU call ({cpu_s:.1f} s); launches: cold "
          f"{launches}, per warm call {warm_launches}; cold {cold:.3f} s, "
          f"warm median of {WARM_CALLS} {med:.3f} s ({min(warm):.3f} .. "
          f"{max(warm):.3f}); in turns (A B B A) poisoned "
          f"{[round(x, 3) for x in turns['poisoned']]} clean "
          f"{[round(x, 3) for x in turns['clean']]}: a poisoned batch costs "
          f"{price:.3f} s more; K4 engine (PYRUHVRO_TPU_PALLAS=1) {k4_s:.3f} s, "
          f"launches {k4_launches}, equal {card}")
    out["p1"] = {"launches": launches, "warm_launches": warm_launches,
                 "cold_s": cold, "warm_s": warm, "turns_s": turns,
                 "cpu_s": cpu_s, "k4_s": k4_s, "k4_launches": k4_launches,
                 "quarantined": len(quar), "slugs": slugs,
                 "poisoned_price_s": price}
    del want, want_q

    # P3: a spent budget raises before any launch; a generous one is free
    zero(every)
    try:
        skip(poisoned, timeout_s=0)
        raise SystemExit("P3: timeout_s=0 returned")
    except api.DeadlineExceeded as e:
        site = e.site
    counts = {k: c.launches for k, c in every.items()}
    if any(counts.values()):
        raise SystemExit(f"P3: timeout_s=0 launched {counts}")
    t0 = time.perf_counter()
    got600, quar600 = skip(poisoned, timeout_s=600)
    t600 = time.perf_counter() - t0
    same_columns("P3", got600, got)
    if entry_fields(quar600) != entry_fields(quar):
        raise SystemExit("P3: timeout_s=600 quarantined other rows")
    print(f"policy P3: timeout_s=0 raised DeadlineExceeded at {site!r} with "
          f"every launch count 0; timeout_s=600 returned P1's result in "
          f"{t600:.3f} s {card}")
    out["p3"] = {"site": site, "timeout_600_s": t600}
    del got, quar, got600, quar600, poisoned

    # P2: the records as a BinaryArray, against the list; pack_s in turns
    t0 = time.perf_counter()
    arr = pa.array(data, pa.binary())
    arr_s = time.perf_counter() - t0
    got = api.deserialize_array_threaded(arr, schema, MAIN_CHUNKS)
    same_columns("P2", got, api.deserialize_array_threaded(
        data, schema, MAIN_CHUNKS))
    del got
    from pyruhvro_tpu_torch.ops.codec import get_device_codec
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema

    dec = get_device_codec(get_or_parse_schema(schema), DEVICE).decoder
    view, k = ingest.as_datum_input(arr), dm.overlap_chunks(len(data))
    pack = {"list": [], "binary_array": []}
    for leg in ("list", "binary_array", "binary_array", "list"):
        triples = dec.decode_to_columns_overlapped(
            data if leg == "list" else view, k)
        pack[leg].append(triples[0][2]["timings"]["pack_s"])
        del triples
    print(f"policy P2: deserialize_array_threaded(pa.array({len(data)} "
          f"records, pa.binary())) equal to the list's batches; pack_s in "
          f"turns (A B B A), ms: list "
          f"{[round(x * 1e3, 1) for x in pack['list']]}, BinaryArray "
          f"{[round(x * 1e3, 1) for x in pack['binary_array']]} (building "
          f"the array {arr_s:.2f} s, excluded) {card}")
    out["p2"] = {"pack_s": pack, "array_build_s": arr_s}
    del arr, view

    # P4: the host oracle against the card, decode and encode
    sub = data[:POLICY_HOST_ROWS]
    t0 = time.perf_counter()
    host = api.deserialize_array_threaded(sub, schema, MAIN_CHUNKS,
                                          backend="host")
    host_s = time.perf_counter() - t0
    same_values("P4", host, api.deserialize_array_threaded(
        sub, schema, MAIN_CHUNKS, device="cpu"))
    same_columns("P4", host, api.deserialize_array_threaded(
        sub, schema, MAIN_CHUNKS))
    batch = api.deserialize_array(sub, schema)
    t0 = time.perf_counter()
    hwire = wire_of(api.serialize_record_batch(batch, schema, MAIN_CHUNKS,
                                               backend="host"))
    host_enc_s = time.perf_counter() - t0
    if hwire != sub or wire_of(api.serialize_record_batch(
            batch, schema, MAIN_CHUNKS)) != hwire:
        raise SystemExit("P4: the host encode differs from the card's or "
                         "from the input datums")
    print(f"policy P4: backend='host' on {len(sub)} records: decode "
          f"{host_s:.3f} s, encode {host_enc_s:.3f} s (host clock), equal to "
          f"the card's decode and encode and to the input datums {card}")
    out["p4"] = {"decode_s": host_s, "encode_s": host_enc_s}

    # P5: the encode bisect, "skip" and (on a nullable copy) "null"
    rng = np.random.default_rng(5)
    n = POLICY_ENCODE_ROWS
    vals = rng.integers(-128, 128, size=n)
    ebad = sorted(int(i) for i in rng.choice(n, size=4, replace=False))
    vals[ebad] = rng.integers(200, 1000, size=4)
    from decimal import Decimal

    dec_arr = pa.array([Decimal(int(v)) for v in vals],
                       type=pa.decimal128(3, 0))
    enc = {"encode_rows": em.encode_kernel.rows,
           "encode_strings": em.encode_kernel.strings}
    p5 = {}
    for policy, schema5, nullable in (("skip", DECIMAL_SCHEMA, False),
                                      ("null", DECIMAL_SCHEMA, False),
                                      ("null", NULL_DECIMAL_SCHEMA, True)):
        field = pa.field("d", dec_arr.type, nullable=nullable)
        batch5 = pa.RecordBatch.from_arrays([dec_arr],
                                            schema=pa.schema([field]))
        zero(enc)
        t0 = time.perf_counter()
        wire5, q5 = api.serialize_record_batch(
            batch5, schema5, MAIN_CHUNKS, on_error=policy,
            return_errors=True)
        t5 = time.perf_counter() - t0
        rows_launches = em.encode_kernel.rows.launches
        want5, wq5 = api.serialize_record_batch(
            batch5, schema5, MAIN_CHUNKS, on_error=policy,
            return_errors=True, device="cpu")
        keep = n if nullable else n - len(ebad)
        if [q.index for q in q5] != ebad or \
                entry_fields(q5) != entry_fields(wq5) or \
                {q.tier for q in q5} != {"device"}:
            raise SystemExit(f"P5 {policy}: quarantined {entry_fields(q5)}")
        got5 = wire_of(wire5)
        if len(got5) != keep or got5 != wire_of(want5):
            raise SystemExit(f"P5 {policy}: {len(got5)} rows, or a wire "
                             f"other than the CPU call's")
        label = f"{policy}{' (nullable schema)' if nullable else ''}"
        print(f"policy P5: serialize_record_batch({n} rows, 4 do not fit, "
              f"on_error={policy!r}{', nullable schema' if nullable else ''})"
              f" quarantined {ebad}, {len(got5)} rows out, wire equal to the "
              f"CPU call's; the bisect took {rows_launches} encode_rows "
              f"launches, {t5:.3f} s {card}")
        p5[label] = {"encode_rows_launches": rows_launches, "s": t5,
                     "rows_out": len(got5)}
    out["p5"] = p5
    # the paths line reads a warm median from every entry
    out["warm_s"] = warm
    return out


def main() -> int:
    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA card", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if not (here / "pyruhvro_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no pyruhvro_tpu_torch package beside {here}; run "
              f"it from the root of a checkout of the repository",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(here))
    import threading

    import numpy as np
    import pyarrow as pa

    from pyruhvro_tpu_torch import (
        DeviceCapacityExceeded,
        MalformedAvro,
        UnsupportedOnDevice,
        deserialize_array,
        deserialize_array_threaded,
        serialize_record_batch,
    )
    from pyruhvro_tpu_torch.ops import decode as dm
    from pyruhvro_tpu_torch.ops import encode as em
    from pyruhvro_tpu_torch.ops import walk_decode as wd
    from pyruhvro_tpu_torch.ops.arrow_build import build_record_batch
    from pyruhvro_tpu_torch.ops.codec import _concat_batches, get_device_codec
    import pyruhvro_tpu_torch as port
    from pyruhvro_tpu_torch.runtime import capacity, ingest, native
    from pyruhvro_tpu_torch.runtime import pack as packing
    from pyruhvro_tpu_torch.runtime.chunking import chunk_bounds
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema
    from pyruhvro_tpu_torch.schema.parser import parse_schema
    from pyruhvro_tpu_torch.utils import datagen

    os.environ.pop("PYRUHVRO_TPU_PALLAS", None)

    # 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = smi_name_power()
    print(f"device: {name} capability={cap} torch={torch.__version__} "
          f"cuda={torch.version.cuda} count={torch.cuda.device_count()}")
    print(smi)
    card = f"[{smi}]"

    # 2. build: one nvcc per source, all started together
    kernels = {"walk_decode": wd.walk_kernel, "decode_walk": dm.walk_kernel,
               "decode_finalize": dm.finalize_kernel,
               "encode": em.encode_kernel}
    libs, failures = {}, []

    def build(key):
        try:
            libs[key] = kernels[key].library()
        except Exception as e:  # reported below, the smoke then fails
            failures.append(f"{key}: {e}")

    def build_packer():
        try:
            libs["packer"] = native.load_packer()
        except Exception as e:  # reported below, the smoke then fails
            failures.append(f"packer: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(k,)) for k in kernels]
    threads.append(threading.Thread(target=build_packer))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise SystemExit("build failed: " + "; ".join(failures))
    print(f"build: {len(libs)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    packer = libs.pop("packer")
    print(f"build: {' '.join(packer.command)} ({packer.path.name}) in "
          f"{packer.build_s:.2f} s")
    for key, lib in libs.items():
        print(f"build: nvcc {kernels[key].source} -> {lib.path.name} "
              f"(sm_90a) in {lib.build_s:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 3. K4 against its plain walk
    errors = (MalformedAvro, UnsupportedOnDevice)
    worst = {"walk_decode": 0, "decode_walk": 0, "decode_finalize": 0}
    for fx in fixtures(datagen, parse_schema):
        worst["walk_decode"] = max(worst["walk_decode"], check_fixture(
            torch, np, wd, *fx, parse_schema, errors))

    # 4. K1 and K2 against their plain versions
    t0 = time.perf_counter()
    perrors = (MalformedAvro, UnsupportedOnDevice, DeviceCapacityExceeded)
    walk_blocks = [0, 0]
    for fx in pipeline_fixtures(datagen, parse_schema, PIPELINE_ROWS) + \
            block_edge_fixtures(datagen, parse_schema, PIPELINE_ROWS):
        w, blocks = check_pipeline_fixture(torch, np, dm, *fx, parse_schema,
                                           perrors)
        worst["decode_walk"] = max(worst["decode_walk"], w)
        worst["decode_finalize"] = max(worst["decode_finalize"], w)
        walk_blocks = [walk_blocks[0] + blocks[0], walk_blocks[1] + blocks[1]]
    if not all(walk_blocks):
        raise SystemExit(f"decode_walk ran {walk_blocks[0]} staged and "
                         f"{walk_blocks[1]} device-memory blocks over the "
                         f"fixtures: both paths must run")
    print(f"pipeline fixtures: {time.perf_counter() - t0:.1f} s; "
          f"decode_walk blocks {walk_blocks[0]} staged, {walk_blocks[1]} "
          f"reading device memory")
    # 4b. K3 against its plain version
    t0 = time.perf_counter()
    worst["encode"] = 0

    def cpu_decode(datums, schema):
        return deserialize_array(datums, schema, device="cpu")

    def card_decode(datums, schema):
        return deserialize_array(datums, schema)

    spans = [0, 0]
    for fx in encode_fixtures(pa, datagen, parse_schema, cpu_decode,
                              PIPELINE_ROWS):
        w, (staged, direct) = check_encode_fixture(torch, em, *fx,
                                                   parse_schema, card_decode)
        worst["encode"] = max(worst["encode"], w)
        spans[0] += staged
        spans[1] += direct
    print(f"encode fixtures: {time.perf_counter() - t0:.1f} s; encode_rows "
          f"write blocks {spans[0]} staged, {spans[1]} direct")

    # 5. the main paths
    kafka = datagen.KAFKA_SCHEMA_JSON
    t0 = time.perf_counter()
    data = datagen.kafka_style_datums(MAIN_ROWS, seed=0)
    print(f"data: {MAIN_ROWS} Kafka records, {sum(map(len, data)):,} bytes, "
          f"generated in {time.perf_counter() - t0:.1f} s (excluded)")
    pipe = {"decode_walk": dm.walk_kernel,
            "decode_finalize": dm.finalize_kernel}
    results = {}
    got1, results["kafka"] = drive("1 (Kafka, default engine)", data, kafka,
                                   pipe, deserialize_array_threaded, card)
    chunks1 = dm.overlap_chunks(len(data))
    if chunks1 != MAIN_CHUNKS or \
            results["kafka"]["warm_launches"]["decode_walk"] != chunks1:
        raise SystemExit(f"main path 1: {chunks1} overlap chunks and "
                         f"{results['kafka']['warm_launches']} launches per "
                         f"warm call: the overlapped path must launch "
                         f"decode_walk once per chunk")
    os.environ["PYRUHVRO_TPU_OVERLAP"] = "0"
    got1s, results["kafka_single"] = drive(
        "1s (Kafka, one launch, PYRUHVRO_TPU_OVERLAP=0)", data, kafka, pipe,
        deserialize_array_threaded, card)
    os.environ.pop("PYRUHVRO_TPU_OVERLAP")
    if results["kafka_single"]["warm_launches"]["decode_walk"] != 1:
        raise SystemExit("main path 1s: the one launch ran "
                         f"{results['kafka_single']['warm_launches']}")
    results["kafka"]["turns_s"] = warm_turns(
        "1 and 1s", data, kafka, deserialize_array_threaded, card)
    os.environ["PYRUHVRO_TPU_PALLAS"] = "1"
    got2, results["kafka_pallas"] = drive(
        "2 (Kafka, PYRUHVRO_TPU_PALLAS=1)", data, kafka,
        {"walk_decode": wd.walk_kernel}, deserialize_array_threaded, card)
    os.environ.pop("PYRUHVRO_TPU_PALLAS")
    t0 = time.perf_counter()
    want = deserialize_array_threaded(data, kafka, MAIN_CHUNKS, device="cpu")
    cpu_s = time.perf_counter() - t0
    same_values("main path 1", got1, want)
    same_values("main path 1s", got1s, want)
    same_values("main path 2", got2, want)
    print(f"main paths 1, 1s and 2 equal the CPU call ({cpu_s:.1f} s) value "
          f"by value on all {MAIN_CHUNKS} batches")
    del got1, got1s, got2, want

    nested_schema = PIPELINE_SHAPES["arr_rec_arr"]
    t0 = time.perf_counter()
    nested = datagen.random_datums(parse_schema(nested_schema), NESTED_ROWS,
                                   seed=0)
    print(f"data: {NESTED_ROWS} arr_rec_arr records, "
          f"{sum(map(len, nested)):,} bytes, generated in "
          f"{time.perf_counter() - t0:.1f} s (excluded)")
    got3, results["nested"] = drive("3 (nested arr_rec_arr)", nested,
                                    nested_schema, pipe,
                                    deserialize_array_threaded, card)
    same_values("main path 3", got3, deserialize_array_threaded(
        nested, nested_schema, MAIN_CHUNKS, device="cpu"))
    del got3
    t0 = time.perf_counter()
    large = large_kafka_datums(datagen, parse_schema, LARGE_ROWS, seed=0)
    sizes = [len(d) for d in large]
    print(f"data: {LARGE_ROWS} Kafka records of {min(sizes)} to "
          f"{max(sizes)} B, {sum(sizes):,} bytes, generated in "
          f"{time.perf_counter() - t0:.1f} s (excluded)")
    got4, results["large"] = drive("4 (Kafka records of 4-16 KiB)", large,
                                   kafka, pipe, deserialize_array_threaded,
                                   card)
    same_values("main path 4", got4, deserialize_array_threaded(
        large, kafka, MAIN_CHUNKS, device="cpu"))
    del got4
    print("main paths 3 and 4 equal the CPU calls value by value")

    # 5b. the encode main path: path 1's records decoded into one batch,
    # then serialize_record_batch; the chunks must be the input datums
    enc_counters = {"encode_rows": em.encode_kernel.rows,
                    "encode_strings": em.encode_kernel.strings}
    encode_paths = (("5 (Kafka encode)", "kafka_encode", data, kafka),
                    ("3e (nested re-encode)", "nested_encode", nested,
                     nested_schema),
                    ("4e (large records re-encode)", "large_encode", large,
                     kafka))
    enc_batches = {}
    for label, key, rows, schema in encode_paths:
        t0 = time.perf_counter()
        batch = deserialize_array(rows, schema)
        print(f"encode input {key}: {batch.num_rows} rows decoded on the "
              f"card in {time.perf_counter() - t0:.1f} s (excluded)")
        got, results[key] = drive_encode(label, batch, rows, schema,
                                         enc_counters,
                                         serialize_record_batch, card)
        t0 = time.perf_counter()
        want = serialize_record_batch(batch, schema, MAIN_CHUNKS,
                                      device="cpu")
        cpu_s = time.perf_counter() - t0
        for i, (g, w) in enumerate(zip(got, want)):
            if not g.equals(w):
                raise SystemExit(f"main path {label}: chunk {i} differs from "
                                 f"the CPU call")
        print(f"main path {label}: equal to the CPU call ({cpu_s:.1f} s) on "
              f"all {MAIN_CHUNKS} chunks")
        enc_batches[key] = (batch, schema)
        del got, want

    # 5c. the public call contract: error policies, deadlines, BinaryArray
    # input, the host oracle, the encode bisect
    t0 = time.perf_counter()
    results["policy"] = policy_phase(port, pa, np, dm, wd, em, ingest, data,
                                     kafka, card)
    print(f"policy phase: {time.perf_counter() - t0:.1f} s")

    # 6. phases and kernels at the main paths' shapes
    os.environ["PYRUHVRO_TPU_PALLAS"] = "1"
    k4codec = get_device_codec(get_or_parse_schema(kafka), DEVICE)
    os.environ.pop("PYRUHVRO_TPU_PALLAS")
    phases(k4codec.decoder, data, build_record_batch, k4codec, card,
           "path 2 (K4 engine)")
    k4 = k4_kernel(torch, wd, k4codec.decoder, data, libs["walk_decode"],
                   card)
    pipeline_paths = (("path 1 (Kafka)", "kafka", data, kafka),
                      ("path 3 (nested)", "nested", nested, nested_schema),
                      ("path 4 (large records)", "large", large, kafka))
    for label, key, rows, schema in pipeline_paths:
        codec = get_device_codec(get_or_parse_schema(schema), DEVICE)
        results[key]["phases"] = overlap_phases(
            dm, packing, codec, rows, build_record_batch, _concat_batches,
            card, label)
        results[key]["cold"] = planner_cold(dm, capacity, codec.decoder,
                                            rows, card, label)
        triples = codec.decoder.decode_to_columns_overlapped(
            rows, dm.overlap_chunks(len(rows)))
        totals = {}
        for _host, _n, meta in triples:
            for path, v in meta["item_totals"].items():
                totals[path] = totals.get(path, 0) + v
        print(f"{label}: item totals per region over the chunks {totals}, "
              f"{sum(map(len, rows)):,} record bytes")
        del triples
    codec = get_device_codec(get_or_parse_schema(kafka), DEVICE)
    results["kafka_single"]["phases"] = phases(
        codec.decoder, data, build_record_batch, codec, card,
        "path 1s (one launch)")
    # K1 and K2 against their plain versions on the main paths' data, at
    # every rung of every chunk of a fresh decoder, and of path 1's one
    # launch
    held = [(label, rows, schema, True)
            for label, _key, rows, schema in pipeline_paths]
    held.append(("path 1s (one launch)", data, kafka, False))
    for label, rows, schema, chunked in held:
        t0 = time.perf_counter()
        dec = dm.DeviceDecoder(parse_schema(schema), DEVICE)
        rungs, blocks = hold_kernels(torch, dm, dec, label)
        if chunked:
            dec.decode_to_columns_overlapped(rows,
                                             dm.overlap_chunks(len(rows)))
        else:
            dec.decode_to_columns(rows)
        print(f"{label}: decode_walk and decode_finalize bit-equal to their "
              f"plain versions (every buffer, #err, the blob) at every rung "
              f"(max cap, compact) {rungs}, decode_walk blocks staged/device "
              f"memory {blocks[0]}/{blocks[1]}, in "
              f"{time.perf_counter() - t0:.1f} s")
        del dec
    # K1 and K2 at each overlapped path's largest chunk, and at path 1's
    # one launch
    at_chunks = {}
    for label, key, rows, schema in pipeline_paths:
        bounds = chunk_bounds(len(rows), dm.overlap_chunks(len(rows)))
        a, b = max(bounds, key=lambda ab: sum(map(len, rows[ab[0]:ab[1]])))
        at_chunks[key] = pipeline_kernels(
            torch, dm, get_device_codec(get_or_parse_schema(schema),
                                        DEVICE).decoder,
            rows[a:b], card, f"{label}'s chunk shapes",
            breakdown=key == "kafka")
    k1, k2 = dict(at_chunks["kafka"][0]), dict(at_chunks["kafka"][1])
    k1["chunk_shapes"] = {key: v[0] for key, v in at_chunks.items()}
    k2["chunk_shapes"] = {key: v[1] for key, v in at_chunks.items()}
    k1["single_launch"], k2["single_launch"] = pipeline_kernels(
        torch, dm, codec.decoder, data, card, "path 1's one-launch shapes")
    k1["single_launch_levers"] = k1_kernel(
        torch, dm, codec.decoder, data, libs["decode_walk"], card)
    k1["nested_stack_ms"] = walk_stacks(
        torch, dm, get_device_codec(get_or_parse_schema(nested_schema),
                                    DEVICE).decoder, nested, "path 3", card)
    for key, (batch, schema) in enc_batches.items():
        enc = get_device_codec(get_or_parse_schema(schema), DEVICE)._encoder
        results[key]["phases_ms"] = {
            k: v * 1e3 for k, v in encode_phases(enc, batch, card,
                                                 key).items()}
    kbatch, _schema = enc_batches["kafka_encode"]
    kenc = get_device_codec(get_or_parse_schema(kafka), DEVICE)._encoder
    k3_rows, k3_strings, k3 = encode_kernels(torch, np, em, kenc, kbatch,
                                             card, worst["encode"])
    results["kafka_encode"]["k3"] = k3
    for key, (batch, schema) in enc_batches.items():
        enc = get_device_codec(get_or_parse_schema(schema), DEVICE)._encoder
        held = results[key]["k3_held"] = hold_encode_path(
            torch, em, enc, batch, card, key)
        spans[0] += held["staged_blocks"]
        spans[1] += held["direct_blocks"]
    if not all(spans):
        raise SystemExit(f"encode_rows ran {spans[0]} staged and {spans[1]} "
                         f"direct write blocks: both paths must run")

    regs = {f"pyruhvro_tpu_torch/csrc/{kernels[k].source}":
            "/".join(re.findall(r"Used (\d+) registers", lib.log))
            for k, lib in libs.items()}
    rows = [
        {"name": "walk_decode", "route": "cuda",
         "source": "pyruhvro_tpu_torch/csrc/walk_decode.cu",
         "replaces": "pyruhvro_tpu/ops/pallas_decode.py:256",
         "replaces_function": "PallasKernelDecoder._build",
         "launches": results["kafka_pallas"]["launches"]["walk_decode"],
         "max_abs_err": worst["walk_decode"], **k4, "bound_by": "bytes",
         "library_ms": None},
        {"name": "decode_walk", "route": "cuda",
         "source": "pyruhvro_tpu_torch/csrc/decode_walk.cu",
         "replaces": "pyruhvro_tpu/ops/decode.py:373",
         "replaces_function": "DeviceDecoder._trace_walk",
         "launches": results["kafka"]["launches"]["decode_walk"],
         "max_abs_err": worst["decode_walk"], **k1, "bound_by": "bytes"},
        {"name": "decode_finalize", "route": "cuda",
         "source": "pyruhvro_tpu_torch/csrc/decode_finalize.cu",
         "replaces": "pyruhvro_tpu/ops/decode.py:456",
         "replaces_function": "DeviceDecoder.build_pipeline (pipeline)",
         "launches": results["kafka"]["launches"]["decode_finalize"],
         "max_abs_err": worst["decode_finalize"], **k2, "bound_by": "bytes"},
        {"name": "encode_rows", "route": "cuda",
         "source": "pyruhvro_tpu_torch/csrc/encode.cu",
         "replaces": "pyruhvro_tpu/ops/encode.py:1328",
         "replaces_function": "DeviceEncoder._program (size and write "
                              "passes)",
         "launches": results["kafka_encode"]["launches"]["encode_rows"],
         **k3_rows, "bound_by": "bytes"},
        {"name": "encode_strings", "route": "cuda",
         "source": "pyruhvro_tpu_torch/csrc/encode.cu",
         "replaces": "pyruhvro_tpu/ops/encode.py:579",
         "replaces_function": "_write_string_bytes (in "
                              "DeviceEncoder._program)",
         "launches": results["kafka_encode"]["launches"]["encode_strings"],
         **k3_strings, "bound_by": "bytes"},
    ]
    for r in rows:
        r["registers"] = regs[r["source"]]
    print(json.dumps({"paths": {k: {**v, "warm_median_s": statistics.median(
        v["warm_s"])} for k, v in results.items()}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
