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
   ``encode.cu``) and one ``g++`` for each native host module (the record
   pack ``packer.cpp``, the host tier's VM ``host/host_codec.cpp`` and
   extractor ``host/extract.cpp``) and for the host tier's specialised
   units of the Kafka and ``arr_rec_arr`` schemas
   (``hostpath/specialize.py``), all started together, with ptxas
   registers and spills, and each ``g++`` command and its seconds;
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
   equal to the CPU call's — ``equals()`` and the union columns' values on
   every chunk, value by value on the first —, K1 and K2 launches
   counted from 0, the cold
   and warm calls, the warm calls in turns with clean path 1, and once on
   the K4 engine), P2 the records as a ``BinaryArray`` (equal batches,
   ``pack_s`` in turns with the list), P3 ``timeout_s=0`` (raises before
   any launch) and ``timeout_s=600`` (P1's result), P4 ``backend="host"``
   on ``POLICY_HOST_ROWS`` records (decode and encode equal to the
   card's), P5 the encode bisect on ``POLICY_ENCODE_ROWS`` one-byte
   decimals with 4 that do not fit under ``"skip"`` and ``"null"`` (the
   planted rows quarantined, the wire equal to the CPU call's, the
   ``encode_rows`` launches it took); then the ``host`` phase, the
   native host tier (``backend="host"``) against the card, with the
   host's CPU model, ``os.cpu_count()`` and affinity: H1 path 1, H2
   paths 3 and 4, H3 path 5's encode (each: the codec's lane counts
   from 0 over the cold call, the warm median of ``WARM_CALLS``, warm
   calls in turns with the card's, A B B A twice, the result equal to
   the card's; H1 must decode on the fused lane through the shard
   runner, H3 take the native extract and give the input datums), H4
   the crossover (Kafka batches of 1,000 to 1,000,000 records, card
   against host in turns), H5 P4's records on the oracle
   (``PYRUHVRO_TPU_NO_NATIVE=1``) beside the native tier, H6 path 1 on
   the specialised engine against the VM (``PYRUHVRO_TPU_NO_SPECIALIZE=1``)
   in turns, decode and encode, equal, with the unit's ``g++`` seconds,
   and the lane counters;
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
   then the ``telemetry`` phase (T1-T4) and the ``route`` phase
   (:func:`route_phase`): R1 ``backend="auto"`` on paths 1 and 5 (the
   static verdict ``device_selected``, the device path's launches, equal
   batches, the ledger's predicted and observed seconds), R3
   ``PYRUHVRO_TPU_POOL=process`` on the host tier (path 1 and P1 against
   the shard runner in turns, the workers' spans under the caller's
   trace, no worker on the card), R2 ``PYRUHVRO_TPU_AUTOTUNE=1`` on 10k,
   100k and 1M Kafka records (each arm's predicted and observed seconds,
   the settled arm), R4 capacity plans persisted by one fresh process and
   read by the next (``PYRUHVRO_TPU_CAPACITY_PERSIST=1``), R5 the host
   answer to a record past ``_MAX_ITEM_CAP`` under ``"auto"`` only;
7. the ``multichip`` phase (:func:`multichip_phase`), K5: M1
   ``ShardedDecoder`` over every visible card on path 1's records (each
   shard's blob and ``#err`` bit-equal to the plain versions' and the
   one-card pipeline's at the same rung, K1/K2 counted from 0; with two
   cards or more the codec's fan-out under ``device="cuda"`` and the
   one-card path on ``cuda:1``), a batch of fewer rows than shards; M2
   ``MULTI_SHARDS`` shards on card 0 through the codec (the shards'
   batches returned as they are), warm calls in turns with path 1, each
   shard's K1/K2 by CUDA events; M3 path 3 from a cold decoder (rungs
   and ``device.retries`` equal to a cold one-card launch's); M4
   ``ShardedEncoder`` on path 5's batch (each shard's K3 bit-equal to
   the plain encode, the wire equal to the input datums); M5 bad rows in
   shards 2 and 6 (one ``MalformedAvro`` equal to the one-card path's);
8. the ``planes`` phase (:func:`planes_phase`) on the first
   ``PLANES_ROWS`` of path 1's records: C1 arrays of null items encode
   on the card to the oracle's wire; F1 ``device_launch`` and ``h2d``
   faults raise ``FaultInjected`` under ``backend="device"`` and
   ``"auto"``, counted, with no host answer, the next call equal to
   the CPU call; F2 an ``h2d`` hang under ``timeout_s=0.5`` raises
   ``DeadlineExceeded``; F3 two threads decode on the card under
   ``schedtest.run_interleaved`` for three seeds, equal, no stall; S1 a
   deep-sampled call (each launch waited on, the waits counted) against
   a plain one in turns, with the sampler's overhead estimate; L1 an SLO breached by
   the card's calls, its flight dump holding the device launches'
   spans, its ``alert_command`` run;
9. the ``incident`` phase (:func:`incident_phase`, A1-A3, O1, I1, T1):
   the audit shadow of the card's decode and encode, a planted byte, the
   obs server, one incident bundle, the timeline's deltas;
10. the ``serving`` phase (:func:`serving_phase`, V1-V5) on the first
   ``SERVING_ROWS`` of path 1's records: the micro-batching plane's
   requests from several threads against one-shot calls on the card
   (equal, K1/K2 launches per coalesced batch against per request, the
   end-to-end latencies in turns), ``shed`` at depth 8, the brownout
   ladder in ``/healthz``, a poisoned member rebased and a launch fault
   in every member's future, encode requests and the Flight door;
11. the ``memory`` phase (:func:`memory_phase`, G1-G6): the memory
   accounting's planes at path 1's size against the card's allocator,
   the phase's arenas and buckets evicted (``memory_allocated`` falls by
   the arenas' card bytes; the next call launches them first again and
   is equal) and the specialised host engines (re-admitted without a
   second ``g++`` run), a pressure relief (``/healthz`` 503, RSS and the
   allocators before and after), three tenants' decodes and encodes,
   ``/memory`` and ``mem-report``, the OTLP export of those calls and
   the fleet merge and diff;
12. ``{"host": ...}``, ``{"telemetry": ...}``, ``{"route": ...}``,
   ``{"multichip": ...}``, ``{"planes": ...}``, ``{"incident": ...}``,
   ``{"serving": ...}``, ``{"memory": ...}``, ``{"paths": ...}`` and
   ``{"kernels": [...]}`` JSON lines (K5 as ``sharded_fanout``), then
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
POLICY_WARM_CALLS = 2       # P1: warm calls (fewer than WARM_CALLS: time)

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
        # arrays of null items stay out: the reference's extractor, which
        # the encode tests hold these fixtures against, rejects them (the
        # port writes the oracle's wire, ROADMAP.md (c) 1; planes C1)
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


# cycles of the spin kernel that keeps the stream busy while the host
# enqueues a call timed by queued_ms (about 10 ms at the H100's clock)
QUEUE_SPIN_CYCLES = 20_000_000


def queued_ms(torch, fn, repeats: int, prepare=None) -> float:
    """Best device time of ``fn``'s kernels over ``repeats`` runs, by CUDA
    events, after one warm run, with the stream kept busy by a spin kernel
    (``torch.cuda._sleep``) while the host enqueues the start event,
    ``fn`` and the end event: the kernels back to back with the host's
    enqueue hidden, as a profiler trace shows them, where :func:`cuda_ms`
    on an idle stream also holds the host's launch latency. ``prepare``
    runs before the spin, untimed. Fails if the spin of a timed run ended
    before the host had enqueued the end event (the warm run may load
    modules for longer)."""
    best = float("inf")
    for i in range(repeats + 1):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        if i and start.query():
            raise SystemExit("queued_ms: the spin ended before the host "
                             "enqueued the timed call")
        torch.cuda.synchronize()
        if i:
            best = min(best, start.elapsed_time(end))
    return best


MEMORY_ROWS = 100_000       # G4-G6: Kafka records per tenant call
MEMORY_TENANTS = ("t-alpha", "t-beta", "t-gamma")
MEMORY_TP = "00-" + "5d" * 16 + "-" + "a1" * 8 + "-01"
MEMORY_HOST_ROWS = 30_000   # G2/G3: host rows, past the specialiser's 20,000


def round512(n: int) -> int:
    """A request's size rounded as PyTorch's caching allocator rounds it
    first: at least 512 bytes, a multiple of 512."""
    return max(512, -(-n // 512) * 512)


def block_sizes(torch, tensors):
    """The caching allocator's own block size of each tensor (its
    ``memory_snapshot()`` block at the tensor's address): what
    ``memory_allocated`` counts for it. A large request takes a whole new
    segment, rounded to 2 MiB, when the rest would be under 1 MiB."""
    blocks = {b["address"]: b["size"] for seg in torch.cuda.memory_snapshot()
              for b in seg["blocks"] if b["state"] == "active_allocated"}
    return [blocks.get(t.data_ptr()) for t in tensors]


def memory_phase(api, pa, torch, dm, em, data, schema, card):
    """Memory accounting, the cache lifecycle, ``tenant=``, the OTLP
    exporter and the fleet merge against the card's decode and encode,
    under a schema string of its own (sticky caps after R5), from
    ``telemetry.reset()``:

    * G1: a cold and a warm ``deserialize_array_threaded`` of path 1's
      records (8 chunks, R = 131,072), then ``snapshot_memory()``: every
      plane's bytes and items, ``tracked_bytes`` against ``rss_bytes``,
      the arenas' card bytes against ``torch.cuda.memory_allocated``
      before the cold call and after the warm one;
    * G2: an arena whose ``consumed`` event waits behind a spin kernel
      is not evicted (``device.arena.evict_busy``); then the phase
      decoder's arenas and buckets evicted through the hooks
      registered with ``cachelife``: ``memory_allocated`` falls by the
      arenas' card blocks as the allocator sized them (:func:`block_sizes`;
      beside their bytes rounded to 512 B); RSS before and after
      (the pinned blocks stay in PyTorch's host cache); the next call
      launches its buckets as first launches and is equal to the call
      before the eviction; then the specialised host engines evicted
      after a ``backend="host"`` call of ``MEMORY_HOST_ROWS`` records:
      the next host call re-admits its engine from the file, with no
      ``g++`` run (``specialize.builds``), and is equal;
    * G3: ``PYRUHVRO_TPU_MEM_HIGH_WATER=1`` and ``force_pressure_check()``:
      ``mem.pressure``, ``cache.evict.*.pressure`` (the engines' among
      them) and one allocator release counted, ``/healthz`` 503 with
      ``mem_pressure``; RSS, ``memory_allocated`` and
      ``memory_reserved`` before and after; the next call equal, and the
      next host call on its engine's file, with no ``g++`` run;
    * G4: decode and encode of ``MEMORY_ROWS`` records under each of
      ``MEMORY_TENANTS``: the sketch's rows, ``tenant`` on each root span,
      ``/memory`` equal to ``snapshot_memory()`` on the same state, and
      ``mem-report`` of the saved snapshot naming the tenants;
    * G5: the OTLP exporter on a collector stub in this process over G4's
      calls: every span under the caller's trace id, the
      ``device.launch_s`` histogram with an exemplar;
    * G6: the obs server's live snapshot merged with a saved copy of
      itself (every counter exactly twice), and the diff of the phase's
      first and last snapshots naming the phase's counters.

    Every failure exits non-zero. Returns the phase's figures."""
    import contextlib
    import gc
    import io
    import os
    import shutil
    import tempfile
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from pyruhvro_tpu_torch.api import _native_host_codec as native_host_codec
    from pyruhvro_tpu_torch.ops.codec import get_device_codec
    from pyruhvro_tpu_torch.runtime import (cachelife, device_obs, fleet,
                                            memacct, metrics, obs_server,
                                            otel, telemetry)
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema

    doc = json.loads(schema)
    doc["doc"] = "memory phase"
    schema = json.dumps(doc)
    pipe = {"decode_walk": dm.walk_kernel,
            "decode_finalize": dm.finalize_kernel}
    enc = {"encode_rows": em.encode_kernel.rows,
           "encode_strings": em.encode_kernel.strings}
    out = {}
    telemetry.reset()
    first = json.loads(json.dumps(telemetry.snapshot(), default=str))

    def mem_now():
        torch.cuda.synchronize()
        return {"rss": memacct.rss_bytes(),
                "allocated": torch.cuda.memory_allocated(),
                "reserved": torch.cuda.memory_reserved()}

    def call(rows=data, **kw):
        return api.deserialize_array_threaded(rows, schema, MAIN_CHUNKS, **kw)

    def host_call():
        # past the specialiser's threshold (PYRUHVRO_TPU_SPECIALIZE_ROWS)
        return api.deserialize_array(data[:MEMORY_HOST_ROWS], schema,
                                     backend="host")

    # G1: the probes at path 1's size
    m0 = mem_now()
    t0 = time.perf_counter()
    call()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    before = call()
    warm_s = time.perf_counter() - t0
    m1 = mem_now()
    dec = get_device_codec(get_or_parse_schema(schema), DEVICE).decoder
    arenas = dict(dec._arenas)
    card_bytes = [a.dev.nbytes for a in arenas.values()]
    host_bytes = [a.host_t.nbytes for a in arenas.values()]
    words = [a.dev.numel() for a in arenas.values()]
    memacct.collect(force=True)  # not the phase start's memoized walk
    snap = memacct.snapshot_memory()
    caches = snap["caches"]
    planes = {k: {kk: v.get(kk) for kk in ("bytes", "items", "device_bytes")
                  if kk in v} for k, v in caches.items()}
    missing = {"cache.schema", "cache.executables", "cache.arenas",
               "cache.kernels", "capacity", "routing", "rings"} - set(caches)
    if missing or len(arenas) != 2 or \
            caches["cache.kernels"]["items"] < 3 or \
            caches["cache.arenas"]["device_bytes"] < sum(card_bytes) or \
            m1["allocated"] - m0["allocated"] < sum(card_bytes):
        raise SystemExit(f"memory G1: planes {planes} (missing {missing}), "
                         f"the phase's arenas {len(arenas)} of card bytes "
                         f"{card_bytes}; memory_allocated {m0['allocated']}"
                         f" -> {m1['allocated']}")
    out["G1"] = {"cold_s": cold_s, "warm_s": warm_s, "planes": planes,
                 "tracked_bytes": snap["tracked_bytes"],
                 "rss_bytes": snap["rss_bytes"],
                 "arena_keys": [list(k[:3]) for k in arenas],
                 "arena_words": words, "arena_card_bytes": card_bytes,
                 "arena_host_bytes": host_bytes, "before": m0, "after": m1,
                 "devices": snap.get("devices")}
    print(f"memory G1: deserialize_array_threaded({len(data)} records, "
          f"{MAIN_CHUNKS}) cold {cold_s:.3f} s, warm {warm_s:.3f} s; the "
          f"phase decoder's {len(arenas)} arenas {words} int32 words, "
          f"{sum(host_bytes):,} pinned host bytes and {sum(card_bytes):,} "
          f"card bytes; memory_allocated {m0['allocated']:,} -> "
          f"{m1['allocated']:,} (+{m1['allocated'] - m0['allocated']:,}), "
          f"reserved {m1['reserved']:,}; planes (bytes, items) "
          + ", ".join(f"{k} {v.get('bytes'):,.0f} / {v.get('items')}"
                      for k, v in planes.items())
          + f"; tracked {snap['tracked_bytes']:,} of rss "
          f"{snap['rss_bytes']:,} "
          f"({snap['tracked_bytes'] / snap['rss_bytes'] * 100:.2f} %) "
          f"{card}")

    # G2: the phase's arenas and buckets evicted through cachelife's hooks
    managed = cachelife._caches
    fp = get_or_parse_schema(schema).fingerprint
    arena_keys = [k for k, _t, _b in managed["arenas"].entries()
                  if k[0] == id(dec)]
    exe_keys = [k for k, _t, _b in managed["executables"].entries()
                if k.startswith(fp + "|")]
    buckets = set(dec._launched)
    # an arena whose launch is still running on the card stays: its
    # ``consumed`` event recorded behind a spin kernel
    arena = dec._arenas[arena_keys[0][1]]
    done = arena.consumed
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    arena.consumed = torch.cuda.Event()
    arena.consumed.record()
    busy0 = metrics.snapshot().get("device.arena.evict_busy", 0)
    kept = not managed["arenas"].evict(arena_keys[0]) and \
        dec._arenas.get(arena_keys[0][1]) is arena
    busy = metrics.snapshot().get("device.arena.evict_busy", 0) - busy0
    torch.cuda.synchronize()
    arena.consumed = done
    if not kept or busy != 1:
        raise SystemExit(f"memory G2: an arena whose launch was running "
                         f"was evicted (kept {kept}, evict_busy {busy})")
    del arena, done
    gc.collect()  # garbage of earlier phases is not the eviction's
    blocks = block_sizes(torch, [a.dev for a in arenas.values()])
    m2 = mem_now()
    evicted_arenas = sum(managed["arenas"].evict(k) for k in arena_keys)
    evicted_buckets = sum(managed["executables"].evict(k) for k in exe_keys)
    del arenas  # the phase's own references; the decoder dropped its own
    m3 = mem_now()
    rounded = sum(round512(b) for b in card_bytes)
    drop = m2["allocated"] - m3["allocated"]
    if evicted_arenas != 2 or not evicted_buckets or dec._launched or \
            None in blocks or drop != sum(blocks):
        raise SystemExit(f"memory G2: evicted {evicted_arenas} arenas and "
                         f"{evicted_buckets} buckets (launched left "
                         f"{dec._launched}); memory_allocated fell by "
                         f"{drop:,}, not the arenas' blocks {blocks} "
                         f"(their bytes rounded to 512: {rounded:,})")
    c0 = metrics.snapshot()
    zero(pipe)
    t0 = time.perf_counter()
    got = call()
    again_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in pipe.items()}
    c1 = metrics.snapshot()
    misses = c1.get("device.jit_cache.misses", 0) - \
        c0.get("device.jit_cache.misses", 0)
    if misses < 1 or not dec._launched or min(launches.values()) < 1:
        raise SystemExit(f"memory G2: the next call counted {misses} first "
                         f"launches, launched {launches}")
    same_columns("memory G2", got, before)
    del got
    out["G2"] = {"evicted_arenas": evicted_arenas,
                 "evicted_buckets": evicted_buckets,
                 "busy_kept": kept, "allocated_drop": drop,
                 "blocks": blocks,
                 "rounded_512": rounded,
                 "before": m2, "after": m3,
                 "rss_change": m3["rss"] - m2["rss"],
                 "first_launches": misses, "launches": launches,
                 "next_call_s": again_s,
                 "buckets_before": len(buckets),
                 "buckets_after": len(dec._launched)}
    print(f"memory G2: an arena whose launch was still running on the "
          f"card was kept (device.arena.evict_busy {busy:.0f}); then "
          f"{evicted_arenas} arenas and {evicted_buckets} "
          f"buckets evicted through cachelife: memory_allocated fell by "
          f"{drop:,} bytes, the arenas' blocks {blocks} as the allocator "
          f"sized them (their bytes rounded to 512: {rounded:,}), "
          f"reserved {m2['reserved']:,} -> "
          f"{m3['reserved']:,}, RSS {m2['rss']:,} -> {m3['rss']:,} "
          f"({m3['rss'] - m2['rss']:+,}); the next call {again_s:.3f} s "
          f"counted {misses:.0f} first launches, launched {launches}, "
          f"equal to the call before {card}")
    # ... and the specialised host engines: a host call past the
    # specialiser's threshold, its engines evicted, the next call
    # re-admits the engine from its file without a g++ run
    host_want = host_call()
    hcodec = native_host_codec(get_or_parse_schema(schema))
    eng_keys = [k for k, _t, _b in managed["engines"].entries()]
    c0 = metrics.snapshot()
    evicted_engines = sum(managed["engines"].evict(k) for k in eng_keys)
    unhooked = hcodec._spec is None
    host_got = host_call()
    c1 = metrics.snapshot()
    eng_delta = {k: c1.get(k, 0) - c0.get(k, 0)
                 for k in ("specialize.evictions", "specialize.builds")}
    if not evicted_engines or not unhooked or hcodec._spec is None or \
            eng_delta["specialize.builds"] or \
            eng_delta["specialize.evictions"] != evicted_engines:
        raise SystemExit(f"memory G2: evicted {evicted_engines} engines "
                         f"(the codec unhooked: {unhooked}, re-admitted: "
                         f"{hcodec._spec is not None}), counters {eng_delta}")
    same_columns("memory G2 (host)", [host_got], [host_want])
    out["G2"]["engines"] = {"evicted": evicted_engines,
                            "counters": eng_delta,
                            "engine": hcodec._spec.__name__}
    print(f"memory G2: {evicted_engines} specialised host engines evicted "
          f"through cachelife ({eng_keys}); the next backend='host' call "
          f"re-admitted {hcodec._spec.__name__} from its file with "
          f"{eng_delta['specialize.builds']:.0f} g++ runs, equal {card}")

    # G3: pressure
    srv = obs_server.ObsServer(port=0).start()
    col = None
    tmp = tempfile.mkdtemp(prefix="pyruhvro-memory-")
    try:
        os.environ["PYRUHVRO_TPU_MEM_HIGH_WATER"] = "1"
        c0 = metrics.snapshot()
        m4 = mem_now()
        t0 = time.perf_counter()
        try:
            memacct.force_pressure_check()
        finally:
            os.environ.pop("PYRUHVRO_TPU_MEM_HIGH_WATER")
        relief_s = time.perf_counter() - t0
        m5 = mem_now()
        c1 = metrics.snapshot()
        delta = {k: c1[k] - c0.get(k, 0) for k in c1
                 if k.startswith(("mem.", "cache.evict.", "device.arena.",
                                  "device.jit_cache.", "schema_cache."))
                 and c1[k] != c0.get(k, 0)}
        code, body = http_get(srv.url + "/healthz")
        health = json.loads(body)
        evicted = {k: v for k, v in delta.items()
                   if k.startswith("cache.evict.") and k.endswith(".pressure")}
        if delta.get("mem.pressure") != 1 or not evicted or \
                not evicted.get("cache.evict.engines.pressure") or \
                delta.get("mem.allocator_release") != 1 or code != 503 or \
                not health["unhealthy_bits"]["mem_pressure"]:
            raise SystemExit(f"memory G3: counters {delta}, /healthz {code} "
                             f"{health.get('unhealthy_bits')}")
        zero(pipe)
        t0 = time.perf_counter()
        got = call()
        again3_s = time.perf_counter() - t0
        launches3 = launched("memory G3", pipe)
        same_columns("memory G3", got, before)
        del got, before
        # the relief dropped the schema entry and its host codec too: a
        # fresh codec loads the engine from its file, no g++ run
        b0 = metrics.snapshot().get("specialize.builds", 0)
        same_columns("memory G3 (host)", [host_call()], [host_want])
        hcodec = native_host_codec(get_or_parse_schema(schema))
        builds3 = metrics.snapshot().get("specialize.builds", 0) - b0
        if hcodec._spec is None or builds3:
            raise SystemExit(f"memory G3: the host engine after the relief "
                             f"{hcodec._spec}, {builds3} g++ runs")
        out["G3"] = {"counters": delta, "before": m4, "after": m5,
                     "rss_change": m5["rss"] - m4["rss"],
                     "allocated_change": m5["allocated"] - m4["allocated"],
                     "reserved_change": m5["reserved"] - m4["reserved"],
                     "relief_s": relief_s, "healthz": code,
                     "next_call_s": again3_s, "launches": launches3,
                     "host_engine": hcodec._spec.__name__,
                     "host_builds": builds3}
        print(f"memory G3: PYRUHVRO_TPU_MEM_HIGH_WATER=1, one pressure pass "
              f"in {relief_s:.3f} s evicted {evicted}; RSS {m4['rss']:,} -> "
              f"{m5['rss']:,} ({m5['rss'] - m4['rss']:+,}), "
              f"memory_allocated {m4['allocated']:,} -> "
              f"{m5['allocated']:,}, reserved {m4['reserved']:,} -> "
              f"{m5['reserved']:,}; /healthz 503 with mem_pressure; the "
              f"next call {again3_s:.3f} s launched {launches3}, equal; a "
              f"host call re-admitted {hcodec._spec.__name__} with "
              f"{builds3:.0f} g++ runs, equal {card}")

        # G4 and G5: three tenants' card calls, exported over OTLP
        reqs = []

        class Stub(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                reqs.append((self.path, json.loads(self.rfile.read(n))))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        col = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
        threading.Thread(target=col.serve_forever, daemon=True).start()
        otel.start(f"http://127.0.0.1:{col.server_address[1]}",
                   interval_s=3600)
        rows = data[:MEMORY_ROWS]
        zero(pipe)
        zero(enc)
        t0 = time.perf_counter()
        for tenant in MEMORY_TENANTS:
            batches = call(rows, tenant=tenant, trace_ctx=MEMORY_TP)
            arrays = api.serialize_record_batch(
                pa.Table.from_batches(batches), schema, MAIN_CHUNKS,
                tenant=tenant, trace_ctx=MEMORY_TP)
            if [d for a in arrays for d in a.to_pylist()] != list(rows):
                raise SystemExit(f"memory G4: {tenant}'s wire is not the "
                                 f"input")
        tenants_s = time.perf_counter() - t0
        launches4 = {**launched("memory G4", pipe),
                     **launched("memory G4", enc)}
        sketch = {r["tenant"]: r for r in memacct.tenant_hotlist()
                  if r["schema"] == fp}
        roots = [s.to_dict() for s in
                 list(telemetry._spans)[-2 * len(MEMORY_TENANTS):]]
        span_tenants = [s["attrs"].get("tenant") for s in roots]
        bad = [t for t in MEMORY_TENANTS
               if sketch.get(t, {}).get("calls") != 2
               or sketch[t].get("decode_calls") != 1
               or sketch[t].get("encode_calls") != 1
               or sketch[t].get("rows") != 2 * len(rows)]
        if bad or span_tenants != [t for t in MEMORY_TENANTS
                                   for _ in range(2)]:
            raise SystemExit(f"memory G4: sketch {sketch}, the root spans' "
                             f"tenants {span_tenants}")
        ttl = memacct._COLLECT_TTL_S
        memacct._COLLECT_TTL_S = 1e9  # one probe walk serves both reads
        try:
            mem = json.loads(json.dumps(memacct.snapshot_memory()))
            code, body = http_get(srv.url + "/memory")
            scraped = json.loads(body)
            mem2 = json.loads(json.dumps(memacct.snapshot_memory()))
        finally:
            memacct._COLLECT_TTL_S = ttl
        peaks = (mem.pop("peak_rss_bytes"), scraped.pop("peak_rss_bytes"),
                 mem2.pop("peak_rss_bytes"))
        if code != 200 or scraped != mem or mem2 != mem or \
                not peaks[0] <= peaks[1] <= peaks[2]:
            raise SystemExit(f"memory G4: /memory {code} differs from "
                             f"snapshot_memory() on the same state")
        saved = telemetry.snapshot()
        path = os.path.join(tmp, "snapshot.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(saved, f, default=str)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = telemetry.main(["mem-report", path])
        report = text.getvalue()
        if rc != 0 or not all(t in report for t in MEMORY_TENANTS) or \
                "cache.arenas" not in report:
            raise SystemExit(f"memory G4: mem-report exit {rc}:\n{report}")
        out["G4"] = {"sketch": sketch, "calls_s": tenants_s,
                     "launches": launches4, "memory_endpoint": code,
                     "report_lines": len(report.splitlines())}
        print(f"memory G4: {len(MEMORY_TENANTS)} tenants, each a decode "
              f"and an encode of {len(rows)} records on the card in "
              f"{tenants_s:.3f} s (launches {launches4}): the sketch's rows "
              + ", ".join(f"{t} {sketch[t]['calls']} calls / "
                          f"{sketch[t]['rows']} rows / "
                          f"{sketch[t]['bytes']:,} B"
                          for t in MEMORY_TENANTS)
              + f"; tenant on each root span; /memory equal to "
              f"snapshot_memory(); mem-report ({len(report.splitlines())} "
              f"lines) names them")
        print(report.rstrip())

        otel.stop()  # the final flush
        spans = [s for p_, b in reqs if p_.endswith("/v1/traces")
                 for rs in b["resourceSpans"] for ss in rs["scopeSpans"]
                 for s in ss["spans"]]
        mets = {m["name"]: m for p_, b in reqs if p_.endswith("/v1/metrics")
                for rm in b["resourceMetrics"] for sm in rm["scopeMetrics"]
                for m in sm["metrics"]}
        trace_id = MEMORY_TP.split("-")[1]
        names = sorted({s["name"] for s in spans})
        launch = mets.get("device.launch_s", {}).get("histogram", {}).get(
            "dataPoints", [{}])[0]
        exemplars = launch.get("exemplars") or []
        kernel_attrs = sorted({a["key"] for s in spans
                               if s["name"].startswith("device.")
                               for a in s["attributes"]})
        if not spans or {s["traceId"] for s in spans} != {trace_id} or \
                "device.launch_s" not in names or not exemplars or \
                len(exemplars[0].get("traceId", "")) != 32 or \
                not {"walk_s", "finalize_s", "bytes"} <= set(kernel_attrs):
            raise SystemExit(f"memory G5: {len(spans)} spans under "
                             f"{sorted({s['traceId'] for s in spans})}, "
                             f"names {names}, kernel attributes "
                             f"{kernel_attrs}, exemplars {exemplars}")
        c = metrics.snapshot()
        out["G5"] = {"spans": len(spans), "names": names,
                     "kernel_attrs": kernel_attrs,
                     "exemplar": exemplars[0],
                     "posts": len(reqs),
                     "exported": c.get("otlp.spans_exported")}
        print(f"memory G5: OTLP to a collector stub: {len(spans)} spans "
              f"({', '.join(names)}) in {len(reqs)} POSTs, every one under "
              f"trace {trace_id}; launch spans carry {kernel_attrs}; "
              f"device.launch_s's exemplar {exemplars[0]}")

        # G6: the fleet merge of the live snapshot and a saved copy
        live = fleet.fetch_snapshot(f"{srv.host}:{srv.port}")
        copy_path = os.path.join(tmp, "live.json")
        with open(copy_path, "w", encoding="utf-8") as f:
            json.dump(live, f)
        with open(copy_path, encoding="utf-8") as f:
            saved_copy = json.load(f)
        merged = fleet.merge_snapshots([live, saved_copy], ["live", "copy"])
        off = {k: (v, merged["counters"].get(k)) for k, v in
               live["counters"].items() if merged["counters"].get(k) != 2 * v}
        last = json.loads(json.dumps(telemetry.snapshot(), default=str))
        d = fleet.diff_snapshots(first, last)
        named = set(d["counters"]["new"]) | {
            row[0] for row in d["counters"]["changed"]}
        want = {"mem.pressure", "cache.evict.arenas.pressure",
                "device.jit_cache.evictions", "device.arena.evictions",
                "otlp.spans_exported", "mem.allocator_release"}
        diff_text = fleet.render_diff(first, last)
        if off or set(merged["counters"]) != set(live["counters"]) or \
                not want <= named or "mem.pressure" not in diff_text:
            raise SystemExit(f"memory G6: counters not doubled {off}; the "
                             f"diff misses {want - named}")
        out["G6"] = {"counters": len(live["counters"]),
                     "tenants_merged": len(merged["memory"].get(
                         "tenants", [])),
                     "diff_new": len(d["counters"]["new"]),
                     "diff_changed": len(d["counters"]["changed"])}
        print(f"memory G6: the obs server's live snapshot merged with a "
              f"saved copy: all {len(live['counters'])} counters exactly "
              f"twice; the diff of the phase's first and last snapshot "
              f"names {len(d['counters']['new'])} new and "
              f"{len(d['counters']['changed'])} changed counters, "
              f"{sorted(want)} among them")
    finally:
        otel.stop()
        srv.stop()
        if col is not None:
            col.shutdown()
            col.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


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


def host_pack_s(t) -> float:
    """A decode's host pack, as this script has always reported it: the
    records joined (``pack_s``, the ``decode.pack_s`` phase) and packed
    into the launch's arenas (``arena_s``) or row arrays (``rows_s``)."""
    return t["pack_s"] + t.get("arena_s", 0.0) + t.get("rows_s", 0.0)


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
        meta["timings"]["pack_s"] = host_pack_s(meta["timings"])
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
        row = {key: t[key] for key in ("h2d_s", "walk_s",
                                        "finalize_s", "d2h_s", "overlap_s",
                                        "overlap_frac", "rungs", "reruns")}
        row["pack_s"] = host_pack_s(t)
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
    default_launch = variants["default"]
    queued = queued_ms(torch, lambda: wd.walk_kernel.launch(default_launch),
                       5, prepare=default_launch.reset)
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
    moved = wd.launch_bytes(int(offs[-1] - offs[0]), R, launch.output_bytes())
    read = moved - launch.output_bytes()
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
    return {"ms": kernel_ms, "kernel_ms": kernel_ms, "queued_ms": queued,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "variant_ms": variant_ms,
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


def plan_totals(plan):
    """Region id -> the item total of the finalize run just made (its
    ``#offsets``' last entry, read on the card): what
    ``decode.finalize_bytes`` reads from the blob's ``#red:sum`` on the
    decode path."""
    return {rid: int(off[-1]) for rid, off in plan.offsets.items()}


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
    totals = plan_totals(plan)
    for p, spec in zip(plan.passes, dm.finalize_spec(plan)[1]):
        rid = p["rid"]
        name = "rows" if rid == 0 else plan.prog.regions[rid]
        got = {"ms": cuda_ms(torch, lambda: fk.launch_pass(plan, p), 5),
               "bound_ms": dm.finalize_pass_bytes(spec, totals.get(
                   rid, p["n_pos"])) / HBM_BYTES_PER_S * 1e3}
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
    record_bytes = int(lengths.to(torch.int64).sum())
    walk_read = record_bytes + 8 * R
    walk_written = dm.walk_bytes(record_bytes, R, sum(
        b.numel() * b.element_size() for b in L.bufs)) - walk_read
    walk_bound = (walk_read + walk_written) / HBM_BYTES_PER_S * 1e3
    fin_moved = dm.finalize_bytes(dm.finalize_spec(plan), plan_totals(plan))
    fin_bound = fin_moved / HBM_BYTES_PER_S * 1e3
    parts = finalize_breakdown(torch, dm, plan, takes, card) \
        if breakdown else None
    # the launches the launch registry times, their host enqueue hidden:
    # the walk; the gather passes and the epilogue (the offsets made by
    # the last run are read again, the blob is not read after this)
    walk_queued = queued_ms(torch, lambda: dm.walk_kernel.launch(L), 5)
    fin_queued = queued_ms(torch, lambda: [
        dm.finalize_kernel.launch_pass(plan, p) for p in plan.passes
    ] + [dm.finalize_kernel.launch_epilogue(plan)], 5)
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
    return ({"ms": walk_ms, "queued_ms": walk_queued, "plain_ms": plain_walk_ms,
             "bound_ms": walk_bound, "library_ms": None, "shape": shape},
            {"ms": fin_ms, "queued_ms": fin_queued, "plain_ms": plain_fin_ms,
             "bound_ms": fin_bound, "library_ms": take_ms, "shape": shape,
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
    # the launches the launch registry times, their host enqueue hidden:
    # the size and write passes (not the cumsum between), the strings
    rows_queued = queued_ms(torch, lambda: (
        em.encode_kernel.launch_rows(L, False, sizes),
        em.encode_kernel.launch_rows(L, True, sizes, cum, out)), 5,
        prepare=L.clear_dst)
    strings_queued = queued_ms(
        torch, lambda: em.encode_kernel.launch_strings(L, out), 5)
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
    traffic = em.rows_traffic(L)
    if (traffic["placed"], traffic["payload"]) != (placed, payload):
        raise SystemExit(f"main path shapes: the host walk of the encode "
                         f"code placed {traffic['placed']} payloads of "
                         f"{traffic['payload']} B, the card {placed} of "
                         f"{payload} B")
    # encode_rows: the lane entries its code reaches and #off in, the
    # non-payload bytes, #dst and the row sizes out; encode_strings:
    # #src, #len and #dst of each placed payload in, its bytes in and
    # out; all of K3: the lane entries and #src in, the payload, the
    # rows' other bytes and the row sizes out (#off and #dst are its own
    # scratch)
    rows_moved, strings_moved = em.k3_bytes(traffic, total, R)
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
    return ({"ms": size_ms + write_ms, "queued_ms": rows_queued,
             "size_ms": size_ms,
             "write_ms": write_ms, "staged_blocks": spans[0],
             "direct_blocks": spans[1], "span_budget": budgets["launch"],
             "free_span_bytes": free,
             "write_ms_by_budget": write_variants, "plain_ms": rows_plain_ms,
             "bound_ms": rows_bound, "library_ms": None,
             "max_abs_err": err},
            {"ms": strings_ms, "queued_ms": strings_queued,
             "plain_ms": strings_plain_ms,
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


def cpu_line() -> str:
    """The host's CPU model (``/proc/cpuinfo``'s ``model name``; where that
    is missing or ``unknown``, its vendor, family, model and stepping and
    ``lscpu``'s model name), ``os.cpu_count()`` and the affinity set: the
    host tier's numbers depend on them."""
    import os
    import platform
    import subprocess

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = info.get("model name", "")
    if model.lower() in ("", "unknown"):
        try:
            lscpu = subprocess.run(["lscpu"], capture_output=True, text=True,
                                   timeout=10).stdout
        except (OSError, subprocess.SubprocessError):
            lscpu = ""
        names = [ln.partition(":")[2].strip() for ln in lscpu.splitlines()
                 if ln.startswith(("Model name:", "BIOS Model name:"))]
        model = (f"{info.get('vendor_id', platform.machine())} family "
                 f"{info.get('cpu family', '?')} model "
                 f"{info.get('model', '?')} stepping "
                 f"{info.get('stepping', '?')}, microcode "
                 f"{info.get('microcode', '?')}, lscpu model name "
                 f"{' / '.join(names) or '?'} (/proc/cpuinfo model name "
                 f"{info.get('model name', 'missing')!r})")
    aff = sorted(os.sched_getaffinity(0))
    return (f"{model}; os.cpu_count()={os.cpu_count()}; affinity "
            f"{len(aff)} CPUs {aff[0]}-{aff[-1]}")


def host_turns(call_host, call_card):
    """Warm calls of the host tier and the card in turns, A B B A twice."""
    times = {"host": [], "card": []}
    for leg in ["host", "card", "card", "host"] * 2:
        t0 = time.perf_counter()
        out = (call_host if leg == "host" else call_card)()
        times[leg].append(time.perf_counter() - t0)
        del out
    return times


# the host tier's lane counters (runtime/metrics.py), as the reference keys
# them: the fused decode lane and its fallback, the native extract and its
# fallback, the shard runner's calls and the fan-outs it measured
HOST_LANES = ("decode.fused", "decode.fused_fallback", "extract.native",
              "extract.fallback", "shard.native", "pool.eff_fanouts")


def lane_counts(metrics, since=None):
    """The host lane counters now, or their growth since ``since``."""
    now = metrics.snapshot()
    return {k: now.get(k, 0.0) - (since or {}).get(k, 0.0)
            for k in HOST_LANES}


def host_path(label, metrics, call_host, call_card, compare, rows, card):
    """One path on ``backend="host"``: the lane counters read before and
    after the cold call, ``WARM_CALLS`` warm calls, then warm calls in
    turns with the same call on the card, whose result must equal the
    host tier's."""
    before = lane_counts(metrics)
    t0 = time.perf_counter()
    got = call_host()
    cold = time.perf_counter() - t0
    counts = lane_counts(metrics, before)
    warm = []
    for _ in range(WARM_CALLS):
        del got
        t0 = time.perf_counter()
        got = call_host()
        warm.append(time.perf_counter() - t0)
    compare(label, got, call_card())
    del got
    turns = host_turns(call_host, call_card)
    host_med = statistics.median(turns["host"])
    card_med = statistics.median(turns["card"])
    print(f"host {label}: lanes of the cold call {counts}; cold {cold:.3f} s, "
          f"warm median of {WARM_CALLS} {statistics.median(warm):.3f} s "
          f"({min(warm):.3f} .. {max(warm):.3f}) = "
          f"{rows / statistics.median(warm):,.0f} rec/s; in turns (A B B A "
          f"twice) host median {host_med:.3f} s {[round(x, 3) for x in turns['host']]}, "
          f"card median {card_med:.3f} s {[round(x, 3) for x in turns['card']]}; "
          f"equal to the card's {card}")
    return {"lanes": counts, "cold_s": cold, "warm_s": warm,
            "turns_s": turns, "rows": rows}


def host_phase(api, data, nested, large, kafka_batch, nested_schema, card,
               units=None):
    """The native host tier (``backend="host"``, ``hostpath/``) against
    the card: H1 path 1, H2 paths 3 and 4, H3 path 5's encode, H4 the
    crossover over Kafka batch sizes, H5 P4's records on the oracle
    (``PYRUHVRO_TPU_NO_NATIVE=1``) beside the native tier, H6 path 1 on
    the specialised engine against the VM. Fails if path 1 did not take
    the fused decode lane or path 5 the native extract. ``units`` holds
    the specialised units' build of the script's build step."""
    import os

    from pyruhvro_tpu_torch.runtime import metrics
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema
    from pyruhvro_tpu_torch.utils import datagen

    kafka = datagen.KAFKA_SCHEMA_JSON
    print(f"host: {cpu_line()}")
    out = {"cpu": cpu_line()}

    def codec_of(schema):
        codec = api._native_host_codec(get_or_parse_schema(schema))
        if codec is None:
            raise SystemExit("host: backend='host' did not take the native "
                             "tier")
        return codec

    def decode_path(label, rows, schema):
        codec = codec_of(schema)
        res = host_path(
            label, metrics,
            lambda: api.deserialize_array_threaded(rows, schema, MAIN_CHUNKS,
                                                   backend="host"),
            lambda: api.deserialize_array_threaded(rows, schema, MAIN_CHUNKS),
            same_columns, len(rows), card)
        return codec, res

    # H1: path 1 on the host tier
    _c, out["h1"] = decode_path("H1 (path 1, Kafka)", data, kafka)
    lanes = out["h1"]["lanes"]
    if lanes["decode.fused"] < 1 or lanes["decode.fused_fallback"] or \
            lanes["shard.native"] != 1:
        raise SystemExit(f"H1: path 1 took the lanes {lanes}: it must decode "
                         f"through the shard runner on the fused lane")
    # H2: paths 3 and 4
    _c, out["h2_nested"] = decode_path("H2 (path 3, nested)", nested,
                                       nested_schema)
    _c, out["h2_large"] = decode_path("H2 (path 4, large records)", large,
                                      kafka)

    # H3: path 5's encode
    def wire_equal(label, got, want):
        if wire_of(got) != wire_of(want):
            raise SystemExit(f"{label}: the host encode differs from the "
                             f"card's")

    since_h3 = lane_counts(metrics)
    out["h3"] = host_path(
        "H3 (path 5, Kafka encode)", metrics,
        lambda: api.serialize_record_batch(kafka_batch, kafka, MAIN_CHUNKS,
                                           backend="host"),
        lambda: api.serialize_record_batch(kafka_batch, kafka, MAIN_CHUNKS),
        wire_equal, kafka_batch.num_rows, card)
    lanes = out["h3"]["lanes"]
    if lanes["extract.native"] < 1 or lanes["extract.fallback"]:
        raise SystemExit(f"H3: path 5's encode took the lanes {lanes}: it "
                         f"must take the native extract")
    if wire_of(api.serialize_record_batch(kafka_batch, kafka, MAIN_CHUNKS,
                                          backend="host")) != data:
        raise SystemExit("H3: the host encode differs from the input datums")

    # H4: the crossover, card against host over Kafka batch sizes
    h4 = {}
    for n in (1_000, 10_000, 100_000, 1_000_000):
        rows = data[:n]
        host_call = (lambda r=rows: api.deserialize_array_threaded(
            r, kafka, MAIN_CHUNKS, backend="host"))
        card_call = (lambda r=rows: api.deserialize_array_threaded(
            r, kafka, MAIN_CHUNKS))
        same_columns(f"H4 {n}", host_call(), card_call())
        turns = host_turns(host_call, card_call)
        h4[n] = {k: statistics.median(v) for k, v in turns.items()}
        h4[n]["turns_s"] = turns
        print(f"host H4: {n} Kafka records, warm medians in turns: host "
              f"{h4[n]['host'] * 1e3:.2f} ms, card {h4[n]['card'] * 1e3:.2f} "
              f"ms ({'card' if h4[n]['card'] < h4[n]['host'] else 'host'} "
              f"faster) {card}")
    wins = [n for n in h4 if h4[n]["card"] < h4[n]["host"]]
    out["h4"] = {str(n): v for n, v in h4.items()}
    out["h4_card_wins_from"] = min(wins) if wins else None
    print(f"host H4: the card wins from {out['h4_card_wins_from']} records "
          f"(None: at no size measured) {card}")

    # H5: P4's records on the oracle beside the native tier
    sub = data[:POLICY_HOST_ROWS]
    sub_batch = api.deserialize_array(sub, kafka)
    h5 = {}
    for tier in ("native", "oracle"):
        if tier == "oracle":
            os.environ["PYRUHVRO_TPU_NO_NATIVE"] = "1"
        dec, enc = [], []
        for _ in range(1 + WARM_CALLS):
            t0 = time.perf_counter()
            got = api.deserialize_array_threaded(sub, kafka, MAIN_CHUNKS,
                                                 backend="host")
            dec.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            arrays = api.serialize_record_batch(sub_batch, kafka,
                                                MAIN_CHUNKS, backend="host")
            enc.append(time.perf_counter() - t0)
        os.environ.pop("PYRUHVRO_TPU_NO_NATIVE", None)
        same_columns(f"H5 {tier}", got, api.deserialize_array_threaded(
            sub, kafka, MAIN_CHUNKS))
        if wire_of(arrays) != sub:
            raise SystemExit(f"H5 {tier}: the encode differs from the input")
        h5[tier] = {"decode_cold_s": dec[0], "decode_warm_s": dec[1:],
                    "encode_cold_s": enc[0], "encode_warm_s": enc[1:]}
        print(f"host H5 ({tier}): {len(sub)} records, decode cold "
              f"{dec[0]:.4f} s, warm median {statistics.median(dec[1:]):.4f} "
              f"s; encode cold {enc[0]:.4f} s, warm median "
              f"{statistics.median(enc[1:]):.4f} s; equal to the card's and "
              f"to the input datums {card}")
    out["h5"] = h5
    out["h6"] = host_h6(api, metrics, codec_of, data, kafka_batch, kafka,
                        units or {}, card)
    print(f"host lane counters (since H3): "
          f"{lane_counts(metrics, since_h3)}")
    return out


def host_h6(api, metrics, codec_of, data, kafka_batch, kafka, units, card):
    """H6: path 1's records on ``backend="host"`` through the specialised
    engine and through the VM (a codec built under
    ``PYRUHVRO_TPU_NO_SPECIALIZE=1``), each under a schema string of its
    own: decode and encode equal, then warm calls in turns (A B B A
    twice); the Kafka unit's ``g++`` seconds from the build step."""
    import os

    schemas = {arm: json.dumps(dict(json.loads(kafka), doc=f"H6 {arm}"))
               for arm in ("spec", "vm")}
    os.environ["PYRUHVRO_TPU_NO_SPECIALIZE"] = "1"
    try:
        vm_codec = codec_of(schemas["vm"])
    finally:
        os.environ.pop("PYRUHVRO_TPU_NO_SPECIALIZE")
    spec_codec = codec_of(schemas["spec"])
    builds0 = metrics.snapshot().get("specialize.builds", 0)

    def dec(arm):
        return lambda: api.deserialize_array_threaded(
            data, schemas[arm], MAIN_CHUNKS, backend="host")

    def enc(arm):
        return lambda: api.serialize_record_batch(
            kafka_batch, schemas[arm], MAIN_CHUNKS, backend="host")

    t0 = time.perf_counter()
    got = dec("spec")()
    cold_s = time.perf_counter() - t0
    if spec_codec._spec is None or vm_codec._spec is not None:
        raise SystemExit(f"host H6: engines {spec_codec._spec} (specialised "
                         f"arm) and {vm_codec._spec} (VM arm)")
    same_columns("host H6", got, dec("vm")())
    del got
    spec_wire = wire_of(enc("spec")())
    if spec_wire != wire_of(enc("vm")()) or spec_wire != data:
        raise SystemExit("host H6: the specialised encode differs from the "
                         "VM's or from the input datums")
    del spec_wire
    dec_turns = turns_of(dec("spec"), dec("vm"), ("spec", "vm"))
    enc_turns = turns_of(enc("spec"), enc("vm"), ("spec", "vm"))
    builds = metrics.snapshot().get("specialize.builds", 0) - builds0
    out = {"cold_s": cold_s, "decode_turns_s": dec_turns,
           "encode_turns_s": enc_turns, "units": units,
           "builds_in_h6": builds, "engine": spec_codec._spec.__name__}
    med = {k: {arm: statistics.median(v[arm]) for arm in v}
           for k, v in (("decode", dec_turns), ("encode", enc_turns))}
    print(f"host H6: path 1 on the specialised engine {out['engine']} "
          f"against the VM, equal decode and encode (the input datums); "
          f"the specialised arm's first call {cold_s:.3f} s ({builds:.0f} "
          f"g++ runs); warm medians in turns (A B B A twice): decode "
          f"specialised {med['decode']['spec']:.3f} s "
          f"{[round(x, 3) for x in dec_turns['spec']]}, VM "
          f"{med['decode']['vm']:.3f} s "
          f"{[round(x, 3) for x in dec_turns['vm']]}; encode specialised "
          f"{med['encode']['spec']:.3f} s "
          f"{[round(x, 3) for x in enc_turns['spec']]}, VM "
          f"{med['encode']['vm']:.3f} s "
          f"{[round(x, 3) for x in enc_turns['vm']]}; units built in the "
          f"build step {units} {card}")
    return out


# the kernels the launch registry times (runtime/device_obs.py), by kind
TELEMETRY_KERNELS = ("walk", "finalize", "walk_decode", "encode_rows",
                     "encode_strings")
# the Prometheus text exposition, line by line
PROM_META = re.compile(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+$")
PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+=\"[^\"]*\"\})? "
    r"(\S+)( # \{trace_id=\"[0-9a-f]{32}\"\} \S+)?$")


def on_off_turns(telemetry, call):
    """Warm calls with telemetry on and off in turns, A B B A twice."""
    times = {"on": [], "off": []}
    try:
        for leg in ["on", "off", "off", "on"] * 2:
            telemetry.set_enabled(leg == "on")
            t0 = time.perf_counter()
            out = call()
            times[leg].append(time.perf_counter() - t0)
            del out
    finally:
        telemetry.set_enabled(True)
    return times


def registry_by_kernel(snap):
    """The launch registry of a snapshot summed per kernel kind: launches,
    seconds and bytes of the launches after each bucket's first."""
    out = {}
    for e in ((snap.get("device") or {}).get("jit_cache") or {}).values():
        k = out.setdefault(e["kind"], {"launches": 0, "launch_s": 0.0,
                                       "bytes": 0, "compiles": 0})
        k["launches"] += e["launches"]
        k["launch_s"] += e["launch_s"]
        k["bytes"] += e["bytes"]
        k["compiles"] += e["compiles"]
    return out


# the device kernels of each registry kind, by name in a profiler trace
TRACE_KERNELS = {"walk": ("decode_walk_kernel",),
                 "finalize": ("finalize_pass_kernel",
                              "finalize_epilogue_kernel"),
                 "walk_decode": ("walk_decode_kernel",),
                 "encode_rows": ("encode_rows_kernel",),
                 "encode_strings": ("encode_strings_kernel",)}


def traced_kernels(torch, call):
    """One call under ``torch.profiler`` with CUDA activity: the trace's
    device kernels in start order as ``(name, start us, device us)``
    (copies and memsets left out)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = call()
        torch.cuda.synchronize()
    del out
    ks = [(e.name, e.time_range.start, e.time_range.elapsed_us())
          for e in prof.events()
          if "cuda" in str(getattr(e, "device_type", "")).lower()
          and not e.name.startswith(("Memcpy", "Memset"))]
    if not ks:
        raise SystemExit("T2: the profiler's trace holds no device kernel")
    return sorted(ks, key=lambda k: k[1])


def trace_us_by_kind(ks):
    """Device us per registry kind in a trace: the kernels each kind
    times, by name (K2's gather passes and epilogue, not the library's
    cumsums and fills between them)."""
    return {kind: sum(us for name, _start, us in ks
                      if any(key in name for key in keys))
            for kind, keys in TRACE_KERNELS.items()}


def prom_lines_parse(text: str) -> int:
    """Every line of a Prometheus text exposition parses (a HELP or TYPE
    line, or a sample whose value is a float); the sample count."""
    samples = 0
    for line in text.splitlines():
        if PROM_META.match(line):
            continue
        m = PROM_SAMPLE.match(line)
        if m is None:
            raise SystemExit(f"T4: Prometheus line does not parse: {line!r}")
        float(m.group(2))
        samples += 1
    return samples


def telemetry_phase(api, torch, telemetry, traceprop, dm, em, data,
                    schema, kernel_ms, here, card):
    """The observability base on the card: T1 path 1's, P1's and path
    5's warm calls with telemetry on and off in turns; T2 path 1's snapshot
    (``render_report``), each kernel kind's ``device.launch_s`` per launch
    beside this script's own CUDA-event time of the same launches at the
    same shapes (``kernel_ms[kind]``: ``queued``, their host enqueue
    hidden by :func:`queued_ms`, and ``idle``, the kernels line's
    :func:`cuda_ms` on an idle stream) and, for one more call under
    ``torch.profiler``, beside the trace's kernel time per launch
    (:func:`trace_us_by_kind`), its bytes
    over its seconds beside the card's rate, and the root span beside the
    call's wall time; T3 a call with
    ``trace_ctx``: the root span and P1's quarantine entries carry its
    trace id; T4 the memory watermark beside
    ``torch.cuda.max_memory_allocated``, the Prometheus text line by line,
    the Perfetto JSON and the CLI's report of a saved snapshot. Fails on
    any check; the times are reported, not judged."""
    import os
    import subprocess

    out = {}
    poisoned, bad = poison(data, POLICY_EVERY)

    def path1():
        return api.deserialize_array_threaded(data, schema, MAIN_CHUNKS)

    def p1():
        return api.deserialize_array_threaded(
            poisoned, schema, MAIN_CHUNKS, on_error="skip")

    batch5 = api.deserialize_array(data, schema)

    def path5():
        return api.serialize_record_batch(batch5, schema, MAIN_CHUNKS)

    # T1: on and off in turns
    for label, call in (("path 1", path1), ("P1", p1), ("path 5", path5)):
        call()
        turns = on_off_turns(telemetry, call)
        on, off = (statistics.median(turns[k]) for k in ("on", "off"))
        spread_on = max(turns["on"]) - min(turns["on"])
        spread_off = max(turns["off"]) - min(turns["off"])
        out["t1_" + label.replace(" ", "")] = {
            "turns_s": turns, "on_s": on, "off_s": off,
            "diff_s": on - off, "diff_pct": (on - off) / off * 100,
            "spread_on_s": spread_on, "spread_off_s": spread_off}
        print(f"telemetry T1 {label}: warm calls in turns (A B B A twice), "
              f"telemetry on median {on:.4f} s {[round(x, 4) for x in turns['on']]}"
              f", off median {off:.4f} s "
              f"{[round(x, 4) for x in turns['off']]}; on - off "
              f"{on - off:+.4f} s ({(on - off) / off * 100:+.2f} %); spread "
              f"of the legs on {spread_on:.4f} s, off {spread_off:.4f} s "
              f"{card}")

    # T2: path 1's snapshot and the launch registry per kernel kind
    from pyruhvro_tpu_torch.runtime import device_obs

    telemetry.reset()
    walk0 = dm.walk_kernel.launches
    for _ in range(2):
        path1()
    t0 = time.perf_counter()
    path1()
    wall = time.perf_counter() - t0
    walks = dm.walk_kernel.launches - walk0
    snap1 = telemetry.snapshot()
    print("telemetry T2: path 1's snapshot after 3 warm calls, "
          "render_report:")
    print(telemetry.render_report(snap1), end="")
    root = snap1["spans"][-1]
    if root["name"] != "api.deserialize_array_threaded" or \
            root["attrs"].get("route") != "device":
        raise SystemExit(f"T2: the last root span is {root['name']} "
                         f"{root['attrs']}")
    pending = [c for p in root.get("children", [])
               for c in p.get("children", [])
               if c["name"] in ("device.launch_s", "device.compile_s")
               and c["dur_s"] is None]
    if pending or snap1["counters"].get("device.launch_unresolved"):
        raise SystemExit(f"T2: {len(pending)} launch spans of the last call "
                         f"unresolved")
    per_kind, traced = {}, {}

    def keep(snap, kinds, call):
        """The registry of 3 warm calls per kind, then one more call
        under the profiler: its registry beside its trace."""
        got = registry_by_kernel(snap)
        per_kind.update({k: got[k] for k in kinds if k in got})
        telemetry.reset()
        ks = traced_kernels(torch, call)
        reg = registry_by_kernel(telemetry.snapshot())
        us = trace_us_by_kind(ks)
        for k in kinds:
            traced[k] = {"registry": reg.get(k), "trace_us": us[k]}

    keep(snap1, ("walk", "finalize"), path1)
    # path 2's engine (K4), then path 5's encode (K3), each alone; K3's
    # bytes need the walk over the batch's lanes, counted only on request
    telemetry.reset()
    os.environ["PYRUHVRO_TPU_PALLAS"] = "1"
    try:
        for _ in range(3):
            path1()
        keep(telemetry.snapshot(), ("walk_decode",), path1)
    finally:
        os.environ.pop("PYRUHVRO_TPU_PALLAS", None)
    telemetry.reset()
    device_obs.count_walked_bytes(True)
    try:
        for _ in range(3):
            path5()
        keep(telemetry.snapshot(), ("encode_rows", "encode_strings"), path5)
    finally:
        device_obs.count_walked_bytes(False)
    del batch5
    if per_kind.get("walk", {}).get("launches") != walks or not walks:
        raise SystemExit(f"T2: decode_walk launched {walks} times over 3 "
                         f"warm calls, the registry counted "
                         f"{per_kind.get('walk')}")
    kinds = {}
    for kind in TELEMETRY_KERNELS:
        k = per_kind.get(kind)
        if not k or not k["launches"] or not k["bytes"]:
            raise SystemExit(f"T2: no timed launch with bytes of {kind}: "
                             f"{k}")
        t = traced[kind]
        t_reg = t["registry"] or {}
        if not t_reg.get("launches") or not t["trace_us"]:
            raise SystemExit(f"T2: the traced call of {kind}: registry "
                             f"{t_reg}, trace {t['trace_us']} us")
        ms = k["launch_s"] / k["launches"] * 1e3
        trace_ms = t["trace_us"] / t_reg["launches"] / 1e3
        traced_reg_ms = t_reg["launch_s"] / t_reg["launches"] * 1e3
        rate = k["bytes"] / k["launch_s"]
        queued, idle = kernel_ms[kind]["queued"], kernel_ms[kind]["idle"]
        kinds[kind] = {**k, "launch_ms": ms, "smoke_ms": queued,
                       "ratio": ms / queued, "idle_ms": idle,
                       "trace_ms": trace_ms, "traced_launch_ms": traced_reg_ms,
                       "ratio_trace": traced_reg_ms / trace_ms,
                       "bytes_per_s": rate, "of_hbm": rate / HBM_BYTES_PER_S}
        print(f"telemetry T2 {kind}: device.launch_s {ms:.4f} ms per launch "
              f"over {k['launches']} launches, this script's CUDA-event time "
              f"of the same launches at the same shapes, their host enqueue "
              f"hidden, {queued:.4f} ms, ratio {ms / queued:.3f} (on an idle "
              f"stream {idle:.4f} ms); a call under torch.profiler: "
              f"device.launch_s {traced_reg_ms:.4f} ms per launch, the "
              f"trace's kernels {trace_ms:.4f} ms per launch, ratio "
              f"{traced_reg_ms / trace_ms:.3f}; device.cost.bytes_accessed / "
              f"device.launch_s = {rate / 1e9:.1f} GB/s, "
              f"{rate / HBM_BYTES_PER_S * 100:.1f} % of 3.35 TB/s {card}")
    out["t2"] = {"kinds": kinds, "root_s": root["dur_s"], "wall_s": wall,
                 "walk_launches": walks}
    print(f"telemetry T2: the root span {root['dur_s']:.4f} s, the call's "
          f"wall time {wall:.4f} s {card}")

    # T3: trace_ctx
    trace_id, parent = "ab" * 16, "cd" * 8
    tp = f"00-{trace_id}-{parent}-01"
    telemetry.reset()
    path1_tp = api.deserialize_array_threaded(data, schema, MAIN_CHUNKS,
                                              trace_ctx=tp)
    del path1_tp
    root = telemetry.snapshot()["spans"][-1]
    if (root.get("trace_id"), root.get("parent_span_id")) != \
            (trace_id, parent):
        raise SystemExit(f"T3: the root span's trace {root.get('trace_id')}"
                         f" / {root.get('parent_span_id')}, not {tp}")
    ctx = traceprop.TraceContext("ef" * 16, "01" * 8)
    _got, quar = api.deserialize_array_threaded(
        poisoned, schema, MAIN_CHUNKS, on_error="skip", return_errors=True,
        trace_ctx=ctx)
    ids = {q.trace_id for q in quar}
    if len(quar) != len(bad) or ids != {ctx.trace_id}:
        raise SystemExit(f"T3: {len(quar)} quarantine entries with trace ids"
                         f" {sorted(ids, key=str)[:3]}")
    out["t3"] = {"trace_id": trace_id, "entries": len(quar)}
    print(f"telemetry T3: trace_ctx={tp!r} joined by the root span; P1's "
          f"{len(quar)} quarantine entries all carry {ctx.trace_id} {card}")
    del _got, quar

    # T4: memory, Prometheus, Perfetto, the CLI
    telemetry.reset()
    path1()
    snap = telemetry.snapshot()
    peak_torch = torch.cuda.max_memory_allocated(0)
    mem = (snap.get("device") or {}).get("memory") or {}
    rec = mem.get("cuda:0") or {}
    peak = rec.get("peak_bytes_in_use", 0)
    if not peak or peak > peak_torch:
        raise SystemExit(f"T4: note_memory {mem}, "
                         f"max_memory_allocated {peak_torch}")
    samples = prom_lines_parse(telemetry.prometheus(snap))
    prom_ex = prom_lines_parse(telemetry.prometheus(snap, exemplars=True))
    doc = json.loads(json.dumps(telemetry.perfetto_trace(snap)))
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    if not events or any(e["dur"] < 0 for e in events):
        raise SystemExit(f"T4: Perfetto trace of {len(events)} events")
    saved = here / "build" / "telemetry_snapshot.json"
    saved.parent.mkdir(exist_ok=True)
    saved.write_text(json.dumps(snap))
    report = subprocess.run(
        [sys.executable, "-m", "pyruhvro_tpu_torch.telemetry", "report",
         str(saved)], cwd=here, capture_output=True, text=True)
    if report.returncode or "== phase breakdown ==" not in report.stdout:
        raise SystemExit(f"T4: the telemetry CLI exited {report.returncode}"
                         f": {report.stderr[-2000:]}")
    out["t4"] = {"peak_bytes_in_use": peak, "max_memory_allocated":
                 peak_torch, "bytes_limit": rec.get("bytes_limit"),
                 "prom_samples": samples, "perfetto_events": len(events)}
    print(f"telemetry T4: note_memory peak {peak / 1e9:.3f} GB (in use "
          f"{rec.get('bytes_in_use', 0) / 1e9:.3f} GB of "
          f"{rec.get('bytes_limit', 0) / 1e9:.1f} GB), "
          f"torch.cuda.max_memory_allocated {peak_torch / 1e9:.3f} GB; "
          f"Prometheus text: {samples} samples, every line parses ({prom_ex}"
          f" with exemplars); Perfetto JSON: {len(events)} events; the CLI's "
          f"report of the saved snapshot ({saved.name}) ran {card}")
    return out


# R3's trace context: the workers' spans must join it
ROUTE_TP = "00-" + "7e" * 16 + "-" + "c3" * 8 + "-01"
# R2: every second autotuned call explores (the least-observed arm)
ROUTE_EXPLORE = "0.5"
ROUTE_CALLS = 6             # R2: autotuned calls per row band
ROUTE_TURNS = 1             # R3: rounds of A B B A (one: the time limit)
# R3's P1 on the host tier: its first records (1,000 poisoned). The native
# tier's tolerant path decodes a chunk's tail again after each bad row, so
# the whole P1 takes about 110 s a call on the shard arm (this phase with
# ROUTE_P1_ROWS = 1,000,000 on an H100 machine; PERF.md §5)
ROUTE_P1_ROWS = 100_000

# R4's child: warm the card and the kernel libraries, then time the first
# device call of each dataset file (paths 1 and 4) in a fresh process
ROUTE_CHILD = r"""
import json, sys, time
import pyarrow as pa
import torch
sys.path.insert(0, sys.argv[1])
from pyruhvro_tpu_torch import deserialize_array_threaded
from pyruhvro_tpu_torch.ops import decode as dm
from pyruhvro_tpu_torch.runtime import capacity, costmodel, metrics, native
from pyruhvro_tpu_torch.utils import datagen
dev, chunks = sys.argv[2], int(sys.argv[3])
if dev == "cuda":
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    dm.walk_kernel.library()
    dm.finalize_kernel.library()
native.load("packer")
out = {"loaded_plans": len(capacity.entries())}
for label, path in zip(sys.argv[4::2], sys.argv[5::2]):
    with pa.ipc.open_file(path) as f:
        rows = f.read_all().column(0).combine_chunks().to_pylist()
    dm.walk_kernel.launches = dm.finalize_kernel.launches = 0
    before = metrics.snapshot()
    t0 = time.perf_counter()
    deserialize_array_threaded(rows, datagen.KAFKA_SCHEMA_JSON, chunks,
                               device=dev)
    cold = time.perf_counter() - t0
    now = metrics.snapshot()
    out[label] = {"cold_s": cold, "decode_walk": dm.walk_kernel.launches,
                  "decode_finalize": dm.finalize_kernel.launches, **{
                      k.split(".")[-1]: now.get(k, 0) - before.get(k, 0)
                      for k in ("device.capacity.plan_hits",
                                "device.capacity.plan_misses",
                                "device.retries", "device.seed_s")}}
print(json.dumps(out))
"""


def turns_of(call_a, call_b, labels, rounds: int = 2):
    """Warm calls of two arms in turns, A B B A ``rounds`` times."""
    times = {k: [] for k in labels}
    for leg in [labels[0], labels[1], labels[1], labels[0]] * rounds:
        t0 = time.perf_counter()
        out = (call_a if leg == labels[0] else call_b)()
        times[leg].append(time.perf_counter() - t0)
        del out
    return times


def smi_compute_pids():
    """The pids ``nvidia-smi`` lists as holding a compute context."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return sorted(int(x) for x in out.stdout.split() if x.strip().isdigit())


def route_child(here, env, files, card_dev):
    """One R4 child (:data:`ROUTE_CHILD`) → its JSON line."""
    args = [sys.executable, "-c", ROUTE_CHILD, str(here), card_dev,
            str(MAIN_CHUNKS)]
    for label, path in files:
        args += [label, str(path)]
    proc = subprocess.run(args, cwd=str(here), env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"route R4: the child failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def route_phase(api, pa, dm, em, data, schema, kafka_batch, large,
                warm_launches, here, card):
    """The routing plane on the card. R1 ``backend="auto"`` on path 1 and
    path 5: the static verdict ``device_selected``, the kernels launched
    as on the device path's warm call (K1 and K2 per chunk, K3), the
    batches equal to ``backend="device"``'s, the ledger entry's predicted
    and observed seconds. R3 ``PYRUHVRO_TPU_POOL=process`` with
    ``backend="host"`` on path 1 and on P1's first ``ROUTE_P1_ROWS``
    records: the cold call (spawning workers that import torch) and warm calls in turns with the shard arm, the
    batches, quarantine entries and ``MalformedAvro``'s index equal to the
    shard arm's, one ``pool.worker`` span per chunk under the caller's
    trace id, and no worker in ``nvidia-smi``'s compute apps. R2
    ``PYRUHVRO_TPU_AUTOTUNE=1`` (every second call exploring, the profile
    in a temporary directory) on Kafka batches of 10k, 100k and 1M rows:
    each arm's predicted and observed seconds, the arm the model settles
    on, ``router.override``; every result equal to the device call's. R4
    ``PYRUHVRO_TPU_CAPACITY_PERSIST=1`` in a fresh child that decodes
    paths 1 and 4 and exits, then a second fresh child: the first device
    call's launches, planner counts and cold seconds without and with the
    profile. R5 a batch whose item counts pass ``_MAX_ITEM_CAP``: the
    oracle's batch under ``"auto"`` (the host answer),
    ``DeviceCapacityExceeded`` under ``"device"``. Fails on any check."""
    import os
    import shutil

    from pyruhvro_tpu_torch import DeviceCapacityExceeded, MalformedAvro
    from pyruhvro_tpu_torch.fallback.decoder import (compile_reader,
                                                     decode_to_record_batch)
    from pyruhvro_tpu_torch.runtime import (costmodel, metrics, pool,
                                            router, telemetry)
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema

    out = {}
    card_dev = DEVICE
    pipe = {"decode_walk": dm.walk_kernel,
            "decode_finalize": dm.finalize_kernel}
    enc = {"encode_rows": em.encode_kernel.rows,
           "encode_strings": em.encode_kernel.strings}
    tmp = here / "build" / "route_phase"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)

    def ledger_check(label, reason):
        e = router.last_entry()
        if e is None or e["reason"] != reason or e["tier"] != "device" or \
                e["observed_s"] is None or e["predicted_s"] is None:
            raise SystemExit(f"route {label}: ledger entry {e}: must be the "
                             f"device tier by {reason} with predicted and "
                             f"observed seconds")
        return e

    # R1: backend="auto" keeps path 1 and path 5 on the card
    telemetry.reset()
    want = api.deserialize_array_threaded(data, schema, MAIN_CHUNKS)
    zero(pipe)
    got = api.deserialize_array_threaded(data, schema, MAIN_CHUNKS,
                                         backend="auto")
    counts = launched("route R1 (path 1, auto)", pipe)
    if counts != {k: int(v) for k, v in warm_launches.items()}:
        raise SystemExit(f"route R1: backend='auto' launched {counts} on "
                         f"path 1, the device path's warm call "
                         f"{warm_launches}")
    same_columns("route R1 path 1", got, want)
    e1 = ledger_check("R1 path 1", "device_selected")
    del got, want
    want = api.serialize_record_batch(kafka_batch, schema, MAIN_CHUNKS)
    zero(enc)
    got = api.serialize_record_batch(kafka_batch, schema, MAIN_CHUNKS,
                                     backend="auto")
    ecounts = launched("route R1 (path 5, auto)", enc)
    if wire_of(got) != wire_of(want):
        raise SystemExit("route R1: path 5 under backend='auto' differs from "
                         "backend='device'")
    e5 = ledger_check("R1 path 5", "device_selected")
    del got, want
    out["r1"] = {"path1": {"launches": counts, "arm": e1["arm"],
                           "predicted_s": e1["predicted_s"],
                           "observed_s": e1["observed_s"]},
                 "path5": {"launches": ecounts, "arm": e5["arm"],
                           "predicted_s": e5["predicted_s"],
                           "observed_s": e5["observed_s"]}}
    print(f"route R1: backend='auto' on path 1 {e1['arm']} "
          f"({e1['mode']}, {e1['reason']}) launched {counts}, predicted "
          f"{e1['predicted_s']:.4f} s, observed {e1['observed_s']:.4f} s; "
          f"path 5 {e5['arm']} ({e5['reason']}) launched {ecounts}, "
          f"predicted {e5['predicted_s']:.4f} s, observed "
          f"{e5['observed_s']:.4f} s; both equal to backend='device' {card}")

    # R3: the process pool against the shard runner on the host tier
    poisoned, bad = poison(data[:ROUTE_P1_ROWS], POLICY_EVERY)

    def host(rows, **kw):
        return api.deserialize_array_threaded(rows, schema, MAIN_CHUNKS,
                                              backend="host", **kw)

    def on_process(call):
        os.environ["PYRUHVRO_TPU_POOL"] = "process"
        try:
            return call()
        finally:
            os.environ.pop("PYRUHVRO_TPU_POOL", None)

    shard = host(data)
    telemetry.reset()
    t0 = time.perf_counter()
    got = on_process(lambda: host(data, trace_ctx=ROUTE_TP))
    cold = time.perf_counter() - t0
    e = router.last_entry()
    if e["arm"] != f"native/c{MAIN_CHUNKS}/process" or e.get("degraded"):
        raise SystemExit(f"route R3: the process arm did not serve: {e}")
    root = telemetry.snapshot()["spans"][-1]
    workers = [c for c in root["children"] if c["name"] == "pool.worker"]
    trace_id = ROUTE_TP.split("-")[1]
    if len(workers) != MAIN_CHUNKS or \
            {w["trace_id"] for w in workers} != {trace_id} or \
            root["trace_id"] != trace_id:
        raise SystemExit(f"route R3: {len(workers)} pool.worker spans under "
                         f"trace ids {sorted({w['trace_id'] for w in workers})}"
                         f": one per chunk under {trace_id} expected")
    worker_pids = sorted({w["attrs"]["pid"] for w in workers})
    smi_pids = smi_compute_pids() if card_dev == "cuda" else []
    if set(smi_pids) & set(worker_pids) or len(smi_pids) > 1:
        raise SystemExit(f"route R3: nvidia-smi lists compute apps "
                         f"{smi_pids} (workers {worker_pids}, parent "
                         f"{os.getpid()}): a worker initialised CUDA")
    same_columns("route R3 path 1", got, shard)
    del got
    turns = turns_of(lambda: on_process(lambda: host(data)),
                     lambda: host(data), ("process", "shard"),
                     rounds=ROUTE_TURNS)
    got_q = on_process(lambda: host(poisoned, on_error="skip",
                                    return_errors=True))
    want_q = host(poisoned, on_error="skip", return_errors=True)
    same_columns("route R3 P1", got_q[0], want_q[0])
    if entry_fields(got_q[1]) != entry_fields(want_q[1]) or \
            [q.index for q in got_q[1]] != bad:
        raise SystemExit("route R3: P1's quarantine on the process arm "
                         "differs from the shard arm's")
    p1_turns = turns_of(
        lambda: on_process(lambda: host(poisoned, on_error="skip")),
        lambda: host(poisoned, on_error="skip"), ("process", "shard"),
        rounds=ROUTE_TURNS)
    errs = []
    for call in (lambda: on_process(lambda: host(poisoned)),
                 lambda: host(poisoned)):
        try:
            call()
            raise SystemExit("route R3: P1 under 'raise' did not raise")
        except MalformedAvro as err:
            errs.append((err.index, err.err_name, err.tier))
    if errs[0] != errs[1] or errs[0][0] != bad[0]:
        raise SystemExit(f"route R3: MalformedAvro {errs[0]} on the process "
                         f"arm, {errs[1]} on the shard arm (first bad row "
                         f"{bad[0]})")
    med = {k: statistics.median(v) for k, v in turns.items()}
    p1_med = {k: statistics.median(v) for k, v in p1_turns.items()}
    out["r3"] = {"cold_s": cold, "turns_s": turns, "p1_turns_s": p1_turns,
                 "worker_pids": worker_pids, "smi_pids": smi_pids,
                 "parent_pid": os.getpid(), "malformed": list(errs[0])}
    print(f"route R3: PYRUHVRO_TPU_POOL=process, backend='host' on path 1: "
          f"cold call (spawning {len(worker_pids)} workers) {cold:.3f} s; "
          f"warm in turns (A B B A x{ROUTE_TURNS}) process median "
          f"{med['process']:.3f} s {[round(x, 3) for x in turns['process']]}"
          f", shard median {med['shard']:.3f} s "
          f"{[round(x, 3) for x in turns['shard']]}; P1's first "
          f"{len(poisoned)} records (skip) in turns process "
          f"{p1_med['process']:.3f} s, shard {p1_med['shard']:.3f} s; "
          f"{len(workers)} pool.worker spans under the caller's trace; "
          f"batches, {len(got_q[1])} quarantine entries and MalformedAvro "
          f"{errs[0]} equal to the shard arm's; nvidia-smi compute apps "
          f"{smi_pids} (parent {os.getpid()}, workers {worker_pids}) {card}")
    del got_q, want_q, poisoned

    # R2: autotune over three row bands
    wants = {n: api.deserialize_array_threaded(data[:n], schema, MAIN_CHUNKS)
             for n in (10_000, 100_000, 1_000_000)}
    router.reset()
    env = {"PYRUHVRO_TPU_AUTOTUNE": "1",
           "PYRUHVRO_TPU_EXPLORE": ROUTE_EXPLORE,
           "PYRUHVRO_TPU_ROUTING_PROFILE": str(tmp / "profile.json")}
    os.environ.update(env)
    fp = get_or_parse_schema(schema).fingerprint
    r2 = {}
    try:
        for n, want in wants.items():
            overrides = metrics.snapshot().get("router.override", 0)
            rows, seen = data[:n], []
            for _ in range(ROUTE_CALLS):
                got = api.deserialize_array_threaded(rows, schema,
                                                     MAIN_CHUNKS,
                                                     backend="auto")
                same_columns(f"route R2 {n}", got, want)
                del got
                seen.append(router.last_entry())
            band = seen[-1]["band"]
            arms = sorted({a for e in seen for a in
                           [e["arm"], *e["counterfactual_s"]]})
            per_arm = {}
            for a in arms:
                obs = [e["observed_s"] for e in seen if e["arm"] == a]
                per_arm[a] = {
                    "calls": len(obs),
                    "observed_s": statistics.median(obs) if obs else None,
                    "predicted_s": costmodel.predict(fp, "decode", band, a,
                                                     n)}
            unobserved = [a for a, v in per_arm.items() if not v["calls"]]
            if unobserved:
                raise SystemExit(f"route R2 {n}: arms never observed "
                                 f"{unobserved}")
            for e in seen:
                if e["mode"] == "model" and e["predicted_s"] is None:
                    raise SystemExit(f"route R2 {n}: the model picked the "
                                     f"unobserved arm {e['arm']}")
            settled = min(per_arm, key=lambda a: per_arm[a]["predicted_s"])
            r2[str(n)] = {"arms": per_arm, "settled": settled,
                          "modes": [(e["arm"], e["mode"]) for e in seen],
                          "override": metrics.snapshot().get(
                              "router.override", 0) - overrides}
            print(f"route R2: {n} Kafka records, {ROUTE_CALLS} autotuned "
                  f"calls {r2[str(n)]['modes']}; per arm predicted / "
                  f"observed median s "
                  + ", ".join(f"{a} {v['predicted_s']:.4f} / "
                              f"{v['observed_s']:.4f} ({v['calls']})"
                              for a, v in per_arm.items())
                  + f"; the model settles on {settled}; router.override "
                  f"{r2[str(n)]['override']:.0f}; every result equal to the "
                  f"device call's {card}")
        saved = costmodel.save_profile()
        doc = json.loads(Path(saved).read_text())
        if doc.get("package") != "pyruhvro_tpu_torch" or not doc["entries"]:
            raise SystemExit(f"route R2: the saved profile {saved} is wrong")
        print(f"route R2: profile saved to {saved} with "
              f"{len(doc['entries'])} arm entries and "
              f"{len(doc.get('capacity', []))} capacity plans")
    finally:
        for k in env:
            os.environ.pop(k, None)
    out["r2"] = r2
    del wants
    pool.shutdown_process_pool()

    # R4: capacity plans persisted by one process, seeding the next
    files = []
    for label, rows in (("path1", data), ("path4", large)):
        path = tmp / f"{label}.arrow"
        arr = pa.array(rows, pa.binary())
        with pa.ipc.new_file(str(path), pa.schema([("d", arr.type)])) as w:
            w.write_batch(pa.record_batch([arr], names=["d"]))
        files.append((label, path))
        del arr
    child_env = {k: v for k, v in os.environ.items()
                 if not k.startswith("PYRUHVRO_TPU_")}
    child_env.update(PYRUHVRO_TPU_CAPACITY_PERSIST="1",
                     PYRUHVRO_TPU_ROUTING_PROFILE=str(tmp / "capacity.json"))
    without = route_child(here, child_env, files, card_dev)
    doc = json.loads((tmp / "capacity.json").read_text())
    if doc.get("package") != "pyruhvro_tpu_torch" or \
            len(doc.get("capacity", [])) < 2:
        raise SystemExit(f"route R4: the first child saved "
                         f"{len(doc.get('capacity', []))} capacity plans")
    with_plan = route_child(here, child_env, files, card_dev)
    for label, _p in files:
        if with_plan[label]["plan_hits"] < 1 or \
                with_plan[label]["plan_misses"] or \
                without[label]["plan_misses"] < 1:
            raise SystemExit(f"route R4 {label}: without the profile "
                             f"{without[label]}, with it {with_plan[label]}")
    out["r4"] = {"without": without, "with": with_plan,
                 "plans_saved": len(doc["capacity"])}
    for label, _p in files:
        a, b = without[label], with_plan[label]
        print(f"route R4 {label}: a fresh process's first device call "
              f"without the profile {a['cold_s']:.3f} s (decode_walk "
              f"{a['decode_walk']}, decode_finalize {a['decode_finalize']}, "
              f"retries {a['retries']:.0f}, plan misses "
              f"{a['plan_misses']:.0f}, sample seeding {a['seed_s']:.4f} s)"
              f"; with it {b['cold_s']:.3f} s (decode_walk "
              f"{b['decode_walk']}, decode_finalize {b['decode_finalize']}, "
              f"retries {b['retries']:.0f}, plan hits {b['plan_hits']:.0f}, "
              f"sample seeding {b['seed_s']:.4f} s); "
              f"{len(doc['capacity'])} plans persisted {card}")

    # R5: the host answers a batch the card cannot take, under "auto" only
    big = kafka_batch.slice(0, 16)
    emails = big.column("emails").to_pylist()
    emails[5] = [""] * (dm._MAX_ITEM_CAP + 1)
    big = big.set_column(big.schema.get_field_index("emails"),
                         big.schema.field("emails"),
                         pa.array(emails, big.schema.field("emails").type))
    rows = wire_of(api.serialize_record_batch(big, schema, 1,
                                              backend="host"))
    try:
        api.deserialize_array(rows, schema)
        raise SystemExit("route R5: backend='device' decoded a record past "
                         "_MAX_ITEM_CAP")
    except DeviceCapacityExceeded as err:
        device_err = str(err)
    answers = metrics.snapshot().get("device.host_answer", 0)
    t0 = time.perf_counter()
    got = api.deserialize_array(rows, schema, backend="auto")
    auto_s = time.perf_counter() - t0
    e = router.last_entry()
    entry = get_or_parse_schema(schema)
    want = decode_to_record_batch(rows, entry.ir, entry.arrow_schema,
                                  compile_reader(entry.ir))
    same_values("route R5", [got], [want])
    if metrics.snapshot().get("device.host_answer", 0) <= answers or \
            e["reason"] != "device_selected":
        raise SystemExit(f"route R5: the host did not answer under 'auto' "
                         f"({e})")
    out["r5"] = {"items": dm._MAX_ITEM_CAP + 1, "auto_s": auto_s,
                 "device_error": device_err}
    print(f"route R5: a record of {dm._MAX_ITEM_CAP + 1} items: "
          f"backend='device' raises DeviceCapacityExceeded ({device_err}); "
          f"backend='auto' ({e['reason']}) answers on the host in "
          f"{auto_s:.3f} s, equal to the oracle's batch {card}")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


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
    for _ in range(POLICY_WARM_CALLS):
        t0 = time.perf_counter()
        skip(poisoned)
        warm.append(time.perf_counter() - t0)
    warm_launches = {k: c.launches / POLICY_WARM_CALLS
                     for k, c in pipe.items()}
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
    # equals() and the union columns' values on every chunk; value by
    # value (to_pylist, about 35 s a million rows) on the first only
    same_columns("P1", got, want)
    same_values("P1 (first chunk)", got[:1], want[:1])
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
          f"entries equal to the CPU call ({cpu_s:.1f} s; value by value on "
          f"the first chunk); launches: cold "
          f"{launches}, per warm call {warm_launches}; cold {cold:.3f} s, "
          f"warm median of {POLICY_WARM_CALLS} {med:.3f} s ({min(warm):.3f} .. "
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
        pack[leg].append(host_pack_s(triples[0][2]["timings"]))
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


MULTI_SHARDS = 8            # M2-M5: shards on one card (repeated device)
MULTI_BAD = (250_017, 300_000, 750_005, 874_999)  # M5: in shards 2 and 6


def keep_last_rung(sd):
    """Make the sharded decoder ``sd`` keep its last rung's inputs and
    outputs in ``sd.last_rung``: each shard's packed launch buffer and row
    count, the rung (R, B, caps, compact) and each shard's blob and
    ``#err``, still on the device."""
    real = sd._rung

    def kept(packed, ns, R, B, item_caps, tot_caps, compact, timings):
        blobs, errs, spec = real(packed, ns, R, B, item_caps, tot_caps,
                                 compact, timings)
        sd.last_rung = dict(packed=packed, ns=ns, R=R, B=B,
                            item_caps=item_caps, tot_caps=tot_caps,
                            compact=compact, blobs=blobs, errs=errs)
        return blobs, errs, spec

    sd._rung = kept


def hold_shards(torch, dm, sd, label, one_card=True):
    """Each shard's blob and ``#err`` of ``sd``'s last rung bit-equal to the
    plain versions on the same packed buffer and, with ``one_card``, to
    the one-card pipeline's (K1 then K2 through ``DeviceDecoder.pipeline``
    on that buffer at the same rung). Returns per shard ``(record bytes,
    bytes K1 + K2 must move)``; fails on any difference."""
    r = sd.last_rung
    prog, R, B = sd.base.prog, r["R"], r["B"]
    caps, tots, compact = r["item_caps"], r["tot_caps"], r["compact"]
    layout = dm.blob_layout(prog, R, B, caps, tots, compact)
    runner = dm.DeviceDecoder(prog.ir, r["packed"][0].device)
    out = []
    for d, (p, n) in enumerate(zip(r["packed"], r["ns"])):
        words, starts, lengths = dm.DeviceDecoder.launch_views(p, R, B)
        with torch.cuda.device(p.device):
            pb, pe = dm.walk_plain(words, starts, lengths, n, prog, caps)
            pblob = dm.finalize_plain(pb, pe, prog, R, B, caps, tots,
                                      compact)
            want = [("plain", pblob, pe)]
            if one_card:
                blob1, err1 = runner.pipeline(p, R, B, n, caps, tots,
                                              compact)
                want.append(("one-card pipeline", blob1, err1))
            for name, blob, err in want:
                if not torch.equal(r["blobs"][d], blob) or \
                        not torch.equal(r["errs"][d][:n], err[:n]):
                    raise SystemExit(f"{label}: shard {d}'s blob or #err "
                                     f"differs from the {name}'s at caps "
                                     f"{caps}")
            host = dm.split_blob(pblob.cpu().numpy()[:-dm.STATUS_BYTES],
                                 layout)
            totals = {rid: int(host["#red:sum:" + path][0])
                      for rid, path in enumerate(prog.regions) if rid}
            plan = dm.FinalizePlan(pb, pe, prog, R, B, caps, tots, compact)
            record_bytes = int(lengths[:n].to(torch.int64).sum())
            moved = dm.walk_bytes(record_bytes, R, dm.walk_out_bytes(
                prog, R, caps)) + dm.finalize_bytes(dm.finalize_spec(plan),
                                                    totals)
            out.append((record_bytes, moved))
            del pb, pe, pblob, plan, want
    return out


def shard_kernel_ms(torch, dm, sd, plain_of=None):
    """Per shard of ``sd``'s last rung, ``(K1, K2)`` ms by CUDA events on
    its card, best of 5 after one warm run, as :func:`pipeline_kernels`
    times them (K1 one launch of the settled walk, K2 every pass and the
    epilogue); with ``plain_of`` a shard's index, also that shard's plain
    K1 + K2 (best of 2), as ``(per shard, plain ms)``."""
    r = sd.last_rung
    prog, R, B = sd.base.prog, r["R"], r["B"]
    caps = r["item_caps"]
    out, plain_ms = [], None
    for d, (p, n) in enumerate(zip(r["packed"], r["ns"])):
        words, starts, lengths = dm.DeviceDecoder.launch_views(p, R, B)
        with torch.cuda.device(p.device):
            L = dm.WalkLaunch(words, starts, lengths, n, prog, caps)
            bufs, err = dm.walk_kernel.run(L)
            k1 = cuda_ms(torch, lambda: dm.walk_kernel.launch(L), 5)
            plan = dm.FinalizePlan(bufs, err, prog, R, B, caps,
                                   r["tot_caps"], r["compact"])
            k2 = cuda_ms(torch, lambda: dm.finalize_kernel.run(plan), 5)
            out.append((k1, k2))
            if d == plain_of:
                plain_ms = cuda_ms(torch, lambda: dm.walk_plain(
                    words, starts, lengths, n, prog, caps), 2) + \
                    cuda_ms(torch, lambda: dm.finalize_plain(
                        bufs, err, prog, R, B, caps, r["tot_caps"],
                        r["compact"]), 2)
            del L, bufs, err, plan
    return out, plain_ms


def malformed_of(call):
    """``(message, index, slug, indices)`` of the ``MalformedAvro`` that
    ``call`` raises; fails if it raises none."""
    try:
        call()
    except ValueError as e:
        return (str(e), e.index, e.err_name, e.indices)
    raise SystemExit("expected a MalformedAvro")


def multichip_phase(api, torch, dm, em, par, pse, codec_mod, parse_schema,
                    get_or_parse_schema, data, nested, kafka_batch, kafka,
                    nested_schema, card):
    """K5, the chunk fan-out (``pyruhvro_tpu_torch/parallel``). M1:
    ``ShardedDecoder`` over every visible card on path 1's records, each
    shard's blob bit-equal to the plain versions' and the one-card
    pipeline's at the same rung, K1/K2 counted from 0 over the call; with
    two cards or more also ``deserialize_array_threaded(..., device=
    "cuda", num_chunks=D)`` (the codec's fan-out) and ``device="cuda:1"``;
    a batch of fewer rows than shards. M2: ``MULTI_SHARDS`` shards on
    card 0 through the codec's route (the shards' batches returned as
    they are, equal to path 1's), warm calls in turns with path 1, each
    shard's K1 and K2. M3: path 3 from a cold decoder at
    ``MULTI_SHARDS`` shards, its rungs and ``device.retries`` equal to a
    cold one-card decoder's on one launch, the shards bit-equal to the
    plain versions. M4: ``ShardedEncoder`` on path 5's batch, each shard's
    K3 bit-equal to the plain encode, the wire equal to the one-card
    call's. M5: path 1 with bad rows in shards 2 and 6: one
    ``MalformedAvro`` equal to the one-card path's."""
    from pyruhvro_tpu_torch.runtime import metrics

    res = {}
    D = torch.cuda.device_count()
    card0 = torch.device(DEVICE, 0) if DEVICE == "cuda" else \
        torch.device(DEVICE)
    ir, nested_ir = parse_schema(kafka), parse_schema(nested_schema)
    walk, fin = dm.walk_kernel, dm.finalize_kernel
    # the one-card path of card 0 (with several cards, device="cuda" fans
    # out)
    one_card = api.deserialize_array_threaded(data, kafka, MAIN_CHUNKS,
                                              device=card0)

    # M1: every visible card, one chunk each
    t0 = time.perf_counter()
    sd = par.ShardedDecoder(ir, devices=None if DEVICE == "cuda"
                            else [card0])
    keep_last_rung(sd)
    walk.launches = fin.launches = 0
    t1 = time.perf_counter()
    got = sd.decode(data)
    cold = time.perf_counter() - t1
    launches = {"decode_walk": walk.launches,
                "decode_finalize": fin.launches}
    if min(launches.values()) < sd.D:
        raise SystemExit(f"M1: {sd.D} shards launched {launches}")
    t1 = time.perf_counter()
    got = sd.decode(data)
    warm = time.perf_counter() - t1
    want = api.deserialize_array_threaded(data, kafka, sd.D, device=card0)
    same_columns("M1", got, want)
    shards = hold_shards(torch, dm, sd, "M1")
    big = max(range(sd.D), key=lambda d: shards[d][0])
    ms, plain_ms = shard_kernel_ms(torch, dm, sd, plain_of=big)
    res["M1"] = {"shards": sd.D, "launches": launches, "cold_s": cold,
                 "warm_s": warm, "kernel_ms": ms,
                 "bound_ms": [s[1] / (HBM_BYTES_PER_S / 1e3)
                              for s in shards],
                 "plain_ms": plain_ms, "largest": big}
    print(f"multichip M1: ShardedDecoder over {sd.D} card(s) "
          f"{[str(x) for x in sd.devices]} on {len(data)} Kafka records: "
          f"launches {launches} from 0, cold {cold:.3f} s, warm "
          f"{warm:.3f} s; every shard's blob and #err bit-equal to the "
          f"plain versions and the one-card pipeline at caps "
          f"{sd.last_rung['item_caps']}; K1/K2 ms per shard {ms}; equal to "
          f"deserialize_array_threaded(..., {sd.D}) {card}")
    del got, want
    if D >= 2:
        # a schema string of its own: the route phase's R5 left the plain
        # string's decoder at 2^20-item caps, whose slots no launch of
        # path 1's rows holds (the codec would halve it on one card)
        fresh = kafka + " "
        codec = codec_mod.get_device_codec(get_or_parse_schema(fresh), "cuda")
        fan = codec._sharded_decoder()
        if fan is None:
            raise SystemExit("M1: device='cuda' with several cards has no "
                             "fan-out")
        keep_last_rung(fan)
        t1 = time.perf_counter()
        got = api.deserialize_array_threaded(data, fresh, D)
        fan_s = time.perf_counter() - t1
        cards = {str(p.device) for p in getattr(fan, "last_rung",
                                                {}).get("packed", [])}
        if len(got) != D or len(cards) != D:
            raise SystemExit(f"M1: device='cuda' gave {len(got)} batches "
                             f"from the cards {cards}")
        same_columns("M1 fan-out", got, api.deserialize_array_threaded(
            data, fresh, D, device=card0))
        turns = {"fan_out": [], "cuda:0": []}
        for leg in ["fan_out", "cuda:0", "cuda:0", "fan_out"]:
            t1 = time.perf_counter()
            batches = api.deserialize_array_threaded(
                data, fresh, D, device="cuda" if leg == "fan_out" else card0)
            turns[leg].append(time.perf_counter() - t1)
            del batches
        res["M1"]["fan_out_turns_s"] = turns
        same_columns("M1 cuda:1", api.deserialize_array_threaded(
            data, kafka, MAIN_CHUNKS, device="cuda:1"), one_card)
        enc1 = api.serialize_record_batch(kafka_batch, kafka, MAIN_CHUNKS,
                                          device="cuda:1")
        if wire_of(enc1) != data:
            raise SystemExit("M1: serialize_record_batch on cuda:1 differs "
                             "from the input datums")
        res["M1"]["fan_out_s"] = fan_s
        print(f"multichip M1: deserialize_array_threaded(device='cuda', "
              f"num_chunks={D}) fanned out over {D} cards in {fan_s:.3f} s, "
              f"equal to cuda:0; warm in turns (A B B A) {turns}; "
              f"device='cuda:1' decode and encode equal {card}")
        del got, enc1
    else:
        print("multichip M1: one card visible: the codec's fan-out across "
              "cards and device='cuda:1' are not exercised here")
    few = par.ShardedDecoder(ir, devices=[card0] * MULTI_SHARDS)
    pads = few.decode(data[:3])
    if [b.num_rows for b in pads] != [1, 1, 1] + [0] * (MULTI_SHARDS - 3):
        raise SystemExit(f"M1: 3 records in {MULTI_SHARDS} shards gave "
                         f"{[b.num_rows for b in pads]}")
    same_columns("M1 pads", pads[:3], api.deserialize_array_threaded(
        data[:3], kafka, 3, device="cpu"))
    res["M1"]["s"] = time.perf_counter() - t0
    del sd, few, pads

    # M2: MULTI_SHARDS shards on card 0 through the codec's route (card
    # 0's codec: R5 left device="cuda"'s at 2^20-item caps)
    t0 = time.perf_counter()
    codec = codec_mod.get_device_codec(get_or_parse_schema(kafka), card0)
    sd8 = par.ShardedDecoder(base=codec.decoder,
                             devices=[card0] * MULTI_SHARDS)
    keep_last_rung(sd8)
    seen = []
    real_decode = sd8.decode

    def recorded(*args, **kwargs):
        out = real_decode(*args, **kwargs)
        seen.append(out)
        return out

    sd8.decode = recorded
    before = codec._sharded
    codec._sharded = sd8
    try:
        got = api.deserialize_array_threaded(data, kafka, MAIN_CHUNKS,
                                             device=card0)
        if len(seen) != 1 or not all(g is s for g, s in zip(got, seen[0])):
            raise SystemExit("M2: the codec did not return the shards' "
                             "batches as they are")
        same_columns("M2", got, one_card)
        del got
        times = {"overlapped": [], "shards": []}
        for leg in ["overlapped", "shards", "shards", "overlapped"] * 2:
            codec._sharded = sd8 if leg == "shards" else False
            t1 = time.perf_counter()
            batches = api.deserialize_array_threaded(data, kafka,
                                                     MAIN_CHUNKS,
                                                     device=card0)
            times[leg].append(time.perf_counter() - t1)
            del batches
    finally:
        codec._sharded = before
    ms8, _plain = shard_kernel_ms(torch, dm, sd8)
    res["M2"] = {"shards": MULTI_SHARDS, "turns_s": times,
                 "kernel_ms": ms8, "s": time.perf_counter() - t0}
    print(f"multichip M2: {MULTI_SHARDS} shards on {card0} through the "
          f"codec, the shards' batches returned as they are, equal to path "
          f"1; warm calls in turns (A B B A twice), s: "
          + "; ".join(f"{k} median {statistics.median(v):.3f} "
                      f"{[round(x, 3) for x in v]}" for k, v in times.items())
          + f"; K1/K2 ms per shard {[(round(a, 3), round(b, 3)) for a, b in ms8]} "
          f"{card}")
    del sd8

    # M3: path 3 from a cold decoder, shards against one launch
    t0 = time.perf_counter()
    retries0 = metrics.snapshot().get("device.retries", 0)
    one = dm.DeviceDecoder(nested_ir, card0)
    _h, _n, meta = one.decode_to_columns(nested)
    one_rungs = meta["timings"]["rungs"]
    one_retries = metrics.snapshot().get("device.retries", 0) - retries0
    del _h, meta, one
    sd3 = par.ShardedDecoder(nested_ir, devices=[card0] * MULTI_SHARDS)
    keep_last_rung(sd3)
    retries0 = metrics.snapshot().get("device.retries", 0)
    triples = sd3.decode_to_chunk_columns(nested)
    rungs = triples[0][2]["timings"]["rungs"]
    retries = metrics.snapshot().get("device.retries", 0) - retries0
    del triples
    if retries != one_retries or rungs != one_rungs:
        raise SystemExit(f"M3: {MULTI_SHARDS} shards climbed {rungs} rungs "
                         f"({retries} retries), one launch {one_rungs} "
                         f"({one_retries})")
    t1 = time.perf_counter()
    hold_shards(torch, dm, sd3, "M3", one_card=False)
    hold_s = time.perf_counter() - t1
    same_columns("M3", sd3.decode(nested), api.deserialize_array_threaded(
        nested, nested_schema, MULTI_SHARDS, device=card0))
    res["M3"] = {"rungs": rungs, "retries": retries,
                 "one_launch_rungs": one_rungs, "hold_s": hold_s,
                 "s": time.perf_counter() - t0}
    print(f"multichip M3: {len(nested)} nested records in {MULTI_SHARDS} "
          f"shards from a cold decoder: {rungs} rungs, device.retries "
          f"{retries}, as a cold one-card decoder's one launch; shards "
          f"bit-equal to the plain versions; equal to path 3 {card}")
    del sd3

    # M4: the sharded encoder on path 5's batch
    t0 = time.perf_counter()
    enc = par.ShardedEncoder(parse_schema(kafka), kafka_batch.schema,
                             devices=[card0] * MULTI_SHARDS)
    kept = []
    real_run = pse.run_program

    def keep(L, timings=None):
        out = real_run(L, timings)
        kept.append((L, out))
        return out

    em.encode_kernel.rows.launches = em.encode_kernel.strings.launches = 0
    pse.run_program = keep
    try:
        t1 = time.perf_counter()
        arrays = enc.encode(kafka_batch)
        enc_s = time.perf_counter() - t1
    finally:
        pse.run_program = real_run
    k3 = {"encode_rows": em.encode_kernel.rows.launches,
          "encode_strings": em.encode_kernel.strings.launches}
    if k3 != {"encode_rows": 2 * MULTI_SHARDS,
              "encode_strings": MULTI_SHARDS}:
        raise SystemExit(f"M4: {MULTI_SHARDS} shards launched {k3}")
    for d, (L, (out, sizes)) in enumerate(kept):
        dv = L.dv()
        p_out, p_sizes, p_dst = em.rows_plain(dv, L.prog, L.cap)
        em.strings_plain(p_out, dv, L.prog, p_dst)
        total = int(p_sizes.to(torch.int64).sum())
        worst = max(max_abs_diff(torch, sizes, p_sizes),
                    max_abs_diff(torch, out[:total], p_out[:total]))
        for path, dst in L.dst().items():
            worst = max(worst, max_abs_diff(torch, dst, p_dst[path]))
        if worst:
            raise SystemExit(f"M4: shard {d}'s encode kernels != plain "
                             f"(max abs diff {worst})")
        del dv, p_out, p_sizes, p_dst
    del kept
    want = api.serialize_record_batch(kafka_batch, kafka, MULTI_SHARDS)
    if len(arrays) != MULTI_SHARDS or \
            not all(a.equals(w) for a, w in zip(arrays, want)) or \
            wire_of(arrays) != data:
        raise SystemExit("M4: the sharded encode differs from the one-card "
                         "call or the input datums")
    res["M4"] = {"launches": k3, "encode_s": enc_s,
                 "s": time.perf_counter() - t0}
    print(f"multichip M4: ShardedEncoder, {MULTI_SHARDS} shards of "
          f"{kafka_batch.num_rows} rows in {enc_s:.3f} s: launches {k3} from "
          f"0, each shard's K3 bit-equal to the plain encode, the wire "
          f"equal to the one-card call and the input datums {card}")
    del enc, arrays, want

    # M5: bad rows in shards 2 and 6, one MalformedAvro
    t0 = time.perf_counter()
    bad = list(data)
    for i in MULTI_BAD:
        bad[i] = b"\x01"
    sd5 = par.ShardedDecoder(ir, devices=[card0] * MULTI_SHARDS)
    got = malformed_of(lambda: sd5.decode(bad))
    want = malformed_of(lambda: api.deserialize_array_threaded(
        bad, kafka, MULTI_SHARDS, device=card0))
    if got != want or [i for i, _s in got[3]] != list(MULTI_BAD):
        raise SystemExit(f"M5: the shards raised {got[:3]} with indices "
                         f"{got[3]}, the one-card path {want[:3]} with "
                         f"{want[3]}")
    res["M5"] = {"message": got[0], "indices": got[3],
                 "s": time.perf_counter() - t0}
    print(f"multichip M5: bad rows {list(MULTI_BAD)} in shards 2 and 6: one "
          f"MalformedAvro {got[0]!r}, indices {got[3]}, equal to the "
          f"one-card path's {card}")
    print("multichip phase parts, s: " + ", ".join(
        f"{k} {v['s']:.1f}" for k, v in res.items()))
    return res


PLANES_ROWS = 100_000       # the planes phase: Kafka records per call
PLANES_SEEDS = (0, 1, 2)    # F3: schedules of the two decoding threads
PLANES_HANG_S = 2.0         # F2: the h2d hang against a 0.5 s budget
PLANES_TURNS = 2            # S1: rounds of A B B A twice (8 calls a side)


def nulls_datums(n: int):
    """``n`` rows of :data:`NULLS_SCHEMA` with 0 to 4 null items each: the
    count, no bytes per item, the block end, then a 1-byte string."""
    return [(zz(k % 5) + zz(0) if k % 5 else zz(0)) + zz(1) + b"x"
            for k in range(n)]


def counter_delta(metrics, before, prefixes):
    """Counters under ``prefixes`` that moved since ``before``."""
    now = metrics.snapshot()
    return {k: now[k] - before.get(k, 0.0) for k in now
            if k.startswith(prefixes) and now[k] != before.get(k, 0.0)}


def planes_phase(api, torch, dm, em, data, schema, here, card):
    """The planes above the codec on the card, each held against the same
    call on the CPU (``device="cpu"``) or a card call that was:

    * C1: :data:`NULLS_SCHEMA`'s batch (arrays of null items) encodes on
      the card (``encode_rows`` counted from 0) to the oracle's wire,
      which is the input, ``b"\\x04\\x00\\x02x"`` for 2 items;
    * F1: ``device_launch:error:1``, then ``h2d:error:1``, each under
      ``backend="device"`` and ``"auto"``: ``FaultInjected`` raised,
      ``fault.injected.<site>`` counted once, no host tier or host
      answer counted, and the next call without a spec equal to the
      CPU call;
    * F2: ``h2d:hang`` with ``PYRUHVRO_TPU_FAULT_HANG_S`` =
      :data:`PLANES_HANG_S` under ``timeout_s=0.5`` raises
      ``DeadlineExceeded``;
    * F3: two threads decode on the card under
      ``schedtest.run_interleaved`` for :data:`PLANES_SEEDS`: both equal
      the CPU call, no stall;
    * S1: a deep-sampled call (each launch waited on at its end) and a
      plain one in turns, A B B A twice, :data:`PLANES_TURNS` times:
      both calls' seconds, the
      sampler's ``overhead_fraction`` beside the measured ratio,
      ``sampling.deep_calls``, and ``device.sync_waits``: a deep call
      waits once on each of its K1 / K2 launches, a plain call never; the
      batches equal;
    * L1: an SLO whose ``threshold_s`` is under the warm call breaches
      after ``min_calls``: a flight dump whose records hold the device
      launches' spans, and its ``alert_command`` run.

    ``data`` is :data:`PLANES_ROWS` records of ``schema``, which the
    phase decodes under a schema string of its own: a fresh decoder that
    no earlier phase has left at sticky item caps (a record past the
    item limit, R5). Every failure exits non-zero. Returns the phase's
    figures."""
    import os

    from pyruhvro_tpu_torch.runtime import (faults, metrics, sampling,
                                            schedtest, slo, telemetry)
    from pyruhvro_tpu_torch.runtime.deadline import DeadlineExceeded

    doc = json.loads(schema)
    doc["doc"] = "planes phase"
    schema = json.dumps(doc)
    out = {}
    pipe = {"decode_walk": dm.walk_kernel,
            "decode_finalize": dm.finalize_kernel}
    host_keys = ("route.native", "route.fallback", "device.host_answer")

    # C1: arrays of null items on the card
    nulls = nulls_datums(4096)
    batch = api.deserialize_array(nulls, NULLS_SCHEMA)
    enc = {"encode_rows": em.encode_kernel.rows}
    zero(enc)
    arrays = api.serialize_record_batch(batch, NULLS_SCHEMA, 2)
    c1_launches = launched("planes C1", enc)
    wire = [d for a in arrays for d in a.to_pylist()]
    cpu = api.serialize_record_batch(batch, NULLS_SCHEMA, 2, device="cpu")
    if wire != nulls or wire != [d for a in cpu for d in a.to_pylist()]:
        raise SystemExit("planes C1: the card's wire of null items is not "
                         "the oracle's")
    if wire[2] != b"\x04\x00\x02x":
        raise SystemExit(f"planes C1: row 2 encodes to {wire[2]!r}")
    out["C1"] = {"rows": len(nulls), "launches": c1_launches,
                 "row2": wire[2].hex()}
    print(f"planes C1: {len(nulls)} rows of null items encode on the card "
          f"to the oracle's wire (row 2 {wire[2]!r}), launches "
          f"{c1_launches}")

    # the reference for F1-S1: the card's call, held once against the CPU
    t0 = time.perf_counter()
    want = api.deserialize_array_threaded(data, schema, MAIN_CHUNKS,
                                          device="cpu")
    cpu_s = time.perf_counter() - t0
    card_want = api.deserialize_array_threaded(data, schema, MAIN_CHUNKS)
    same_values("planes: the card call", card_want, want)
    del want

    # F1: the device seams raise under "device" and "auto"
    f1 = {}
    for site in ("device_launch", "h2d"):
        for backend in ("device", "auto"):
            label = f"planes F1 {site} {backend}"
            faults.reset()
            before = metrics.snapshot()
            os.environ["PYRUHVRO_TPU_FAULTS"] = f"{site}:error:1"
            try:
                api.deserialize_array_threaded(data, schema, MAIN_CHUNKS,
                                               backend=backend)
            except faults.FaultInjected as e:
                if e.site != site:
                    raise SystemExit(f"{label}: raised at {e.site}")
            else:
                raise SystemExit(f"{label}: the call did not raise")
            finally:
                os.environ.pop("PYRUHVRO_TPU_FAULTS")
            moved = counter_delta(metrics, before,
                                  ("fault.", *host_keys))
            if moved != {f"fault.injected.{site}": 1.0}:
                raise SystemExit(f"{label}: counters {moved}")
            got = api.deserialize_array_threaded(data, schema, MAIN_CHUNKS,
                                                 backend=backend)
            same_columns(f"{label}: the next call", got, card_want)
            f1[f"{site}/{backend}"] = moved
    out["F1"] = f1
    print(f"planes F1: device_launch and h2d faults raised FaultInjected "
          f"under device and auto, counted once each, no host answer; "
          f"the next calls equal the CPU call ({cpu_s:.1f} s)")

    # F2: a hung copy against the call's deadline
    os.environ["PYRUHVRO_TPU_FAULTS"] = "h2d:hang:1"
    os.environ["PYRUHVRO_TPU_FAULT_HANG_S"] = str(PLANES_HANG_S)
    t0 = time.perf_counter()
    try:
        api.deserialize_array_threaded(data, schema, MAIN_CHUNKS,
                                       timeout_s=0.5)
    except DeadlineExceeded as e:
        f2 = {"raised_s": time.perf_counter() - t0, "site": e.site,
              "elapsed_s": e.elapsed_s}
    else:
        raise SystemExit("planes F2: the hung call did not raise "
                         "DeadlineExceeded")
    finally:
        os.environ.pop("PYRUHVRO_TPU_FAULTS")
        os.environ.pop("PYRUHVRO_TPU_FAULT_HANG_S")
    out["F2"] = f2
    print(f"planes F2: h2d hang of {PLANES_HANG_S} s under timeout_s=0.5 "
          f"raised DeadlineExceeded at {f2['site']} after "
          f"{f2['raised_s']:.3f} s")

    # F3: two decoding threads under the interleaving harness
    f3 = []
    for seed in PLANES_SEEDS:
        res = {}

        def worker(k):
            def run():
                res[k] = api.deserialize_array_threaded(data, schema,
                                                        MAIN_CHUNKS)
            return run

        t0 = time.perf_counter()
        h = schedtest.run_interleaved([worker(0), worker(1)], seed=seed,
                                      timeout_s=120.0)
        secs = time.perf_counter() - t0
        if h.stalls:
            raise SystemExit(f"planes F3 seed {seed}: {h.stalls} stalls")
        for k in (0, 1):
            same_columns(f"planes F3 seed {seed} thread {k}", res[k],
                         card_want)
        points = {}
        for _t, p in h.trace:
            points[p] = points.get(p, 0) + 1
        f3.append({"seed": seed, "switch_points": len(h.trace),
                   "points": points, "s": secs})
    out["F3"] = f3
    print(f"planes F3: two card threads under {len(PLANES_SEEDS)} seeded "
          f"schedules, no stall, both equal the CPU call; yield points "
          f"{[r['switch_points'] for r in f3]}")

    # S1: deep-sampled against plain, in turns; the sampler starts from
    # nothing (the harness's slow calls above would weigh in its
    # estimate of a plain call) and learns one plain call first
    sampling.reset()
    sampling.set_enabled(True)
    deep_before = metrics.snapshot().get("sampling.deep_calls", 0.0)
    launches = []
    waits = {"deep": [], "plain": []}
    outs = {}

    def call(deep):
        # period 1 samples this call; a period past the call count never
        sampling._period = 1 if deep else 1 << 16
        sampling._pending_resample = False
        zero(pipe)
        w0 = metrics.snapshot().get("device.sync_waits", 0.0)
        got = api.deserialize_array_threaded(data, schema, MAIN_CHUNKS)
        # a deep call waits once on each launch's end, a plain one never
        # (and the CPU's plain versions of a rehearsal have nothing to
        # wait on)
        waited = metrics.snapshot().get("device.sync_waits", 0.0) - w0
        launched = sum(c.launches for c in pipe.values())
        if waited != (launched if deep and DEVICE != "cpu" else 0):
            raise SystemExit(f"planes S1: a {'deep' if deep else 'plain'} "
                             f"call waited {waited:.0f} times on its "
                             f"{launched} launches")
        waits["deep" if deep else "plain"].append(waited)
        if deep:
            launches.append({k: c.launches for k, c in pipe.items()})
        outs["deep" if deep else "plain"] = got
        return got

    try:
        call(False)
        times = {"deep": [], "plain": []}
        for _ in range(PLANES_TURNS):
            for k, v in turns_of(lambda: call(True), lambda: call(False),
                                 ("deep", "plain")).items():
                times[k] += v
    finally:
        sampling.set_enabled(None)
    deep_calls = metrics.snapshot().get("sampling.deep_calls", 0.0) - \
        deep_before
    if deep_calls != 4 * PLANES_TURNS:
        raise SystemExit(f"planes S1: {deep_calls} deep calls of "
                         f"{4 * PLANES_TURNS}")
    same_columns("planes S1 deep", outs["deep"], card_want)
    same_columns("planes S1 plain", outs["plain"], card_want)
    med = {k: statistics.median(v) for k, v in times.items()}
    s1 = {"deep_s": times["deep"], "plain_s": times["plain"],
          "measured_ratio": med["deep"] / med["plain"] - 1.0,
          "overhead_fraction": sampling.overhead_fraction(),
          "period_after": sampling.period(),
          "deep_calls": deep_calls, "deep_launches": launches[0],
          "sync_waits": waits,
          "snapshot": sampling.snapshot_sampling()}
    out["S1"] = s1
    print(f"planes S1: deep {spread(times['deep'])} ms, plain "
          f"{spread(times['plain'])} ms ({s1['measured_ratio'] * 100:+.2f} "
          f"%), the sampler's overhead_fraction "
          f"{s1['overhead_fraction'] * 100:.2f} %, {deep_calls:.0f} deep "
          f"calls, each waited {waits['deep'][0]:.0f} times on "
          f"{launches[0]}, a plain call {waits['plain'][0]:.0f} times "
          f"{card}")

    # L1: an SLO breached by the card's calls
    build = here / "build" / "planes"
    build.mkdir(parents=True, exist_ok=True)
    for f in build.iterdir():
        f.unlink()
    flag = build / "alert_fired"
    slo_path = build / "slo.json"
    slo_path.write_text(json.dumps({"version": 1, "objectives": [{
        "name": "card-decode", "op": "decode", "threshold_s": 0.001,
        "target": 0.5, "windows_s": [60, 120], "burn_threshold": 1.5,
        "min_calls": 5,
        "alert_command": f"{sys.executable} -c \"open(r'{flag}', "
                         f"'w').write('x')\""}]}))
    os.environ["PYRUHVRO_TPU_SLO_FILE"] = str(slo_path)
    os.environ["PYRUHVRO_TPU_FLIGHT_DIR"] = str(build)
    try:
        telemetry._flight_last_auto = 0.0
        calls = []
        for _ in range(6):
            t0 = time.perf_counter()
            api.deserialize_array_threaded(data, schema, MAIN_CHUNKS)
            calls.append(time.perf_counter() - t0)
            time.sleep(0.3)  # past the engine's 0.25 s evaluation step
        breached = slo.breached()
        for _ in range(200):  # the hook runs detached
            if flag.exists():
                break
            time.sleep(0.05)
        dumps = sorted(build.glob("flight_*_slo_breach.json"))
        section = slo.snapshot_slo()
    finally:
        os.environ.pop("PYRUHVRO_TPU_SLO_FILE")
        os.environ.pop("PYRUHVRO_TPU_FLIGHT_DIR")
        slo.reset()
    if breached != ["card-decode"] or len(dumps) != 1 or not flag.exists():
        raise SystemExit(f"planes L1: breached {breached}, dumps {dumps}, "
                         f"alert {flag.exists()}")
    doc = json.loads(dumps[0].read_text())
    launch_phases = {k: v for r in doc["records"]
                     for k, v in r["phases"].items()
                     if k.startswith("device.")}
    if "device.launch_s" not in launch_phases:
        raise SystemExit(f"planes L1: the flight dump holds no device "
                         f"launch spans: {launch_phases}")
    out["L1"] = {"calls_s": calls, "records": len(doc["records"]),
                 "device_phases_s": launch_phases,
                 "objective": section["objectives"][0]}
    print(f"planes L1: the SLO breached after {len(calls)} calls "
          f"({spread(calls)} ms), one flight dump of "
          f"{len(doc['records'])} records with device phases "
          f"{sorted(launch_phases)}, the alert command ran")
    for f in build.iterdir():
        f.unlink()
    build.rmdir()
    return out


INCIDENT_ROWS = 100_000     # the incident phase: Kafka records per call
INCIDENT_FLIP = (2, 1234)   # A3: the flipped byte's (chunk, row in chunk)
INCIDENT_COLUMN = "created_at"


def flip_byte(pa, batch, name, row):
    """One flipped byte of one row of a fixed-width column (the reference's
    ``tests/test_audit.py`` ``_flip_buffer_byte``, the array's offset
    honoured): the smallest silent corruption."""
    idx = batch.schema.names.index(name)
    arr = batch.column(idx)
    width = arr.type.bit_width // 8
    bufs = arr.buffers()
    data = bytearray(bufs[1].to_pybytes())
    data[(arr.offset + row) * width] ^= 0x01
    cols = list(batch.columns)
    cols[idx] = pa.Array.from_buffers(
        arr.type, len(arr), [bufs[0], pa.py_buffer(bytes(data))],
        offset=arr.offset)
    return pa.RecordBatch.from_arrays(cols, schema=batch.schema)


def http_get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def countable(delta):
    """A counter delta without the audit's own keys, the timeline's tick
    count (its thread ticks when it will) and the seconds."""
    return {k: v for k, v in delta.items()
            if not k.startswith(("audit.", "timeline."))
            and not k.endswith("_s")}


def incident_phase(api, pa, dm, em, data, schema, card):
    """The incident plane against the card's decode and encode, under the
    reference's defaults (the audit on, the timeline ticking), with
    ``PYRUHVRO_TPU_INCIDENT_DIR`` a temporary directory:

    * A1: ``audit.force_next()``, then ``deserialize_array_threaded`` on
      the card: audited once, no mismatch (K1/K2's output digests equal
      the oracle's); the shadow's seconds, and the root span's SLO feed
      is its duration less them; the counters other than ``audit.*``
      (and seconds) equal those of the same call unaudited;
    * A2: the same for ``serialize_record_batch`` of those rows: K3's wire
      round-trips through the oracle clean;
    * A3: one byte flipped in the card's result before the seam
      (:data:`INCIDENT_FLIP`): the mismatch in :data:`INCIDENT_COLUMN`
      at the exact row, the caller's batches untouched, the arm and the
      schema's device tier penalised, and the next ``backend="device"``
      call still launches K1/K2 and equals the first;
    * O1: an ``ObsServer`` on 127.0.0.1: ``/healthz`` 503 with
      ``audit_mismatch`` set, ``/metrics`` byte-identical to
      ``telemetry.prometheus()``, ``/audit``, ``/timeline`` and
      ``/incidents`` parse;
    * I1: within ``incident.DEBOUNCE_S`` the tick thread writes exactly
      one bundle, holding the ``audit.mismatch`` event, the flight ring
      and the routing tail; ``incident-report`` renders it;
    * T1: ``timeline.tick_now()`` over the phase: each counter's deltas
      sum to its cumulative value.

    ``data`` is :data:`INCIDENT_ROWS` records of ``schema``, decoded under
    a schema string of its own (sticky caps after R5). The phase starts
    from ``telemetry.reset()`` and keeps the deep sampler off, so that
    two calls' counters compare. Every failure exits non-zero. Returns
    the phase's figures."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from pyruhvro_tpu_torch import api as api_mod
    from pyruhvro_tpu_torch.runtime import (audit, costmodel, incident,
                                            metrics, obs_server, sampling,
                                            slo, telemetry, timeline)
    from pyruhvro_tpu_torch.runtime.chunking import chunk_bounds

    doc = json.loads(schema)
    doc["doc"] = "incident phase"
    schema = json.dumps(doc)
    pipe = {"decode_walk": dm.walk_kernel,
            "decode_finalize": dm.finalize_kernel}
    enc = {"encode_rows": em.encode_kernel.rows}
    # what the audit saw of the earlier phases' calls, at its defaults
    seen = audit.snapshot_audit()
    out = {"before": {k: seen.get(k) for k in ("calls", "audited",
                                               "period", "cost_ratio")}}
    tmp = tempfile.mkdtemp(prefix="pyruhvro-incidents-")
    os.environ["PYRUHVRO_TPU_INCIDENT_DIR"] = tmp
    telemetry.reset()
    sampling.set_enabled(False)
    srv = None
    try:
        # A1: an audited decode on the card against an unaudited one
        card_out = api.deserialize_array_threaded(data, schema, MAIN_CHUNKS)
        fed, consumed = [], []
        feed, consume = slo.record_root, audit.consume_shadow_seconds

        def feed_spy(name, fp, dur, err):
            fed.append(dur)
            return feed(name, fp, dur, err)

        def consume_spy():
            consumed.append(consume())
            return consumed[-1]

        def audited(call):
            """(plain delta, audited delta, audited result): a warm call,
            then a plain one and an audited one"""
            call()
            before = metrics.snapshot()
            call()
            mid = metrics.snapshot()
            audit.force_next()
            zero(pipe)
            zero(enc)
            fed.clear()
            consumed.clear()
            slo.record_root = feed_spy
            audit.consume_shadow_seconds = consume_spy
            try:
                got = call()
            finally:
                slo.record_root = feed
                audit.consume_shadow_seconds = consume
            after = metrics.snapshot()
            plain = {k: mid[k] - before.get(k, 0.0) for k in mid
                     if mid[k] != before.get(k, 0.0)}
            aud = {k: after[k] - mid.get(k, 0.0) for k in after
                   if after[k] != mid.get(k, 0.0)}
            return plain, aud, got

        def check_audited(label, plain, aud, launches):
            mine = {k: v for k, v in aud.items() if k.startswith("audit.")}
            if mine.get("audit.audited") != 1 or \
                    mine.get("audit.mismatches") or \
                    mine.get("audit.shadow_error"):
                raise SystemExit(f"incident {label}: audit counters {mine}")
            if countable(plain) != countable(aud):
                raise SystemExit(f"incident {label}: the audited call's "
                                 f"counters {countable(aud)} differ from "
                                 f"the plain call's {countable(plain)}")
            span = telemetry._spans[-1]
            if len(consumed) != 1 or consumed[0] <= 0 or len(fed) != 1 or \
                    abs(fed[0] - (span.dur_s - consumed[0])) > 1e-6:
                raise SystemExit(f"incident {label}: the SLO feed {fed} is "
                                 f"not the root's {span.dur_s} s less the "
                                 f"shadow's {consumed}")
            return {"shadow_s": consumed[0],
                    "primary_s": span.dur_s - consumed[0],
                    "root_s": span.dur_s, "slo_fed_s": fed[0],
                    "audited_rows": aud["audit.audited_rows"],
                    "launches": launches,
                    "counters_compared": len(countable(aud))}

        plain, aud, got = audited(lambda: api.deserialize_array_threaded(
            data, schema, MAIN_CHUNKS))
        a1 = check_audited("A1", plain, aud, launched("incident A1", pipe))
        same_columns("incident A1", got, card_out)
        sec = audit.snapshot_audit()
        a1.update(ratio=a1["shadow_s"] / a1["primary_s"],
                  cost_ratio=sec["cost_ratio"], period=sec["period"])
        out["A1"] = a1
        print(f"incident A1: the card's decode of {len(data)} rows audited "
              f"clean, shadow {a1['shadow_s']:.3f} s against the primary's "
              f"{a1['primary_s']:.3f} s (x{a1['ratio']:.1f}), the audit's "
              f"cost ratio {sec['cost_ratio']} and period {sec['period']}; "
              f"the SLO fed {a1['slo_fed_s']:.4f} s; "
              f"{a1['counters_compared']} counters equal the plain call's; "
              f"launches {a1['launches']} {card}")

        # A2: an audited encode on the card, round-tripped by the oracle
        table = pa.Table.from_batches(card_out)
        plain, aud, arrays = audited(lambda: api.serialize_record_batch(
            table, schema, MAIN_CHUNKS))
        a2 = check_audited("A2", plain, aud, launched("incident A2", enc))
        wire = [d for a in arrays for d in a.to_pylist()]
        if wire != list(data):
            raise SystemExit("incident A2: the card's wire is not the input")
        sec = audit.snapshot_audit()
        a2.update(ratio=a2["shadow_s"] / a2["primary_s"],
                  cost_ratio=sec["cost_ratio"], period=sec["period"])
        out["A2"] = a2
        print(f"incident A2: the card's encode audited clean by the round "
              f"trip, shadow {a2['shadow_s']:.3f} s against "
              f"{a2['primary_s']:.3f} s (x{a2['ratio']:.1f}), cost ratio "
              f"{sec['cost_ratio']}, period {sec['period']}; launches "
              f"{a2['launches']} {card}")

        # A3: one flipped byte in the card's result, before the seam
        bounds = chunk_bounds(len(data), MAIN_CHUNKS)
        chunk, row = INCIDENT_FLIP
        real = api_mod._maybe_audit_decode

        def corrupting(dec, entry, d, b, on_error, result):
            real(dec, entry, d, b, on_error, [
                flip_byte(pa, x, INCIDENT_COLUMN, row) if i == chunk else x
                for i, x in enumerate(result)])

        api_mod._maybe_audit_decode = corrupting
        audit.force_next()
        try:
            got = api.deserialize_array_threaded(data, schema, MAIN_CHUNKS)
        finally:
            api_mod._maybe_audit_decode = real
        t_mismatch = time.perf_counter()
        wall_mismatch = time.time()
        same_columns("incident A3: the caller's batches", got, card_out)
        recs = audit.mismatches()
        want_row = bounds[chunk][0] + row
        if len(recs) != 1 or recs[0]["column"] != INCIDENT_COLUMN or \
                recs[0]["row_index"] != want_row or recs[0]["op"] != "decode":
            raise SystemExit(f"incident A3: mismatches {recs}, not "
                             f"{INCIDENT_COLUMN} row {want_row}")
        m = recs[0]
        if not (costmodel.arm_penalized(m["schema"], m["arm"])
                and costmodel.device_penalized(m["schema"])
                and m["arm"].startswith("device/")):
            raise SystemExit(f"incident A3: the arm {m['arm']} is not "
                             f"penalised")
        zero(pipe)
        again = api.deserialize_array_threaded(data, schema, MAIN_CHUNKS,
                                               backend="device")
        after = launched("incident A3: the next device call", pipe)
        same_columns("incident A3: the next device call", again, card_out)
        last = telemetry.snapshot()["routing"]["ledger"][-1]
        if last["tier"] != "device":
            raise SystemExit(f"incident A3: the next call ran on "
                             f"{last['tier']}")
        out["A3"] = {"mismatch": m, "next_launches": after,
                     "counters": {k: v for k, v in metrics.snapshot().items()
                                  if k.startswith(("audit.mismatch",
                                                   "router."))}}
        print(f"incident A3: a byte flipped at chunk {chunk} row {row} "
              f"found in {m['column']} row {m['row_index']}, the caller's "
              f"batches untouched, {m['arm']} and the device tier "
              f"penalised; the next backend=\"device\" call launched "
              f"{after} on the card")

        # O1: the obs server
        srv = obs_server.ObsServer(port=0).start()
        code, body = http_get(srv.url + "/healthz")
        health = json.loads(body)
        if code != 503 or not health["unhealthy_bits"]["audit_mismatch"]:
            raise SystemExit(f"incident O1: /healthz {code} {health}")
        diffs = []
        for attempt in range(3):
            # each export recomputes the audit's coverage gauge decayed
            # to its own instant (its last digit may move between two
            # reads), and a tick of the timeline thread between them
            # counts timeline.ticks: read both again
            code, body = http_get(srv.url + "/metrics")
            text = telemetry.prometheus()
            same_metrics = body.decode() == text
            if same_metrics:
                break
            diffs.append(sorted(set(body.decode().splitlines())
                                ^ set(text.splitlines()))[:8])
        if code != 200 or not same_metrics:
            raise SystemExit("incident O1: /metrics is not "
                             "telemetry.prometheus()")
        metrics_bytes = len(body)
        docs = {}
        for path in ("/audit", "/timeline", "/incidents"):
            code, body = http_get(srv.url + path)
            if code != 200:
                raise SystemExit(f"incident O1: {path} answered {code}")
            docs[path] = json.loads(body)
        if docs["/audit"]["mismatches"] != 1:
            raise SystemExit(f"incident O1: /audit {docs['/audit']}")
        out["O1"] = {"healthz": health, "metrics_bytes": metrics_bytes,
                     "metrics_attempts": attempt + 1,
                     "metrics_diffs": diffs,
                     "audit_mismatches": docs["/audit"]["mismatches"],
                     "timeline_events": [
                         e["name"] for e in docs["/timeline"]["events"]],
                     "incidents": docs["/incidents"]["incidents"]}
        print(f"incident O1: /healthz 503 with audit_mismatch, /metrics "
              f"byte-identical ({attempt + 1} read(s)), /audit, /timeline "
              f"and /incidents parse")

        # I1: one bundle, written by the tick thread
        while time.perf_counter() - t_mismatch < incident.DEBOUNCE_S and \
                not [f for f in os.listdir(tmp) if f.startswith("incident_")]:
            time.sleep(0.05)
        # seen by this poll, at most: the thread wrote it earlier
        found_s = time.perf_counter() - t_mismatch
        time.sleep(0.5)
        bundles = sorted(f for f in os.listdir(tmp)
                         if f.startswith("incident_"))
        if len(bundles) != 1:
            raise SystemExit(f"incident I1: bundles {bundles}")
        path = os.path.join(tmp, bundles[0])
        with open(path, encoding="utf-8") as f:
            bundle = json.load(f)
        names = [e["name"] for e in bundle["timeline"]["events"]]
        if bundle["trigger"] != "audit.mismatch" or \
                "audit.mismatch" not in names or \
                not bundle["flight"]["records"] or \
                not bundle["routing_tail"] or \
                bundle["health"]["code"] != 503 or \
                bundle.get("section_errors"):
            raise SystemExit(f"incident I1: the bundle {bundles[0]}: "
                             f"trigger {bundle['trigger']}, events {names}, "
                             f"errors {bundle.get('section_errors')}")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = telemetry.main(["incident-report", path])
        report = text.getvalue()
        if rc != 0 or "breach interval" not in report or \
                "audit.mismatch" not in report or "503" not in report:
            raise SystemExit(f"incident I1: incident-report exit {rc}:\n"
                             f"{report}")
        event_ts = [e["ts"] for e in bundle["timeline"]["events"]
                    if e["name"] == "audit.mismatch"][0]
        written_s = bundle["time"] - event_ts
        out["I1"] = {"file": bundles[0], "found_s": found_s,
                     "written_after_event_s": written_s,
                     "event_after_call_s": event_ts - wall_mismatch,
                     "bytes": os.path.getsize(path), "sections": sorted(
                         bundle), "flight_records": len(
                         bundle["flight"]["records"]),
                     "routing_tail": len(bundle["routing_tail"]),
                     "report_lines": len(report.splitlines())}
        print(f"incident I1: the tick thread wrote one bundle "
              f"({out['I1']['bytes']} bytes) {written_s:.3f} s after the "
              f"mismatch event: {len(bundle['flight']['records'])} flight "
              f"records, {len(bundle['routing_tail'])} ledger entries; "
              f"incident-report renders it")
    finally:
        if srv is not None:
            srv.stop()
        sampling.set_enabled(None)
        os.environ.pop("PYRUHVRO_TPU_INCIDENT_DIR", None)
        shutil.rmtree(tmp, ignore_errors=True)

    # T1: the ticks' counter deltas over the phase re-sum to the counters
    timeline.tick_now()
    sec = timeline.snapshot_timeline()
    totals = {}
    for t in sec["ticks"]:
        for k, v in t["counters"].items():
            totals[k] = totals.get(k, 0.0) + v
    now = metrics.snapshot()
    # the tick counts itself after its record
    off = {k: (totals.get(k, 0.0), v) for k, v in now.items()
           if k != "timeline.ticks" and abs(totals.get(k, 0.0) - v) >
           1e-9 * max(1.0, abs(v))}
    if off:
        raise SystemExit(f"incident T1: deltas and counters differ: {off}")
    out["T1"] = {"ticks": len(sec["ticks"]), "counters": len(now),
                 "events": [e["name"] for e in sec["events"]]}
    print(f"incident T1: {len(sec['ticks'])} tick(s), the deltas of "
          f"{len(now)} counters re-sum to them; events "
          f"{out['T1']['events']}")
    return out


SERVING_ROWS = 100_000      # the serving phase: Kafka records
SERVING_REQUESTS = 64       # V1: requests of 1,000-4,000 records each
SERVING_THREADS = 4         # V1: threads submitting them
SERVING_TURNS = 2           # V1: rounds of A B B A (plane, one-shot calls)


def quantile(xs, q: float) -> float:
    """The ``q`` quantile of ``xs`` (nearest rank)."""
    ys = sorted(xs)
    return ys[min(len(ys) - 1, max(0, int(round(q * (len(ys) - 1)))))]


def serving_phase(api, pa, dm, em, data, schema, card):
    """The serving plane (``pyruhvro_tpu_torch/serving/``) on the card,
    under a schema string of its own, from ``telemetry.reset()``:

    * V1: ``SERVING_REQUESTS`` requests of 1,000-4,000 of ``data``'s
      records, submitted from ``SERVING_THREADS`` threads to a plane of
      two workers, against the same requests as one-shot
      ``deserialize_array`` calls from as many threads, in turns (A B B
      A, ``SERVING_TURNS`` times): every future equal to its one-shot
      call; K1/K2 launches counted from 0 over each round (per coalesced
      batch against per request); each request's end-to-end seconds
      (``serve.e2e_s`` and this script's own clock) beside the one-shot
      calls';
    * V2: ``PYRUHVRO_TPU_SERVE_POLICY=shed`` at depth 8: 12 requests, 4
      shed with ``Overloaded("queue_full")`` and a ``retry_after_s`` from
      the cost model, the drain's accounting balanced, equal results and
      ``serve.double_resolve`` 0;
    * V3: the brownout ladder engaged by a full queue and released once
      the workers drain it, seen in ``/healthz`` of the obs server both
      ways, the audit switched off and back on;
    * V4: three coalesced requests under ``on_error="skip"``, one with
      two rows poisoned: its entries rebased to its own indices, every
      member equal to its one-shot call; then a ``device_launch`` fault
      in a coalesced batch: every member's future raises
      ``FaultInjected``, and no call reaches the host tier;
    * V5: encode requests (K3 launches counted from 0): each future's
      wire equal to the one-shot call's and to the records; the Arrow
      Flight door's DoPut / DoGet round trip, or a line saying
      ``pyarrow.flight`` is unavailable.

    Every failure exits non-zero. Returns the phase's figures."""
    import os
    import threading

    import numpy as np

    from pyruhvro_tpu_torch import serving
    from pyruhvro_tpu_torch.runtime import audit, faults, metrics, obs_server
    from pyruhvro_tpu_torch.runtime import telemetry
    from pyruhvro_tpu_torch.serving import Overloaded, ServePlane
    from pyruhvro_tpu_torch.serving import flight as sfl

    doc = json.loads(schema)
    doc["doc"] = "serving phase"
    schema = json.dumps(doc)
    pipe = {"decode_walk": dm.walk_kernel,
            "decode_finalize": dm.finalize_kernel}
    enc = {"encode_rows": em.encode_kernel.rows,
           "encode_strings": em.encode_kernel.strings}
    host_keys = ("route.native", "route.fallback", "route.host",
                 "device.host_answer", "fallback.")
    out = {}
    serving.reset()
    telemetry.reset()
    rng = np.random.default_rng(0)
    sizes = rng.integers(1_000, 4_001, SERVING_REQUESTS)
    starts = rng.integers(0, len(data) - 4_000, SERVING_REQUESTS)
    reqs = [data[a:a + n] for a, n in zip(starts.tolist(), sizes.tolist())]

    def one_shot(rows, **kw):
        return api.deserialize_array(rows, schema, device=DEVICE, **kw)

    # V1: the plane against one-shot calls, in turns
    wants = [one_shot(r) for r in reqs]  # warms the buckets

    def fan(work):
        """``work(i)`` for every request, from SERVING_THREADS threads."""
        errors = []

        def run(k):
            try:
                for i in range(k, len(reqs), SERVING_THREADS):
                    work(i)
            except BaseException as e:  # reported below, the phase fails
                errors.append(e)

        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(SERVING_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise SystemExit(f"serving V1: {errors[0]!r}")

    plane = serving.start(workers=2)

    def served_round():
        e2e, futs = [None] * len(reqs), [None] * len(reqs)

        def submit(i):
            t0 = time.perf_counter()
            f = plane.submit("decode", reqs[i], schema, device=DEVICE,
                             timeout_s=120.0)

            def done(_f, i=i, t0=t0):
                e2e[i] = time.perf_counter() - t0

            f.add_done_callback(done)
            futs[i] = f

        b0 = metrics.snapshot().get("serve.batches", 0)
        zero(pipe)
        t0 = time.perf_counter()
        fan(submit)
        got = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        launches = launched("serving V1 (plane)", pipe)
        batches = metrics.snapshot().get("serve.batches", 0) - b0
        for i, (g, w) in enumerate(zip(got, wants)):
            same_columns(f"serving V1 request {i}", [g], [w])
        return {"wall_s": wall, "e2e_s": e2e, "launches": launches,
                "batches": batches}

    def one_shot_round():
        lat = [None] * len(reqs)

        def call(i):
            t0 = time.perf_counter()
            one_shot(reqs[i])
            lat[i] = time.perf_counter() - t0

        zero(pipe)
        t0 = time.perf_counter()
        fan(call)
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "e2e_s": lat,
                "launches": launched("serving V1 (one-shot)", pipe),
                "batches": len(reqs)}

    rounds = {"plane": [], "one_shot": []}
    for leg in ["plane", "one_shot", "one_shot", "plane"] * SERVING_TURNS:
        rounds[leg].append(served_round() if leg == "plane"
                           else one_shot_round())
    rep = serving.stop()
    hist = telemetry.snapshot()["histograms"].get("serve.e2e_s", {})
    v1 = {}
    for leg, rs in rounds.items():
        lat = [x for r in rs for x in r["e2e_s"]]
        batches = sum(r["batches"] for r in rs)
        k1 = sum(r["launches"]["decode_walk"] for r in rs)
        k2 = sum(r["launches"]["decode_finalize"] for r in rs)
        v1[leg] = {"p50_s": quantile(lat, 0.5), "p99_s": quantile(lat, 0.99),
                   "wall_s": [r["wall_s"] for r in rs],
                   "batches_per_round": batches / len(rs),
                   "k1_per_batch": k1 / batches, "k2_per_batch": k2 / batches,
                   "k1_per_request": k1 / (len(rs) * len(reqs)),
                   "k2_per_request": k2 / (len(rs) * len(reqs))}
    v1["serve_e2e_hist"] = {k: hist.get(k) for k in ("count", "p50", "p99")}
    v1["drain"] = rep
    v1["rows"] = int(sizes.sum())
    if rep["accepted"] != rep["completed"] or rep["failed"] or \
            metrics.snapshot().get("serve.double_resolve", 0):
        raise SystemExit(f"serving V1: the drain's accounting {rep}")
    out["V1"] = v1
    pl, os_ = v1["plane"], v1["one_shot"]
    print(f"serving V1: {SERVING_REQUESTS} requests of {sizes.min()}-"
          f"{sizes.max()} records ({v1['rows']:,} rows a round) from "
          f"{SERVING_THREADS} threads, equal to the one-shot calls; in turns "
          f"(A B B A x{SERVING_TURNS}): the plane {pl['batches_per_round']:.1f}"
          f" coalesced batches a round, K1/K2 {pl['k1_per_batch']:.2f}/"
          f"{pl['k2_per_batch']:.2f} per batch = {pl['k1_per_request']:.3f}/"
          f"{pl['k2_per_request']:.3f} per request, e2e p50 "
          f"{pl['p50_s'] * 1e3:.2f} ms p99 {pl['p99_s'] * 1e3:.2f} ms, rounds "
          f"{[round(x, 3) for x in pl['wall_s']]} s; one-shot K1/K2 "
          f"{os_['k1_per_request']:.3f}/{os_['k2_per_request']:.3f} per "
          f"request, p50 {os_['p50_s'] * 1e3:.2f} ms p99 "
          f"{os_['p99_s'] * 1e3:.2f} ms, rounds "
          f"{[round(x, 3) for x in os_['wall_s']]} s; serve.e2e_s "
          f"histogram {v1['serve_e2e_hist']}; drain {rep} {card}")

    knob_env = {}

    def knob(name, value):
        knob_env.setdefault(name, os.environ.get(name))
        os.environ[name] = value

    def restore():
        for name, value in knob_env.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        knob_env.clear()

    # V2: shed at depth 8
    try:
        knob("PYRUHVRO_TPU_SERVE_POLICY", "shed")
        knob("PYRUHVRO_TPU_SERVE_QUEUE", "8")
        knob("PYRUHVRO_TPU_SERVE_TENANT_SHARE", "0")
        p = ServePlane(autostart=False)
        futs, shed = [], []
        for i in range(12):
            try:
                futs.append((i, p.submit("decode", reqs[i], schema,
                                         device=DEVICE, timeout_s=120.0)))
            except Overloaded as e:
                shed.append({"reason": e.reason, "queued": e.queued,
                             "retry_after_s": e.retry_after_s})
        t0 = time.perf_counter()
        rep = p.drain()
        drain_s = time.perf_counter() - t0
    finally:
        restore()
    for i, f in futs:
        same_columns(f"serving V2 request {i}", [f.result(timeout=0)],
                     [wants[i]])
    c = metrics.snapshot()
    if len(shed) != 4 or {s["reason"] for s in shed} != {"queue_full"} or \
            any(s["retry_after_s"] is None or s["retry_after_s"] <= 0
                for s in shed) or rep["accepted"] != 8 or \
            rep["completed"] != 8 or rep["drained"] != 8 or \
            c.get("serve.double_resolve", 0):
        raise SystemExit(f"serving V2: shed {shed}, drain {rep}")
    out["V2"] = {"shed": shed, "drain": rep, "drain_s": drain_s,
                 "double_resolve": c.get("serve.double_resolve", 0)}
    print(f"serving V2: shed policy at depth 8, 12 requests: 8 accepted, 4 "
          f"shed queue_full with retry_after_s "
          f"{[round(s['retry_after_s'], 4) for s in shed]} (the cost model's "
          f"drain estimate); the drain {drain_s:.3f} s {rep}, results equal, "
          f"serve.double_resolve 0 {card}")

    # V3: the brownout ladder, seen in /healthz
    srv = obs_server.ObsServer(port=0).start()
    try:
        knob("PYRUHVRO_TPU_SERVE_POLICY", "shed")
        knob("PYRUHVRO_TPU_SERVE_QUEUE", "4")
        knob("PYRUHVRO_TPU_SERVE_BROWNOUT", "0.1")
        knob("PYRUHVRO_TPU_SERVE_BROWNOUT_SUSTAIN", "1")
        knob("PYRUHVRO_TPU_SERVE_TENANT_SHARE", "0")
        audit_before = audit.enabled()
        p = ServePlane(workers=2, autostart=False)
        serving._plane = p  # the plane /healthz reads
        for i in range(4):
            p.submit("decode", reqs[i], schema, device=DEVICE,
                     timeout_s=120.0)
        time.sleep(0.05)  # past the ladder's tick throttle
        try:
            p.submit("decode", reqs[4], schema, device=DEVICE,
                     timeout_s=120.0)
            raise SystemExit("serving V3: a full queue admitted a request")
        except Overloaded:
            pass
        code, body = http_get(srv.url + "/healthz")
        engaged = json.loads(body)["degraded_bits"]["brownout"]
        audit_off = audit.enabled()
        t0 = time.perf_counter()
        p.start_workers()
        while p.engaged_rungs() and time.perf_counter() - t0 < 60:
            time.sleep(0.01)
        released_s = time.perf_counter() - t0
        code2, body2 = http_get(srv.url + "/healthz")
        after = json.loads(body2)["degraded_bits"]["brownout"]
        rep = p.drain()
        c = metrics.snapshot()
        counts = {k: c.get(k, 0) for k in c
                  if k.startswith("serve.brownout")}
    finally:
        restore()
        serving.reset()
        srv.stop()
    if engaged != list(serving.BROWNOUT_RUNGS) or after or audit_off or \
            audit.enabled() != audit_before or rep["completed"] != 4 or \
            any(counts.get(f"serve.brownout.{r}") != 1 or
                counts.get(f"serve.brownout_release.{r}") != 1
                for r in serving.BROWNOUT_RUNGS):
        raise SystemExit(f"serving V3: /healthz brownout {engaged} then "
                         f"{after}, audit {audit_before} -> {audit_off} -> "
                         f"{audit.enabled()}, counters {counts}, drain {rep}")
    out["V3"] = {"engaged": engaged, "released_after_s": released_s,
                 "healthz": [code, code2], "counters": counts}
    print(f"serving V3: a full queue (depth 4) engaged every brownout rung, "
          f"/healthz {code} degraded_bits.brownout {engaged} (audit off); "
          f"the workers drained it and every rung released in "
          f"{released_s:.3f} s, /healthz {code2} brownout {after} (audit "
          f"on again) {card}")

    # V4: a poisoned member rebased; a launch fault in every member
    members = [list(reqs[i]) for i in range(3)]
    bad = [5, len(members[1]) - 7]
    for j in bad:
        members[1][j] = b"\x01"
    p = ServePlane(autostart=False)
    b0 = metrics.snapshot().get("serve.batches", 0)
    futs = [p.submit("decode", m, schema, device=DEVICE, on_error="skip",
                     return_errors=True, timeout_s=120.0) for m in members]
    p.drain()
    batches = metrics.snapshot().get("serve.batches", 0) - b0
    entries = []
    for i, (f, m) in enumerate(zip(futs, members)):
        got, quar = f.result(timeout=0)
        want, want_q = one_shot(m, on_error="skip", return_errors=True)
        same_columns(f"serving V4 member {i}", [got], [want])
        if entry_fields(quar) != entry_fields(want_q):
            raise SystemExit(f"serving V4: member {i}'s entries "
                             f"{entry_fields(quar)} against the one-shot "
                             f"call's {entry_fields(want_q)}")
        entries.append([(q.index, q.error, q.tier) for q in quar])
    if batches != 1 or [e[0] for e in entries[1]] != bad or entries[0] or \
            entries[2] or {e[2] for e in entries[1]} != {"device"}:
        raise SystemExit(f"serving V4: {batches} batches, entries {entries}")
    c0 = metrics.snapshot()
    try:
        knob("PYRUHVRO_TPU_FAULTS", "device_launch:error:1")
        p = ServePlane(autostart=False)
        futs = [p.submit("decode", reqs[i], schema, device=DEVICE,
                         timeout_s=120.0) for i in range(3)]
        rep = p.drain()
    finally:
        restore()
        faults.reset()
    raised = []
    for f in futs:
        e = f.exception(timeout=0)
        raised.append(type(e).__name__)
    c1 = metrics.snapshot()
    delta = {k: c1[k] - c0.get(k, 0) for k in c1
             if c1[k] != c0.get(k, 0) and k.startswith(
                 ("serve.", "fault.", "route.", "device.host_answer",
                  "fallback."))}
    if raised != ["FaultInjected"] * 3 or rep["failed"] != 3 or \
            delta.get("serve.worker_degraded") != 1 or \
            delta.get("serve.serial_calls") != 3 or \
            any(k.startswith(host_keys) for k in delta):
        raise SystemExit(f"serving V4: a launch fault raised {raised}, "
                         f"drain {rep}, counters {delta}")
    out["V4"] = {"entries": entries, "fault_raised": raised,
                 "fault_counters": delta}
    print(f"serving V4: three requests under on_error='skip' coalesced into "
          f"one batch, the poisoned member's entries {entries[1]} at its "
          f"own indices, every member equal to its one-shot call; a "
          f"device_launch fault in a coalesced batch: every future raised "
          f"{raised[0]}, counters {delta}, nothing on the host {card}")

    # V5: encode requests, and the Flight door
    batch = one_shot(data[:16_000])
    slices = [batch.slice(i * 2_000, 2_000) for i in range(8)]
    p = serving.start(workers=2)
    zero(enc)
    futs = [p.submit("encode", b, schema, device=DEVICE, num_chunks=1,
                     timeout_s=120.0) for b in slices]
    got = [f.result(timeout=300) for f in futs]
    launches = launched("serving V5", enc)
    for i, (g, b) in enumerate(zip(got, slices)):
        if wire_of(g) != wire_of(api.serialize_record_batch(
                b, schema, 1, device=DEVICE)) \
                or wire_of(g) != data[i * 2_000:(i + 1) * 2_000]:
            raise SystemExit(f"serving V5: encode request {i}'s wire "
                             f"differs")
    out["V5"] = {"encode_launches": launches}
    if sfl.flight_available():
        import pyarrow.flight as fl

        server = sfl.start_flight_server("grpc://127.0.0.1:0")
        try:
            client = fl.connect(f"grpc://127.0.0.1:{server.port}")
            rows = data[:2_000]
            wire = pa.record_batch([pa.array(rows, type=pa.binary())],
                                   names=["wire"])
            t0 = time.perf_counter()
            writer, meta = client.do_put(fl.FlightDescriptor.for_command(
                json.dumps({"schema": schema, "tenant": "flight",
                            "device": DEVICE,
                            "timeout_s": 120.0}).encode()), wire.schema)
            writer.write_batch(wire)
            writer.done_writing()
            ticket = meta.read().to_pybytes()
            writer.close()
            table = client.do_get(fl.Ticket(ticket)).read_all()
            flight_s = time.perf_counter() - t0
        finally:
            server.shutdown()
        want = pa.Table.from_batches([one_shot(rows)])
        if table.to_pylist() != want.to_pylist():
            raise SystemExit("serving V5: the Flight round trip differs")
        out["V5"]["flight_s"] = flight_s
        flight = (f"the Flight DoPut/DoGet round trip of {len(rows)} "
                  f"records in {flight_s:.3f} s, equal")
    else:
        out["V5"]["flight_s"] = None
        flight = "pyarrow.flight is unavailable: no Flight round trip"
    out["V5"]["drain"] = serving.stop()
    print(f"serving V5: 8 encode requests of 2,000 rows, launches "
          f"{launches}, each wire equal to the one-shot call's and to the "
          f"records; {flight} {card}")
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
    from pyruhvro_tpu_torch.ops import codec as codec_mod
    from pyruhvro_tpu_torch import parallel as par
    from pyruhvro_tpu_torch.parallel import sharded_encode as pse
    from pyruhvro_tpu_torch.hostpath import specialize
    from pyruhvro_tpu_torch.hostpath.program import lower_host
    from pyruhvro_tpu_torch.ops.arrow_build import build_record_batch
    from pyruhvro_tpu_torch.ops.codec import _concat_batches, get_device_codec
    import pyruhvro_tpu_torch as port
    from pyruhvro_tpu_torch import api as port_api
    from pyruhvro_tpu_torch.runtime import (
        capacity,
        ingest,
        native,
        telemetry,
        traceprop,
    )
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

    def build_native(key):
        try:
            libs[key] = native.load(key)
        except Exception as e:  # reported below, the smoke then fails
            failures.append(f"{key}: {e}")

    # the host tier's specialised units of the paths' schemas (built at
    # a codec's first call past PYRUHVRO_TPU_SPECIALIZE_ROWS otherwise)
    spec_schemas = {"kafka": datagen.KAFKA_SCHEMA_JSON,
                    "arr_rec_arr": PIPELINE_SHAPES["arr_rec_arr"]}
    units = {}

    def build_unit(key):
        try:
            prog = lower_host(parse_schema(spec_schemas[key]))
            name = specialize.module_name(prog)
            fresh = not list(specialize.spec_dir().glob(name + ".*so"))
            t0 = time.perf_counter()
            specialize.load_specialized(prog)
            units[key] = {"module": name, "fresh": fresh,
                          "s": time.perf_counter() - t0}
        except Exception as e:  # reported below, the smoke then fails
            failures.append(f"specialised unit {key}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(k,)) for k in kernels]
    threads += [threading.Thread(target=build_native, args=(k,))
                for k in native.SOURCES]
    threads += [threading.Thread(target=build_unit, args=(k,))
                for k in spec_schemas]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise SystemExit("build failed: " + "; ".join(failures))
    print(f"build: {len(libs)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for key in native.SOURCES:
        lib = libs.pop(key)
        print(f"build: {' '.join(lib.command)} ({lib.path.name}) in "
              f"{lib.build_s:.2f} s")
    for key, u in units.items():
        print(f"build: g++ specialised unit {u['module']} ({key}) "
              f"{'built' if u['fresh'] else 'reused from build/'} in "
              f"{u['s']:.2f} s")
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

    # 5d. the native host tier against the card
    t0 = time.perf_counter()
    host = host_phase(port_api, data, nested, large,
                      enc_batches["kafka_encode"][0], nested_schema, card,
                      units)
    print(f"host phase: {time.perf_counter() - t0:.1f} s")

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

    # 7. the observability base: telemetry on and off, the launch registry
    # beside this script's kernel times, trace_ctx, the exporters
    t0 = time.perf_counter()
    tel = telemetry_phase(
        port, torch, telemetry, traceprop, dm, em, data, kafka,
        {kind: {"queued": k["queued_ms"], "idle": k["ms"]}
         for kind, k in (("walk", k1), ("finalize", k2), ("walk_decode", k4),
                         ("encode_rows", k3_rows),
                         ("encode_strings", k3_strings))},
        here, card)
    print(f"telemetry phase: {time.perf_counter() - t0:.1f} s")

    # 8. the routing plane: backend="auto", the process pool, autotune,
    # persisted capacity plans, the host answers
    t0 = time.perf_counter()
    route = route_phase(port, pa, dm, em, data, kafka,
                        enc_batches["kafka_encode"][0], large,
                        results["kafka"]["warm_launches"], here, card)
    print(f"route phase: {time.perf_counter() - t0:.1f} s")

    # 9. the chunk fan-out (K5): every visible card, and MULTI_SHARDS
    # shards on card 0
    t0 = time.perf_counter()
    multi = multichip_phase(port, torch, dm, em, par, pse, codec_mod,
                            parse_schema, get_or_parse_schema, data, nested,
                            enc_batches["kafka_encode"][0], kafka,
                            nested_schema, card)
    print(f"multichip phase: {time.perf_counter() - t0:.1f} s")

    # 10. the planes above the codec: null items, fault seams, the
    # interleaving harness, deep sampling, SLOs and the flight recorder
    t0 = time.perf_counter()
    planes = planes_phase(port, torch, dm, em, data[:PLANES_ROWS], kafka,
                          here, card)
    print(f"planes phase: {time.perf_counter() - t0:.1f} s")

    # 11. the incident plane: the audit shadow of the card's decode and
    # encode, the obs server, incident bundles and the timeline
    t0 = time.perf_counter()
    incident = incident_phase(port, pa, dm, em, data[:INCIDENT_ROWS], kafka,
                              card)
    incident["phase_s"] = time.perf_counter() - t0
    print(f"incident phase: {incident['phase_s']:.1f} s")

    # 12. the serving plane: coalesced requests against one-shot calls,
    # shedding, the brownout ladder, a poisoned member and a launch fault,
    # encode requests and the Flight door
    t0 = time.perf_counter()
    serve = serving_phase(port, pa, dm, em, data[:SERVING_ROWS], kafka,
                          card)
    serve["phase_s"] = time.perf_counter() - t0
    print(f"serving phase: {serve['phase_s']:.1f} s")

    # 13. memory accounting, the cache lifecycle and tenant=, the OTLP
    # exporter and the fleet merge, against the card's arenas and buckets
    t0 = time.perf_counter()
    memory = memory_phase(port, pa, torch, dm, em, data, kafka, card)
    memory["phase_s"] = time.perf_counter() - t0
    print(f"memory phase: {memory['phase_s']:.1f} s")

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
    m1 = multi["M1"]
    big = m1["largest"]
    rows.append(
        {"name": "sharded_fanout", "route": "cuda",
         "source": "pyruhvro_tpu_torch/parallel/sharded.py",
         "replaces": "pyruhvro_tpu/parallel/sharded.py:144",
         "replaces_function": "ShardedDecoder._sharded_fn (per_shard; "
                              "sharded_encode.py:81 for encode)",
         "launches": sum(m1["launches"].values()), "max_abs_err": 0,
         "ms": sum(m1["kernel_ms"][big]), "plain_ms": m1["plain_ms"],
         "bound_ms": m1["bound_ms"][big], "bound_by": "bytes",
         "library_ms": None, "shards": m1["shards"],
         "launches_by_kernel": m1["launches"],
         "shard_k1_k2_ms": m1["kernel_ms"],
         "d8_shard_k1_k2_ms": multi["M2"]["kernel_ms"],
         "d8_encode_launches": multi["M4"]["launches"],
         "bit_equal": True})
    print(json.dumps({"host": host}))
    print(json.dumps({"telemetry": tel}))
    print(json.dumps({"route": route}))
    print(json.dumps({"multichip": multi}))
    print(json.dumps({"planes": planes}))
    print(json.dumps({"incident": incident}, default=str))
    print(json.dumps({"serving": serve}, default=str))
    print(json.dumps({"memory": memory}, default=str))
    print(json.dumps({"paths": {k: {**v, "warm_median_s": statistics.median(
        v["warm_s"])} for k, v in results.items()}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
