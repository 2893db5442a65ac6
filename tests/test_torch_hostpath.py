"""The port's native host tier held against the reference's, on the CPU.

``pyruhvro_tpu_torch.hostpath`` (the opcode program, the C++ VM built from
``csrc/host/``, ``NativeHostCodec``) against ``pyruhvro_tpu.hostpath`` with
the reference's specialiser and superoptimizer off
(``PYRUHVRO_TPU_NO_SPECIALIZE=1``, ``PYRUHVRO_TPU_NO_OPT=1``, the arm the
port copies), and against the pure-Python oracle: the lowering, decode on
the fused and plan-buffer lanes, the chunked modes (the shard runner
against the reference's shard runner and its one decode per chunk, one
decode sliced) with ``_PER_CHUNK_ROWS`` lowered in both packages,
malformed records, encode on the native-extract and
``host_mode`` lanes, the ``backend="host"`` routing and its error
policies, a failed build, and where the build reads its sources. Decode
and encode are integer and byte work: the tolerance is 0. Records come
from ``utils/datagen`` and mutations are placed by a numpy seed. Each
package's codecs are built once per module.
"""

import os
import re
import shutil
from decimal import Decimal
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.gate import host_supported as ref_host_supported  # noqa: E402
from pyruhvro_tpu.hostpath import program as ref_program  # noqa: E402
from pyruhvro_tpu.hostpath.codec import NativeHostCodec as RefCodec  # noqa: E402
from pyruhvro_tpu.ops import UnsupportedOnDevice as RefUnsupported  # noqa: E402
from pyruhvro_tpu.ops.decode import BatchTooLarge as RefTooLarge  # noqa: E402
from pyruhvro_tpu.runtime import knobs as ref_knobs  # noqa: E402
from pyruhvro_tpu.runtime.ingest import DatumView as RefView  # noqa: E402
from pyruhvro_tpu.schema.cache import get_or_parse_schema as ref_entry  # noqa: E402
from pyruhvro_tpu.utils.datagen import (  # noqa: E402
    WIDENED_SCHEMA_JSON,
    widened_datums,
)

import chip_smoke  # noqa: E402
import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch import api  # noqa: E402
from pyruhvro_tpu_torch.errors import BatchTooLarge  # noqa: E402
from pyruhvro_tpu_torch.fallback.decoder import decode_to_record_batch  # noqa: E402
from pyruhvro_tpu_torch.fallback.encoder import (  # noqa: E402
    compile_encoder_plan,
    encode_record_batch,
)
from pyruhvro_tpu_torch.gate import host_supported  # noqa: E402
from pyruhvro_tpu_torch.hostpath import program  # noqa: E402
from pyruhvro_tpu_torch.hostpath.codec import NativeHostCodec  # noqa: E402
from pyruhvro_tpu_torch.ops import UnsupportedOnDevice  # noqa: E402
from pyruhvro_tpu_torch.runtime import deadline, knobs, metrics, native, pool  # noqa: E402
from pyruhvro_tpu_torch.runtime.ingest import DatumView  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KAFKA = datagen.KAFKA_SCHEMA_JSON
NESTED = chip_smoke.PIPELINE_SHAPES["arr_rec_arr"]
SHAPES = {"kafka": KAFKA, **datagen.CRITERION_SHAPES, "arr_rec_arr": NESTED,
          "widened": WIDENED_SCHEMA_JSON}
# every logical type the host VM adds, local-timestamp-millis included
LOWER_ONLY = """{"type":"record","name":"Lw","fields":[
  {"name":"b","type":"bytes"},
  {"name":"f","type":{"type":"fixed","name":"F5","size":5}},
  {"name":"dur","type":{"type":"fixed","name":"D12","size":12,
      "logicalType":"duration"}},
  {"name":"db","type":{"type":"bytes","logicalType":"decimal",
      "precision":38,"scale":3}},
  {"name":"df","type":["null",{"type":"fixed","name":"DF","size":16,
      "logicalType":"decimal","precision":30,"scale":1}]},
  {"name":"u","type":{"type":"string","logicalType":"uuid"}},
  {"name":"tm","type":{"type":"int","logicalType":"time-millis"}},
  {"name":"tu","type":{"type":"long","logicalType":"time-micros"}},
  {"name":"ltm","type":{"type":"long","logicalType":"local-timestamp-millis"}},
  {"name":"ltu","type":{"type":"long","logicalType":"local-timestamp-micros"}},
  {"name":"m","type":{"type":"map","values":{"type":"array","items":
      ["null","string",{"type":"enum","name":"E","symbols":["A","B"]}]}}}]}"""
WIDE_FIXED_DECIMAL = ('{"type":"record","name":"W17","fields":[{"name":"d",'
                      '"type":{"type":"fixed","name":"F17","size":17,'
                      '"logicalType":"decimal","precision":38,"scale":0}}]}')
NULLABLE = datagen.CRITERION_SHAPES["nullable_primitives"]
FIXED_DECIMAL = ('{"type":"record","name":"FD2","fields":[{"name":"d","type":'
                 '{"type":"fixed","name":"F2","size":2,"logicalType":"decimal",'
                 '"precision":5,"scale":0}}]}')
NULL_FIXED_DECIMAL = ('{"type":"record","name":"NFD2","fields":[{"name":"d",'
                      '"type":["null",{"type":"fixed","name":"G2","size":2,'
                      '"logicalType":"decimal","precision":5,"scale":0}]}]}')


def lane_count(key: str) -> float:
    """A lane counter of the port's metrics since the last reset."""
    return metrics.snapshot().get(key, 0.0)


@pytest.fixture(scope="module", autouse=True)
def _reference_raw_program():
    """The reference's raw-program arm, which the port copies."""
    before = {k: os.environ.get(k) for k in ("PYRUHVRO_TPU_NO_SPECIALIZE",
                                             "PYRUHVRO_TPU_NO_OPT")}
    for k in before:
        os.environ[k] = "1"
    yield
    for k, v in before.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def codecs(_reference_raw_program):
    """``schema → (port entry, port codec, reference codec)``, built once."""
    memo = {}

    def get(schema):
        if schema not in memo:
            e, r = get_or_parse_schema(schema), ref_entry(schema)
            memo[schema] = (e, NativeHostCodec(e.ir, e.arrow_schema),
                            RefCodec(r.ir, r.arrow_schema))
        return memo[schema]

    return get


def datums_of(name, n, seed):
    if name == "kafka":
        return datagen.kafka_style_datums(n, seed=seed)
    if name == "widened":
        return widened_datums(n, seed=seed)
    ir = get_or_parse_schema(SHAPES[name]).ir
    return datagen.random_datums(ir, n, seed=seed)


def oracle(e, datums):
    return decode_to_record_batch(datums, e.ir, e.arrow_schema)


def same(got, want):
    """Equal by value (``to_pylist``: sliced sparse unions can pass
    ``equals`` with other values) and by schema."""
    assert got.schema.equals(want.schema)
    assert got.num_rows == want.num_rows
    assert got.to_pylist() == want.to_pylist()


def wire(arrays):
    if isinstance(arrays, pa.Array):
        arrays = [arrays]
    return [bytes(x) for a in arrays for x in a.to_pylist()]


def fields(entries):
    return [(q.index, q.datum, q.error, q.tier) for q in entries]


# -- (a) the lowering -------------------------------------------------------------


@pytest.mark.parametrize("name", list(SHAPES) + ["lower_only"])
def test_lowering_equals_the_reference(name):
    schema = LOWER_ONLY if name == "lower_only" else SHAPES[name]
    got = program.lower_host(get_or_parse_schema(schema).ir)
    want = ref_program.lower_host(ref_entry(schema).ir)
    assert np.array_equal(got.ops, want.ops)
    assert got.ops.dtype == want.ops.dtype
    assert np.array_equal(got.coltypes, want.coltypes)
    assert got.op_aux == want.op_aux
    assert got.regions == want.regions
    assert got.region_parents == want.region_parents
    assert [(c.key, c.ctype, c.region) for c in got.cols] == \
        [(c.key, c.ctype, c.region) for c in want.cols]
    assert got.buffer_plan() == want.buffer_plan()


def test_outside_the_subset_raises_in_both():
    for schema in (WIDE_FIXED_DECIMAL,
                   '{"type":"record","name":"B39","fields":[{"name":"d","type":'
                   '{"type":"bytes","logicalType":"decimal","precision":39,'
                   '"scale":0}}]}'):
        assert not host_supported(get_or_parse_schema(schema).ir)
        assert not ref_host_supported(ref_entry(schema).ir)
        with pytest.raises(UnsupportedOnDevice, match="host VM subset"):
            program.lower_host(get_or_parse_schema(schema).ir)
        with pytest.raises(RefUnsupported, match="host VM subset"):
            ref_program.lower_host(ref_entry(schema).ir)
    for schema in list(SHAPES.values()) + [LOWER_ONLY]:
        assert host_supported(get_or_parse_schema(schema).ir)


# the port's own routing profile: the two packages' tests share one
# checkout and must never read each other's profile (ROADMAP.md (c) 9)
KNOB_DEPARTURES = {
    "PYRUHVRO_TPU_ROUTING_PROFILE": ("ROUTING_PROFILE.torch.json",
                                     "ROUTING_PROFILE.json"),
}


def test_knob_defaults_are_the_reference():
    registry = ref_knobs.registry()
    assert "PYRUHVRO_TPU_NO_NATIVE" in knobs.DEFAULTS
    assert {"PYRUHVRO_TPU_PALLAS", "PYRUHVRO_TPU_SHARD_THREADS",
            "PYRUHVRO_TPU_QUARANTINE_STORM"} <= set(knobs.registry())
    for name, default in knobs.DEFAULTS.items():
        if name in KNOB_DEPARTURES:
            assert (default, registry[name].default) == \
                KNOB_DEPARTURES[name], name
            continue
        assert default == registry[name].default, name
    for name, choices in knobs.CHOICES.items():
        assert choices == registry[name].choices, name


# -- (b) decode -------------------------------------------------------------------


def plan_decode(c, data, nthreads=0):
    """The plan-buffer lane, which serves the batches the fused pass
    declines: the VM's ``decode`` and the Python assembly."""
    native_data = (data.native_parts() if hasattr(data, "native_parts")
                   else data)
    bufs, err_rec, err_bits = c._mod.decode(c.prog.ops, c.prog.coltypes,
                                            native_data, nthreads)
    c._raise_malformed(err_rec, err_bits)
    return c._plan_batch(bufs, len(data))


@pytest.mark.parametrize("lane", ["fused", "plan"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_decode_equals_the_reference_and_the_oracle(name, lane, codecs,
                                                    monkeypatch):
    if lane == "plan":
        # the reference's knob for its own plan-buffer lane
        monkeypatch.setenv("PYRUHVRO_TPU_NO_FUSED_DECODE", "1")
        dec = (lambda d, **kw: plan_decode(c, d, **kw))
    else:
        dec = (lambda d, **kw: c.decode(d, **kw))
    e, c, r = codecs(SHAPES[name])
    datums = datums_of(name, 300, seed=7)
    metrics.reset()
    got = dec(datums)
    same(got, r.decode(datums))
    same(got, oracle(e, datums))
    if lane == "plan":
        assert lane_count("decode.fused") == 0
    else:
        assert lane_count("decode.fused") \
            + lane_count("decode.fused_fallback") \
            == 1
    # a BinaryArray reaches the VM through its buffers, a slice of it too
    arr = pa.array(datums, pa.binary())
    same(dec(DatumView(arr)), got)
    same(dec(DatumView(arr.slice(37, 150))), got.slice(37, 150))
    same(dec(datums, nthreads=3), got)


def test_native_parts_are_the_reference():
    arr = pa.array(datagen.kafka_style_datums(40, seed=2), pa.binary())
    for a in (arr, arr.slice(5, 20), pa.array([], pa.binary()),
              pa.array([b""] * 3, pa.large_binary())):
        got, want = DatumView(a).native_parts(), RefView(a).native_parts()
        assert got[0] == want[0] and got[3:] == want[3:]
        assert bytes(got[1]) == bytes(want[1])
        assert bytes(got[2]) == bytes(want[2])


def test_uuid_text_forms_and_invalid_utf8(codecs):
    """Exotic uuid texts decline the fused lane: the Python assembly
    serves them, as in the reference; invalid text raises the same."""
    from pyruhvro_tpu_torch.fallback.io import write_long

    e, c, r = codecs('{"type":"record","name":"UU","fields":[{"name":"u",'
                     '"type":{"type":"string","logicalType":"uuid"}}]}')

    def mk(text):
        b = bytearray()
        write_long(b, len(text))
        return bytes(b + text)

    good = [mk(b"12345678-1234-5678-1234-567812345678"),
            mk(b"{ABCDEF00-1234-5678-1234-567812345678}"),
            mk(b"12345678123456781234567812345678")]
    metrics.reset()
    got = c.decode(good)
    assert lane_count("decode.fused_fallback") == 1
    same(got, r.decode(good))
    same(got, oracle(e, good))
    for bad in ([mk(b"junk")], [mk(b"\xff\xfe")]):
        with pytest.raises(ValueError) as got:
            c.decode(bad)
        with pytest.raises(ValueError) as want:
            r.decode(bad)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)
    s, _c, rs = codecs('{"type":"record","name":"S","fields":['
                       '{"name":"s","type":"string"}]}')
    with pytest.raises(ValueError) as got:
        _c.decode([b"\x04\xff\xfe"])
    with pytest.raises(ValueError) as want:
        rs.decode([b"\x04\xff\xfe"])
    assert str(got.value) == str(want.value) and "UTF-8" in str(got.value)


@pytest.mark.parametrize("mode", ["shards", "per_chunk", "slice"])
@pytest.mark.parametrize("name", ["kafka", "arr_rec_arr", "widened"])
def test_decode_threaded_equals_the_reference(name, mode, codecs,
                                              monkeypatch):
    if mode != "slice":
        monkeypatch.setattr(NativeHostCodec, "_PER_CHUNK_ROWS", 8)
        monkeypatch.setattr(RefCodec, "_PER_CHUNK_ROWS", 8)
    if mode == "per_chunk":
        # the reference's one decode per chunk against the port's one call
        # through the shard runner
        monkeypatch.setenv("PYRUHVRO_TPU_NO_NATIVE_SHARDS", "1")
    e, c, r = codecs(SHAPES[name])
    datums = datums_of(name, 101, seed=3)
    metrics.reset()
    got = c.decode_threaded(datums, 4)
    want = r.decode_threaded(datums, 4, pool="shard" if mode == "shards"
                             else "thread")
    assert [b.num_rows for b in got] == [25, 25, 25, 26]
    for g, w in zip(got, want):
        same(g, w)
    whole = oracle(e, datums)
    for g, (a, b) in zip(got, [(0, 25), (25, 50), (50, 75), (75, 101)]):
        same(g, whole.slice(a, b - a))
    assert lane_count("shard.native") == (mode != "slice")


# -- (c) malformed records --------------------------------------------------------


def mutate(rng, d: bytes, kind: int) -> bytes:
    """One of 8 mutations of a datum: byte overwrites (one byte, a run of
    0xff), truncations (one byte off, to half), appended bytes (one, a
    run), bit flips (one bit, three bits)."""
    b = bytearray(d)
    at = int(rng.integers(0, max(len(b), 1)))
    if kind == 0 and b:
        b[at] = int(rng.integers(0, 256))
    elif kind == 1 and b:
        b[at:at + 4] = b"\xff" * len(b[at:at + 4])
    elif kind == 2:
        b = b[:-1]
    elif kind == 3:
        b = b[:len(b) // 2]
    elif kind == 4:
        b += bytes([int(rng.integers(0, 256))])
    elif kind == 5:
        b += bytes(rng.integers(0, 256, size=5).astype(np.uint8))
    elif kind == 6 and b:
        b[at] ^= 1 << int(rng.integers(0, 8))
    elif kind == 7 and b:
        for _ in range(3):
            j = int(rng.integers(0, len(b)))
            b[j] ^= 1 << int(rng.integers(0, 8))
    return bytes(b)


def outcome(fn):
    try:
        return "ok", [b.to_pylist() for b in fn()]
    except (ValueError, OverflowError) as e:
        return "err", (type(e).__name__, str(e),
                       getattr(e, "index", None),
                       getattr(e, "err_name", None),
                       getattr(e, "tier", None))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["kafka", "arr_rec_arr"])
def test_malformed_records_raise_as_the_reference(name, seed, codecs,
                                                  monkeypatch):
    e, c, r = codecs(SHAPES[name])
    rng = np.random.default_rng(seed)
    clean = datums_of(name, 120, seed=seed + 11)
    monkeypatch.setattr(NativeHostCodec, "_PER_CHUNK_ROWS", 8)
    monkeypatch.setattr(RefCodec, "_PER_CHUNK_ROWS", 8)
    errors = 0
    for kind in range(8):
        data = list(clean)
        for j in sorted(rng.choice(len(data), 2, replace=False)):
            data[j] = mutate(rng, data[j], kind)
        got = outcome(lambda: [c.decode(data)])
        assert got == outcome(lambda: [r.decode(data)]), kind
        errors += got[0] == "err"
        if got[0] == "err" and got[1][3] is not None:
            assert got[1][4] == "native"
        # global indices from the shard runner, against the reference's
        assert outcome(lambda: c.decode_threaded(data, 4)) == outcome(
            lambda: r.decode_threaded(data, 4, pool="shard")), kind
    assert errors >= 4


# -- (d) encode -------------------------------------------------------------------


@pytest.mark.parametrize("lane", ["native", "host_mode"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_encode_equals_the_reference_and_the_oracle(name, lane, codecs,
                                                    monkeypatch):
    if lane == "host_mode":
        # the reference's knob for its own host_mode lane
        monkeypatch.setenv("PYRUHVRO_TPU_NO_NATIVE_EXTRACT", "1")
    e, c, r = codecs(SHAPES[name])
    datums = datums_of(name, 300, seed=5)
    batch = oracle(e, datums)
    metrics.reset()
    got = wire(c.encode(batch) if lane == "native"
               else c._encode_host_mode(batch, batch.num_rows))
    assert got == datums
    assert got == wire(r.encode(batch))
    assert got == [bytes(d) for d in encode_record_batch(
        batch, e.ir, compile_encoder_plan(e.ir))]
    assert lane_count("extract.native") == (lane == "native")
    chunks = c.encode_threaded(batch, 3)
    assert [len(a) for a in chunks] == [100, 100, 100]
    assert wire(chunks) == datums


@pytest.mark.parametrize("lane", ["native", "host_mode"])
def test_encode_value_errors_are_the_reference(lane, codecs, monkeypatch):
    if lane == "host_mode":
        # the reference's knob for its own host_mode lane
        monkeypatch.setenv("PYRUHVRO_TPU_NO_NATIVE_EXTRACT", "1")
    cases = [
        (FIXED_DECIMAL, pa.RecordBatch.from_pydict(
            {"d": pa.array([Decimal(1), Decimal(99999)],
                           pa.decimal128(5, 0))})),
        ('{"type":"record","name":"BD","fields":[{"name":"d","type":'
         '{"type":"bytes","logicalType":"decimal","precision":3,"scale":0}}]}',
         pa.RecordBatch.from_pydict(
             {"d": pa.array([Decimal(1), Decimal(12345)],
                            pa.decimal128(5, 0))})),
        ('{"type":"record","name":"S","fields":[{"name":"s","type":"string"}]}',
         pa.RecordBatch.from_pydict({"s": pa.array(["a", None], pa.utf8())})),
        ('{"type":"record","name":"S","fields":[{"name":"s","type":"string"}]}',
         pa.RecordBatch.from_pydict({"t": pa.array(["x"])})),
    ]
    for schema, batch in cases:
        _e, c, r = codecs(schema)
        got = outcome(lambda: [c.encode(batch) if lane == "native"
                               else c._encode_host_mode(batch,
                                                        batch.num_rows)])
        want = outcome(lambda: [r.encode(batch)])
        assert got == want
        if got[0] == "err":
            assert got[1][0] in ("ValueError", "OverflowError")


def test_encode_splits_a_batch_too_large_as_the_reference(codecs,
                                                          monkeypatch):
    e, c, r = codecs(KAFKA)
    datums = datagen.kafka_style_datums(100, seed=9)
    batch = oracle(e, datums)
    calls = {"port": 0, "ref": 0}

    def capped(orig, exc, key):
        def encode(self, b):
            calls[key] += 1
            if b.num_rows > 16:
                raise exc(b.num_rows, -1)
            return orig(self, b)
        return encode

    monkeypatch.setattr(NativeHostCodec, "encode",
                        capped(NativeHostCodec.encode, BatchTooLarge, "port"))
    monkeypatch.setattr(RefCodec, "encode",
                        capped(RefCodec.encode, RefTooLarge, "ref"))
    got = c.encode_threaded(batch, 3)
    want = r.encode_threaded(batch, 3, pool="thread")
    assert [len(a) for a in got] == [len(a) for a in want] == [33, 33, 34]
    assert wire(got) == wire(want) == datums
    assert calls["port"] == calls["ref"] > 1
    one = oracle(e, datums[:1])
    monkeypatch.setattr(NativeHostCodec, "encode",
                        capped(NativeHostCodec.encode, BatchTooLarge, "port"))
    assert wire(c.encode_threaded(one, 1)) == datums[:1]


def test_chunked_encode_modes(codecs, monkeypatch):
    e, c, r = codecs(NESTED)
    datums = datums_of("arr_rec_arr", 101, seed=4)
    batch = oracle(e, datums)
    monkeypatch.setattr(NativeHostCodec, "_PER_CHUNK_ROWS", 8)
    monkeypatch.setattr(RefCodec, "_PER_CHUNK_ROWS", 8)
    metrics.reset()
    shards = c.encode_threaded(batch, 4)
    assert lane_count("shard.native") == 1
    # where the shard runner declines, one encode per chunk on the pool
    monkeypatch.setattr(NativeHostCodec, "_encode_native_shards",
                        lambda self, b, bounds: None)
    per_chunk = c.encode_threaded(batch, 4)
    assert lane_count("shard.native") == 1
    want = r.encode_threaded(batch, 4, pool="thread")
    for g in (shards, per_chunk):
        assert [len(a) for a in g] == [len(a) for a in want]
        assert wire(g) == wire(want) == datums
    # over 2 * _PER_CHUNK_ROWS rows, one encode runs in slices
    assert wire(c.encode(batch)) == datums


# -- (e) the public calls ---------------------------------------------------------


def poisoned(schema, n, seed):
    rng = np.random.default_rng(seed)
    name = next(k for k, v in SHAPES.items() if v == schema)
    data = datums_of(name, n, seed=seed)
    bad = sorted(int(j) for j in rng.choice(n, 6, replace=False))
    for k, j in enumerate(bad):
        data[j] = b"\x01" if k % 2 else data[j][:1]
    return data, bad


def test_host_backend_takes_the_native_tier(codecs, monkeypatch):
    datums = datagen.kafka_style_datums(200, seed=12)
    entry = get_or_parse_schema(KAFKA)
    tier, impl = api._route_candidates(entry, "host", 200, "cuda")[:2]
    assert tier == "native" and isinstance(impl, NativeHostCodec)
    metrics.reset()
    got = port.deserialize_array_threaded(datums, KAFKA, 4, backend="host")
    assert lane_count("decode.fused") == 1
    want = ref.deserialize_array_threaded(datums, KAFKA, 4, backend="host")
    for g, w in zip(got, want):
        same(g, w)
    arrays = port.serialize_record_batch(oracle(entry, datums), KAFKA, 4,
                                         backend="host")
    assert lane_count("extract.native") == 1
    assert wire(arrays) == datums
    # a BinaryArray equals the list
    for g, w in zip(port.deserialize_array_threaded(
            pa.array(datums, pa.binary()), KAFKA, 4, backend="host"), got):
        same(g, w)
    # under PYRUHVRO_TPU_NO_NATIVE the oracle serves
    monkeypatch.setenv("PYRUHVRO_TPU_NO_NATIVE", "1")
    assert api._route_candidates(entry, "host", 0, "cuda")[:2] == \
        ("fallback", None)
    metrics.reset()
    for g, w in zip(port.deserialize_array_threaded(datums, KAFKA, 4,
                                                    backend="host"), got):
        same(g, w)
    assert lane_count("decode.fused") == 0


def test_outside_the_subset_the_oracle_serves():
    from decimal import Decimal as D

    entry = get_or_parse_schema(WIDE_FIXED_DECIMAL)
    assert api._route_candidates(entry, "host", 0, "cuda")[:2] == \
        ("fallback", None)
    batch = pa.RecordBatch.from_pydict(
        {"d": pa.array([D(5), D(-7), D(10) ** 30], pa.decimal128(38, 0))})
    wire_ = port.serialize_record_batch(batch, WIDE_FIXED_DECIMAL, 1,
                                        backend="host")
    assert wire(wire_) == wire(ref.serialize_record_batch(
        batch, WIDE_FIXED_DECIMAL, 1, backend="host"))
    same(port.deserialize_array(wire(wire_), WIDE_FIXED_DECIMAL,
                                backend="host"),
         ref.deserialize_array(wire(wire_), WIDE_FIXED_DECIMAL,
                               backend="host"))


@pytest.mark.parametrize("chunks", [None, 3])
@pytest.mark.parametrize("policy", ["skip", "null"])
def test_host_policies_equal_the_reference(policy, chunks):
    schema = NULLABLE if policy == "null" else KAFKA
    data, bad = poisoned(schema, 150, seed=21 + (chunks or 0))
    kw = {"backend": "host", "on_error": policy, "return_errors": True}
    if chunks is None:
        got, got_q = port.deserialize_array(data, schema, **kw)
        want, want_q = ref.deserialize_array(data, schema, **kw)
        got, want = [got], [want]
    else:
        got, got_q = port.deserialize_array_threaded(data, schema, chunks,
                                                     **kw)
        want, want_q = ref.deserialize_array_threaded(data, schema, chunks,
                                                      **kw)
    assert fields(got_q) == fields(want_q)
    assert [q.index for q in got_q] == bad
    assert {q.tier for q in got_q} == {"native"}
    assert len(got) == len(want)
    for g, w in zip(got, want):
        same(g, w)
    assert fields(port.last_quarantine()) == fields(got_q)


def test_host_policy_with_a_value_error_row():
    """A row good on the wire whose value cannot build (invalid UTF-8)
    reaches the oracle, as in the reference."""
    schema = ('{"type":"record","name":"UQ","fields":[{"name":"s","type":'
              '["null","string"]}]}')
    data = [b"\x02\x06abc"] * 10
    data[3] = b"\x02\x04\xff\xfe"
    data[6] = b"\x01"
    for policy in ("skip", "null"):
        got, got_q = port.deserialize_array_threaded(
            data, schema, 2, backend="host", on_error=policy,
            return_errors=True)
        want, want_q = ref.deserialize_array_threaded(
            data, schema, 2, backend="host", on_error=policy,
            return_errors=True)
        assert fields(got_q) == fields(want_q)
        assert [q.index for q in got_q] == [3, 6]
        for g, w in zip(got, want):
            same(g, w)


@pytest.mark.parametrize("policy", ["skip", "null"])
def test_host_encode_bisect_equals_the_reference(policy):
    rng = np.random.default_rng(8)
    vals = rng.integers(-500, 500, size=64)
    vals[[5, 40]] = [70000, -40000]  # past a 2-byte fixed
    for schema, nullable in ((FIXED_DECIMAL, False),
                             (NULL_FIXED_DECIMAL, True)):
        field = pa.field("d", pa.decimal128(5, 0), nullable=nullable)
        batch = pa.RecordBatch.from_arrays(
            [pa.array([Decimal(int(v)) for v in vals], pa.decimal128(5, 0))],
            schema=pa.schema([field]))
        kw = {"backend": "host", "on_error": policy, "return_errors": True}
        got, got_q = port.serialize_record_batch(batch, schema, 2, **kw)
        want, want_q = ref.serialize_record_batch(batch, schema, 2, **kw)
        assert fields(got_q) == fields(want_q)
        assert [q.index for q in got_q] == [5, 40]
        assert {q.tier for q in got_q} == {"native"}
        assert [wire(a) for a in got] == [wire(a) for a in want]


def test_host_deadline_raises():
    datums = datagen.kafka_style_datums(20, seed=1)
    with pytest.raises(deadline.DeadlineExceeded):
        port.deserialize_array(datums, KAFKA, backend="host", timeout_s=0)
    with pytest.raises(deadline.DeadlineExceeded):
        port.deserialize_array_threaded(datums, KAFKA, 2, backend="host",
                                        on_error="skip", timeout_s=0)
    # the pool's workers take the caller's deadline over
    with deadline.scope(0.0, op="t"):
        with pytest.raises(deadline.DeadlineExceeded, match="pool"):
            pool.map_chunks(lambda x: x, [1, 2, 3])
    assert pool.map_chunks(lambda x: x * 2, [1, 2, 3]) == [2, 4, 6]


# -- (f) a failed build -----------------------------------------------------------


def test_failed_build_raises_and_never_serves_the_oracle(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(native, "_cxx", lambda: shutil.which("false"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_loaded", {})
    schema = ('{"type":"record","name":"BuildFails","fields":['
              '{"name":"x","type":"long"}]}')
    data = [b"\x02", b"\x04"]
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port.deserialize_array(data, schema, backend="host")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port.deserialize_array_threaded(data, schema, 2, backend="host",
                                        on_error="skip")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        NativeHostCodec(get_or_parse_schema(schema).ir,
                        get_or_parse_schema(schema).arrow_schema)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("PYRUHVRO_TPU_NO_NATIVE", "1")
    assert port.deserialize_array(data, schema,
                                  backend="host").column(0).to_pylist() == [1, 2]


# -- (g) the build's sources ------------------------------------------------------


def test_build_reads_only_the_ports_sources():
    csrc = (REPO / "pyruhvro_tpu_torch" / "csrc").resolve()
    for name, (rel, module) in native.SOURCES.items():
        files = native.source_files(native.CSRC / rel)
        assert all(csrc in f.parents for f in files), (name, files)
        assert f"PyInit_{module}".encode() in (native.CSRC / rel).read_bytes()
    lib = native.load_host_codec()
    assert lib.path.parent == native.BUILD_DIR
    assert not any("pyruhvro_tpu/" in arg for arg in lib.command)
    assert [a for a in lib.command if a.startswith("-I")] == [
        f"-I{__import__('sysconfig').get_paths()['include']}"]
    text = (REPO / "pyruhvro_tpu_torch" / "runtime" / "native.py").read_text()
    assert "pyruhvro_tpu/" not in text.replace(
        "pyruhvro_tpu/runtime/native/build.py", "")
    for path in sorted(csrc.rglob("*")):
        if path.suffix in (".cpp", ".h", ".cu", ".cuh"):
            for inc in re.findall(r'#\s*include\s+"([^"]+)"',
                                  path.read_text()):
                assert csrc in (path.parent / inc).resolve().parents, inc


# the VM's one departure: an Avro int past int32 is an error
# (ERR_INT_RANGE, read through Reader::read_int), not its low 32 bits
INT_RANGE_EDITS = {
    "host_codec.cpp": [(
        "        int64_t v = present ? r.read_zigzag() : 0;\n"
        "        (*cols_)[op.col].i32.push_back((int32_t)v);  "
        "// low-32 like the device walk",
        "        int32_t v = present ? r.read_int() : 0;  "
        "// int32-range checked\n"
        "        (*cols_)[op.col].i32.push_back(v);")],
    "host_vm_core.h": [(
        "  ERR_DEC_RANGE = 1 << 8,  // decimal outside decimal128's 128-bit "
        "range\n",
        "  ERR_DEC_RANGE = 1 << 8,  // decimal outside decimal128's 128-bit "
        "range\n"
        "  ERR_INT_RANGE = 1 << 9,  // an Avro int whose varint lies past "
        "int32\n"), (
        "    return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);\n  }\n",
        "    return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);\n  }\n\n"
        "  // An Avro int: a zigzag varint that must lie in int32, as the "
        "oracle\n"
        "  // and the device walks hold it (ERR_INT_RANGE past it, value 0).\n"
        "  inline int32_t read_int() {\n"
        "    int64_t v = read_zigzag();\n"
        "    if (v < INT32_MIN || v > INT32_MAX) {\n"
        "      err |= ERR_INT_RANGE;\n"
        "      return 0;\n"
        "    }\n"
        "    return (int32_t)v;\n"
        "  }\n")],
}
# the only edits of the copies besides their first comment: the module
# names, comments that cited the reference's own ticket numbers, and
# INT_RANGE_EDITS
COPY_EDITS = {
    "host_codec.cpp": [('"_pyruhvro_hostcodec"', '"_pyruhvro_torch_hostcodec"'),
                       ("PyInit__pyruhvro_hostcodec",
                        "PyInit__pyruhvro_torch_hostcodec")]
    + INT_RANGE_EDITS["host_codec.cpp"],
    "extract.cpp": [('"_pyruhvro_extract"', '"_pyruhvro_torch_extract"'),
                    ("PyInit__pyruhvro_extract", "PyInit__pyruhvro_torch_extract")],
    "arrow_decode_core.h": [("extract_core.h (ISSUE 9\n// tentpole). The VM's",
                             "extract_core.h. The VM's")],
    "extract_core.h": [("(ISSUE 2 tentpole; Zerrow-style", "(Zerrow-style")],
    "shard_runner.h": [("(PR 13 discipline; the TSan flavor runs this)",
                        "(the TSan flavor runs this)")],
    "host_vm_core.h": INT_RANGE_EDITS["host_vm_core.h"],
}


@pytest.mark.parametrize("name", sorted(COPY_EDITS))
def test_host_sources_are_the_references_copies(name):
    got = (REPO / "pyruhvro_tpu_torch" / "csrc" / "host" / name).read_text()
    want = (REPO / "pyruhvro_tpu" / "runtime" / "native" / name).read_text()
    head, body = got.split("\n//\n", 1)
    assert head.startswith(f"// Copy of pyruhvro_tpu/runtime/native/{name}")
    for old, new in COPY_EDITS[name]:
        assert want.count(old) == 1
        want = want.replace(old, new)
    assert body == want


def test_build_key_covers_headers_and_the_cpu(monkeypatch, tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(native.CSRC / "host", copy / "host")
    monkeypatch.setattr(native, "CSRC", copy)
    first = native.build_path("host_codec")
    assert first.parent == native.BUILD_DIR
    header = copy / "host" / "shard_runner.h"
    header.write_text(header.read_text() + "\n// edited\n")
    second = native.build_path("host_codec")
    assert second != first
    assert native.build_path("extract") != first
    monkeypatch.setattr(native, "cpu_tag", lambda: "another-cpu")
    assert native.build_path("host_codec") != second
