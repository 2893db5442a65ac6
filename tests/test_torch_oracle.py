"""The port's host oracle and its cap sampling held against the reference's.

The port's ``fallback/`` (a copy of ``pyruhvro_tpu/fallback/``) against the
reference's on random schemas and datums: the same values, the same
``MalformedAvro`` message, index, slug and tier on mutated datums, the
same per-record capture, and the encoder's wire byte-equal. Then the
hostile-input guards (depth cap, zero-width items, a 2 GiB string
claim, ``PYRUHVRO_TPU_MAX_DATUM_BYTES``) and the quarantine records.
Last, ``seed_caps_from_sample``: a fresh port decoder and a fresh
reference decoder reach the same caps in the same number of rungs.
Everything here is integer and byte work: the tolerance is 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from pyruhvro_tpu.fallback import decoder as ref_decoder  # noqa: E402
from pyruhvro_tpu.fallback import encoder as ref_encoder  # noqa: E402
from pyruhvro_tpu.ops.decode import DeviceDecoder as RefDecoder  # noqa: E402
from pyruhvro_tpu.runtime import capacity as ref_capacity  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402
from pyruhvro_tpu.runtime import quarantine as ref_quarantine  # noqa: E402
from pyruhvro_tpu.schema.arrow_map import to_arrow_schema as ref_arrow  # noqa: E402
from pyruhvro_tpu.schema.parser import parse_schema as ref_parse  # noqa: E402
from pyruhvro_tpu.utils.datagen import random_schema  # noqa: E402

import chip_smoke  # noqa: E402
from pyruhvro_tpu_torch.errors import MalformedAvro  # noqa: E402
from pyruhvro_tpu_torch.fallback import decoder, encoder, io  # noqa: E402
from pyruhvro_tpu_torch.ops import decode  # noqa: E402
from pyruhvro_tpu_torch.runtime import quarantine  # noqa: E402
from pyruhvro_tpu_torch.schema.arrow_map import to_arrow_schema  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

SEEDS = range(24)


def _mutations(datums, seed):
    """Each datum bit-flipped, truncated or extended at numpy-drawn
    positions (one mutation per datum)."""
    rng = np.random.default_rng(seed)
    out = []
    for j, d in enumerate(datums):
        kind = j % 4
        if kind == 0 and d:
            b = bytearray(d)
            b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
            out.append(bytes(b))
        elif kind == 1:
            out.append(d[:int(rng.integers(len(d) + 1))])
        elif kind == 2:
            out.append(d + bytes(rng.integers(0, 256, 2, dtype=np.uint8)))
        else:
            out.append(bytes(rng.integers(0, 256, 3, dtype=np.uint8)) + d)
    return out


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as e:  # both packages' MalformedAvro
        return "error", (str(e), getattr(e, "index", None),
                         getattr(e, "err_name", None),
                         getattr(e, "tier", None))


@pytest.mark.parametrize("seed", SEEDS)
def test_decoder_matches_the_reference_oracle(seed):
    schema = random_schema(seed)
    ir, rir = parse_schema(schema), ref_parse(schema)
    datums = datagen.random_datums(ir, 40, seed=seed)
    got = decoder.decode_to_record_batch(datums, ir, to_arrow_schema(ir))
    want = ref_decoder.decode_to_record_batch(datums, rir, ref_arrow(rir))
    # equals(), not to_pylist(): the random timestamps pass datetime's range,
    # and nothing here is a slice (where equals() can miss sparse unions)
    assert got.schema.equals(want.schema) and got.equals(want)
    reader, rreader = decoder.compile_reader(ir), ref_decoder.compile_reader(rir)
    bad = _mutations(datums, seed)
    for i, d in enumerate(bad):
        assert _outcome(lambda: decoder.decode_records(
            [d], ir, reader, index_base=i)) == _outcome(
            lambda: ref_decoder.decode_records([d], rir, rreader,
                                               index_base=i))
    rows, errs = decoder.decode_records_tolerant(bad, ir, reader, 7)
    rrows, rerrs = ref_decoder.decode_records_tolerant(bad, rir, rreader, 7)
    assert rows == rrows and errs == rerrs
    pairs = [(3 * i, d) for i, d in enumerate(bad)]
    assert decoder.decode_pairs_tolerant(pairs, ir, reader) == \
        ref_decoder.decode_pairs_tolerant(pairs, rir, rreader)
    # wire-valid survivors whose values cannot build (uuid text, decimal
    # precision) raise the same ValueError on both sides
    assert _outcome(lambda: decoder.rows_to_record_batch(
        rows, ir, to_arrow_schema(ir))) == _outcome(
        lambda: ref_decoder.rows_to_record_batch(rrows, rir, ref_arrow(rir)))


@pytest.mark.parametrize("seed", SEEDS)
def test_encoder_wire_matches_the_reference_oracle(seed):
    schema = random_schema(seed)
    ir, rir = parse_schema(schema), ref_parse(schema)
    datums = datagen.random_datums(ir, 40, seed=seed)
    batch = decoder.decode_to_record_batch(datums, ir, to_arrow_schema(ir))
    plan = encoder.compile_encoder_plan(ir)
    got = encoder.encode_record_batch(batch, ir, plan)
    assert got == ref_encoder.encode_record_batch(
        batch, rir, ref_encoder.compile_encoder_plan(rir))
    assert got == datums  # the generator writes the canonical form
    for f, col in zip(ir.fields, batch.columns):
        assert encoder.extract_rows(col, f.type) == ref_encoder.extract_rows(
            col, next(rf.type for rf in rir.fields if rf.name == f.name))


def test_encoder_errors_match_the_reference_oracle():
    import pyarrow as pa

    schema = ('{"type":"record","name":"E","fields":[{"name":"e","type":'
              '{"type":"enum","name":"En","symbols":["A","B"]}},'
              '{"name":"x","type":"long"}]}')
    ir, rir = parse_schema(schema), ref_parse(schema)
    cases = [
        pa.RecordBatch.from_pylist([{"e": "A", "x": 1}, {"e": "Q", "x": 2}]),
        pa.RecordBatch.from_pylist([{"e": "A"}]),
        pa.RecordBatch.from_pylist([{"e": "A", "x": "s"}]),
        pa.RecordBatch.from_pylist([{"e": "A", "x": None}]),
    ]
    for batch in cases:
        assert _outcome(lambda: encoder.encode_record_batch(batch, ir)) == \
            _outcome(lambda: ref_encoder.encode_record_batch(batch, rir))
        assert _outcome(lambda: encoder.encode_record_batch(batch, ir))[0] \
            == "error"


def test_wire_primitives_match_the_reference():
    from pyruhvro_tpu.fallback import io as ref_io

    rng = np.random.default_rng(5)
    values = [0, 1, -1, 63, -64, 64, 2**31, -(2**63), 2**63 - 1] + [
        int(v) for v in rng.integers(-2**62, 2**62, 50)]
    for v in values:
        out, rout = bytearray(), bytearray()
        io.write_long(out, v)
        ref_io.write_long(rout, v)
        assert out == rout and io.long_size(v) == len(out)
        assert io.read_long(out, 0) == ref_io.read_long(rout, 0) == \
            (v, len(out))
    for buf in (b"", b"\x80", b"\x80" * 11, b"\x05", b"\x02a",
                b"\x80\x80\x80\x80\x80\x80\x80\x80\x80\x80\x01", b"\x02"):
        for rd, rref in ((io.read_bytes, ref_io.read_bytes),
                         (io.read_bool, ref_io.read_bool),
                         (io.read_double, ref_io.read_double)):
            assert _outcome(lambda: rd(buf, 0)) == _outcome(
                lambda: rref(buf, 0))
    assert io.MalformedAvro is MalformedAvro
    assert io.MAX_ZERO_WIDTH_ITEMS == ref_io.MAX_ZERO_WIDTH_ITEMS


def test_hostile_input_guards_match_the_reference(monkeypatch):
    zs = ('{"type":"record","name":"Z","fields":[{"name":"a","type":'
          '{"type":"array","items":"null"}}]}')
    ss = '{"type":"record","name":"S","fields":[{"name":"s","type":"string"}]}'
    zz = chip_smoke.zz
    for schema, datum in ((zs, zz(1 << 40) + b"\x00"),
                          (zs, zz(io.MAX_ZERO_WIDTH_ITEMS + 1) + b"\x00"),
                          (zs, zz(3) + b"\x00"),
                          (ss, zz(2 << 30) + b"ab"),
                          (ss, zz(3) + b"abc")):
        ir, rir = parse_schema(schema), ref_parse(schema)
        assert _outcome(lambda: decoder.decode_records([datum], ir)) == \
            _outcome(lambda: ref_decoder.decode_records([datum], rir))
    deep = '"long"'
    for i in range(80):
        deep = ('{"type":"record","name":"R%d","fields":'
                '[{"name":"f","type":%s}]}' % (i, deep))
    with pytest.raises(ValueError, match="nesting depth"):
        decoder.compile_reader(parse_schema(deep))
    monkeypatch.setenv("PYRUHVRO_TPU_MAX_DEPTH", "100")
    decoder.compile_reader(parse_schema(deep))
    monkeypatch.setenv("PYRUHVRO_TPU_MAX_DATUM_BYTES", "3")
    ir, rir = parse_schema(ss), ref_parse(ss)
    for datum in (zz(1) + b"a", zz(3) + b"abc"):
        assert _outcome(lambda: decoder.decode_records([datum], ir, None, 4)) \
            == _outcome(lambda: ref_decoder.decode_records([datum], rir,
                                                           None, 4))
    assert io.max_datum_bytes() == 3


def test_quarantine_records_follow_the_reference():
    entries = [(5, b"\x01", "overrun", "device"), (2, None, "x", "fallback")]
    got = quarantine.rebase(entries, 10)
    want = ref_quarantine.rebase(entries, 10)
    assert [tuple(e) for e in got] == [tuple(e) for e in want]
    assert got[0].trace_id is None and got[0].index == 15
    assert quarantine.QuarantinedRecord._fields == \
        ref_quarantine.QuarantinedRecord._fields
    quarantine.publish(list(got))
    assert [e.index for e in quarantine.last()] == [12, 15]


# -- seed_caps_from_sample ------------------------------------------------------

SAMPLED = {"kafka": datagen.KAFKA_SCHEMA_JSON,
           "arr_rec_arr": chip_smoke.PIPELINE_SHAPES["arr_rec_arr"]}


def _data(name, n):
    schema = SAMPLED[name]
    if name == "kafka":
        return schema, datagen.kafka_style_datums(n, seed=3)
    return schema, datagen.random_datums(parse_schema(schema), n, seed=3)


def _retries():
    return ref_metrics.snapshot().get("device.retries", 0)


@pytest.mark.parametrize("overlapped", [False, True])
@pytest.mark.parametrize("name", sorted(SAMPLED))
def test_sampled_caps_and_rungs_match_the_reference(name, overlapped,
                                                    monkeypatch):
    """A fresh decoder of each package seeds its caps from the oracle's
    decode of the first 128 records after a planner miss, then climbs the
    same rungs to the same caps; what the decode returns does not change
    (held by the other test files)."""
    monkeypatch.setenv("PYRUHVRO_TPU_OVERLAP_ROWS", "64")
    schema, datums = _data(name, 512 if overlapped else 300)
    ref_capacity.reset()
    port = decode.DeviceDecoder(parse_schema(schema), device="cpu")
    ref = RefDecoder(ref_parse(schema))
    sampled = []
    real = decode.DeviceDecoder.seed_caps_from_sample

    def spy(self, data, R):
        sampled.append((len(data), R))
        real(self, data, R)

    monkeypatch.setattr(decode.DeviceDecoder, "seed_caps_from_sample", spy)
    retries0 = _retries()
    if overlapped:
        triples = port.decode_to_columns_overlapped(datums, 8)
        ref.decode_to_columns_overlapped(datums, 8)
        timings = triples[0][2]["timings"]
        port_retries = timings["rungs"] - timings["chunks"]
    else:
        timings = port.decode_to_columns(datums)[2]["timings"]
        ref.decode_to_columns(datums)
        port_retries = timings["rungs"] - 1
    assert sampled == [(len(datums), 64 if overlapped else 512)]
    assert port._item_caps == ref._item_caps
    assert port._tot_cap_mem == ref._tot_cap_mem
    assert port._seed_tried == ref._seed_tried
    assert port_retries == _retries() - retries0
    # the sample moved the caps off the first rung
    assert max(port._item_caps) > 8 or max(port._tot_cap_mem.values()) > 8


def test_sampling_is_skipped_after_a_plan_hit_and_tried_once():
    schema, datums = _data("arr_rec_arr", 300)
    from pyruhvro_tpu_torch.runtime import capacity

    capacity.reset()
    first = decode.DeviceDecoder(parse_schema(schema), device="cpu",
                                 fingerprint="sampled")
    first.decode_to_columns(datums)
    assert first._seed_tried
    hit = decode.DeviceDecoder(parse_schema(schema), device="cpu",
                               fingerprint="sampled")
    hit.decode_to_columns(datums)
    assert hit._seed_tried == set()  # the plan replaced the sample
    # a sample that does not decode leaves the caps to the ladder
    bad = decode.DeviceDecoder(parse_schema(schema), device="cpu")
    bad.seed_caps_from_sample([b"\xff\xff\xff"] + datums, 512)
    assert bad._tot_cap_mem == {} and bad._seed_tried
    bad.seed_caps_from_sample(datums, 512)  # tried once per (R, region)
    assert bad._tot_cap_mem == {}
    capacity.reset()
