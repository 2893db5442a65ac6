"""The overlapped chunk path held against the reference's, on the CPU.

``deserialize_array_threaded(..., 8, device="cpu")`` and
``deserialize_array(..., device="cpu")`` on batches of several overlap
chunks (``PYRUHVRO_TPU_OVERLAP_ROWS=64``) against the reference's
``DeviceCodec`` (the JAX pipeline on the CPU, whose codec takes its own
overlapped path for the same batches) and the pure-Python oracle, value
by value: Kafka, nested and large records; bad rows in three chunks as
one ``MalformedAvro``; a later chunk that overflows chunk 0's rung; the
crafted lanes whose errors depend on what a walk reads past a record;
the codec's halving. Decode is integer work: the tolerance is 0.

Each test uses schema strings of its own (the JSON with trailing
spaces), so that the reference's process-wide codecs and capacity plans
for the plain strings, which other test files grow, do not reach these
decoders. Both packages seed a fresh bucket's caps from a host decode of
the first 128 records after a planner miss.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from pyruhvro_tpu.fallback.decoder import decode_to_record_batch  # noqa: E402
from pyruhvro_tpu.ops.codec import get_device_codec as ref_codec  # noqa: E402
from pyruhvro_tpu.runtime import capacity as ref_capacity  # noqa: E402
from pyruhvro_tpu.runtime.chunking import chunk_bounds  # noqa: E402
from pyruhvro_tpu.schema.arrow_map import to_arrow_schema as ref_arrow  # noqa: E402
from pyruhvro_tpu.schema.cache import get_or_parse_schema as ref_entry  # noqa: E402
from pyruhvro_tpu.schema.parser import parse_schema as ref_parse  # noqa: E402

import chip_smoke  # noqa: E402
from pyruhvro_tpu_torch import (  # noqa: E402
    deserialize_array,
    deserialize_array_threaded,
)
from pyruhvro_tpu_torch.ops import decode  # noqa: E402
from pyruhvro_tpu_torch.runtime import capacity  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

zz = chip_smoke.zz
KAFKA = datagen.KAFKA_SCHEMA_JSON + " "
NESTED = chip_smoke.PIPELINE_SHAPES["arr_rec_arr"] + " "
LARGE = datagen.KAFKA_SCHEMA_JSON + "  "
LADDER = chip_smoke.LADDER_SCHEMA + " "
STRINGS = ('{"type":"record","name":"Craft","fields":[{"name":"xs","type":'
           '{"type":"array","items":"string"}}]}')
GLOBAL_BOUND = chip_smoke.GLOBAL_BOUND_SCHEMA + " "


@pytest.fixture(autouse=True)
def _overlap_env(monkeypatch):
    """Chunks of 64 rows on both sides; one torch thread (parallel test
    workers share the CPU)."""
    monkeypatch.setenv("PYRUHVRO_TPU_OVERLAP_ROWS", "64")
    monkeypatch.delenv("PYRUHVRO_TPU_OVERLAP", raising=False)
    monkeypatch.delenv("PYRUHVRO_TPU_PALLAS", raising=False)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def overlapped(monkeypatch):
    """Records the chunks of each call of the port's overlapped path."""
    calls = []
    real = decode.DeviceDecoder.decode_to_columns_overlapped

    def counting(self, data, n_chunks):
        calls.append(n_chunks)
        return real(self, data, n_chunks)

    monkeypatch.setattr(decode.DeviceDecoder, "decode_to_columns_overlapped",
                        counting)
    return calls


def _reference(schema, datums):
    """``("ok", batch)`` or ``("error", (message, index, slug, tier,
    indices))`` of the reference's ``DeviceCodec``."""
    return _outcome(lambda: ref_codec(ref_entry(schema)).decode(datums))


def _port(schema, datums):
    return _outcome(lambda: deserialize_array(datums, schema, device="cpu"))


def _outcome(call):
    try:
        return "ok", call()
    except ValueError as e:  # both packages' MalformedAvro
        return "error", (str(e), e.index, e.err_name, e.tier, e.indices)


def _oracle(schema, datums):
    ir = ref_parse(schema)
    return decode_to_record_batch(datums, ir, ref_arrow(ir))


def _large(n):
    return chip_smoke.large_kafka_datums(datagen, parse_schema, n, seed=2)


PARITY = {
    "kafka": (KAFKA, lambda: datagen.kafka_style_datums(512, seed=31)),
    "nested": (NESTED, lambda: datagen.random_datums(
        parse_schema(NESTED), 512, seed=6)),
    "large": (LARGE, lambda: _large(192)),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_threaded_matches_reference_and_oracle(case, overlapped):
    schema, make = PARITY[case]
    datums = make()
    got = deserialize_array_threaded(datums, schema, 8, device="cpu")
    assert overlapped == [len(datums) // 64]
    kind, want = _reference(schema, datums)
    assert kind == "ok"
    oracle = _oracle(schema, datums)
    bounds = chunk_bounds(len(datums), 8)
    assert len(got) == len(bounds)
    for batch, (a, b) in zip(got, bounds):
        assert batch.schema.equals(oracle.schema)
        assert batch.to_pylist() == want.slice(a, b - a).to_pylist()
        assert batch.to_pylist() == oracle.slice(a, b - a).to_pylist()


def test_warm_call_streams_every_chunk(overlapped):
    """The second call of a bucket streams chunk 0 too: one rung per
    chunk, no rerun, the same values."""
    datums = datagen.kafka_style_datums(256, seed=32)
    dec = decode.DeviceDecoder(parse_schema(KAFKA), device="cpu",
                               fingerprint="warm-stream")
    cold = dec.decode_to_columns_overlapped(datums, 4)
    warm = dec.decode_to_columns_overlapped(datums, 4)
    t = warm[0][2]["timings"]
    assert (t["chunks"], t["rungs"], t["reruns"]) == (4, 4, 0)
    assert cold[0][2]["timings"]["rungs"] >= 4
    for (hc, nc, mc), (hw, nw, mw) in zip(cold, warm):
        assert nc == nw and hc.keys() == hw.keys()
        assert all((hc[k] == hw[k]).all() for k in hc)
        assert mc["flat"].base is not None  # a view of the one concat
    assert 0.0 <= t["overlap_frac"] <= 1.0 and t["overlap_s"] >= 0.0


def test_malformed_rows_in_three_chunks(overlapped):
    """Bad rows in three chunks: one MalformedAvro with every global index,
    as the reference raises it (the case of
    ``tests/test_device_fastpath.py::test_overlap_malformed_indices_cover_all_chunks``)."""
    datums = datagen.kafka_style_datums(512, seed=17)
    bad = [10, 200, 400]
    for i in bad:
        datums[i] = b"\xff" * 3 + datums[i]
    got = _port(KAFKA, datums)
    assert overlapped == [8]
    want = _reference(KAFKA, datums)
    assert got[0] == "error" and got == want
    _msg, index, _slug, tier, indices = got[1]
    assert index == 10 and tier == "device"
    assert sorted(i for i, _s in indices) == bad


def test_later_chunk_overflows_chunk_zeros_rung(overlapped):
    """Chunk 0 converges at small caps; chunk 5's arrays need more item
    slots, so it reruns its ladder from its arena. The values equal the
    reference's and the oracle's."""
    w = datagen.compile_writer(parse_schema(LADDER))

    def rec(k):
        out = bytearray()
        w(out, {"xs": list(range(k))})
        return bytes(out)

    datums = [rec(1) for _ in range(512)]
    datums[5 * 64 + 7] = rec(40)
    datums[5 * 64 + 9] = rec(70)
    dec = decode.DeviceDecoder(parse_schema(LADDER), device="cpu",
                               fingerprint="rerun")
    triples = dec.decode_to_columns_overlapped(datums, 8)
    timings = triples[0][2]["timings"]
    assert timings["reruns"] == 1
    # the host sample seeds chunk 0's caps (its first 128 records hold one
    # item each), so the one rung past the 8 dispatches is chunk 5's rerun
    assert timings["rungs"] == len(triples) + 1
    got = deserialize_array(datums, LADDER, device="cpu")
    kind, want = _reference(LADDER, datums)
    assert kind == "ok"
    assert got.to_pylist() == want.to_pylist()
    assert got.to_pylist() == _oracle(LADDER, datums).to_pylist()
    # the rerun taught the planner its rung: a fresh decoder of the
    # fingerprint reruns nothing. The reference's planner keeps chunk 0's
    # rung only (its rerun ladder converges at once and harvests nothing).
    fresh = decode.DeviceDecoder(parse_schema(LADDER), device="cpu",
                                 fingerprint="rerun")
    again = fresh.decode_to_columns_overlapped(datums, 8)[0][2]["timings"]
    assert (again["rungs"], again["reruns"]) == (8, 0)
    R = 64
    port_plan = capacity.lookup(get_or_parse_schema(LADDER).fingerprint, R)
    ref_plan = ref_capacity.lookup(ref_entry(LADDER).fingerprint, R)
    assert port_plan["item_caps"]["xs"] == 128
    assert ref_plan["item_caps"]["xs"] == 8


def _crafted_chunk_edge():
    """Chunk 0's last lane claims 500 strings and holds one: its second
    item reads past its record. On one launch that is record 64's first
    byte, a negative block count (zigzag 0x01) read as a string length
    (``neg_len``); in a chunk it is the chunk's zero padding
    (``overrun``)."""
    def sarr(vals):
        return zz(len(vals)) + b"".join(zz(len(v)) + v for v in vals) + zz(0)
    datums = [sarr([b"ab"]) for _ in range(128)]
    datums[63] = zz(500) + zz(1) + b"q"
    datums[64] = zz(-1) + zz(3) + zz(2) + b"ab" + zz(0)
    return datums


def _crafted_global_bound():
    """Zero-byte items in a nested loop beside lanes of long strings, the
    long lanes in one chunk only: the loop bounds of the chunks and of
    the one launch differ."""
    w = datagen.compile_writer(parse_schema(GLOBAL_BOUND))

    def rec(value):
        out = bytearray()
        w(out, value)
        return bytes(out)

    datums = [rec({"aa": [[None] * (i % 4)], "s": "z"}) for i in range(192)]
    datums[3] = rec({"aa": [[None], [None] * 300], "s": ""})
    datums[70] = rec({"aa": [[None] * 3], "s": "x" * 900})
    datums[150] = rec({"aa": [[None] * 2, [None] * 1500], "s": "y"})
    return datums


CRAFTED = {"chunk_edge": (STRINGS, _crafted_chunk_edge),
           "global_bound": (GLOBAL_BOUND, _crafted_global_bound)}


@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_crafted_lanes_follow_the_reference_on_both_paths(case, monkeypatch):
    """Each path equals the reference under the same knob: chunked by
    default, one launch under ``PYRUHVRO_TPU_OVERLAP=0``. The chunk-edge
    lanes raise different errors on the two paths, in both packages."""
    schema, make = CRAFTED[case]
    datums = make()
    chunked = _port(schema, datums)
    assert chunked == _reference(schema, datums)
    monkeypatch.setenv("PYRUHVRO_TPU_OVERLAP", "0")
    single = _port(schema, datums)
    assert single == _reference(schema, datums)
    if case == "chunk_edge":
        assert chunked[0] == single[0] == "error"
        assert chunked[1][1:3] == (63, "overrun")
        assert single[1][1:3] == (63, "neg_len")
    else:
        assert chunked[0] == single[0] == "ok"
        assert chunked[1].to_pylist() == single[1].to_pylist() == \
            _oracle(schema, datums).to_pylist()


def test_halving_rebases_rows_through_the_overlapped_path(monkeypatch,
                                                          overlapped):
    """Over the launch budget the overlapped path raises BatchTooLarge and
    the codec halves the batch; each half decodes through the overlapped
    path again. Bad rows in the right half keep their global indices,
    as the reference raises them from the whole batch."""
    datums = datagen.kafka_style_datums(512, seed=23)
    whole = deserialize_array(datums, KAFKA, device="cpu")
    bad = [300, 450]
    broken = list(datums)
    for i in bad:
        broken[i] = b"\xff" * 3 + broken[i]
    want = _reference(KAFKA, broken)
    monkeypatch.setattr(decode, "LAUNCH_MAX_BYTES",
                        sum(map(len, datums)) * 2 // 3)
    overlapped.clear()
    assert deserialize_array(datums, KAFKA, device="cpu").to_pylist() == \
        whole.to_pylist()
    assert overlapped == [8, 4, 4]  # the whole batch, then each half
    got = _port(KAFKA, broken)
    assert got[0] == "error" and got == want
    assert got[1][1] == 300 and [i for i, _s in got[1][4]] == bad
