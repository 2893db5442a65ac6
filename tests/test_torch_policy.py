"""The port's public call contract held against the reference's, on the CPU.

The port's five public functions with ``device="cpu"`` (the kernels'
plain versions) against the reference's with ``backend="tpu"`` (its device
tier on JAX's CPU, as ``tests/test_error_policy.py`` runs it), and the
port's ``backend="host"`` against the reference's host tier with its
native VM off (the pure-Python oracle): ``on_error="skip"``/``"null"``
with ``return_errors``, the assembly's per-column errors, the encode
bisect, ``PYRUHVRO_TPU_MAX_DATUM_BYTES``, ``timeout_s``, pyarrow binary
input, the spawn aliases, and the narrowed ``except`` that lets a device
fault through. Chunks of 64 rows (``PYRUHVRO_TPU_OVERLAP_ROWS=64``) make
both packages take their overlapped paths. Decode and encode are integer
and byte work: the tolerance is 0.

Bad rows are placed by a numpy seed; records come from
``utils/datagen``. Quarantine entries are compared field by field
(``index``, ``datum``, ``error``, ``tier``): the reference also stamps a
trace id, which the port does not have.
"""

import pickle
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.ops.codec import get_device_codec as ref_codec  # noqa: E402
from pyruhvro_tpu.schema.cache import get_or_parse_schema as ref_entry  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.ops import decode, encode  # noqa: E402
from pyruhvro_tpu_torch.runtime import deadline  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

KAFKA = datagen.KAFKA_SCHEMA_JSON
FLAT = """{"type":"record","name":"F","fields":[
  {"name":"x","type":"long"},{"name":"s","type":"string"}]}"""
NULLABLE = """{"type":"record","name":"N","fields":[
  {"name":"a","type":["null","long"]},
  {"name":"s","type":["null","string"]}]}"""
DECIMAL = ('{"type":"record","name":"D","fields":[{"name":"d","type":'
           '{"type":"fixed","name":"Fx","size":1,"logicalType":"decimal",'
           '"precision":3,"scale":0}}]}')
NULL_DECIMAL = ('{"type":"record","name":"ND","fields":[{"name":"d","type":'
                '["null",{"type":"fixed","name":"Fx","size":1,"logicalType":'
                '"decimal","precision":3,"scale":0}]}]}')
COLUMNS = """{"type":"record","name":"Col","fields":[
  {"name":"p","type":"string"},
  {"name":"du","type":{"type":"fixed","name":"Du","size":12,
                       "logicalType":"duration"}}]}"""
SCHEMAS = {"kafka": KAFKA, "flat": FLAT, "nullable": NULLABLE}
ROWS = 256


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Chunks of 64 rows on both sides; one torch thread (parallel test
    workers share the CPU)."""
    monkeypatch.setenv("PYRUHVRO_TPU_OVERLAP_ROWS", "64")
    for name in ("PYRUHVRO_TPU_OVERLAP", "PYRUHVRO_TPU_PALLAS",
                 "PYRUHVRO_TPU_MAX_DATUM_BYTES", "PYRUHVRO_TPU_DEADLINE_S"):
        monkeypatch.delenv(name, raising=False)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def poisoned(schema: str, seed: int, n: int = ROWS, k: int = 9):
    """``n`` records of ``schema`` with ``k`` rows at numpy-drawn positions
    replaced by a union branch of -1, a truncation or three 0xff bytes in
    front; returns the datums and the planted rows."""
    datums = (datagen.kafka_style_datums(n, seed=seed) if schema == KAFKA
              else datagen.random_datums(parse_schema(schema), n, seed=seed))
    rng = np.random.default_rng(seed)
    bad = sorted(int(i) for i in rng.choice(n, size=k, replace=False))
    for j, i in enumerate(bad):
        d = datums[i]
        datums[i] = (b"\x01", d[:max(1, len(d) // 3)], b"\xff" * 3 + d)[j % 3]
    return datums, bad


def fields(entries):
    return [(q.index, q.datum, q.error, q.tier) for q in entries]


def same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.schema.equals(w.schema)
        assert g.num_rows == w.num_rows
        assert g.to_pylist() == w.to_pylist()


# -- row errors ---------------------------------------------------------------


@pytest.mark.parametrize("chunks", [1, 3, 8])
@pytest.mark.parametrize("policy", ["skip", "null"])
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_row_errors_match_the_reference(name, policy, chunks):
    schema = SCHEMAS[name]
    datums, bad = poisoned(schema, seed=len(name) * 7)
    got, got_q = port.deserialize_array_threaded(
        datums, schema, chunks, device="cpu", on_error=policy,
        return_errors=True)
    want, want_q = ref.deserialize_array_threaded(
        datums, schema, chunks, backend="tpu", on_error=policy,
        return_errors=True)
    same_batches(got, want)
    assert fields(got_q) == fields(want_q)
    assert fields(port.last_quarantine()) == fields(got_q)
    assert {q.index for q in got_q} <= set(bad) and got_q
    assert all(q.tier == "device" for q in got_q)
    if policy == "null" and name == "nullable":
        # all-nullable: every chunk keeps its row count
        assert sum(b.num_rows for b in got) == ROWS
    else:
        assert sum(b.num_rows for b in got) == ROWS - len(got_q)


@pytest.mark.parametrize("policy", ["skip", "null"])
def test_single_batch_entry_matches_the_reference(policy):
    datums, _bad = poisoned(NULLABLE, seed=5)
    got = port.deserialize_array(datums, NULLABLE, device="cpu",
                                 on_error=policy, return_errors=True)
    want = ref.deserialize_array(datums, NULLABLE, backend="tpu",
                                 on_error=policy, return_errors=True)
    same_batches([got[0]], [want[0]])
    assert fields(got[1]) == fields(want[1])
    # without return_errors: the bare batch, the entries in last_quarantine
    bare = port.deserialize_array(datums, NULLABLE, device="cpu",
                                  on_error=policy)
    assert bare.to_pylist() == got[0].to_pylist()
    assert fields(port.last_quarantine()) == fields(got[1])


def test_raise_is_unchanged_and_clean_batches_quarantine_nothing():
    datums, bad = poisoned(FLAT, seed=11)
    with pytest.raises(port.MalformedAvro) as ei:
        port.deserialize_array_threaded(datums, FLAT, 3, device="cpu")
    assert ei.value.index == bad[0]
    clean = datagen.random_datums(parse_schema(FLAT), 100, seed=2)
    out, errs = port.deserialize_array_threaded(
        clean, FLAT, 3, device="cpu", on_error="skip", return_errors=True)
    assert errs == [] and port.last_quarantine() == []
    assert sum(b.num_rows for b in out) == 100
    assert port.deserialize_array_threaded(
        clean, FLAT, 3, device="cpu", return_errors=True)[1] == []


# -- the assembly's per-column errors ------------------------------------------


def _column_datums(bad_utf8: bool, bad_duration: bool, n: int = 40):
    w = datagen.compile_writer(parse_schema(COLUMNS))
    out = []
    for i in range(n):
        buf = bytearray()
        w(buf, {"p": f"p{i}", "du": bytes(12)})
        out.append(bytes(buf))
    if bad_utf8:
        # a string of 2 bytes that are not UTF-8
        out[13] = b"\x04\xff\xfe" + bytes(12)
    if bad_duration:
        # 2^32 - 1 months: past Duration(ms) int64 on the device assembly
        out[29] = b"\x04p9" + b"\xff\xff\xff\xff" + bytes(8)
    return out


@pytest.mark.parametrize("case", ["utf8", "duration"])
def test_assembly_errors_under_raise_match_the_reference(case):
    datums = _column_datums(case == "utf8", case == "duration")
    codec = ref_codec(ref_entry(COLUMNS))
    kind = ValueError if case == "utf8" else OverflowError  # MalformedAvro
    with pytest.raises(kind) as want:
        codec.decode(datums)
    with pytest.raises(kind) as got:
        port.deserialize_array(datums, COLUMNS, device="cpu")
    assert str(got.value) == str(want.value)
    if case == "utf8":
        assert "invalid UTF-8 in string column 'p'" in str(got.value)
        assert got.value.index is None and want.value.index is None
    else:
        assert str(got.value) == ("duration at 'du' exceeds Duration(ms) "
                                  "int64")


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("case", ["utf8", "duration", "both"])
def test_assembly_errors_under_skip_go_to_the_oracle(case, chunks):
    """An assembly error names no row, so the chunk is served by the
    oracle, which names ``record i`` with ``tier="fallback"``, as in the
    reference."""
    datums = _column_datums(case != "duration", case != "utf8")
    got, got_q = port.deserialize_array_threaded(
        datums, COLUMNS, chunks, device="cpu", on_error="skip",
        return_errors=True)
    want, want_q = ref.deserialize_array_threaded(
        datums, COLUMNS, chunks, backend="tpu", on_error="skip",
        return_errors=True)
    same_batches(got, want)
    assert fields(got_q) == fields(want_q)
    expect = {"utf8": [(13, "bad_utf8")], "duration": [(29, "bad_value")],
              "both": [(13, "bad_utf8"), (29, "bad_value")]}[case]
    assert [(q.index, q.error) for q in got_q] == expect
    assert all(q.tier == "fallback" for q in got_q)


# -- the narrowed except --------------------------------------------------------


def test_a_kernel_fault_is_not_sent_to_the_oracle(monkeypatch):
    """Under ``on_error="skip"`` a wrapper that raises ``RuntimeError``
    (a failed build or launch) makes the call raise it; the reference
    would serve such a batch from its oracle."""
    datums, _bad = poisoned(FLAT, seed=3)

    def broken(*_args, **_kwargs):
        raise RuntimeError("decode_walk launch failed: CUDA error 700")

    monkeypatch.setattr(decode, "walk", broken)
    for chunks in (1, 8):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            port.deserialize_array_threaded(datums, FLAT, chunks,
                                            device="cpu", on_error="skip")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        port.deserialize_array(datums, FLAT, device="cpu", on_error="null")

    def broken_encode(*_args, **_kwargs):
        raise RuntimeError("encode_rows launch failed: CUDA error 700")

    monkeypatch.setattr(encode, "run_program", broken_encode)
    batch = _decimal_batch(np.random.default_rng(0), 16, [3])
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        port.serialize_record_batch(batch, DECIMAL, 2, device="cpu",
                                    on_error="skip")


def test_a_tier_limit_is_not_sent_to_the_oracle(monkeypatch):
    datums, _bad = poisoned(FLAT, seed=4)

    def too_big(*_args, **_kwargs):
        raise port.DeviceCapacityExceeded("needs more item slots")

    monkeypatch.setattr(decode, "walk", too_big)
    with pytest.raises(port.DeviceCapacityExceeded):
        port.deserialize_array(datums, FLAT, device="cpu", on_error="skip")

    def unsupported(*_args, **_kwargs):
        raise port.UnsupportedOnDevice("outside the device subset")

    monkeypatch.setattr(decode, "walk", unsupported)
    with pytest.raises(port.UnsupportedOnDevice):
        port.deserialize_array_threaded(datums, FLAT, 3, device="cpu",
                                        on_error="skip")


PLANTED = {
    "value_error": lambda: ValueError("walk buffers must be 16-B aligned"),
    "malformed_no_row": lambda: port.MalformedAvro("no row named"),
    "overflow": lambda: OverflowError("int too large"),
}


@pytest.mark.parametrize("kernel", ["walk", "finalize"])
@pytest.mark.parametrize("planted", sorted(PLANTED))
def test_a_wrapper_data_error_is_not_sent_to_the_oracle(monkeypatch, planted,
                                                        kernel):
    """A ``ValueError``, a ``MalformedAvro`` that names no row or an
    ``OverflowError`` from the K1 or K2 wrapper is a fault of the device
    tier, not of a record's value: under ``on_error="skip"`` the call
    raises it instead of decoding on the oracle."""
    datums, _bad = poisoned(FLAT, seed=6)
    want = type(PLANTED[planted]())

    def broken(*_args, **_kwargs):
        raise PLANTED[planted]()

    monkeypatch.setattr(decode, kernel, broken)
    for chunks in (1, 8):
        with pytest.raises(want):
            port.deserialize_array_threaded(datums, FLAT, chunks,
                                            device="cpu", on_error="skip")
    with pytest.raises(want):
        port.deserialize_array(datums, FLAT, device="cpu", on_error="null")


@pytest.mark.parametrize("planted", ["value_error", "overflow"])
def test_an_encode_wrapper_error_is_not_bisected(monkeypatch, planted):
    """A ``ValueError`` or ``OverflowError`` from the K3 wrapper is not
    a row's value: ``on_error="skip"`` raises it instead of quarantining
    every row."""
    batch = _decimal_batch(np.random.default_rng(1), 16, [3])
    want = type(PLANTED[planted]())

    def broken(*_args, **_kwargs):
        raise PLANTED[planted]()

    monkeypatch.setattr(encode, "run_program", broken)
    for policy in ("skip", "null"):
        with pytest.raises(want):
            port.serialize_record_batch(batch, DECIMAL, 2, device="cpu",
                                        on_error=policy)


def test_a_ladder_that_does_not_converge_raises(monkeypatch):
    """The capacity ladder's failure to converge is a limit of the engine
    (``DeviceCapacityExceeded``), raised under every policy."""
    datums, _bad = poisoned(FLAT, seed=7, n=64)
    monkeypatch.setattr(decode.DeviceDecoder, "_next_rung",
                        lambda *_args, **_kwargs: True)
    for policy in ("raise", "skip", "null"):
        with pytest.raises(port.DeviceCapacityExceeded, match="converge"):
            port.deserialize_array_threaded(datums, FLAT, 2, device="cpu",
                                            on_error=policy)


@pytest.mark.parametrize("chunks", [1, 3, 8])
def test_a_poisoned_chunk_costs_two_more_decodes(monkeypatch, chunks):
    """After the optimistic decode fails on the walk's error rows, each
    chunk decodes once, quarantines every bad row its walk names, and
    decodes its survivors once more: no row is searched for one by one."""
    from pyruhvro_tpu_torch.ops.codec import DeviceCodec
    from pyruhvro_tpu_torch.runtime.chunking import chunk_bounds

    datums, bad = poisoned(KAFKA, seed=9)
    calls = []
    real = DeviceCodec.decode

    def counted(self, data):
        calls.append(len(data))
        return real(self, data)

    monkeypatch.setattr(DeviceCodec, "decode", counted)
    out, quar = port.deserialize_array_threaded(
        datums, KAFKA, chunks, device="cpu", on_error="skip",
        return_errors=True)
    got = [q.index for q in quar]
    assert got and set(got) <= set(bad)
    want = [ROWS]
    for a, b in chunk_bounds(ROWS, chunks):
        named = sum(a <= i < b for i in got)
        want += [b - a, b - a - named] if named else [b - a]
    assert calls == want
    assert sum(b.num_rows for b in out) == ROWS - len(got)


def test_a_rows_slug_is_its_chunks_own():
    """A one-byte poisoned row is an overrun in the middle of a launch and
    a bad branch as its last lane, so a chunk's entries come from the
    chunk's own launch, as in the reference, not from the optimistic
    decode of the whole batch."""
    datums = datagen.kafka_style_datums(ROWS, seed=12)
    datums[84] = b"\x01"  # the last row of the first of 3 chunks
    with pytest.raises(port.MalformedAvro) as whole:
        port.deserialize_array(datums, KAFKA, device="cpu")
    assert whole.value.indices == [(84, "overrun")]
    got, got_q = port.deserialize_array_threaded(
        datums, KAFKA, 3, device="cpu", on_error="skip", return_errors=True)
    want, want_q = ref.deserialize_array_threaded(
        datums, KAFKA, 3, backend="tpu", on_error="skip", return_errors=True)
    same_batches(got, want)
    assert fields(got_q) == fields(want_q) == [
        (84, b"\x01", "bad_branch", "device")]


# -- encode ----------------------------------------------------------------------


def _decimal_batch(rng, n, bad, nullable=False):
    """``n`` decimals that fit one byte, ``bad`` rows of 200..999 that do
    not."""
    vals = [Decimal(int(v)) for v in rng.integers(-128, 128, size=n)]
    for i in bad:
        vals[i] = Decimal(int(rng.integers(200, 1000)))
    arr = pa.array(vals, type=pa.decimal128(3, 0))
    field = pa.field("d", arr.type, nullable=nullable)
    return pa.RecordBatch.from_arrays([arr], schema=pa.schema([field]))


@pytest.mark.parametrize("schema", ["plain", "nullable"])
@pytest.mark.parametrize("policy", ["skip", "null"])
def test_encode_policies_match_the_reference(policy, schema):
    rng = np.random.default_rng(21)
    bad = sorted(int(i) for i in rng.choice(300, size=4, replace=False))
    s = DECIMAL if schema == "plain" else NULL_DECIMAL
    batch = _decimal_batch(rng, 300, bad, nullable=schema == "nullable")
    with pytest.raises(OverflowError):
        port.serialize_record_batch(batch, s, 3, device="cpu")
    got, got_q = port.serialize_record_batch(
        batch, s, 3, device="cpu", on_error=policy, return_errors=True)
    want, want_q = ref.serialize_record_batch(
        batch, s, 3, backend="tpu", on_error=policy, return_errors=True)
    assert fields(got_q) == fields(want_q)
    assert [q.index for q in got_q] == bad
    assert all(q.datum is None and q.tier == "device" for q in got_q)
    assert [a.to_pylist() for a in got] == [a.to_pylist() for a in want]
    rows = sum(len(a) for a in got)
    assert rows == (300 if (policy, schema) == ("null", "nullable")
                    else 300 - len(bad))


# -- limits and input -----------------------------------------------------------


def test_max_datum_bytes_under_raise_and_skip(monkeypatch):
    datums = datagen.random_datums(parse_schema(FLAT), 120, seed=8)
    lens = np.array([len(d) for d in datums])
    limit = int(np.sort(lens)[-4])  # three datums are longer
    monkeypatch.setenv("PYRUHVRO_TPU_MAX_DATUM_BYTES", str(limit))
    for data in (datums, pa.array(datums, pa.binary())):
        with pytest.raises(port.MalformedAvro) as got:
            port.deserialize_array_threaded(data, FLAT, 3, device="cpu")
        with pytest.raises(ValueError) as want:
            ref.deserialize_array_threaded(data, FLAT, 3, backend="tpu")
        assert str(got.value) == str(want.value)
        assert got.value.err_name == "datum_too_large"
        assert got.value.tier == "policy"
    got, got_q = port.deserialize_array_threaded(
        datums, FLAT, 3, device="cpu", on_error="skip", return_errors=True)
    want, want_q = ref.deserialize_array_threaded(
        datums, FLAT, 3, backend="tpu", on_error="skip", return_errors=True)
    same_batches(got, want)
    assert fields(got_q) == fields(want_q)
    assert [q.index for q in got_q] == sorted(
        int(i) for i in np.flatnonzero(lens > limit))
    assert {q.error for q in got_q} == {"datum_too_large"}
    monkeypatch.setenv("PYRUHVRO_TPU_MAX_DATUM_BYTES", "0")
    assert port.deserialize_array(datums, FLAT,
                                  device="cpu").num_rows == 120


def test_argument_checks():
    empty = pa.RecordBatch.from_pylist([], schema=pa.schema([]))
    with pytest.raises(ValueError, match="on_error must be"):
        port.deserialize_array([], FLAT, device="cpu", on_error="ignore")
    with pytest.raises(ValueError, match="on_error must be"):
        port.serialize_record_batch(empty, FLAT, 1, device="cpu",
                                    on_error="drop")
    for backend in ("auto", "tpu"):
        with pytest.raises(ValueError, match="not ported"):
            port.deserialize_array([], FLAT, backend=backend)
    with pytest.raises(ValueError, match="backend must be"):
        port.deserialize_array_threaded([], FLAT, 2, backend="gpu")
    with pytest.raises(ValueError, match="timeout_s must be"):
        port.deserialize_array([], FLAT, device="cpu", timeout_s=-1)
    with pytest.raises(TypeError):
        port.deserialize_array([], FLAT, device="cpu", tenant="a")


def test_timeout_zero_raises_before_any_decode(monkeypatch):
    datums, _bad = poisoned(KAFKA, seed=1)
    walks = []
    real = decode.walk
    monkeypatch.setattr(decode, "walk",
                        lambda *a, **k: walks.append(1) or real(*a, **k))
    for policy in ("raise", "skip", "null"):
        with pytest.raises(port.DeadlineExceeded) as ei:
            port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu",
                                            on_error=policy, timeout_s=0)
        assert ei.value.site == "call_start" and ei.value.budget_s == 0
        assert ei.value.op == "deserialize_array_threaded"
    with pytest.raises(port.DeadlineExceeded):
        port.serialize_record_batch(
            pa.RecordBatch.from_pylist([{"x": 1, "s": "a"}]), FLAT, 1,
            device="cpu", timeout_s=0)
    with pytest.raises(port.DeadlineExceeded):
        port.deserialize_array(datums, KAFKA, backend="host", timeout_s=0)
    assert walks == []
    e = pickle.loads(pickle.dumps(ei.value))
    assert (e.op, e.site, e.budget_s, str(e)) == (
        ei.value.op, ei.value.site, 0, str(ei.value))
    # the knob is the default budget; the keyword wins
    clean = datagen.kafka_style_datums(10, seed=1)
    monkeypatch.setenv("PYRUHVRO_TPU_DEADLINE_S", "0")
    with pytest.raises(port.DeadlineExceeded):
        port.deserialize_array(clean, KAFKA, device="cpu")
    assert port.deserialize_array(clean, KAFKA, device="cpu",
                                  timeout_s=600).num_rows == 10


def test_deadline_checks_every_rung_chunk_and_resume(monkeypatch):
    """A generous budget changes nothing, and the checks run where the
    reference puts them: call start, each ladder rung, each chunk of the
    overlapped path, each tolerant resume."""
    datums, _bad = poisoned(KAFKA, seed=12)
    sites = []
    real = deadline.check

    def spy(index=None, site=None):
        sites.append(site)
        real(index=index, site=site)

    monkeypatch.setattr(deadline, "check", spy)
    got = port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu",
                                          on_error="skip", timeout_s=600)
    monkeypatch.setattr(deadline, "check", real)
    want = port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu",
                                           on_error="skip")
    same_batches(got, want)
    assert {"call_start", "device.capacity_ladder", "device.chunk",
            "tolerant.resume"} <= set(sites)


@pytest.mark.parametrize("form", ["binary", "large_binary", "chunked"])
def test_arrow_input_equals_the_list(form):
    datums = datagen.kafka_style_datums(ROWS, seed=9)
    if form == "binary":
        data = pa.array(datums, pa.binary())
    elif form == "large_binary":
        data = pa.array(datums, pa.large_binary())
    else:
        data = pa.chunked_array([pa.array(datums[:100], pa.binary()),
                                 pa.array(datums[100:], pa.binary())])
    want = port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu")
    same_batches(port.deserialize_array_threaded(data, KAFKA, 8,
                                                 device="cpu"), want)
    # a slice of an array starts at a non-zero offset into its buffers
    sliced = pa.array(datums, pa.binary()).slice(37, 150)
    same_batches([port.deserialize_array(sliced, KAFKA, device="cpu")],
                 [port.deserialize_array(datums[37:187], KAFKA,
                                         device="cpu")])
    same_batches(
        port.deserialize_array_threaded(data, KAFKA, 8, backend="host"),
        ref.deserialize_array_threaded(data, KAFKA, 8, backend="host"))


def test_arrow_input_under_the_policies_and_the_k4_engine(monkeypatch):
    datums, _bad = poisoned(NULLABLE, seed=14)
    arr = pa.array(datums, pa.binary())
    for policy in ("skip", "null"):
        got = port.deserialize_array_threaded(
            arr, NULLABLE, 3, device="cpu", on_error=policy,
            return_errors=True)
        want = port.deserialize_array_threaded(
            datums, NULLABLE, 3, device="cpu", on_error=policy,
            return_errors=True)
        same_batches(got[0], want[0])
        assert fields(got[1]) == fields(want[1])
    monkeypatch.setenv("PYRUHVRO_TPU_PALLAS", "1")
    clean = datagen.random_datums(parse_schema(NULLABLE), 90, seed=1)
    same_batches([port.deserialize_array(pa.array(clean, pa.binary()),
                                         NULLABLE, device="cpu")],
                 [port.deserialize_array(clean, NULLABLE, device="cpu")])
    # the K4 engine names every bad row too, so one pass quarantines
    # them; its survivors and bad rows are the oracle's
    got = port.deserialize_array(arr, NULLABLE, device="cpu",
                                 on_error="skip", return_errors=True)
    host = port.deserialize_array(datums, NULLABLE, backend="host",
                                  on_error="skip", return_errors=True)
    same_batches([got[0]], [host[0]])
    assert [q.index for q in got[1]] == [q.index for q in host[1]]
    assert all(q.tier == "device" for q in got[1])


def test_arrays_with_nulls_are_refused():
    arr = pa.array([b"\x02\x00", None], pa.binary())
    with pytest.raises(ValueError, match="null"):
        port.deserialize_array(arr, FLAT, device="cpu")
    with pytest.raises(ValueError, match="null"):
        port.deserialize_array_threaded(pa.chunked_array([arr]), FLAT, 1,
                                        backend="host")


# -- the host tier ----------------------------------------------------------------


@pytest.mark.parametrize("policy", ["raise", "skip", "null"])
def test_host_backend_equals_the_reference_oracle(policy, monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_NO_NATIVE", "1")
    schema = NULLABLE if policy == "null" else KAFKA
    if policy == "raise":
        datums = datagen.kafka_style_datums(ROWS, seed=18)
    else:
        datums, _bad = poisoned(schema, seed=18)
    kw = {} if policy == "raise" else {"on_error": policy}
    got, got_q = port.deserialize_array_threaded(
        datums, schema, 3, backend="host", return_errors=True, **kw)
    want, want_q = ref.deserialize_array_threaded(
        datums, schema, 3, backend="host", return_errors=True, **kw)
    same_batches(got, want)
    assert fields(got_q) == fields(want_q)
    assert all(q.tier == "fallback" for q in got_q)
    # the host tier ignores device: no card is needed
    batch = port.deserialize_array(datums[:50], schema, backend="host",
                                   device="cuda", **kw)
    if policy == "raise":
        wire = port.serialize_record_batch(batch, schema, 4, backend="host")
        assert wire[0].to_pylist() + wire[1].to_pylist() + \
            wire[2].to_pylist() + wire[3].to_pylist() == datums[:50]
        assert [a.to_pylist() for a in wire] == [
            a.to_pylist() for a in ref.serialize_record_batch(
                batch, schema, 4, backend="host")]
        card = port.serialize_record_batch(batch, schema, 4, device="cpu")
        assert [a.to_pylist() for a in card] == [
            a.to_pylist() for a in wire]


def test_host_backend_encode_policies_equal_the_reference(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_NO_NATIVE", "1")
    rng = np.random.default_rng(4)
    batch = _decimal_batch(rng, 64, [5, 40], nullable=True)
    for schema in (DECIMAL, NULL_DECIMAL):
        for policy in ("skip", "null"):
            got, got_q = port.serialize_record_batch(
                batch, schema, 2, backend="host", on_error=policy,
                return_errors=True)
            want, want_q = ref.serialize_record_batch(
                batch, schema, 2, backend="host", on_error=policy,
                return_errors=True)
            assert fields(got_q) == fields(want_q)
            assert [q.index for q in got_q] == [5, 40]
            assert [a.to_pylist() for a in got] == [
                a.to_pylist() for a in want]


# -- the spawn aliases ------------------------------------------------------------


def test_spawn_aliases_return_what_the_threaded_entries_return():
    datums, bad = poisoned(NULLABLE, seed=23)
    for kw in ({"device": "cpu", "on_error": "skip"},
               {"device": "cpu", "on_error": "null"},
               {"backend": "host", "on_error": "skip"}):
        a = port.deserialize_array_threaded(datums, NULLABLE, 3,
                                            return_errors=True, **kw)
        b = port.deserialize_array_threaded_spawn(datums, NULLABLE, 3,
                                                  return_errors=True, **kw)
        same_batches(a[0], b[0])
        assert fields(a[1]) == fields(b[1])
    with pytest.raises(port.MalformedAvro) as ei:
        port.deserialize_array_threaded_spawn(datums, NULLABLE, 3,
                                              device="cpu")
    assert ei.value.index == bad[0]
    batch = port.deserialize_array(datums, NULLABLE, device="cpu",
                                   on_error="skip")
    for kw in ({"device": "cpu"}, {"backend": "host"}):
        a = port.serialize_record_batch(batch, NULLABLE, 5, **kw)
        b = port.serialize_record_batch_spawn(batch, NULLABLE, 5, **kw)
        assert [x.to_pylist() for x in a] == [x.to_pylist() for x in b]
