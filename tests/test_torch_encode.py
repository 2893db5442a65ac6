"""The port's encode (K3) held against the JAX reference, on the CPU.

* the extractor (``ops/encode_extract.py``) equals the reference's
  ``extract_batch`` key for key: dtype, values and the byte bound;
* the plain program (``ops/encode.py`` ``encode_plain``) writes the bytes
  of the reference's ``DeviceEncoder.encode`` and of the oracle encoder;
* a Python model of ``csrc/encode.cu`` (``model_encode_rows``,
  ``model_encode_strings``), run through the real encode code and launch
  tables by ``_EncodeKernel.run``, is bit-equal to the plain version;
* the codec's halving, the public ``serialize_record_batch`` and its
  errors match the reference.

Encode is integer work: every comparison is exact.
"""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import pyruhvro_tpu as ref_api  # noqa: E402
from pyruhvro_tpu.fallback.decoder import decode_to_record_batch  # noqa: E402
from pyruhvro_tpu.fallback.encoder import encode_record_batch  # noqa: E402
from pyruhvro_tpu.ops import encode as ref_encode  # noqa: E402
from pyruhvro_tpu.schema.cache import get_or_parse_schema as ref_entry  # noqa: E402
from pyruhvro_tpu.utils.datagen import KAFKA_SCHEMA_JSON, random_datums  # noqa: E402
from test_device_decode import SHAPES  # noqa: E402

from pyruhvro_tpu_torch import (  # noqa: E402
    BatchTooLarge,
    deserialize_array,
    serialize_record_batch,
)
from pyruhvro_tpu_torch.ops import encode  # noqa: E402
from pyruhvro_tpu_torch.ops import encode_extract  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402
from pyruhvro_tpu_torch.utils.datagen import kafka_style_datums  # noqa: E402

SCHEMAS = {**SHAPES, "kafka": KAFKA_SCHEMA_JSON,
           "logical": chip_smoke.LOGICAL_SCHEMA}
ROWS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cpu_decode(datums, schema):
    return deserialize_array(datums, schema, device="cpu")


FIXTURES = {name: (schema, batch) for name, schema, batch in
            chip_smoke.encode_fixtures(pa, datagen, parse_schema,
                                       _cpu_decode, ROWS)}


def _batch(name: str, rows: int, seed: int) -> pa.RecordBatch:
    """A batch of ``rows`` rows of ``SCHEMAS[name]`` from the oracle's
    decode (the logical schema: the encode fixture's batch)."""
    schema = SCHEMAS[name]
    if name == "logical":
        return FIXTURES["logical_types"][1]
    e = ref_entry(schema)
    datums = (kafka_style_datums(rows, seed=seed) if name == "kafka"
              else random_datums(e.ir, rows, seed=seed))
    return decode_to_record_batch(datums, e.ir, e.arrow_schema)


def _encoder(schema: str, device="cpu") -> encode.DeviceEncoder:
    e = get_or_parse_schema(schema)
    return encode.DeviceEncoder(e.ir, e.arrow_schema, device)


def _wire(arr: pa.Array):
    return [bytes(x) for x in arr.to_pylist()]


# -- the extractor ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_extractor_matches_reference(name):
    rows = 24 + 127 * (sorted(SCHEMAS).index(name) % 2)
    batch = _batch(name, rows, seed=5)
    schema = SCHEMAS[name]
    e, re_ = get_or_parse_schema(schema), ref_entry(schema)
    dv, bound = encode_extract.extract_batch(encode.lower_encoder(e.ir),
                                             batch, e.ir)
    want, want_bound = ref_encode.extract_batch(
        ref_encode.lower_encoder(re_.ir), batch, re_.ir)
    assert bound == want_bound
    assert sorted(dv) == sorted(want)
    for key in want:
        assert dv[key].dtype == want[key].dtype, key
        assert np.array_equal(dv[key], want[key]), key
    assert encode_extract.input_entries(dv) == ref_encode.input_entries(want)


def _set_column(batch, name, arr):
    cols = list(batch.columns)
    i = batch.schema.get_field_index(name)
    cols[i] = arr
    fields = list(batch.schema)
    fields[i] = pa.field(name, arr.type)
    return pa.RecordBatch.from_arrays(cols, schema=pa.schema(fields))


def _bad_batches():
    flat = _batch("flat", 3, seed=79)
    kafka = _batch("kafka", 4, seed=3)
    union = _batch("union", 6, seed=2)
    u = union.column(union.schema.get_field_index("u"))
    tids = np.frombuffer(u.buffers()[1], np.int8, count=len(u)).copy()
    tids[1] = 9
    bad_u = pa.UnionArray.from_sparse(
        pa.array(tids, pa.int8()), [u.field(k) for k in range(u.type.num_fields)],
        [f.name for f in u.type], list(u.type.type_codes))
    return {
        "missing column": ("flat", pa.RecordBatch.from_pydict(
            {"wrong": pa.array([1, 2])})),
        "wrong Arrow type": ("flat", _set_column(
            flat, "a", pa.array(["x", "y", "z"]))),
        "null at a non-nullable position": ("flat", _set_column(
            flat, "a", pa.array([1, None, 3], pa.int64()))),
        "unknown enum symbol": ("kafka", _set_column(
            kafka, "class", pa.array(["A", "Q", "B", "C"]))),
        "union type_id out of range": ("union", _set_column(
            union, "u", bad_u)),
        "array of null items": ("null_items", FIXTURES_NULL_ITEMS),
    }


FIXTURES_NULL_ITEMS = _cpu_decode(
    [chip_smoke.zz(2) + chip_smoke.zz(0) + chip_smoke.zz(1) + b"x"],
    chip_smoke.NULLS_SCHEMA)
SCHEMAS_ERR = {**SCHEMAS, "null_items": chip_smoke.NULLS_SCHEMA}


@pytest.mark.parametrize("case", sorted(_bad_batches()))
def test_value_errors_match_reference(case):
    name, batch = _bad_batches()[case]
    schema = SCHEMAS_ERR[name]
    e, re_ = get_or_parse_schema(schema), ref_entry(schema)
    with pytest.raises(ValueError) as want:
        ref_encode.extract_batch(ref_encode.lower_encoder(re_.ir), batch,
                                 re_.ir)
    with pytest.raises(ValueError) as got:
        serialize_record_batch(batch, schema, 2, device="cpu")
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


# -- the plain program ---------------------------------------------------------


@pytest.fixture(scope="module")
def ref_encoders():
    """The reference's encoders (one XLA CPU compile per shape bucket)."""
    out = {}
    for name in ("kafka", "arr", "arr_rec_arr"):
        e = ref_entry(SCHEMAS[name])
        out[name] = ref_encode.DeviceEncoder(e.ir, e.arrow_schema)
    return out


@pytest.mark.parametrize("name", ["kafka", "arr", "arr_rec_arr"])
def test_plain_program_matches_reference_encoder(name, ref_encoders):
    batch = _batch(name, 40, seed=11)
    want = ref_encoders[name].encode(batch)
    got = _encoder(SCHEMAS[name]).encode(batch)
    assert _wire(got) == _wire(want)
    assert got.equals(want)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_plain_program_matches_oracle(name):
    batch = _batch(name, 151, seed=61)
    got = _wire(_encoder(SCHEMAS[name]).encode(batch))
    assert got == encode_record_batch(batch, ref_entry(SCHEMAS[name]).ir)


def test_plain_program_blob_layout():
    """``encode_plain`` returns the reference's ``[cap | row_sizes]``:
    the rows' bytes back to back, zeros after them, then the sizes."""
    schema, batch = FIXTURES["kafka"]
    enc = _encoder(schema)
    L = enc.launch(batch)
    blob = encode.encode_plain(L.dv(), enc.prog, L.cap).numpy()
    sizes = blob[L.cap:].view(np.int32)
    want = encode_record_batch(batch, ref_entry(schema).ir)
    assert sizes.size == L.R and list(sizes[:L.n]) == list(map(len, want))
    assert not sizes[L.n:].any()
    total = int(sizes.sum())
    assert bytes(blob[:total]) == b"".join(want)
    assert not blob[total:L.cap].any()


# -- a model of csrc/encode.cu, through the real launch tables ----------------------


def _typed(buf: np.ndarray, at: int, dtype) -> np.ndarray:
    dt = np.dtype(dtype)
    return np.frombuffer(buf, dt, count=(buf.size - at) // dt.itemsize,
                         offset=at)


def model_encode_rows(L, write: bool, row_sizes, cum=None, out=None,
                      reads=None):
    """What one ``encode_rows`` launch writes, one row at a time, step by
    step as the kernel's ``RowWalk::run``. ``reads``, where given, gathers
    each ``(lane, index)`` the walk reads and each ``#dst`` it writes."""
    buf = L.buf.numpy()
    code = L.code_view().numpy().tolist()
    lanes = L.lanes_view().numpy().tolist()
    sizes = row_sizes.numpy()
    outb = None if out is None else out.numpy()

    def at(lane, idx, dtype):
        if reads is not None:
            reads.add((lane, idx))
        return int(_typed(buf, lanes[lane], dtype)[idx])

    for row in range(L.R):
        if row >= L.n:
            if not write:
                sizes[row] = 0
            continue
        start = int(cum.numpy()[row]) - int(sizes[row]) if write else 0
        pos = 0

        def put(b):
            nonlocal pos
            if write:
                outb[start + pos] = b & 0xFF
            pos += 1

        def varint(z):
            while z >= 0x80:
                put((z & 0x7F) | 0x80)
                z >>= 7
            put(z)

        def varint32(v):
            varint(((v << 1) ^ (v >> 31)) & 0xFFFFFFFF)

        def decimal(lane, idx, n):
            if reads is not None:
                reads.add((lane, idx))
            dec = _typed(buf, lanes[lane], np.uint8)[16 * idx:16 * idx + 16]
            fill = 0xFF if dec[15] >= 0x80 else 0
            for k in range(n):
                le = n - 1 - k
                put(int(dec[le]) if le < 16 else fill)

        stack, pc = [], 0
        while True:
            idx = stack[-1][0] if stack else row
            op = code[pc]
            if op == encode.OP_VARINT32:
                varint32(at(code[pc + 1], idx, np.int32))
                pc += 2
            elif op == encode.OP_VARINT64:
                x = at(code[pc + 1], idx, np.uint32) | (
                    at(code[pc + 2], idx, np.uint32) << 32)
                varint(((x << 1) ^ (0 - (x >> 63))) & (2**64 - 1))
                pc += 3
            elif op in (encode.OP_F32, encode.OP_F64):
                for lane in code[pc + 1:pc + (2 if op == encode.OP_F32
                                               else 3)]:
                    w = at(lane, idx, np.uint32)
                    for k in range(4):
                        put(w >> (8 * k))
                pc += 2 if op == encode.OP_F32 else 3
            elif op == encode.OP_BOOL:
                put(at(code[pc + 1], idx, np.uint8))
                pc += 2
            elif op in (encode.OP_STRING, encode.OP_PAYLOAD):
                if op == encode.OP_STRING:
                    size = at(code[pc + 1], idx, np.int32)
                    varint32(size)
                else:
                    size = code[pc + 1]
                if reads is not None:
                    reads.add((code[pc + 2], idx))
                if write:
                    _typed(buf, lanes[code[pc + 2]], np.int32)[idx] = \
                        start + pos
                pos += size
                pc += 3
            elif op == encode.OP_DEC_BYTES:
                n = at(code[pc + 1], idx, np.int32)
                varint32(n)
                decimal(code[pc + 2], idx, n)
                pc += 3
            elif op == encode.OP_DEC_FIXED:
                decimal(code[pc + 2], idx, code[pc + 1])
                pc += 3
            elif op == encode.OP_NULLABLE:
                valid = at(code[pc + 1], idx, np.uint8) != 0
                null_idx = code[pc + 2]
                varint32(1 - null_idx if valid else null_idx)
                pc = pc + 4 if valid else code[pc + 3]
            elif op == encode.OP_UNION:
                tid, n = at(code[pc + 1], idx, np.int32), code[pc + 2]
                varint32(tid)
                arm = code[pc + 4 + tid] if 0 <= tid < n else -1
                pc = arm if arm >= 0 else code[pc + 3]
            elif op == encode.OP_JUMP:
                pc = code[pc + 1]
            elif op == encode.OP_REPEATED:
                count = at(code[pc + 1], idx, np.int32)
                if count > 0:
                    varint32(count)
                    first = at(code[pc + 2], idx, np.int32)
                    stack.append([first, first + count, pc])
                    pc += 4
                else:
                    put(0)
                    pc = code[pc + 3]
            elif op == encode.OP_LOOP:
                top = stack[-1]
                top[0] += 1
                if top[0] < top[1]:
                    pc = top[2] + 4
                else:
                    stack.pop()
                    put(0)
                    pc += 2
            else:
                assert op == encode.OP_END, op
                break
        if not write:
            sizes[row] = pos


def model_encode_strings(L, out) -> None:
    """What one ``encode_strings`` launch writes: element by element of
    the column table, its bytes from ``#bytes`` at ``#src`` to ``#dst``."""
    buf = L.buf.numpy()
    lanes = L.lanes_view().numpy().tolist()
    outb = out.numpy()
    for src_l, len_l, bytes_l, dst_l, n_el, _base in \
            L.cols_view().numpy().reshape(-1, 6).tolist():
        src = _typed(buf, lanes[src_l], np.int32)
        lens = _typed(buf, lanes[len_l], np.int32)
        data = _typed(buf, lanes[bytes_l], np.uint8)
        dst = _typed(buf, lanes[dst_l], np.int32)
        for j in range(n_el):
            if dst[j] >= 0:
                outb[dst[j]:dst[j] + lens[j]] = data[src[j]:src[j] + lens[j]]


class _ModelEncodeKernel(encode._EncodeKernel):
    """``_EncodeKernel`` with the models in place of the launches."""

    def launch_rows(self, L, write, row_sizes, cum=None, out=None):
        model_encode_rows(L, write, row_sizes, cum, out)
        self._count(self.rows)

    def launch_strings(self, L, out):
        model_encode_strings(L, out)
        self._count(self.strings)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_kernel_model_matches_plain_version(name):
    schema, batch = FIXTURES[name]
    enc = _encoder(schema)
    if batch.num_rows == 0:
        assert len(enc.encode(batch)) == 0
        return
    L = enc.launch(batch)
    plain_out, plain_sizes, plain_dst = encode.rows_plain(L.dv(), enc.prog,
                                                          L.cap)
    encode.strings_plain(plain_out, L.dv(), enc.prog, plain_dst)
    kernel = _ModelEncodeKernel()
    out, sizes = kernel.run(L)
    assert torch.equal(sizes, plain_sizes)
    total = int(sizes.to(torch.int64).sum())
    assert torch.equal(out[:total], plain_out[:total])
    for path, dst in L.dst().items():
        assert torch.equal(dst, plain_dst[path]), path
    assert kernel.rows.launches == 2
    assert kernel.strings.launches == (1 if L.n_elems else 0)
    # the tables the kernel reads: each #off the exclusive running sum of
    # its #count over every lane of the parent axis
    for rid in range(1, len(enc.prog.regions)):
        path = enc.prog.regions[rid]
        counts = L.view(path + "#count").to(torch.int64)
        assert L.view(path + "#off").tolist() == [0] + torch.cumsum(
            counts, 0).tolist()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rows_traffic_counts_what_the_kernel_reads(name):
    """``chip_smoke.rows_traffic``, the walk behind ``encode_rows``' byte
    bound, counts exactly the lane entries the kernel's model reads and
    the ``#dst`` entries it writes."""
    schema, batch = FIXTURES[name]
    enc = _encoder(schema)
    if batch.num_rows == 0:
        return
    L = enc.launch(batch)
    L.set_offsets()
    reads = set()
    model_encode_rows(L, False, torch.empty(L.R, dtype=torch.int32),
                      reads=reads)
    lanes = enc.prog.lanes
    got = {"lanes": 0, "off": 0, "dst": 0}
    for lane, _idx in reads:
        key = lanes[lane]
        kind = key[key.rindex("#") + 1:]
        if kind in ("off", "dst"):
            got[kind] += 4
        else:
            got["lanes"] += 16 if kind == "dec" else \
                L.dv_np[key].itemsize
    assert chip_smoke.rows_traffic(np, encode, L) == got


def test_launch_buffer_is_aligned_and_names_every_lane():
    schema, batch = FIXTURES["logical_types"]
    enc = _encoder(schema)
    L = enc.launch(batch)
    assert all(at % 16 == 0 for at, _dt, _ln in L.layout.values())
    assert set(enc.prog.lanes) <= set(L.layout)
    assert L.lanes_view().tolist() == [L.layout[k][0] for k in enc.prog.lanes]
    assert L.in_bytes <= L.dst_at <= L.total_bytes
    assert L.n_elems == sum(L.view(c.path + "#len").numel()
                            for c in enc.prog.string_cols)


def test_kernel_library_declares_every_argument(monkeypatch):
    """ctypes passes every pointer and the stream as c_void_p, every
    ``long long`` as c_longlong and every ``int`` as c_int, in the order
    of each C entry point of ``encode.cu``."""
    from pyruhvro_tpu_torch.ops import _build

    src = (Path(_build.CSRC) / "encode.cu").read_text()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(entries) == {"encode_rows", "encode_strings"}
    fns = {name: ctypes.CDLL(None).strlen for name in entries}
    lib = types.SimpleNamespace(cdll=types.SimpleNamespace(**fns))
    monkeypatch.setattr(_build, "load_kernel_library", lambda s: lib)
    encode.encode_kernel.library()
    for name, params in entries.items():
        kinds = [ctypes.c_void_p if "*" in p else
                 ctypes.c_longlong if "long long" in p else ctypes.c_int
                 for p in params.split(",")]
        assert fns[name].argtypes == kinds, name
        assert fns[name].restype is ctypes.c_int, name


def test_source_agrees_on_opcodes_and_limits():
    from pyruhvro_tpu_torch.ops import _build

    src = (Path(_build.CSRC) / "encode.cu").read_text()
    defined = dict(re.findall(r"#define (OP_\w+) (\d+)", src))
    assert {k: int(v) for k, v in defined.items()} == encode.OPCODES
    assert re.search(r"kMaxDepth = (\d+)", src).group(1) == \
        str(encode.MAX_DEPTH)
    assert re.search(r"kWarpCopy = (\d+)", src).group(1) == \
        str(encode.STRINGS_PER_WARP_BYTES)


@pytest.mark.parametrize("name, per_warp", [
    ("kafka", False), ("sliced", False), ("len16", True),
    ("record_64KiB_len16", True)])
def test_string_copy_mode_follows_the_payload_size(name, per_warp):
    """A warp per payload element where the payload buffers hold 32 bytes
    or more per lane (records of kilobytes), else a thread per element."""
    schema, batch = FIXTURES[name]
    assert _encoder(schema).launch(batch).strings_per_warp is per_warp


def test_kernel_wrappers_refuse_cpu_tensors():
    schema, batch = FIXTURES["kafka"]
    L = _encoder(schema).launch(batch)
    sizes = torch.empty(L.R, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        encode.encode_kernel.launch_rows(L, False, sizes)
    with pytest.raises(ValueError, match="CUDA"):
        encode.encode_kernel.launch_strings(L, torch.empty(L.cap,
                                                           dtype=torch.uint8))
    assert encode.encode_kernel.rows.launches == 0


# -- codec and API ----------------------------------------------------------------------


def test_serialize_matches_reference_per_chunk():
    datums = kafka_style_datums(130, seed=83)
    batch = ref_api.deserialize_array(datums, KAFKA_SCHEMA_JSON,
                                      backend="host")
    want = ref_api.serialize_record_batch(batch, KAFKA_SCHEMA_JSON, 4,
                                          backend="tpu")
    got = serialize_record_batch(batch, KAFKA_SCHEMA_JSON, 4, device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.to_pylist() == w.to_pylist()
    # a Table takes the same path, and the wire is the input datums'
    table = pa.Table.from_batches([batch])
    got_t = serialize_record_batch(table, KAFKA_SCHEMA_JSON, 4, device="cpu")
    assert sum((_wire(a) for a in got_t), []) == datums


def test_halving_keeps_the_bytes(monkeypatch):
    schema, batch = FIXTURES["kafka"]
    whole = _wire(serialize_record_batch(batch, schema, 1, device="cpu")[0])
    calls = []
    real = encode.DeviceEncoder.encode

    def counting(self, b):
        calls.append(b.num_rows)
        return real(self, b)

    monkeypatch.setattr(encode.DeviceEncoder, "encode", counting)
    monkeypatch.setattr(encode, "MAX_OUTPUT_BYTES", 600)
    got = serialize_record_batch(batch, schema, 3, device="cpu")
    assert sum((_wire(a) for a in got), []) == whole
    assert calls[0] == batch.num_rows and max(calls[1:]) < batch.num_rows
    monkeypatch.setattr(encode, "MAX_OUTPUT_BYTES", 16)
    with pytest.raises(BatchTooLarge):
        serialize_record_batch(batch.slice(0, 1), schema, 1, device="cpu")


def test_sliced_batch_with_a_sparse_union_at_an_offset():
    schema, batch = FIXTURES["sliced"]
    assert batch.column(batch.schema.get_field_index("status")).offset > 0
    got = sum((_wire(a) for a in serialize_record_batch(
        batch, schema, 3, device="cpu")), [])
    assert got == encode_record_batch(batch, ref_entry(schema).ir)
    back = deserialize_array(got, schema, device="cpu")
    assert back.to_pylist() == batch.to_pylist()


@pytest.mark.parametrize("name", ["kafka", "arr_rec_arr", "logical_types",
                                  "extreme_varints"])
def test_wire_is_a_fixed_point(name):
    schema, batch = FIXTURES[name]
    if name == "logical_types":
        batch = batch.slice(2)  # the int128 extremes do not decode back
    once = sum((_wire(a) for a in serialize_record_batch(
        batch, schema, 2, device="cpu")), [])
    again = sum((_wire(a) for a in serialize_record_batch(
        deserialize_array(once, schema, device="cpu"), schema, 2,
        device="cpu")), [])
    assert again == once


def test_phase_timings_only_when_asked():
    """A ``timings`` dict gets the host phases; the bytes are the same
    either way."""
    schema, batch = FIXTURES["kafka"]
    enc = _encoder(schema)
    timings = {}
    assert _wire(enc.encode(batch, timings)) == _wire(enc.encode(batch))
    assert {"extract_s", "pack_s", "h2d_s", "d2h_s", "wrap_s",
            "total_s"} <= set(timings)
    assert all(v >= 0 for v in timings.values())


def test_empty_batch_encodes_to_an_empty_array():
    schema, batch = FIXTURES["empty"]
    got = serialize_record_batch(batch, schema, 4, device="cpu")
    assert len(got) == 1 and len(got[0]) == 0 and got[0].type == pa.binary()


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema, batch = FIXTURES["kafka"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serialize_record_batch(batch, schema, 2)


def test_too_deep_nesting_is_unsupported():
    from pyruhvro_tpu_torch import UnsupportedOnDevice

    t = '"int"'
    for _ in range(encode.MAX_DEPTH + 1):
        t = '{"type":"array","items":%s}' % t
    schema = '{"type":"record","name":"D","fields":[{"name":"x","type":%s}]}' % t
    with pytest.raises(UnsupportedOnDevice, match="nests"):
        encode.lower_encoder(parse_schema(schema))

