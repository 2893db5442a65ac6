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
def test_value_errors_match_reference(case, monkeypatch):
    name, batch = _bad_batches()[case]
    schema = SCHEMAS_ERR[name]
    e, re_ = get_or_parse_schema(schema), ref_entry(schema)
    if case == "array of null items":
        # the port departs here (ROADMAP.md (c) 1): a null item is the
        # only value of a null position, so every tier writes the
        # oracle's wire, zero bytes per item, where the reference's
        # extractor raises
        want = encode_record_batch(batch, re_.ir)
        assert want == [b"\x04\x00\x02x"]
        for backend, no_native in (("device", ""), ("host", ""),
                                   ("host", "1")):
            monkeypatch.setenv("PYRUHVRO_TPU_NO_NATIVE", no_native)
            got = serialize_record_batch(batch, schema, 2, device="cpu",
                                         backend=backend)
            assert [v for a in got for v in a.to_pylist()] == want
        return
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
                      reads=None, budget: int = 0, seed: int = 0):
    """What one ``encode_rows`` launch writes, block by block of
    ``ROW_BLOCK`` rows and row by row as the kernel's ``RowWalk::run``.
    In write mode a block whose span ``[S, E)``, widened down to a 16-B
    bound, fits ``budget`` writes into a shared-memory stand-in filled
    with random bytes (the payload positions keep them) and stores the
    span whole: bytes over the head and tail, 16-B pieces between;
    returns ``(staged, direct)`` blocks. ``reads``, where given, gathers
    each ``(lane, index)`` the walk reads and each ``#dst`` it writes."""
    buf = L.buf.numpy()
    code = L.code_view().numpy().tolist()
    lanes = L.lanes_view().numpy().tolist()
    sizes = row_sizes.numpy()
    outb = None if out is None else out.numpy()
    cumv = None if cum is None else cum.numpy().astype(np.int64)
    rng = np.random.default_rng(seed)
    blocks = [0, 0]

    def at(lane, idx, dtype):
        if reads is not None:
            reads.add((lane, idx))
        return int(_typed(buf, lanes[lane], dtype)[idx])

    def walk(row, target, origin, start):
        """One row's walk; ``target[start + pos]`` takes its bytes and
        each ``#dst`` the output position ``origin + start + pos``."""
        pos = 0

        def put(b):
            nonlocal pos
            if write:
                target[start + pos] = b & 0xFF
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
                        origin + start + pos
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
                return pos

    for r0 in range(0, L.R, encode.ROW_BLOCK):
        rows = range(r0, min(r0 + encode.ROW_BLOCK, L.n))
        if not write:
            for row in range(r0, min(r0 + encode.ROW_BLOCK, L.R)):
                sizes[row] = walk(row, None, 0, 0) if row < L.n else 0
            continue
        if not rows:
            continue
        S = int(cumv[r0] - sizes[r0])
        E = int(cumv[rows[-1]])
        S0 = S & ~15
        if E - S0 > budget:
            blocks[1] += 1
            for row in rows:
                walk(row, outb, 0, int(cumv[row] - sizes[row]))
            continue
        blocks[0] += 1
        smem = rng.integers(0, 256, budget, dtype=np.uint8)
        for row in rows:
            walk(row, smem, S0, int(cumv[row] - sizes[row]) - S0)
        A = min((S + 15) & ~15, E)
        B = max(E & ~15, A)
        assert A - S < 16 and E - B < 16 and (B - A) % 16 == 0
        outb[S:A] = smem[S - S0:A - S0]
        outb[B:E] = smem[B - S0:E - S0]
        for g in range(A, B, 16):
            outb[g:g + 16] = smem[g - S0:g - S0 + 16]
    return tuple(blocks)


INT_MAX = 2**31 - 1


def _count_le(src, n, x, samples):
    """The kernel's ``count_le``: the elements of ``src[0, n)`` at or below
    ``x``, each step sampling ``samples`` points of the range left."""
    lo, hi = 0, n
    t = np.arange(1, samples + 1, dtype=np.int64)
    while lo < hi:
        span = hi - lo
        c = int(np.count_nonzero(src[lo + span * t // (samples + 1)] <= x))
        new_lo = lo + span * c // (samples + 1) + 1 if c else lo
        hi = lo + span * (c + 1) // (samples + 1) if c < samples else hi
        lo = new_lo
    return lo


def _slot_carry(tops, threads):
    """Each thread's carry into its slot: the largest mark of the slots
    before it, as the kernel's warp scan (``__shfl_up_sync``) and its
    per-warp totals give it."""
    tops = np.asarray(tops).reshape(-1, min(32, threads))
    inclusive = np.maximum.accumulate(tops, axis=1)
    before = np.concatenate([np.full((tops.shape[0], 1), -1),
                             inclusive[:, :-1]], axis=1)
    totals = inclusive[:, -1]
    warps_before = np.concatenate([[-1], np.maximum.accumulate(totals)[:-1]])
    return np.maximum(before, warps_before[:, None]).reshape(-1)


def _map_chunk(src, lens, dst, mc, nxt, ws, we, slot, threads, tgt):
    """The kernel's ``map_chunk``: marks, the slots' carries, each mapped
    byte's target into ``tgt`` (window order)."""
    mark = np.full(threads * slot, -1, np.int64)
    # the kernel's threads mark in no set order: one mark per byte, so
    # any order gives the same marks (here, the last element first)
    for i in reversed(range(mc)):
        p = max(int(src[i]), ws)
        if p != max(int(src[i + 1]) if i + 1 < mc else nxt, ws):
            mark[p - ws] = i
    slots = mark.reshape(threads, slot)
    carry = _slot_carry(slots.max(axis=1), threads)
    b0, b1 = max(ws, int(src[0])), min(we, nxt)
    for t in range(threads):
        run = carry[t]
        for k in range(slot):
            run = max(run, slots[t, k])
            j = ws + t * slot + k
            if b0 <= j < b1:
                pos = j - int(src[run])
                tgt[t * slot + k] = dst[run] + pos if (
                    dst[run] >= 0 and pos < lens[run]) else -1


def _copy_run(outb, t0, win, s0, n):
    """The kernel's ``copy_run``: ``out[t0, t0 + n) = win[s0, s0 + n)``,
    bytes over the head and tail, 16-B pieces between."""
    A = min((t0 + 15) & ~15, t0 + n)
    B = max((t0 + n) & ~15, A)
    assert A - t0 < 16 and t0 + n - B < 16 and (B - A) % 16 == 0
    outb[t0:A] = win[s0:s0 + A - t0]
    outb[B:t0 + n] = win[s0 + B - t0:s0 + n]
    for g in range(A, B, 16):
        i = s0 + g - t0
        outb[g:g + 16] = win[i:i + 16]


def model_encode_strings(L, out, window=None, chunk=None, threads=None,
                         grid=3, few=None):
    """What one ``encode_strings`` launch writes, as the kernel walks it:
    ``grid`` blocks, each a contiguous run of the launch's windows in
    order. A window's set holds its bytes and up to ``chunk`` + 4
    elements from ``c0`` (rounded down to 4), where ``c0`` is the owner
    of the byte before the window (found by the search at a block's first
    window in a column, else counted by the window before); the elements
    that start before the window's end are mapped, and any past the set
    are loaded and mapped ``chunk`` at a time; then every mapped byte is
    copied. A window after another of its column stages a quarter more
    elements than that one held, and ``STRING_AHEAD``, unless that one
    held more than it staged; where the set before holds that many from
    the window's first element, the window keeps it. ``window``, ``chunk`` and ``threads``
    default to the kernel's;
    other values renumber the windows from the table's extents."""
    window = window or encode.STRING_WINDOW
    chunk = chunk or encode.STRING_CHUNK
    threads = threads or encode.STRING_THREADS
    few_max = encode.STRING_FEW if few is None else few
    slot = window // threads
    buf = L.buf.numpy()
    lanes = L.lanes_view().numpy().tolist()
    outb = out.numpy()
    cols, first = [], 0
    for src_l, len_l, bytes_l, dst_l, n_el, extent, first_w, _ in \
            L.cols_view().numpy().reshape(-1, encode._COL_WORDS).tolist():
        if window == encode.STRING_WINDOW:
            assert first_w == first
        cols.append((_typed(buf, lanes[src_l], np.int32)[:n_el],
                     _typed(buf, lanes[len_l], np.int32)[:n_el],
                     _typed(buf, lanes[bytes_l], np.uint8),
                     _typed(buf, lanes[dst_l], np.int32)[:n_el],
                     n_el, extent, first))
        first += -(-extent // window)
    n_windows = first
    if window == encode.STRING_WINDOW:
        assert n_windows == L.n_windows
    grid = max(1, min(grid, n_windows))
    starts = [col[6] for col in cols]

    def column_of(c, w):
        while c + 1 < len(cols) and starts[c + 1] <= w:
            c += 1
        return c

    def elements(src, n, lo, hi):
        e = np.arange(lo, hi)
        return np.where(e < n, src[np.minimum(e, n - 1)], INT_MAX)

    for blk in range(grid):
        w_lo, w_hi = blk * n_windows // grid, (blk + 1) * n_windows // grid
        c = column_of(0, w_lo)
        src, lens, data, dst, n, extent, first_w = cols[c]
        c0 = max(_count_le(src, n, (w_lo - first_w) * window - 1,
                           threads) - 1, 0)
        want, kept = chunk + 4, None
        for w in range(w_lo, w_hi):
            src, lens, data, dst, n, extent, first_w = cols[c]
            ws = (w - first_w) * window
            wl = min(window, extent - ws)
            we = ws + wl
            window_bytes = data[ws:we].copy()
            if kept is None:
                c0a = c0 & ~3
                cnt = min(want, ((n + 3) & ~3) - c0a)
            else:  # the window before's set still holds these elements
                c0a, cnt = kept
            kept = None
            avail = min(cnt - (c0 - c0a), n - c0)
            mc = int(np.count_nonzero(src[c0:c0 + avail] <= we - 1))
            nxt = int(elements(src, n, c0 + mc, c0 + mc + 1)[0])
            # the next window of the column stages by this one's count,
            # unless this one had more than it staged
            want = chunk + 4 if nxt <= we - 1 else min(
                chunk + 4, (mc + (mc >> 2) + encode.STRING_AHEAD + 3) & ~3)
            tgt = np.full(threads * slot, -1, np.int64)
            few = nxt > we - 1 and mc <= few_max
            runs = [(int(src[i]), int(lens[i]), int(dst[i]),
                     int(src[i + 1]) if i + 1 < c0 + mc else nxt)
                    for i in range(c0, c0 + mc)] if few else []
            if not few:
                _map_chunk(src[c0:c0 + mc], lens[c0:c0 + mc],
                           dst[c0:c0 + mc], mc, nxt, ws, we, slot, threads,
                           tgt)
            cursor = c0 + mc
            while nxt <= we - 1:
                sv = elements(src, n, cursor, cursor + chunk)
                mc = int(np.count_nonzero(sv <= we - 1))
                nxt = int(elements(src, n, cursor + mc, cursor + mc + 1)[0])
                _map_chunk(sv, lens[cursor:cursor + mc],
                           dst[cursor:cursor + mc], mc, nxt, ws, we, slot,
                           threads, tgt)
                cursor += mc
            if w + 1 < w_hi:
                c_next = column_of(c, w + 1)
                if c_next != c:
                    c, want = c_next, chunk + 4
                    src, lens, data, dst, n, extent, first_w = cols[c]
                    c0 = max(_count_le(src, n, (w + 1 - first_w) * window
                                       - 1, threads) - 1, 0)
                else:
                    c0 = max(cursor - 1, 0)
                    if nxt > we - 1 and c0 - c0a + want <= cnt:
                        kept = (c0a, cnt)
            for start, size, to, after in runs:
                lo, hi = max(start, ws), min(after, start + size, we)
                if to >= 0 and lo < hi:
                    _copy_run(outb, to + lo - start, window_bytes, lo - ws,
                              hi - lo)
            if not few:
                keep = tgt[:wl] >= 0
                outb[tgt[:wl][keep]] = window_bytes[keep]


class _ModelEncodeKernel(encode._EncodeKernel):
    """``_EncodeKernel`` with the models in place of the launches, at a
    span budget of ``budget`` (the kernel's floor by default)."""

    def __init__(self, budget: int = encode.SPAN_FLOOR):
        super().__init__()
        self.budget = budget
        self.blocks = (0, 0)

    def free_span_bytes(self, L):
        return self.budget

    def span_budget(self, L):
        return self.budget

    def launch_rows(self, L, write, row_sizes, cum=None, out=None,
                    budget=None):
        if write and budget is None:
            budget = L.span_budget = self.span_budget(L)
        got = model_encode_rows(L, write, row_sizes, cum, out,
                                budget=budget or 0)
        if write:
            self.blocks = got
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
    assert kernel.strings.launches == (1 if L.n_windows else 0)
    # one block of rows at this size, its span [0, total): staged when
    # it fits the budget (not the records of kilobytes)
    assert kernel.blocks == encode.span_plan(sizes, L.n, L.span_budget)
    assert kernel.blocks == ((1, 0) if total <= encode.SPAN_FLOOR
                             else (0, 1))
    # the tables the kernel reads: each #off the exclusive running sum of
    # its #count over every lane of the parent axis
    for rid in range(1, len(enc.prog.regions)):
        path = enc.prog.regions[rid]
        counts = L.view(path + "#count").to(torch.int64)
        assert L.view(path + "#off").tolist() == [0] + torch.cumsum(
            counts, 0).tolist()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rows_traffic_counts_what_the_kernel_reads(name):
    """``encode.rows_traffic``, the walk behind ``encode_rows``' byte
    bound (``chip_smoke.py`` and the launch telemetry read it), counts
    exactly the lane entries the kernel's model reads and the ``#dst``
    entries it writes, and the payloads placed and their bytes as the
    plain version's ``#dst`` lanes give them."""
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
    traffic = encode.rows_traffic(L)
    assert {k: traffic[k] for k in got} == got
    _out, _sizes, dst = encode.rows_plain(L.dv(), enc.prog, L.cap)
    placed = payload = 0
    for col in enc.prog.string_cols:
        keep = dst[col.path] >= 0
        placed += int(keep.sum())
        payload += int(L.view(col.path + "#len")[keep].to(torch.int64).sum())
    assert (traffic["placed"], traffic["payload"]) == (placed, payload)


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
    assert set(entries) == {"encode_rows", "encode_strings",
                            "encode_rows_smem_bytes",
                            "encode_rows_blocks_per_sm"}
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
    constants = {k: int(v) for k, v in
                 re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert constants["kMaxDepth"] == encode.MAX_DEPTH
    assert constants["kThreads"] == encode.ROW_BLOCK
    assert constants["kSpanFloor"] == encode.SPAN_FLOOR
    assert constants["kSpanMax"] == encode.SPAN_MAX
    assert constants["kColWords"] == encode._COL_WORDS
    assert constants["kWindow"] == encode.STRING_WINDOW
    assert constants["kStringThreads"] == encode.STRING_THREADS
    assert constants["kChunk"] == encode.STRING_CHUNK
    assert constants["kAhead"] == encode.STRING_AHEAD
    assert constants["kFew"] == encode.STRING_FEW


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_src_is_non_decreasing_per_column(name):
    """``encode_strings`` finds a window's elements by searching ``#src``
    and counting the staged ones that start before the window's end: it
    needs every payload column's ``#src`` non-decreasing, pads included
    (the reference assumes the same, ``encode.py:586``)."""
    schema, batch = FIXTURES[name]
    enc = _encoder(schema)
    if batch.num_rows == 0:
        return
    dv = enc.launch(batch).dv_np
    for col in enc.prog.string_cols:
        src = dv[col.path + "#src"].astype(np.int64)
        assert (np.diff(src) >= 0).all(), col.path
        real = src[src != encode_extract._BIG]
        assert real.size == 0 or real[-1] < encode_extract._BIG


def _payload_launch(columns, window):
    """A launch stand-in holding payload columns ``(src, lens, data,
    dst)`` as the launch buffer lays them out (16-byte aligned lanes, the
    column table with each column's extent and first window), and the
    plain version's inputs for the same columns."""
    pieces, lanes, rows, dv, dst, first = [], [], [], {}, {}, 0
    pos = 0

    def lane(arr):
        nonlocal pos
        raw = np.ascontiguousarray(arr).view(np.uint8)
        pieces.append((pos, raw))
        lanes.append(pos)
        pos += (raw.size + 15) // 16 * 16
        return len(lanes) - 1

    for k, (src, lens, data, dsts) in enumerate(columns):
        src = np.asarray(src, np.int32)
        lens = np.asarray(lens, np.int32)
        data = np.asarray(data, np.uint8)
        data = np.concatenate([data, np.zeros(-data.size % 4, np.uint8)])
        dsts = np.asarray(dsts, np.int32)
        extent = encode.payload_extent(src, lens, data.size)
        rows.append([lane(src), lane(lens), lane(data), lane(dsts),
                     src.size, extent, first, 0])
        first += -(-extent // window)
        path = f"c{k}"
        dv[path + "#src"] = torch.from_numpy(src)
        dv[path + "#len"] = torch.from_numpy(lens)
        dv[path + "#bytes"] = torch.from_numpy(data.view(np.int32))
        dst[path] = torch.from_numpy(dsts)
    buf = np.zeros(pos + 16, np.uint8)
    for at, raw in pieces:
        buf[at:at + raw.size] = raw
    cols = np.asarray(rows, np.int32).reshape(-1, encode._COL_WORDS)
    L = types.SimpleNamespace(
        buf=torch.from_numpy(buf),
        lanes_view=lambda: torch.tensor(lanes, dtype=torch.int64),
        cols_view=lambda: torch.from_numpy(cols.reshape(-1)),
        n_windows=first)
    prog = types.SimpleNamespace(string_cols=[
        types.SimpleNamespace(path=f"c{k}") for k in range(len(columns))])
    return L, prog, dv, dst


def _column(lens, placed=None, empty_at=(), seed=0):
    """``(src, lens, data, dst, size)``: one payload column of elements of
    ``lens`` bytes back to back, random bytes, each placed at its own
    output run unless ``placed`` says otherwise; ``empty_at`` puts empty
    elements before the element that starts at each of those offsets;
    ``size`` bounds the output."""
    rng = np.random.default_rng(seed)
    src, out_lens, pos = [], [], 0
    for n in lens:
        src.append(pos)
        out_lens.append(n)
        pos += n
    for at in empty_at:
        k = int(np.searchsorted(src, at, side="left"))
        src.insert(k, at)
        out_lens.insert(k, 0)
    data = rng.integers(0, 256, pos, dtype=np.uint8)
    dsts, at = [], 3
    for k, n in enumerate(out_lens):
        keep = placed is None or placed[k]
        dsts.append(at if keep else -1)
        at += n + 5
    return src, out_lens, data, dsts, at


STRING_CASES = {
    # a payload over a window bound
    "straddle": [_column([10] * 20, seed=1)],
    # a payload longer than two windows
    "over_two_windows": [_column([5, 200, 7], seed=2)],
    # a window that starts inside an unplaced element
    "unplaced_at_window_start": [_column(
        [30, 100, 9, 40], placed=[True, False, True, True], seed=3)],
    # empty payloads that start where a window starts
    "empties_at_window_start": [_column(
        [64, 3, 20, 11], empty_at=[64, 64, 64, 67], seed=4)],
    # more elements in a window than a chunk stages (the loaded chunks)
    # and than the run copy takes (the byte map)
    "many_in_a_window": [_column(
        [1, 0, 2] * 90, placed=[k % 7 != 3 for k in range(270)], seed=5)],
    # lengths shorter than the gap to the next start, and a length past
    # it (the next element owns those bytes)
    "gaps_and_overlaps": [(
        [0, 10, 10, 30, 31, 90], [4, 25, 8, 0, 70, 3],
        np.arange(120, dtype=np.uint8), [500, 300, 200, 100, -1, 0], 0)],
    # two columns, the first with no element inside its buffer
    "no_element_then_one": [
        ([1 << 30] * 4, [0] * 4, np.zeros(16, np.uint8), [-1] * 4, 0),
        _column([70], seed=6)],
}


@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("few", [0, encode.STRING_FEW])
@pytest.mark.parametrize("case", sorted(STRING_CASES))
def test_string_windows_match_plain_version(case, few, grid):
    """``model_encode_strings`` at 64-byte windows, 4 threads and chunks
    of 8 elements, with every window mapped byte by byte (``few`` 0) or
    the kernel's run copies, on one block or three, against
    ``strings_plain`` on columns built to put payloads, empties and
    unplaced elements at window bounds."""
    columns = [c[:4] for c in STRING_CASES[case]]
    L, prog, dv, dst = _payload_launch(columns, 64)
    size = max([c[4] for c in STRING_CASES[case]] + [
        int(max(d)) + 300 for *_, d in columns if len(d)]) + 64
    want = torch.zeros(size, dtype=torch.uint8)
    encode.strings_plain(want, dv, prog, dst)
    got = torch.zeros(size, dtype=torch.uint8)
    model_encode_strings(L, got, window=64, chunk=8, threads=4, grid=grid,
                         few=few)
    assert torch.equal(got, want)
    assert int(want.count_nonzero()) > 0 or case == "no_element_then_one"


@pytest.mark.parametrize("src, lens, nbytes, extent", [
    ([0, 5, 9], [5, 4, 2], 16, 11),        # the last element's end
    ([0, 5, 9], [5, 4, 30], 16, 16),       # clipped to the buffer
    ([0, 0, 1 << 30], [0, 0, 0], 16, 0),   # only empties, then a pad
    ([1 << 30] * 3, [0] * 3, 16, 0),       # no element in the buffer
])
def test_payload_extent(src, lens, nbytes, extent):
    assert encode.payload_extent(np.asarray(src, np.int32),
                                 np.asarray(lens, np.int32),
                                 nbytes) == extent


@pytest.mark.parametrize("fits", [True, False])
def test_block_span_just_under_and_just_over_the_budget(fits):
    """A 300-row Kafka batch (three write blocks) at the budget that
    just holds its first block's span, and one byte less: that block
    staged or direct, the rest alike, and the bytes the plain version's
    either way (the staged block's payload positions start as random
    bytes and the copy overwrites every one)."""
    schema = KAFKA_SCHEMA_JSON
    batch = _batch("kafka", 300, seed=29)
    enc = _encoder(schema)
    L = enc.launch(batch)
    plain_out, plain_sizes, plain_dst = encode.rows_plain(L.dv(), enc.prog,
                                                          L.cap)
    encode.strings_plain(plain_out, L.dv(), enc.prog, plain_dst)
    first = int(plain_sizes[:encode.ROW_BLOCK].to(torch.int64).sum())
    kernel = _ModelEncodeKernel(budget=first if fits else first - 1)
    out, sizes = kernel.run(L)
    total = int(sizes.to(torch.int64).sum())
    assert torch.equal(out[:total], plain_out[:total])
    staged, direct = kernel.blocks
    assert (staged, direct) == encode.span_plan(sizes, L.n, kernel.budget)
    assert staged + direct == 3
    widened = [int(s) for s in _block_spans(sizes, L.n)]
    assert widened[0] == first
    assert staged == sum(w <= kernel.budget for w in widened)
    assert (widened[0] <= kernel.budget) is fits


def _block_spans(sizes, n):
    """Each write block's span widened down to a 16-B bound."""
    end = np.cumsum(sizes[:n].numpy().astype(np.int64))
    spans = []
    for r0 in range(0, n, encode.ROW_BLOCK):
        r1 = min(r0 + encode.ROW_BLOCK, n) - 1
        start = end[r0] - int(sizes[r0])
        spans.append(end[r1] - (start & ~15))
    return spans


OCCUPANCY = {
    # blocks an SM holds at s bytes of shared memory: 16 while a block
    # takes at most 14 KiB, so what costs no block is under the floor
    "floor": lambda s: min(16, 233472 // (s + 1024)),
    # registers allow 4 blocks: staging up to about 56 KiB costs none
    "free": lambda s: min(4, 233472 // (s + 1024)),
    "fails": lambda s: -1,
}


@pytest.mark.parametrize("case", sorted(OCCUPANCY))
def test_span_budget_follows_the_occupancy_query(monkeypatch, case):
    """The write launch's budget: the largest staging (16-B steps, at most
    ``SPAN_MAX``) at which the query holds as many blocks an SM as with
    none, at least ``SPAN_FLOOR``, kept per table size; a failed query
    raises."""
    from pyruhvro_tpu_torch.ops import _build

    schema, batch = FIXTURES["kafka"]
    L = _encoder(schema).launch(batch)
    tables = (8 * len(L.prog.lanes) + 4 * len(L.prog.code) + 15) // 16 * 16
    asked = []

    def occupancy(s):
        asked.append(s)
        return per_sm(s)

    per_sm = OCCUPANCY[case]
    lib = types.SimpleNamespace(cdll=types.SimpleNamespace(
        encode_rows=types.SimpleNamespace(argtypes=[]),
        encode_rows_smem_bytes=lambda n_lanes, code_len, b: tables + b,
        encode_rows_blocks_per_sm=occupancy))
    monkeypatch.setattr(_build, "load_kernel_library", lambda s: lib)
    kernel = encode._EncodeKernel()
    if case == "fails":
        with pytest.raises(RuntimeError, match="occupancy"):
            kernel.span_budget(L)
        return
    got = kernel.span_budget(L)
    free = max(b for b in range(0, encode.SPAN_MAX + 1, 16)
               if per_sm(tables + b) >= per_sm(tables))
    assert got == max(free, encode.SPAN_FLOOR)
    assert (got == encode.SPAN_FLOOR) is (case == "floor")
    assert got % 16 == 0 and asked[0] == tables
    n = len(asked)
    assert kernel.span_budget(L) == got and len(asked) == n  # kept


def test_kernel_wrappers_refuse_cpu_tensors():
    schema, batch = FIXTURES["kafka"]
    L = _encoder(schema).launch(batch)
    sizes = torch.empty(L.R, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode.encode_kernel.launch_rows(L, False, sizes)
    with pytest.raises(RuntimeError, match="CUDA"):
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

