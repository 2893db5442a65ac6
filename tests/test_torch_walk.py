"""The port's walk held against the reference's Pallas walk, on the CPU.

Same inputs, made from a seed, go through ``pyruhvro_tpu``'s
``PallasKernelDecoder`` in interpret mode and through
``pyruhvro_tpu_torch``'s ``WalkDecoder`` on ``device="cpu"`` (the plain
PyTorch walk of the same field-program code the CUDA kernel runs). The
decode is bit-exact, so the tolerance is 0: integers compare exactly,
floats as bit patterns. Malformed batches must raise the same
``MalformedAvro`` message, and their raw ``#err`` words (and every other
buffer) must agree at the same cap rung.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyruhvro_tpu.fallback.io import MalformedAvro as RefMalformed  # noqa: E402
from pyruhvro_tpu.ops.pallas_decode import PallasKernelDecoder  # noqa: E402
from pyruhvro_tpu.schema.parser import parse_schema as ref_parse  # noqa: E402
from pyruhvro_tpu.utils.datagen import (  # noqa: E402
    CRITERION_SHAPES,
    KAFKA_SCHEMA_JSON,
    random_datums,
)

from pyruhvro_tpu_torch.errors import MalformedAvro  # noqa: E402
from pyruhvro_tpu_torch.ops import UnsupportedOnDevice  # noqa: E402
from pyruhvro_tpu_torch.ops.walk_decode import (  # noqa: E402
    WalkDecoder,
    tile_rows,
    walk,
    walk_padded,
    walk_plain,
)
from pyruhvro_tpu_torch.runtime.pack import concat_records  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils.datagen import kafka_style_datums  # noqa: E402

LADDER_SCHEMA = """{"type":"record","name":"Big","fields":[
  {"name":"xs","type":{"type":"array","items":"long"}}]}"""

# zero-byte items: the block loop is bounded only by the tile's loop bound
NULLS_SCHEMA = """{"type":"record","name":"Nulls","fields":[
  {"name":"xs","type":{"type":"array","items":"null"}},
  {"name":"s","type":"string"}]}"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain walk runs at test sizes; one intra-op thread keeps it from
    oversubscribing the CPU that parallel test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Pair:
    """The reference decoder and the port's, built once per schema."""

    def __init__(self, schema: str):
        self.ref = PallasKernelDecoder(ref_parse(schema), interpret=True)
        self.port = WalkDecoder(parse_schema(schema), device="cpu")


_pairs = {}


def _pair(schema: str) -> _Pair:
    if schema not in _pairs:
        _pairs[schema] = _Pair(schema)
    return _pairs[schema]


def _zz(v: int) -> bytes:
    """Avro long wire bytes of ``v``."""
    z = ((v << 1) ^ (v >> 63)) & ((1 << 64) - 1)
    out = bytearray()
    while z >= 0x80:
        out.append((z & 0x7F) | 0x80)
        z >>= 7
    out.append(z)
    return bytes(out)


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8),
        np.ascontiguousarray(b).view(np.uint8),
    )


def _gathered(flat, starts, lens) -> np.ndarray:
    """The bytes that (start, len) descriptors name in ``flat``."""
    starts = starts.astype(np.int64)
    lens = lens.astype(np.int64)
    idx = np.repeat(starts - np.cumsum(lens) + lens, lens) \
        + np.arange(int(lens.sum()))
    return flat[idx]


def _assert_same_columns(p: _Pair, datums):
    """decode_to_columns on both sides: row buffers on [:n], dense item
    buffers whole, #offsets, item_totals. ``#start`` descriptors index
    different byte buffers (the port's concatenated records, the
    reference's padded rows), so they compare after each side's row base
    is taken off (``offs[row]`` in the port, ``row*BW*4`` in the
    reference), and the bytes they name compare as gathered values."""
    h_ref, n_ref, m_ref = p.ref.decode_to_columns(datums)
    h_port, n_port, m_port = p.port.decode_to_columns(datums)
    n = len(datums)
    assert n_port == n_ref == n
    assert set(h_port) == set(h_ref)
    lens = np.array([len(d) for d in datums], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    row_bytes = WalkDecoder.row_words(lens) * 4
    rows_of = {0: np.arange(n)}
    for rid in range(1, len(p.port.prog.regions)):
        path = p.port.prog.regions[rid]
        rows_of[rid] = np.repeat(np.arange(n),
                                 np.diff(h_ref[path + "#offsets"]))
    for key, want in h_ref.items():
        got = h_port[key]
        assert got.dtype == want.dtype, key
        spec = p.ref.prog.buffers.get(key)
        if spec is not None and spec.region == 0:
            want, got = want[:n_ref], got[:n_ref]
        if key.endswith("#start"):
            rows = rows_of[spec.region]
            got = got.view(np.uint32) - offs[rows].astype(np.uint32)
            want = want.view(np.uint32) - (rows * row_bytes).astype(np.uint32)
        assert _same_bits(got, want), key
    assert m_port["item_totals"] == m_ref["item_totals"]
    assert m_port["flat"].tobytes() == b"".join(datums)
    for col in p.port.prog.string_cols:
        count = n if col.region == 0 else m_ref["item_totals"][
            p.port.prog.regions[col.region]]
        got, want = (_gathered(m["flat"], h[col.path + "#start"][:count],
                               h[col.path + "#len"][:count])
                     for h, m in ((h_port, m_port), (h_ref, m_ref)))
        assert np.array_equal(got, want), col.path
    assert p.port._caps == p.ref._caps


def _padded_layout(datums, R: int, BW: int):
    """The reference's launch arrays: row-padded ``[R, BW*4]`` bytes, lens,
    act."""
    padded = np.zeros((R, BW * 4), np.uint8)
    for i, d in enumerate(datums):
        padded[i, : len(d)] = np.frombuffer(d, np.uint8)
    lens = np.zeros(R, np.int32)
    lens[: len(datums)] = [len(d) for d in datums]
    act = (np.arange(R) < len(datums)).astype(np.int32)
    return padded, lens, act


def _flat_layout(datums, R: int):
    """The kernel's launch arrays: concatenated bytes, ``offs``, ``act``."""
    flat, offsets = concat_records(datums, tail=16)
    offs, act = WalkDecoder.row_arrays(offsets, R)
    return torch.from_numpy(flat), torch.from_numpy(offs), \
        torch.from_numpy(act)


def _raw_both(p: _Pair, datums, caps):
    """Both walks' raw outputs at one cap rung, before any error raise. The
    port's walk takes the flat input with ``base = row*BW*4``, so its
    row-region ``#start`` matches the reference's bit for bit."""
    import jax

    n = len(datums)
    lens_np = np.array([len(d) for d in datums], np.int32)
    BW = 4
    while BW * 4 < int(lens_np.max(initial=1)):
        BW *= 2
    tile_r = p.ref._tile_rows(BW, caps)
    assert tile_rows(p.port.prog, BW, caps) == tile_r
    R = max(1, -(-n // tile_r)) * tile_r
    padded, lens, act = _padded_layout(datums, R, BW)
    outs = p.ref._fn(R // tile_r, tile_r, BW, caps)(
        jax.device_put(padded.view(np.uint32)), jax.device_put(lens),
        jax.device_put(act),
    )
    ref = {k: np.asarray(v) for k, v in zip(p.ref.out_keys, outs)}
    flat, offs, act_t = _flat_layout(datums, R)
    base = torch.arange(R, dtype=torch.int32) * (BW * 4)
    bufs, err = walk_plain(flat, offs, act_t, BW, base, p.port.prog, caps,
                           tile_r)
    port = {k: b.numpy() for k, b in zip(p.port.prog.out_keys, bufs)}
    port["#err"] = err.numpy()
    return ref, port


def _assert_same_raw(p: _Pair, datums, caps):
    ref, port = _raw_both(p, datums, caps)
    assert set(ref) == set(port)
    for key in ref:
        assert _same_bits(port[key], ref[key]), key
    return port["#err"][: len(datums)].view(np.uint32)


def _same_error(p: _Pair, datums) -> str:
    with pytest.raises(RefMalformed) as want:
        p.ref.decode_to_columns(datums)
    with pytest.raises(MalformedAvro) as got:
        p.port.decode_to_columns(datums)
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_kafka_columns_match_reference():
    _assert_same_columns(_pair(KAFKA_SCHEMA_JSON),
                         kafka_style_datums(300, seed=1))


@pytest.mark.parametrize("shape", sorted(CRITERION_SHAPES))
def test_criterion_shape_columns_match_reference(shape):
    schema = CRITERION_SHAPES[shape]
    _assert_same_columns(_pair(schema),
                         random_datums(ref_parse(schema), 200, seed=11))


def test_nan_payloads_survive():
    """Floats and doubles travel as bit patterns: NaN payloads, signed
    zeros and infinities come out bit-equal to the reference."""
    import struct

    schema = CRITERION_SHAPES["flat_primitives"]
    datums = random_datums(ref_parse(schema), 200, seed=11)
    for f32, f64 in [(0x7FC00001, 0x7FF8000000000001), (0xFF800000, 1 << 63),
                     (0x80000000, 0x7FF0000000000000)]:
        datums.append(_zz(7) + _zz(-5) + struct.pack("<Q", f64)
                      + struct.pack("<I", f32) + b"\x01" + _zz(2) + b"ab")
    _assert_same_columns(_pair(schema), datums)
    h, n, _meta = _pair(schema).port.decode_to_columns(datums)
    assert h["weight#v"][200:n].view(np.uint32).tolist() == [
        0x7FC00001, 0xFF800000, 0x80000000]


def test_cap_ladder_matches_reference():
    """Arrays of 0-40 longs blow the first cap (8): both ladders climb to
    the same rung, and starting both at that rung gives the same columns."""
    rng = random.Random(6)
    datums = []
    for _ in range(200):
        xs = [rng.randrange(-1000, 1000) for _ in range(rng.randrange(0, 40))]
        datums.append((_zz(len(xs)) + b"".join(map(_zz, xs)) if xs else b"")
                      + _zz(0))
    p = _pair(LADDER_SCHEMA)
    p.ref._caps = p.port._caps = None
    _assert_same_columns(p, datums)
    assert p.port._caps == (0, 64)
    _assert_same_columns(p, datums)  # both start at the learned rung


def test_truncated_varint_raises_same_message():
    schema = CRITERION_SHAPES["flat_primitives"]
    datums = random_datums(ref_parse(schema), 64, seed=3)
    datums[17] = b"\x82"
    msg = _same_error(_pair(schema), datums)
    assert msg.startswith("record 17: ")
    _assert_same_raw(_pair(schema), datums, (0,))


def test_trailing_bytes_raise_same_message():
    schema = CRITERION_SHAPES["flat_primitives"]
    datums = random_datums(ref_parse(schema), 16, seed=9)
    datums[4] = datums[4] + b"\x00"
    assert _same_error(_pair(schema), datums) == \
        "record 4: trailing bytes after datum"


@pytest.mark.parametrize("seed", range(4))
def test_bit_flipped_kafka_matches_reference(seed):
    """Random bit flips in Kafka datums: the same #err word on every row
    (and the same buffers) at the first rung, the same message."""
    rng = random.Random(seed)
    datums = kafka_style_datums(300, seed=100 + seed)
    for i in rng.sample(range(300), 40):
        d = bytearray(datums[i])
        for _ in range(rng.randrange(1, 4)):
            d[rng.randrange(len(d))] ^= 1 << rng.randrange(8)
        datums[i] = bytes(d)
    p = _pair(KAFKA_SCHEMA_JSON)
    err = _assert_same_raw(p, datums, (0, 8, 8))
    assert err.any()
    p.ref._caps = p.port._caps = None
    _same_error(p, datums)


def test_string_length_past_int32_matches_reference():
    """Lengths >= 2^31 read as negative (ERR_NEG_LEN); a length of
    2^31-1 wraps the int32 cursor without ERR_OVERRUN, exactly as the
    reference adds cursors."""
    datums = kafka_style_datums(64, seed=5)
    name = b"\x02"  # nullable name: present
    datums[3] = name + _zz(1 << 31) + datums[3][1:]
    datums[9] = name + _zz((1 << 31) - 1) + b"abc"
    datums[20] = name + _zz(1 << 40)
    p = _pair(KAFKA_SCHEMA_JSON)
    err = _assert_same_raw(p, datums, (0, 8, 8))
    assert err[3] & 2 and err[20] & 2  # ERR_NEG_LEN
    assert not err[9] & 2
    p.ref._caps = p.port._caps = None
    assert _same_error(p, datums).startswith("record 3: ")


def test_zero_byte_items_follow_the_tile_loop_bound():
    """Array-of-null items consume no bytes, so only the loop bound ends
    them. The bound is the tile's max span (+ icap + 2): a row beside a
    long row finishes its 50 items, one with 5000 is cut (ERR_OVERRUN)."""
    long_s = _zz(200) + b"x" * 200
    datums = [
        _zz(50) + _zz(0) + _zz(0),         # 50 nulls: fits the tile bound
        _zz(0) + long_s,                   # the long row sets the bound
        _zz(5000) + _zz(0) + _zz(0),       # past any bound: cut
        _zz(-3) + _zz(0) + _zz(0) + _zz(0),  # negative count + byte size
    ]
    p = _pair(NULLS_SCHEMA)
    err = _assert_same_raw(p, datums, (0, 8))
    assert err[0] == 1 << 7           # ERR_ITEM_OVERFLOW only
    assert err[2] & 4                  # cut by the bound: ERR_OVERRUN
    assert err[1] == 0 and err[3] == 0
    _assert_same_raw(p, datums[:1] + datums[3:], (0, 64))


def test_empty_and_inactive_rows():
    p = _pair(KAFKA_SCHEMA_JSON)
    h, n, meta = p.port.decode_to_columns([])
    assert n == 0 and meta["item_totals"] == {"emails": 0,
                                              "phone_numbers": 0}


def test_nested_repetition_is_unsupported():
    nested = """{"type":"record","name":"NN","fields":[
      {"name":"m","type":{"type":"array","items":
          {"type":"array","items":"long"}}}]}"""
    with pytest.raises(UnsupportedOnDevice, match="nested repetition"):
        WalkDecoder(parse_schema(nested), device="cpu")


def test_wide_record_is_unsupported():
    schema = CRITERION_SHAPES["flat_primitives"]
    ir = parse_schema(schema)
    datums = [_zz(1) + _zz(2) + bytes(8) + bytes(4) + b"\x01"
              + _zz(3000) + b"y" * 3000]
    with pytest.raises(UnsupportedOnDevice, match="exceeds the pallas tile"):
        WalkDecoder(ir, device="cpu").decode_to_columns(datums)


def test_walk_dispatches_cpu_tensors_to_the_plain_walk(monkeypatch):
    """A CPU tensor takes the plain walk and never the kernel."""
    from pyruhvro_tpu_torch.ops import walk_decode

    def refuse(*a, **k):
        raise AssertionError("kernel launched for a CPU tensor")

    monkeypatch.setattr(walk_decode, "walk_kernel", refuse)
    dec = WalkDecoder(parse_schema(LADDER_SCHEMA), device="cpu")
    # one block of one item, then the end block
    flat, offs, act = _flat_layout([bytes([2, 6, 0])], 128)
    base = torch.zeros(128, dtype=torch.int32)
    bufs, err = walk(flat, offs, act, 4, base, dec.prog, (0, 8), 128)
    assert int(err[0]) == 0
    assert [int(b[0]) for b in bufs] == [1, 0, 3]  # count, hi, lo


def test_kernel_wrapper_refuses_cpu_tensors():
    from pyruhvro_tpu_torch.ops.walk_decode import walk_kernel

    dec = WalkDecoder(parse_schema(LADDER_SCHEMA), device="cpu")
    flat, offs, act = _flat_layout([bytes([2, 6, 0])], 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        walk_kernel(flat, offs, act, 4, act, dec.prog, (0, 8), 128)


def test_kernel_library_declares_every_argument(monkeypatch):
    """ctypes must pass every pointer (and the stream) as c_void_p, in the
    order of each C entry point; an undeclared pointer is cut to 32 bits."""
    import ctypes
    import re
    import types
    from pathlib import Path

    from pyruhvro_tpu_torch.ops import _build
    from pyruhvro_tpu_torch.ops.walk_decode import walk_kernel

    src = (Path(_build.CSRC) / "walk_decode.cu").read_text()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(entries) == {"walk_decode", "walk_decode_smem_bytes",
                            "walk_decode_blocks_per_sm"}
    # any foreign function objects will do; each CDLL makes its own
    fns = {name: ctypes.CDLL(None).strlen for name in entries}
    lib = types.SimpleNamespace(cdll=types.SimpleNamespace(**fns))
    monkeypatch.setattr(_build, "load_kernel_library", lambda source: lib)
    walk_kernel.library()
    for name, params in entries.items():
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params.split(",")]
        assert fns[name].argtypes == kinds, name
        assert fns[name].restype is ctypes.c_int, name


# -- the flat input against the row-padded input -----------------------------

CLIP_SCHEMA = """{"type":"record","name":"Clip","fields":[
  {"name":"s","type":"string"},{"name":"x","type":"long"}]}"""


def _layout_fixtures():
    """name → (schema, datums): every shape the kernel's fixtures cover, at
    CPU test sizes, and the reads that the padded rows clip."""
    flat = CRITERION_SHAPES["flat_primitives"]
    cases = {"kafka": (KAFKA_SCHEMA_JSON, kafka_style_datums(300, seed=1))}
    for name in sorted(CRITERION_SHAPES):
        schema = CRITERION_SHAPES[name]
        cases[name] = (schema, random_datums(ref_parse(schema), 150, seed=11))
    rng = random.Random(6)
    ladder = []
    for _ in range(150):
        xs = [rng.randrange(-1000, 1000) for _ in range(rng.randrange(0, 20))]
        ladder.append((_zz(len(xs)) + b"".join(map(_zz, xs)) if xs else b"")
                      + _zz(0))
    cases["cap_ladder"] = (LADDER_SCHEMA, ladder)
    trunc = random_datums(ref_parse(flat), 64, seed=3)
    trunc[17] = b"\x82"
    cases["truncated_varint"] = (flat, trunc)
    trailing = random_datums(ref_parse(flat), 16, seed=9)
    trailing[4] = trailing[4] + b"\x00"
    cases["trailing_bytes"] = (flat, trailing)
    huge = kafka_style_datums(64, seed=5)
    huge[3] = b"\x02" + _zz(1 << 31) + huge[3][1:]
    huge[9] = b"\x02" + _zz((1 << 31) - 1) + b"abc"
    cases["string_len_2^31"] = (KAFKA_SCHEMA_JSON, huge)
    # BW = 16 words: a record of exactly 64 bytes, one whose last varint
    # runs past word 15 (the clipped reads repeat its last word) right
    # before a record of 0xFF bytes, and short records whose varints run
    # past their length into the next record's bytes (read as 0)
    clip = [_zz(62) + b"y" * 62 + _zz(7),
            _zz(59) + b"z" * 59 + b"\x80\x80\x80\x80",
            b"\xff" * 40,
            _zz(3) + b"ab",
            b"\x02a\x80",
            _zz(0) + _zz(-1)]
    cases["row_clip"] = (CLIP_SCHEMA, clip * 30)
    nulls = [_zz(50) + _zz(0) + _zz(0), _zz(0) + _zz(200) + b"x" * 200,
             _zz(5000) + _zz(0) + _zz(0), _zz(-3) + _zz(0) + _zz(0) + _zz(0)]
    cases["zero_byte_items"] = (NULLS_SCHEMA, nulls * 3)
    return cases


_LAYOUTS = _layout_fixtures()


@pytest.mark.parametrize("name", sorted(_LAYOUTS))
def test_flat_walk_equals_padded_walk(name):
    """The plain walk over the concatenated records (the kernel's input)
    against the plain walk over the reference's row-padded rows, at the
    first rung and the next: every buffer and ``#err`` bit-equal,
    row-region ``#start`` once each side's base (``offs[row]``,
    ``row*BW*4``) is taken off."""
    schema, datums = _LAYOUTS[name]
    dec = WalkDecoder(parse_schema(schema), device="cpu")
    prog, n = dec.prog, len(datums)
    lens = np.array([len(d) for d in datums], np.int64)
    BW = dec.row_words(lens)
    caps = dec.first_caps()
    for _rung in range(2):
        tile_r, R = dec.launch_rows(n, BW, caps)
        flat, offs, act = _flat_layout(datums, R)
        base = offs[:-1].to(torch.int32)
        got, got_err = walk_plain(flat, offs, act, BW, base, prog, caps,
                                  tile_r)
        padded, plens, pact = _padded_layout(datums, R, BW)
        row_base = torch.arange(R, dtype=torch.int32) * (BW * 4)
        want, want_err = walk_padded(
            torch.from_numpy(padded), torch.from_numpy(plens),
            torch.from_numpy(pact), row_base, prog, caps, tile_r)
        assert _same_bits(got_err.numpy(), want_err.numpy())
        for key, g, w in zip(prog.out_keys, got, want):
            g, w = g.numpy(), w.numpy()
            if prog.buffers[key].region == 0 and key.endswith("#start"):
                # inactive rows are not rebased: 0 on both sides
                live = act.numpy().astype(np.uint32)
                g = g.view(np.uint32) - base.numpy().view(np.uint32) * live
                w = w.view(np.uint32) - row_base.numpy().view(np.uint32) * live
            assert _same_bits(g, w), (name, key, caps)
        err = got_err[:n].numpy().view(np.uint32)
        if not (err & (1 << 7)).any():
            break
        caps = tuple(0 if c == 0 else 2 * c for c in caps)
    if name == "row_clip":
        assert BW == 16 and lens.max() == 64
        assert err[1] & 1 and err[2] and err[4]  # varint, junk, overrun


def test_row_clip_matches_reference():
    """The clip fixture at the reference's own walk, bit for bit."""
    schema, datums = _LAYOUTS["row_clip"]
    _assert_same_raw(_pair(schema), datums, (0,))


def test_pack_is_a_concatenation():
    """The decoder's pack: the records' bytes in one run with 16 zero bytes
    after it, offsets over R rows (rows past n empty), act on n rows."""
    dec = WalkDecoder(parse_schema(KAFKA_SCHEMA_JSON), device="cpu")
    datums = kafka_style_datums(50, seed=3)
    lens = np.array([len(d) for d in datums], np.int64)
    flat, offs, act = dec.pack(datums, lens, 128)
    assert flat.tobytes() == b"".join(datums) + bytes(16)
    assert offs.shape == (129,) and offs.dtype == np.int64
    assert np.array_equal(np.diff(offs)[:50], lens)
    assert (offs[50:] == lens.sum()).all()
    assert act.tolist() == [1] * 50 + [0] * 78


def test_block_spans_cover_each_block_in_16_byte_units():
    from pyruhvro_tpu_torch.ops.walk_decode import block_spans

    datums = kafka_style_datums(300, seed=4)
    _flat, offs, _act = _flat_layout(datums, 512)
    span, nonempty = block_spans(offs)
    o = offs.numpy()
    for blk in range(4):
        lo, hi = o[128 * blk], o[128 * blk + 128]
        assert span[blk] == -(-hi // 16) * 16 - lo // 16 * 16
        assert span[blk] % 16 == 0 and span[blk] >= hi - lo
        assert bool(nonempty[blk]) == (hi > lo)
    assert nonempty.tolist() == [True, True, True, False]


def test_stage_plan_stages_rows_first_within_the_budget():
    from pyruhvro_tpu_torch.ops.walk_decode import stage_plan

    prog = WalkDecoder(parse_schema(KAFKA_SCHEMA_JSON), device="cpu").prog
    caps = (0, 8, 8)
    sizes = [128 * (1 if prog.buffers[k].region == 0 else 8)
             * prog.buffers[k].dtype.itemsize for k in prog.out_keys]
    rows = [b for b, k in enumerate(prog.out_keys)
            if prog.buffers[k].region == 0]
    stage, used = stage_plan(prog, caps, 48 << 10)
    assert used == sum(sizes) == 128 * (87 + 8 * 24)
    assert sorted(stage) == sorted(set(stage)) and min(stage) == 0
    assert all(s % 16 == 0 for s in stage)
    assert max(stage[b] for b in rows) < min(
        s for b, s in enumerate(stage) if b not in rows)
    row_bytes = sum(sizes[b] for b in rows)
    stage, used = stage_plan(prog, caps, row_bytes)
    assert used == row_bytes
    assert [s >= 0 for s in stage] == [b in rows for b in range(len(stage))]
    assert stage_plan(prog, caps, 0) == ([-1] * len(stage), 0)


def test_input_staging_keeps_oversized_blocks_in_device_memory():
    """Blocks whose records span more than the input budget read flat in
    device memory; the budget is the largest span that fits."""
    from pyruhvro_tpu_torch.ops.walk_decode import block_spans, input_staging

    big = [bytes(1900 + i % 100) for i in range(200)]
    small = kafka_style_datums(300, seed=6)
    _flat, offs, _act = _flat_layout(big + small, 640)
    span, nonempty = block_spans(offs)
    budget, staged, unstaged = input_staging(offs, 32 << 10)
    fits = [int(s) for s, e in zip(span, nonempty) if e and s <= 32 << 10]
    assert (staged, unstaged) == (len(fits), 2) and staged == 2
    assert budget == max(fits) and budget % 16 == 0
    assert input_staging(offs, 0) == (0, 0, 4)


def test_default_output_budget_costs_no_resident_block(monkeypatch):
    """The default output staging is the largest (16-B steps) at which the
    occupancy query still gives the blocks per SM of no staging."""
    import types

    from pyruhvro_tpu_torch.ops import walk_decode as wd

    cap = {"by_registers": 12}

    def blocks_per_sm(smem):  # a card with 228 KiB, 1 KiB per block kept
        return min(cap["by_registers"], (228 << 10) // (smem + 1024))

    lib = types.SimpleNamespace(cdll=types.SimpleNamespace(
        walk_decode_blocks_per_sm=blocks_per_sm))
    monkeypatch.setattr(wd.walk_kernel, "library", lambda: lib)
    fake = types.SimpleNamespace(smem_bytes=lambda out: 15072 + out)
    out = wd.KernelLaunch._free_out_bytes(fake)
    assert out % 16 == 0 and blocks_per_sm(15072 + out) == 12
    assert blocks_per_sm(15072 + out + 16) == 11
    cap["by_registers"] = 4  # then the whole budget is free
    fake = types.SimpleNamespace(smem_bytes=lambda out: 2048 + out)
    assert wd.KernelLaunch._free_out_bytes(fake) == wd._OUT_STAGE_MAX
