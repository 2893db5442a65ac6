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
    walk_plain,
)
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


def _assert_same_columns(p: _Pair, datums):
    """decode_to_columns on both sides: row buffers on [:n], dense item
    buffers whole, #offsets, item_totals and the padded bytes."""
    h_ref, n_ref, m_ref = p.ref.decode_to_columns(datums)
    h_port, n_port, m_port = p.port.decode_to_columns(datums)
    assert n_port == n_ref == len(datums)
    assert set(h_port) == set(h_ref)
    for key, want in h_ref.items():
        got = h_port[key]
        assert got.dtype == want.dtype, key
        spec = p.ref.prog.buffers.get(key)
        if spec is not None and spec.region == 0:
            want, got = want[:n_ref], got[:n_ref]
        assert _same_bits(got, want), key
    assert m_port["item_totals"] == m_ref["item_totals"]
    assert np.array_equal(m_port["flat"], m_ref["flat"])
    assert p.port._caps == p.ref._caps


def _raw_both(p: _Pair, datums, caps):
    """Both walks' raw outputs at one cap rung, before any error raise."""
    import jax

    n = len(datums)
    lens_np = np.array([len(d) for d in datums], np.int32)
    BW = 4
    while BW * 4 < int(lens_np.max(initial=1)):
        BW *= 2
    tile_r = p.ref._tile_rows(BW, caps)
    assert tile_rows(p.port.prog, BW, caps) == tile_r
    R = max(1, -(-n // tile_r)) * tile_r
    padded = np.zeros((R, BW * 4), np.uint8)
    for i, d in enumerate(datums):
        padded[i, : len(d)] = np.frombuffer(d, np.uint8)
    lens = np.zeros(R, np.int32)
    lens[:n] = lens_np
    act = np.zeros(R, np.int32)
    act[:n] = 1
    outs = p.ref._fn(R // tile_r, tile_r, BW, caps)(
        jax.device_put(padded.view(np.uint32)), jax.device_put(lens),
        jax.device_put(act),
    )
    ref = {k: np.asarray(v) for k, v in zip(p.ref.out_keys, outs)}
    bufs, err = walk_plain(torch.from_numpy(padded), torch.from_numpy(lens),
                           torch.from_numpy(act), p.port.prog, caps, tile_r)
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
    rows = torch.zeros((128, 16), dtype=torch.uint8)
    rows[0, 0] = 2  # one block of one item
    rows[0, 1] = 6
    lens = torch.zeros(128, dtype=torch.int32)
    lens[0] = 3
    act = (lens > 0).to(torch.int32)
    bufs, err = walk(rows, lens, act, dec.prog, (0, 8), 128)
    assert int(err[0]) == 0
    assert [int(b[0]) for b in bufs] == [1, 0, 3]  # count, hi, lo


def test_kernel_wrapper_refuses_cpu_tensors():
    from pyruhvro_tpu_torch.ops.walk_decode import walk_kernel

    dec = WalkDecoder(parse_schema(LADDER_SCHEMA), device="cpu")
    rows = torch.zeros((128, 16), dtype=torch.uint8)
    lens = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        walk_kernel(rows, lens, lens, dec.prog, (0, 8), 128)


def test_kernel_library_declares_every_argument(monkeypatch):
    """ctypes must pass every pointer (and the stream) as c_void_p, in the
    order of the C entry point; an undeclared pointer is cut to 32 bits."""
    import ctypes
    import re
    import types
    from pathlib import Path

    from pyruhvro_tpu_torch.ops import _build
    from pyruhvro_tpu_torch.ops.walk_decode import walk_kernel

    fn = ctypes.CDLL(None).strlen  # any foreign function object will do
    lib = types.SimpleNamespace(cdll=types.SimpleNamespace(walk_decode=fn))
    monkeypatch.setattr(_build, "load_kernel_library", lambda source: lib)
    walk_kernel.library()
    src = (Path(_build.CSRC) / "walk_decode.cu").read_text()
    params = re.search(r'extern "C" int walk_decode\(([^)]*)\)', src).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in params.split(",")]
    assert fn.argtypes == kinds
    assert fn.restype is ctypes.c_int
