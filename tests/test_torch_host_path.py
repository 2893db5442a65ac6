"""The port's decode host path held against the reference's, on the CPU.

The native record pack (``csrc/packer.cpp`` built by
``runtime/native.py``) against the reference's ``runtime/pack.py``
``concat_records``; ``overlap_chunks`` against the reference's under the
same environment; the persistent arenas' identity; the capacity planner's
learned rung against the reference's ``capacity.lookup`` for the same
schema and ``R``, and a fresh decoder that starts from it. Decode is
integer work: the tolerance is 0.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from pyruhvro_tpu.ops.decode import DeviceDecoder as RefDecoder  # noqa: E402
from pyruhvro_tpu.ops.decode import overlap_chunks as ref_overlap_chunks  # noqa: E402
from pyruhvro_tpu.ops.decode import pack_launch_into as ref_pack  # noqa: E402
from pyruhvro_tpu.runtime import capacity as ref_capacity  # noqa: E402
from pyruhvro_tpu.runtime.pack import concat_records as ref_concat  # noqa: E402
from pyruhvro_tpu.schema.parser import parse_schema as ref_parse  # noqa: E402

import chip_smoke  # noqa: E402
from pyruhvro_tpu_torch.ops import decode  # noqa: E402
from pyruhvro_tpu_torch.runtime import capacity, native, pack  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _kafka(n):
    return datagen.kafka_style_datums(n, seed=3)


PACK_CASES = {
    "kafka": lambda: _kafka(300),
    "empty_records": lambda: [b"", b"\x02", b"", b"", b"\x04\x06", b""],
    "all_empty": lambda: [b""] * 5,
    "buffer_items": lambda: [bytearray(b"\x02ab"), memoryview(b"\x04xyz"),
                             b"\x00", memoryview(bytearray(b"q" * 9))],
    "empty_list": lambda: [],
    # past the native join's 1 MB threshold: the copy runs on threads
    "threaded": lambda: [bytes([i % 251]) * (300 + i % 700)
                         for i in range(4000)],
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_native_concat_matches_reference(case):
    data = PACK_CASES[case]()
    flat, offsets = pack.concat_records(data, native=True)
    want_flat, want_offsets = ref_concat(data)
    assert flat.dtype == np.uint8 and offsets.dtype == np.int64
    assert np.array_equal(offsets, want_offsets)
    assert flat.tobytes() == want_flat.tobytes()
    plain_flat, plain_offsets = pack.concat_records(data)
    assert np.array_equal(offsets, plain_offsets)
    assert flat.tobytes() == plain_flat.tobytes()


def test_native_concat_keeps_the_tail_zeroed():
    data = _kafka(50)
    flat, offsets = pack.concat_records(data, tail=16, native=True)
    plain, _ = pack.concat_records(data, tail=16)
    assert flat.size == offsets[-1] + 16 and not flat[-16:].any()
    assert flat.tobytes() == plain.tobytes()


@pytest.mark.parametrize("native_join", [True, False])
def test_concat_raises_on_an_item_that_is_not_bytes(native_join):
    with pytest.raises(TypeError):
        pack.concat_records([b"\x02", 7, b""], native=native_join)
    with pytest.raises(TypeError):
        pack.concat_records([b"\x02", "text"], native=native_join)


def test_native_build_is_keyed_and_reused():
    lib = native.load_packer()
    assert native.load_packer() is lib
    assert lib.path.parent == native.BUILD_DIR and lib.path.exists()
    assert lib.command[0].endswith("g++")
    assert {"-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"} <= set(
        lib.command)
    assert lib.module.max_len([b"ab", b"", b"xyz"]) == (3, 5)


def test_pack_launch_into_matches_reference():
    """A chunk of a larger concat, its offsets starting above 0, packed
    into an arena that held other bytes: the reference's buffer."""
    data = _kafka(200)
    flat, offsets = pack.concat_records(data, native=True)
    a, b = 37, 121
    R, B = pack.launch_shape(b - a, int(offsets[b] - offsets[a]))
    got = np.full(B // 4 + 2 * R + 1, 0xDEADBEEF, np.uint32)
    want = got.copy()
    chunk = flat[offsets[a]:offsets[b]]
    pack.pack_launch_into(got, chunk, offsets[a:b + 1], R, B)
    ref_pack(want, chunk, offsets[a:b + 1], b - a, R, B)
    assert np.array_equal(got, want)


# the knob values of tests/test_device_fastpath.py::test_overlap_knob_off,
# the defaults, and values that do not parse (they give the defaults)
OVERLAP_CASES = [
    ("0", None, 1 << 20), (None, "1000", 999), (None, "1000", 2000),
    (None, "1000", 1 << 20), (None, None, 8191), (None, None, 8192),
    (None, None, 40_000), ("off", "64", 512), ("yes", "64", 100),
    ("maybe", "x", 9000), (" TRUE ", " 16 ", 48), (None, "0", 5),
    (None, "-3", 7),
]


@pytest.mark.parametrize("overlap,rows,n", OVERLAP_CASES)
def test_overlap_chunks_matches_reference(monkeypatch, overlap, rows, n):
    for name, value in (("PYRUHVRO_TPU_OVERLAP", overlap),
                        ("PYRUHVRO_TPU_OVERLAP_ROWS", rows)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert decode.overlap_chunks(n) == ref_overlap_chunks(n)


def _flat_decoder():
    return decode.DeviceDecoder(
        parse_schema(chip_smoke.PIPELINE_SHAPES["flat"]), device="cpu")


def test_arena_identity_per_thread_and_slot():
    dec = _flat_decoder()
    a0 = dec._arena(64, 1024, slot=0)
    assert dec._arena(64, 1024, slot=0) is a0
    a1 = dec._arena(64, 1024, slot=1)
    assert a1 is not a0 and a1.host.ctypes.data != a0.host.ctypes.data
    assert a0.host.size == 1024 // 4 + 2 * 64 + 1
    assert a0.dev is a0.host_t  # the CPU arena is one plain tensor
    other = []
    t = threading.Thread(target=lambda: other.append(
        dec._arena(64, 1024, slot=0)))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and other[0] is not a0
    # a larger B supersedes the smaller arena of this (R, slot, thread)
    big = dec._arena(64, 4096, slot=0)
    assert dec._arena(64, 4096, slot=0) is big
    assert (64, 1024, 0, threading.get_ident()) not in dec._arenas
    assert dec._arena(64, 1024, slot=1) is a1


def test_arenas_keep_their_identity_across_calls(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_OVERLAP_ROWS", "32")
    dec = _flat_decoder()
    schema = chip_smoke.PIPELINE_SHAPES["flat"]
    data = datagen.random_datums(parse_schema(schema), 128, seed=5)
    dec.decode_to_columns_overlapped(data, 4)
    first = dict(dec._arenas)
    assert sorted(k[2] for k in first) == [0, 1]
    ptrs = {k: a.host.ctypes.data for k, a in first.items()}
    dec.decode_to_columns_overlapped(data, 4)
    assert dec._arenas.keys() == first.keys()
    assert all(dec._arenas[k] is a and a.host.ctypes.data == ptrs[k]
               for k, a in first.items())
    dec.decode_to_columns(data)  # the single launch: slot 0 of its R
    assert dec._arenas.keys() - first.keys()


PLANNER_SCHEMAS = ["arr_rec_arr", "NR3"]


@pytest.mark.parametrize("shape", PLANNER_SCHEMAS)
def test_planner_learns_the_references_rung(shape):
    """After one converged ladder on each side, the planner holds the same
    caps for the same schema and R as the reference's; a fresh decoder of
    that schema then decodes at one rung, with the same columns."""
    schema = chip_smoke.PIPELINE_SHAPES[shape]
    # item counts past the first rung's 8 in every region
    cases = {c[0]: c for c in chip_smoke.pipeline_fixtures(
        datagen, parse_schema, 40)}
    data = cases[f"{shape}_overflow"][2] if f"{shape}_overflow" in cases \
        else cases["nested_overflow"][2]
    capacity.reset()
    ref_capacity.reset()
    port = decode.DeviceDecoder(parse_schema(schema), device="cpu",
                                fingerprint=f"planner-{shape}")
    host, n, meta = port.decode_to_columns(data)
    assert meta["timings"]["rungs"] > 1
    flat, offsets = pack.concat_records(data)
    R, B = pack.launch_shape(n, int(offsets[-1]))
    ref = RefDecoder(ref_parse(schema))
    # the reference's own decode path: the host sample after a plan miss
    if not ref.seed_from_plan(R):
        ref.seed_caps_from_sample(data, R)
    arena = ref._arena(R, B)
    ref_pack(arena, flat, offsets, n, R, B)
    ref._run_ladder(arena, R, B)
    got = capacity.lookup(port.fingerprint, R)
    want = ref_capacity.lookup(ref.fingerprint, R)
    assert want is not None and got == want
    assert capacity.snapshot() == {"plans": 1, "schemas": 1}
    fresh = decode.DeviceDecoder(parse_schema(schema), device="cpu",
                                 fingerprint=port.fingerprint)
    host2, _n, meta2 = fresh.decode_to_columns(data)
    assert meta2["timings"]["rungs"] == 1
    assert fresh.caps_snapshot(R) == port.caps_snapshot(R)
    assert host2.keys() == host.keys()
    for k in host:
        assert np.array_equal(host2[k], host[k])
    # another fingerprint has no plan, and a decoder without one does not
    # use the planner: both climb again
    for fp in ("other", None):
        other = decode.DeviceDecoder(parse_schema(schema), device="cpu",
                                     fingerprint=fp)
        assert other.decode_to_columns(data)[2]["timings"]["rungs"] > 1
    assert capacity.snapshot() == {"plans": 2, "schemas": 2}
    capacity.reset()
    ref_capacity.reset()


def test_planner_merges_by_monotonic_max():
    capacity.reset()
    capacity.learn("fp", 64, {"a": 16, "b": 8}, {"a": 256}, [1024])
    capacity.learn("fp", 64, {"a": 8, "b": 32}, {"a": 128, "c": 4}, [2048])
    assert capacity.lookup("fp", 64) == {
        "item_caps": {"a": 16, "b": 32}, "tot_caps": {"a": 256, "c": 4},
        "str_full_B": {1024, 2048}}
    assert capacity.lookup("fp", 128) is None
    assert capacity.lookup("other", 64) is None
    capacity.learn("", 64, {"a": 1}, {})  # no identity: not learned
    assert capacity.snapshot() == {"plans": 1, "schemas": 1}
    capacity.reset()
    assert capacity.snapshot() == {"plans": 0, "schemas": 0}


def test_planned_bucket_streams_every_chunk(monkeypatch):
    """A bucket the planner knows streams chunk 0 too: no chunk climbs a
    ladder of its own, each takes one rung."""
    monkeypatch.setenv("PYRUHVRO_TPU_OVERLAP_ROWS", "32")
    capacity.reset()
    schema = chip_smoke.PIPELINE_SHAPES["arr_rec_arr"]
    data = datagen.random_datums(parse_schema(schema), 128, seed=8)
    cold = decode.DeviceDecoder(parse_schema(schema), device="cpu",
                                fingerprint="planned")
    cold.decode_to_columns_overlapped(data, 4)
    warm = decode.DeviceDecoder(parse_schema(schema), device="cpu",
                                fingerprint="planned")
    triples = warm.decode_to_columns_overlapped(data, 4)
    t = triples[0][2]["timings"]
    assert (t["chunks"], t["rungs"], t["reruns"]) == (4, 4, 0)
    capacity.reset()
