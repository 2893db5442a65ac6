"""The port's pipeline engine held against the reference's, on the CPU.

``pyruhvro_tpu_torch.ops.decode`` (``DeviceDecoder``: the plain walk and
the plain finalize, the kernels' plain versions) against
``pyruhvro_tpu.ops.decode.DeviceDecoder`` (the jitted XLA pipeline) on the
same packed inputs, made from seeds: the blob byte for byte at every rung
the ladder visits, in the compact and full-width modes, ``#err`` against
``_trace_walk`` on malformed batches, the ladder's caps, and the public
path against the oracle. Decode is integer work: the tolerance is 0.

The fixtures are ``chip_smoke.pipeline_fixtures``, the ones the card
holds the kernels against, at a small size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from pyruhvro_tpu.fallback.decoder import decode_to_record_batch  # noqa: E402
from pyruhvro_tpu.ops.decode import DeviceDecoder as RefDecoder  # noqa: E402
from pyruhvro_tpu.ops.decode import pack_launch_into as ref_pack  # noqa: E402
from pyruhvro_tpu.schema.arrow_map import to_arrow_schema as ref_arrow  # noqa: E402
from pyruhvro_tpu.schema.parser import parse_schema as ref_parse  # noqa: E402
from pyruhvro_tpu.utils.datagen import random_schema  # noqa: E402

import chip_smoke  # noqa: E402
from pyruhvro_tpu_torch import (  # noqa: E402
    BatchTooLarge,
    MalformedAvro,
    deserialize_array,
    deserialize_array_threaded,
)
from pyruhvro_tpu_torch.errors import DeviceCapacityExceeded  # noqa: E402
from pyruhvro_tpu_torch.ops import decode  # noqa: E402
from pyruhvro_tpu_torch.ops.fieldprog import lower  # noqa: E402
from pyruhvro_tpu_torch.runtime import pack  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

ROWS = 24
FIXTURES = {name: (schema, datums, bad) for name, schema, datums, bad in
            chip_smoke.pipeline_fixtures(datagen, parse_schema, ROWS)}
MALFORMED = sorted(k for k, v in FIXTURES.items() if v[2])
# every rung, both string modes and the ladder's end on the reference's
# own test shapes; the first rung alone on the fixtures that overflow it
# (items under dropped items, long strings, negative blocks) and on the
# one with more finalize jobs per pass than a block resolves at once
# (kJobChunk in csrc/decode_finalize.cu); #err at the
# first rung on the malformed ones and the zero-byte loops. XLA's CPU
# compiles (one per rung and mode) bound this file's time.
LADDER_FIXTURES = sorted(chip_smoke.PIPELINE_SHAPES) + ["kafka"]
FIRST_RUNG_FIXTURES = ["nested_overflow", "NR3_overflow",
                       "nested_global_bound", "record_64KiB_len16",
                       "negative_block_counts", "many_fields"]
ERR_FIXTURES = MALFORMED + ["nested_global_bound", "zero_byte_items"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_refs = {}


def _ref(schema: str) -> RefDecoder:
    """One reference decoder per schema (its jit cache outlives a
    fixture), its capacity ladder back at the first rung."""
    if schema not in _refs:
        _refs[schema] = RefDecoder(ref_parse(schema))
    ref = _refs[schema]
    ref._item_caps = [0] + [8] * (len(ref.prog.regions) - 1)
    ref._tot_cap_mem.clear()
    ref._str_full.clear()
    return ref


def _packed(datums):
    """``(port's packed buffer, R, B, n)``; the reference's packing of the
    same records must give the same buffer."""
    flat, lanes, n, R, B = decode.DeviceDecoder.pack(datums)
    buf = decode.DeviceDecoder.launch_buffer(flat, lanes, B, "cpu")
    buf = buf.numpy().view(np.uint32)
    _flat, offsets = pack.concat_records(datums)
    want = np.full_like(buf, 0xDEADBEEF)
    ref_pack(want, flat, offsets, n, R, B)
    assert np.array_equal(buf, want)
    return buf, R, B, n


def _ref_blob(ref, arena, R, B, caps, tot, compact):
    fn, layout = ref._pipeline_fn(R, B, caps, tot, compact)
    return np.asarray(jax.device_get(fn(jax.device_put(arena.copy())))), \
        layout


def _port_rungs(port, datums):
    """Decode on the port's CPU path, recording every rung's blob. The
    ladder starts at the first rung, with no host sample, as the
    reference's ``_run_ladder`` that it is held against does."""
    rungs = []
    real = port.pipeline
    port.seed_caps_from_sample = lambda data, R: None

    def recording(packed, R, B, n, item_caps, tot_caps, compact,
                  timings=None):
        blob, err = real(packed, R, B, n, item_caps, tot_caps, compact,
                         timings)
        rungs.append((item_caps, tot_caps, compact, blob.numpy().copy()))
        return blob, err

    port.pipeline = recording
    try:
        port.decode_to_columns(datums)
        outcome = None
    except MalformedAvro as e:
        outcome = (str(e), e.indices)
    return rungs, outcome


@pytest.mark.parametrize("name", LADDER_FIXTURES)
def test_blob_and_ladder_match_reference(name):
    """At every rung the port's ladder visits, its blob is byte-equal to
    the reference pipeline's on the same packed input, and at the last
    rung in the other string mode too (compact sl32/len16 against full
    width); the ladder ends at the reference's caps and string mode."""
    schema, datums, _bad = FIXTURES[name]
    ref = _ref(schema)
    port = decode.DeviceDecoder(parse_schema(schema), device="cpu")
    arena, R, B, n = _packed(datums)
    rungs, outcome = _port_rungs(port, datums)
    assert rungs
    modes = {c for _i, _t, c, _b in rungs}
    for item_caps, tot_caps, compact, blob in rungs:
        want, layout = _ref_blob(ref, arena, R, B, item_caps, tot_caps,
                                 compact)
        assert decode.blob_layout(port.prog, R, B, item_caps, tot_caps,
                                  compact) == [
            (k, np.dtype(d), ln) for k, d, ln in layout]
        assert blob[-decode.STATUS_BYTES:].tolist() == [0] * 8
        assert np.array_equal(blob[:-decode.STATUS_BYTES], want), (
            name, item_caps, tot_caps, compact)
    if port.prog.string_cols and len(modes) == 1:
        item_caps, tot_caps, compact, _blob = rungs[-1]
        words, starts, lengths = port.launch_views(
            torch.from_numpy(arena.view(np.int32)), R, B)
        bufs, err = decode.walk_plain(words, starts, lengths, n, port.prog,
                                      item_caps)
        other = decode.finalize_plain(bufs, err, port.prog, R, B, item_caps,
                                      tot_caps, not compact).numpy()
        want, _layout = _ref_blob(ref, arena, R, B, item_caps, tot_caps,
                                  not compact)
        assert np.array_equal(other[:-decode.STATUS_BYTES], want)
    # the reference's own ladder, from the same first rung
    host = ref._run_ladder(arena, R, B)
    assert port._item_caps == ref._item_caps
    assert port._tot_cap_mem == ref._tot_cap_mem
    assert port._str_full == ref._str_full
    assert outcome is None and not host["#red:err"][0]


@pytest.mark.parametrize("name", FIRST_RUNG_FIXTURES)
def test_first_rung_blob_matches_reference(name):
    """Where the first rung overflows (items under a dropped item wrap
    into the first record's slots, strings overflow the compact
    descriptors), its blob is still the reference's, byte for byte."""
    schema, datums, _bad = FIXTURES[name]
    ref = _ref(schema)
    port = decode.DeviceDecoder(parse_schema(schema), device="cpu")
    arena, R, B, n = _packed(datums)
    item_caps, tot_caps = port.caps_snapshot(R)
    blob, _err = port.pipeline(torch.from_numpy(arena.view(np.int32)), R, B,
                               n, item_caps, tot_caps, True)
    want, _layout = _ref_blob(ref, arena, R, B, item_caps, tot_caps, True)
    assert np.array_equal(blob.numpy()[:-decode.STATUS_BYTES], want)


@pytest.mark.parametrize("name", ERR_FIXTURES)
def test_err_lanes_match_reference(name):
    """``#err`` of the plain walk equals the reference's error lanes
    (``_err_fn``, the walk's ``#err``) at the first rung: the global loop
    bound (a lane cut by another lane's span inside a nested loop), items
    past the cap, reads past a record's end and the clipped reads all
    decide these bits. Where the ladder ends on that rung, a malformed
    batch raises the reference's message with every bad row's index."""
    schema, datums, bad = FIXTURES[name]
    ref = _ref(schema)
    port = decode.DeviceDecoder(parse_schema(schema), device="cpu")
    arena, R, B, n = _packed(datums)
    caps, _tot = port.caps_snapshot(R)
    words, starts, lengths = port.launch_views(
        torch.from_numpy(arena.view(np.int32)), R, B)
    _bufs, err = decode.walk_plain(words, starts, lengths, n, port.prog, caps)
    want = ref._err_fn(R, B, caps)(
        *(jax.device_put(a) for a in ref._arena_views(arena, R, B)),
        np.int32(n))
    assert np.array_equal(err.numpy().view(np.uint32), np.asarray(want))
    _rungs, outcome = _port_rungs(port, datums)
    assert (outcome is not None) == bad
    if bad and port.caps_snapshot(R)[0] == caps:
        with pytest.raises(Exception) as ei:
            ref._raise_row_errors(arena, R, B, n)
        assert outcome == (str(ei.value), ei.value.indices)


def test_global_bound_fixture_needs_the_global_bound():
    """The nested fixture's second record has 300 zero-byte items and 5
    bytes left at its inner loop's entry. Alone, its loop runs 5 + 8 + 2 =
    15 iterations; beside the first record (105 bytes left at the same
    loop entry) it runs the global bound, 105 + 8 + 2 = 115, and is cut
    there. The third record's second outer item is alone in its loop
    instance (outer iteration 1): 8 + 8 + 2 = 18."""
    from pyruhvro_tpu_torch.ops.varint import (
        ERR_ITEM_OVERFLOW,
        ERR_OVERRUN,
        ERR_TRAILING,
    )

    schema, datums, _bad = FIXTURES["nested_global_bound"]
    prog = lower(parse_schema(schema))
    count = prog.out_keys.index("aa/@item#count")
    cut = ERR_ITEM_OVERFLOW | ERR_OVERRUN | ERR_TRAILING
    for batch, want in ((datums, [3, 115, 18]), (datums[1:2], [15])):
        arena, R, B, n = _packed(batch)
        words, starts, lengths = decode.DeviceDecoder.launch_views(
            torch.from_numpy(arena.view(np.int32)), R, B)
        bufs, err = decode.walk_plain(words, starts, lengths, n, prog,
                                      (0, 8, 8))
        got = bufs[count].tolist()
        assert [got[0], got[8], got[17]][:len(want)] == want
        assert err[1 if len(want) > 1 else 0] == cut


@pytest.mark.parametrize("name", ["arr_rec_arr", "NR3", "nested_overflow",
                                  "NR3_overflow", "record_8KiB",
                                  "record_64KiB_len16", "zero_byte_items",
                                  "nested_global_bound",
                                  "negative_block_counts"])
def test_public_path_matches_oracle(name):
    """``deserialize_array_threaded(..., device="cpu")`` equals the
    oracle value by value: nested repetition (three levels), records of 8
    and 64 KiB, more than 1024 items in one record."""
    schema, datums, _bad = FIXTURES[name]
    ir = ref_parse(schema)
    want = decode_to_record_batch(datums, ir, ref_arrow(ir)).to_pylist()
    got = deserialize_array_threaded(datums, schema, 3, device="cpu")
    assert [r for b in got for r in b.to_pylist()] == want


def test_random_nested_schemas_match_oracle():
    """Generated schemas with nested repetition (the ones the row-padded
    engine refuses) decode on the pipeline engine."""
    checked = 0
    for seed in range(60):
        schema = random_schema(seed)
        prog = lower(parse_schema(schema))
        if prog.depth < 2:
            continue
        ir = ref_parse(schema)
        datums = datagen.random_datums(parse_schema(schema), 30, seed=seed)
        want = decode_to_record_batch(datums, ir, ref_arrow(ir))
        assert deserialize_array(datums, schema,
                                 device="cpu").to_pylist() == want.to_pylist()
        checked += 1
    assert checked >= 3


def test_blob_layout_matches_reference_everywhere():
    """The blob layout of many schemas, rungs and string modes equals the
    reference's (``build_pipeline`` returns it without tracing)."""
    schemas = [random_schema(s) for s in range(30)] + \
        list(chip_smoke.PIPELINE_SHAPES.values())
    for schema in schemas:
        ref = RefDecoder(ref_parse(schema))
        prog = lower(parse_schema(schema))
        for R, B, cap in ((8, 16, 8), (64, 1 << 21, 32)):
            caps = tuple([0] + [cap] * (len(prog.regions) - 1))
            tot = tuple([0] + [R * cap] * (len(prog.regions) - 1))
            for compact in (True, False):
                _fn, want = ref.build_pipeline(R, B, caps, tot, compact)
                assert decode.blob_layout(prog, R, B, caps, tot, compact) == \
                    [(k, np.dtype(d), ln) for k, d, ln in want]


def test_fixture_shapes_are_the_reference_tests_shapes():
    from test_device_decode import SHAPES

    for name, schema in SHAPES.items():
        assert chip_smoke.PIPELINE_SHAPES[name] == schema, name


def test_item_cap_limit_raises_device_capacity_exceeded(monkeypatch):
    """Past the per-record item cap the port raises: it has no host tier
    to serve the batch from."""
    monkeypatch.setattr(decode, "_MAX_ITEM_CAP", 64)
    schema = chip_smoke.LADDER_SCHEMA
    enc = chip_smoke.zz
    datums = [enc(100) + b"".join(enc(i) for i in range(100)) + enc(0),
              enc(0)]
    with pytest.raises(DeviceCapacityExceeded, match="100 item slots"):
        deserialize_array(datums, schema, device="cpu")


def test_slot_limits_raise_before_a_launch():
    prog = lower(parse_schema(chip_smoke.PIPELINE_SHAPES["NR3"]))
    big = (0, 1 << 10, 1 << 10, 1 << 10)
    with pytest.raises(BatchTooLarge):
        decode.check_slots(prog, 64, big)
    with pytest.raises(DeviceCapacityExceeded):
        decode.check_slots(prog, 8, big)
    decode.check_slots(prog, 8, (0, 1 << 8, 1 << 8, 1 << 8))


def test_halving_rebases_the_malformed_row(monkeypatch):
    """Over the launch's byte budget the codec halves the batch (each half
    still on the pipeline engine); a bad row in a right half still names
    its index in the whole batch, with every bad row's index re-based."""
    schema = chip_smoke.PIPELINE_SHAPES["arr_rec_arr"]
    datums = datagen.random_datums(parse_schema(schema), 400, seed=4)
    whole = deserialize_array(datums, schema, device="cpu")
    monkeypatch.setattr(decode, "LAUNCH_MAX_BYTES", 4_000)
    calls = []
    real = decode.DeviceDecoder.decode_to_columns

    def counting(self, data):
        calls.append(len(data))
        return real(self, data)

    monkeypatch.setattr(decode.DeviceDecoder, "decode_to_columns", counting)
    assert deserialize_array(datums, schema, device="cpu").to_pylist() == \
        whole.to_pylist()
    assert len(calls) > 3 and max(calls[1:]) < 400
    datums[390] = b"\x82"
    datums[397] = b""
    with pytest.raises(MalformedAvro) as ei:
        deserialize_array(datums, schema, device="cpu")
    assert str(ei.value).startswith("record 390: ")
    assert ei.value.index == 390
    assert [i for i, _slug in ei.value.indices] == [390, 397]


def test_launch_budget_is_the_engines_own(monkeypatch):
    """The pipeline engine's rule is 2^30 datum bytes per launch
    (``decode.py:981-985``), not the row-padded engine's."""
    dec = decode.DeviceDecoder(parse_schema(chip_smoke.PIPELINE_SHAPES[
        "flat"]), device="cpu")
    monkeypatch.setattr(decode, "LAUNCH_MAX_BYTES", 10)
    with pytest.raises(BatchTooLarge):
        dec.pack([b"\x00" * 11])
    assert pack.LAUNCH_MAX_BYTES == 1 << 30


def test_pack_lays_out_inactive_lanes():
    datums = [b"\x02\x04", b"", b"\x06"]
    buf, R, B, n = _packed(datums)
    W = B // 4
    assert (R, B, n) == (8, 16, 3)
    assert buf[W:W + R].view(np.int32).tolist() == [0, 2, 2] + [16] * 5
    assert buf[W + R:W + 2 * R].view(np.int32).tolist() == \
        [2, 0, 1] + [0] * 5
    assert int(buf[-1]) == 3
    assert bytes(buf[:W].view(np.uint8)) == b"\x02\x04\x06" + bytes(13)


def test_flat_reads_clip_to_the_buffer():
    """Reads past the last word clip to it; a cursor past 2^31 reads as
    unsigned and clips too (``pyruhvro_tpu/ops/varint.py:106-133``)."""
    from pyruhvro_tpu_torch.ops.varint import FlatWords

    w = FlatWords(torch.arange(16, dtype=torch.uint8))
    cur = torch.tensor([0, 13, 14, 15, 40, -4, -(1 << 31)])
    got = [w.window_byte(cur, k).tolist() for k in range(3)]
    assert got[0] == [0, 13, 14, 15, 12, 12, 12]
    assert got[1] == [1, 14, 15, 12, 13, 13, 13]
    assert got[2] == [2, 15, 12, 13, 14, 14, 14]


def test_walk_kernel_wrapper_refuses_cpu_tensors():
    prog = lower(parse_schema(chip_smoke.LADDER_SCHEMA))
    words = torch.zeros(4, dtype=torch.int32)
    lanes = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode.walk_kernel(words, lanes, lanes, 1, prog, (0, 8))
    bufs, err = decode.walk_plain(words, lanes, lanes, 0, prog, (0, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        decode.finalize_kernel(bufs, err, prog, 8, 16, (0, 8), (0, 8), True,
                               decode.FinalizeCache())
