"""The walk kernel's (K1) block design, modelled on the CPU.

``csrc/decode_walk.cu`` stages each block's records in shared memory and
reads a byte from that copy only when its clipped address lies inside
it; reads that leave the span (a block's last lane overrunning into the
next block, a cursor wrapped by a string length of 2^31-1) come from the
words in device memory, and the last record's reads past the words clip
to the last word, inside the last block's copy when that is staged. The
Python model in ``test_torch_decode_kernels.py`` follows those blocks;
here it runs on batches of several blocks built to take each of those
reads, under staging plans that stage all, some or none of the blocks
(and with no key folded per block), and is held bit-equal to the plain
walk. One such batch also goes through the reference's own error lanes.
The source's constants, its table layout and where it counts its blocks
are checked against the wrapper's mirror of them.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from pyruhvro_tpu.ops.decode import DeviceDecoder as RefDecoder  # noqa: E402
from pyruhvro_tpu.schema.parser import parse_schema as ref_parse  # noqa: E402

import chip_smoke  # noqa: E402
from pyruhvro_tpu_torch.ops import _build  # noqa: E402
from pyruhvro_tpu_torch.ops import decode  # noqa: E402
from pyruhvro_tpu_torch.ops.fieldprog import lower  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402
from test_torch_decode_kernels import model_walk_launch  # noqa: E402
from test_torch_decode_kernels import table_parts  # noqa: E402

ROWS = 300  # three blocks of 128 lanes with records, R = 512
EDGES = {name: (schema, datums, bad) for name, schema, datums, bad in
         chip_smoke.block_edge_fixtures(datagen, parse_schema, ROWS)}
WALK_CU = (Path(_build.CSRC) / "decode_walk.cu").read_text()
# the batches with reads outside every block's span: the overrun into the
# next block and the wrapped cursor (its clipped address is the last word)
LEAVING = {"block_last_lane_overrun", "string_len_2^31-1_staged"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _launch_views(datums):
    """``(words, starts, lengths, n, R, B)`` of the batch's first rung."""
    flat, lanes, n, R, B = decode.DeviceDecoder.pack(datums)
    packed = decode.DeviceDecoder.launch_buffer(flat, lanes, B, "cpu")
    words, starts, lengths = decode.DeviceDecoder.launch_views(packed, R, B)
    return words, starts, lengths, n, R, B


def _model_run(L):
    """``_DecodeWalkKernel.run`` on the model, with every launch's byte
    reads summed: ``(buffers, #err, [staged, from the words])``."""
    reads = [0, 0]
    for _ in range(decode._MAX_WALK_LAUNCHES):
        got = model_walk_launch(L)
        reads = [reads[0] + got[0], reads[1] + got[1]]
        if L.settle():
            L.apply_log()
            return L.bufs, L.err, reads
    raise AssertionError("bounds did not settle")


def _plans(starts, lengths, n, B):
    """Every block staged; about half of them (the budget at the median
    span); none; and every block staged with no key folded per block."""
    _a, span, _s, covers = decode.walk_input_staging(starts, lengths, n, B,
                                                     1 << 30)
    median = int(np.median(span[covers])) // 16 * 16
    return {"all": {"in_max": 1 << 17},
            "half": {"in_max": median},
            "none": {"in_max": 0},
            "unfolded": {"in_max": 1 << 17, "_fold": 0}}


@pytest.mark.parametrize("plan", ["all", "half", "none", "unfolded"])
@pytest.mark.parametrize("name", sorted(EDGES))
def test_block_model_matches_plain_walk(name, plan):
    """Every buffer and ``#err`` bit-equal to the plain walk, whichever
    blocks are staged and whether keys are folded per block; the reads
    that leave a staged span come from the words; the blocks counted in
    the status are the staging plan's."""
    schema, datums, _bad = EDGES[name]
    prog = lower(parse_schema(schema))
    words, starts, lengths, n, R, B = _launch_views(datums)
    assert n < R and R // decode.WALK_THREADS >= 3
    caps = (0,) + (8,) * (len(prog.regions) - 1)
    opts = _plans(starts, lengths, n, B)[plan]
    L = decode.WalkLaunch(words, starts, lengths, n, prog, caps, **opts)
    _a, _span, staged, covers = L.input_staging()
    kb, ke, (from_copy, from_words) = _model_run(L)
    pb, pe = decode.walk_plain(words, starts, lengths, n, prog, caps)
    for key, k, p in zip(prog.out_keys + ["#err"], kb + [ke], pb + [pe]):
        assert torch.equal(k, p), (name, plan, key)
    if plan == "none":
        assert not staged.any() and from_copy == 0
    else:
        assert staged.any() and from_copy > 0
    if plan == "half":
        assert (covers & ~staged).any()
    if plan == "none" or name in LEAVING:
        assert from_words > 0, (name, plan)
    assert L.blocks == (int(staged.sum()), int((covers & ~staged).sum()))
    assert L.fold == (0 if plan == "unfolded" else decode.WALK_KEY_FOLD)


def test_edge_reads_leave_the_staged_span():
    """At a 32 KiB budget every block of the edge batches is staged but
    the one over it. The overrun at a block's last lane and the wrapped
    cursor still read the words; the last record's reads past the words
    clip to the last word, which the last block's copy holds; the block
    over the budget reads the words."""
    for name, (schema, datums, bad) in EDGES.items():
        prog = lower(parse_schema(schema))
        words, starts, lengths, n, R, B = _launch_views(datums)
        caps = (0,) + (8,) * (len(prog.regions) - 1)
        L = decode.WalkLaunch(words, starts, lengths, n, prog, caps,
                              in_max=1 << 15)
        _a, _span, staged, covers = L.input_staging()
        _kb, ke, (_c, from_words) = _model_run(L)
        assert bool((ke.numpy() != 0).any()) == bad, name
        if name == "record_over_the_staging_budget":
            assert covers.sum() - staged.sum() == 1
        else:
            assert (staged == covers).all(), name
        if name == "last_record_to_the_clip":
            assert B == sum(map(len, datums))
            assert from_words == 0
        else:
            assert from_words > 0, name


@pytest.fixture(scope="module")
def kafka_ref():
    return RefDecoder(ref_parse(datagen.KAFKA_SCHEMA_JSON))


def test_block_edge_err_matches_reference(kafka_ref):
    """The overrun at each block's last lane: the model's ``#err`` (its
    reads into the next block from the words) equals the reference's
    error lanes (``_err_fn``) on the same packed input."""
    schema, datums, _bad = EDGES["block_last_lane_overrun"]
    prog = lower(parse_schema(schema))
    words, starts, lengths, n, R, B = _launch_views(datums)
    caps = (0,) + (8,) * (len(prog.regions) - 1)
    L = decode.WalkLaunch(words, starts, lengths, n, prog, caps,
                          in_max=1 << 15)
    _kb, ke, _reads = _model_run(L)
    arena = torch.cat([words, starts, lengths,
                       torch.tensor([n], dtype=torch.int32)]).numpy()
    want = kafka_ref._err_fn(R, B, caps)(
        *(jax.device_put(a) for a in kafka_ref._arena_views(
            arena.view(np.uint32), R, B)), np.int32(n))
    got = ke.numpy().view(np.uint32)
    assert np.array_equal(got, np.asarray(want))
    assert got[127] != 0 and got[255] != 0


def test_input_staging_follows_the_active_lanes():
    """A block's span runs from its first lane's start to its last active
    lane's end, widened to 16 B; lanes past ``n`` stay out of it."""
    starts = torch.tensor([3, 10, 50, 90, 200, 200], dtype=torch.int32)
    lengths = torch.tensor([7, 40, 40, 110, 0, 0], dtype=torch.int32)
    a, span, staged, covers = decode.walk_input_staging(starts, lengths, 4,
                                                        256, 208)
    assert a.tolist() == [0] and span.tolist() == [208]
    assert staged.tolist() == [True] and covers.tolist() == [True]
    _a, _s, staged, _c = decode.walk_input_staging(starts, lengths, 4, 256,
                                                   192)
    assert staged.tolist() == [False]
    _a, _s, staged, _c = decode.walk_input_staging(starts, lengths, 4, 200,
                                                   208)
    assert staged.tolist() == [False]  # past the words
    _a, span, staged, covers = decode.walk_input_staging(starts, lengths, 0,
                                                         256, 208)
    assert span.tolist() == [0] and not covers.any() and not staged.any()


def test_budgets_keep_the_blocks_per_sm():
    """Left None, the input budget is the most that costs no resident
    block; a cap given is taken as it is, to 16 B."""
    def per_sm(in_bytes):  # 2 KiB of tables, 16 blocks at most
        return min(16, (228 << 10) // (2048 + in_bytes))

    assert per_sm(0) == 16
    in_budget = decode.walk_budget(per_sm, None)
    assert per_sm(in_budget) == 16 and per_sm(in_budget + 16) < 16
    assert in_budget % 16 == 0
    assert decode.walk_budget(per_sm, 4096) == 4096
    assert decode.walk_budget(per_sm, 100) == 96
    assert decode.walk_budget(None, None) == decode._WALK_IN_MAX


def _c_body(name: str) -> str:
    body = WALK_CU[WALK_CU.index(name):]
    return body[:body.index("\n}\n")]


def test_table_layout_agrees_with_the_kernel():
    """The packed table's int32 parts start where ``tab_offsets`` in the
    source puts them, in the order the model reads them; the launch
    status holds the log's length where the source counts it, and the
    block counts after it."""
    prog = lower(parse_schema(datagen.KAFKA_SCHEMA_JSON))
    nb, nr = len(prog.out_keys), len(prog.regions)
    for n_keys in (0, 1, 37):
        o = types.SimpleNamespace()
        env = {"code_len": len(prog.code), "n_bufs": nb, "n_regions": nr,
               "n_keys": n_keys, "o": o, "max": max}
        for part, expr in re.findall(r"o\.(\w+) = ([^;]+);",
                                     _c_body("tab_offsets(")):
            setattr(o, part, eval(expr, env))
        at, want = 0, {}
        for part, n in table_parts(len(prog.code), nb, nr, n_keys):
            want[part] = at
            at += n
        assert want.pop("code") == 0
        assert vars(o) == want
    kernel = _c_body("decode_walk_kernel(Params P)")
    assert "log_n = P.status + 3 * max(P.n_keys, 1) + 2 * P.n_regions;" \
        in WALK_CU
    assert "blocks = P.status + 3 * keys + 2 * P.n_regions + 1;" in kernel
    assert "atomicAdd(&blocks[staged ? 0 : 1], 1);" in kernel
    schema, datums, _bad = EDGES["block_last_lane_overrun"]
    words, starts, lengths, n, R, B = _launch_views(datums)
    L = decode.WalkLaunch(words, starts, lengths, n, prog, (0, 8, 8))
    assert L.log_at() == 3 * max(L.n_keys, 1) + 2 * nr
    assert L.status.numel() == L.log_at() + 3


def test_source_agrees_with_the_wrapper():
    """Block size, the loop-stack instantiations and the folded keys are
    the same in ``decode_walk.cu`` and in the wrapper."""
    assert int(re.search(r"kThreads = (\d+);", WALK_CU).group(1)) == \
        decode.WALK_THREADS
    assert int(re.search(r"kKeyTab = (\d+);", WALK_CU).group(1)) == \
        decode.WALK_KEY_FOLD
    for fn in ("decode_walk_blocks_per_sm", "decode_walk("):
        cases = [int(c) for c in re.findall(r"case (\d+): return",
                                            _c_body(fn))]
        assert tuple(cases) == decode.WALK_STACKS, fn
    prog = lower(parse_schema(datagen.KAFKA_SCHEMA_JSON))
    assert decode.walk_stack(prog.depth) == 1
    assert [decode.walk_stack(d) for d in range(9)] == \
        [1, 1, 2, 8, 8, 8, 8, 8, 8]
    with pytest.raises(decode.DeviceCapacityExceeded):
        decode.walk_stack(9)
