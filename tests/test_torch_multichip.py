"""The chunk fan-out (K5) held against the reference's, on the CPU.

The reference's ``ShardedDecoder`` runs on the spoofed 8-device CPU mesh
(``tests/conftest.py`` sets ``--xla_force_host_platform_device_count=8``);
the port's runs over repeated CPU devices (``[torch.device("cpu")] * D``,
each shard on the kernels' plain versions), its counterpart of that mesh.
Held against the reference, with inputs made from seeds and tolerance 0:
the shards' batches by value on Kafka (D = 8) and a nested shape (D = 4);
the cap ladder's batches and ``device.retries`` (the reference's
``test_multichip.py`` rows, D = 4); bad rows in several shards as one
``MalformedAvro`` (message, ``index``, ``indices``, slug); the codec's
fan-out route against the reference's ``deserialize_array_threaded(...,
backend="tpu")``, with the shards' batches returned as they are for 8
chunks and re-sliced for 3, 5 and 16, and ``on_error="skip"``'s entries.
Held against the oracle: the other shapes, fewer rows than devices, one
record, and the sharded encoder's wire bytes. The routing conditions,
the faults and limits of the fan-out, and its telemetry are the port's
own. Three reference fan-outs are built, module-scoped (XLA's CPU
compiles dominate the time); each schema string is one of this file's
(trailing spaces), so other files' codecs and plans never reach them.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.fallback.decoder import (  # noqa: E402
    decode_to_record_batch as ref_oracle,
)
from pyruhvro_tpu.fallback.encoder import compile_writer  # noqa: E402
from pyruhvro_tpu.ops.codec import get_device_codec as ref_codec  # noqa: E402
from pyruhvro_tpu.parallel import ShardedDecoder as RefSharded  # noqa: E402
from pyruhvro_tpu.parallel import chunk_mesh  # noqa: E402
from pyruhvro_tpu.runtime import capacity as ref_capacity  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402
from pyruhvro_tpu.schema.cache import get_or_parse_schema as ref_entry  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch import DeviceCapacityExceeded, MalformedAvro  # noqa: E402
from pyruhvro_tpu_torch.errors import BatchTooLarge  # noqa: E402
from pyruhvro_tpu_torch.ops import codec as port_codec  # noqa: E402
from pyruhvro_tpu_torch.parallel import (  # noqa: E402
    ShardedDecoder,
    ShardedEncoder,
    chunk_devices,
)
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    capacity,
    device_obs,
    metrics,
    telemetry,
)
from pyruhvro_tpu_torch.runtime.chunking import chunk_bounds  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

from test_device_decode import SHAPES  # noqa: E402

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the spoofed 8-device CPU mesh")

CPU = torch.device("cpu")
KAFKA = datagen.KAFKA_SCHEMA_JSON + "   "
NESTED = SHAPES["arr_rec_arr"] + "   "
ARR = SHAPES["arr"] + "   "


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """One launch per batch on both sides' one-card paths; one torch
    thread (parallel test workers share the CPU)."""
    for name in ("PYRUHVRO_TPU_OVERLAP_ROWS", "PYRUHVRO_TPU_OVERLAP",
                 "PYRUHVRO_TPU_PALLAS", "PYRUHVRO_TPU_MAX_DATUM_BYTES",
                 "PYRUHVRO_TPU_DEADLINE_S"):
        monkeypatch.delenv(name, raising=False)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def same_batches(got, want):
    """Batch by batch: schema, rows and values (``to_pylist``: zero-copy
    slices of sparse unions hold wrong values under ``equals``)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.schema.equals(w.schema), i
        assert g.num_rows == w.num_rows, i
        assert g.to_pylist() == w.to_pylist(), i


def oracle_shards(schema, datums, n_shards):
    """The oracle's batch cut with the reference's bounds, padded with
    empty shards to ``n_shards``."""
    ir = ref_entry(schema).ir
    whole = ref_oracle(datums, ir, ref_entry(schema).arrow_schema)
    bounds = chunk_bounds(len(datums), n_shards)
    bounds += [(len(datums), len(datums))] * (n_shards - len(bounds))
    return [whole.slice(a, b - a) for a, b in bounds]


def port_shards(schema, datums, n_shards, **kw):
    entry = get_or_parse_schema(schema)
    sd = ShardedDecoder(entry.ir, devices=[CPU] * n_shards, **kw)
    return sd.decode(datums, entry.ir, entry.arrow_schema)


def outcome(call):
    """``("ok", result)`` or ``("error", (type, message, index, slug,
    indices))`` of both packages' ``MalformedAvro``."""
    try:
        return "ok", call()
    except ValueError as e:
        return "error", (type(e).__name__, str(e), e.index, e.err_name,
                         e.indices)


def retries(snapshot) -> float:
    return snapshot().get("device.retries", 0)


@pytest.fixture(scope="module")
def kafka():
    """The reference's Kafka codec and its fan-out over the 8 spoofed
    devices (reference build 1, shared by every Kafka case), and the
    module's Kafka datums."""
    codec = ref_codec(ref_entry(KAFKA))
    fan_out = codec._sharded_decoder()
    assert fan_out is not None and fan_out.D == 8
    return fan_out, datagen.kafka_style_datums(200, seed=31)


# -- the devices -----------------------------------------------------------------


def test_chunk_devices():
    assert chunk_devices([CPU] * 8) == [CPU] * 8
    assert chunk_devices(["cpu"] * 8, n_devices=3) == [CPU] * 3
    with pytest.raises(RuntimeError, match="need 9 devices"):
        chunk_devices([CPU] * 8, n_devices=9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no device"):
            chunk_devices()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            chunk_devices(["cuda:0"])
    with pytest.raises(ValueError, match="need a schema IR"):
        ShardedDecoder(devices=[CPU])
    with pytest.raises(ValueError, match="need a schema IR"):
        ShardedEncoder(devices=[CPU])


# -- the decoder against the reference's fan-out ---------------------------------


def test_kafka_shards_equal_the_reference(kafka):
    fan_out, datums = kafka
    entry = ref_entry(KAFKA)
    want = fan_out.decode(datums, entry.ir, entry.arrow_schema)
    got = port_shards(KAFKA, datums, 8)
    same_batches(got, want)
    same_batches(got, oracle_shards(KAFKA, datums, 8))


def test_nested_shards_equal_the_reference():
    entry = ref_entry(NESTED)
    datums = datagen.random_datums(get_or_parse_schema(NESTED).ir, 157,
                                   seed=29)
    fan_out = RefSharded(entry.ir, mesh=chunk_mesh(n_devices=4))
    want = fan_out.decode(datums, entry.ir, entry.arrow_schema)
    got = port_shards(NESTED, datums, 4)
    same_batches(got, want)
    same_batches(got, oracle_shards(NESTED, datums, 4))


def _cap_rows():
    """``test_multichip.py``'s rows: 29 strings an item list, past the
    first rung's caps."""
    w = compile_writer(ref_entry(ARR).ir)
    datums = []
    for i in range(19):
        buf = bytearray()
        w(buf, {"xs": [f"v{i}-{j}" for j in range(29)], "ys": [i, -i],
                "na": (0, None)})
        datums.append(bytes(buf))
    return datums


def test_cap_ladder_equals_the_reference():
    """Both fan-outs climb from the first rung (planners reset, sample
    seeding off): the same batches in as many rungs."""
    datums = _cap_rows()
    ref_capacity.reset()
    capacity.reset()
    entry = ref_entry(ARR)
    fan_out = RefSharded(entry.ir, mesh=chunk_mesh(n_devices=4))
    fan_out.base.seed_caps_from_sample = lambda *a, **k: None
    before = retries(ref_metrics.snapshot)
    want = fan_out.decode(datums, entry.ir, entry.arrow_schema)
    want_retries = retries(ref_metrics.snapshot) - before
    pentry = get_or_parse_schema(ARR)
    sd = ShardedDecoder(pentry.ir, devices=[CPU] * 4)
    sd.base.seed_caps_from_sample = lambda *a, **k: None
    before = retries(metrics.snapshot)
    got = sd.decode(datums, pentry.ir, pentry.arrow_schema)
    assert retries(metrics.snapshot) - before == want_retries > 0
    same_batches(got, want)
    same_batches(got, oracle_shards(ARR, datums, 4))
    # the shards share one rung: the next call climbs nothing
    before = retries(metrics.snapshot)
    same_batches(sd.decode(datums, pentry.ir, pentry.arrow_schema), want)
    assert retries(metrics.snapshot) == before


@pytest.mark.parametrize("bad", [[33], [6, 33], [0, 17, 39]])
def test_bad_rows_in_several_shards_raise_once_as_the_reference(kafka, bad):
    """Row 33 of 40 lies in shard 6 of 8: ``record 33``, and every bad
    row of every shard in ``indices``, re-based to global rows."""
    fan_out, datums = kafka
    datums = list(datums[:40])
    for i in bad:
        datums[i] = datums[i] + b"\x00"
    entry = ref_entry(KAFKA)
    want = outcome(lambda: fan_out.decode(datums, entry.ir,
                                          entry.arrow_schema))
    got = outcome(lambda: port_shards(KAFKA, datums, 8))
    assert got == want
    assert got[0] == "error" and got[1][1].startswith(f"record {bad[0]}:")
    assert [i for i, _slug in got[1][4]] == bad


# -- the decoder against the oracle ----------------------------------------------


@pytest.mark.parametrize("shape", sorted(set(SHAPES) - {"arr_rec_arr"}))
def test_shards_equal_the_oracle(shape):
    datums = datagen.random_datums(get_or_parse_schema(SHAPES[shape]).ir,
                                   157, seed=29)
    same_batches(port_shards(SHAPES[shape], datums, 8),
                 oracle_shards(SHAPES[shape], datums, 8))


@pytest.mark.parametrize("shape, n, n_shards", [
    ("nested", 3, 8), ("arr", 1, 8), ("arr_rec_arr", 5, 8), ("map", 2, 2)])
def test_fewer_rows_than_devices_pad_with_empty_shards(shape, n, n_shards):
    datums = datagen.random_datums(get_or_parse_schema(SHAPES[shape]).ir,
                                   n, seed=41)
    got = port_shards(SHAPES[shape], datums, n_shards)
    assert len(got) == n_shards
    assert [b.num_rows for b in got] == [1] * n + [0] * (n_shards - n)
    same_batches(got, oracle_shards(SHAPES[shape], datums, n_shards))


# -- the encoder -------------------------------------------------------------------


@pytest.mark.parametrize("schema, n, n_shards", [
    (KAFKA, 43, 8), (KAFKA, 3, 8), (NESTED, 37, 4), (ARR, 1, 8)])
def test_sharded_encoder_is_wire_exact(schema, n, n_shards):
    """One ``BinaryArray`` per chunk of the reference's bounds, the
    original datums byte for byte (``serialize.rs:69-99``'s fan-out)."""
    entry = get_or_parse_schema(schema)
    datums = (datagen.kafka_style_datums(n, seed=31) if schema == KAFKA
              else datagen.random_datums(entry.ir, n, seed=33))
    batch = port.deserialize_array(datums, schema, device="cpu")
    enc = ShardedEncoder(entry.ir, entry.arrow_schema,
                         devices=[CPU] * n_shards)
    arrays = enc.encode(batch)
    assert [len(a) for a in arrays] == \
        [b - a for a, b in chunk_bounds(n, n_shards)]
    assert [x for a in arrays for x in a.to_pylist()] == datums
    assert enc in device_obs.holders()


# -- the codec's route ---------------------------------------------------------------


def patch_fan_out(monkeypatch):
    """The codec's fan-out as 8 repeated CPU devices (the CPU box has no
    cards), sharing the codec's decoder; returns the batches each sharded
    call gave and counts the codec's concatenations."""
    calls = {"shards": [], "concat": 0}
    real_concat = port_codec._concat_batches

    fans = {}  # codec -> its fan-out, for this test only

    def cpu_fan_out(self):
        if self not in fans:
            fans[self] = ShardedDecoder(base=self.decoder, devices=[CPU] * 8)
        return fans[self]

    def counting_concat(batches):
        calls["concat"] += 1
        return real_concat(batches)

    real_decode = ShardedDecoder.decode

    def recording(self, data, ir=None, arrow_schema=None):
        out = real_decode(self, data, ir, arrow_schema)
        calls["shards"].append(out)
        return out

    monkeypatch.setattr(port_codec.DeviceCodec, "_sharded_decoder",
                        cpu_fan_out)
    monkeypatch.setattr(port_codec, "_concat_batches", counting_concat)
    monkeypatch.setattr(ShardedDecoder, "decode", recording)
    return calls


@pytest.fixture
def fan_out(monkeypatch):
    return patch_fan_out(monkeypatch)


@pytest.mark.parametrize("num_chunks", [8, 3, 5, 16])
def test_threaded_fan_out_equals_the_reference(kafka, monkeypatch,
                                               num_chunks):
    _fan, datums = kafka
    one_card = port.deserialize_array_threaded(datums, KAFKA, num_chunks,
                                               device="cpu")
    calls = patch_fan_out(monkeypatch)
    got = port.deserialize_array_threaded(datums, KAFKA, num_chunks,
                                          device="cpu")
    want = ref.deserialize_array_threaded(datums, KAFKA, num_chunks,
                                          backend="tpu")
    same_batches(got, want)
    same_batches(got, one_card)
    assert len(calls["shards"]) == 1
    if num_chunks == 8:
        # the shards are the chunks: returned as they are
        assert all(g is s for g, s in zip(got, calls["shards"][0]))
        assert calls["concat"] == 0
    else:
        assert calls["concat"] == 1


def _poisoned(datums, rows):
    datums = list(datums)
    for j, i in enumerate(rows):
        d = datums[i]
        datums[i] = (b"\x01", d[:max(1, len(d) // 3)], b"\xff" * 3 + d)[j % 3]
    return datums


@pytest.mark.parametrize("policy", ["skip", "null"])
def test_tolerant_fan_out_equals_the_reference(kafka, fan_out, policy):
    """The optimistic call goes through the fan-out; its one
    ``MalformedAvro`` names every bad row, and each chunk then decodes
    on its own, as in the reference."""
    _fan, datums = kafka
    datums = _poisoned(datums, [3, 61, 62, 140, 199])
    got, got_q = port.deserialize_array_threaded(
        datums, KAFKA, 8, device="cpu", on_error=policy, return_errors=True)
    want, want_q = ref.deserialize_array_threaded(
        datums, KAFKA, 8, backend="tpu", on_error=policy,
        return_errors=True)
    same_batches(got, want)

    def fields(entries):
        return [(q.index, q.datum, q.error, q.tier) for q in entries]

    assert fields(got_q) == fields(want_q)
    assert [q.index for q in got_q] == [3, 61, 62, 140, 199]
    assert len(fan_out["shards"]) == 0  # the optimistic call raised


def test_fan_out_is_taken_only_for_cuda_without_an_index(monkeypatch):
    """Pipeline engine, ``device="cuda"`` with no index, more than one
    card: the fan-out over every card with the codec's decoder as its
    base. ``"cuda:k"``, ``"cpu"``, one card and the row-padded engine keep
    the one-card path."""
    import pyruhvro_tpu_torch.parallel as par

    built = []
    monkeypatch.setattr(par, "ShardedDecoder",
                        lambda base: built.append(base) or "fan-out")
    entry = get_or_parse_schema(KAFKA)
    cards = {"n": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards["n"])

    def codec(device, pallas="off"):
        c = port_codec.DeviceCodec(entry, "cpu", pallas)
        c.device = torch.device(device)
        return c

    c = codec("cuda")
    assert c._sharded_decoder() == "fan-out" and built == [c.decoder]
    assert c._sharded_decoder() == "fan-out" and len(built) == 1
    for device in ("cuda:0", "cuda:1", "cpu"):
        assert codec(device)._sharded_decoder() is None
    assert codec("cuda", pallas="mosaic")._sharded_decoder() is None
    cards["n"] = 1
    assert codec("cuda")._sharded_decoder() is None
    assert len(built) == 1


def test_fan_out_faults_and_limits(kafka, fan_out, monkeypatch):
    """A fault raises, counted in ``device.call_failure``, and never
    reaches the one-card path; a capacity limit raises under
    ``"device"`` and is answered on the host under ``"auto"``; a shard
    over the byte budget goes to the one-card path, which halves."""
    _fan, datums = kafka
    datums = datums[:64]
    # "auto" keeps a device="cpu" call on the device tier
    monkeypatch.setenv("PYRUHVRO_TPU_DEVICE_MIN_ROWS", "0")
    one_card = []
    real_decode = port_codec.DeviceCodec.decode

    def counted(self, data, **kw):
        one_card.append(len(data))
        return real_decode(self, data, **kw)

    monkeypatch.setattr(port_codec.DeviceCodec, "decode", counted)

    def raising(exc):
        def decode(self, *a, **k):
            raise exc
        monkeypatch.setattr(ShardedDecoder, "decode", decode)

    raising(RuntimeError("launch failed"))
    before = metrics.snapshot().get("device.call_failure", 0)
    for backend in ("device", "auto"):
        with pytest.raises(RuntimeError, match="launch failed"):
            port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu",
                                            backend=backend)
    assert metrics.snapshot().get("device.call_failure", 0) == before + 2
    assert one_card == []

    raising(DeviceCapacityExceeded("too many items"))
    with pytest.raises(DeviceCapacityExceeded):
        port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu")
    before = metrics.snapshot().get("device.host_answer.capacity", 0)
    got = port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu",
                                          backend="auto")
    assert metrics.snapshot()["device.host_answer.capacity"] == before + 1
    same_batches(got, oracle_shards(KAFKA, datums, 8))
    assert one_card == []

    raising(BatchTooLarge(64, 1 << 31))
    got = port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu")
    same_batches(got, oracle_shards(KAFKA, datums, 8))
    assert one_card == [64]


def test_fan_out_telemetry():
    """One ``device.pipeline_s`` span with ``shards=D`` over the pack,
    the copies (one ``decode.shard_pack_s`` per shard), one launch per
    rung of kind ``decode.sharded`` and the blob copies; the launch
    registry per kernel kind under the ``D{D},…`` bucket; the sharded
    decoder kept by ``track_holder``."""
    telemetry.reset()
    entry = get_or_parse_schema(KAFKA)
    datums = datagen.kafka_style_datums(48, seed=5)
    datums[9] = b"\x01"
    sd = ShardedDecoder(entry.ir, devices=[CPU] * 4)
    assert sd in device_obs.holders()
    with telemetry.root_span("test.fan_out"):
        with pytest.raises(MalformedAvro, match="record 9"):
            sd.decode(datums, entry.ir, entry.arrow_schema)
        sd.decode(datums[10:], entry.ir, entry.arrow_schema)
    root = telemetry.snapshot()["spans"][-1]
    pipes = [c for c in root["children"]
             if c["name"] == "device.pipeline_s"]
    assert len(pipes) == 2
    for pipe in pipes:
        assert pipe["attrs"]["shards"] == 4
        assert pipe["attrs"]["op"] == "decode"
        names = [c["name"] for c in pipe["children"]]
        # the first call seeds the caps from a host sample between them
        assert [n for n in names if n != "device.seed_s"][:2] == \
            ["decode.pack_s", "decode.h2d_s"]
        h2d = pipe["children"][names.index("decode.h2d_s")]
        assert [c["name"] for c in h2d["children"]] == \
            ["decode.shard_pack_s"] * 4
        assert [c["attrs"]["shard"] for c in h2d["children"]] == \
            [0, 1, 2, 3]
        assert "decode.d2h_s" in names
        launches = [c for c in pipe["children"] if c["name"] in
                    ("device.compile_s", "device.launch_s")]
        assert launches and all(c["attrs"]["kind"] == "decode.sharded"
                                and c["attrs"]["bucket"].startswith("D4,")
                                for c in launches)
    errs = [c for c in pipes[0]["children"]
            if c["name"] == "decode.shard_err_s"]
    assert [c["attrs"]["shard"] for c in errs] == [0]
    rows = telemetry.snapshot()["device"]["jit_cache"]
    assert {r["kind"] for r in rows.values()
            if r["bucket"].startswith("D4,")} == {"walk", "finalize"}


# -- every launch on its tensors' card ------------------------------------------------


class _OnCard:
    """A stand-in for a tensor on a card: its device, pointer 0."""

    def __init__(self, device, n: int = 16):
        self.device = torch.device(device)
        self.shape = (n,)
        self._n = n

    def data_ptr(self):
        return 0

    def numel(self):
        return self._n


def test_every_launch_and_query_runs_on_its_tensors_card(monkeypatch):
    """Each kernel entry point and occupancy query of K1, K2, K4 and K3
    is called with the CUDA runtime's current device set to the card of
    the tensors it is given (``cuda:1`` here); the occupancy budgets are
    kept per card."""
    import types

    import numpy as np

    from pyruhvro_tpu_torch.ops import decode as dm
    from pyruhvro_tpu_torch.ops import encode as em
    from pyruhvro_tpu_torch.ops import walk_decode as wd

    current = []

    class on_device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            current.append(None if self.device is None
                           else torch.device(self.device))

        def __exit__(self, *exc):
            current.pop()

    calls = []

    def entry(name, rc=0):
        def fn(*args):
            calls.append((name, current[-1] if current else None))
            return rc
        return fn

    lib = types.SimpleNamespace(cdll=types.SimpleNamespace(
        decode_walk=entry("decode_walk"),
        decode_walk_smem_bytes=lambda *a: 1024,
        decode_walk_blocks_per_sm=entry("decode_walk_blocks_per_sm", 8),
        decode_finalize_run=entry("decode_finalize_run"),
        walk_decode=entry("walk_decode"),
        encode_rows=entry("encode_rows"),
        encode_strings=entry("encode_strings"),
        encode_rows_smem_bytes=lambda *a: 1024,
        encode_rows_blocks_per_sm=entry("encode_rows_blocks_per_sm", 8)))
    monkeypatch.setattr(torch.cuda, "device", on_device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    walk_k, fin_k = dm._DecodeWalkKernel(), dm._FinalizeKernel()
    enc_k = em._EncodeKernel()
    for k in (walk_k, fin_k, wd.walk_kernel, enc_k):
        monkeypatch.setattr(k, "library", lambda: lib)
    card = "cuda:1"
    t = _OnCard(card)
    prog = types.SimpleNamespace(code=[0] * 4, depth=1, out_keys=["a"],
                                 regions=["", "r"], lanes=[0] * 3)
    walk_k.launch(types.SimpleNamespace(
        words=t, starts=t, lengths=t, n=4, R=8, table=t, prog=prog,
        bufs=[t], n_regions=2, stack=1, n_keys=1, in_budget=0, fold=0,
        status=t, log=t, log_cap=1, err=t, reset=lambda: None))
    assert walk_k.budget(prog, 1, None, torch.device(card)) > 0
    n_queries = len(calls)
    walk_k.budget(prog, 1, None, torch.device(card))
    assert len(calls) == n_queries  # kept for this card
    walk_k.budget(prog, 1, None, torch.device("cuda:2"))
    assert calls[-1] == ("decode_walk_blocks_per_sm", torch.device("cuda:2"))
    calls[n_queries:] = []
    plan = types.SimpleNamespace(
        dev=torch.device(card), blob=t, scratch=t, ptrs=np.zeros(2, np.int64),
        cache=None, tables=types.SimpleNamespace(
            tab_ptr=0, plan_ptr=0, launches=2, spec=(8, ()), stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    fin_k.run(plan)
    wd.walk_kernel.launch(types.SimpleNamespace(
        flat=t, offs=t, act=t, base=t, BW=4, table=t, prog=prog, bufs=[t],
        n_regions=2, ptrs=t, tile_r=128, fixed_upto=0, in_budget=0,
        out_bytes=0, span_max=t, in_mask=t, cut=t, err=t))
    L = types.SimpleNamespace(
        buf=t, prog=prog, n=4, R=8, cols=[], n_windows=1,
        code_view=lambda: t, lanes_view=lambda: t, cols_view=lambda: t)
    enc_k.launch_rows(L, True, t, t, t)
    enc_k.launch_strings(L, t)
    names = [name for name, _dev in calls]
    queries = names.count("decode_walk_blocks_per_sm")
    assert names == ["decode_walk"] + ["decode_walk_blocks_per_sm"] * \
        queries + ["decode_finalize_run", "walk_decode"] + ["encode_rows_blocks_per_sm"] * \
        names.count("encode_rows_blocks_per_sm") + ["encode_rows",
                                                    "encode_strings"]
    assert queries and {dev for _name, dev in calls} == \
        {torch.device(card)}, calls


def test_fan_out_keeps_the_call_contract(kafka, fan_out, monkeypatch):
    """``timeout_s``, ``trace_ctx`` and ``backend="auto"`` behave on the
    fan-out as on one card: the deadline is checked at every rung (0
    raises before any shard is packed), the root span joins the caller's
    trace, and ``"auto"`` keeps a device call on the fan-out."""
    from pyruhvro_tpu_torch import DeadlineExceeded
    from pyruhvro_tpu_torch.parallel import sharded

    _fan, datums = kafka
    datums = datums[:64]
    sites = []
    real_check = sharded.deadline.check

    def spy(index=None, site=None):
        sites.append(site)
        return real_check(index=index, site=site)

    monkeypatch.setattr(sharded.deadline, "check", spy)
    with pytest.raises(DeadlineExceeded):
        port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu",
                                        timeout_s=0)
    assert fan_out["shards"] == [] and sites == ["call_start"]
    sites.clear()
    telemetry.reset()
    tp = "00-" + "4b" * 16 + "-" + "a1" * 8 + "-01"
    got = port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu",
                                          timeout_s=600, trace_ctx=tp)
    assert sites.count("device.capacity_ladder") == 1  # one rung
    assert len(fan_out["shards"]) == 1
    root = telemetry.snapshot()["spans"][-1]
    assert root["trace_id"] == "4b" * 16
    assert any(c["name"] == "device.pipeline_s" and
               c["attrs"].get("shards") == 8 for c in root["children"])
    monkeypatch.setenv("PYRUHVRO_TPU_DEVICE_MIN_ROWS", "0")
    auto = port.deserialize_array_threaded(datums, KAFKA, 8, device="cpu",
                                           backend="auto")
    assert len(fan_out["shards"]) == 2
    same_batches(auto, got)
    same_batches(got, oracle_shards(KAFKA, datums, 8))
