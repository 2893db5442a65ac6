"""The port's memory accounting and cache lifecycle
(``pyruhvro_tpu_torch/runtime/memacct.py`` and ``cachelife.py``, copies of
the reference's, with the schema cache's lifecycle, the launch-state and
arena planes of ``runtime/device_obs.py`` and ``tenant=`` on the API)
held against the reference on the CPU.

* **Lifecycle.** The same schema-cache calls give the reference's live
  entries, eviction order and counters under the LRU cap, the TTL and a
  pressure relief; ``cachelife``'s eviction order over the same managed
  caches is the reference's.
* **Rebuilds.** A decode and an encode after a schema, bucket or arena
  eviction are bit-equal to the same calls in the reference (its device
  tier on JAX's CPU), and the next launch of an evicted bucket is a first
  launch again. An arena whose copy or launch is in flight is never
  evicted.
* **Attribution.** ``tenant=`` on the five functions; the space-saving
  sketch, fed the same calls, equals the reference's; ``render_mem_report``
  of the same documents equals the reference's.
* **Surfaces.** ``mem-report`` and ``knobs`` with the exit-2 contract,
  ``/memory`` live and static, pressure marking ``/healthz``, and no
  probe or scrape calling into CUDA.
* **Races.** The reference's collect-vs-reset and memo-vs-evict races
  replayed on the port's ``schedtest`` with its committed seeds.
"""

import json
import random
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.runtime import cachelife as ref_cachelife  # noqa: E402
from pyruhvro_tpu.runtime import memacct as ref_memacct  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402
from pyruhvro_tpu.schema import cache as ref_cache  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.ops import decode as dm  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    cachelife,
    device_obs,
    memacct,
    metrics,
    obs_server,
    schedtest,
    telemetry,
)
from pyruhvro_tpu_torch.schema import cache as scache  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

KAFKA = datagen.KAFKA_SCHEMA_JSON
# a small schema of its own (a string, an array of strings, a nullable
# double), so the reference's XLA CPU compiles stay short and no other
# file's decoders are shared
SMALL = json.dumps({"type": "record", "name": "MemAcct", "fields": [
    {"name": "id", "type": "long"},
    {"name": "name", "type": "string"},
    {"name": "tags", "type": {"type": "array", "items": "string"}},
    {"name": "score", "type": ["null", "double"]}]})
ROWS = 150
CHUNKS = 4
# the reference's committed repro seeds (tests/test_concurrency.py:36-38)
MEMACCT_RACE_SEED = 6
MEMO_EVICT_RACE_SEED = 6
SWEEP = 12

KNOBS = ("PYRUHVRO_TPU_MEM_HIGH_WATER", "PYRUHVRO_TPU_CACHE_TTL_S",
         "PYRUHVRO_TPU_CACHE_MAX_SCHEMAS", "PYRUHVRO_TPU_MEM_TOPK",
         "PYRUHVRO_TPU_CACHE_MAX_EXECUTABLES")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    # the overlapped path at test sizes: the arenas take two slots
    monkeypatch.setenv("PYRUHVRO_TPU_OVERLAP_ROWS", "32")
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def small():
    """The rows, and the reference's device-tier decode (per chunk) and
    encode of them on JAX's CPU, computed once."""
    data = datagen.random_datums(parse_schema(SMALL), ROWS, seed=11)
    want = ref.deserialize_array_threaded(data, SMALL, CHUNKS,
                                          backend="tpu")
    batch = ref.deserialize_array(data, SMALL, backend="host")
    wire = ref.serialize_record_batch(batch, SMALL, 2, backend="tpu")
    return data, want, batch, wire


def _schema(i: int) -> str:
    return json.dumps({"type": "record", "name": f"Mem{i}",
                       "fields": [{"name": "a", "type": "long"},
                                  {"name": "b", "type": "string"}]})


def _live(cache_mod):
    return {json.loads(k)["name"] for k in cache_mod._cache}


def _both_caches():
    """The two schema caches, emptied, with their counters."""
    scache.clear_schema_cache()
    ref_cache.clear_schema_cache()
    return ((scache, metrics, cachelife), (ref_cache, ref_metrics,
                                           ref_cachelife))


def _port_calls(data, batch):
    """The port's decode (chunked) and encode, on the CPU."""
    got = port.deserialize_array_threaded(data, SMALL, CHUNKS, device="cpu")
    wire = port.serialize_record_batch(batch, SMALL, 2, device="cpu")
    return got, wire


def _same(got, want):
    got_batches, got_wire = got
    want_batches, want_wire = want
    assert len(got_batches) == len(want_batches)
    for g, w in zip(got_batches, want_batches):
        assert g.equals(w)
        assert g.to_pylist() == w.to_pylist()
    assert [a.to_pylist() for a in got_wire] == \
        [a.to_pylist() for a in want_wire]


# -- the snapshot's memory section and its gauges ------------------------------


def test_snapshot_carries_gauges_and_memory_section():
    port.deserialize_array(datagen.kafka_style_datums(50, seed=3), KAFKA,
                           backend="host")
    snap = telemetry.snapshot()
    assert snap["schema_version"] == telemetry.SNAPSHOT_SCHEMA_VERSION
    mem = snap["memory"]
    assert mem["rss_bytes"] > 0 and mem["tracked_bytes"] > 0
    assert mem["caches"]["cache.schema"]["items"] >= 1
    assert set(mem["lifecycle"]) >= {"schema", "executables", "arenas"}
    g = snap["gauges"]
    assert g["mem.rss_bytes"] == mem["rss_bytes"]
    assert g["mem.cache.schema.bytes"] > 0
    assert g["mem.tracked_bytes"] == mem["tracked_bytes"]
    prom = telemetry.prometheus(snap)
    assert "# TYPE pyruhvro_tpu_mem_rss_bytes gauge" in prom


def test_legacy_snapshot_renders_unchanged():
    snap = {"schema_version": 2, "counters": {"a.b": 1.0},
            "histograms": {}, "spans": []}
    assert "gauge" not in telemetry.prometheus(snap)
    assert telemetry.render_report(snap)
    assert memacct.render_mem_report(snap) == \
        ref_memacct.render_mem_report(snap)
    assert "predates" in memacct.render_mem_report(snap)


# -- the schema cache's lifecycle against the reference's -----------------------


def test_schema_lru_admission_cap(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_CACHE_MAX_SCHEMAS", "4")
    out = []
    for cache_mod, mets, _life in _both_caches():
        before = mets.snapshot()
        for i in range(9):
            cache_mod.get_or_parse_schema(_schema(i))
        c = mets.snapshot()
        out.append((_live(cache_mod),
                    c["cache.evict.schema.lru"]
                    - before.get("cache.evict.schema.lru", 0),
                    c["schema_cache.evictions"]
                    - before.get("schema_cache.evictions", 0)))
    assert out[0] == out[1] == ({"Mem5", "Mem6", "Mem7", "Mem8"}, 5, 5)


def test_schema_lru_evicts_least_recently_used(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_CACHE_MAX_SCHEMAS", "2")
    lives = []
    for cache_mod, _mets, _life in _both_caches():
        cache_mod.get_or_parse_schema(_schema(0))
        cache_mod.get_or_parse_schema(_schema(1))
        cache_mod.get_or_parse_schema(_schema(0))  # refresh 0's clock
        cache_mod.get_or_parse_schema(_schema(2))  # evicts 1, not 0
        lives.append(_live(cache_mod))
    assert lives[0] == lives[1] == {"Mem0", "Mem2"}


def test_schema_ttl_eviction(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_CACHE_TTL_S", "0.01")
    for cache_mod, mets, life in _both_caches():
        cache_mod.get_or_parse_schema(_schema(0))
        life.sweep(time.monotonic())
        assert len(cache_mod._cache) == 1
        time.sleep(0.03)
        life.sweep(time.monotonic())
        assert len(cache_mod._cache) == 0
        assert mets.snapshot()["cache.evict.schema.ttl"] >= 1


def test_ttl_off_by_default():
    for cache_mod, _mets, life in _both_caches():
        cache_mod.get_or_parse_schema(_schema(0))
        time.sleep(0.01)
        assert life.sweep(time.monotonic()) == 0
        assert len(cache_mod._cache) == 1


def test_hit_miss_evict_counters_reconcile(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_CACHE_MAX_SCHEMAS", "3")
    out = []
    for cache_mod, mets, _life in _both_caches():
        before = mets.snapshot()
        for i in range(6):
            for _ in range(2):
                cache_mod.get_or_parse_schema(_schema(i))
        c = mets.snapshot()
        d = {k: c.get(k, 0) - before.get(k, 0)
             for k in ("schema_cache.hits", "schema_cache.misses",
                       "schema_cache.evictions", "cache.evict.schema.lru")}
        assert d["schema_cache.hits"] + d["schema_cache.misses"] == 12
        assert len(cache_mod._cache) == \
            d["schema_cache.misses"] - d["schema_cache.evictions"]
        out.append(d)
    assert out[0] == out[1]


def test_footprint_counts_the_codecs_programs(small):
    data, _want, batch, _wire = small
    scache.clear_schema_cache()
    entry = scache.get_or_parse_schema(SMALL)
    bare = entry.footprint_bytes()
    assert bare == len(SMALL) * 4 + 512
    port.deserialize_array(data, SMALL, device="cpu")
    codec = next(v for k, v in entry._extras.items()
                 if k.startswith("device_codec"))
    built = entry.footprint_bytes()
    assert built >= bare + 128 + codec.decoder.prog.code.nbytes
    port.serialize_record_batch(batch, SMALL, 1, device="cpu")
    # memoized: the encoder built inside the codec lands no extra
    assert entry.footprint_bytes() == built
    entry._fpb = None
    assert entry.footprint_bytes() == built + \
        codec._encoder.prog.code.nbytes
    port.deserialize_array(data, SMALL, backend="host")
    host = entry._extras["native_host_codec"]
    assert entry.footprint_bytes() >= built + 128 + \
        codec._encoder.prog.code.nbytes + host.prog.ops.nbytes + \
        host.prog.coltypes.nbytes


# -- cachelife's eviction order against the reference's ------------------------


class _Fake:
    """A managed cache of fixed entries whose evictions are logged."""

    def __init__(self, name, ents, cap=0):
        self.name, self.ents, self.cap, self.log = name, dict(ents), cap, []

    def entries(self):
        return [(k, ts, b) for k, (ts, b) in self.ents.items()]

    def evict(self, key):
        self.log.append(key)
        return self.ents.pop(key, None) is not None


def _fakes(life, now):
    a = _Fake("fake_a", {f"a{i}": (now - 100 + i * 7, 1000 + i)
                         for i in range(6)}, cap=3)
    b = _Fake("fake_b", {f"b{i}": (now - 98 + i * 5, 2000) for i in range(5)})
    for f in (a, b):
        life.register(f.name, entries=f.entries, evict=f.evict,
                      capacity=(lambda f=f: f.cap))
    return a, b


def _run_lifecycle(life, mets, monkeypatch, now):
    with life._lock:
        saved = dict(life._caches)
        life._caches.clear()
    try:
        a, b = _fakes(life, now)
        admitted = life.admit("fake_a")
        monkeypatch.setenv("PYRUHVRO_TPU_CACHE_TTL_S", "90")
        swept = life.sweep(now)
        monkeypatch.delenv("PYRUHVRO_TPU_CACHE_TTL_S")
        relieved = life.relieve(3000)
        summary = life.snapshot_lifecycle()
        c = mets.snapshot()
        return (admitted, swept, relieved, a.log, b.log, summary,
                {k: v for k, v in c.items() if k.startswith("cache.")})
    finally:
        with life._lock:
            life._caches.clear()
            life._caches.update(saved)


def test_cachelife_eviction_order_matches_reference(monkeypatch):
    now = time.monotonic()
    got = _run_lifecycle(cachelife, metrics, monkeypatch, now)
    ref_metrics.reset()
    want = _run_lifecycle(ref_cachelife, ref_metrics, monkeypatch, now)
    assert got == want
    admitted, swept, relieved, log_a, log_b, _s, counts = got
    assert (admitted, log_a[:3]) == (3, ["a0", "a1", "a2"])
    assert counts["cache.evict.fake_a.lru"] == 3


def test_a_raising_hook_is_counted_and_skipped():
    with cachelife._lock:
        saved = dict(cachelife._caches)
    try:
        cachelife.register("broken", entries=lambda: 1 / 0,
                           evict=lambda k: True, capacity=lambda: 1)
        assert cachelife.admit("broken") == 0
        assert cachelife.snapshot_lifecycle()["broken"] == {
            "entries": 0, "bytes": 0, "capacity": 1}
        assert metrics.snapshot()["cache.hook_error"] >= 2
    finally:
        with cachelife._lock:
            cachelife._caches.clear()
            cachelife._caches.update(saved)


# -- decode and encode after each kind of eviction -------------------------------


def test_schema_eviction_rebuild_bit_identical(small):
    data, want, batch, wire = small
    _same(_port_calls(data, batch), (want, wire))
    misses0 = metrics.snapshot().get("schema_cache.misses", 0)
    for key in list(scache._cache):
        assert scache._evict(key)
    _same(_port_calls(data, batch), (want, wire))
    assert metrics.snapshot()["schema_cache.misses"] == misses0 + 1
    assert metrics.snapshot()["schema_cache.evictions"] >= 1


def test_bucket_eviction_relaunches_and_matches(small):
    data, want, batch, wire = small
    _same(_port_calls(data, batch), (want, wire))
    mem = memacct.snapshot_memory()
    assert mem["caches"]["cache.executables"]["items"] >= 1
    fp = scache.get_or_parse_schema(SMALL).fingerprint
    mine = [e for e in device_obs._exe_entries() if e[0].startswith(fp)]
    kinds = {k.split("|")[1] for k, _t, _b in mine}
    assert {"walk", "finalize", "encode_plain"} <= kinds
    before = metrics.snapshot()
    for key, _ts, _b in mine:
        device_obs._evict_executable(key)
    assert not [e for e in device_obs._exe_entries()
                if e[0].startswith(fp)]
    codec = next(v for k, v in scache.get_or_parse_schema(
        SMALL)._extras.items() if k.startswith("device_codec"))
    assert not codec.decoder._launched and not codec._encoder._launched
    _same(_port_calls(data, batch), (want, wire))
    c = metrics.snapshot()
    # every evicted bucket launched as a first launch again: misses
    # still equal first launches
    assert c["device.jit_cache.evictions"] - before.get(
        "device.jit_cache.evictions", 0) == len(
        {(k.split("|")[0], k.split("|")[2]) for k, _t, _b in mine})
    for key in ("device.jit_cache.misses", "decode.compiles",
                "encode.compiles"):
        assert c[key] > before.get(key, 0), key
    # the learned caps stay
    assert codec.decoder._planned


def test_arena_eviction_rebuild_parity(small):
    data, want, batch, wire = small
    _same(_port_calls(data, batch), (want, wire))
    ents = device_obs._arena_entries()
    assert ents and all(b > 0 and ts > 0 for _k, ts, b in ents)
    probe = memacct.collect(force=True)["cache.arenas"]
    assert probe["bytes"] == sum(b for _k, _t, b in ents)
    assert probe["device_bytes"] == 0  # the CPU twin is the host tensor
    for key, _ts, _b in ents:
        assert device_obs._evict_arena(key)
    assert not device_obs._arena_entries()
    misses0 = metrics.snapshot().get("device.arena.misses", 0)
    _same(_port_calls(data, batch), (want, wire))
    c = metrics.snapshot()
    assert c["device.arena.misses"] > misses0
    assert c["device.arena.evictions"] >= len(ents)


class _Busy:
    def query(self):
        return False


def test_an_arena_in_flight_is_not_evicted(small):
    data, _want, batch, _wire = small
    _port_calls(data, batch)
    [(key, _ts, _b), *_rest] = device_obs._arena_entries()
    holder = next(h for h in device_obs.holders() if id(h) == key[0])
    arena = holder._arenas[key[1]]
    for attr in ("copied", "consumed"):
        setattr(arena, attr, _Busy())
        assert not device_obs._evict_arena(key)
        assert holder._arenas[key[1]] is arena
        setattr(arena, attr, None)
    assert metrics.snapshot()["device.arena.evict_busy"] == 2
    assert device_obs._evict_arena(key)


def test_checkout_stamps_last_used():
    dec = dm.DeviceDecoder(parse_schema(SMALL), "cpu")
    a = dec._arena(64, 256)
    t0 = a.last_used
    time.sleep(0.01)
    assert dec._arena(64, 256) is a and a.last_used > t0
    assert dec in device_obs.holders()


def test_executable_cap_admits_lru(monkeypatch, small):
    data, _want, batch, _wire = small
    monkeypatch.setenv("PYRUHVRO_TPU_CACHE_MAX_EXECUTABLES", "2")
    # a fresh codec: admission runs at first launches, as in the reference
    scache.clear_schema_cache()
    _port_calls(data, batch)
    assert len(device_obs._exe_entries()) <= 2
    assert metrics.snapshot()["cache.evict.executables.lru"] >= 1


# -- pressure ----------------------------------------------------------------------


def test_pressure_eviction_and_health_bit(monkeypatch):
    scache.clear_schema_cache()
    scache.get_or_parse_schema(_schema(0))
    scache.get_or_parse_schema(_schema(1))
    monkeypatch.setenv("PYRUHVRO_TPU_MEM_HIGH_WATER", "1")  # always over
    memacct.force_pressure_check()
    c = metrics.snapshot()
    assert c["mem.pressure"] == 1
    assert c["cache.evict.schema.pressure"] >= 1
    # no CUDA in this process: the allocators are not touched
    assert "mem.allocator_release" not in c
    assert metrics.mark_age("mem_pressure") is not None
    code, body = obs_server.health()
    assert code == 503
    assert body["unhealthy_bits"]["mem_pressure"] is True


def test_pressure_inside_a_call_annotates_its_root_span(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_MEM_HIGH_WATER", "1")
    memacct.reset()  # the tick is throttled: arm it
    port.deserialize_array(datagen.kafka_style_datums(10, seed=1), KAFKA,
                           device="cpu", tenant="hot")
    root = telemetry.snapshot()["spans"][-1]
    assert root["attrs"]["mem_pressure"] is True
    assert root["attrs"]["tenant"] == "hot"


def test_no_pressure_without_high_water():
    scache.clear_schema_cache()
    scache.get_or_parse_schema(_schema(0))
    memacct.force_pressure_check()
    assert "mem.pressure" not in metrics.snapshot()
    assert len(scache._cache) == 1


def test_pressure_annotates_snapshot_state(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_MEM_HIGH_WATER", "1")
    snap = memacct.snapshot_memory()
    assert snap["high_water_bytes"] == 1
    assert snap["over_high_water"] is True


def test_relieve_frees_requested_overage():
    scache.clear_schema_cache()
    for i in range(6):
        scache.get_or_parse_schema(_schema(i))
    per_entry = scache._lifecycle_entries()[0][2]
    evicted, freed = cachelife.relieve(per_entry + 1)
    assert evicted >= 1 and freed >= per_entry + 1
    assert len(scache._cache) >= 4


def test_no_probe_or_scrape_calls_into_cuda(monkeypatch, small):
    data, _want, batch, _wire = small
    _port_calls(data, batch)

    def forbidden(*a, **k):
        raise AssertionError("a probe called into CUDA")

    for name in ("memory_stats", "mem_get_info", "empty_cache",
                 "current_device", "memory_allocated", "synchronize",
                 "init"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    assert not torch.cuda.is_initialized()
    telemetry.snapshot()
    memacct.collect(force=True)
    monkeypatch.setenv("PYRUHVRO_TPU_MEM_HIGH_WATER", "1")
    memacct.force_pressure_check()
    assert not device_obs.release_allocator_caches()
    srv = obs_server.ObsServer(port=0).start()
    try:
        with urllib.request.urlopen(f"{srv.url}/memory", timeout=5) as r:
            assert json.loads(r.read())["rss_bytes"] > 0
    finally:
        srv.stop()
    assert "mem.probe_error" not in metrics.snapshot()
    assert not torch.cuda.is_initialized()


# -- tenants and the sketch ----------------------------------------------------------


def test_tenant_attribution_lands_in_sketch_and_span():
    data = datagen.kafka_style_datums(40, seed=9)
    sketches = []
    for mod, mm, kw in ((port, memacct, {"device": "cpu"}),
                        (ref, ref_memacct, {"backend": "host"})):
        mm.reset()
        mod.deserialize_array(data, KAFKA, tenant="acme", **kw)
        mod.deserialize_array(data, KAFKA, tenant="acme", **kw)
        mod.deserialize_array(data, KAFKA, **kw)
        sketches.append(mm._sketch.snapshot())
    assert sketches[0] == sketches[1]
    rows = {(r["tenant"], r["schema"]): r for r in sketches[0]}
    fp = scache.get_or_parse_schema(KAFKA).fingerprint
    assert rows[("acme", fp)]["calls"] == 2
    assert rows[("acme", fp)]["rows"] == 80
    assert rows[("-", fp)]["calls"] == 1
    spans = [s for s in telemetry.snapshot()["spans"]
             if s["attrs"].get("tenant") == "acme"]
    assert len(spans) == 2


@pytest.mark.parametrize("backend", ["device", "host"])
def test_tenant_kwarg_on_every_api_function(backend):
    data = datagen.kafka_style_datums(20, seed=10)
    kw = {"backend": backend, "device": "cpu"}
    port.deserialize_array(data, KAFKA, **kw)
    # one batch object encoded in both packages: the sketch's bytes of
    # an encode are the batch's nbytes
    batch = ref.deserialize_array(data, KAFKA, backend="host")
    port.deserialize_array_threaded(data, KAFKA, 2, tenant="t1", **kw)
    port.deserialize_array_threaded_spawn(data, KAFKA, 2, tenant="t1", **kw)
    port.serialize_record_batch(batch, KAFKA, 1, tenant="t1", **kw)
    port.serialize_record_batch_spawn(batch, KAFKA, 1, tenant="t1", **kw)
    port.deserialize_array(data, KAFKA, tenant="t1", **kw)
    rows = {r["tenant"]: r for r in memacct.snapshot_memory()["tenants"]}
    assert rows["t1"]["calls"] == 5
    assert rows["t1"]["decode_calls"] == 3
    assert rows["t1"]["encode_calls"] == 2
    ref_memacct.reset()
    rbatch = ref.deserialize_array(data, KAFKA, backend="host")
    assert rbatch.equals(batch)
    rbatch = batch
    ref.deserialize_array_threaded(data, KAFKA, 2, backend="host",
                                   tenant="t1")
    ref.deserialize_array_threaded_spawn(data, KAFKA, 2, backend="host",
                                         tenant="t1")
    ref.serialize_record_batch(rbatch, KAFKA, 1, backend="host",
                               tenant="t1")
    ref.serialize_record_batch_spawn(rbatch, KAFKA, 1, backend="host",
                                     tenant="t1")
    ref.deserialize_array(data, KAFKA, backend="host", tenant="t1")
    assert memacct._sketch.snapshot() == ref_memacct._sketch.snapshot()


def test_sketch_is_bounded_topk(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_MEM_TOPK", "4")
    out = []
    for mm in (memacct, ref_memacct):
        mm.reset()
        for i in range(12):
            mm.attribute(f"tenant{i}", "fp", "decode", 10, [b"x" * 8])
        for _ in range(5):
            mm.attribute("whale", "fp", "decode", 1000, [b"x" * 4096])
        out.append(mm._sketch.snapshot())
    assert out[0] == out[1]
    assert len(out[0]) <= 4 and out[0][0]["tenant"] == "whale"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_space_saving_matches_reference_on_a_random_stream(monkeypatch,
                                                           seed):
    monkeypatch.setenv("PYRUHVRO_TPU_MEM_TOPK", "8")
    rng = random.Random(seed)
    stream = [(f"t{int(rng.paretovariate(1.2)) % 30}",
               f"s{rng.randrange(4)}", rng.choice(["decode", "encode"]),
               rng.randrange(1, 500),
               [b"y" * rng.randrange(1, 200)] * rng.randrange(1, 90))
              for _ in range(400)]
    a, b = memacct._SpaceSaving(), ref_memacct._SpaceSaving()
    for tenant, schema, op, rows, payload in stream:
        nbytes = memacct._approx_bytes(payload)
        assert nbytes == ref_memacct._approx_bytes(payload)
        a.note(tenant, schema, op, rows, nbytes)
        b.note(tenant, schema, op, rows, nbytes)
    assert a.snapshot() == b.snapshot()
    assert len(a.snapshot()) == 8


def test_approx_bytes_of_each_input_kind():
    import pyarrow as pa

    data = datagen.kafka_style_datums(100, seed=2)
    arr = pa.array(data, pa.binary())
    from pyruhvro_tpu.runtime.ingest import as_datum_input as ref_ingest
    from pyruhvro_tpu_torch.runtime.ingest import as_datum_input

    assert memacct._approx_bytes(as_datum_input(arr)) == \
        ref_memacct._approx_bytes(ref_ingest(arr)) == sum(map(len, data))
    # read off the end offsets: sliced, large and empty views too
    for view in (arr.slice(7, 50), arr.slice(99), arr.slice(3, 0),
                 pa.array(data, pa.large_binary()).slice(5, 60),
                 pa.array([], pa.binary())):
        assert memacct._approx_bytes(as_datum_input(view)) == \
            ref_memacct._approx_bytes(ref_ingest(view)) == \
            sum(len(d) for d in view.to_pylist())
    batch = port.deserialize_array(data, KAFKA, backend="host")
    for payload in (data, batch, None, []):
        assert memacct._approx_bytes(payload) == \
            ref_memacct._approx_bytes(payload)


# -- mem-report, knobs, /memory ------------------------------------------------------


def test_mem_report_equals_the_reference_on_the_same_documents():
    data = datagen.kafka_style_datums(60, seed=11)
    port.deserialize_array(data, KAFKA, device="cpu", tenant="cli-tenant")
    metrics.inc("cache.evict.schema.lru", 2)
    metrics.inc("cache.evict.arenas.pressure")
    mine = json.loads(json.dumps(telemetry.snapshot(), default=str))
    ref.deserialize_array(data, KAFKA, backend="host", tenant="r")
    theirs = json.loads(json.dumps(ref.telemetry.snapshot(), default=str))
    for doc in (mine, theirs):
        assert memacct.render_mem_report(doc) == \
            ref_memacct.render_mem_report(doc)
    text = memacct.render_mem_report(mine)
    assert "cache.arenas" in text and "cli-tenant" in text
    # the card's reserved bytes, which only the port records, render
    # after the reference's line
    mine["memory"]["devices"] = {"cuda:0": {
        "bytes_in_use": 10, "peak_bytes_in_use": 20,
        "bytes_reserved": 2048}}
    line = [x for x in memacct.render_mem_report(mine).splitlines()
            if x.startswith("device[")][0]
    assert line == "device[cuda:0]: in use 10 B, peak 20 B, reserved 2.0 kB"


def test_mem_report_cli_renders_snapshot(tmp_path, capsys):
    port.deserialize_array(datagen.kafka_style_datums(60, seed=11), KAFKA,
                           device="cpu", tenant="cli-tenant")
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(telemetry.snapshot(), default=str))
    assert telemetry.main(["mem-report", str(path)]) == 0
    out = capsys.readouterr().out
    assert "== memory ==" in out and "cache.schema" in out
    assert "cli-tenant" in out
    assert telemetry.main(["report", str(path)]) == 0
    assert "render with the mem-report subcommand" in \
        capsys.readouterr().out


def test_mem_report_cli_exit2_contract(tmp_path, capsys):
    assert telemetry.main(["mem-report", str(tmp_path / "nope.json")]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    assert telemetry.main(["mem-report", str(bad)]) == 2
    notsnap = tmp_path / "notsnap.json"
    notsnap.write_text('{"foo": 1}')
    assert telemetry.main(["mem-report", str(notsnap)]) == 2
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    assert telemetry.main(["mem-report", str(garbage)]) == 2
    capsys.readouterr()


def test_knobs_cli_lists_the_registry(monkeypatch, capsys):
    monkeypatch.setenv("PYRUHVRO_TPU_MEM_HIGH_WATER", "123")
    assert telemetry.main(["knobs"]) == 0
    out = capsys.readouterr().out
    assert "PYRUHVRO_TPU_MEM_HIGH_WATER  [int, default 0]  (set: '123')" \
        in out
    assert telemetry.main(["knobs", "--markdown"]) == 0
    md = capsys.readouterr().out
    assert "| `PYRUHVRO_TPU_CACHE_TTL_S` | float | `0.0` |" in md
    from pyruhvro_tpu.runtime import knobs as ref_knobs
    from pyruhvro_tpu_torch.runtime import knobs

    theirs = ref_knobs.registry()
    for name in ("PYRUHVRO_TPU_MEM_HIGH_WATER", "PYRUHVRO_TPU_CACHE_TTL_S",
                 "PYRUHVRO_TPU_CACHE_MAX_SCHEMAS",
                 "PYRUHVRO_TPU_CACHE_MAX_EXECUTABLES",
                 "PYRUHVRO_TPU_MEM_TOPK", "PYRUHVRO_TPU_OTLP_ENDPOINT",
                 "PYRUHVRO_TPU_OTLP_INTERVAL_S"):
        assert knobs.DEFAULTS[name] == theirs[name].default
    assert "PYRUHVRO_TPU_CACHE_MAX_ENGINES" not in knobs.DEFAULTS
    with pytest.raises(SystemExit) as e:
        telemetry.main(["knobs", "--bogus"])
    assert e.value.code == 2
    capsys.readouterr()


def test_memory_endpoint_live(monkeypatch):
    port.deserialize_array(datagen.kafka_style_datums(30, seed=12), KAFKA,
                           backend="host", tenant="live")
    # one probe walk serves both reads (the memo does not age out)
    monkeypatch.setattr(memacct, "_COLLECT_TTL_S", 1e9)
    srv = obs_server.ObsServer(port=0).start()
    try:
        with urllib.request.urlopen(f"{srv.url}/memory", timeout=5) as r:
            doc = json.loads(r.read())
        assert doc["rss_bytes"] > 0 and "cache.schema" in doc["caches"]
        # the scrape is the snapshot's section on the same state (the
        # peak RSS is read anew by each)
        mem = json.loads(json.dumps(memacct.snapshot_memory()))
        assert doc.pop("peak_rss_bytes") <= mem.pop("peak_rss_bytes")
        assert doc == mem
        assert doc["tenants"][0]["tenant"] == "live"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.url}/nope", timeout=5)
        assert "/memory" in json.loads(e.value.read())["endpoints"]
    finally:
        srv.stop()


def test_memory_endpoint_static_snapshot():
    port.deserialize_array(datagen.kafka_style_datums(30, seed=13), KAFKA,
                           backend="host")
    snap = json.loads(json.dumps(telemetry.snapshot(), default=str))
    legacy = {k: v for k, v in snap.items() if k != "memory"}
    for doc, check in ((snap, lambda m: m == snap["memory"]),
                       (legacy, lambda m: m["static"] is True)):
        srv = obs_server.ObsServer(port=0, snapshot=doc).start()
        try:
            with urllib.request.urlopen(f"{srv.url}/memory",
                                        timeout=5) as r:
                assert check(json.loads(r.read()))
        finally:
            srv.stop()


# -- internals -----------------------------------------------------------------------


def test_rss_probe_reads_statm():
    rss = memacct.rss_bytes()
    assert rss > 10 * 1024 * 1024
    assert memacct.peak_rss_bytes() >= rss // 2
    assert abs(rss - ref_memacct.rss_bytes()) < 64 * 1024 * 1024


def test_probe_errors_are_counted_not_raised():
    memacct.register_probe("test.broken", lambda: 1 / 0)
    try:
        out = memacct.collect(force=True)
        assert "test.broken" not in out
        assert metrics.snapshot()["mem.probe_error"] >= 1
    finally:
        with memacct._lock:
            memacct._probes.pop("test.broken", None)


def test_every_plane_is_probed(small):
    data, _want, batch, _wire = small
    _port_calls(data, batch)
    caches = memacct.collect(force=True)
    assert {"cache.schema", "cache.executables", "cache.arenas",
            "capacity", "routing", "rings"} <= set(caches)
    for name, c in caches.items():
        assert c["bytes"] >= 0, name
    from pyruhvro_tpu_torch.ops import _build

    assert caches.get("cache.kernels", _build._kernels_probe()) == \
        {"bytes": 0.0, "items": 0.0}  # no nvcc here: nothing built


# -- races, replayed on the port's schedtest with the reference's seeds ---------------


def _memacct_race(seed, legacy):
    """A gauge collect interleaved with a reset; ``legacy`` replays the
    reference's pre-fix collect (no generation check)."""
    state = {"v": 1}
    memacct.reset()
    memacct.register_probe("test.race", lambda: {"bytes": float(state["v"])})

    def collect():
        if legacy:
            with memacct._lock:
                probes = list(memacct._probes.items())
            out = {name: fn() for name, fn in probes}
            schedtest.yp("memacct.collect.store")
            with memacct._collect_lock:
                memacct._collect_memo = (time.monotonic(), out, 0)
        else:
            memacct.collect()

    def reset():
        schedtest.yp("memacct.collect")
        state["v"] = 2
        memacct.reset()

    try:
        h = schedtest.Harness(seed=seed)
        h.thread(collect, name="collect")
        h.thread(reset, name="reset")
        h.run()
        return memacct.collect().get("test.race", {}).get("bytes")
    finally:
        with memacct._lock:
            memacct._probes.pop("test.race", None)


def test_memacct_collect_vs_reset_fixed_all_seeds():
    for seed in range(SWEEP):
        assert _memacct_race(seed, legacy=False) == 2.0, seed


def test_memacct_collect_vs_reset_legacy_caught():
    assert _memacct_race(MEMACCT_RACE_SEED, legacy=True) == 1.0


def test_memo_vs_eviction_race_reproduced():
    """A check-then-read memo lookup races an eviction pop: KeyError
    under the committed seed; the shipped ``.get`` read survives every
    seed."""
    def run(seed, buggy):
        modules, errors = {"eng": "mod"}, []

        def lookup():
            if buggy:
                if "eng" in modules:
                    schedtest.yp("engine.memo")
                    try:
                        modules["eng"]
                    except KeyError:
                        errors.append(seed)
            else:
                schedtest.yp("engine.memo")
                modules.get("eng")

        def evict():
            schedtest.yp("engine.evict")
            modules.pop("eng", None)

        h = schedtest.Harness(seed=seed)
        h.thread(lookup, name="lookup")
        h.thread(evict, name="evict")
        h.run()
        return errors

    assert run(MEMO_EVICT_RACE_SEED, buggy=True)
    for seed in range(SWEEP):
        assert run(seed, buggy=False) == []


def test_schema_cache_eviction_vs_get_consistent():
    """A get racing an eviction of the real schema cache serves the old
    entry or rebuilds, never errors or returns a half-built entry."""
    for seed in range(SWEEP):
        scache.clear_schema_cache()
        scache.get_or_parse_schema(KAFKA)
        got = []

        def getter():
            got.append(scache.get_or_parse_schema(KAFKA).fingerprint)

        def evictor():
            schedtest.yp("schema_cache.evict.enter")
            scache._evict(KAFKA)

        h = schedtest.Harness(seed=seed)
        h.thread(getter, name="get")
        h.thread(evictor, name="evict")
        h.run()
        assert got == [scache.get_or_parse_schema(KAFKA).fingerprint], seed


def test_a_call_holding_an_evicted_entry_finishes_on_it(small):
    """A relief on one thread evicts the schema entry a call on another
    thread holds: that call finishes on its own reference, bit-equal."""
    data, want, batch, wire = small
    scache.clear_schema_cache()
    results = []

    def call():
        results.append(_port_calls(data, batch))

    def relieve():
        schedtest.yp("relieve")
        cachelife.relieve(1 << 40)

    for seed in (0, 1, 2):
        results.clear()
        h = schedtest.Harness(seed=seed)
        h.thread(call, name="call")
        h.thread(relieve, name="relieve")
        h.run()
        _same(results[0], (want, wire))
