"""The port's fault seams and interleaving harness, held against the
reference on the CPU (``pyruhvro_tpu_torch/runtime/faults.py`` and
``runtime/schedtest.py``, copies of ``pyruhvro_tpu/runtime/``'s).

* **Faults.** The same spec over the same call sequence injects at the
  same calls in both packages, the seed's phase shift included; a
  malformed spec counts ``fault.config_error`` in both and breaks
  nothing; every site of the reference's tuple parses and fires. Each
  wired seam is driven through the port's public calls:
  ``device_launch``, ``device_compile`` and ``h2d`` raise
  ``FaultInjected`` under ``backend="device"`` and ``"auto"`` alike and
  never reach the host tier (``ROADMAP.md`` (c) 9; the reference's
  ``test_device_fault_degrades_to_host`` is the departure); the native
  seams raise too ((c) 7); ``profile_load`` / ``profile_save`` and
  ``flight_dump`` are counted and leave the call's result unchanged;
  ``pool_worker:exit`` kills a spawned worker and opens the
  ``process_pool`` breaker while the thread path serves the call.
* **schedtest.** ``run_interleaved`` over the port's breaker and cost
  model gives the reference's schedule trace for the same seeds, with no
  stall, over a sweep of ``PYRUHVRO_TPU_SCHED_SEEDS`` seeds; the seed and
  point-filter knobs act as the reference's.

Everything runs on the CPU (``device="cpu"``) at a few hundred rows;
values are compared exactly.
"""

import json
import pickle

import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.runtime import breaker as ref_breaker  # noqa: E402
from pyruhvro_tpu.runtime import costmodel as ref_costmodel  # noqa: E402
from pyruhvro_tpu.runtime import faults as ref_faults  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402
from pyruhvro_tpu.runtime import schedtest as ref_schedtest  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.errors import MalformedAvro  # noqa: E402
from pyruhvro_tpu_torch.hostpath.codec import NativeHostCodec  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    breaker,
    costmodel,
    faults,
    metrics,
    pool,
    router,
    schedtest,
    telemetry,
)
from pyruhvro_tpu_torch.runtime.faults import FaultInjected  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

KAFKA = datagen.KAFKA_SCHEMA_JSON
ROWS = 200


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Both packages' counters, breakers and fault counters cleared; no
    spec, no routing persistence, no flight directory."""
    for name in ("PYRUHVRO_TPU_FAULTS", "PYRUHVRO_TPU_POOL",
                 "PYRUHVRO_TPU_AUTOTUNE", "PYRUHVRO_TPU_NO_NATIVE",
                 "PYRUHVRO_TPU_DEVICE_MIN_ROWS", "PYRUHVRO_TPU_FLIGHT_DIR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")
    for mod in (telemetry, ref.telemetry):
        mod.reset()
    for mod in (faults, ref_faults):
        mod.reset()
    ref_breaker.reset()
    yield
    monkeypatch.delenv("PYRUHVRO_TPU_FAULTS", raising=False)
    faults.reset()
    telemetry.reset()


@pytest.fixture(scope="module")
def data():
    return datagen.kafka_style_datums(ROWS, seed=31)


def schema_of(doc: str) -> str:
    """The Kafka schema under a doc of its own: a fresh schema entry,
    codec and decoder (so a bucket's first launch happens here)."""
    d = json.loads(KAFKA)
    d["doc"] = doc
    return json.dumps(d)


def injections(mod, site: str, n: int):
    """Which of ``n`` calls of ``mod.fire(site)`` raise."""
    hits = []
    for _ in range(n):
        try:
            mod.fire(site)
            hits.append(False)
        except mod.FaultInjected:
            hits.append(True)
    return hits


def same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.to_pylist() == w.to_pylist()


def host_counted(c) -> list:
    """The counters that would say a call reached the host tier."""
    return sorted(k for k in c if k.startswith((
        "route.native", "route.fallback", "route.host",
        "device.host_answer")))


# -- the registry ------------------------------------------------------------


@pytest.mark.parametrize("spec,n", [
    ("vm_decode:error:0.5", 10),
    ("vm_decode:error:0.25", 16),
    ("vm_decode:error:0.25:2", 16),
    ("h2d:error:0.3:5", 20),
    ("device_launch:error:1", 6),
])
def test_injection_schedule_is_the_reference(monkeypatch, spec, n):
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", spec)
    site = spec.split(":")[0]
    got = injections(faults, site, n)
    want = injections(ref_faults, site, n)
    assert got == want and any(got)
    assert metrics.snapshot()["fault.injected." + site] == sum(got)
    # the same spec again from a reset gives the same positions
    faults.reset()
    assert injections(faults, site, n) == got


def test_seed_shifts_the_phase_as_in_the_reference(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "vm_decode:error:0.25")
    base = injections(faults, "vm_decode", 8)
    faults.reset()
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "vm_decode:error:0.25:2")
    shifted = injections(faults, "vm_decode", 8)
    ref_faults.reset()
    assert shifted == injections(ref_faults, "vm_decode", 8)
    assert sum(base) == sum(shifted) == 2 and base != shifted


def test_malformed_spec_counts_and_breaks_nothing(monkeypatch, data):
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS",
                       "nonsense:error:1,vm_decode:zap:1,vm_decode:error:7,"
                       ":::,vm_decode:error:0.5:notanint")
    faults.fire("vm_decode")
    ref_faults.fire("vm_decode")
    got = metrics.snapshot().get("fault.config_error")
    assert got == ref_metrics.snapshot().get("fault.config_error") >= 4
    assert not faults.active()
    same(port.deserialize_array_threaded(data, KAFKA, 2, device="cpu"),
         port.deserialize_array_threaded(data, KAFKA, 2, backend="host"))


def test_every_site_is_the_reference_and_fires(monkeypatch):
    assert faults.SITES == ref_faults.SITES
    for site in faults.SITES:
        faults.reset()
        monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", f"{site}:error:1")
        with pytest.raises(FaultInjected) as ei:
            faults.fire(site)
        assert isinstance(ei.value, RuntimeError) and ei.value.site == site
        back = pickle.loads(pickle.dumps(ei.value))
        assert isinstance(back, FaultInjected) and back.site == site
    with pytest.raises(AssertionError):
        faults.fire("no_such_site")


def test_hang_sleeps_the_configured_seconds(monkeypatch):
    import time

    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "h2d:hang:1")
    monkeypatch.setenv("PYRUHVRO_TPU_FAULT_HANG_S", "0.2")
    assert faults.hang_seconds() == ref_faults.hang_seconds() == 0.2
    t0 = time.perf_counter()
    faults.fire("h2d")  # a hang returns
    assert 0.2 <= time.perf_counter() - t0 < 5.0


# -- the device seams raise, under "device" and "auto" -----------------------


@pytest.mark.parametrize("backend", ["device", "auto"])
@pytest.mark.parametrize("site", ["device_launch", "device_compile", "h2d"])
def test_a_device_fault_raises_and_never_reaches_the_host(
        monkeypatch, data, site, backend):
    # "auto" keeps the device tier under device="cpu" at any row count
    monkeypatch.setenv("PYRUHVRO_TPU_DEVICE_MIN_ROWS", "0")
    schema = schema_of(f"chaos-{site}-{backend}")
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", f"{site}:error:1")
    with pytest.raises(FaultInjected) as ei:
        port.deserialize_array_threaded(data, schema, 4, backend=backend,
                                        device="cpu")
    assert ei.value.site == site
    c = metrics.snapshot()
    assert c["fault.injected." + site] == 1
    assert host_counted(c) == []
    assert router.last_entry()["error"] == "FaultInjected"
    span = telemetry.snapshot()["spans"][-1]
    assert span["attrs"]["fault_injected"] == site
    assert span["attrs"]["route"] == "device"
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "")
    got = port.deserialize_array_threaded(data, schema, 4, backend=backend,
                                          device="cpu")
    same(got, port.deserialize_array_threaded(data, schema, 4,
                                              backend="host"))
    if site == "h2d":
        return  # the encode program copies no arena
    batch = port.deserialize_array(data, schema, backend="host")
    enc_schema = schema_of(f"chaos-enc-{site}-{backend}")
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", f"{site}:error:1")
    telemetry.reset()
    with pytest.raises(FaultInjected):
        port.serialize_record_batch(batch, enc_schema, 2, backend=backend,
                                    device="cpu")
    assert host_counted(metrics.snapshot()) == []
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "")
    arrays = port.serialize_record_batch(batch, enc_schema, 2,
                                         backend=backend, device="cpu")
    assert [d for a in arrays for d in a.to_pylist()] == data


def test_a_device_compile_fault_fires_at_a_first_launch_only(monkeypatch,
                                                             data):
    schema = schema_of("chaos-compile-once")
    port.deserialize_array(data, schema, device="cpu")
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "device_compile:error:1")
    port.deserialize_array(data, schema, device="cpu")  # a warm bucket
    assert "fault.injected.device_compile" not in metrics.snapshot()


# -- the native seams raise ((c) 7) ------------------------------------------


@pytest.mark.parametrize("site", ["native_build", "vm_decode",
                                  "shard_worker", "native_extract"])
def test_a_native_fault_raises(monkeypatch, data, site):
    monkeypatch.setattr(NativeHostCodec, "_PER_CHUNK_ROWS", 8)
    schema = schema_of(f"chaos-native-{site}")
    batch = port.deserialize_array(data, KAFKA, backend="host")
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", f"{site}:error:1")
    with pytest.raises(FaultInjected):
        if site == "native_extract":
            port.serialize_record_batch(batch, schema, 1, backend="host")
        else:
            port.deserialize_array_threaded(data, schema, 4, backend="host")
    c = metrics.snapshot()
    assert c["fault.injected." + site] >= 1
    assert not any(k.startswith("route.fallback") for k in c)
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "")
    same(port.deserialize_array_threaded(data, schema, 4, backend="host"),
         port.deserialize_array_threaded(data, KAFKA, 4, device="cpu"))
    arrays = port.serialize_record_batch(batch, schema, 4, backend="host")
    assert [d for a in arrays for d in a.to_pylist()] == data


# -- the best-effort seams: counted, the call unaffected ---------------------


def test_profile_faults_are_cold_starts_as_in_the_reference(monkeypatch,
                                                            tmp_path):
    for mod, cm, snap in ((faults, costmodel, metrics.snapshot),
                          (ref_faults, ref_costmodel, ref_metrics.snapshot)):
        path = str(tmp_path / f"{cm.__name__}.json")
        cm.observe("fp", "decode", 8, "native/c1/shard", 100, 0.01)
        monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "profile_save:error:1")
        assert cm.save_profile(path) is None
        assert snap().get("router.profile_save_error") == 1.0
        monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "")
        assert cm.save_profile(path) == path
        monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "profile_load:error:1")
        assert cm.load_profile(path) is False
        assert snap().get("router.profile_load_error") == 1.0
        monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "")
        assert cm.load_profile(path) is True


def test_a_flight_dump_fault_leaves_the_call_unchanged(monkeypatch,
                                                       tmp_path, data):
    monkeypatch.setenv("PYRUHVRO_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("PYRUHVRO_TPU_QUARANTINE_STORM", "2")
    bad = list(data)
    for i in (1, 2, 3):
        bad[i] = b"\xff\xff\xff"
    want = port.deserialize_array(bad, KAFKA, device="cpu",
                                  on_error="skip")
    assert len(list(tmp_path.glob("flight_*_quarantine.json"))) == 1
    for f in tmp_path.iterdir():
        f.unlink()
    telemetry.reset()
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "flight_dump:error:1")
    got = port.deserialize_array(bad, KAFKA, device="cpu", on_error="skip")
    assert got.to_pylist() == want.to_pylist() and got.num_rows == ROWS - 3
    with pytest.raises(MalformedAvro):  # the error dump fails as well
        port.deserialize_array(bad, KAFKA, device="cpu")
    c = metrics.snapshot()
    assert c["fault.injected.flight_dump"] >= 1
    assert c["flight.dump_error"] >= 1
    assert list(tmp_path.iterdir()) == []  # nothing half-written


def test_pool_worker_exit_opens_the_process_breaker(monkeypatch, data):
    """A spawned worker killed by ``pool_worker:exit`` breaks the pool:
    the ``process_pool`` breaker opens and the call is served on the
    parent's shard arm, equal to it."""
    want = port.deserialize_array_threaded(data, KAFKA, 2, backend="host")
    monkeypatch.setenv("PYRUHVRO_TPU_POOL", "process")
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "pool_worker:exit:1")
    try:
        got = port.deserialize_array_threaded(data, KAFKA, 2,
                                              backend="host")
    finally:
        pool.shutdown_process_pool()
    same(got, want)
    entry = router.last_entry()
    assert entry["arm"] == "native/c2/process" and entry["degraded"]
    assert breaker.get("process_pool").export()["state"] == "open"
    assert not pool.process_available()
    c = metrics.snapshot()
    assert c["pool.process_fallback"] == 1
    assert c["breaker.process_pool.opened"] == 1


# -- schedtest: the reference's schedules ------------------------------------


def breaker_and_model_workers(brk_mod, cm_mod, tag: str, path: str):
    """Three workers over one package's breaker and cost model: a probe
    that fails and retries, a verdict giver, and an observer that saves
    its profile to ``path``."""
    br = brk_mod.CircuitBreaker(f"sched-{tag}", threshold=1, backoff_s=0.0)
    log = []

    def prober():
        for _ in range(3):
            log.append(("acquire", br.acquire()))
            br.record_failure()

    def verdicts():
        for _ in range(2):
            br.record_success()
            log.append(("release", br.release()))

    def observer():
        for i in range(4):
            cm_mod.observe("fp", "decode", 8, "native/c1/shard", 100,
                           0.001 * (i + 1))
        cm_mod.save_profile(path)

    return [prober, verdicts, observer], log


@pytest.mark.parametrize("seed", range(5))
def test_schedule_trace_is_the_reference(tmp_path, seed):
    fns, log = breaker_and_model_workers(breaker, costmodel, "port",
                                         str(tmp_path / "port.json"))
    h = schedtest.run_interleaved(fns, seed=seed)
    rfns, rlog = breaker_and_model_workers(ref_breaker, ref_costmodel, "ref",
                                           str(tmp_path / "ref.json"))
    rh = ref_schedtest.run_interleaved(rfns, seed=seed)
    assert h.stalls == rh.stalls == 0
    assert h.trace == rh.trace
    assert log == rlog
    assert {p for _t, p in h.trace} >= {
        "breaker.acquire", "breaker.record", "breaker.release",
        "costmodel.observe", "costmodel.save"}


def test_schedule_sweep_is_the_reference(tmp_path):
    """The seed sweep (``PYRUHVRO_TPU_SCHED_SEEDS``, default 20; set it
    higher to search deeper) past the five seeds above."""
    n = schedtest.explore_seeds()
    assert n == ref_schedtest.explore_seeds()
    for seed in range(5, 5 + n):
        fns, log = breaker_and_model_workers(
            breaker, costmodel, "port", str(tmp_path / f"p{seed}.json"))
        h = schedtest.run_interleaved(fns, seed=seed)
        rfns, rlog = breaker_and_model_workers(
            ref_breaker, ref_costmodel, "ref", str(tmp_path / f"r{seed}.json"))
        rh = ref_schedtest.run_interleaved(rfns, seed=seed)
        assert h.stalls == rh.stalls == 0, seed
        assert (h.trace, log) == (rh.trace, rlog), seed


def test_sched_seed_and_points_knobs_are_the_references(monkeypatch,
                                                        tmp_path):
    """``PYRUHVRO_TPU_SCHED_SEED`` pins a harness made without a seed,
    and ``PYRUHVRO_TPU_SCHED_POINTS`` keeps only the named points in the
    schedule, in both packages alike."""
    monkeypatch.setenv("PYRUHVRO_TPU_SCHED_SEED", "3")
    monkeypatch.setenv("PYRUHVRO_TPU_SCHED_POINTS",
                       "breaker.acquire, costmodel.save")
    runs = []
    for mod, brk, cm, tag in ((schedtest, breaker, costmodel, "port"),
                              (ref_schedtest, ref_breaker, ref_costmodel,
                               "ref")):
        fns, log = breaker_and_model_workers(brk, cm, tag,
                                             str(tmp_path / f"{tag}.json"))
        h = mod.Harness()
        for fn in fns:
            h.thread(fn)
        h.run(timeout_s=30.0)
        assert (h.seed, h.stalls) == (3, 0)
        runs.append((h.trace, log))
    assert runs[0] == runs[1]
    assert {p for _t, p in runs[0][0]} == {"breaker.acquire",
                                            "costmodel.save"}


def test_schema_cache_and_arena_yield_points(monkeypatch):
    """Two threads parse, memoize and check out an arena under one seed:
    the port's trace names the reference's points, and runs with no
    stall."""
    from pyruhvro_tpu_torch.ops.decode import DeviceDecoder
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema

    def worker(k):
        def run():
            entry = get_or_parse_schema(schema_of(f"sched-cache-{k}"))
            get_or_parse_schema(schema_of(f"sched-cache-{k}"))
            dec = entry.get_extra("sched_decoder", lambda: DeviceDecoder(
                entry.ir, device="cpu"))
            dec._arena(64, 4096)
        return run

    h = schedtest.run_interleaved([worker(0), worker(1)], seed=7)
    assert h.stalls == 0
    points = [p for _t, p in h.trace]
    for p in ("schema_cache.insert", "schema_cache.get",
              "schema_cache.memo", "arena.checkout"):
        assert points.count(p) == 2, (p, points)
    assert schedtest.active() is False
