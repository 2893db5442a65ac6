"""The port's routing plane held against the reference's, on the CPU.

The cost model, the circuit breaker and the drift detector are fed the
same sequences in both packages and must export the same state.
``backend="auto"`` with ``device="cpu"`` (the port's ``devices_cpu_only``)
must route a sequence of Kafka calls to the same tier, arm, mode and
reason as the reference's ``backend="auto"`` on JAX's CPU platform, with
autotune off and on (a fixed explore rate), and return the same batches.
Then the routing profile (a round trip in ``tmp_path`` with capacity
plans, and the refusal of a foreign or untagged document), a fresh
process seeding its decoder from a persisted plan, the recompile-storm
penalty, the ledger and its renderers, and the host answers that only
``"auto"`` allows. Every test that turns autotune or persistence on sets
``PYRUHVRO_TPU_ROUTING_PROFILE`` to ``""`` or to ``tmp_path``.
Decode and encode are integer and byte work: the tolerance is 0.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.runtime import breaker as ref_breaker  # noqa: E402
from pyruhvro_tpu.runtime import costmodel as ref_costmodel  # noqa: E402
from pyruhvro_tpu.runtime import drift as ref_drift  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402
from pyruhvro_tpu.runtime import router as ref_router  # noqa: E402
from pyruhvro_tpu.schema.cache import get_or_parse_schema as ref_entry  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.fallback.decoder import decode_to_record_batch  # noqa: E402
from pyruhvro_tpu_torch.ops import decode, encode  # noqa: E402
from pyruhvro_tpu_torch.ops.codec import DeviceCodec  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    breaker,
    capacity,
    costmodel,
    device_obs,
    drift,
    metrics,
    router,
    telemetry,
)
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KAFKA = datagen.KAFKA_SCHEMA_JSON
# outside the device subset (a decimal past decimal128): "gate_fail"
WIDE_DECIMAL = ('{"type":"record","name":"WD","fields":[{"name":"d","type":'
                '{"type":"fixed","name":"F17","size":17,"logicalType":'
                '"decimal","precision":38,"scale":0}}]}')
# schemas of their own for the tests that break a codec on purpose: the
# codecs are memoized per schema for the life of the process
ANSWER_DECODE = KAFKA.replace('"name": "User"', '"name": "AnsDec"', 1)
ANSWER_ENCODE = KAFKA.replace('"name": "User"', '"name": "AnsEnc"', 1)
ANSWER_ENCODE_U = KAFKA.replace('"name": "User"', '"name": "AnsEncU"', 1)
OBS = [("s1", "decode", 7, "native/c1/none", 100, 0.002),
       ("s1", "decode", 7, "device/c1/none", 100, 0.030),
       ("s1", "decode", 7, "native/c1/none", 120, 0.0021),
       ("s1", "encode", 11, "native/c4/shard", 2000, 0.004),
       ("s2", "decode", 17, "device/c8/none", 100_000, 0.25),
       ("s1", "decode", 7, "native/c1/none", 90, 0.0016)]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Both packages' routing state cleared; the routing, engine and
    reference-only knobs unset or pinned; one torch thread."""
    for name in ("PYRUHVRO_TPU_AUTOTUNE", "PYRUHVRO_TPU_EXPLORE",
                 "PYRUHVRO_TPU_DEVICE_MIN_ROWS", "PYRUHVRO_TPU_POOL",
                 "PYRUHVRO_TPU_CAPACITY_PERSIST", "PYRUHVRO_TPU_OVERLAP",
                 "PYRUHVRO_TPU_OVERLAP_ROWS", "PYRUHVRO_TPU_PALLAS",
                 "PYRUHVRO_TPU_NO_NATIVE", "PYRUHVRO_TPU_BREAKER_THRESHOLD",
                 "PYRUHVRO_TPU_BREAKER_BACKOFF", "PYRUHVRO_TPU_DRIFT_RATIO",
                 "PYRUHVRO_TPU_DRIFT_SUSTAIN"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    # the reference's sampler and audit shadow stay out of its timings
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")
    monkeypatch.setenv("PYRUHVRO_TPU_NO_AUDIT", "1")
    telemetry.reset()
    ref.telemetry.reset()
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    telemetry.reset()
    ref.telemetry.reset()


@pytest.fixture(scope="module")
def kafka():
    return datagen.kafka_style_datums(64, seed=3)


@pytest.fixture(scope="module")
def kafka_batch(kafka):
    return port.deserialize_array(kafka, KAFKA, backend="host")


def same_batches(got, want):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.to_pylist() == w.to_pylist()


def route_of(entry):
    return (entry["tier"], entry["arm"], entry["mode"], entry["reason"])


# -- (a) the cost model, the breaker and drift -------------------------------


def feed(model, obs):
    for o in obs:
        model.observe(*o)


def test_cost_model_predictions_and_export_are_the_reference():
    feed(costmodel, OBS)
    feed(ref_costmodel, OBS)
    keys = {(o[0], o[1], o[2], o[3]) for o in OBS}
    for key in sorted(keys):
        for rows in (1, 64, 100_000):
            assert costmodel.predict(*key, rows) == \
                ref_costmodel.predict(*key, rows)
        assert costmodel.obs_count(*key) == ref_costmodel.obs_count(*key)
    assert costmodel.predict("s1", "decode", 7, "device/c4/none", 10) is None
    assert costmodel.snapshot()["entries"] == \
        ref_costmodel.snapshot()["entries"]
    assert costmodel.predict_drain("s1", "decode", 500) == \
        ref_costmodel.predict_drain("s1", "decode", 500)
    for _ in range(3):
        assert costmodel.tick("s1", "decode", 7) == \
            ref_costmodel.tick("s1", "decode", 7)
    # aging past the evidence cap, and worker observations merged
    many = [("s3", "decode", 9, "native/c1/none", 300, 0.001 * (1 + i % 5))
            for i in range(600)]
    with costmodel.record_observations() as got, \
            ref_costmodel.record_observations() as want:
        feed(costmodel, many)
        feed(ref_costmodel, many)
    assert got == want and len(got) == 600
    assert costmodel.merge_observations(got) == \
        ref_costmodel.merge_observations(want) == 600
    assert costmodel.snapshot()["entries"] == \
        ref_costmodel.snapshot()["entries"]


def test_arm_penalty_inflates_like_the_reference():
    feed(costmodel, OBS)
    feed(ref_costmodel, OBS)
    for model in (costmodel, ref_costmodel):
        model.penalize_arm("s1", "native/c1/none", 60.0, factor=1.7)
        model.penalize("s2", 60.0)
    key = ("s1", "decode", 7, "native/c1/none")
    assert costmodel.predict(*key, 50) == ref_costmodel.predict(*key, 50)
    assert costmodel.arm_penalized("s1", "native/c1/none")
    assert costmodel.device_penalized("s2") and \
        ref_costmodel.device_penalized("s2")
    assert not costmodel.device_penalized("s1")


class Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def test_breaker_sequence_exports_the_reference(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(breaker, "time", clock)
    monkeypatch.setattr(ref_breaker, "time", clock)
    monkeypatch.setenv("PYRUHVRO_TPU_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("PYRUHVRO_TPU_BREAKER_BACKOFF", "0.5")
    a, b = breaker.get("process_pool"), ref_breaker.get("process_pool")
    steps = ["fail", "ok", "fail", "fail", "acquire", "tick:0.4", "acquire",
             "tick:0.2", "acquire", "acquire", "fail", "tick:0.9",
             "acquire", "release", "acquire", "fail", "tick:2.1", "acquire",
             "ok", "acquire", "force", "tick:31", "acquire", "tick:31",
             "acquire", "ok"]
    for step in steps:
        if step.startswith("tick:"):
            clock.t += float(step[5:])
            continue
        got = want = None
        for br in (a, b):
            r = {"fail": br.record_failure, "ok": br.record_success,
                 "acquire": br.acquire, "release": br.release,
                 "force": br.force_open}[step]()
            if br is a:
                got = r
            else:
                want = r
        assert got == want, step
        assert a.export() == b.export(), step
        assert a.allow() == b.allow() and a.state() == b.state(), step
    assert breaker.snapshot_breakers() == ref_breaker.snapshot_breakers()
    keys = [k for k in ref_metrics.snapshot() if k.startswith("breaker.")]
    assert keys
    for k in keys:
        assert metrics.snapshot()[k] == ref_metrics.snapshot()[k], k
    for opens in range(1, 9):
        assert breaker.backoff_schedule(opens) == \
            ref_breaker.backoff_schedule(opens)


@pytest.mark.parametrize("ratio,sustain", [(None, None), ("1.2", "3")])
def test_drift_verdicts_are_the_reference(monkeypatch, ratio, sustain):
    if ratio:
        monkeypatch.setenv("PYRUHVRO_TPU_DRIFT_RATIO", ratio)
        monkeypatch.setenv("PYRUHVRO_TPU_DRIFT_SUSTAIN", sustain)
    rng = np.random.default_rng(7)
    base = rng.uniform(1e-6, 2e-6, 40)
    seq = list(base) + list(base[:25] * 2.5) + list(base[:10] * 0.9)
    for arm in ("native/c1/none", "device/c8/none"):
        for x in seq:
            drift.observe("s", "decode", 9, arm, float(x))
            ref_drift.observe("s", "decode", 9, arm, float(x))
    got, want = drift.snapshot_drift(), ref_drift.snapshot_drift()
    assert got == want
    assert any(e["detections"] for e in got["entries"])
    for k in ("drift.checks", "drift.suspect", "drift.detected",
              "router.arm_penalty", "router.device_penalty"):
        assert metrics.snapshot().get(k) == ref_metrics.snapshot().get(k), k
    for arm in ("native/c1/none", "device/c8/none"):
        assert costmodel.arm_penalty("s", arm) == \
            ref_costmodel.arm_penalty("s", arm)
    assert costmodel.device_penalized("s") == ref_costmodel.device_penalized("s")


# -- (b) backend="auto" against the reference's ------------------------------


def port_call(kind, data, batch, chunks, **kw):
    if kind == "decode":
        return port.deserialize_array(data, KAFKA, device="cpu",
                                      backend="auto", **kw)
    if kind == "threaded":
        return port.deserialize_array_threaded(data, KAFKA, chunks,
                                               device="cpu", backend="auto",
                                               **kw)
    return port.serialize_record_batch(batch, KAFKA, chunks, device="cpu",
                                       backend="auto", **kw)


def ref_call(kind, data, batch, chunks, **kw):
    if kind == "decode":
        return ref.deserialize_array(data, KAFKA, backend="auto", **kw)
    if kind == "threaded":
        return ref.deserialize_array_threaded(data, KAFKA, chunks,
                                              backend="auto", **kw)
    return ref.serialize_record_batch(batch, KAFKA, chunks, backend="auto",
                                      **kw)


STATIC_SEQUENCE = [("decode", 64, 1), ("threaded", 64, 4), ("encode", 64, 4),
                   ("threaded", 16, 2), ("decode", 1, 1)]


@pytest.mark.parametrize("min_rows", [None, "32"])
def test_static_verdict_is_the_reference(monkeypatch, kafka, kafka_batch,
                                         min_rows):
    """Autotune off: the static verdict (``devices_cpu_only``, or with
    ``PYRUHVRO_TPU_DEVICE_MIN_ROWS`` ``device_min_rows`` below it and the
    device above) gives the reference's tier, arm, mode and reason, and
    the same result."""
    if min_rows:
        monkeypatch.setenv("PYRUHVRO_TPU_DEVICE_MIN_ROWS", min_rows)
    for kind, rows, chunks in STATIC_SEQUENCE:
        data, batch = kafka[:rows], kafka_batch.slice(0, rows)
        got = port_call(kind, data, batch, chunks)
        want = ref_call(kind, data, batch, chunks)
        if kind == "encode":
            assert [a.to_pylist() for a in got] == \
                [a.to_pylist() for a in want]
        else:
            same_batches(got, want)
        assert route_of(router.last_entry()) == \
            route_of(ref_router.last_entry()), (kind, rows, chunks)
    reasons = {e["reason"] for e in router.snapshot_routing()["ledger"]}
    assert reasons == ({"devices_cpu_only"} if not min_rows
                       else {"device_selected", "device_min_rows"})


def test_gate_fail_is_the_reference():
    from decimal import Decimal as D

    values = [D(int(v)) for v in
              np.random.default_rng(2).integers(-10**12, 10**12, 20)]
    batch = pa.RecordBatch.from_pydict(
        {"d": pa.array(values + [D(10) ** 30], pa.decimal128(38, 0))})
    [arr] = port.serialize_record_batch(batch, WIDE_DECIMAL, 1,
                                        backend="auto")
    assert route_of(router.last_entry()) == \
        ("fallback", "fallback/c1/none", "static", "gate_fail")
    data = arr.to_pylist()
    got = port.deserialize_array(data, WIDE_DECIMAL, backend="auto")
    want = ref.deserialize_array(data, WIDE_DECIMAL, backend="auto")
    same_batches(got, want)
    assert route_of(router.last_entry()) == route_of(ref_router.last_entry())
    assert router.last_entry()["reason"] == "gate_fail"


def test_autotune_routes_like_the_reference(monkeypatch, kafka):
    """Autotune on, every second call exploring: the same arms in the same
    modes on single-chunk Kafka calls (where the port's arm space is the
    reference's), the greedy pick never an unobserved arm; then chunked
    calls with exploration off."""
    monkeypatch.setenv("PYRUHVRO_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("PYRUHVRO_TPU_EXPLORE", "0.5")
    got, want = [], []
    for _ in range(6):
        same_batches(port_call("decode", kafka, None, 1),
                     ref_call("decode", kafka, None, 1))
        got.append(route_of(router.last_entry()))
        want.append(route_of(ref_router.last_entry()))
    assert got == want
    assert [m for _t, _a, m, _r in got] == \
        ["cold_start", "explore", "model", "explore", "model", "explore"]
    assert {r for *_x, r in got} == {"devices_cpu_only", "autotune_explore"}
    monkeypatch.setenv("PYRUHVRO_TPU_EXPLORE", "0")
    for _ in range(3):
        same_batches(port_call("threaded", kafka, None, 4),
                     ref_call("threaded", kafka, None, 4))
        assert route_of(router.last_entry()) == \
            route_of(ref_router.last_entry())
    ledger = router.snapshot_routing()["ledger"]
    for e in ledger:
        if e["mode"] == "model":
            assert e["predicted_s"] is not None
    assert metrics.snapshot()["router.explored"] == 3
    assert metrics.snapshot()["router.override"] == 3


def test_every_function_leaves_one_ledger_entry(kafka, kafka_batch):
    calls = [
        lambda: port.deserialize_array(kafka, KAFKA, backend="auto",
                                       device="cpu"),
        lambda: port.deserialize_array_threaded(kafka, KAFKA, 2,
                                                backend="auto", device="cpu"),
        lambda: port.deserialize_array_threaded_spawn(
            kafka, KAFKA, 2, backend="auto", device="cpu"),
        lambda: port.serialize_record_batch(kafka_batch, KAFKA, 2,
                                            backend="auto", device="cpu"),
        lambda: port.serialize_record_batch_spawn(
            kafka_batch, KAFKA, 2, backend="auto", device="cpu"),
    ]
    for i, call in enumerate(calls, 1):
        call()
        assert len(router.snapshot_routing()["ledger"]) == i
    with pytest.raises(port.DeadlineExceeded):
        port.deserialize_array(kafka, KAFKA, backend="auto", device="cpu",
                               timeout_s=0)
    last = router.last_entry()
    assert last["error"] == "DeadlineExceeded" and last["observed_s"] >= 0
    with pytest.raises(ValueError, match="no TPU"):
        port.deserialize_array(kafka, KAFKA, backend="tpu")
    assert len(router.snapshot_routing()["ledger"]) == 6
    span = telemetry.snapshot()["spans"][-1]
    assert span["attrs"]["route_arm"] == last["arm"]


def test_route_report_and_what_if_render_a_live_snapshot(tmp_path, monkeypatch,
                                                         kafka, capsys):
    monkeypatch.setenv("PYRUHVRO_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("PYRUHVRO_TPU_EXPLORE", "0.5")
    for _ in range(4):
        port.deserialize_array(kafka, KAFKA, backend="auto", device="cpu")
    snap = telemetry.snapshot()
    assert {"routing"} <= set(snap)
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(snap))
    for cmd, render in (("route-report", ref_router.render_route_report),
                        ("what-if", ref_router.render_what_if)):
        assert telemetry.main([cmd, str(path)]) == 0
        out = capsys.readouterr().out
        assert out == render(snap)
    assert "decision ledger: 4 entries" in telemetry.render_report(snap)
    proc = subprocess.run(
        [sys.executable, "-m", "pyruhvro_tpu_torch.telemetry",
         "route-report", str(path)], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0 and "== routing ==" in proc.stdout


# -- (c) the routing profile -------------------------------------------------


def test_profile_round_trip_with_capacity(tmp_path):
    feed(costmodel, OBS)
    capacity.learn("s1", 128, {"emails": 16}, {"emails": 900}, [64])
    path = str(tmp_path / "p.json")
    assert costmodel.save_profile(path) == path
    doc = json.loads(Path(path).read_text())
    assert doc["package"] == "pyruhvro_tpu_torch" and doc["version"] == 2
    assert doc["capacity"] == capacity.entries()
    # the reference writes the same entries from the same observations
    feed(ref_costmodel, OBS)
    ref_path = str(tmp_path / "ref.json")
    ref_costmodel.save_profile(ref_path)
    ref_doc = json.loads(Path(ref_path).read_text())
    assert ref_doc["entries"] == doc["entries"]
    entries = costmodel.snapshot()["entries"]
    plan = capacity.lookup("s1", 128)
    costmodel.reset()
    assert capacity.lookup("s1", 128) is None
    assert costmodel.load_profile(path)
    assert costmodel.snapshot()["entries"] == entries
    assert capacity.lookup("s1", 128) == plan
    # a save after a load contributes nothing new
    costmodel.save_profile(path)
    assert json.loads(Path(path).read_text())["entries"] == doc["entries"]
    assert metrics.snapshot()["router.profile_loaded"] == 1


@pytest.mark.parametrize("doc", ["reference", "untagged", "foreign",
                                 "stale", "corrupt"])
def test_foreign_or_untagged_profile_is_refused(tmp_path, doc):
    path = tmp_path / "p.json"
    feed(ref_costmodel, OBS)
    if doc == "reference":
        ref_costmodel.save_profile(str(path))
    else:
        feed(costmodel, OBS)
        costmodel.save_profile(str(path))
        d = json.loads(path.read_text())
        if doc == "untagged":
            del d["package"]
        elif doc == "foreign":
            d["package"] = "pyruhvro_tpu"
        elif doc == "stale":
            d["version"] = 99
        path.write_text("{" if doc == "corrupt" else json.dumps(d))
        costmodel.reset()
    assert not costmodel.load_profile(str(path))
    assert costmodel.snapshot()["entries"] == []
    assert metrics.snapshot()["router.profile_load_error"] == 1


CHILD = """
import json, sys
from pyruhvro_tpu_torch import deserialize_array_threaded
from pyruhvro_tpu_torch.ops import decode
from pyruhvro_tpu_torch.runtime import capacity, metrics
from pyruhvro_tpu_torch.utils import datagen
data = datagen.kafka_style_datums(600, seed=1)
deserialize_array_threaded(data, datagen.KAFKA_SCHEMA_JSON, 2, device="cpu")
c = metrics.snapshot()
print(json.dumps({"hits": c.get("device.capacity.plan_hits", 0),
                  "misses": c.get("device.capacity.plan_misses", 0),
                  "retries": c.get("device.retries", 0),
                  "plans": capacity.entries()}))
"""


def run_child(env, tmp_path):
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_fresh_process_seeds_its_decoder_from_the_profile(tmp_path):
    """Under ``PYRUHVRO_TPU_CAPACITY_PERSIST=1`` a process saves its
    plans at exit and a fresh one loads them at import: its first device
    call is a planner hit with no capacity retry."""
    profile = tmp_path / "ROUTING_PROFILE.torch.json"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYRUHVRO_TPU_")}
    env.update(PYRUHVRO_TPU_CAPACITY_PERSIST="1",
               PYRUHVRO_TPU_ROUTING_PROFILE=str(profile),
               PYRUHVRO_TPU_OVERLAP="0", OMP_NUM_THREADS="1")
    first = run_child(env, tmp_path)
    assert first["misses"] >= 1 and first["hits"] == 0 and first["plans"]
    doc = json.loads(profile.read_text())
    assert doc["package"] == "pyruhvro_tpu_torch"
    assert doc["capacity"] == first["plans"]
    second = run_child(env, tmp_path)
    assert second["hits"] >= 1 and second["misses"] == 0
    assert second["retries"] == 0
    # without the profile the fresh process misses again
    env["PYRUHVRO_TPU_ROUTING_PROFILE"] = ""
    third = run_child(env, tmp_path)
    assert third["hits"] == 0 and third["misses"] >= 1


# -- (d) the storm penalty ---------------------------------------------------


def test_recompile_storm_withholds_the_device_arm(monkeypatch, kafka):
    monkeypatch.setenv("PYRUHVRO_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("PYRUHVRO_TPU_EXPLORE", "0")
    monkeypatch.setenv("PYRUHVRO_TPU_DEVICE_MIN_ROWS", "1")
    port.deserialize_array(kafka, KAFKA, backend="auto", device="cpu")
    ref.deserialize_array(kafka, KAFKA, backend="auto")
    assert router.last_entry()["tier"] == "device"
    assert route_of(router.last_entry()) == route_of(ref_router.last_entry())
    fp = get_or_parse_schema(KAFKA).fingerprint
    assert not costmodel.device_penalized(fp)
    monkeypatch.setenv("PYRUHVRO_TPU_RECOMPILE_STORM", "3")
    for b in range(3):
        device_obs.note_compile(fp, "walk", f"R{b}")
    assert metrics.snapshot()["device.recompile_storm"] >= 1
    assert costmodel.device_penalized(fp)
    ref_costmodel.penalize(ref_entry(KAFKA).fingerprint, 60.0)
    same_batches(port.deserialize_array(kafka, KAFKA, backend="auto",
                                        device="cpu"),
                 ref.deserialize_array(kafka, KAFKA, backend="auto"))
    assert route_of(router.last_entry()) == route_of(ref_router.last_entry())
    assert router.last_entry()["tier"] == "native"
    assert metrics.snapshot()["router.storm_skip"] == 1
    assert "device/c1/none" in router.last_entry()["counterfactual_s"]
    # a forced device call still runs on the device
    port.deserialize_array(kafka, KAFKA, backend="device", device="cpu")
    assert router.last_entry()["tier"] == "device"


# -- (e) the host answers, under "auto" only ---------------------------------


@pytest.fixture()
def device_static(monkeypatch):
    """``backend="auto"`` routed to the device tier on the CPU."""
    monkeypatch.setenv("PYRUHVRO_TPU_DEVICE_MIN_ROWS", "0")


def oracle(data, schema):
    entry = get_or_parse_schema(schema)
    from pyruhvro_tpu_torch.fallback.decoder import compile_reader

    return decode_to_record_batch(data, entry.ir, entry.arrow_schema,
                                  compile_reader(entry.ir))


def test_capacity_past_the_card_is_answered_on_the_host(monkeypatch,
                                                        device_static):
    """Records whose item counts pass ``_MAX_ITEM_CAP`` (lowered here):
    ``DeviceCapacityExceeded`` under ``"device"``, the oracle's batch
    under ``"auto"``."""
    monkeypatch.setattr(decode, "_MAX_ITEM_CAP", 64)
    batch = port.deserialize_array(datagen.kafka_style_datums(40, seed=4),
                                   KAFKA, backend="host")
    emails = batch.column("emails").to_pylist()
    emails[7] = [f"u{i}@x" for i in range(100)]
    batch = batch.set_column(batch.schema.get_field_index("emails"),
                             batch.schema.field("emails"),
                             pa.array(emails, batch.schema.field(
                                 "emails").type))
    [arr] = port.serialize_record_batch(batch, KAFKA, 1, backend="host")
    data = arr.to_pylist()
    with pytest.raises(port.DeviceCapacityExceeded):
        port.deserialize_array(data, ANSWER_DECODE, device="cpu")
    telemetry.reset()
    same_batches(port.deserialize_array(data, ANSWER_DECODE, backend="auto",
                                        device="cpu"),
                 oracle(data, ANSWER_DECODE))
    span = telemetry.snapshot()["spans"][-1]
    assert span["attrs"]["route"] == "device"
    assert span["attrs"]["device_host_answer"] == "capacity"
    same_batches(port.deserialize_array_threaded(data, ANSWER_DECODE, 3,
                                                 backend="auto",
                                                 device="cpu"),
                 port.deserialize_array_threaded(data, ANSWER_DECODE, 3,
                                                 backend="host"))
    assert metrics.snapshot()["device.host_answer.capacity"] == 2


@pytest.mark.parametrize("error", ["batch_too_large", "unsupported"])
def test_decode_limits_are_answered_on_the_host(monkeypatch, device_static,
                                                kafka, error):
    planted = {"batch_too_large": lambda: port.BatchTooLarge(1, 1 << 31),
               "unsupported": lambda: port.UnsupportedOnDevice("tile")}[error]

    def refuse(self, data):
        raise planted()

    monkeypatch.setattr(DeviceCodec, "_decode_triples", refuse)
    with pytest.raises(type(planted())):
        port.deserialize_array(kafka, ANSWER_DECODE, device="cpu")
    got = port.deserialize_array_threaded(kafka, ANSWER_DECODE, 2,
                                          backend="auto", device="cpu")
    same_batches(got, port.deserialize_array_threaded(
        kafka, ANSWER_DECODE, 2, backend="host"))
    # one datum over the budget is answered alone: every row, in halves
    want = len(kafka) if error == "batch_too_large" else 1
    assert metrics.snapshot()[f"device.host_answer.{error}"] == want
    # the answers serve the tolerant policies too, with the host's rows
    bad = list(kafka)
    bad[9] = b"\x01"
    out, quar = port.deserialize_array_threaded(
        bad, ANSWER_DECODE, 2, backend="auto", device="cpu",
        on_error="skip", return_errors=True)
    want_out, want_q = port.deserialize_array_threaded(
        bad, ANSWER_DECODE, 2, backend="host", on_error="skip",
        return_errors=True)
    same_batches(out, want_out)
    assert [(q.index, q.error) for q in quar] == \
        [(q.index, q.error) for q in want_q] == [(9, "overrun")]


@pytest.mark.parametrize("error", ["unsupported", "batch_too_large"])
def test_encode_limits_are_answered_on_the_host(monkeypatch, device_static,
                                                kafka_batch, error):
    if error == "unsupported":
        def refuse(*_a, **_k):
            raise port.UnsupportedOnDevice("outside the encode subset")

        monkeypatch.setattr(encode, "lower_encoder", refuse)
        # a codec of its own: the refusal is kept on the codec
        schema, want_error = ANSWER_ENCODE_U, port.UnsupportedOnDevice
    else:
        def refuse(self, batch):
            raise port.BatchTooLarge(batch.num_rows, 1 << 31)

        monkeypatch.setattr(encode.DeviceEncoder, "encode", refuse)
        schema, want_error = ANSWER_ENCODE, port.BatchTooLarge
    batch = kafka_batch
    with pytest.raises(want_error):
        port.serialize_record_batch(batch, schema, 2, device="cpu")
    got = port.serialize_record_batch(batch, schema, 2, backend="auto",
                                      device="cpu")
    want = port.serialize_record_batch(batch, schema, 2, backend="host")
    assert [a.to_pylist() for a in got] == [a.to_pylist() for a in want]
    assert metrics.snapshot()[f"device.host_answer.{error}"] >= 1


def test_a_card_fault_raises_under_auto(monkeypatch, device_static, kafka,
                                        kafka_batch):
    def broken(*_a, **_k):
        raise RuntimeError("decode_walk launch failed: CUDA error 700")

    monkeypatch.setattr(decode, "walk", broken)
    for policy in ("raise", "skip"):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            port.deserialize_array_threaded(kafka, KAFKA, 2, backend="auto",
                                            device="cpu", on_error=policy)
    assert router.last_entry()["error"] == "RuntimeError"

    def broken_encode(*_a, **_k):
        raise OSError("encode_rows launch failed")

    monkeypatch.setattr(encode, "run_program", broken_encode)
    with pytest.raises(OSError):
        port.serialize_record_batch(kafka_batch, KAFKA, 2, backend="auto",
                                    device="cpu")
    assert "device.host_answer" not in metrics.snapshot()
    assert metrics.snapshot()["device.call_failure"] == 3


def test_no_card_raises_under_auto(kafka):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        port.deserialize_array(kafka, KAFKA, backend="auto")


def test_knobs_parse_like_the_reference(monkeypatch):
    from pyruhvro_tpu.runtime import knobs as ref_knobs
    from pyruhvro_tpu_torch.runtime import knobs, pool

    for raw, want in (("process", "process"), ("PROCESS", "process"),
                      ("", "thread"), ("fork", "thread")):
        monkeypatch.setenv("PYRUHVRO_TPU_POOL", raw)
        assert pool.pool_mode() == want == ref_knobs.get_enum(
            "PYRUHVRO_TPU_POOL")
    assert metrics.snapshot()["knob.parse_error.PYRUHVRO_TPU_POOL"] == 1
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    assert costmodel.profile_path() == "" == ref_costmodel.profile_path()
    monkeypatch.delenv("PYRUHVRO_TPU_ROUTING_PROFILE")
    assert costmodel.profile_path() == "ROUTING_PROFILE.torch.json"
    assert knobs.is_set("PYRUHVRO_TPU_POOL")


def test_concurrent_routing_state_loses_nothing(monkeypatch):
    """More threads than cores on the cost model and a half-open breaker,
    with a short switch interval: no lost observation or decide tick, and
    exactly one half-open probe admitted."""
    import threading

    clock = Clock()
    monkeypatch.setattr(breaker, "time", clock)
    br = breaker.get("process_pool")
    br.record_failure()
    clock.t += 60.0
    admitted = []

    def work(k):
        for _ in range(200):
            costmodel.observe(f"t{k}", "decode", 7, "native/c1/none", 100,
                              0.001)
            costmodel.tick("shared", "decode", 7)
        admitted.append(br.acquire())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(3 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    for k in range(len(threads)):
        assert costmodel.obs_count(f"t{k}", "decode", 7,
                                   "native/c1/none") == 200
    assert costmodel.tick("shared", "decode", 7) == 200 * len(threads) + 1
    assert admitted.count(True) == 1 and br.state() == "half_open"
