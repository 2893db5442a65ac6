"""The port's serving plane (``pyruhvro_tpu_torch/serving/``, a copy of
``pyruhvro_tpu/serving/``), held against the reference on the CPU.

* Every test of ``tests/test_serving.py`` and the four serving seams of
  ``tests/test_chaos.py`` (``serve_worker`` error and hang, the
  ``serve_enqueue`` bypass, the breaker's half-open recovery), each under
  the reference's name, run on the port with ``device="cpu"`` (the
  kernels' plain versions; the plane's own default is ``"cuda"``).
* The same seeded requests through the reference's ``ServePlane`` and
  the port's, both on ``backend="host"`` (no XLA compile): each future's
  values, the quarantine entries' rebased indices and slugs, and the
  accounting (submitted, accepted, shed by reason, completed, failed,
  coalesced, drained) are equal.
* The departures (``ROADMAP.md`` (c) 11): a ``device_launch`` fault in a
  coalesced batch reaches every member's future as ``FaultInjected`` and
  nothing is answered by the host tier or the oracle; requests for
  different devices never share a batch; the Flight spec's ``device``.

Private planes are built with ``autostart=False`` so nothing runs until
``drain()`` flushes the queues inline. ``tests/conftest.py`` resets only
the reference's plane, so the fixture below stops and resets both
packages' planes, counters, breakers and fault counters around each
test.
"""

import json
import signal
import threading
import time
import urllib.error
import urllib.request

import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu import serving as ref_serving  # noqa: E402
from pyruhvro_tpu.runtime import breaker as ref_breaker  # noqa: E402
from pyruhvro_tpu.runtime import faults as ref_faults  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402

import pyruhvro_tpu_torch as pv  # noqa: E402
from pyruhvro_tpu_torch import serving  # noqa: E402
from pyruhvro_tpu_torch.errors import MalformedAvro  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    audit,
    breaker,
    costmodel,
    faults,
    metrics,
    obs_server,
    sampling,
    telemetry,
)
from pyruhvro_tpu_torch.runtime.deadline import DeadlineExceeded  # noqa: E402
from pyruhvro_tpu_torch.runtime.faults import FaultInjected  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.serving import Overloaded, ServePlane  # noqa: E402
from pyruhvro_tpu_torch.utils.datagen import (  # noqa: E402
    KAFKA_SCHEMA_JSON,
    kafka_style_datums,
    random_datums,
)

FLAT_SCHEMA = """\
{"type":"record","name":"F","fields":[
  {"name":"x","type":"long"},{"name":"s","type":"string"}]}"""

DEV = "cpu"  # the plain versions of the kernels: the port's device tier here


def counters():
    return metrics.snapshot()


def decode(data, schema=KAFKA_SCHEMA_JSON, **kw):
    return pv.deserialize_array(data, schema, device=DEV, **kw)


def _reset_planes():
    for mod in (serving, ref_serving):
        mod.reset()
    for mod in (telemetry, ref.telemetry):
        mod.reset()
    for mod in (faults, ref_faults):
        mod.reset()
    ref_breaker.reset()


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Both packages' planes stopped and reset (their worker threads and
    process-wide brownout overrides would leak into later tests), and
    their counters, breakers and fault counters cleared."""
    for name in ("PYRUHVRO_TPU_FAULTS", "PYRUHVRO_TPU_AUTOTUNE",
                 "PYRUHVRO_TPU_FLIGHT_DIR", "PYRUHVRO_TPU_NO_NATIVE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")
    monkeypatch.setenv("PYRUHVRO_TPU_NO_AUDIT", "1")
    _reset_planes()
    yield
    monkeypatch.delenv("PYRUHVRO_TPU_FAULTS", raising=False)
    _reset_planes()


@pytest.fixture
def chaos(monkeypatch):
    """Set the fault spec in-process (the registry re-parses when the
    variable changes)."""

    def set_spec(spec: str, hang_s: float = None):
        monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", spec)
        if hang_s is not None:
            monkeypatch.setenv("PYRUHVRO_TPU_FAULT_HANG_S", str(hang_s))

    yield set_spec


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def host_counted(c) -> list:
    """The counters that would say a call reached the host tier."""
    return sorted(k for k in c if k.startswith((
        "route.native", "route.fallback", "route.host",
        "device.host_answer", "fallback.")))


# ---------------------------------------------------------------------------
# byte identity + coalescing
# ---------------------------------------------------------------------------


def test_submit_decode_byte_identical_to_one_shot_api():
    data = kafka_style_datums(16, seed=1)
    direct = decode(data)
    p = ServePlane(workers=2)
    try:
        got = p.call("decode", data, KAFKA_SCHEMA_JSON, device=DEV,
                     timeout_s=30.0)
        assert got.equals(direct)
    finally:
        p.drain()


def test_submit_encode_byte_identical_to_one_shot_api():
    data = kafka_style_datums(10, seed=2)
    batch = decode(data)
    direct = pv.serialize_record_batch(batch, KAFKA_SCHEMA_JSON, 2,
                                       device=DEV)
    p = ServePlane(workers=1)
    try:
        got = p.call("encode", batch, KAFKA_SCHEMA_JSON, device=DEV,
                     num_chunks=2, timeout_s=30.0)
        assert got == direct
    finally:
        p.drain()


def test_coalesced_batch_splits_back_per_request():
    p = ServePlane(autostart=False)
    futs = []
    for i in range(5):
        futs.append(p.submit(
            "decode", kafka_style_datums(4, seed=100 + i),
            KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0))
    rep = p.drain()
    assert rep["accepted"] == 5 and rep["completed"] == 5
    for i, f in enumerate(futs):
        want = decode(kafka_style_datums(4, seed=100 + i))
        assert f.result(timeout=0).equals(want)
    # the five requests ran as ONE coalesced API call, not five
    assert counters().get("serve.coalesced", 0) == 5
    assert counters().get("serve.batches", 0) == 1


def test_coalesced_split_value_identical_on_union_schema():
    # pyarrow's zero-copy slice corrupts sparse-union columns at non-zero
    # offsets while .equals() still passes: the split must take() on
    # union-bearing schemas so the VALUES match a direct call
    data = kafka_style_datums(200, seed=21)
    direct = pa.Table.from_batches([decode(data)]).to_pylist()
    p = ServePlane(autostart=False)
    futs = [p.submit("decode", data[i * 20:(i + 1) * 20],
                     KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
            for i in range(10)]
    p.drain()
    assert counters().get("serve.batches", 0) == 1  # one coalesced call
    got = []
    for f in futs:
        got.extend(pa.Table.from_batches([f.result(timeout=0)])
                   .to_pylist())
    assert got == direct


def test_coalescing_respects_max_batch_rows(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_MAX_BATCH_ROWS", "6")
    p = ServePlane(autostart=False)
    futs = [p.submit("decode", kafka_style_datums(4, seed=200 + i),
                     KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
            for i in range(4)]
    p.drain()
    for f in futs:
        assert f.result(timeout=0).num_rows == 4
    # 4 rows/request under a 6-row cap -> no two requests coalesce
    assert counters().get("serve.batches", 0) == 4


def test_coalesced_quarantine_rebases_to_caller_indices():
    entry = get_or_parse_schema(FLAT_SCHEMA)
    d1 = random_datums(entry.ir, 5, seed=11)
    d1[2] = b""  # never decodes a record with a non-null field
    d2 = random_datums(entry.ir, 4, seed=12)
    d2[1] = b""
    direct1 = decode(d1, FLAT_SCHEMA, on_error="skip", return_errors=True)
    direct2 = decode(d2, FLAT_SCHEMA, on_error="skip", return_errors=True)
    p = ServePlane(autostart=False)
    f1 = p.submit("decode", d1, FLAT_SCHEMA, device=DEV, on_error="skip",
                  return_errors=True, timeout_s=30.0)
    f2 = p.submit("decode", d2, FLAT_SCHEMA, device=DEV, on_error="skip",
                  return_errors=True, timeout_s=30.0)
    p.drain()
    assert counters().get("serve.batches", 0) == 1  # they coalesced
    b1, q1 = f1.result(timeout=0)
    b2, q2 = f2.result(timeout=0)
    # indices are each caller's OWN record indices, not batch offsets
    assert [q.index for q in q1] == [2]
    assert [q.index for q in q2] == [1]
    assert [q.tier for q in q1 + q2] == ["device", "device"]
    assert b1.equals(direct1[0]) and b2.equals(direct2[0])
    assert [q.index for q in direct1[1]] == [2]


# ---------------------------------------------------------------------------
# deadlines from enqueue
# ---------------------------------------------------------------------------


def test_queue_wait_counts_against_timeout_and_sheds_without_decode():
    p = ServePlane(autostart=False)
    f = p.submit("decode", kafka_style_datums(3, seed=5),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=0.05)
    time.sleep(0.12)  # expire IN the queue; no worker ever ran
    p.drain()
    with pytest.raises(DeadlineExceeded) as ei:
        f.result(timeout=0)
    assert ei.value.site == "serve_queue"
    assert ei.value.budget_s == pytest.approx(0.05)
    assert ei.value.elapsed_s >= 0.05
    c = counters()
    assert c.get("serve.expired", 0) == 1
    # the expired request never reached a decode path
    assert c.get("serve.batches", 0) == 0
    assert c.get("serve.serial_calls", 0) == 0


def test_live_requests_keep_their_remaining_budget():
    p = ServePlane(autostart=False)
    f = p.submit("decode", kafka_style_datums(3, seed=6),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
    p.drain()
    assert f.result(timeout=0).num_rows == 3


# ---------------------------------------------------------------------------
# backpressure: shed + block
# ---------------------------------------------------------------------------


def test_shed_policy_rejects_with_structured_overloaded(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", "shed")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_QUEUE", "2")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_TENANT_SHARE", "0")
    # teach the cost model this schema so the rejection carries a
    # predicted-drain retry hint
    decode(kafka_style_datums(50, seed=1))
    p = ServePlane(autostart=False)
    for i in range(2):
        p.submit("decode", kafka_style_datums(2, seed=i),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0,
                 tenant="acme")
    with pytest.raises(Overloaded) as ei:
        p.submit("decode", kafka_style_datums(2, seed=9),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0,
                 tenant="acme")
    e = ei.value
    assert e.reason == "queue_full"
    assert e.tenant == "acme"
    assert e.queued == 2
    assert e.retry_after_s is not None and e.retry_after_s > 0
    c = counters()
    assert c.get("serve.shed.queue_full", 0) == 1
    assert c.get("serve.shed", 0) == 1
    assert metrics.mark_age("serve_shed") is not None
    assert metrics.mark_age("queue_saturated") is not None
    rep = p.drain()
    assert rep["accepted"] == 2 and rep["shed"] == 1


def test_block_policy_waits_for_space_then_admits(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", "block")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_QUEUE", "1")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_ENQUEUE_WAIT_S", "5")
    p = ServePlane(autostart=False)
    p.submit("decode", kafka_style_datums(2, seed=1),
             KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
    done = threading.Event()
    res = {}

    def second():
        try:
            res["f"] = p.submit("decode", kafka_style_datums(2, seed=2),
                                KAFKA_SCHEMA_JSON, device=DEV,
                                timeout_s=30.0)
        except BaseException as e:  # pragma: no cover - failure detail
            res["err"] = e
        done.set()

    t = threading.Thread(target=second, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not done.is_set()  # still blocked on the full queue
    p.start_workers()  # workers free the slot; the submit completes
    assert done.wait(timeout=10), "blocked submit never admitted"
    assert "err" not in res, res.get("err")
    p.drain()
    assert res["f"].result(timeout=0).num_rows == 2


def test_block_policy_enqueue_timeout_is_structured(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", "block")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_QUEUE", "1")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_ENQUEUE_WAIT_S", "0.05")
    p = ServePlane(autostart=False)
    p.submit("decode", kafka_style_datums(2, seed=1),
             KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
    with pytest.raises(Overloaded) as ei:
        p.submit("decode", kafka_style_datums(2, seed=2),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
    assert ei.value.reason == "enqueue_timeout"
    assert counters().get("serve.shed.enqueue_timeout", 0) == 1
    p.drain()


def test_tenant_share_cap_protects_other_tenants(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", "shed")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_QUEUE", "8")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_TENANT_SHARE", "0.5")
    p = ServePlane(autostart=False)
    flood_shed = 0
    for i in range(8):
        try:
            p.submit("decode", kafka_style_datums(1, seed=i),
                     KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0,
                     tenant="flood")
        except Overloaded as e:
            assert e.reason == "tenant_share"
            flood_shed += 1
    assert flood_shed > 0, "flood tenant never hit the fairness cap"
    # a well-behaved tenant still gets in past the flood
    f = p.submit("decode", kafka_style_datums(1, seed=99),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0,
                 tenant="ok")
    p.drain()
    assert f.result(timeout=0).num_rows == 1
    assert counters().get("serve.shed.tenant_share", 0) == flood_shed


# ---------------------------------------------------------------------------
# brownout ladder
# ---------------------------------------------------------------------------


def test_brownout_rungs_engage_and_auto_recover(monkeypatch):
    monkeypatch.delenv("PYRUHVRO_TPU_NO_AUDIT")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", "shed")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_QUEUE", "4")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_BROWNOUT", "0.1")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_BROWNOUT_SUSTAIN", "1")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_TENANT_SHARE", "0")
    p = ServePlane(autostart=False)
    serving._plane = p  # expose to healthz/snapshot (reset clears it)
    for i in range(4):
        p.submit("decode", kafka_style_datums(1, seed=i),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
    time.sleep(0.03)  # past the tick throttle
    with pytest.raises(Overloaded):
        p.submit("decode", kafka_style_datums(1, seed=9),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
    # pressure 1.0 over one sustained tick: the WHOLE ladder engages
    assert p.engaged_rungs() == ("audit", "sampling", "explore",
                                 "tenant")
    assert audit.enabled() is False
    assert sampling.enabled() is False
    assert costmodel.explore_rate() == 0.0
    c = counters()
    for rung in serving.BROWNOUT_RUNGS:
        assert c.get("serve.brownout." + rung, 0) == 1
    assert metrics.mark_age("serve_brownout") is not None
    # the degraded bit is visible on /healthz while rungs are engaged
    code, body = obs_server.health()
    assert body["degraded_bits"]["brownout"] == list(
        serving.BROWNOUT_RUNGS)
    # drain the backlog, then tick again: pressure is gone, every rung
    # auto-releases and the process-wide overrides are restored
    p.start_workers()
    deadline_t = time.monotonic() + 30
    while p.engaged_rungs() and time.monotonic() < deadline_t:
        time.sleep(0.05)
    assert p.engaged_rungs() == ()
    assert audit.enabled() is True  # knob-driven again
    assert costmodel.explore_rate() > 0.0
    c = counters()
    for rung in serving.BROWNOUT_RUNGS:
        assert c.get("serve.brownout_release." + rung, 0) == 1
    occ = p.snapshot()["brownout"]["occupancy_s"]
    assert all(occ[r] > 0 for r in serving.BROWNOUT_RUNGS)
    p.drain()


def test_brownout_tenant_rung_sheds_flood_tenant(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", "shed")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_TENANT_SHARE", "0.5")
    # > 1 disables the ladder's own evaluation so the hand-engaged
    # rung below isn't auto-released by the zero-pressure tick
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_BROWNOUT", "2")
    # make "flood" a heavy hitter in the accounting sketch
    from pyruhvro_tpu_torch.runtime import memacct

    fp = get_or_parse_schema(KAFKA_SCHEMA_JSON).fingerprint
    memacct.attribute("flood", fp, "decode", 1000, 10_000_000)
    p = ServePlane(autostart=False)
    p._brownout._engaged_at["tenant"] = time.monotonic()
    with pytest.raises(Overloaded) as ei:
        p.submit("decode", kafka_style_datums(1, seed=1),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0,
                 tenant="flood")
    assert ei.value.reason == "tenant_flood"
    # untagged and well-behaved traffic still admits
    f = p.submit("decode", kafka_style_datums(1, seed=2),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0,
                 tenant="ok")
    p.drain()
    assert f.result(timeout=0).num_rows == 1


# ---------------------------------------------------------------------------
# zero-loss drain + accounting
# ---------------------------------------------------------------------------


def test_drain_accounting_drained_equals_accepted_minus_shed(
        monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", "shed")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_QUEUE", "3")
    p = ServePlane(autostart=False)
    futs, shed = [], 0
    for i in range(5):
        try:
            futs.append(p.submit(
                "decode", kafka_style_datums(2, seed=i),
                KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0))
        except Overloaded:
            shed += 1
    rep = p.drain()
    assert shed == 2 and rep["accepted"] == 3
    # every request resolved DURING drain counts as drained
    c = counters()
    assert c.get("serve.drained", 0) == len(futs)
    assert rep["drained"] == rep["accepted"]
    assert rep["accepted"] == rep["completed"] + rep["failed"]
    for f in futs:
        assert f.result(timeout=0).num_rows == 2
    # second drain is an idempotent no-op
    assert p.drain()["accepted"] == 3


def test_drain_timeout_resolves_leftovers_structured(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_QUEUE", "64")
    p = ServePlane(autostart=False)
    futs = [p.submit("decode", kafka_style_datums(1, seed=i),
                     KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
            for i in range(3)]
    # pretend workers exist, so that the drain takes its timed path
    # instead of the inline flush
    p._threads = [threading.Thread(target=lambda: None)]
    p._threads[0].start()
    rep = p.drain(timeout_s=0.0)
    assert rep["queued"] == 0
    for f in futs:
        with pytest.raises(Overloaded) as ei:
            f.result(timeout=0)
        assert ei.value.reason == "drain_aborted"
    assert counters().get("serve.drain_aborted", 0) == 3
    # structured-failed, not lost: the accounting still balances
    assert rep["accepted"] == rep["completed"] + rep["failed"] == 3


def test_zero_loss_property_under_load_and_faults(monkeypatch):
    """Randomized zero-loss check: every submitted request terminates
    exactly once — a result, an Overloaded shed, or a structured error
    — even with admission+worker chaos and a mid-load drain."""
    import random

    rng = random.Random(1234)
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", "shed")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_QUEUE", "4")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_COALESCE_S", "0.001")
    monkeypatch.setenv(
        "PYRUHVRO_TPU_FAULTS",
        "serve_worker:error:0.4:3,serve_enqueue:error:0.1:5")
    p = ServePlane(workers=2)
    futs, shed, submitted = [], 0, 0
    for i in range(40):
        submitted += 1
        try:
            futs.append(p.submit(
                "decode",
                kafka_style_datums(rng.randint(1, 4), seed=i),
                KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0,
                tenant=rng.choice([None, "a", "b"])))
        except Overloaded:
            shed += 1
        if i == 30:
            threading.Thread(target=p.drain, daemon=True).start()
    rep = p.drain()
    results = failures = 0
    for f in futs:
        assert f.done(), "a request was lost (future never resolved)"
        if f.exception() is None:
            assert f.result().num_rows >= 1
            results += 1
        else:
            assert isinstance(f.exception(),
                              (Overloaded, DeadlineExceeded))
            failures += 1
    assert results + failures + shed == submitted
    c = counters()
    assert c.get("serve.double_resolve", 0) == 0
    assert rep["accepted"] == rep["completed"] + rep["failed"]
    # submitted = admitted + shed + served-directly-on-degrade
    assert (rep["accepted"] + c.get("serve.shed", 0)
            + c.get("serve.enqueue_degraded", 0)) == submitted


# ---------------------------------------------------------------------------
# SIGTERM/SIGINT drain
# ---------------------------------------------------------------------------


def test_signal_drain_completes_inflight_then_accounts():
    prev = {s: signal.getsignal(s)
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        p = serving.start(workers=1)
        assert serving.install_drain_signal(exit_after=False)
        futs = [p.submit("decode", kafka_style_datums(2, seed=i),
                         KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
                for i in range(4)]
        signal.raise_signal(signal.SIGTERM)
        deadline_t = time.monotonic() + 30
        while serving.plane() is not None and time.monotonic() < deadline_t:
            time.sleep(0.02)
        assert serving.plane() is None, "signal drain never completed"
        for f in futs:
            assert f.result(timeout=10).num_rows == 2  # none lost
        c = counters()
        assert c.get("serve.signal_drain", 0) == 1  # flushed off-handler
        assert c.get("serve.drain", 0) == 1
    finally:
        serving._drain_signal_installed = False
        for s, h in prev.items():
            signal.signal(s, h)


def test_install_drain_signal_handler_is_signal_safe():
    """The registered handler body calls nothing but DeferredCount.bump /
    list.append / Event.set (no locks, no metrics.inc, no I/O)."""
    import ast
    import inspect
    import textwrap

    src = textwrap.dedent(inspect.getsource(serving.install_drain_signal))
    tree = ast.parse(src)
    handler = next(n for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)
                   and n.name == "handler")
    calls = {ast.unparse(c.func) for c in ast.walk(handler)
             if isinstance(c, ast.Call)}
    assert calls <= {"_signal_drains.bump", "received.append",
                     "fired.set"}, calls


# ---------------------------------------------------------------------------
# chaos seams
# ---------------------------------------------------------------------------


def test_serve_enqueue_fault_degrades_to_direct_call(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "serve_enqueue:error:1.0")
    data = kafka_style_datums(6, seed=3)
    direct = decode(data)
    p = ServePlane(autostart=False)
    f = p.submit("decode", data, KAFKA_SCHEMA_JSON, device=DEV,
                 timeout_s=30.0)
    assert f.result(timeout=0).equals(direct)  # resolved synchronously
    c = counters()
    assert c.get("serve.enqueue_degraded", 0) == 1
    assert c.get("serve.accepted", 0) == 0  # the queue was bypassed
    p.drain()


def test_serve_worker_fault_drains_to_serial_byte_identical(
        monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "serve_worker:error:1.0")

    def one_round():
        p = ServePlane(autostart=False)
        futs = [p.submit("decode", kafka_style_datums(3, seed=40 + i),
                         KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
                for i in range(3)]
        p.drain()
        for i, f in enumerate(futs):
            want = decode(kafka_style_datums(3, seed=40 + i))
            assert f.result(timeout=0).equals(want)

    one_round()  # 1st coalesce failure -> serial fallback
    c = counters()
    assert c.get("serve.worker_degraded", 0) == 1
    assert c.get("serve.serial_calls", 0) == 3
    one_round()  # 2nd failure trips the breaker (threshold 2)
    assert breaker.get("serve_worker").state() == "open"
    one_round()  # open breaker: coalescing withheld, straight serial
    c = counters()
    assert c.get("serve.breaker_serial", 0) >= 1
    assert c.get("serve.worker_degraded", 0) == 2
    assert c.get("serve.serial_calls", 0) == 9


def test_data_error_in_coalesced_batch_isolated_to_guilty_request():
    entry = get_or_parse_schema(FLAT_SCHEMA)
    good = random_datums(entry.ir, 3, seed=21)
    bad = random_datums(entry.ir, 3, seed=22)
    bad[1] = b""
    p = ServePlane(autostart=False)
    fg = p.submit("decode", good, FLAT_SCHEMA, device=DEV, timeout_s=30.0)
    fb = p.submit("decode", bad, FLAT_SCHEMA, device=DEV, timeout_s=30.0)
    p.drain()
    # on_error="raise": the coalesced attempt fails as a whole, the
    # serial retry isolates the malformed datum to its own caller
    assert fg.result(timeout=0).num_rows == 3
    with pytest.raises(MalformedAvro) as ei:
        fb.result(timeout=0)
    assert ei.value.tier == "device"
    assert counters().get("serve.batch_isolate", 0) == 1


# ---------------------------------------------------------------------------
# observability surfaces
# ---------------------------------------------------------------------------


def test_serving_section_in_snapshot_and_serve_endpoint():
    p = serving.start(workers=1)
    p.call("decode", kafka_style_datums(3, seed=7),
           KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
    snap = telemetry.snapshot()
    assert snap["serving"]["accepted"] == 1
    assert snap["serving"]["policy"] in ("block", "shed")
    srv = obs_server.ObsServer().start()
    try:
        code, sv = _get(srv.url + "/serve")
        assert code == 200 and sv["accepted"] == 1
        # static snapshot server renders the saved serving section
        srv2 = obs_server.ObsServer(snapshot=json.loads(
            json.dumps(snap, default=str))).start()
        try:
            code2, sv2 = _get(srv2.url + "/serve")
            assert code2 == 200 and sv2["accepted"] == 1
        finally:
            srv2.stop()
        # a pre-serving snapshot degrades to a note, not a 500
        srv3 = obs_server.ObsServer(
            snapshot={"counters": {}, "histograms": {}}).start()
        try:
            code3, sv3 = _get(srv3.url + "/serve")
            assert code3 == 200 and sv3["static"] is True
        finally:
            srv3.stop()
        code, body = _get(srv.url + "/healthz")
        assert "queue_saturated" in body["unhealthy_bits"]
        assert "shedding" in body["degraded_bits"]
        assert "brownout" in body["degraded_bits"]
    finally:
        srv.stop()


def test_shedding_flips_healthz_degraded(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", "shed")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_QUEUE", "1")
    p = ServePlane(autostart=False)
    p.submit("decode", kafka_style_datums(1, seed=1),
             KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
    with pytest.raises(Overloaded):
        p.submit("decode", kafka_style_datums(1, seed=2),
                 KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
    code, body = obs_server.health()
    assert body["degraded_bits"]["shedding"] is True
    assert body["unhealthy_bits"]["queue_saturated"] is True
    assert code == 503
    p.drain()


def test_serve_report_cli_contract(tmp_path, capsys):
    p = serving.start(workers=1)
    p.call("decode", kafka_style_datums(3, seed=8),
           KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
    snap = telemetry.snapshot()
    fn = tmp_path / "snap.json"
    fn.write_text(json.dumps(snap, default=str))
    assert telemetry.main(["serve-report", str(fn)]) == 0
    out = capsys.readouterr().out
    assert "serving plane" in out and "accepted 1" in out
    # the report's pointer to it
    assert telemetry.main(["report", str(fn)]) == 0
    assert "render with the serve-report subcommand" in \
        capsys.readouterr().out
    # exit-2 contract: missing file / not-a-snapshot
    assert telemetry.main(["serve-report",
                           str(tmp_path / "nope.json")]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"foo": 1}))
    assert telemetry.main(["serve-report", str(bad)]) == 2
    # legacy snapshot (pre-serving): renders the degradation note
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps({"counters": {}, "histograms": {}}))
    assert telemetry.main(["serve-report", str(legacy)]) == 0
    assert "no serving section" in capsys.readouterr().out


def test_snapshot_omits_serving_section_when_no_plane_ran():
    assert serving.plane() is None
    assert "serving" not in telemetry.snapshot()
    assert serving.snapshot_serving() == {}


# ---------------------------------------------------------------------------
# Arrow Flight front door
# ---------------------------------------------------------------------------


def _flight_put(client, fl, cmd: dict, data):
    wire = pa.record_batch([pa.array(data, type=pa.binary())],
                           names=["wire"])
    writer, meta = client.do_put(
        fl.FlightDescriptor.for_command(json.dumps(cmd).encode()),
        wire.schema)
    writer.write_batch(wire)
    writer.done_writing()
    ticket = meta.read().to_pybytes().decode()
    writer.close()
    return ticket


def test_flight_unavailable_is_counted_noop(monkeypatch):
    from pyruhvro_tpu_torch.serving import flight as sfl

    monkeypatch.setattr(sfl, "flight_available", lambda: False)
    assert sfl.start_flight_server() is None
    assert counters().get("serve.flight_unavailable", 0) == 1


def test_flight_round_trip_with_tenant_and_trace():
    fl = pytest.importorskip("pyarrow.flight")
    from pyruhvro_tpu_torch.serving import flight as sfl

    server = sfl.start_flight_server("grpc://127.0.0.1:0")
    assert server is not None
    try:
        client = fl.connect(f"grpc://127.0.0.1:{server.port}")
        data = kafka_style_datums(8, seed=9)
        ticket = _flight_put(client, fl, {
            "schema": KAFKA_SCHEMA_JSON, "tenant": "acme", "device": DEV,
            "traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
            "timeout_s": 30.0}, data)
        table = client.do_get(fl.Ticket(ticket.encode())).read_all()
        direct = decode(data)
        assert table.to_pylist() == pa.Table.from_batches(
            [direct]).to_pylist()
        assert counters().get("serve.accepted", 0) >= 1
        # an unknown ticket is an RPC error, not a server death
        with pytest.raises(fl.FlightError):
            client.do_get(fl.Ticket(b"bogus")).read_all()
        assert counters().get("serve.flight_get", 0) == 2
    finally:
        server.shutdown()
        serving.stop()


def test_flight_fault_fails_rpc_but_server_survives(monkeypatch):
    fl = pytest.importorskip("pyarrow.flight")
    from pyruhvro_tpu_torch.serving import flight as sfl

    server = sfl.start_flight_server("grpc://127.0.0.1:0")
    try:
        client = fl.connect(f"grpc://127.0.0.1:{server.port}")
        data = kafka_style_datums(4, seed=10)
        cmd = {"schema": KAFKA_SCHEMA_JSON, "timeout_s": 30.0,
               "device": DEV}
        wire = pa.record_batch([pa.array(data, type=pa.binary())],
                               names=["wire"])
        monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "serve_flight:error:1.0")
        with pytest.raises(fl.FlightError):
            writer, meta = client.do_put(
                fl.FlightDescriptor.for_command(json.dumps(cmd).encode()),
                wire.schema)
            writer.write_batch(wire)
            writer.done_writing()
            meta.read()
            writer.close()
        assert counters().get("serve.flight_degraded", 0) >= 1
        monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "")
        ticket = _flight_put(client, fl, cmd, data)
        table = client.do_get(fl.Ticket(ticket.encode())).read_all()
        assert table.num_rows == 4
    finally:
        server.shutdown()
        serving.stop()


def test_flight_spec_defaults_to_the_card(monkeypatch):
    """The Flight spec's backend defaults to ``"device"`` and its device
    to ``"cuda"``: with no card here the decode fails that one RPC with
    the card's ``RuntimeError``, and nothing is answered on the host."""
    fl = pytest.importorskip("pyarrow.flight")
    from pyruhvro_tpu_torch.serving import flight as sfl

    server = sfl.start_flight_server("grpc://127.0.0.1:0")
    try:
        client = fl.connect(f"grpc://127.0.0.1:{server.port}")
        data = kafka_style_datums(4, seed=10)
        ticket = _flight_put(client, fl, {"schema": KAFKA_SCHEMA_JSON,
                                          "timeout_s": 30.0}, data)
        with pytest.raises(fl.FlightError, match="RuntimeError"):
            client.do_get(fl.Ticket(ticket.encode())).read_all()
        assert host_counted(counters()) == []
        snap = serving.plane().snapshot()
        assert snap["failed"] == 1
    finally:
        server.shutdown()
        serving.stop()


# ---------------------------------------------------------------------------
# module-level lifecycle
# ---------------------------------------------------------------------------


def test_start_is_idempotent_and_restartable():
    p1 = serving.start(workers=1)
    assert serving.start() is p1
    serving.stop()
    p2 = serving.start(workers=1)
    assert p2 is not p1
    serving.stop()


def test_reset_restores_brownout_overrides():
    audit.set_enabled(False)
    sampling.set_enabled(False)
    costmodel.set_explore_override(0.0)
    serving.reset()
    assert costmodel.explore_rate() > 0.0
    # knob-driven defaults again (not the forced False)
    assert sampling.enabled() in (True, False)


# ---------------------------------------------------------------------------
# the serving seams of the chaos matrix: serve_enqueue / serve_worker x
# backpressure policy, and the breaker's half-open recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["block", "shed"])
def test_serve_worker_error_cell_serial_fallback_byte_identical(
        chaos, monkeypatch, policy):
    """error x {block,shed}: a crashing coalesced batch degrades to the
    per-request serial path — byte-identical output, counted, and the
    repeated failure opens the serve_worker breaker."""
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", policy)
    chaos("serve_worker:error:1")
    for round_no in range(2):  # threshold 2: second round opens it
        plane = ServePlane(autostart=False)
        futs = [plane.submit(
            "decode", kafka_style_datums(4, seed=60 + i),
            KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
            for i in range(3)]
        plane.drain()
        for i, f in enumerate(futs):
            want = decode(kafka_style_datums(4, seed=60 + i))
            assert f.result(timeout=0).equals(want)
    c = metrics.snapshot()
    assert c.get("fault.injected.serve_worker") == 2.0, c
    assert c.get("serve.worker_degraded") == 2.0, c
    assert breaker.get("serve_worker").state() == "open"


@pytest.mark.parametrize("policy", ["block", "shed"])
def test_serve_worker_hang_cell_watchdog_trips_breaker(
        chaos, monkeypatch, policy):
    """hang x {block,shed}: a WEDGED coalesced batch is bounded by the
    batch stall watchdog, not by the members' (much larger) budgets;
    survivors drain to the serial path, byte-identical."""
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", policy)
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_BATCH_TIMEOUT_S", "0.05")
    chaos("serve_worker:hang:1", hang_s=0.3)
    plane = ServePlane(autostart=False)
    futs = [plane.submit(
        "decode", kafka_style_datums(4, seed=70 + i),
        KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0) for i in range(3)]
    t0 = time.perf_counter()
    plane.drain()
    dt = time.perf_counter() - t0
    for i, f in enumerate(futs):
        want = decode(kafka_style_datums(4, seed=70 + i))
        assert f.result(timeout=0).equals(want)
    assert dt < 10.0  # hung once for 0.3 s, then bounded — not wedged
    c = metrics.snapshot()
    assert c.get("fault.injected.serve_worker") == 1.0, c
    assert c.get("serve.worker_degraded") == 1.0, c
    assert c.get("serve.expired") is None, c


@pytest.mark.parametrize("policy", ["block", "shed"])
def test_serve_enqueue_cell_direct_bypass(chaos, monkeypatch, policy):
    """An admission fault serves the call DIRECTLY (queue bypassed),
    byte-identical under either policy."""
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", policy)
    chaos("serve_enqueue:error:1")
    data = kafka_style_datums(6, seed=80)
    want = decode(data)
    plane = ServePlane(autostart=False)
    f = plane.submit("decode", data, KAFKA_SCHEMA_JSON, device=DEV,
                     timeout_s=30.0)
    assert f.result(timeout=0).equals(want)
    plane.drain()
    c = metrics.snapshot()
    assert c.get("fault.injected.serve_enqueue") == 1.0, c
    assert c.get("serve.enqueue_degraded") == 1.0, c


def test_serve_breaker_reopens_coalescing_after_recovery(
        chaos, monkeypatch):
    """After the fault clears and the backoff elapses, the half-open
    probe re-admits coalescing."""
    br = breaker.get("serve_worker")
    br.force_open(backoff_s=0.02)
    plane = ServePlane(autostart=False)
    futs = [plane.submit(
        "decode", kafka_style_datums(2, seed=90 + i),
        KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0) for i in range(2)]
    plane.drain()  # open breaker -> serial, still correct
    for f in futs:
        assert f.result(timeout=0).num_rows == 2
    assert metrics.snapshot().get("serve.breaker_serial") == 1.0
    time.sleep(0.05)  # backoff elapses -> half-open
    plane2 = ServePlane(autostart=False)
    futs2 = [plane2.submit(
        "decode", kafka_style_datums(2, seed=95 + i),
        KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0) for i in range(2)]
    plane2.drain()
    for f in futs2:
        assert f.result(timeout=0).num_rows == 2
    # the probe batch succeeded: the seam is closed again
    assert breaker.get("serve_worker").state() == "closed"
    assert metrics.snapshot().get("serve.coalesced") == 2.0


# ---------------------------------------------------------------------------
# the reference's ServePlane and the port's on the same requests
# ---------------------------------------------------------------------------


def _requests():
    """Eight seeded requests: two tenants, poisoned members under
    ``"skip"``, a malformed member under ``"raise"``."""
    ir = get_or_parse_schema(FLAT_SCHEMA).ir
    reqs = []
    for i in range(8):
        data = random_datums(ir, 3 + i, seed=300 + i)
        on_error = "skip" if i % 3 == 0 else "raise"
        if i in (0, 3):
            data[1 + i // 3] = b""  # quarantined under "skip"
        if i == 5:
            data[2] = b"\x01"  # raises under "raise"
        reqs.append((data, on_error, "t%d" % (i % 2)))
    return reqs


def _scenario(plane_cls, schema, reqs, **kw):
    """The requests through a plane on ``backend="host"``, then the
    drain. Returns each request's outcome and the plane's report."""
    plane = plane_cls(autostart=False)
    outcomes = []
    for data, on_error, tenant in reqs:
        try:
            fut = plane.submit("decode", data, schema, on_error=on_error,
                               return_errors=on_error == "skip",
                               tenant=tenant, timeout_s=30.0,
                               backend="host", **kw)
        except Exception as e:  # noqa: BLE001 — compared below
            outcomes.append(("shed", e.reason, e.queued))
            continue
        outcomes.append(fut)
    rep = plane.drain()
    out = []
    for o in outcomes:
        if isinstance(o, tuple):
            out.append(o)
            continue
        e = o.exception(timeout=0)
        if e is not None:
            out.append(("error", type(e).__name__, str(e)))
            continue
        res = o.result(timeout=0)
        if isinstance(res, tuple):
            batch, quar = res
            out.append(("ok", batch.to_pylist(),
                        [(q.index, q.error, q.tier) for q in quar]))
        else:
            out.append(("ok", res.to_pylist(), None))
    return out, rep


def _serve_counts(c):
    keys = ("serve.submitted", "serve.accepted", "serve.completed",
            "serve.failed", "serve.coalesced", "serve.drained",
            "serve.batches", "serve.batch_isolate", "serve.serial_calls",
            "serve.shed")
    out = {k: c.get(k, 0) for k in keys}
    out.update({k: v for k, v in c.items() if k.startswith("serve.shed.")})
    return out


@pytest.mark.parametrize("tenant_share,shed_by", [("0", "queue_full"),
                                                  ("0.5", "tenant_share")])
def test_same_requests_same_results_as_the_reference(monkeypatch,
                                                     tenant_share, shed_by):
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_POLICY", "shed")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_QUEUE", "2")
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_TENANT_SHARE", tenant_share)
    monkeypatch.setenv("PYRUHVRO_TPU_SERVE_BROWNOUT", "2")
    reqs = _requests()
    want, want_rep = _scenario(ref_serving.ServePlane, FLAT_SCHEMA, reqs)
    ref_counts = _serve_counts(ref_metrics.snapshot())
    got, got_rep = _scenario(ServePlane, FLAT_SCHEMA, reqs, device=DEV)
    assert got == want
    assert got_rep == want_rep
    assert _serve_counts(counters()) == ref_counts
    # the scenario reaches the paths it names
    assert ("shed", shed_by) in [o[:2] for o in got]
    assert any(o[0] == "ok" and o[2] for o in got)  # a rebased entry
    if shed_by == "queue_full":
        assert ("error", "MalformedAvro") in [o[:2] for o in got]


# ---------------------------------------------------------------------------
# the departures: device faults reach every member; devices never mix
# ---------------------------------------------------------------------------


def test_launch_fault_in_a_coalesced_batch_reaches_every_member(chaos):
    chaos("device_launch:error:1")
    p = ServePlane(autostart=False)
    futs = [p.submit("decode", kafka_style_datums(3, seed=500 + i),
                     KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
            for i in range(3)]
    rep = p.drain()
    for f in futs:
        with pytest.raises(FaultInjected):
            f.result(timeout=0)
    assert rep["failed"] == 3 and rep["completed"] == 0
    c = counters()
    # the coalesced attempt failed as a card fault, each member then
    # failed in its own serial call on the card
    assert c.get("serve.worker_degraded", 0) == 1
    assert c.get("serve.serial_calls", 0) == 3
    assert c.get("fault.injected.device_launch", 0) >= 4
    assert c.get("route.device", 0) >= 4
    assert host_counted(c) == []


def test_requests_for_different_devices_never_coalesce():
    p = ServePlane(autostart=False)
    cpu = [p.submit("decode", kafka_style_datums(2, seed=600 + i),
                    KAFKA_SCHEMA_JSON, device=DEV, timeout_s=30.0)
           for i in range(2)]
    card = [p.submit("decode", kafka_style_datums(2, seed=610 + i),
                     KAFKA_SCHEMA_JSON, device="cuda", timeout_s=30.0)
            for i in range(2)]
    queues = p.snapshot()["queues"]
    assert sorted(q["device"] for q in queues) == ["cpu", "cuda"]
    assert all(q["queued"] == 2 for q in queues)
    p.drain()
    c = counters()
    assert c.get("serve.batches", 0) == 2
    assert c.get("serve.coalesced", 0) == 2  # the CPU pair only
    for i, f in enumerate(cpu):
        assert f.result(timeout=0).equals(
            decode(kafka_style_datums(2, seed=600 + i)))
    # no card here: each "cuda" request fails on its own, on the card's
    # path, and nothing answers it on the host
    for f in card:
        with pytest.raises(RuntimeError):
            f.result(timeout=0)
    assert host_counted(counters()) == []
