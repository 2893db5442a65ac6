"""The port's process-pool arm (``PYRUHVRO_TPU_POOL=process``), on the CPU.

A chunked call of the host tier fans its chunks out to spawned worker
processes, each re-entering the port's API with ``backend="host"``. The
results must equal the shard arm's (the native tier), the thread arm's
(the oracle) and the reference's; a bad row's ``MalformedAvro`` must
carry the call's row index; ``on_error="skip"`` must give the
reference's entries; every worker's span and cost-model observations
must merge into the parent's snapshot; and a broken pool must open the
``process_pool`` breaker and serve on the parent's own path, counted and
marked degraded. One spawn pool serves the module (2-3 chunks, so 2-3
workers), and is shut down at its end. The reference runs without the
pool (its results do not depend on it). Decode and encode are integer
and byte work: the tolerance is 0.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import pyruhvro_tpu as ref  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    breaker,
    costmodel,
    metrics,
    pool,
    router,
    telemetry,
)
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

KAFKA = datagen.KAFKA_SCHEMA_JSON
NULLABLE = datagen.CRITERION_SHAPES["nullable_primitives"]
TP = "00-" + "5c" * 16 + "-" + "b2" * 8 + "-01"
ROWS = 300


@pytest.fixture(scope="module", autouse=True)
def spawn_pool():
    """The module's spawn pool, stopped at the end."""
    yield
    pool.shutdown_process_pool()


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Both packages' telemetry cleared, the routing knobs unset, the
    reference's raw-program arm (which the port's native tier is)."""
    for name in ("PYRUHVRO_TPU_POOL", "PYRUHVRO_TPU_AUTOTUNE",
                 "PYRUHVRO_TPU_NO_NATIVE", "PYRUHVRO_TPU_MAX_DATUM_BYTES",
                 "PYRUHVRO_TPU_TRACEPARENT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    monkeypatch.setenv("PYRUHVRO_TPU_NO_SPECIALIZE", "1")
    monkeypatch.setenv("PYRUHVRO_TPU_NO_OPT", "1")
    telemetry.reset()
    ref.telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def data():
    return datagen.kafka_style_datums(ROWS, seed=21)


def poisoned(data, seed):
    """``data`` with a few rows at numpy-drawn positions replaced by
    ``b"\\x01"``; returns the datums and the planted rows."""
    bad = sorted(int(i) for i in np.random.default_rng(seed).choice(
        len(data), 4, replace=False))
    out = list(data)
    for i in bad:
        out[i] = b"\x01"
    return out, bad


def same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.to_pylist() == w.to_pylist()


def fields(entries):
    return [(q.index, q.datum, q.error, q.tier) for q in entries]


def on_process(monkeypatch, call):
    """``call()`` with ``PYRUHVRO_TPU_POOL=process`` set in the parent only
    (the reference reads the same variable)."""
    monkeypatch.setenv("PYRUHVRO_TPU_POOL", "process")
    try:
        return call()
    finally:
        monkeypatch.delenv("PYRUHVRO_TPU_POOL")


@pytest.mark.parametrize("chunks", [2, 3])
def test_process_results_are_the_shard_thread_and_reference(monkeypatch,
                                                            data, chunks):
    got = on_process(monkeypatch, lambda: port.deserialize_array_threaded(
        data, KAFKA, chunks, backend="host"))
    assert router.last_entry()["arm"] == f"native/c{chunks}/process"
    assert not router.last_entry().get("degraded")
    shard = port.deserialize_array_threaded(data, KAFKA, chunks,
                                            backend="host")
    assert router.last_entry()["arm"] == f"native/c{chunks}/shard"
    monkeypatch.setenv("PYRUHVRO_TPU_NO_NATIVE", "1")
    thread = port.deserialize_array_threaded(data, KAFKA, chunks,
                                             backend="host")
    assert router.last_entry()["arm"] == f"fallback/c{chunks}/thread"
    monkeypatch.delenv("PYRUHVRO_TPU_NO_NATIVE")
    want = ref.deserialize_array_threaded(data, KAFKA, chunks,
                                          backend="host")
    for other in (shard, thread, want):
        same(got, other)
    # encode: the chunks' wire equals the input datums on every arm
    batch = port.deserialize_array(data, KAFKA, backend="host")
    arrays = on_process(monkeypatch, lambda: port.serialize_record_batch(
        batch, KAFKA, chunks, backend="host"))
    assert router.last_entry()["arm"] == f"native/c{chunks}/process"
    wire = [d for a in arrays for d in a.to_pylist()]
    assert wire == data
    assert [a.to_pylist() for a in arrays] == \
        [a.to_pylist() for a in port.serialize_record_batch(
            batch, KAFKA, chunks, backend="host")] == \
        [a.to_pylist() for a in ref.serialize_record_batch(
            batch, KAFKA, chunks, backend="host")]
    assert metrics.snapshot()["pool.proc_fanouts"] == 2


def test_malformed_avro_carries_the_call_index(monkeypatch, data):
    bad_data, bad = poisoned(data, seed=3)
    with pytest.raises(port.MalformedAvro) as got:
        on_process(monkeypatch, lambda: port.deserialize_array_threaded(
            bad_data, KAFKA, 3, backend="host"))
    with pytest.raises(port.MalformedAvro) as want:
        port.deserialize_array_threaded(bad_data, KAFKA, 3, backend="host")
    # each worker names its own chunk's first bad row, so the global
    # index is the first chunk's with a bad row
    assert got.value.index == want.value.index == bad[0]
    assert (got.value.err_name, got.value.tier) == \
        (want.value.err_name, want.value.tier)
    c = metrics.snapshot()
    assert c["pool.worker_malformed"] == 1
    assert "pool.process_fallback" not in c
    assert router.snapshot_routing()["ledger"][0]["error"] == "MalformedAvro"


@pytest.mark.parametrize("policy", ["skip", "null"])
def test_tolerant_entries_are_the_reference(monkeypatch, data, policy):
    schema = KAFKA if policy == "skip" else NULLABLE
    rows = data if policy == "skip" else datagen.random_datums(
        get_or_parse_schema(NULLABLE).ir, ROWS, seed=5)
    bad_data, bad = poisoned(rows, seed=8)
    got, got_q = on_process(monkeypatch, lambda: port.deserialize_array_threaded(
        bad_data, schema, 3, backend="host", on_error=policy,
        return_errors=True))
    assert port.last_quarantine() == got_q
    shard, shard_q = port.deserialize_array_threaded(
        bad_data, schema, 3, backend="host", on_error=policy,
        return_errors=True)
    want, want_q = ref.deserialize_array_threaded(
        bad_data, schema, 3, backend="host", on_error=policy,
        return_errors=True)
    same(got, shard)
    same(got, want)
    assert fields(got_q) == fields(shard_q) == fields(want_q)
    assert [q.index for q in got_q] == bad
    c = metrics.snapshot()
    # the workers counted their entries once; the merge does not again
    assert c["decode.quarantined"] == 2 * len(bad)


def test_encode_skip_rechunks_the_survivors(monkeypatch):
    from decimal import Decimal

    import pyarrow as pa

    schema = ('{"type":"record","name":"D","fields":[{"name":"d","type":'
              '{"type":"fixed","name":"Fx","size":1,"logicalType":"decimal",'
              '"precision":3,"scale":0}}]}')
    vals = [Decimal(int(v)) for v in
            np.random.default_rng(1).integers(-100, 100, 60)]
    for i in (4, 33, 50):
        vals[i] = Decimal(300)  # does not fit one byte
    batch = pa.RecordBatch.from_pydict(
        {"d": pa.array(vals, pa.decimal128(3, 0))})
    got, got_q = on_process(monkeypatch, lambda: port.serialize_record_batch(
        batch, schema, 3, backend="host", on_error="skip",
        return_errors=True))
    want, want_q = ref.serialize_record_batch(
        batch, schema, 3, backend="host", on_error="skip", return_errors=True)
    assert [a.to_pylist() for a in got] == [a.to_pylist() for a in want]
    assert fields(got_q) == fields(want_q)
    assert [q.index for q in got_q] == [4, 33, 50]


def test_worker_spans_and_observations_merge(monkeypatch, data):
    on_process(monkeypatch, lambda: port.deserialize_array_threaded(
        data, KAFKA, 3, backend="host", trace_ctx=TP))
    snap = telemetry.snapshot()
    root = snap["spans"][-1]
    assert root["trace_id"] == "5c" * 16
    workers = [c for c in root["children"] if c["name"] == "pool.worker"]
    assert len(workers) == 3
    assert {w["trace_id"] for w in workers} == {"5c" * 16}
    assert sorted(w["attrs"]["rows"] for w in workers) == [100, 100, 100]
    assert os.getpid() not in {w["attrs"]["pid"] for w in workers}
    c = snap["counters"]
    assert c["pool.worker_merges"] == 3 and c["pool.worker_rows"] == ROWS
    assert c["router.worker_obs"] == 3
    arms = {(e["arm"], e["band"]) for e in snap["routing"]["model"]["entries"]}
    assert ("native/c1/none", costmodel.row_band(100)) in arms
    assert ("native/c3/process", costmodel.row_band(ROWS)) in arms
    # the workers' own API calls counted their decodes here too
    assert c["route.native"] == 4


class Broken:
    """An executor whose workers cannot start."""

    def submit(self, *_a, **_k):
        from concurrent.futures.process import BrokenProcessPool

        raise BrokenProcessPool("workers died")

    def shutdown(self, *_a, **_k):
        pass


def test_a_broken_pool_opens_the_breaker_and_degrades(monkeypatch, data):
    monkeypatch.setattr(pool, "_proc_pool", Broken())
    got = on_process(monkeypatch, lambda: port.deserialize_array_threaded(
        data, KAFKA, 3, backend="host"))
    same(got, ref.deserialize_array_threaded(data, KAFKA, 3, backend="host"))
    entry = router.last_entry()
    assert entry["arm"] == "native/c3/process" and entry["degraded"]
    assert breaker.get("process_pool").export()["state"] == "open"
    assert not pool.process_available()
    c = metrics.snapshot()
    assert c["pool.process_fallback"] == 1 and c["router.degraded"] == 1
    assert c["breaker.process_pool.opened"] == 1
    # the degraded call taught the model nothing about the process arm
    assert costmodel.obs_count(entry["schema"], "decode", entry["band"],
                               "native/c3/process") == 0
    # while open, the next call degrades at once, without a spawn
    bad_data, _bad = poisoned(data, seed=4)
    got, quar = on_process(monkeypatch, lambda: port.deserialize_array_threaded(
        bad_data, KAFKA, 3, backend="host", on_error="skip",
        return_errors=True))
    want, want_q = port.deserialize_array_threaded(
        bad_data, KAFKA, 3, backend="host", on_error="skip",
        return_errors=True)
    same(got, want)
    assert fields(quar) == fields(want_q)
    assert metrics.snapshot()["pool.process_fallback"] == 2
    assert telemetry.snapshot()["breakers"]["process_pool"]["state"] == "open"
