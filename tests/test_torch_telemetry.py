"""The port's observability base held against the reference's, on the CPU.

``pyruhvro_tpu_torch.runtime.telemetry``, ``metrics``, ``traceprop`` and
``device_obs`` against ``pyruhvro_tpu.runtime``'s: the same histogram
quantiles on the same seeded observations; the same traceparent parsing;
the same exporter text on the same snapshot; the same span trees (names,
nesting and child counts) and data-determined counters for the same
batches on the device tier (the port with ``device="cpu"``, the kernels'
plain versions; the reference with ``backend="tpu"``, its XLA programs on
JAX's CPU), the native tier (the reference's raw-program arm,
``PYRUHVRO_TPU_NO_SPECIALIZE=1 PYRUHVRO_TPU_NO_OPT=1``) and the oracle
(``PYRUHVRO_TPU_NO_NATIVE=1``); ``trace_ctx=`` on the five functions and
the quarantine's trace ids; disabled mode; results unchanged by
telemetry; worker payloads; the CLI and the trace file; the launch
recorder's events; the quarantine storm's threshold; K3's bytes only on
request; and a source scan. Data comes from numpy seeds and
``utils/datagen``. Counts and bytes are compared with tolerance 0;
seconds are never asserted.

Left out of the tree and counter comparisons, each by design
(``ROADMAP.md`` (c)):

* span attributes (names, nesting and child counts are compared): the
  reference's router adds ``route_arm``/``route_mode``/``route_obs_s``,
  the port's launch spans add each kernel's seconds and bytes;
* on a bucket's first launch the reference's AOT split gives a
  ``device.compile_s`` and a ``device.launch_s`` span, the port one
  ``device.compile_s`` (``mode="first_call"``);
* after a capacity retry the reference copies its packed input to the
  device again (``decode.h2d_s``, ``decode.h2d_bytes``: the launch
  donated it); the port's rungs read the same device buffer, so its tree
  and h2d bytes lack that copy;
* ``decode.d2h_bytes`` / ``device.d2h_bytes``: the port's blob carries
  ``STATUS_BYTES`` status bytes per launch after the reference's layout;
* the counters of planes the port does not have (``router.*``,
  ``sampling.*``, ``drift.*``, ``timeline.*``, ``schema_cache.*``),
  ``device.cost.*`` (the reference's XLA cost model; the port's kernel
  bounds, counted on the card only), ``device.capacity.plan_*`` (the
  reference's decoder misses its planner on calls the port's hits),
  ``device.arena.*`` (the port's pinned arenas are keyed per (R, B,
  slot)) and ``device.jit_cache.*`` / ``decode.compiles`` /
  ``decode.launches`` (per XLA executable in the reference, per decoder
  bucket in the port).
"""

import ast
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402
from pyruhvro_tpu.runtime import telemetry as ref_tel  # noqa: E402
from pyruhvro_tpu.runtime import traceprop as ref_tp  # noqa: E402

import chip_smoke  # noqa: E402
import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.ops import decode as dm  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    capacity,
    device_obs,
    metrics,
    telemetry,
    traceprop,
)
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KAFKA = datagen.KAFKA_SCHEMA_JSON
NESTED = chip_smoke.PIPELINE_SHAPES["arr_rec_arr"]
SCHEMAS = {"kafka": KAFKA, "arr_rec_arr": NESTED}
TP = "00-" + "4b" * 16 + "-" + "a1" * 8 + "-01"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Both packages' telemetry cleared around each test; the engines'
    knobs at their defaults; one torch thread."""
    for name in ("PYRUHVRO_TPU_OVERLAP", "PYRUHVRO_TPU_OVERLAP_ROWS",
                 "PYRUHVRO_TPU_PALLAS", "PYRUHVRO_TPU_NO_NATIVE",
                 "PYRUHVRO_TPU_TRACE", "PYRUHVRO_TPU_TRACEPARENT",
                 "PYRUHVRO_TPU_DEVICE_SYNC", "PYRUHVRO_TPU_NO_TELEMETRY"):
        monkeypatch.delenv(name, raising=False)
    telemetry.reset()
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    telemetry.set_enabled(True)
    telemetry.reset()


@pytest.fixture(scope="module")
def data():
    """Seeded batches per schema and size (numpy seeds inside datagen)."""
    out = {}
    for n in (512, 8192):
        out[("kafka", n)] = datagen.kafka_style_datums(n, seed=n)
        out[("arr_rec_arr", n)] = datagen.random_datums(
            parse_schema(NESTED), n, seed=n)
    return out


def poisoned(n=512, every=37, seed=5):
    """Kafka records with a numpy-seeded offset and one row in ``every``
    replaced by ``b"\\x01"``; returns the datums and the bad rows."""
    datums = datagen.kafka_style_datums(n, seed=seed)
    start = int(np.random.default_rng(seed).integers(0, every))
    bad = list(range(start, n, every))
    for i in bad:
        datums[i] = b"\x01"
    return datums, bad


def shape(span, ordered=True):
    """A span tree's names, nesting and child counts."""
    kids = [shape(c, ordered) for c in span.get("children", [])]
    return (span["name"], kids if ordered else sorted(kids, key=repr))


def aot_pairs_to_first_call(tree):
    """The reference's cold tree with each ``device.compile_s`` +
    ``device.launch_s`` pair of its AOT split folded into one
    ``device.compile_s``, the port's first-call form."""
    name, kids = tree
    out = []
    for k in kids:
        if out and out[-1][0] == "device.compile_s" and \
                k[0] == "device.launch_s":
            continue
        out.append(aot_pairs_to_first_call(k))
    return (name, out)


def without_reputs(span):
    """The reference's span dict without the ``decode.h2d_s`` right after
    each ``device.retry_s`` (the re-copy of a donated input), and the
    bytes those copies moved."""
    kids, moved = [], 0
    for c in span.get("children", []):
        if c["name"] == "decode.h2d_s" and kids and \
                kids[-1]["name"] == "device.retry_s":
            moved += c["attrs"]["bytes"]
            continue
        c, m = without_reputs(c)
        kids.append(c)
        moved += m
    return {**span, "children": kids}, moved


def last_root(tel):
    return tel.snapshot()["spans"][-1]


def counters(tel, keys):
    c = tel.snapshot()["counters"]
    return {k: c.get(k, 0.0) for k in keys}


def launches_in(tree) -> int:
    name, kids = tree
    return (name in ("device.compile_s", "device.launch_s")) + sum(
        launches_in(k) for k in kids)


# -- (a) units ----------------------------------------------------------------


def test_histogram_quantiles_and_buckets_are_the_reference():
    rng = np.random.default_rng(2024)
    values = rng.lognormal(mean=-7.0, sigma=2.5, size=10_000)
    ids = [f"{i:032x}" for i in rng.integers(0, 1 << 62, size=10_000)]
    got, want = telemetry._Hist(), ref_tel._Hist()
    for v, t in zip(values.tolist(), ids):
        got.observe(v, t)
        want.observe(v, t)
    assert got.summary() == want.summary()
    for q in (0.5, 0.95, 0.99, 0.999):
        assert got.quantile(q) == want.quantile(q)
    assert telemetry._BUCKET_BOUNDS == ref_tel._BUCKET_BOUNDS


# -- (b) trace contexts ---------------------------------------------------------

TRACEPARENTS = [
    TP,
    TP.upper(),
    "  " + TP + "  ",
    "00-" + "0" * 32 + "-" + "a1" * 8 + "-01",   # all-zero trace id
    "00-" + "4b" * 16 + "-" + "0" * 16 + "-01",  # all-zero span id
    "ff-" + "4b" * 16 + "-" + "a1" * 8 + "-01",  # version ff
    "01-" + "4b" * 16 + "-" + "a1" * 8 + "-00",  # a later version
    "00-" + "4b" * 15 + "-" + "a1" * 8 + "-01",  # short trace id
    "00-" + "4b" * 16 + "-" + "a1" * 9 + "-01",  # long span id
    "00-" + "4b" * 16 + "-" + "a1" * 8,          # no flags
    "not a traceparent",
    "",
]


def test_traceparent_parsing_is_the_reference(monkeypatch):
    for raw in TRACEPARENTS:
        assert traceprop.coerce(raw) == ref_tp.coerce(raw), raw
        if raw.strip():
            assert traceprop.parse(raw) == ref_tp.parse(raw), raw
    for value in (("4b" * 16, "a1" * 8), ("4b" * 16, "a1" * 8, "00"),
                  ("0" * 32, "a1" * 8), ("4b" * 16,), 42, None,
                  traceprop.TraceContext("4b" * 16, "a1" * 8)):
        assert traceprop.coerce(value) == ref_tp.coerce(value), value
    # counted alike: the parse errors of the whole table
    for key in ("trace.parse_error",):
        assert metrics.snapshot().get(key) == \
            ref_metrics.snapshot().get(key)
    # resolve: explicit > thread-local > PYRUHVRO_TPU_TRACEPARENT > None
    assert traceprop.resolve(None) is None is ref_tp.resolve(None)
    monkeypatch.setenv("PYRUHVRO_TPU_TRACEPARENT", TP)
    assert traceprop.resolve(None) == ref_tp.resolve(None) == \
        ("4b" * 16, "a1" * 8, "01")
    other = ("cd" * 16, "ef" * 8)
    with traceprop.activate(traceprop.TraceContext(*other)), \
            ref_tp.activate(ref_tp.TraceContext(*other)):
        assert traceprop.resolve(None) == ref_tp.resolve(None)
        assert traceprop.resolve(TP) == ref_tp.resolve(TP)
    monkeypatch.setenv("PYRUHVRO_TPU_TRACEPARENT", "garbage")
    assert traceprop.resolve(None) is None is ref_tp.resolve(None)
    assert metrics.snapshot().get("trace.env_ingress") == \
        ref_metrics.snapshot().get("trace.env_ingress") == 1


# -- (c) exporters ----------------------------------------------------------------


def test_exporters_give_the_reference_text_on_the_same_snapshot(data):
    port.deserialize_array_threaded(data[("kafka", 512)], KAFKA, 4,
                                    device="cpu")
    port.deserialize_array_threaded(data[("kafka", 512)], KAFKA, 4,
                                    backend="host")
    snap = json.loads(json.dumps(telemetry.snapshot()))
    assert telemetry.prometheus(snap) == ref_tel.prometheus(snap)
    assert telemetry.prometheus(snap, exemplars=True) == \
        ref_tel.prometheus(snap, exemplars=True)
    assert json.dumps(telemetry.perfetto_trace(snap), sort_keys=True) == \
        json.dumps(ref_tel.perfetto_trace(snap), sort_keys=True)
    assert telemetry.render_report(snap) == ref_tel.render_report(snap)
    # the bound bytes of the card's launches: one line says what it sums
    snap["counters"]["device.cost.bytes_accessed"] = 123456789.0
    got = telemetry.render_report(snap).splitlines()
    want = ref_tel.render_report(snap).splitlines()
    diff = [(g, w) for g, w in zip(got, want) if g != w]
    assert len(got) == len(want) and len(diff) == 1
    assert diff[0][0].startswith("kernel bounds: 0 flops, 123.46 MB")
    assert diff[0][1].startswith("xla cost model: 0 flops, 123.46 MB")


# -- (d) span trees and counters ----------------------------------------------------

DATA_COUNTERS = ("decode.h2d_bytes", "device.h2d_bytes", "device.retries",
                 "decode.quarantined", "route.device")


@pytest.mark.parametrize("n", [512, 8192])
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_device_tier_trees_and_counters_are_the_reference(name, n, data):
    """Cold and warm calls of ``deserialize_array`` (one launch at 512
    rows, the overlapped path's 2 chunks at 8,192). The schema string is
    this case's own (trailing blanks), so both packages build a fresh
    codec; both capacity planners start empty at each call (the
    reference's telemetry reset empties its planner)."""
    schema = SCHEMAS[name] + " " * (n // 512)
    datums = data[(name, n)]
    for call in ("cold", "warm"):
        telemetry.reset()
        capacity.reset()
        ref_tel.reset()
        got = port.deserialize_array(datums, schema, device="cpu")
        want = ref.deserialize_array(datums, schema, backend="tpu")
        assert got.to_pylist() == want.to_pylist()
        g, (w, reput) = last_root(telemetry), without_reputs(
            last_root(ref_tel))
        assert g["attrs"]["rows"] == w["attrs"]["rows"] == n
        gs, ws = shape(g), shape(w)
        if call == "cold":
            ws = aot_pairs_to_first_call(ws)
        assert gs == ws
        gc, wc = counters(telemetry, DATA_COUNTERS), \
            counters(ref_tel, DATA_COUNTERS)
        for key in ("decode.h2d_bytes", "device.h2d_bytes"):
            wc[key] -= reput
        assert gc == wc
        g_d2h = telemetry.snapshot()["counters"]["decode.d2h_bytes"]
        w_d2h = ref_tel.snapshot()["counters"]["decode.d2h_bytes"]
        assert g_d2h == w_d2h + dm.STATUS_BYTES * launches_in(gs)
    # the launches on the warm call's spans are the registry's
    reg = telemetry.snapshot()["device"]["jit_cache"]
    for kind in ("walk", "finalize"):
        rows = [e for e in reg.values() if e["kind"] == kind]
        assert sum(e["launches"] for e in rows) == launches_in(gs)


HOST_COUNTERS = ("decode.fused", "decode.fused_fallback", "extract.native",
                 "extract.fallback", "route.native", "route.fallback",
                 "pool.chunks", "pool.fanouts", "pool.worker_rows",
                 "encode.quarantined")


@pytest.fixture()
def raw_program(monkeypatch):
    """The reference's raw-program arm, which the port's native tier is."""
    monkeypatch.setenv("PYRUHVRO_TPU_NO_SPECIALIZE", "1")
    monkeypatch.setenv("PYRUHVRO_TPU_NO_OPT", "1")


@pytest.mark.parametrize("tier", ["native", "oracle"])
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_host_tier_trees_and_counters_are_the_reference(name, tier, data,
                                                        raw_program,
                                                        monkeypatch):
    if tier == "oracle":
        monkeypatch.setenv("PYRUHVRO_TPU_NO_NATIVE", "1")
    schema, datums = SCHEMAS[name], data[(name, 512)]
    batch = port.deserialize_array(datums, schema, backend="host")
    calls = (
        lambda api: api.deserialize_array(datums, schema, backend="host"),
        lambda api: api.deserialize_array_threaded(datums, schema, 4,
                                                   backend="host"),
        lambda api: api.serialize_record_batch(batch, schema, 4,
                                               backend="host"),
    )
    for call in calls:
        for _ in range(2):  # cold, then warm
            telemetry.reset()
            ref_tel.reset()
            call(port)
            call(ref)
            # pool chunks start in any order: compared as a multiset
            assert shape(last_root(telemetry), ordered=False) == \
                shape(last_root(ref_tel), ordered=False)
            assert counters(telemetry, HOST_COUNTERS) == \
                counters(ref_tel, HOST_COUNTERS)


# -- (e) trace_ctx ----------------------------------------------------------------

PORT_CALLS = {
    "deserialize_array": lambda d, b, **kw: port.deserialize_array(
        d, KAFKA, device="cpu", **kw),
    "deserialize_array_threaded":
        lambda d, b, **kw: port.deserialize_array_threaded(
            d, KAFKA, 3, device="cpu", **kw),
    "deserialize_array_threaded_spawn":
        lambda d, b, **kw: port.deserialize_array_threaded_spawn(
            d, KAFKA, 3, device="cpu", **kw),
    "serialize_record_batch": lambda d, b, **kw: port.serialize_record_batch(
        b, KAFKA, 3, device="cpu", **kw),
    "serialize_record_batch_spawn":
        lambda d, b, **kw: port.serialize_record_batch_spawn(
            b, KAFKA, 3, device="cpu", **kw),
}


@pytest.mark.parametrize("fn", sorted(PORT_CALLS))
def test_root_span_joins_trace_ctx(fn, data):
    datums = data[("kafka", 512)][:64]
    batch = port.deserialize_array(datums, KAFKA, device="cpu")
    for ctx in (TP, traceprop.TraceContext("4b" * 16, "a1" * 8),
                ("4b" * 16, "a1" * 8)):
        telemetry.reset()
        PORT_CALLS[fn](datums, batch, trace_ctx=ctx)
        root = last_root(telemetry)
        assert root["name"].startswith("api.")
        assert (root["trace_id"], root["parent_span_id"]) == \
            ("4b" * 16, "a1" * 8)
    # malformed: counted and ignored, a fresh trace is minted
    telemetry.reset()
    PORT_CALLS[fn](datums, batch, trace_ctx="00-zz")
    root = last_root(telemetry)
    assert len(root["trace_id"]) == 32 and "parent_span_id" not in root
    assert metrics.snapshot()["trace.parse_error"] == 1


@pytest.mark.parametrize("chunks", [None, 4])
def test_quarantine_entries_carry_the_reference_trace_id(chunks):
    datums, bad = poisoned()
    kw = dict(on_error="skip", return_errors=True, trace_ctx=TP)
    if chunks is None:
        got, got_q = port.deserialize_array(datums, KAFKA, device="cpu", **kw)
        want, want_q = ref.deserialize_array(datums, KAFKA, backend="tpu",
                                             **kw)
    else:
        got, got_q = port.deserialize_array_threaded(
            datums, KAFKA, chunks, device="cpu", **kw)
        want, want_q = ref.deserialize_array_threaded(
            datums, KAFKA, chunks, backend="tpu", **kw)
    assert [q.index for q in got_q] == [q.index for q in want_q] == bad
    assert [q.trace_id for q in got_q] == [q.trace_id for q in want_q] == \
        ["4b" * 16] * len(bad)
    keys = ["decode.quarantined"] + [f"decode.quarantine.{q.error}"
                                     for q in want_q]
    assert counters(telemetry, keys) == counters(ref_tel, keys)
    assert last_root(telemetry)["attrs"]["quarantined"] == len(bad)
    assert last_root(telemetry)["attrs"]["on_error"] == "skip"


@pytest.mark.parametrize("n", [99, 100])
def test_quarantine_storm_at_the_reference_default(n, monkeypatch):
    """A call with ``quarantine.STORM`` entries (the default of
    ``PYRUHVRO_TPU_QUARANTINE_STORM``, the reference's default) counts one
    storm and marks it; one entry fewer counts none."""
    from pyruhvro_tpu.runtime import knobs as ref_knobs
    from pyruhvro_tpu_torch.runtime import quarantine

    monkeypatch.delenv("PYRUHVRO_TPU_QUARANTINE_STORM", raising=False)
    assert quarantine.STORM == \
        ref_knobs.get_int("PYRUHVRO_TPU_QUARANTINE_STORM") == 100
    entries = [quarantine.QuarantinedRecord(i, b"\x01", "malformed",
                                            "device") for i in range(n)]
    with telemetry.root_span("api.test"):
        quarantine.publish(entries, "skip", op="decode")
    c = metrics.snapshot()
    assert c.get("decode.quarantined") == n
    assert c.get("decode.quarantine_storms", 0) == (n >= 100)
    assert (metrics.mark_age("quarantine_storm") is not None) == (n >= 100)


@pytest.mark.parametrize("n", [2, 3])
def test_the_storm_knob_moves_the_threshold(n, monkeypatch):
    """``PYRUHVRO_TPU_QUARANTINE_STORM=3`` (read at each call, as the
    reference's ``_storm_threshold``): three entries count a storm, two
    do not."""
    from pyruhvro_tpu_torch.runtime import quarantine

    monkeypatch.setenv("PYRUHVRO_TPU_QUARANTINE_STORM", "3")
    entries = [quarantine.QuarantinedRecord(i, b"\x01", "malformed",
                                            "device") for i in range(n)]
    with telemetry.root_span("api.test"):
        quarantine.publish(entries, "skip", op="decode")
    c = metrics.snapshot()
    assert c.get("decode.quarantined") == n
    assert c.get("decode.quarantine_storms", 0) == (n >= 3)
    assert (metrics.mark_age("quarantine_storm") is not None) == (n >= 3)


# -- (f) disabled mode -------------------------------------------------------------


def test_disabled_mode_keeps_counters_drops_spans(data):
    datums = data[("kafka", 512)][:30]
    telemetry.set_enabled(False)
    try:
        port.deserialize_array(datums, KAFKA, backend="host")
        port.deserialize_array(datums, KAFKA, device="cpu")
    finally:
        telemetry.set_enabled(True)
    snap = telemetry.snapshot()
    assert snap["spans"] == []
    assert snap["histograms"] == {}
    assert "device" not in snap  # no launch timed
    c = snap["counters"]
    assert c.get("route.native", 0) + c.get("route.fallback", 0) == 1
    assert c["route.device"] == 1 and c["decode.h2d_bytes"] > 0


def test_no_telemetry_knob_starts_disabled():
    code = ("from pyruhvro_tpu_torch.runtime import telemetry;"
            "print(telemetry.enabled())")
    env = dict(os.environ, PYRUHVRO_TPU_NO_TELEMETRY="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


# -- (g) telemetry changes no result -------------------------------------------------


def test_results_and_errors_are_the_same_with_telemetry_off(data):
    datums = data[("arr_rec_arr", 512)]
    bad_datums, _bad = poisoned()
    outcomes = {}
    for on in (True, False):
        telemetry.set_enabled(on)
        try:
            dev = port.deserialize_array_threaded(datums, NESTED, 3,
                                                  device="cpu")
            host = port.deserialize_array_threaded(datums, NESTED, 3,
                                                   backend="host")
            wire = port.serialize_record_batch(
                pa.Table.from_batches(dev), NESTED, 3, device="cpu")
            skip = port.deserialize_array(bad_datums, KAFKA, device="cpu",
                                          on_error="skip", return_errors=True)
            with pytest.raises(port.MalformedAvro) as err:
                port.deserialize_array(bad_datums, KAFKA, device="cpu")
        finally:
            telemetry.set_enabled(True)
        outcomes[on] = ([b.to_pylist() for b in dev],
                        [b.to_pylist() for b in host],
                        [a.to_pylist() for a in wire],
                        skip[0].to_pylist(),
                        [(q.index, q.error) for q in skip[1]],
                        (str(err.value), err.value.index))
    assert outcomes[True] == outcomes[False]


# -- (h) worker payloads -------------------------------------------------------------


def test_worker_payload_survives_pickle_and_merges():
    def work(tel, met):
        with tel.worker_scope("pool.worker", rows=10) as w:
            met.inc("worker.items", 2.0)
            with tel.phase("worker.step_s"):
                pass
        return w.payload

    got, want = work(telemetry, metrics), work(ref_tel, ref_metrics)
    for p in (got, want):
        assert p["rows"] == 10 and p["span"]["name"] == "pool.worker"
    assert got["counters"]["worker.items"] == want["counters"][
        "worker.items"] == 2.0
    assert shape(got["span"]) == shape(want["span"])
    payload = pickle.loads(pickle.dumps(got))
    telemetry.reset()
    with telemetry.root_span("api.test"):
        telemetry.merge_worker(payload)
    snap = telemetry.snapshot()
    assert snap["counters"]["worker.items"] == 2.0
    assert snap["counters"]["pool.worker_rows"] == 10
    assert snap["counters"]["pool.worker_merges"] == 1
    assert shape(snap["spans"][-1]) == (
        "api.test", [("pool.worker", [("worker.step_s", [])])])


# -- (i) the CLI and the trace file ---------------------------------------------------


def test_cli_renders_a_saved_snapshot(tmp_path, data):
    port.deserialize_array_threaded(data[("kafka", 512)], KAFKA, 2,
                                    device="cpu")
    snap = telemetry.snapshot()
    path = tmp_path / "snapshot.json"
    path.write_text(json.dumps(snap))
    cli = [sys.executable, "-m", "pyruhvro_tpu_torch.telemetry"]
    out = subprocess.run(cli + ["report", str(path)], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout == telemetry.render_report(json.loads(path.read_text()))
    assert "== device tier ==" in out.stdout
    out = subprocess.run(cli + ["prom", str(path)], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert chip_smoke.prom_lines_parse(out.stdout) > 0
    trace = tmp_path / "trace.json"
    subprocess.run(cli + ["perfetto", str(path), "-o", str(trace)],
                   cwd=REPO, check=True)
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "device.launch_s" for e in events)


def test_trace_file_gets_one_line_per_root_span(tmp_path, monkeypatch, data):
    path = tmp_path / "spans.jsonl"
    monkeypatch.setenv("PYRUHVRO_TPU_TRACE", str(path))
    datums = data[("kafka", 512)][:40]
    port.deserialize_array(datums, KAFKA, device="cpu")
    port.deserialize_array_threaded(datums, KAFKA, 2, backend="host")
    telemetry.reset()  # closes the file
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["name"] for x in lines] == ["api.deserialize_array",
                                          "api.deserialize_array_threaded"]
    assert all(len(x["trace_id"]) == 32 for x in lines)


# -- the launch recorder on the card, with stand-in events ----------------------------


class _Event:
    """A stand-in CUDA event: its handle (``cuda_event``) is what a kernel
    library records; it completes when the test says so; reading it
    early raises, as ``cudaEventElapsedTime`` does; it never
    synchronises."""

    made = 0
    clock = 0.0
    by_handle = {}

    def __init__(self):
        type(self).made += 1
        self.at, self.done = None, False
        self.cuda_event = 0x1000 + type(self).made
        type(self).by_handle[self.cuda_event] = self

    def record(self, stream=None):
        _Event.clock += 0.001
        self.at, self.done = _Event.clock, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        if not (self.done and end.done):
            raise RuntimeError("event not ready")
        return (end.at - self.at) * 1e3

    def synchronize(self):
        raise AssertionError("telemetry must not synchronise")


def _library_records(t):
    """What a kernel library does with the handles ``timed`` hands it:
    records the first before its kernel and the second after it."""
    assert None not in t.events
    for handle in t.events:
        _Event.by_handle[handle].record()


def test_launch_events_are_pooled_read_late_and_counted(monkeypatch):
    events = []

    def acquire(key, stream):
        with device_obs._lock:
            pool = device_obs._pools.get(key)
            if pool:
                ev = pool.pop()
                events.append(ev)
                return ev
        ev = _Event()
        events.append(ev)
        return ev

    class Stream:
        cuda_stream = 7

    monkeypatch.setattr(device_obs, "_acquire", acquire)
    monkeypatch.setattr(device_obs, "_pools", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream)
    card = torch.device("cuda", 0)
    _Event.made = 0
    with telemetry.root_span("api.test"):
        for i in range(3):
            info = {}
            with device_obs.launch("decode.pipeline", "R8", "fp",
                                   first=i == 0, info=info) as L:
                L.add_bytes("walk", 100)
                L.add_bytes("finalize", lambda rec: rec.info["n"] * 2)
                with device_obs.timed("walk", card) as t:
                    _library_records(t)
                with device_obs.timed("finalize", card) as t:
                    _library_records(t)
            info["n"] = 10
            # the call waited: its events completed, then it flushes
            for ev in events:
                ev.done = True
            events.clear()
            device_obs.flush(final=False)
        # a launch whose call raised before its wait: dropped at the root
        with device_obs.launch("decode.pipeline", "R8", "fp",
                               first=False):
            with device_obs.timed("walk", card) as t:
                _library_records(t)
    assert _Event.made == 4  # two kernels x two events, then reused
    snap = telemetry.snapshot()
    c = snap["counters"]
    assert c["device.jit_cache.misses"] == 1
    assert c["device.jit_cache.hits"] == 3
    assert c["device.cost.bytes_accessed"] == 3 * (100 + 20)
    assert c["device.launch_unresolved"] == 1
    reg = snap["device"]["jit_cache"]
    assert reg["fp|walk|R8"]["compiles"] == 1
    assert reg["fp|walk|R8"]["launches"] == 2
    assert reg["fp|finalize|R8"]["bytes"] == 2 * 20
    root = snap["spans"][-1]
    names = [k["name"] for k in root["children"]]
    assert names == ["device.compile_s"] + ["device.launch_s"] * 3
    assert [k["dur_s"] is not None for k in root["children"]] == \
        [True, True, True, False]
    assert root["children"][0]["attrs"]["mode"] == "first_call"


def test_device_sync_zero_records_no_event(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_DEVICE_SYNC", "0")
    monkeypatch.setattr(device_obs, "_acquire", lambda key, stream: 1 / 0)
    card = torch.device("cuda", 0)
    with device_obs.launch("decode.pipeline", "R8", "fp", first=False):
        with device_obs.timed("walk", card) as t:
            assert t.events == (None, None)
    device_obs.flush()
    assert "device" not in telemetry.snapshot()
    assert metrics.snapshot()["device.jit_cache.hits"] == 1


@pytest.mark.parametrize("walked", [False, True])
def test_encode_bytes_walk_only_on_request(walked, monkeypatch, data):
    """K3's launch record carries bytes only while
    ``count_walked_bytes`` is on, and then ``k3_bytes`` over
    ``rows_traffic`` of the launch (the encoder of a card, its launch
    record made on the CPU's buffer; nothing runs on a card)."""
    from pyruhvro_tpu_torch.ops import encode as em
    from pyruhvro_tpu_torch.schema.arrow_map import to_arrow_schema

    ir = parse_schema(KAFKA)
    batch = port.deserialize_array(data[("kafka", 512)], KAFKA,
                                   device="cpu")
    enc = em.DeviceEncoder(ir, to_arrow_schema(ir), "cpu")
    L = enc.launch(batch)
    monkeypatch.setattr(enc, "device", torch.device("cuda", 0))
    device_obs.count_walked_bytes(walked)
    try:
        rec = enc._launch(L, {"total": 0})
    finally:
        device_obs.count_walked_bytes(False)
    assert device_obs.walked_bytes() is False
    if not walked:
        assert rec.L.nbytes == {}
        return
    rec.L.info["total"] = 12345
    want = em.k3_bytes(em.rows_traffic(L), 12345, L.R)
    assert (rec.L.nbytes["encode_rows"](rec.L),
            rec.L.nbytes["encode_strings"](rec.L)) == want


def test_finalize_bytes_from_the_blob_totals_are_the_plan_offsets():
    """``decode.finalize_bytes`` at the item totals a decode reads from the
    blob's ``#red:sum`` equals the count at the plan's own ``#offsets``
    (what ``chip_smoke.py`` reads on the card), on the CPU's plan."""
    ir = parse_schema(KAFKA)
    dec = dm.DeviceDecoder(ir, device="cpu")
    datums = datagen.kafka_style_datums(300, seed=9)
    flat, lanes, n, R, B = dec.pack(datums)
    packed = dec.launch_buffer(flat, lanes, B, "cpu")
    item_caps, tot_caps = dec.caps_snapshot(R)
    words, starts, lengths = dec.launch_views(packed, R, B)
    bufs, err = dm.walk_plain(words, starts, lengths, n, dec.prog, item_caps)
    blob = dm.finalize_plain(bufs, err, dec.prog, R, B, item_caps, tot_caps)
    host = dec._split(blob.numpy(), dm.blob_layout(
        dec.prog, R, B, item_caps, tot_caps, True), n)
    plan = dm.FinalizePlan(bufs, err, dec.prog, R, B, item_caps, tot_caps,
                           True, dm.FinalizeCache())
    assert len(plan.passes) > 1  # item regions, each under the rows
    tot = plan.view("tot", torch.int64, len(dec.prog.regions))
    for p in plan.passes:
        assert dec.prog.region_parents[p["rid"]] == 0 or p["rid"] == 0
        if p["rid"]:  # what the region's last tile leaves in the scratch
            tot[p["rid"]] = bufs[dec.prog.out_keys.index(
                dec.prog.regions[p["rid"]] + "#count")].sum()
    spec = dm.finalize_spec(plan)
    assert dm.finalize_bytes(spec, dec._item_totals(host)) == \
        dm.finalize_bytes(spec, chip_smoke.plan_totals(plan)) > spec[0]
    assert dm.walk_bytes(int(lengths.sum()), R, dm.walk_out_bytes(
        dec.prog, R, item_caps)) == int(lengths.sum()) + 12 * R + sum(
            b.numel() * b.element_size() for b in bufs)


# -- (j) source scan ------------------------------------------------------------------


# the flight recorder's best-effort functions (the reference's contract:
# a failed dump, rotation or signal install is counted or reported by
# its return value, and never fails the call it observes)
FLIGHT_BEST_EFFORT = {"_flight_records", "_rotate_flight_dir", "mtime",
                      "_flight_autodump", "install_flight_signal"}

# the incident plane's observers, which count a failure and go on as the
# reference's do (the caller's result is already complete): the timeline's
# tick loop, each incident section, write, rotation and listing, the audit
# shadow, the obs server's handler (the 500 path) and start; the CLI's
# exit-2 contract (its file loader and the fleet's scrapes); coldigest's
# probes of a pyarrow type's byte width and union type codes; and the
# memory plane's and the exporter's observers: a failed probe
# (``mem.probe_error``), a failed lifecycle hook (``cache.hook_error``)
# and the OTLP exporter's failed POST, counted behind its breaker
BEST_EFFORT = {
    "telemetry": FLIGHT_BEST_EFFORT | {"main", "_load", "_fleet_cmd",
                                       "_diff_cmd"},
    "device_obs": set(),
    "timeline": {"_run"},
    "incident": {"_section", "_rotate", "mtime", "capture_now",
                 "list_incidents"},
    "audit": {"maybe_audit", "_run_shadow"},
    "obs_server": {"do_GET", "start_from_env"},
    "coldigest": {"_byte_width", "_update"},
    "memacct": {"_collect_full", "tracked_bytes", "_device_memory",
                "peak_rss_bytes", "rss_bytes", "_approx_bytes"},
    "cachelife": {"_safe_entries", "_evict_one", "admit",
                  "snapshot_lifecycle"},
    "otel": {"_post", "flush"},
    "fleet": {"num"},
    # the serving plane's future-carrying catches (a request's error ends
    # in its future: the direct call, the coalesced batch's
    # classification, the serial call), the drain's counted flush
    # (``serve.flush_error``) and the signal arming's; the Flight door's
    # RPC-scoped ones (one RPC fails, the server stays) and its probe of
    # ``pyarrow.flight``; the specialiser's size probe of an engine file
    "serving": {"_direct_future", "_run_requests", "_exec_serial",
                "_flush_saves", "drainer", "install_drain_signal"},
    "flight": {"flight_available", "do_put", "do_get"},
    "specialize": {"_note_engine"},
    # the analysis plane's catches, each turning what it caught into a
    # finding or an absent anchor, as the reference's do: a source file
    # that cannot be read (the guard, consumer and test scans), a trailer
    # or a constant that does not parse, a rewrite that does not strip
    # back, a lattice point that does not lower or optimize, a seeded
    # mutation whose pass crashed; the superoptimizer catches nothing
    # (an error of the verifier propagates)
    "optimize": set(),
    "irverify": {"scan_native_guards", "scan_aux_consumers",
                 "_effects_trailer", "verify_optimized", "run_lattice",
                 "run_mutation_selftest"},
    "contracts": {"check_error_taxonomy", "_cpp_const_eval"},
    # the lints' unreadable tables and README (a finding, or no drain
    # keys in a fixture tree) and a path that has no relative form; the
    # concurrency pass catches nothing
    "lints": {"_rel", "metric_key_registry", "port_section",
              "lint_metric_keys"},
    "concurrency": set(),
}

# the modules outside runtime/
MODULE_PATHS = {"serving": "serving/__init__.py",
                "flight": "serving/flight.py",
                "specialize": "hostpath/specialize.py",
                "optimize": "hostpath/optimize.py",
                "irverify": "analysis/irverify.py",
                "contracts": "analysis/contracts.py",
                "lints": "analysis/lints.py",
                "concurrency": "analysis/concurrency.py"}


@pytest.mark.parametrize("module", ["telemetry", "device_obs", "timeline",
                                    "incident", "audit", "obs_server",
                                    "coldigest", "memacct", "cachelife",
                                    "otel", "fleet", "serving", "flight",
                                    "specialize", "optimize", "irverify",
                                    "contracts", "lints", "concurrency"])
def test_no_synchronise_and_no_swallowed_exception(module):
    path = REPO / "pyruhvro_tpu_torch" / MODULE_PATHS.get(
        module, f"runtime/{module}.py")
    src = path.read_text()
    tree = ast.parse(src)
    assert "torch.cuda.synchronize" not in src
    parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}

    def inside(node, pred):
        while node in parents:
            node = parents[node]
            if pred(node):
                return node
        return None

    def sync_mode_if(node):
        return isinstance(node, ast.If) and any(
            isinstance(c, ast.Call) and getattr(c.func, "id", "") ==
            "sync_mode" for c in ast.walk(node.test))

    # the only waits are sync mode's (a deep-sampled call, or
    # PYRUHVRO_TPU_DEVICE_SYNC=1), inside ``if sync_mode() ...:``
    waits = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "synchronize"]
    assert len(waits) == (2 if module == "device_obs" else 0)
    for n in waits:
        assert inside(n, sync_mode_if) is not None, (module, n.lineno)
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            fn = inside(node, lambda p: isinstance(p, ast.FunctionDef))
            if fn is not None and fn.name in BEST_EFFORT[module]:
                continue
            # every other handler re-raises what it caught
            assert any(isinstance(n, ast.Raise) and n.exc is None
                       for n in ast.walk(node)), (module, node.lineno)


def test_failed_launch_records_nothing(monkeypatch):
    """A launch call that fails raises inside ``timed``: its stretch is
    not recorded and both events go back to the pool."""
    made = []

    def acquire(key, stream):
        made.append(_Event())
        return made[-1]

    class Stream:
        cuda_stream = 9

    monkeypatch.setattr(device_obs, "_acquire", acquire)
    monkeypatch.setattr(device_obs, "_pools", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream)
    card = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        with device_obs.launch("decode.pipeline", "R8", "fp", first=False):
            with device_obs.timed("walk", card) as t:
                _library_records(t)
                raise RuntimeError("decode_walk launch failed: CUDA error 1")
    assert device_obs._pools[(0, 9)] == made
    device_obs.flush()
    assert "device" not in telemetry.snapshot()
