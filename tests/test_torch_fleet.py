"""The port's OTLP exporter and fleet merge and diff
(``pyruhvro_tpu_torch/runtime/otel.py`` and ``fleet.py``, copies of the
reference's, and the CLI's ``fleet`` and ``diff``) held against the
reference on the CPU.

* **OTLP mapping.** ``spans_to_otlp`` and ``metrics_to_otlp`` of the same
  span trees and registries equal the reference's (its clock and its span
  ids pinned alike); the device tier's launch spans carry their kernel
  seconds and bytes as plain attributes.
* **Exporter.** A round trip to a collector stub in the test process
  (every span under the caller's trace id, an exemplar on
  ``device.launch_s``), an unreachable collector counted behind the
  ``otlp_export`` breaker with the spans kept, ``stop`` detaching the
  sink, and the import hook.
* **Fleet.** ``merge_snapshots``, ``diff_snapshots``, ``render_diff``,
  ``parse_window`` and ``window_snapshot`` of the same documents equal the
  reference's; a live snapshot merged with itself doubles every counter;
  a document without a ``serving`` (or any other) section merges.
* **CLI.** ``fleet`` over files and live scrapes, ``diff`` with
  ``--json`` and ``--window``, and the exit-2 contract.
"""

import copy
import gzip
import json
import subprocess
import sys
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.runtime import fleet as ref_fleet  # noqa: E402
from pyruhvro_tpu.runtime import otel as ref_otel  # noqa: E402
from pyruhvro_tpu.runtime import traceprop as ref_traceprop  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    breaker,
    fleet,
    metrics,
    obs_server,
    otel,
    telemetry,
    traceprop,
)
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KAFKA = datagen.KAFKA_SCHEMA_JSON
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"  # the W3C spec example
PARENT_SPAN = "00f067aa0ba902b7"
TRACEPARENT = f"00-{TRACE_ID}-{PARENT_SPAN}-01"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in ("PYRUHVRO_TPU_OTLP_ENDPOINT", "PYRUHVRO_TPU_TRACEPARENT",
                 "PYRUHVRO_TPU_NO_TIMELINE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_OVERLAP_ROWS", "32")
    telemetry.reset()
    breaker.reset()
    yield
    otel.stop()
    telemetry.reset()
    breaker.reset()


def _root_dict():
    with telemetry.root_span("api.test", trace_ctx=TRACEPARENT, rows=4):
        with telemetry.phase("decode.pack_s"):
            pass
    return telemetry.snapshot()["spans"][-1]


def _card_call_root(tenant=None):
    """A device-tier call on the CPU (its launches' spans and registry
    rows are the card's shape) under the caller's trace."""
    data = datagen.kafka_style_datums(100, seed=4)
    port.deserialize_array_threaded(data, KAFKA, 4, device="cpu",
                                    trace_ctx=TRACEPARENT, tenant=tenant)
    return telemetry.snapshot()["spans"][-1]


def _pin_ids(monkeypatch):
    """Export-time span ids minted from one counter per package, and one
    clock, so that the two packages' documents can be compared."""
    for mod, tp in ((otel, traceprop), (ref_otel, ref_traceprop)):
        seq = iter(range(1, 1 << 20))
        monkeypatch.setattr(tp, "new_span_id",
                            lambda seq=seq: f"{next(seq):016x}")
        monkeypatch.setattr(mod, "_START_NS", 1_700_000_000_000_000_000)
    monkeypatch.setattr(otel.time, "time", lambda: 1_700_000_123.5)


# -- OTLP mapping ------------------------------------------------------------------


def test_spans_to_otlp_matches_reference(monkeypatch):
    roots = [_root_dict(), _card_call_root()]
    _pin_ids(monkeypatch)
    got = otel.spans_to_otlp(copy.deepcopy(roots))
    _pin_ids(monkeypatch)
    assert got == ref_otel.spans_to_otlp(copy.deepcopy(roots))
    spans = got["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert {s["traceId"] for s in spans} == {TRACE_ID}
    root = spans[0]
    assert root["parentSpanId"] == PARENT_SPAN
    attrs = {a["key"]: a["value"] for a in root["attributes"]}
    assert attrs["rows"] == {"intValue": "4"}
    # the launches' kernel seconds as plain attributes
    launches = [s for s in spans if s["name"] in ("device.launch_s",
                                                  "device.compile_s")]
    assert launches
    keys = {a["key"] for s in launches for a in s["attributes"]}
    assert {"walk_s", "finalize_s", "kind", "bucket"} <= keys


def test_error_span_maps_status():
    root = _root_dict()
    root["attrs"]["error"] = "MalformedAvro"
    for mod in (otel, ref_otel):
        doc = mod.spans_to_otlp([root])
        assert doc["resourceSpans"][0]["scopeSpans"][0]["spans"][0][
            "status"] == {"code": 2}


def test_metrics_to_otlp_matches_reference(monkeypatch):
    _card_call_root()
    counters = metrics.snapshot()
    hists = telemetry.hist_summaries()
    gauges = {"g.live": 3.0, **metrics.gauges()}
    _pin_ids(monkeypatch)
    got = otel.metrics_to_otlp(counters, gauges, hists)
    assert got == ref_otel.metrics_to_otlp(counters, gauges, hists)
    mets = got["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]
    by_name = {m["name"]: m for m in mets}
    assert all(m["sum"]["isMonotonic"] for m in mets if "sum" in m)
    assert by_name["g.live"]["gauge"]["dataPoints"][0]["asDouble"] == 3.0
    dp = by_name["api.deserialize_array_threaded_s"]["histogram"][
        "dataPoints"][0]
    assert len(dp["bucketCounts"]) == len(dp["explicitBounds"]) + 1
    assert sum(int(c) for c in dp["bucketCounts"]) == int(dp["count"])
    assert dp["exemplars"][0]["traceId"] == TRACE_ID


def test_attr_mapping_of_each_type():
    for v in (True, 3, 2.5, "x", None):
        assert otel._attr("k", v) == ref_otel._attr("k", v)


# -- the exporter ------------------------------------------------------------------------


class _Collector:
    """A collector stub on 127.0.0.1 that answers 200 and keeps bodies."""

    def __init__(self):
        reqs = self.reqs = []

        class Stub(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                reqs.append((self.path, json.loads(self.rfile.read(n))))
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def spans(self):
        return [s for p, b in self.reqs if p.endswith("/v1/traces")
                for rs in b["resourceSpans"] for ss in rs["scopeSpans"]
                for s in ss["spans"]]

    def metrics(self):
        return {m["name"]: m for p, b in self.reqs
                if p.endswith("/v1/metrics")
                for rm in b["resourceMetrics"] for sm in rm["scopeMetrics"]
                for m in sm["metrics"]}

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_round_trip_of_device_calls_to_a_stub_collector():
    col = _Collector()
    try:
        ex = otel.start(col.url, interval_s=3600)  # flushed by hand
        assert otel.exporter() is ex
        assert otel.start(col.url) is ex  # one exporter a process
        _card_call_root(tenant="t-otlp")
        batch = port.deserialize_array(datagen.kafka_style_datums(
            50, seed=5), KAFKA, device="cpu", trace_ctx=TRACEPARENT)
        port.serialize_record_batch(batch, KAFKA, 2, device="cpu",
                                    trace_ctx=TRACEPARENT)
        assert ex.flush() is True
        spans = col.spans()
        assert {s["traceId"] for s in spans} == {TRACE_ID}
        names = {s["name"] for s in spans}
        assert {"api.deserialize_array_threaded",
                "api.serialize_record_batch",
                "device.compile_s"} <= names
        roots = [s for s in spans if s["name"].startswith("api.")]
        assert all(s["parentSpanId"] == PARENT_SPAN for s in roots)
        tenants = {a["value"]["stringValue"] for s in roots
                   for a in s["attributes"] if a["key"] == "tenant"}
        assert tenants == {"t-otlp"}
        mets = col.metrics()
        launch = mets["device.launch_s"]["histogram"]["dataPoints"][0]
        assert launch["exemplars"][0]["traceId"] == TRACE_ID
        c = metrics.snapshot()
        assert c["otlp.spans_exported"] == 3
        assert c["otlp.exports"] == 1
        assert c["otlp.exporter_started"] == 1
    finally:
        otel.stop()
        col.close()
    assert otel.exporter() is None
    assert telemetry._span_sink is None


def test_unreachable_collector_counts_and_requeues():
    ex = otel.OtlpExporter("http://127.0.0.1:1", interval_s=3600)
    root = _root_dict()

    class _S:
        def to_dict(self):
            return root

    ex.enqueue(_S())
    assert ex.flush() is False
    c = metrics.snapshot()
    assert c["otlp.export_errors"] == 1
    assert len(ex._q) == 1  # the span survives for the next pass
    # the breaker opens after its threshold: a dead collector costs one
    # request per backoff window, and the queue is kept
    for _ in range(8):
        ex.flush()
    assert breaker.get("otlp_export").state() == "open"
    assert metrics.snapshot()["otlp.export_skipped"] >= 1
    assert len(ex._q) == 1


def test_a_full_queue_drops_the_oldest_and_counts():
    ex = otel.OtlpExporter("http://127.0.0.1:1", interval_s=3600)
    root = _root_dict()

    class _S:
        def to_dict(self):
            return root

    for _ in range(otel._QUEUE_MAX + 3):
        ex.enqueue(_S())
    assert len(ex._q) == otel._QUEUE_MAX
    assert metrics.snapshot()["otlp.spans_dropped"] == 3


def test_start_from_env_and_the_import_hook(monkeypatch):
    assert otel.start_from_env() is None
    col = _Collector()
    try:
        monkeypatch.setenv("PYRUHVRO_TPU_OTLP_ENDPOINT", col.url)
        ex = otel.start_from_env()
        assert ex is not None and ex.endpoint == col.url
        otel.stop()
        # a fresh process: telemetry's import starts the exporter, and
        # the stop at exit flushes a call's spans
        code = (
            "import sys; sys.path.insert(0, sys.argv[1])\n"
            "from pyruhvro_tpu_torch.runtime import otel, telemetry\n"
            "assert otel.exporter() is not None\n"
            "with telemetry.root_span('api.hook'):\n"
            "    pass\n"
            "otel.stop()\n")
        env = {**__import__("os").environ,
               "PYRUHVRO_TPU_OTLP_ENDPOINT": col.url,
               "PYRUHVRO_TPU_OTLP_INTERVAL_S": "3600"}
        subprocess.run([sys.executable, "-c", code, str(REPO)], env=env,
                       check=True, timeout=120, cwd=str(REPO))
        assert "api.hook" in {s["name"] for s in col.spans()}
    finally:
        otel.stop()
        col.close()


# -- fleet merge -----------------------------------------------------------------------


def _mini_snap(counters, hist_count=0, gauges=None, slo=None, pid=1,
               memory=None):
    snap = {"schema_version": 3, "pid": pid, "counters": dict(counters),
            "histograms": {}, "spans": [], "spans_dropped": 0,
            "flight_records": 0}
    if hist_count:
        snap["histograms"]["decode.pack_s"] = {
            "count": hist_count, "sum": 0.01 * hist_count,
            "p50": 0.001, "p95": 0.001, "p99": 0.001,
            "buckets": [[0.001, hist_count], ["+Inf", hist_count]]}
    if gauges:
        snap["gauges"] = dict(gauges)
    if slo:
        snap["slo"] = slo
    if memory:
        snap["memory"] = memory
    return snap


def _live_snapshots():
    """Two live documents of the port (device-tier calls on the CPU,
    tenants, a timeline tick) and one of the reference."""
    from pyruhvro_tpu_torch.runtime import timeline

    _card_call_root(tenant="a")
    timeline.tick_now()
    first = json.loads(json.dumps(telemetry.snapshot(), default=str))
    batch = port.deserialize_array(datagen.kafka_style_datums(40, seed=8),
                                   KAFKA, device="cpu", tenant="b")
    port.serialize_record_batch(batch, KAFKA, 2, device="cpu", tenant="b")
    timeline.tick_now()
    second = json.loads(json.dumps(telemetry.snapshot(), default=str))
    ref.deserialize_array(datagen.kafka_style_datums(40, seed=8), KAFKA,
                          backend="host", tenant="b")
    theirs = json.loads(json.dumps(ref.telemetry.snapshot(), default=str))
    return first, second, theirs


def test_merge_and_diff_equal_the_reference_on_the_same_documents():
    first, second, theirs = _live_snapshots()
    assert "serving" not in first and "memory" in first
    docs = [first, second, theirs, _mini_snap({"decode.rows": 3.0}, 7,
                                              {"mem.peak_x": 4.0})]
    tags = ["p0", "p1", "ref"]
    got = fleet.merge_snapshots(copy.deepcopy(docs), tags)
    assert got == ref_fleet.merge_snapshots(copy.deepcopy(docs), tags)
    # the tenant sketches fold by (tenant, schema)
    rows = {(r["tenant"], r["schema"]): r for r in got["memory"]["tenants"]}
    fp = port.api.get_or_parse_schema(KAFKA).fingerprint
    assert rows[("b", fp)]["calls"] == 2 + 1
    assert rows[("a", fp)]["calls"] == 2  # in first, and in second
    for a, b in ((first, second), (second, first), (first, theirs),
                 (docs[3], first)):
        assert fleet.diff_snapshots(a, b) == ref_fleet.diff_snapshots(a, b)
        assert fleet.render_diff(a, b) == ref_fleet.render_diff(a, b)
        assert fleet.render_diff(a, b, top=3) == \
            ref_fleet.render_diff(a, b, top=3)


@pytest.mark.parametrize("spec", ["0..", "..-0.001", "-5..", "1e9..",
                                  "0..0", "..", "2..1"])
def test_windows_equal_the_reference(spec):
    _first, second, _theirs = _live_snapshots()
    win = fleet.parse_window(spec)
    assert win == ref_fleet.parse_window(spec)
    assert fleet.window_snapshot(second, win) == \
        ref_fleet.window_snapshot(second, win)


def test_parse_window_rejects_as_the_reference():
    for spec in ("5", "a..b", "1..x"):
        for mod in (fleet, ref_fleet):
            with pytest.raises(ValueError):
                mod.parse_window(spec)
    assert fleet.window_snapshot(_mini_snap({}), (None, None)) is None


def test_counters_sum_exactly():
    a = _mini_snap({"decode.rows": 100.0, "only_a": 1.0})
    b = _mini_snap({"decode.rows": 50.0, "only_b": 2.0})
    m = fleet.merge_snapshots([a, b])
    assert m["counters"] == {"decode.rows": 150.0, "only_a": 1.0,
                             "only_b": 2.0}
    assert [r["tag"] for r in m["fleet"]["replicas"]] == ["r0", "r1"]


def test_histogram_buckets_and_quantiles_merge():
    h = fleet.merge_snapshots([_mini_snap({}, hist_count=10),
                               _mini_snap({}, hist_count=30)])[
        "histograms"]["decode.pack_s"]
    assert h["count"] == 40 and h["buckets"][-1] == ["+Inf", 40]
    assert h["p99"] == 0.001


def test_gauges_fold_by_declared_kind():
    a = _mini_snap({}, gauges={"mem.peak_rss": 10.0, "cache.n": 1.0})
    b = _mini_snap({}, gauges={"mem.peak_rss": 7.0, "cache.n": 2.0})
    g = fleet.merge_snapshots([a, b])["gauges"]
    assert g == {"mem.peak_rss": 10.0, "cache.n": 3.0}
    assert metrics.gauge_kind("mem.peak_rss") == "max"


def test_slo_breaches_survive_replica_tagged():
    a = _mini_snap({}, slo={"file": "/etc/slo.json",
                            "objectives": [{"name": "decode-p99"}],
                            "breached": ["decode-p99"]})
    slo = fleet.merge_snapshots([a, _mini_snap({})],
                                tags=["east", "west"])["slo"]
    assert slo["breached"] == ["[east] decode-p99"]
    assert slo["objectives"][0]["replica"] == "east"


def test_merged_doc_renders_everywhere():
    first, _second, _theirs = _live_snapshots()
    m = fleet.merge_snapshots([first, first])
    assert "phase breakdown" in telemetry.render_report(m)
    assert "pyruhvro_tpu_api_deserialize_array_threaded_s" in \
        telemetry.prometheus(m)
    from pyruhvro_tpu_torch.runtime import memacct

    assert "heavy hitters" in memacct.render_mem_report(m)


def test_empty_input_raises():
    for mod in (fleet, ref_fleet):
        with pytest.raises(ValueError):
            mod.merge_snapshots([])


def test_live_snapshot_merges_with_itself():
    _card_call_root()
    snap = telemetry.snapshot()
    m = fleet.merge_snapshots([snap, snap])
    for k, v in snap["counters"].items():
        assert m["counters"][k] == v + v
    assert m["memory"]["rss_bytes"] == 2 * snap["memory"]["rss_bytes"]


def test_identical_snapshots_diff_clean():
    a = _mini_snap({"decode.rows": 1.0})
    assert "no differences" in fleet.render_diff(a, a)
    d = fleet.diff_snapshots(_mini_snap({"route.host": 9.0,
                                         "route.device": 1.0}),
                             _mini_snap({"route.host": 5.0,
                                         "route.device": 5.0}))
    assert d["routing_mix"]["host"] == [0.9, 0.5]


# -- the CLI ------------------------------------------------------------------------------


def test_fleet_over_files(tmp_path, capsys):
    pa_, pb_ = tmp_path / "a.json", tmp_path / "b.json"
    pa_.write_text(json.dumps(_mini_snap({"decode.rows": 1.0})))
    pb_.write_text(json.dumps(_mini_snap({"decode.rows": 2.0})))
    out = tmp_path / "fleet.json"
    assert telemetry.main(["fleet", str(pa_), str(pb_), "--tag", "x",
                           "-o", str(out)]) == 0
    merged = json.loads(out.read_text())
    assert merged["counters"]["decode.rows"] == 3.0
    assert [r["tag"] for r in merged["fleet"]["replicas"]] == ["x",
                                                               "b.json"]
    assert telemetry.main(["fleet", str(pa_)]) == 0
    assert json.loads(capsys.readouterr().out)["fleet"]["count"] == 1


def test_fleet_scrapes_a_live_obs_server(capsys):
    _card_call_root(tenant="scraped")
    srv = obs_server.ObsServer(port=0).start()
    try:
        gz = urllib.request.urlopen(srv.url + "/snapshot?compress=1",
                                    timeout=10).read()
        assert gz[:2] == b"\x1f\x8b"
        live = fleet.fetch_snapshot(f"{srv.host}:{srv.port}")
        # the fleet scraper reads exactly this surface (each request
        # counts, so the later document holds every earlier key)
        assert set(json.loads(gzip.decompress(gz))["counters"]) <= \
            set(live["counters"])
        assert telemetry.main(["fleet", "--scrape",
                               f"{srv.host}:{srv.port}"]) == 0
        merged = json.loads(capsys.readouterr().out)
        assert merged["fleet"]["replicas"][0]["tag"] == \
            f"{srv.host}:{srv.port}"
        assert {r["tenant"] for r in merged["memory"]["tenants"]} >= \
            {"scraped"}
    finally:
        srv.stop()


def test_fleet_exit2_contract(tmp_path, capsys):
    assert telemetry.main(["fleet"]) == 2
    assert telemetry.main(["fleet", "--scrape", "127.0.0.1:1"]) == 2
    assert telemetry.main(["fleet", "/nonexistent.json"]) == 2
    notsnap = tmp_path / "x.json"
    notsnap.write_text('{"foo": 1}')
    assert telemetry.main(["fleet", str(notsnap)]) == 2
    capsys.readouterr()


def test_diff_cli(tmp_path, capsys):
    first, second, _theirs = _live_snapshots()
    pa_, pb_ = tmp_path / "a.json", tmp_path / "b.json"
    pa_.write_text(json.dumps(first))
    pb_.write_text(json.dumps(second))
    assert telemetry.main(["diff", str(pa_), str(pb_)]) == 0
    assert capsys.readouterr().out == fleet.render_diff(first, second)
    assert telemetry.main(["diff", "--json", str(pa_), str(pb_)]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(
        fleet.diff_snapshots(first, second), default=str))
    assert telemetry.main(["diff", "--window", "0..", str(pa_),
                           str(pb_)]) == 0
    assert "snapshot diff" in capsys.readouterr().out
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps(_mini_snap({"decode.rows": 1.0})))
    assert telemetry.main(["diff", "--window", "0..", str(legacy),
                           str(pb_)]) == 0
    assert "no timeline ticks" in capsys.readouterr().err


def test_diff_exit2_contract(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps(_mini_snap({})))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert telemetry.main(["diff", str(good), "/nonexistent.json"]) == 2
    assert telemetry.main(["diff", str(good), str(bad)]) == 2
    assert telemetry.main(["diff", "--window", "nope", str(good),
                           str(good)]) == 2
    capsys.readouterr()
