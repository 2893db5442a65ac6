"""The port's timeline and incident bundles
(``pyruhvro_tpu_torch/runtime/timeline.py`` and ``incident.py``, copies of
the reference's) held against the reference on the CPU.

* **Ticks.** The same counter increments and histogram observations give
  the reference's per-interval deltas and p50/p95/p99, and the deltas
  re-sum to the cumulative counters; retention keeps the newest ticks.
* **Events.** The ring's bound and drop count, the severity rule and the
  kill switch are the reference's; each state change the port counts
  (the breaker's three, ``drift.detected``, ``quarantine.storm``,
  ``device.recompile_storm``, ``slo.breach`` / ``slo.recovered``,
  ``audit.mismatch``) publishes the reference's event for the same
  trigger. The section and its rendering equal the reference's apart
  from timestamps.
* **Bundles.** Debounce, rotation that spares hand-saved files, section
  isolation, the ``incident_capture`` seam, the reference's section
  keys, and the tick thread writing exactly one bundle for a storm that
  ``incident-report`` renders.
"""

import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu import api as ref_api  # noqa: E402
from pyruhvro_tpu.runtime import audit as ref_audit  # noqa: E402
from pyruhvro_tpu.runtime import breaker as ref_breaker  # noqa: E402
from pyruhvro_tpu.runtime import device_obs as ref_device_obs  # noqa: E402
from pyruhvro_tpu.runtime import drift as ref_drift  # noqa: E402
from pyruhvro_tpu.runtime import faults as ref_faults  # noqa: E402
from pyruhvro_tpu.runtime import incident as ref_incident  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402
from pyruhvro_tpu.runtime import quarantine as ref_quarantine  # noqa: E402
from pyruhvro_tpu.runtime import slo as ref_slo  # noqa: E402
from pyruhvro_tpu.runtime import timeline as ref_timeline  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch import api  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    audit,
    breaker,
    device_obs,
    drift,
    faults,
    incident,
    metrics,
    obs_server,
    quarantine,
    slo,
    telemetry,
    timeline,
)
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

KAFKA = datagen.KAFKA_SCHEMA_JSON
HOST = {"backend": "host", "device": "cpu"}
PORT = dict(metrics=metrics, timeline=timeline, telemetry=telemetry,
            incident=incident, breaker=breaker, drift=drift,
            quarantine=quarantine, device_obs=device_obs, slo=slo,
            audit=audit, api=api, pkg=port, faults=faults)
REF = dict(metrics=ref_metrics, timeline=ref_timeline,
           telemetry=ref.telemetry, incident=ref_incident,
           breaker=ref_breaker, drift=ref_drift, quarantine=ref_quarantine,
           device_obs=ref_device_obs, slo=ref_slo, audit=ref_audit,
           api=ref_api, pkg=ref, faults=ref_faults)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in ("PYRUHVRO_TPU_INCIDENT_DIR", "PYRUHVRO_TPU_NO_TIMELINE",
                 "PYRUHVRO_TPU_TIMELINE_RETENTION", "PYRUHVRO_TPU_FAULTS",
                 "PYRUHVRO_TPU_INCIDENT_MAX_FILES", "PYRUHVRO_TPU_SLO_FILE",
                 "PYRUHVRO_TPU_FLIGHT_DIR", "PYRUHVRO_TPU_AUDIT_BUDGET",
                 "PYRUHVRO_TPU_TIMELINE_INTERVAL_S", "PYRUHVRO_TPU_POOL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")

    def reset():
        for pkg in (PORT, REF):
            # deferred counts an earlier test left pending (a knob's parse
            # error) land now, before the reset, not in this test's ticks
            pkg["metrics"].snapshot()
            pkg["telemetry"].reset()
            pkg["breaker"].reset()
            pkg["faults"].reset()

    reset()
    yield
    reset()


def events(tl, names=None):
    """The section's events without their clocks."""
    out = []
    for e in (tl.snapshot_timeline().get("events") or []):
        if names is None or e["name"] in names:
            out.append({k: v for k, v in e.items()
                        if k not in ("ts", "mono", "trace_id")})
    return out


def untimed_ticks(sec):
    return [{k: v for k, v in t.items() if k not in ("ts", "mono", "dur_s")}
            for t in sec["ticks"]]


# -- the aggregation ring ------------------------------------------------------


def test_counter_deltas_resum_and_are_the_references():
    for pkg in (PORT, REF):
        m, tl = pkg["metrics"], pkg["timeline"]
        m.inc("tlq.alpha", 5.0)
        first = tl.tick_now()
        assert first["dur_s"] is None  # no boundary before the first
        m.inc("tlq.alpha", 7.0)
        m.inc("tlq.beta", 2.0)
        assert tl.tick_now()["dur_s"] >= 0.0
        assert "tlq.alpha" not in tl.tick_now()["counters"]
    got, want = (pkg["timeline"].snapshot_timeline() for pkg in (PORT, REF))
    assert untimed_ticks(got) == untimed_ticks(want)
    for key, total in (("tlq.alpha", 12.0), ("tlq.beta", 2.0)):
        assert sum(t["counters"].get(key, 0.0) for t in got["ticks"]) == \
            metrics.snapshot()[key] == total


def test_histogram_quantiles_per_tick_are_the_references():
    for pkg in (PORT, REF):
        for _ in range(20):
            pkg["telemetry"].observe("tlq.fast_s", 0.001)
        pkg["timeline"].tick_now()
        for _ in range(20):
            pkg["telemetry"].observe("tlq.fast_s", 0.5)
        pkg["timeline"].tick_now()
        pkg["timeline"].tick_now()
    got, want = (pkg["timeline"].snapshot_timeline() for pkg in (PORT, REF))
    assert untimed_ticks(got) == untimed_ticks(want)
    h1, h2 = (t["histograms"]["tlq.fast_s"] for t in got["ticks"][:2])
    assert (h1["count"], h2["count"]) == (20, 20)
    assert h2["p50"] >= 0.5 > h1["p50"]
    assert sum(c for _le, c in h2["buckets"]) == 20
    assert h2["sum"] == pytest.approx(10.0, rel=1e-9)
    assert "histograms" not in got["ticks"][2]


def test_retention_keeps_the_newest_ticks(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_TIMELINE_RETENTION", "5")
    assert timeline.retention() == ref_timeline.retention() == 5
    stamps = []
    for _ in range(9):
        metrics.inc("tlq.mark")
        stamps.append(timeline.tick_now()["ts"])
    sec = timeline.snapshot_timeline()
    assert [t["ts"] for t in sec["ticks"]] == stamps[-5:]
    assert sec["retention"] == 5


def test_the_knob_defaults_are_the_references(monkeypatch):
    assert timeline.interval_s() == ref_timeline.interval_s() == 10.0
    assert timeline.retention() == ref_timeline.retention() == 360
    monkeypatch.setenv("PYRUHVRO_TPU_TIMELINE_INTERVAL_S", "0.001")
    assert timeline.interval_s() == ref_timeline.interval_s() == 0.05
    assert incident._max_files() == ref_incident._max_files() == 16
    assert incident.DEBOUNCE_S == ref_incident.DEBOUNCE_S


def test_event_ring_and_drops_are_the_references():
    for tl in (timeline, ref_timeline):
        for i in range(tl.EVENT_RING + 50):
            tl.event("tlq.spam", attrs={"i": i})
    assert events(timeline) == events(ref_timeline)
    sec = timeline.snapshot_timeline()
    assert len(sec["events"]) == timeline.EVENT_RING
    assert sec["events_dropped"] == 50
    assert sec["events"][0]["attrs"]["i"] == 50
    assert "dropped" in timeline.render_timeline(sec).splitlines()[0]


def test_severity_rule_and_kill_switch(monkeypatch):
    assert timeline.event("tlq.odd", severity="dire")["severity"] == "info"
    monkeypatch.setenv("PYRUHVRO_TPU_NO_TIMELINE", "1")
    assert timeline.event("tlq.gone") is None
    assert timeline.tick_now() is None
    assert timeline.ensure_started() is False
    monkeypatch.delenv("PYRUHVRO_TPU_NO_TIMELINE")
    # the thread started at the import of runtime/telemetry.py
    assert timeline.ensure_started() is True
    assert timeline._thread.daemon and timeline._thread.is_alive()


def test_section_and_rendering_are_the_references():
    # no section before the first tick (read without a whole snapshot,
    # whose memory probes would publish the port's mem.* gauges into the
    # ticks below and not the reference's)
    assert not timeline.snapshot_timeline()
    for pkg in (PORT, REF):
        pkg["metrics"].inc("tlq.one")
        pkg["timeline"].tick_now()
        pkg["timeline"].event("tlq.mid", severity="warn", attrs={"z": 1})
        pkg["metrics"].inc("tlq.two")
        pkg["timeline"].tick_now()
    got = telemetry.snapshot()["timeline"]
    want = ref.telemetry.snapshot()["timeline"]
    assert set(got) == set(want)
    assert untimed_ticks(got) == untimed_ticks(want)
    assert events(timeline) == events(ref_timeline)
    assert {k: got[k] for k in ("interval_s", "retention",
                                "events_dropped")} == \
        {k: want[k] for k in ("interval_s", "retention", "events_dropped")}
    assert timeline.render_timeline(got) == ref_timeline.render_timeline(got)
    rows = [ln for ln in timeline.render_timeline(got).splitlines()[2:]]
    assert "tlq.one" in rows[0] and "tlq.mid" in rows[1] and \
        "tlq.two" in rows[2]
    legacy = {"counters": {}, "histograms": {}}
    assert timeline.render_timeline(legacy) == \
        ref_timeline.render_timeline(legacy)


# -- the events of the planes --------------------------------------------------


def test_breaker_events_are_the_references():
    for pkg in (PORT, REF):
        b = pkg["breaker"].get("tlq")
        for _ in range(b.threshold()):
            b.record_failure()
        b.force_open(0.0)
        assert b.state() == "half_open"
        b.record_success()
    names = {"breaker.opened", "breaker.half_open", "breaker.closed"}
    got = events(timeline, names)
    assert got == events(ref_timeline, names)
    assert [e["name"] for e in got] == ["breaker.opened", "breaker.opened",
                                        "breaker.half_open",
                                        "breaker.closed"]
    assert got[0]["severity"] == "warn"


def test_drift_event_is_the_references():
    for pkg in (PORT, REF):
        for i in range(30):
            pkg["drift"].observe("fp", "decode", 3, "native/c1/none",
                                 1e-6 if i < 12 else 1e-4)
    got = events(timeline, {"drift.detected"})
    assert got and got == events(ref_timeline, {"drift.detected"})
    assert got[0]["severity"] == "incident"


def test_quarantine_storm_event_is_the_references():
    for pkg in (PORT, REF):
        q = pkg["quarantine"]
        q.publish([q.QuarantinedRecord(i, b"", "truncated", "native")
                   for i in range(q.STORM if pkg is PORT else 100)], "skip")
    got = events(timeline, {"quarantine.storm"})
    assert got == events(ref_timeline, {"quarantine.storm"})
    assert got[0]["attrs"] == {"op": "decode", "entries": 100,
                               "policy": "skip"}


def test_recompile_storm_event_is_the_references():
    for i in range(device_obs.churn_threshold()):
        device_obs.note_compile("fp", "decode.pipeline", f"R{i}")
        ref_device_obs.note_compile("fp", "decode.pipeline", f"R{i}", 0.0)
    got = events(timeline, {"device.recompile_storm"})
    assert got == events(ref_timeline, {"device.recompile_storm"})
    assert got == [{"name": "device.recompile_storm",
                    "severity": "incident", "attrs": {"schema": "fp"}}]


def test_slo_breach_and_recovery_events_are_the_references(tmp_path,
                                                           monkeypatch):
    class Clock:
        now = 5000.0

        def monotonic(self):
            return self.now

    clock = Clock()
    monkeypatch.setattr(slo, "time", clock)
    monkeypatch.setattr(ref_slo, "time", clock)
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"version": 1, "objectives": [{
        "name": "t-decode", "op": "decode", "threshold_s": 0.01,
        "target": 0.5, "windows_s": [2, 4], "burn_threshold": 1.5,
        "min_calls": 5}]}))
    monkeypatch.setenv("PYRUHVRO_TPU_SLO_FILE", str(path))
    for i in range(30):
        clock.now += 0.3
        for mod in (slo, ref_slo):
            mod.record("decode", "fp", 0.02 if i < 12 else 0.001,
                       error=False)
            mod.breached()
    names = {"slo.breach", "slo.recovered"}
    got = events(timeline, names)
    assert got == events(ref_timeline, names)
    assert [e["name"] for e in got] == ["slo.breach", "slo.recovered"]


def test_audit_mismatch_event_is_the_references(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_AUDIT_BUDGET", "1.0")
    datums = datagen.kafka_style_datums(20, seed=9)
    for pkg, kw in ((PORT, HOST), (REF, {"backend": "host"})):
        real = pkg["api"]._maybe_audit_decode

        def cut(dec, entry, data, bounds, on_error, result, real=real):
            real(dec, entry, data, bounds, on_error, result.slice(0, 15))

        monkeypatch.setattr(pkg["api"], "_maybe_audit_decode", cut)
        pkg["audit"].force_next()
        pkg["pkg"].deserialize_array(datums, KAFKA, **kw)
    got = events(timeline, {"audit.mismatch"})
    assert got == events(ref_timeline, {"audit.mismatch"})
    assert got[0]["severity"] == "incident"
    assert got[0]["attrs"]["column"] == "#rows"


# -- incident bundles ------------------------------------------------------------


def test_bundle_debounce_coalesces_a_storm(tmp_path, monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_INCIDENT_DIR", str(tmp_path))
    assert incident.request("first") is True
    assert incident.request("second") is False  # coalesced
    path = incident.maybe_capture()
    assert os.path.basename(path).endswith("_first.json")
    assert incident.request("third") is False  # debounced
    assert incident.maybe_capture() is None
    assert [p.name for p in tmp_path.glob("incident_*.json")] == [
        os.path.basename(path)]
    c = metrics.snapshot()
    assert (c["incident.captured"], c["incident.debounced"],
            c["incident.requested"]) == (1, 2, 1)


def test_no_directory_no_bundle():
    assert incident.request("nowhere") is False
    assert incident.maybe_capture() is None
    assert incident.capture_now("nowhere") is None
    assert "incident.requested" not in metrics.snapshot()
    assert incident.list_incidents() == ref_incident.list_incidents()


def test_rotation_spares_hand_saved_files(tmp_path, monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_INCIDENT_DIR", str(tmp_path))
    monkeypatch.setenv("PYRUHVRO_TPU_INCIDENT_MAX_FILES", "3")
    keep = tmp_path / "incident_keep.json"
    keep.write_text("{}")
    paths = []
    for i in range(6):
        paths.append(incident.capture_now(f"trig{i}"))
        os.utime(paths[-1], (i, i))
    names = sorted(n for n in os.listdir(tmp_path)
                   if incident._NAME_RE.match(n))
    assert names == sorted(os.path.basename(p) for p in paths[-3:])
    assert keep.exists()
    assert metrics.snapshot()["incident.dropped"] == 3


def test_sections_are_isolated_and_keyed_as_the_references(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_INCIDENT_DIR", str(tmp_path))
    port.deserialize_array(datagen.kafka_style_datums(16, seed=2), KAFKA,
                           **HOST)
    ref.deserialize_array(datagen.kafka_style_datums(16, seed=2), KAFKA,
                          backend="host")
    docs = []
    for pkg in (PORT, REF):
        pkg["timeline"].tick_now()
        pkg["timeline"].event("tlq.blow", severity="warn")
        with open(pkg["incident"].capture_now(
                "evidence", attrs={"why": "test"})) as f:
            docs.append(json.load(f))
    got, want = docs
    assert set(got) == set(want)
    assert set(got["health"]) == set(want["health"])
    assert got["health"]["unhealthy_bits"] == want["health"]["unhealthy_bits"]
    assert (got["trigger"], got["attrs"]) == ("evidence", {"why": "test"})
    assert got["knobs"]["PYRUHVRO_TPU_INCIDENT_DIR"] == str(tmp_path)
    assert got["routing_tail"] and "records" in got["flight"]
    assert incident.render_incident_report(got) == \
        ref_incident.render_incident_report(got)

    def boom():
        raise RuntimeError("flight plane down")

    monkeypatch.setattr(telemetry, "flight_dump", boom)
    incident.reset()
    with open(incident.capture_now("partial")) as f:
        doc = json.load(f)
    assert "flight" not in doc and "RuntimeError" in \
        doc["section_errors"]["flight"]
    assert doc["counters"] and doc["timeline"]
    assert metrics.snapshot()["incident.section_error"] == 1
    assert "section errors: flight" in incident.render_incident_report(doc)


@pytest.mark.parametrize("kind", ["error", "hang"])
def test_the_incident_capture_seam_counts_as_the_references(
        kind, tmp_path, monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_INCIDENT_DIR", str(tmp_path))
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", f"incident_capture:{kind}:1")
    monkeypatch.setenv("PYRUHVRO_TPU_FAULT_HANG_S", "0.01")
    got = incident.capture_now("chaos")
    want = ref_incident.capture_now("chaos")
    assert (got is None) == (want is None) == (kind == "error")
    for key in ("fault.injected.incident_capture", "incident.capture_failed",
                "incident.captured"):
        assert metrics.snapshot().get(key) == \
            ref_metrics.snapshot().get(key), key
    # a failed write arms the debounce too: a broken disk is no write storm
    assert incident.request("again") is False


def test_the_tick_thread_writes_one_bundle_for_a_storm(tmp_path,
                                                      monkeypatch, capsys):
    """A quarantine storm through the public call: /healthz goes 503, the
    tick thread (woken by the incident event) writes exactly one bundle,
    a second storm is debounced, and ``incident-report`` renders it."""
    monkeypatch.setenv("PYRUHVRO_TPU_INCIDENT_DIR", str(tmp_path))
    bad = [b"\x02"] * quarantine.STORM  # a string length past the end
    for _ in range(2):
        out = port.deserialize_array(bad, KAFKA, on_error="skip", **HOST)
        assert out.num_rows == 0
    code, body = obs_server.health()
    assert code == 503 and body["unhealthy_bits"]["quarantine_storm"]
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline and \
            not list(tmp_path.glob("incident_*.json")):
        time.sleep(0.02)
    time.sleep(0.2)
    [bundle] = tmp_path.glob("incident_*.json")
    doc = json.loads(bundle.read_text())
    assert doc["trigger"] == "quarantine.storm"
    assert doc["health"]["code"] == 503
    assert [e["severity"] for e in doc["timeline"]["events"]
            if e["name"] == "quarantine.storm"][0] == "incident"
    assert metrics.snapshot()["incident.debounced"] >= 1
    assert telemetry.main(["incident-report", str(bundle)]) == 0
    out = capsys.readouterr().out
    assert "breach interval" in out and "quarantine.storm" in out
    assert "503" in out
    listing = incident.list_incidents()
    assert [e["file"] for e in listing["incidents"]] == [bundle.name]
    assert listing["incidents"][0]["pid"] == os.getpid()


def test_timeline_and_incident_cli_exit_codes(tmp_path, capsys):
    timeline.event("tlq.cli", severity="warn")
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps(telemetry.snapshot(), default=str))
    assert telemetry.main(["timeline", str(snap)]) == 0
    assert "tlq.cli" in capsys.readouterr().out
    assert telemetry.main(["timeline", str(snap), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["events"][0]["name"] == \
        "tlq.cli"
    assert telemetry.main(["incident-report", str(snap)]) == 0
    assert "not an incident bundle" in capsys.readouterr().out
    legacy = tmp_path / "legacy.json"
    legacy.write_text('{"counters": {}, "histograms": {}}')
    assert telemetry.main(["timeline", str(legacy)]) == 0
    assert "no timeline section" in capsys.readouterr().out
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{oops")
    other = tmp_path / "other.json"
    other.write_text('{"foo": 1}')
    for cmd in ("timeline", "incident-report"):
        for path in (tmp_path / "missing.json", garbage, other):
            assert telemetry.main([cmd, str(path)]) == 2, (cmd, path)
    capsys.readouterr()
