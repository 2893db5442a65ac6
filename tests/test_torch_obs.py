"""The port's obs server (``pyruhvro_tpu_torch/runtime/obs_server.py``, a
copy of the reference's) held against the reference on the CPU, bound to
127.0.0.1 in the test process.

* **Health.** After the same quarantine storm, recompile storm, drift,
  SLO breach and audit mismatch, ``health()``'s code, status and
  unhealthy bits equal the reference's; the degraded bits read the
  port's own state (``device_backend`` ``"imported"``, ``native_ext``
  from the module cache) and an open breaker degrades as in the
  reference. A saved snapshot's health is the reference's.
* **Endpoints.** ``/metrics`` is byte-identical to
  ``telemetry.prometheus()`` (and with ``?exemplars=1``); ``/healthz``,
  ``/snapshot`` (and ``?compress=1``), ``/flight``, ``/audit``,
  ``/timeline`` (and ``?tick=1``), ``/incidents``, ``/serve`` and
  ``/memory`` answer; unknown paths answer 404; a handler error answers 500
  and counts, through the ``obs_handler`` seam as in the reference.
* **Start.** ``PYRUHVRO_TPU_OBS_PORT`` starts the server at import and
  never in a spawn-pool worker; a bad port counts; the CLI's ``serve``
  exits 2 on a bad file.
"""

import gzip
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu import api as ref_api  # noqa: E402
from pyruhvro_tpu.runtime import audit as ref_audit  # noqa: E402
from pyruhvro_tpu.runtime import breaker as ref_breaker  # noqa: E402
from pyruhvro_tpu.runtime import device_obs as ref_device_obs  # noqa: E402
from pyruhvro_tpu.runtime import drift as ref_drift  # noqa: E402
from pyruhvro_tpu.runtime import faults as ref_faults  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402
from pyruhvro_tpu.runtime import obs_server as ref_obs  # noqa: E402
from pyruhvro_tpu.runtime import quarantine as ref_quarantine  # noqa: E402
from pyruhvro_tpu.runtime import slo as ref_slo  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch import api  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    audit,
    breaker,
    device_obs,
    drift,
    faults,
    metrics,
    obs_server,
    quarantine,
    slo,
    telemetry,
    timeline,
)
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KAFKA = datagen.KAFKA_SCHEMA_JSON
HOST = {"backend": "host", "device": "cpu"}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in ("PYRUHVRO_TPU_OBS_PORT", "PYRUHVRO_TPU_FAULTS",
                 "PYRUHVRO_TPU_SLO_FILE", "PYRUHVRO_TPU_INCIDENT_DIR",
                 "PYRUHVRO_TPU_HEALTH_WINDOW", "PYRUHVRO_TPU_AUDIT_BUDGET",
                 "PYRUHVRO_TPU_FLIGHT_DIR", "PYRUHVRO_TPU_POOL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")

    def reset():
        for mod in (telemetry, ref.telemetry, breaker, ref_breaker, faults,
                    ref_faults):
            mod.reset()

    reset()
    yield
    obs_server.stop()
    reset()


@pytest.fixture
def server():
    srv = obs_server.ObsServer(port=0).start()
    yield srv
    srv.stop()


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


# -- health: the same triggers through both packages ------------------------------


def _storm(mods):
    q = mods["quarantine"]
    n = q.STORM if hasattr(q, "STORM") else 100
    q.publish([q.QuarantinedRecord(i, b"", "truncated", "native")
               for i in range(n)], "skip")


def _recompile(mods):
    d = mods["device_obs"]
    for i in range(d.churn_threshold()):
        if d is device_obs:
            d.note_compile("fp", "decode.pipeline", f"R{i}")
        else:
            d.note_compile("fp", "decode.pipeline", f"R{i}", 0.0)


def _drift(mods):
    for i in range(30):
        mods["drift"].observe("fp", "decode", 3, "native/c1/none",
                              1e-6 if i < 12 else 1e-4)


def _mismatch(mods, monkeypatch):
    real = mods["api"]._maybe_audit_decode

    def cut(dec, entry, data, bounds, on_error, result):
        real(dec, entry, data, bounds, on_error, result.slice(0, 5))

    monkeypatch.setattr(mods["api"], "_maybe_audit_decode", cut)
    monkeypatch.setenv("PYRUHVRO_TPU_AUDIT_BUDGET", "1.0")
    mods["audit"].force_next()
    kw = HOST if mods["pkg"] is port else {"backend": "host"}
    mods["pkg"].deserialize_array(datagen.kafka_style_datums(10, seed=1),
                                  KAFKA, **kw)


PORT = dict(quarantine=quarantine, device_obs=device_obs, drift=drift,
            api=api, audit=audit, pkg=port, slo=slo, obs=obs_server)
REF = dict(quarantine=ref_quarantine, device_obs=ref_device_obs,
           drift=ref_drift, api=ref_api, audit=ref_audit, pkg=ref,
           slo=ref_slo, obs=ref_obs)


def _slo_breach(tmp_path, monkeypatch):
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
    for _ in range(12):
        clock.now += 0.3
        for mod in (slo, ref_slo):
            mod.record("decode", "fp", 0.02, error=False)


def _health_pair():
    (c1, b1), (c2, b2) = obs_server.health(), ref_obs.health()
    return (c1, b1["status"], b1["unhealthy_bits"], b1.get("slo_breached")), \
        (c2, b2["status"], b2["unhealthy_bits"], b2.get("slo_breached"))


@pytest.mark.parametrize("trigger", ["storm", "recompile", "drift", "slo",
                                     "mismatch", "all"])
def test_health_bits_are_the_references(trigger, tmp_path, monkeypatch):
    got, want = _health_pair()
    assert got == want and got[0] == 200
    if trigger in ("slo", "all"):
        _slo_breach(tmp_path, monkeypatch)
    for mods in (PORT, REF):
        if trigger in ("storm", "all"):
            _storm(mods)
        if trigger in ("recompile", "all"):
            _recompile(mods)
        if trigger in ("drift", "all"):
            _drift(mods)
        if trigger in ("mismatch", "all"):
            _mismatch(mods, monkeypatch)
    got, want = _health_pair()
    assert got == want
    assert got[0] == 503 and got[1] == "unhealthy"
    bit = {"storm": "quarantine_storm", "recompile": "recompile_storm",
           "drift": "latency_drift", "slo": "slo_breach",
           "mismatch": "audit_mismatch"}
    on = {k for k, v in got[2].items() if v}
    assert on == (set(bit.values()) if trigger == "all" else {bit[trigger]})
    # the window ages the marks out (the SLO bit is live, not a mark)
    monkeypatch.setenv("PYRUHVRO_TPU_HEALTH_WINDOW", "0")
    if trigger not in ("slo", "all"):
        import time

        time.sleep(0.01)
        assert _health_pair()[0] == _health_pair()[1]
        assert obs_server.health()[0] == 200


def test_degraded_bits_read_the_ports_state():
    code, body = obs_server.health()
    deg = body["degraded_bits"]
    assert set(body) == set(ref_obs.health()[1])
    assert set(deg) == set(ref_obs.health()[1]["degraded_bits"])
    # the device codec's module is imported by the API
    assert deg["device_backend"] == "imported"
    assert deg["native_ext"] in ("loaded", "unprobed")
    port.deserialize_array(datagen.kafka_style_datums(4, seed=1), KAFKA,
                           **HOST)
    assert obs_server.health()[1]["degraded_bits"]["native_ext"] == "loaded"
    assert deg["brownout"] == [] and deg["shedding"] is False
    for b in (breaker, ref_breaker):
        b.get("process_pool").force_open(60.0)
    (c1, b1), (c2, b2) = obs_server.health(), ref_obs.health()
    assert (c1, b1["status"]) == (c2, b2["status"]) == (200, "degraded")
    assert b1["degraded_bits"]["breakers"] == \
        b2["degraded_bits"]["breakers"] == {"process_pool": "open"}
    assert b1["degraded_bits"]["spawn_pool_broken"] is True


def test_saved_snapshot_health_is_the_references(tmp_path, monkeypatch):
    _slo_breach(tmp_path, monkeypatch)
    _storm(PORT)
    snap = json.loads(json.dumps(telemetry.snapshot(), default=str))
    got = obs_server._static_health(snap)
    assert got == ref_obs._static_health(snap)
    assert got[0] == 503 and got[1]["recorded"]["quarantine_storms"] == 1
    srv = obs_server.ObsServer(port=0, snapshot=snap).start()
    try:
        code, body, _ = get(srv.url + "/healthz")
        assert (code, json.loads(body)) == got
        code, body, _ = get(srv.url + "/metrics")
        assert body.decode() == telemetry.prometheus(snap)
        for path in ("/flight", "/incidents", "/audit", "/serve"):
            code, body, _ = get(srv.url + path)
            assert code == 200 and json.loads(body)["static"] is True, path
        # the storm's event is in the saved timeline section
        code, body, _ = get(srv.url + "/timeline")
        assert json.loads(body) == snap["timeline"]
        assert [e["name"] for e in snap["timeline"]["events"]] == [
            "slo.breach", "quarantine.storm"]
    finally:
        srv.stop()


# -- the endpoints ----------------------------------------------------------------


def test_metrics_are_byte_identical(server):
    port.deserialize_array(datagen.kafka_style_datums(20, seed=2), KAFKA,
                           **HOST)
    code, body, headers = get(server.url + "/metrics")
    assert code == 200 and headers["Content-Type"].startswith("text/plain")
    # the request itself counts obs.requests before rendering
    assert body.decode() == telemetry.prometheus()
    code, body, _ = get(server.url + "/metrics?exemplars=1")
    assert body.decode() == telemetry.prometheus(exemplars=True)
    assert "# {trace_id=" in body.decode()


def test_healthz_snapshot_and_flight(server):
    code, body, _ = get(server.url + "/healthz")
    assert code == 200 and json.loads(body)["status"] in ("ok", "degraded")
    port.deserialize_array(datagen.kafka_style_datums(20, seed=2), KAFKA,
                           **HOST)
    code, body, _ = get(server.url + "/snapshot")
    snap = json.loads(body)
    assert code == 200 and snap["schema_version"] == 3
    assert snap["counters"]["obs.requests"] == 2
    code, body, headers = get(server.url + "/snapshot?compress=1")
    assert headers["Content-Encoding"] == "gzip"
    assert json.loads(gzip.decompress(body))["pid"] == os.getpid()
    code, body, _ = get(server.url + "/flight")
    [rec] = json.loads(body)["records"]
    assert rec["name"] == "api.deserialize_array"
    _storm(PORT)
    code, body, _ = get(server.url + "/healthz/")
    assert code == 503
    assert json.loads(body)["unhealthy_bits"]["quarantine_storm"] is True


def test_audit_timeline_incidents_and_serve(server, tmp_path, monkeypatch):
    code, body, _ = get(server.url + "/audit")
    assert (code, json.loads(body)) == (200, {})
    code, body, _ = get(server.url + "/timeline")
    assert (code, json.loads(body)) == (200, {})
    metrics.inc("tlq.live")
    code, body, _ = get(server.url + "/timeline?tick=1")
    [tick] = json.loads(body)["ticks"]
    assert tick["counters"]["tlq.live"] == 1
    monkeypatch.setenv("PYRUHVRO_TPU_AUDIT_BUDGET", "1.0")
    audit.force_next()
    port.deserialize_array(datagen.kafka_style_datums(20, seed=2), KAFKA,
                           **HOST)
    code, body, _ = get(server.url + "/audit")
    assert json.loads(body)["audited"] == 1
    code, body, _ = get(server.url + "/incidents")
    assert json.loads(body) == {"dir": None, "incidents": [],
                                "note": "PYRUHVRO_TPU_INCIDENT_DIR is not set"}
    monkeypatch.setenv("PYRUHVRO_TPU_INCIDENT_DIR", str(tmp_path))
    from pyruhvro_tpu_torch.runtime import incident

    path = incident.capture_now("drill")
    code, body, _ = get(server.url + "/incidents")
    [entry] = json.loads(body)["incidents"]
    assert entry["file"] == os.path.basename(path)
    assert entry["trigger"] == "drill"
    code, body, _ = get(server.url + "/serve")
    assert (code, json.loads(body)) == (200, {})


def test_unknown_paths_and_memory_answer_404(server):
    # unknown paths answer 404 with the endpoint list; /memory, once
    # answered 404 here, is served since memory accounting was ported
    for path in ("/nope", "/metrics/extra"):
        code, body, _ = get(server.url + path)
        doc = json.loads(body)
        assert code == 404 and path in doc["error"]
        assert doc["endpoints"] == list(obs_server.ENDPOINTS)
    assert "/memory" in obs_server.ENDPOINTS
    code, body, _ = get(server.url + "/memory")
    doc = json.loads(body)
    assert code == 200 and doc["rss_bytes"] > 0
    assert {"tracked_bytes", "caches", "lifecycle"} <= set(doc)


def test_a_handler_error_answers_500_as_the_reference(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "obs_handler:error:1")
    codes = []
    for mod in (obs_server, ref_obs):
        srv = mod.ObsServer(port=0).start()
        try:
            code, body, _ = get(srv.url + "/metrics")
            codes.append((code, "FaultInjected" in json.loads(body)["error"]))
        finally:
            srv.stop()
    assert codes == [(500, True), (500, True)]
    for key in ("obs.handler_error", "obs.requests",
                "fault.injected.obs_handler"):
        assert metrics.snapshot()[key] == ref_metrics.snapshot()[key] == 1


# -- start ----------------------------------------------------------------------


def test_start_from_env_and_its_guards(monkeypatch):
    assert obs_server.start_from_env() is None  # unset: no server
    monkeypatch.setenv("PYRUHVRO_TPU_OBS_PORT", "x")
    assert obs_server.start_from_env() is None
    assert metrics.snapshot()["obs.bad_port"] == 1
    monkeypatch.setenv("PYRUHVRO_TPU_OBS_PORT", "0")
    import multiprocessing

    monkeypatch.setattr(multiprocessing, "parent_process", lambda: object())
    assert obs_server.start_from_env() is None  # a spawn-pool worker
    monkeypatch.undo()
    monkeypatch.setenv("PYRUHVRO_TPU_OBS_PORT", "0")
    srv = obs_server.start_from_env()
    assert srv is obs_server.server() is obs_server.start()
    assert srv.host == "127.0.0.1"
    code, _, _ = get(srv.url + "/healthz")
    assert code == 200
    obs_server.stop()
    assert obs_server.server() is None


def test_the_import_starts_the_server_and_the_timeline():
    code = ("import urllib.request, pyruhvro_tpu_torch\n"
            "from pyruhvro_tpu_torch.runtime import obs_server, timeline\n"
            "srv = obs_server.server()\n"
            "r = urllib.request.urlopen(srv.url + '/healthz', timeout=10)\n"
            "print(r.status, timeline._thread.is_alive())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), PYRUHVRO_TPU_OBS_PORT="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["200", "True"]
    assert "obs server listening on http://127.0.0.1:" in out.stderr
    assert "jax" not in out.stderr


def test_serve_cli_exit_codes(tmp_path, capsys):
    garbage = tmp_path / "garbage.json"
    garbage.write_text("[")
    other = tmp_path / "other.json"
    other.write_text('{"foo": 1}')
    for path in (tmp_path / "missing.json", garbage, other):
        assert telemetry.main(["serve", str(path)]) == 2
    assert "error:" in capsys.readouterr().err
    assert timeline.enabled()
