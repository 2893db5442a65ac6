"""The port's SLO engine (``pyruhvro_tpu_torch/runtime/slo.py``, a copy of
``pyruhvro_tpu/runtime/slo.py``) and flight recorder
(``runtime/telemetry.py``), held against the reference on the CPU.

* **SLO.** The burn-rate math, breach and recovery run on an injected
  clock (both modules' ``time`` replaced), never the wall clock, and
  give the reference's window stats and transitions. The error target
  counts errored calls; schema and op matching picks the right calls;
  a missing or corrupt config leaves the engine inactive and the calls
  working. A breach through the port's public calls writes a flight
  dump and runs its ``alert_command`` (a file under ``tmp_path``); an
  ``slo_alert`` fault counts ``slo.alert_error`` and the call survives.
* **Flight.** Root spans land in the ring as the reference's compact
  records; an errored call auto-dumps, at most once a second; rotation
  keeps the newest auto-dumps, spares other files, and 0 means no
  limit; the snapshot, report and ``slo-report`` CLI render them.
"""

import json
import os
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.runtime import metrics as ref_metrics  # noqa: E402
from pyruhvro_tpu.runtime import slo as ref_slo  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.errors import MalformedAvro  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    faults,
    metrics,
    slo,
    telemetry,
)
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

KAFKA = datagen.KAFKA_SCHEMA_JSON


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in ("PYRUHVRO_TPU_SLO_FILE", "PYRUHVRO_TPU_FLIGHT_DIR",
                 "PYRUHVRO_TPU_FLIGHT_MAX_FILES", "PYRUHVRO_TPU_FAULTS",
                 "PYRUHVRO_TPU_POOL", "PYRUHVRO_TPU_AUTOTUNE",
                 "PYRUHVRO_TPU_NO_NATIVE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")
    telemetry.reset()
    ref.telemetry.reset()
    faults.reset()
    yield
    monkeypatch.delenv("PYRUHVRO_TPU_SLO_FILE", raising=False)
    telemetry.reset()
    ref.telemetry.reset()
    faults.reset()


class Clock:
    """An injected ``time`` module for the SLO engine."""

    def __init__(self, now=5000.0):
        self.now = now

    def monotonic(self):
        return self.now


@pytest.fixture
def clocks(monkeypatch):
    """One clock for both SLO modules."""
    c = Clock()
    monkeypatch.setattr(slo, "time", c)
    monkeypatch.setattr(ref_slo, "time", c)
    return c


def slo_file(tmp_path, **over):
    obj = {
        "name": "t-decode", "op": "decode", "schema": "*",
        "threshold_s": 1e-9, "target": 0.5, "windows_s": [1, 5],
        "burn_threshold": 1.5, "min_calls": 5,
    }
    obj.update(over)
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"version": 1, "objectives": [obj]}))
    return str(path)


def without_file(sec):
    return {k: v for k, v in sec.items() if k != "file"}


# -- the burn-rate math --------------------------------------------------------


def test_burn_rate_math_and_recovery_are_the_reference():
    """target 0.9: a budget of 0.1; 2 bad of 10 in the window is a burn
    of 2.0. The long window must burn too before a breach; recovery
    clears on the short window."""
    conf = {"name": "u", "op": "decode", "threshold_s": 1.0, "target": 0.9,
            "windows_s": [5, 50], "burn_threshold": 1.9, "min_calls": 10}
    got, want = slo._Objective(conf, 0), ref_slo._Objective(conf, 0)
    now = 1000.0
    for o in (got, want):
        for i in range(8):
            o.add(now + i * 0.1, 0.1, False)
        for i in range(2):
            o.add(now + 1 + i * 0.1, 5.0, False)
    stats = got.window_stats(now + 2)
    assert stats == want.window_stats(now + 2)
    assert stats[0]["total"] == 10 and stats[0]["bad"] == 2
    assert stats[0]["burn_rate"] == pytest.approx(2.0, abs=1e-6)
    assert got.evaluate(now + 2) is want.evaluate(now + 2) is True
    for o in (got, want):
        for i in range(200):
            o.add(now + 2.5 + i * 0.01, 0.1, False)
    assert got.evaluate(now + 4.6) is want.evaluate(now + 4.6) is False
    assert got.export(now + 5) == want.export(now + 5)


def test_record_breach_and_recovery_match_the_reference(tmp_path,
                                                        monkeypatch, clocks):
    """The same calls at the same injected instants through both
    engines: the same verdicts, sections and counters, a breach once
    ``min_calls`` bad calls fill both windows, and recovery by time decay
    alone (no new calls)."""
    monkeypatch.setenv("PYRUHVRO_TPU_SLO_FILE", slo_file(
        tmp_path, windows_s=[2, 4], min_calls=5, threshold_s=0.01))
    trace = []
    for i in range(30):
        clocks.now += 0.3
        dur = 0.02 if i < 12 else 0.001
        for mod in (slo, ref_slo):
            mod.record("decode", "fp", dur, error=(i == 7))
        trace.append((slo.breached(), ref_slo.breached()))
    assert all(a == b for a, b in trace)
    assert ["t-decode"] in [a for a, _b in trace]
    assert trace[-1] == ([], [])
    assert without_file(slo.snapshot_slo()) == \
        without_file(ref_slo.snapshot_slo())
    for key in ("slo.calls", "slo.errors", "slo.breach", "slo.recovered",
                "slo.breach.t-decode"):
        assert metrics.snapshot().get(key) == \
            ref_metrics.snapshot().get(key), key
    assert metrics.snapshot()["slo.breach"] == 1
    assert metrics.snapshot()["slo.recovered"] == 1


def test_the_error_target_counts_errored_calls(tmp_path, monkeypatch,
                                               clocks):
    monkeypatch.setenv("PYRUHVRO_TPU_SLO_FILE", slo_file(
        tmp_path, threshold_s=None, target=0.999, error_target=0.01,
        burn_threshold=1.0, min_calls=3))
    bad = [d[:2] for d in datagen.kafka_style_datums(10, seed=5)]
    for _ in range(4):
        clocks.now += 0.1
        with pytest.raises(MalformedAvro):
            port.deserialize_array(bad, KAFKA, device="cpu")
    assert metrics.snapshot()["slo.errors"] == 4
    assert slo.breached() == ["t-decode"]


def test_schema_and_op_matching(tmp_path, monkeypatch, clocks):
    data = datagen.kafka_style_datums(20, seed=5)
    fp = port.api.get_or_parse_schema(KAFKA).fingerprint
    monkeypatch.setenv("PYRUHVRO_TPU_SLO_FILE", slo_file(
        tmp_path, op="encode", schema=fp))
    batch = port.deserialize_array(data, KAFKA, device="cpu")
    for _ in range(8):
        clocks.now += 0.1
        port.deserialize_array(data, KAFKA, device="cpu")
    assert slo.breached() == []  # decode calls never match an encode SLO
    other = KAFKA.replace('"name"', '"doc":"slo-other","name"', 1)
    for _ in range(8):
        clocks.now += 0.1
        port.serialize_record_batch(batch, other, 1, device="cpu")
    assert slo.breached() == []  # another schema's fingerprint
    for _ in range(8):
        clocks.now += 0.1
        port.serialize_record_batch(batch, KAFKA, 1, device="cpu")
    assert slo.breached() == ["t-decode"]
    assert metrics.snapshot()["slo.calls"] == 8


def test_a_missing_or_corrupt_config_is_inactive(tmp_path, monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SLO_FILE", str(tmp_path / "none.json"))
    assert not slo.active() and slo.breached() == []
    assert metrics.snapshot()["slo.config_error"] == 1
    assert telemetry.snapshot()["slo"]["config_error"]
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv("PYRUHVRO_TPU_SLO_FILE", str(bad))
    assert not slo.active()
    data = datagen.kafka_style_datums(5, seed=5)
    assert port.deserialize_array(data, KAFKA, device="cpu").num_rows == 5
    assert metrics.snapshot()["slo.config_error"] == 2


def test_a_breach_dumps_the_flight_recorder_and_alerts(tmp_path,
                                                       monkeypatch, clocks):
    flag = tmp_path / "alert_fired"
    dumps = tmp_path / "flight"
    dumps.mkdir()
    monkeypatch.setenv("PYRUHVRO_TPU_FLIGHT_DIR", str(dumps))
    monkeypatch.setenv("PYRUHVRO_TPU_SLO_FILE", slo_file(
        tmp_path, alert_command=f"{sys.executable} -c "
                                f"\"open(r'{flag}', 'w').write('x')\""))
    data = datagen.kafka_style_datums(30, seed=5)
    for _ in range(8):
        clocks.now += 0.1
        port.deserialize_array_threaded(data, KAFKA, 2, device="cpu")
    assert slo.breached() == ["t-decode"]
    [dump] = [f for f in os.listdir(dumps) if f.endswith("slo_breach.json")]
    doc = json.loads((dumps / dump).read_text())
    assert doc["pid"] == os.getpid() and doc["records"]
    assert any(k.startswith("device.") for k in doc["records"][-1]["phases"])
    c = metrics.snapshot()
    assert c["slo.breach"] == 1 and c["slo.alert_fired"] == 1
    for _ in range(200):  # the hook runs detached
        if flag.exists():
            break
        time.sleep(0.05)
    assert flag.read_text() == "x"
    report = slo.render_slo_report(telemetry.snapshot())
    assert "** BREACHED **" in report and "t-decode" in report


def test_an_slo_alert_fault_counts_and_the_call_survives(tmp_path,
                                                         monkeypatch,
                                                         clocks):
    monkeypatch.setenv("PYRUHVRO_TPU_SLO_FILE",
                       slo_file(tmp_path, alert_command="true"))
    monkeypatch.setenv("PYRUHVRO_TPU_FAULTS", "slo_alert:error:1")
    data = datagen.kafka_style_datums(10, seed=5)
    want = port.deserialize_array(data, KAFKA, backend="host")
    for _ in range(8):
        clocks.now += 0.1
        got = port.deserialize_array(data, KAFKA, backend="host")
        assert got.to_pylist() == want.to_pylist()
    assert slo.breached() == ["t-decode"]
    c = metrics.snapshot()
    assert c["fault.injected.slo_alert"] == 1 and c["slo.alert_error"] == 1
    assert "slo.alert_fired" not in c


# -- the flight recorder -------------------------------------------------------


def test_flight_records_are_the_references_shape():
    data = datagen.kafka_style_datums(40, seed=7)
    port.deserialize_array(data, KAFKA, backend="host")
    ref.deserialize_array(data, KAFKA, backend="host")
    [got] = telemetry.flight_dump()["records"]
    [want] = ref.telemetry.flight_dump()["records"]
    assert set(got) == set(want)
    assert got["name"] == want["name"] == "api.deserialize_array"
    assert set(got["phases"]) <= set(want["phases"])
    assert {"host.decode_s", "host.vm_s"} <= set(got["phases"])
    assert telemetry.snapshot()["flight_records"] == 1
    assert "flight recorder: 1 record(s)" in telemetry.render_report(
        telemetry.snapshot())


def test_flight_ring_holds_the_knobs_newest_roots(monkeypatch):
    """``PYRUHVRO_TPU_FLIGHT_N`` sizes the ring (read by ``reset``); the
    oldest root spans leave it first, and each record holds its phases."""
    with monkeypatch.context() as m:
        m.setenv("PYRUHVRO_TPU_FLIGHT_N", "3")
        telemetry.reset()
        for i in range(5):
            with telemetry.root_span("api.deserialize_array", rows=i):
                with telemetry.phase("host.vm_s"):
                    pass
        records = telemetry.flight_dump()["records"]
        assert [r["attrs"]["rows"] for r in records] == [2, 3, 4]
        assert all(set(r["phases"]) == {"host.vm_s"} for r in records)
        assert telemetry.snapshot()["flight_records"] == 3
    telemetry.reset()
    assert telemetry._flight.maxlen == 64


def test_an_errored_call_auto_dumps_once_a_second(tmp_path, monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_FLIGHT_DIR", str(tmp_path))
    bad = [b"\xff\xff\xff"] * 4
    for _ in range(3):
        with pytest.raises(MalformedAvro):
            port.deserialize_array(bad, KAFKA, device="cpu")
    [dump] = sorted(tmp_path.iterdir())
    assert dump.name.startswith(f"flight_{os.getpid()}_")
    assert dump.name.endswith("_error.json")
    doc = json.loads(dump.read_text())
    assert doc["records"][-1]["attrs"]["error"] == "MalformedAvro"
    telemetry._flight_last_auto = 0.0  # past the rate limit
    with pytest.raises(MalformedAvro):
        port.deserialize_array(bad, KAFKA, device="cpu")
    assert len(list(tmp_path.iterdir())) == 2


def test_rotation_keeps_the_newest_auto_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("PYRUHVRO_TPU_FLIGHT_MAX_FILES", "3")
    for i in range(6):
        telemetry._flight_last_auto = 0.0
        p = telemetry._flight_autodump(f"t{i}")
        assert p is not None
        os.utime(p, (i + 1, i + 1))
    files = sorted(f.name for f in tmp_path.iterdir())
    assert len(files) == 3
    assert all(any(f.endswith(f"t{i}.json") for f in files)
               for i in (3, 4, 5))
    assert metrics.snapshot()["flight.dump_dropped"] == 3


def test_rotation_spares_foreign_files(tmp_path):
    (tmp_path / "operator_notes.json").write_text("{}")
    (tmp_path / "flight_incident.json").write_text("{}")
    os.utime(tmp_path / "flight_incident.json", (0, 0))
    for i in range(5):
        (tmp_path / f"flight_1_{i}_x.json").write_text("{}")
        os.utime(tmp_path / f"flight_1_{i}_x.json", (i + 1, i + 1))
    assert telemetry._rotate_flight_dir(str(tmp_path), 2) == 3
    left = sorted(f.name for f in tmp_path.iterdir())
    assert "operator_notes.json" in left and "flight_incident.json" in left
    assert len([f for f in left if f.startswith("flight_1_")]) == 2


def test_rotation_zero_means_no_limit(tmp_path):
    for i in range(4):
        (tmp_path / f"flight_1_{i}_x.json").write_text("{}")
    assert telemetry._rotate_flight_dir(str(tmp_path), 0) == 0
    assert len(list(tmp_path.iterdir())) == 4


def test_the_cli_renders_slo_and_sampling_sections(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("PYRUHVRO_TPU_SLO_FILE", slo_file(tmp_path))
    from pyruhvro_tpu_torch.runtime import sampling

    sampling.set_enabled(True)
    try:
        for _ in range(3):
            port.deserialize_array(datagen.kafka_style_datums(10, seed=3),
                                   KAFKA, backend="host")
        snap = telemetry.snapshot()
    finally:
        sampling.set_enabled(None)
    assert "slo" in snap and "sampling" in snap
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(snap, default=str))
    assert telemetry.main(["slo-report", str(path)]) == 0
    out = capsys.readouterr().out
    assert "== slo ==" in out and "t-decode" in out
    assert telemetry.main(["report", str(path)]) == 0
    out = capsys.readouterr().out
    assert "== adaptive deep sampling ==" in out and "== slo ==" in out
