"""The port's soak scripts (``scripts/torch_*_soak.py``, the fleet and
OTLP smokes, the metrics report) at their smallest sizes, on the CPU.

* Each script's ``main`` with ``--device cpu`` (the kernels' plain
  versions) returns 0 and writes its report where ``--out`` says.
* Without ``--device cpu`` each one raises ``RuntimeError`` here, where
  there is no card: no soak falls back to the CPU.
* A planted divergence, the oracle's answer altered for one seed
  (``torch_soaklib.oracle`` through ``monkeypatch``), makes the fuzz and
  malformed soaks return 1.
* The memory soak returns 1 when a leg misses its criterion.
* ``torch_soaklib.on_device`` fails a card call that a host tier
  answered, and an Avro ``int`` past int32, which the soaks no longer
  leave out of any comparison, is rejected on every leg they run.

Every test restores the environment and resets the port's telemetry,
faults, breakers, audit state and serving plane, since the scripts run
in this process.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.fallback.decoder import (  # noqa: E402
    decode_to_record_batch as ref_oracle,
)

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.fallback.decoder import (  # noqa: E402
    decode_to_record_batch,
)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
CARD_SCRIPTS = ("fuzz_soak", "malformed_soak", "chaos_soak", "mem_soak",
                "audit_soak", "serve_soak", "fleet_smoke", "otlp_smoke")


def script(name: str):
    """``scripts/torch_<name>.py`` as a module (imported once)."""
    mod = sys.modules.get(f"torch_{name}")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"torch_{name}", SCRIPTS / f"torch_{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _isolated():
    from pyruhvro_tpu_torch import serving
    from pyruhvro_tpu_torch.runtime import audit, breaker, faults, telemetry

    env = dict(os.environ)
    telemetry.reset()
    yield
    serving.stop()
    serving.reset()
    os.environ.clear()
    os.environ.update(env)
    for mod in (faults, audit, breaker, telemetry):
        mod.reset()


def run(name: str, tmp_path, *args) -> dict:
    out = tmp_path / f"{name}.json"
    assert script(name).main(["--device", "cpu", "--out", str(out),
                              *args]) == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", CARD_SCRIPTS)
def test_without_a_card_each_soak_raises(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script(name).main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_fuzz_soak(tmp_path):
    doc = run("fuzz_soak", tmp_path, "--count", "5", "--rows", "8",
              "--wide", "5")
    assert doc["failures"] == 0 and doc["schemas"] == 6
    # the composite schema of seeds 100..104 has 67 walk buffers
    assert doc["k2_large_block"] == 1 and doc["k2_small_block"] == 5
    assert doc["k4_seeds"] + doc["k4_declined"] == 6


def test_malformed_soak(tmp_path):
    doc = run("malformed_soak", tmp_path, "--count", "2", "--rows", "24")
    assert doc["failures"] == 0 and doc["records"] == 48
    assert doc["rejects"] > 0


def test_chaos_soak(tmp_path, monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_FAULT_HANG_S", "0.05")
    doc = run("chaos_soak", tmp_path, "--rounds", "1", "--skip-pool")
    assert doc["failed"] == 0
    from pyruhvro_tpu_torch.runtime.faults import SITES

    assert set(doc["sites"]) == set(SITES) - {"pool_worker"}


def test_mem_soak(tmp_path):
    doc = run("mem_soak", tmp_path, "--schemas", "60", "--hot",
              "4", "--max-schemas", "32", "--decompose-rows", "200",
              "--decompose-calls", "3")
    assert doc["pass"]
    assert doc["churn"]["evictions"]["lru"] > 0


def test_audit_soak(tmp_path):
    doc = run("audit_soak", tmp_path, "--rows", "2000", "--rows-per-call",
              "100")
    assert doc["ok"] and doc["audit"]["audited"] > 0


def test_serve_soak(tmp_path):
    doc = run("serve_soak", tmp_path, "--duration", "1.5")
    assert doc["pass"], doc["violations"]
    assert doc["phases"]["overload"]["shed"] > 0


def test_fleet_smoke(tmp_path):
    out = tmp_path / "fleet.json"
    assert script("fleet_smoke").main(["--device", "cpu", "--out",
                                       str(out)]) == 0
    assert json.loads(out.read_text())["fleet"]["count"] == 3
    assert (tmp_path / "fleet_report_smoke.txt").exists()


def test_otlp_smoke(tmp_path):
    doc = run("otlp_smoke", tmp_path)
    assert doc["pass"] and doc["workers"] >= 4 and doc["device_spans"] > 0


def test_metrics_report(tmp_path, capsys):
    from pyruhvro_tpu_torch.runtime import telemetry
    from pyruhvro_tpu_torch.utils import datagen

    port.deserialize_array(datagen.kafka_style_datums(20),
                           datagen.KAFKA_SCHEMA_JSON, device="cpu")
    snap = tmp_path / "snapshot.json"
    snap.write_text(json.dumps(telemetry.snapshot(), default=str))
    mod = script("metrics_report")
    assert mod.main(["report", str(snap)]) == 0
    assert "api.deserialize_array_s" in capsys.readouterr().out
    assert mod.main(["report", str(tmp_path / "missing.json")]) == 2


@pytest.mark.parametrize("name", ["fuzz_soak", "malformed_soak"])
def test_a_planted_divergence_fails_the_soak(name, tmp_path, monkeypatch):
    soak = script(name).soak
    real, accepted = soak.oracle, []

    def planted(datums, entry):
        batch = real(datums, entry)
        accepted.append(len(datums))
        if len(accepted) == 2:
            return batch.slice(1)  # the second accepted answer loses a row
        return batch

    monkeypatch.setattr(soak, "oracle", planted)
    out = tmp_path / "planted.json"
    assert script(name).main(["--device", "cpu", "--count", "2", "--rows",
                              "8", "--out", str(out)]) == 1
    assert json.loads(out.read_text())["failures"] >= 1


# a record of one int whose varint (6 bytes) holds 2^34: valid on the
# wire, past int32
INT_SCHEMA = ('{"type":"record","name":"I","fields":['
              '{"name":"t","type":{"type":"int","logicalType":"time-millis"}}'
              ',{"name":"s","type":"string"}]}')
PAST_INT32 = bytes([0x80, 0x80, 0x80, 0x80, 0x80, 0x01]) + b"\x02x"


def test_an_int_past_int32_is_rejected_on_every_soak_leg():
    """The soaks hold every tier to the oracle with no record left out:
    an ``int`` past int32 is an error on the card's plain versions, the
    VM and the oracle alike, where the reference's device and host tiers
    keep its low 32 bits (its oracle rejects it in the Arrow build)."""
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema

    e = get_or_parse_schema(INT_SCHEMA)
    with pytest.raises(port.MalformedAvro, match="int32"):
        decode_to_record_batch([PAST_INT32], e.ir, e.arrow_schema)
    with pytest.raises(ValueError):
        ref_oracle([PAST_INT32], ref.parse_schema(INT_SCHEMA))
    for kw in ({"backend": "device", "device": "cpu"}, {"backend": "host"}):
        with pytest.raises(port.MalformedAvro) as ei:
            port.deserialize_array([PAST_INT32], INT_SCHEMA, **kw)
        assert ei.value.err_name == "int_range"
    assert ref.deserialize_array([PAST_INT32], INT_SCHEMA,
                                 backend="host").num_rows == 1


def test_on_device_refuses_a_call_the_card_did_not_answer():
    """``torch_soaklib.on_device`` fails a call routed to a host tier or
    answered there, and passes a device call and its data errors."""
    soak = script("fuzz_soak").soak
    from pyruhvro_tpu_torch.utils import datagen

    data = datagen.kafka_style_datums(8)
    schema = datagen.KAFKA_SCHEMA_JSON
    assert soak.on_device(lambda: port.deserialize_array(
        data, schema, backend="device", device="cpu")).num_rows == 8
    with pytest.raises(port.MalformedAvro):
        soak.on_device(lambda: port.deserialize_array(
            [PAST_INT32], INT_SCHEMA, backend="device", device="cpu"))
    for backend in ("host", "auto"):  # "auto" on the CPU: the VM answers
        with pytest.raises(soak.Divergence):
            soak.on_device(lambda: port.deserialize_array(
                data, schema, backend=backend, device="cpu"))


def test_mem_soak_fails_a_missed_criterion(tmp_path, monkeypatch):
    mod = script("mem_soak")
    real = mod.leg_decompose

    def missed(*args):
        return {**real(*args), "decomposed_90pct": False}

    monkeypatch.setattr(mod, "leg_decompose", missed)
    out = tmp_path / "mem.json"
    assert mod.main(["--device", "cpu", "--out", str(out), "--skip-churn",
                     "--decompose-rows", "200", "--decompose-calls",
                     "2"]) == 1
    assert json.loads(out.read_text())["pass"] is False
