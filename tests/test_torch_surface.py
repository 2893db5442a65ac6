"""The port's public surface and generators against the reference's, on
the CPU.

* Every name of ``pyruhvro_tpu.__all__`` is in
  ``pyruhvro_tpu_torch.__all__`` and resolves there; ``telemetry`` is the
  runtime module, so ``python -m pyruhvro_tpu_torch.telemetry`` runs
  without runpy's double-import warning.
* ``is_supported`` (upstream's fast subset), ``host_supported`` and
  ``device_supported`` give the reference's verdicts on
  ``random_schema(0..299)`` and on the cases outside the fast subset
  (bytes, fixed, decimals, uuid, time-millis, local timestamps, a
  top-level non-record, a fixed decimal wider than 16 bytes).
* ``parse_schema`` / ``to_arrow_schema`` give equal Arrow schemas;
  ``clear_schema_cache`` (re-exported by ``schema``) empties the port's
  cache.
* ``random_schema``, ``synthetic_schema_variant``,
  ``WIDENED_SCHEMA_JSON``, ``widened_datums`` and ``mutate_corpus`` give
  the reference's strings and bytes for every seed tried.

No JAX program runs here: both packages' gates, parsers and generators
are pure Python.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import pyruhvro_tpu as ref  # noqa: E402
from pyruhvro_tpu.utils import datagen as ref_datagen  # noqa: E402
from test_fuzz_malformed import mutate_corpus as ref_mutate  # noqa: E402

import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch import schema as port_schema  # noqa: E402
from pyruhvro_tpu_torch.schema import cache as port_cache  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
GATES = ("is_supported", "host_supported", "device_supported")


def _record(t) -> str:
    return json.dumps({"type": "record", "name": "G",
                       "fields": [{"name": "x", "type": t}]})


OUTSIDE_FAST = {
    "bytes": _record("bytes"),
    "fixed": _record({"type": "fixed", "name": "F", "size": 4}),
    "bytes_decimal": _record({"type": "bytes", "logicalType": "decimal",
                              "precision": 12, "scale": 2}),
    "fixed_decimal": _record({"type": "fixed", "name": "D", "size": 8,
                              "logicalType": "decimal", "precision": 16,
                              "scale": 2}),
    "fixed_decimal_over_16_bytes": _record(
        {"type": "fixed", "name": "W", "size": 17, "logicalType": "decimal",
         "precision": 38, "scale": 0}),
    "bytes_decimal_over_38": _record({"type": "bytes",
                                      "logicalType": "decimal",
                                      "precision": 39, "scale": 0}),
    "uuid": _record({"type": "string", "logicalType": "uuid"}),
    "time_millis": _record({"type": "int", "logicalType": "time-millis"}),
    "local_timestamp": _record({"type": "long",
                                "logicalType": "local-timestamp-micros"}),
    "duration": _record({"type": "fixed", "name": "Du", "size": 12,
                         "logicalType": "duration"}),
    "nested_bytes": _record({"type": "array", "items": ["null", "bytes"]}),
    "top_level_array": json.dumps({"type": "array", "items": "long"}),
    "top_level_long": json.dumps("long"),
    "fast_subset": _record({"type": "map", "values": {
        "type": "long", "logicalType": "timestamp-micros"}}),
}


def test_every_reference_name_is_exported():
    for name in ref.__all__:
        assert name in port.__all__, name
        assert getattr(port, name) is not None, name
    assert port.__version__ == ref.__version__
    from pyruhvro_tpu_torch.runtime import metrics, telemetry

    assert port.telemetry is telemetry and port.metrics is metrics


def test_telemetry_module_runs_without_the_double_import_warning():
    out = subprocess.run(
        [sys.executable, "-W", "error::RuntimeWarning", "-m",
         "pyruhvro_tpu_torch.telemetry", "knobs"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "PYRUHVRO_TPU_PALLAS" in out.stdout


@pytest.mark.parametrize("gate", GATES)
def test_gates_equal_the_reference_on_random_schemas(gate):
    verdicts = []
    for seed in range(300):
        s = ref_datagen.random_schema(seed)
        want = getattr(ref, gate)(ref.parse_schema(s))
        assert getattr(port, gate)(port.parse_schema(s)) == want, (seed, s)
        verdicts.append(want)
    if gate != "is_supported":
        assert all(verdicts)  # random schemas stay inside the native set
    else:
        assert any(verdicts) and not all(verdicts)


@pytest.mark.parametrize("name", sorted(OUTSIDE_FAST))
def test_gates_equal_the_reference_outside_the_fast_subset(name):
    s = OUTSIDE_FAST[name]
    got = [getattr(port, g)(port.parse_schema(s)) for g in GATES]
    assert got == [getattr(ref, g)(ref.parse_schema(s)) for g in GATES]
    assert got[0] == (name == "fast_subset")


def test_is_supported_keeps_a_table_of_its_own():
    from pyruhvro_tpu_torch import gate

    assert gate._FAST_LOGICAL is not gate._SUPPORTED_LOGICAL
    assert "bytes" not in gate._FAST_LOGICAL[None]
    assert "bytes" in gate._SUPPORTED_LOGICAL[None]


@pytest.mark.parametrize("which", ["random", "kafka", "widened"])
def test_arrow_schemas_equal_the_reference(which):
    schemas = {"random": [ref_datagen.random_schema(s) for s in range(200)],
               "kafka": [datagen.KAFKA_SCHEMA_JSON],
               "widened": [datagen.WIDENED_SCHEMA_JSON]}[which]
    for s in schemas:
        got = port.to_arrow_schema(port.parse_schema(s))
        assert got.equals(ref.to_arrow_schema(ref.parse_schema(s))), s


def test_clear_schema_cache_empties_the_ports_cache():
    assert port_schema.clear_schema_cache is port_cache.clear_schema_cache
    port_cache.get_or_parse_schema(datagen.synthetic_schema_variant(7))
    assert port_cache._cache
    port_schema.clear_schema_cache()
    assert not port_cache._cache


def test_random_schemas_are_the_references():
    for seed in range(200):
        assert datagen.random_schema(seed) == \
            ref_datagen.random_schema(seed), seed
    assert datagen.random_schema(5, max_depth=5) == \
        ref_datagen.random_schema(5, max_depth=5)


def test_schema_variants_are_the_references():
    for i in range(100):
        assert datagen.synthetic_schema_variant(i) == \
            ref_datagen.synthetic_schema_variant(i)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_widened_data_is_the_references(seed):
    assert datagen.WIDENED_SCHEMA_JSON == ref_datagen.WIDENED_SCHEMA_JSON
    assert datagen.widened_datums(64, seed) == \
        ref_datagen.widened_datums(64, seed)


@pytest.mark.parametrize("seed", [3, 41, 101])
def test_mutated_corpora_are_the_references(seed):
    ir = port.parse_schema(datagen.random_schema(seed))
    datums = datagen.random_datums(ir, 200, seed=seed + 5000)
    assert datagen.mutate_corpus(datums, seed) == ref_mutate(datums, seed)
    assert datagen.mutate_corpus(datums, seed, rate=0.9) == \
        ref_mutate(datums, seed, rate=0.9)
