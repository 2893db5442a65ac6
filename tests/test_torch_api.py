"""The port's public path held against the pure-Python oracle, on the CPU,
and the port's packaging rules.

``pyruhvro_tpu_torch.deserialize_array_threaded(..., device="cpu")`` must
equal ``pyruhvro_tpu.fallback.decoder.decode_to_record_batch`` sliced by
the reference's chunk bounds, value by value (``to_pylist``: sliced
sparse unions can pass ``.equals()`` with wrong values).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")

from pyruhvro_tpu.fallback.decoder import decode_to_record_batch  # noqa: E402
from pyruhvro_tpu.runtime.chunking import chunk_bounds  # noqa: E402
from pyruhvro_tpu.schema.arrow_map import to_arrow_schema as ref_arrow  # noqa: E402
from pyruhvro_tpu.schema.parser import parse_schema as ref_parse  # noqa: E402
from pyruhvro_tpu.utils.datagen import (  # noqa: E402
    CRITERION_SHAPES,
    KAFKA_SCHEMA_JSON,
    WIDENED_SCHEMA_JSON,
    random_datums,
    widened_datums,
)

import pyruhvro_tpu_torch  # noqa: E402
from pyruhvro_tpu_torch import (  # noqa: E402
    MalformedAvro,
    deserialize_array,
    deserialize_array_threaded,
)
from pyruhvro_tpu_torch.ops import walk_decode  # noqa: E402
from pyruhvro_tpu_torch.utils.datagen import kafka_style_datums  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "pyruhvro_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain walk runs at test sizes; one intra-op thread keeps it from
    oversubscribing the CPU that parallel test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _oracle(schema: str, datums):
    ir = ref_parse(schema)
    return decode_to_record_batch(datums, ir, ref_arrow(ir))


def _assert_chunks_match_oracle(schema, datums, num_chunks):
    got = deserialize_array_threaded(datums, schema, num_chunks, device="cpu")
    want = _oracle(schema, datums)
    bounds = chunk_bounds(len(datums), num_chunks)
    assert len(got) == len(bounds)
    for batch, (a, b) in zip(got, bounds):
        expect = want.slice(a, b - a)
        assert batch.schema.equals(want.schema)
        assert batch.num_rows == b - a
        assert batch.to_pylist() == expect.to_pylist()
        assert batch.equals(expect)


@pytest.mark.parametrize("num_chunks", [1, 7])
def test_kafka_threaded_matches_oracle(num_chunks):
    _assert_chunks_match_oracle(KAFKA_SCHEMA_JSON,
                                kafka_style_datums(500, seed=41), num_chunks)


@pytest.mark.parametrize("shape", sorted(CRITERION_SHAPES))
def test_criterion_shapes_threaded_match_oracle(shape):
    schema = CRITERION_SHAPES[shape]
    _assert_chunks_match_oracle(
        schema, random_datums(ref_parse(schema), 300, seed=12), 4)


def test_widened_types_match_oracle():
    _assert_chunks_match_oracle(WIDENED_SCHEMA_JSON, widened_datums(200, 3),
                                3)


def test_random_schemas_match_oracle():
    """Generated schemas over the whole device type surface (the ones
    without nested repetition): every value equals the oracle's."""
    from pyruhvro_tpu.utils.datagen import random_schema

    from pyruhvro_tpu_torch.ops.fieldprog import lower
    from pyruhvro_tpu_torch.schema.parser import parse_schema

    checked = 0
    for seed in range(40):
        schema = random_schema(seed)
        if not walk_decode.walk_supported(lower(parse_schema(schema))):
            continue
        _assert_chunks_match_oracle(
            schema, random_datums(ref_parse(schema), 60, seed=seed), 3)
        checked += 1
    assert checked >= 20


def test_deserialize_array_matches_oracle():
    datums = kafka_style_datums(200, seed=2)
    got = deserialize_array(datums, KAFKA_SCHEMA_JSON, device="cpu")
    want = _oracle(KAFKA_SCHEMA_JSON, datums)
    assert got.to_pylist() == want.to_pylist()
    assert got.equals(want)


def test_empty_input():
    got = deserialize_array_threaded([], KAFKA_SCHEMA_JSON, 4, device="cpu")
    assert len(got) == 1 and got[0].num_rows == 0
    assert got[0].schema.equals(_oracle(KAFKA_SCHEMA_JSON, []).schema)


def test_malformed_names_the_row():
    datums = kafka_style_datums(100, seed=8)
    datums[61] = b"\x82"
    with pytest.raises(MalformedAvro, match=r"^record 61: ") as ei:
        deserialize_array_threaded(datums, KAFKA_SCHEMA_JSON, 4, device="cpu")
    assert ei.value.index == 61 and ei.value.err_name


def test_halving_rebases_the_malformed_row(monkeypatch):
    """Under a lowered launch budget the batch splits (twice here); a bad
    row in a right half still reports its index in the whole batch. This
    is the row-padded engine's budget (``PYRUHVRO_TPU_PALLAS=1``);
    ``tests/test_torch_decode.py`` holds the pipeline engine's."""
    monkeypatch.setenv("PYRUHVRO_TPU_PALLAS", "1")
    schema = CRITERION_SHAPES["flat_primitives"]
    datums = random_datums(ref_parse(schema), 3000, seed=4)
    whole = deserialize_array(datums, schema, device="cpu")
    monkeypatch.setattr(walk_decode, "_LAUNCH_BYTES", 100_000)
    calls = []
    real = walk_decode.WalkDecoder.decode_to_columns

    def counting(self, data):
        calls.append(len(data))
        return real(self, data)

    monkeypatch.setattr(walk_decode.WalkDecoder, "decode_to_columns",
                        counting)
    assert deserialize_array(datums, schema, device="cpu").equals(whole)
    assert max(calls[1:]) < 3000
    datums[2900] = b"\x82"
    with pytest.raises(MalformedAvro) as ei:
        deserialize_array(datums, schema, device="cpu")
    assert str(ei.value).startswith("record 2900: ")
    assert ei.value.index == 2900


def test_device_row_errors_name_their_tier():
    """A row error of a device walk carries ``tier="device"``, in the port
    (either engine) and in the reference alike."""
    import pyruhvro_tpu as ref

    with pytest.raises(ValueError) as want:
        ref.deserialize_array([b"\x01"], KAFKA_SCHEMA_JSON, backend="tpu")
    assert want.value.tier == "device"
    for setting in ("0", "1"):
        os.environ["PYRUHVRO_TPU_PALLAS"] = setting
        try:
            with pytest.raises(MalformedAvro) as got:
                deserialize_array([b"\x01"], KAFKA_SCHEMA_JSON, device="cpu")
        finally:
            os.environ.pop("PYRUHVRO_TPU_PALLAS")
        assert got.value.tier == "device"
        assert str(got.value) == str(want.value)


def test_halving_keeps_the_tier(monkeypatch):
    from pyruhvro_tpu_torch.errors import shift_malformed

    monkeypatch.setenv("PYRUHVRO_TPU_PALLAS", "1")
    schema = CRITERION_SHAPES["flat_primitives"]
    datums = random_datums(ref_parse(schema), 3000, seed=4)
    monkeypatch.setattr(walk_decode, "_LAUNCH_BYTES", 100_000)
    datums[2900] = b"\x82"
    with pytest.raises(MalformedAvro) as ei:
        deserialize_array(datums, schema, device="cpu")
    assert ei.value.index == 2900 and ei.value.tier == "device"
    moved = shift_malformed(ei.value, 7)
    assert (moved.index, moved.tier) == (2907, "device")


def test_malformed_survives_a_pickle_round_trip():
    import pickle

    e = MalformedAvro("record 3: varint too long", index=3,
                      err_name="varint", tier="device",
                      indices=[(3, "varint"), (9, "overrun")])
    back = pickle.loads(pickle.dumps(e))
    assert type(back) is MalformedAvro and str(back) == str(e)
    assert (back.index, back.err_name, back.tier, back.indices) == (
        3, "varint", "device", [(3, "varint"), (9, "overrun")])


NESTED_SCHEMA = """{"type":"record","name":"AA","fields":[
  {"name":"aa","type":{"type":"array","items":{"type":"array",
                                               "items":"int"}}}]}"""


@pytest.mark.parametrize("setting, flat_engine, nested_engine", [
    (None, "DeviceDecoder", "DeviceDecoder"),
    ("0", "DeviceDecoder", "DeviceDecoder"),
    ("1", "WalkDecoder", "DeviceDecoder"),
    ("true", "WalkDecoder", "DeviceDecoder"),
    ("mosaic", "WalkDecoder", "DeviceDecoder"),
])
def test_engine_choice_follows_the_reference(monkeypatch, setting,
                                             flat_engine, nested_engine):
    """The pipeline engine by default; the row-padded walk under
    ``PYRUHVRO_TPU_PALLAS``, except for nested repetition, which the
    pipeline engine serves (``pyruhvro_tpu/ops/codec.py:199-223``)."""
    from pyruhvro_tpu_torch.ops.codec import get_device_codec
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema

    if setting is None:
        monkeypatch.delenv("PYRUHVRO_TPU_PALLAS", raising=False)
    else:
        monkeypatch.setenv("PYRUHVRO_TPU_PALLAS", setting)
    for schema, engine in ((KAFKA_SCHEMA_JSON, flat_engine),
                           (NESTED_SCHEMA, nested_engine)):
        codec = get_device_codec(get_or_parse_schema(schema), "cpu")
        assert type(codec.decoder).__name__ == engine, schema


def test_codec_memo_key_carries_the_engine_mode(monkeypatch):
    from pyruhvro_tpu_torch.ops.codec import get_device_codec
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema

    entry = get_or_parse_schema(KAFKA_SCHEMA_JSON)
    monkeypatch.setenv("PYRUHVRO_TPU_PALLAS", "1")
    padded = get_device_codec(entry, "cpu")
    assert get_device_codec(entry, "cpu") is padded
    monkeypatch.setenv("PYRUHVRO_TPU_PALLAS", "0")
    pipeline = get_device_codec(entry, "cpu")
    assert pipeline is not padded
    assert type(pipeline.decoder).__name__ == "DeviceDecoder"
    monkeypatch.setenv("PYRUHVRO_TPU_PALLAS", "1")
    assert get_device_codec(entry, "cpu") is padded


def test_nested_schema_decodes_under_either_setting(monkeypatch):
    """A nested schema decodes on the default engine, and under
    ``PYRUHVRO_TPU_PALLAS=1`` too (the pipeline engine serves it)."""
    datums = random_datums(ref_parse(NESTED_SCHEMA), 50, seed=3)
    want = _oracle(NESTED_SCHEMA, datums).to_pylist()
    for setting in ("0", "1"):
        monkeypatch.setenv("PYRUHVRO_TPU_PALLAS", setting)
        got = deserialize_array(datums, NESTED_SCHEMA, device="cpu")
        assert got.to_pylist() == want


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    datums = kafka_style_datums(4, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deserialize_array(datums, KAFKA_SCHEMA_JSON)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deserialize_array_threaded(datums, KAFKA_SCHEMA_JSON, 2)


def test_unknown_device_is_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        deserialize_array([], KAFKA_SCHEMA_JSON, device="meta")


def test_import_leaves_jax_and_the_reference_out():
    code = (
        "import sys, pyruhvro_tpu_torch, pyruhvro_tpu_torch.api, "
        "pyruhvro_tpu_torch.ops.walk_decode, pyruhvro_tpu_torch.ops.decode, "
        "pyruhvro_tpu_torch.ops.codec, pyruhvro_tpu_torch.ops.encode, "
        "pyruhvro_tpu_torch.ops.encode_extract, "
        "pyruhvro_tpu_torch.ops._build, pyruhvro_tpu_torch.utils.datagen, "
        "pyruhvro_tpu_torch.runtime.timeline, "
        "pyruhvro_tpu_torch.runtime.incident, "
        "pyruhvro_tpu_torch.runtime.audit, "
        "pyruhvro_tpu_torch.runtime.coldigest, "
        "pyruhvro_tpu_torch.runtime.obs_server, "
        "pyruhvro_tpu_torch.runtime.memacct, "
        "pyruhvro_tpu_torch.runtime.cachelife, "
        "pyruhvro_tpu_torch.runtime.otel, "
        "pyruhvro_tpu_torch.runtime.fleet, "
        "pyruhvro_tpu_torch.serving, pyruhvro_tpu_torch.serving.flight, "
        "pyruhvro_tpu_torch.hostpath.specialize\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pyruhvro_tpu' or m.startswith('pyruhvro_tpu.')]\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_neither_jax_nor_the_reference():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "pyruhvro_tpu"), (path, mod)


def test_public_names():
    assert set(pyruhvro_tpu_torch.__all__) >= {
        "deserialize_array", "deserialize_array_threaded",
        "serialize_record_batch", "MalformedAvro", "UnsupportedOnDevice",
        "BatchTooLarge"}
    assert isinstance(pyruhvro_tpu_torch.deserialize_array(
        [], CRITERION_SHAPES["flat_primitives"], device="cpu"),
        pa.RecordBatch)
