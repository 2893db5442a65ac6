"""The bounds-checked writer (``PYRUHVRO_DEBUG_BOUNDS``) of the port's host
tier (the reference's ``hostpath/codec.py:677-734`` and ``:772``), on the
CPU.

* The tests of the reference's ``test_specialize.py`` (the checked mode
  encodes byte-identically; a ``size_hint`` of 7 raises ``RuntimeError``
  ``bound violated``) and ``test_native_extract.py`` (the fused encode
  under the checked writer over 24 random schemas), on the port.
* The knob reaches every native encode: the extractor's ``encode``, the
  specialised ``encode_arrow``, the ``host_mode`` VM and specialised
  ``encode``, and the shard encode, each read once per call.

Encode is byte work: the tolerance is 0.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from pyruhvro_tpu.utils.datagen import random_schema  # noqa: E402

from pyruhvro_tpu_torch.hostpath.codec import NativeHostCodec  # noqa: E402
from pyruhvro_tpu_torch.ops.encode_extract import run_extractor  # noqa: E402
from pyruhvro_tpu_torch.runtime import metrics, telemetry  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

KAFKA = datagen.KAFKA_SCHEMA_JSON


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_NO_SPECIALIZE", "1")
    monkeypatch.delenv("PYRUHVRO_DEBUG_BOUNDS", raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")
    telemetry.reset()
    yield
    telemetry.reset()


def codec_of(schema, monkeypatch=None, spec=False):
    if spec:
        monkeypatch.delenv("PYRUHVRO_TPU_NO_SPECIALIZE")
        monkeypatch.setenv("PYRUHVRO_TPU_SPECIALIZE_ROWS", "0")
    e = get_or_parse_schema(schema)
    return NativeHostCodec(e.ir, e.arrow_schema)


def wire(arr):
    return [bytes(x) for x in arr.to_pylist()]


class Recorder:
    """A stand-in for a native module: records each call's arguments of
    ``names`` and runs the real function."""

    def __init__(self, mod, *names):
        self.calls = []
        for name in names:
            setattr(self, name, self._wrap(name, getattr(mod, name)))
        self.shard_stats = mod.shard_stats

    def _wrap(self, name, fn):
        def call(*args):
            self.calls.append((name, args))
            return fn(*args)
        return call


@pytest.mark.parametrize("engine", ["vm", "spec"])
def test_checked_bounds_mode(monkeypatch, engine):
    """``PYRUHVRO_DEBUG_BOUNDS=1`` encodes byte-identically through the
    bounds-checked writer; an impossible size hint raises
    ``RuntimeError`` instead of writing past the allocation."""
    codec = codec_of(KAFKA, monkeypatch, spec=engine == "spec")
    datums = datagen.kafka_style_datums(200, seed=21)
    batch = codec.decode(datums)
    assert (codec._spec is not None) == (engine == "spec")
    want = wire(codec.encode(batch))
    monkeypatch.setenv("PYRUHVRO_DEBUG_BOUNDS", "1")
    got = wire(codec.encode(batch))
    assert got == want == datums
    assert wire(codec._encode_host_mode(batch, batch.num_rows, 1)) == datums
    # a direct call with an impossible bound: a loud error
    ex = run_extractor(codec.ir, batch, host_mode=True)
    bufs = codec._encode_buffers(ex)
    with pytest.raises(RuntimeError, match="bound violated"):
        if engine == "spec":
            codec._spec.encode(codec.prog.coltypes, bufs, batch.num_rows,
                               7, 1)
        else:
            codec._mod.encode(codec.prog.ops, codec.prog.coltypes, bufs,
                              batch.num_rows, 7, 1)


@pytest.mark.parametrize("base", range(0, 24, 8))
def test_native_extractor_bounds_soak(base, monkeypatch):
    """The fused encode under the bounds-checked writer: every store is
    checked against the extractor's bound."""
    monkeypatch.setenv("PYRUHVRO_DEBUG_BOUNDS", "1")
    for seed in range(base, base + 8):
        schema = random_schema(seed + 500)
        codec = codec_of(schema)
        datums = datagen.random_datums(codec.ir, 30, seed=seed + 6000)
        batch = codec.decode(datums)
        metrics.reset()
        out = codec.encode(batch)
        assert metrics.snapshot().get("extract.native", 0) >= 1, schema
        assert wire(out) == datums, schema


@pytest.mark.parametrize("knob,want", [("", 0), ("1", 1), ("0", 0)])
def test_knob_reaches_every_vm_encode(monkeypatch, knob, want):
    """The checked flag each native encode of the VM receives, read once
    per call: the extractor's ``encode`` (its last address argument),
    the shard encode, and the ``host_mode`` VM ``encode``."""
    monkeypatch.setenv("PYRUHVRO_DEBUG_BOUNDS", knob)
    codec = codec_of(KAFKA)
    datums = datagen.kafka_style_datums(300, seed=4)
    batch = codec.decode(datums)
    codec.encode(batch[:1])  # loads the extractor
    ext = Recorder(codec._extract_mod, "encode")
    vm = Recorder(codec._mod, "encode", "decode_arrow")
    monkeypatch.setattr(codec, "_extract_mod", ext)
    monkeypatch.setattr(codec, "_mod", vm)
    assert wire(codec.encode(batch)) == datums
    # ops, coltypes, op_aux, array, schema, n, checked
    assert ext.calls[-1][1][6] == want
    assert wire(codec._encode_host_mode(batch, batch.num_rows,
                                        want)) == datums
    assert vm.calls[-1][0] == "encode" and vm.calls[-1][1][-1] == want
    monkeypatch.setattr(NativeHostCodec, "_PER_CHUNK_ROWS", 16)
    arrays = codec.encode_threaded(batch, 4)
    assert [d for a in arrays for d in wire(a)] == datums
    name, args = ext.calls[-1]
    assert args[6] == want and args[7] == 4  # checked, then the shards


def test_knob_reaches_the_specialised_encodes(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_DEBUG_BOUNDS", "1")
    codec = codec_of(KAFKA, monkeypatch, spec=True)
    datums = datagen.kafka_style_datums(120, seed=6)
    batch = codec.decode(datums)
    spec = Recorder(codec._spec, "encode_arrow", "encode")
    monkeypatch.setattr(codec, "_spec", spec)
    assert wire(codec.encode(batch)) == datums
    name, args = spec.calls[-1]
    # coltypes, array, schema, n, checked
    assert name == "encode_arrow" and args[4] == 1
    assert wire(codec._encode_host_mode(batch, batch.num_rows, 1)) == datums
    name, args = spec.calls[-1]
    assert name == "encode" and args[-1] == 1


def test_checked_writer_keeps_the_raw_program(monkeypatch):
    """Encode lanes run the raw program: the optimized one (with fused
    headers) never reaches a writer."""
    monkeypatch.setenv("PYRUHVRO_DEBUG_BOUNDS", "1")
    import chip_smoke

    codec = codec_of(chip_smoke.RUN_SCHEMA)
    assert codec.oprog is not codec.prog
    datums = datagen.random_datums(codec.ir, 200, seed=8)
    batch = codec.decode(datums)
    codec.encode(batch[:1])
    ext = Recorder(codec._extract_mod, "encode")
    monkeypatch.setattr(codec, "_extract_mod", ext)
    assert wire(codec.encode(batch)) == datums
    assert ext.calls[-1][1][0] is codec.prog.ops
    assert codec.prog.ops is not codec.oprog.ops
