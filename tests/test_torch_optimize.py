"""The port's superoptimizer (``pyruhvro_tpu_torch/hostpath/optimize.py``, a
copy of ``pyruhvro_tpu/hostpath/optimize.py``) held against the reference,
the raw program and the oracle, on the CPU.

* The tests of ``tests/test_optimize.py``, on the port: 100 random
  schemas decoded and encoded through the optimized program equal the
  raw program's and the oracle's; ``PYRUHVRO_TPU_NO_OPT=1`` pins the raw
  program; the fuser fires on a run schema; Kafka round-trips; the
  specialised engine (built from the raw program) equals the optimized
  VM; planted bad rewrites come back red from the oracle, and a
  rejected rewrite is counted and never run.
* Parity with the reference: ``optimize_program`` gives the reference's
  ``ops``, ``op_aux`` and ``OptimizeStats`` on Kafka, the run schemas of
  ``chip_smoke.py`` and 50 random schemas.
* The VM on the optimized program against ``PYRUHVRO_TPU_NO_OPT=1`` and
  the oracle, truncation errors included (row index, slug, message).

Decode and encode are integer and byte work: the tolerance is 0.
"""

import copy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from pyruhvro_tpu.hostpath.optimize import optimize_program as ref_optimize  # noqa: E402
from pyruhvro_tpu.hostpath.program import lower_host as ref_lower  # noqa: E402
from pyruhvro_tpu.ops import UnsupportedOnDevice as RefUnsupported  # noqa: E402
from pyruhvro_tpu.schema.cache import get_or_parse_schema as ref_entry  # noqa: E402
from pyruhvro_tpu.utils.datagen import random_schema  # noqa: E402

import chip_smoke  # noqa: E402
from pyruhvro_tpu_torch.analysis import irverify  # noqa: E402
from pyruhvro_tpu_torch.errors import MalformedAvro  # noqa: E402
from pyruhvro_tpu_torch.fallback.decoder import decode_to_record_batch  # noqa: E402
from pyruhvro_tpu_torch.hostpath import optimize as hopt  # noqa: E402
from pyruhvro_tpu_torch.hostpath import program as hp  # noqa: E402
from pyruhvro_tpu_torch.hostpath.codec import NativeHostCodec  # noqa: E402
from pyruhvro_tpu_torch.hostpath.optimize import (  # noqa: E402
    optimize_program,
    strip_optimizations,
)
from pyruhvro_tpu_torch.hostpath.program import lower_host  # noqa: E402
from pyruhvro_tpu_torch.ops import UnsupportedOnDevice  # noqa: E402
from pyruhvro_tpu_torch.runtime import metrics, telemetry  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KAFKA = datagen.KAFKA_SCHEMA_JSON

# a shape the fuser provably rewrites: a run of fixed-width leaves, a
# nullable sub-record with its own run, and a string to break the runs
RUN_SCHEMA = """
{"type": "record", "name": "OptRun", "fields": [
  {"name": "x", "type": "double"},
  {"name": "y", "type": "float"},
  {"name": "k", "type": "boolean"},
  {"name": "tag", "type": "string"},
  {"name": "opt", "type": ["null", {"type": "record", "name": "OInner",
    "fields": [{"name": "p", "type": "double"},
               {"name": "q", "type": "double"}]}]}
]}
"""
SHAPES = {"kafka": KAFKA, "opt_run": RUN_SCHEMA,
          "reading": chip_smoke.RUN_SCHEMA,
          "track": chip_smoke.NULLABLE_RUN_SCHEMA}
STAT_FIELDS = ("applied", "fused_runs", "fused_members", "always_present",
               "str_items", "rejected", "findings")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_NO_SPECIALIZE", "1")
    for name in ("PYRUHVRO_TPU_NO_OPT", "PYRUHVRO_TPU_NATIVE_PROF",
                 "PYRUHVRO_TPU_NATIVE_SAN", "PYRUHVRO_TPU_TSAN"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def guards():
    return irverify.scan_native_guards(str(REPO))


@pytest.fixture(scope="module")
def consumers():
    return irverify.scan_aux_consumers(str(REPO))


def codec_of(schema):
    e = get_or_parse_schema(schema)
    return NativeHostCodec(e.ir, e.arrow_schema)


def raw_codec(monkeypatch, schema):
    monkeypatch.setenv("PYRUHVRO_TPU_NO_OPT", "1")
    c = codec_of(schema)
    monkeypatch.delenv("PYRUHVRO_TPU_NO_OPT")
    return c


def wire(arr):
    return [bytes(x) for x in arr.to_pylist()]


def same(got, want):
    assert got.schema.equals(want.schema)
    assert got.to_pylist() == want.to_pylist()


def datums_of(schema, n, seed):
    if schema == KAFKA:
        return datagen.kafka_style_datums(n, seed=seed)
    return datagen.random_datums(get_or_parse_schema(schema).ir, n, seed=seed)


# -- differential: optimized against raw, the VM, 100 random schemas --------------


@pytest.mark.parametrize("seed", range(100))
def test_optimized_matches_raw_over_random_schemas(seed):
    """Decode and encode through the optimized program equal the raw
    program's and the oracle's: the empirical leg of the verifier's
    effect-equality proof."""
    schema = random_schema(seed)
    e = get_or_parse_schema(schema)
    codec = codec_of(schema)
    datums = datagen.random_datums(e.ir, 40, seed=seed + 7000)

    raw = codec.prog
    opt, stats = optimize_program(raw)
    assert not stats.rejected, stats.findings
    # strip is the exact inverse on ops and coltypes
    stripped = strip_optimizations(opt)
    assert [tuple(r) for r in stripped.ops] == [tuple(r) for r in raw.ops]
    assert [int(c) for c in stripped.coltypes] == \
        [int(c) for c in raw.coltypes]

    got = codec.decode(datums)          # the VM runs codec.oprog
    want = decode_to_record_batch(datums, e.ir, e.arrow_schema)
    assert got.equals(want), schema
    assert wire(codec.encode(want)) == datums, schema


@pytest.mark.parametrize("seed", (3, 17, 41))
def test_no_opt_knob_pins_raw_program(monkeypatch, seed):
    """``PYRUHVRO_TPU_NO_OPT=1`` pins the raw program, and both arms
    agree byte for byte."""
    schema = random_schema(seed)
    e = get_or_parse_schema(schema)
    opt_codec = codec_of(schema)
    raw = raw_codec(monkeypatch, schema)
    assert raw.oprog is raw.prog
    assert raw.opt_stats is None

    datums = datagen.random_datums(e.ir, 60, seed=seed + 8000)
    a = opt_codec.decode(datums)
    b = raw.decode(datums)
    assert a.equals(b)
    assert wire(opt_codec.encode(a)) == wire(raw.encode(b)) == datums


def test_fuser_actually_fires_on_run_schema():
    e = get_or_parse_schema(RUN_SCHEMA)
    codec = codec_of(RUN_SCHEMA)
    assert codec.opt_stats is not None and codec.opt_stats.applied
    assert codec.opt_stats.fused_runs >= 2  # x/y/k run + p/q run
    kinds = [int(r[0]) for r in codec.oprog.ops]
    assert hp.OP_FIXED_RUN in kinds
    datums = datagen.random_datums(e.ir, 500, seed=5)
    got = codec.decode(datums)
    want = decode_to_record_batch(datums, e.ir, e.arrow_schema)
    assert got.equals(want)
    assert wire(codec.encode(want)) == datums


def test_kafka_schema_optimizes_and_roundtrips():
    e = get_or_parse_schema(KAFKA)
    codec = codec_of(KAFKA)
    assert codec.opt_stats.applied and codec.opt_stats.str_items == 2
    assert codec.opt_stats.fused_runs == 0
    datums = datagen.kafka_style_datums(800, seed=11)
    got = codec.decode(datums)
    want = decode_to_record_batch(datums, e.ir, e.arrow_schema)
    same(got, want)
    assert wire(codec.encode(want)) == datums


# -- the specialised engine (built from the raw program) ----------------------------


@pytest.mark.parametrize("seed", (2, 9))
def test_specialized_engine_agrees_with_optimized_generic(monkeypatch, seed):
    """The specialiser compiles the raw program; its output equals the
    optimized VM's (two independent walks over the same effects)."""
    schema = random_schema(seed)
    e = get_or_parse_schema(schema)
    generic = codec_of(schema)
    monkeypatch.setenv("PYRUHVRO_TPU_SPECIALIZE_ROWS", "0")
    monkeypatch.delenv("PYRUHVRO_TPU_NO_SPECIALIZE")
    spec = codec_of(schema)

    datums = datagen.random_datums(e.ir, 200, seed=seed + 9000)
    want = generic.decode(datums)
    got = spec.decode(datums)
    assert spec._spec is not None, "specialization did not engage"
    assert generic._spec is None
    assert got.equals(want)
    assert wire(spec.encode(got)) == wire(generic.encode(want)) == datums


# -- the oracle has teeth: planted bad rewrites come back red ------------------------


def _opt_program():
    raw = lower_host(get_or_parse_schema(RUN_SCHEMA).ir)
    opt, _ = optimize_program(raw, verify=False)
    assert any(int(r[0]) == hp.OP_FIXED_RUN for r in opt.ops)
    return raw, opt


def _mutate(opt, fn):
    mut = copy.deepcopy(opt)
    ops = np.array(mut.ops, dtype=np.int32, copy=True)
    fn(ops)
    mut.ops = ops
    return mut


def _run_pcs(ops):
    return [i for i, r in enumerate(ops) if int(r[0]) == hp.OP_FIXED_RUN]


@pytest.mark.parametrize("name,mutfn", [
    ("span_tamper", lambda ops: ops.__setitem__(
        (_run_pcs(ops)[0], 2), ops[_run_pcs(ops)[0]][2] + 1)),
    ("member_reorder", lambda ops: ops.__setitem__(
        [_run_pcs(ops)[0] + 1, _run_pcs(ops)[0] + 2],
        ops[[_run_pcs(ops)[0] + 2, _run_pcs(ops)[0] + 1]])),
    ("always_present_overclaim", lambda ops: ops.__setitem__(
        (_run_pcs(ops)[-1], 5),
        ops[_run_pcs(ops)[-1]][5] | hp.FLAG_ALWAYS_PRESENT)),
])
def test_planted_bad_rewrite_is_caught(guards, consumers, name, mutfn):
    raw, opt = _opt_program()
    # the honest rewrite passes the oracle clean
    assert irverify.verify_optimized(raw, opt, guards, consumers) == []
    bad = _mutate(opt, mutfn)
    findings = irverify.verify_optimized(raw, bad, guards, consumers)
    assert findings, f"oracle missed planted rewrite {name!r}"
    assert any(f.rule.startswith("irverify.") for f in findings)


def test_rejected_rewrite_is_counted_never_run(monkeypatch):
    """When the oracle rejects, ``optimize_program`` returns the raw
    program untouched and counts the rejection; a codec then runs the
    raw program."""
    raw = lower_host(get_or_parse_schema(RUN_SCHEMA).ir)

    def always_red(orig, opt, guards, consumers, label="optimized"):
        return [irverify.Finding("irverify.optimize", label, "planted")]

    monkeypatch.setattr(irverify, "verify_optimized", always_red)
    before = metrics.snapshot().get("optimize.rejected", 0.0)
    prog, stats = hopt.optimize_program(raw)
    assert stats.rejected and not stats.applied
    assert stats.findings == ({"rule": "irverify.optimize",
                               "path": "optimized", "line": 0,
                               "message": "planted"},)
    assert prog is raw
    assert [tuple(r) for r in prog.ops] == [tuple(r) for r in raw.ops]
    assert metrics.snapshot().get("optimize.rejected", 0.0) == before + 1
    codec = codec_of(RUN_SCHEMA)
    assert codec.oprog is codec.prog and codec.opt_stats.rejected


# -- parity with the reference -----------------------------------------------------


def _parity(schema):
    try:
        ref_raw = ref_lower(ref_entry(schema).ir)
    except RefUnsupported:
        with pytest.raises(UnsupportedOnDevice):
            lower_host(get_or_parse_schema(schema).ir)
        return None
    raw = lower_host(get_or_parse_schema(schema).ir)
    got, st = optimize_program(raw)
    want, ref_st = ref_optimize(ref_raw)
    assert np.array_equal(np.asarray(got.ops), np.asarray(want.ops))
    assert got.op_aux == want.op_aux
    for f in STAT_FIELDS:
        assert getattr(st, f) == getattr(ref_st, f), f
    return st


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_optimize_program_is_the_references(name):
    st = _parity(SHAPES[name])
    assert st.applied and not st.rejected
    if name in ("reading", "track", "opt_run"):
        assert st.fused_runs >= 1


def test_run_schemas_fuse_as_designed():
    """``chip_smoke.RUN_SCHEMA`` holds a run of exact-width fields (the
    bulk lane, always present) and a run of varints; the nullable run
    of ``NULLABLE_RUN_SCHEMA`` is fused but never always present."""
    runs = {}
    for name in ("reading", "track"):
        prog, _st = optimize_program(lower_host(
            get_or_parse_schema(SHAPES[name]).ir))
        runs[name] = [(int(r[1]), int(r[5])) for r in prog.ops
                      if int(r[0]) == hp.OP_FIXED_RUN]
    assert runs["reading"] == [(1, hp.FLAG_ALWAYS_PRESENT),
                               (0, hp.FLAG_ALWAYS_PRESENT)]
    assert runs["track"] == [(1, 0)]


def test_optimize_program_is_the_references_over_random_schemas():
    checked = 0
    for seed in range(50):
        checked += _parity(random_schema(seed)) is not None
    assert checked >= 40


# -- the VM on the optimized program, errors included ------------------------------


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_optimized_decode_equals_no_opt_and_the_oracle(monkeypatch, name):
    schema = SHAPES[name]
    e = get_or_parse_schema(schema)
    opt = codec_of(schema)
    raw = raw_codec(monkeypatch, schema)
    assert opt.oprog is not opt.prog and raw.oprog is raw.prog
    datums = datums_of(schema, 600, 41)
    got = opt.decode(datums)
    same(got, raw.decode(datums))
    same(got, decode_to_record_batch(datums, e.ir, e.arrow_schema))
    assert wire(opt.encode(got)) == datums

    whole = datums[5]
    for cut in sorted({0, 1, len(whole) // 3, len(whole) // 2,
                       len(whole) - 1}):
        bad = list(datums)
        bad[5] = whole[:cut]
        errs = []
        for fn in (opt.decode, raw.decode,
                   lambda d: decode_to_record_batch(d, e.ir,
                                                    e.arrow_schema)):
            with pytest.raises(MalformedAvro) as ei:
                fn(bad)
            errs.append((ei.value.index, ei.value.err_name))
            if len(errs) < 3:
                errs[-1] += (str(ei.value),)
        assert errs[0] == errs[1], (cut, errs)
        assert errs[0][:2] == errs[2] == (5, errs[2][1]), (cut, errs)
    # a trailing byte names its record on both arms
    bad = list(datums)
    bad[2] = datums[2] + b"\x00"
    for codec in (opt, raw):
        with pytest.raises(MalformedAvro) as ei:
            codec.decode(bad)
        assert (ei.value.index, ei.value.err_name) == (2, "trailing")


def test_threaded_optimized_decode_through_the_api(monkeypatch):
    """``backend="host"`` serves the optimized program through the shard
    runner (rows per chunk past ``_PER_CHUNK_ROWS``), equal to the raw
    program's."""
    import pyruhvro_tpu_torch as port

    monkeypatch.setattr(NativeHostCodec, "_PER_CHUNK_ROWS", 8)
    schema = chip_smoke.RUN_SCHEMA
    datums = datums_of(schema, 300, 3)
    got = port.deserialize_array_threaded(datums, schema, 4, backend="host",
                                          device="cpu")
    codec = port.api._native_host_codec(get_or_parse_schema(schema))
    assert codec.oprog is not codec.prog
    raw = raw_codec(monkeypatch, schema)
    want = raw.decode(datums)
    assert sum(b.num_rows for b in got) == len(datums)
    import pyarrow as pa

    assert pa.Table.from_batches(got).equals(pa.Table.from_batches([want]))
