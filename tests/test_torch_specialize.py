"""The port's specialiser (``pyruhvro_tpu_torch/hostpath/specialize.py``, a
copy of ``pyruhvro_tpu/hostpath/specialize.py``) held against the
reference and against the VM and the oracle, on the CPU.

* :func:`generate_source` gives the reference's text (the first line,
  which names the generating module, aside) for Kafka, ``arr_rec_arr``,
  the criterion shapes and random schemas, effect trailers included.
* A specialised codec (``PYRUHVRO_TPU_SPECIALIZE_ROWS=0``) decodes and
  encodes as the VM (``PYRUHVRO_TPU_NO_SPECIALIZE=1``) and the oracle,
  truncation errors and their messages included, on both encode lanes.
* The row threshold accumulates over calls; ``host.vm_s`` and
  ``host.encode_vm_s`` say which engine ran.
* The engines plane: an engine evicted by the plane's cap is re-admitted
  on the next call by importing its file again, with no second ``g++``
  run; ``mem-report`` and ``knobs`` list it.
* A failed ``g++`` build raises ``RuntimeError`` (``ROADMAP.md`` (c) 7).

Each generated unit takes a few seconds of ``g++``: the module builds
the ones it needs in parallel first, into the git-ignored ``build/``.
Decode and encode are integer and byte work: the tolerance is 0.
"""

import json
import os
import shutil
import sysconfig
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from pyruhvro_tpu.hostpath import specialize as ref_specialize  # noqa: E402
from pyruhvro_tpu.hostpath.program import lower_host as ref_lower  # noqa: E402
from pyruhvro_tpu.schema.cache import get_or_parse_schema as ref_entry  # noqa: E402
from pyruhvro_tpu.utils.datagen import (  # noqa: E402
    WIDENED_SCHEMA_JSON,
    random_schema,
    widened_datums,
)

import chip_smoke  # noqa: E402
import pyruhvro_tpu_torch as port  # noqa: E402
from pyruhvro_tpu_torch.errors import MalformedAvro  # noqa: E402
from pyruhvro_tpu_torch.fallback.decoder import decode_to_record_batch  # noqa: E402
from pyruhvro_tpu_torch.gate import host_supported  # noqa: E402
from pyruhvro_tpu_torch.hostpath import specialize  # noqa: E402
from pyruhvro_tpu_torch.hostpath.codec import NativeHostCodec  # noqa: E402
from pyruhvro_tpu_torch.hostpath.program import lower_host  # noqa: E402
from pyruhvro_tpu_torch.runtime import (  # noqa: E402
    cachelife,
    memacct,
    metrics,
    native,
    telemetry,
)
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

KAFKA = datagen.KAFKA_SCHEMA_JSON
SHAPES = {"kafka": KAFKA, **datagen.CRITERION_SHAPES,
          "arr_rec_arr": chip_smoke.PIPELINE_SHAPES["arr_rec_arr"],
          "widened": WIDENED_SCHEMA_JSON}
FUZZ_SEEDS = [11, 42, 101, 250, 333]


def random_schemas(count: int):
    """The reference's random schemas inside the host subset, by seed."""
    out = []
    seed = 0
    while len(out) < count:
        schema = random_schema(seed)
        if host_supported(get_or_parse_schema(schema).ir):
            out.append((seed, schema))
        seed += 1
    return out


def fuzz_schema(seed):
    schema = random_schema(seed)
    return schema if host_supported(get_or_parse_schema(schema).ir) else None


def datums_of(name_or_schema, n, seed):
    if name_or_schema == "kafka":
        return datagen.kafka_style_datums(n, seed=seed)
    if name_or_schema == "widened":
        return widened_datums(n, seed=seed)
    schema = SHAPES.get(name_or_schema, name_or_schema)
    return datagen.random_datums(get_or_parse_schema(schema).ir, n, seed=seed)


def wire(arr):
    return [bytes(x) for x in arr.to_pylist()]


def same(got, want):
    assert got.schema.equals(want.schema)
    assert got.to_pylist() == want.to_pylist()


@pytest.fixture(scope="module", autouse=True)
def _units():
    """Build every unit this module loads, in parallel, so that each
    codec's first call finds its module on disk."""
    schemas = list(SHAPES.values()) + [s for s in map(fuzz_schema,
                                                      FUZZ_SEEDS) if s]

    def build(schema):
        prog = lower_host(get_or_parse_schema(schema).ir)
        name = specialize.module_name(prog)
        src = specialize.spec_dir() / (name + ".cpp")
        if not src.exists():  # written whole: other processes may read it
            src.parent.mkdir(parents=True, exist_ok=True)
            tmp = src.with_name(f"{src.name}.{os.getpid()}.tmp")
            tmp.write_text(specialize.generate_source(prog, name,
                                                      specialize._CORE))
            os.replace(tmp, src)
        so = specialize.spec_dir() / (
            name + sysconfig.get_config_var("EXT_SUFFIX"))
        native.compile_extension(src, so, includes=(specialize._HOST_DIR,))

    native.load_host_codec()
    native.load_extract()
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(build, schemas))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("PYRUHVRO_TPU_NO_SPECIALIZE", raising=False)
    monkeypatch.delenv("PYRUHVRO_TPU_NATIVE_PROF", raising=False)
    monkeypatch.setenv("PYRUHVRO_TPU_ROUTING_PROFILE", "")
    monkeypatch.setenv("PYRUHVRO_TPU_SAMPLE_BUDGET", "0")
    monkeypatch.setenv("PYRUHVRO_TPU_NO_AUDIT", "1")
    telemetry.reset()
    yield
    telemetry.reset()


def spec_codec(monkeypatch, schema: str) -> NativeHostCodec:
    monkeypatch.setenv("PYRUHVRO_TPU_SPECIALIZE_ROWS", "0")
    e = get_or_parse_schema(schema)
    return NativeHostCodec(e.ir, e.arrow_schema)


def vm_codec(monkeypatch, schema: str) -> NativeHostCodec:
    monkeypatch.setenv("PYRUHVRO_TPU_NO_SPECIALIZE", "1")
    e = get_or_parse_schema(schema)
    c = NativeHostCodec(e.ir, e.arrow_schema)
    monkeypatch.delenv("PYRUHVRO_TPU_NO_SPECIALIZE")
    return c


# -- the generated text ----------------------------------------------------------


def ref_text(schema, name="M", **kw):
    text = ref_specialize.generate_source(ref_lower(ref_entry(schema).ir),
                                          name, **kw)
    return text.replace("// AUTO-GENERATED by pyruhvro_tpu.hostpath.",
                        "// AUTO-GENERATED by pyruhvro_tpu_torch.hostpath.", 1)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_generated_source_is_the_references(name):
    schema = SHAPES[name]
    prog = lower_host(get_or_parse_schema(schema).ir)
    assert specialize.generate_source(prog, "M") == ref_text(schema)
    assert specialize.generate_source(prog, "M", with_effects=True) == \
        ref_text(schema, with_effects=True)
    # the unit the port builds includes the cores by name, under its own
    # module name
    name = specialize.module_name(prog)
    assert name.startswith("_pyruhvro_torch_spec_")
    unit = specialize.generate_source(prog, name, specialize._CORE)
    assert '#include "arrow_decode_core.h"' in unit
    assert f"PyInit_{name}(void)" in unit


def test_generated_source_of_random_schemas_is_the_references():
    cases = random_schemas(24)
    for seed, schema in cases:
        prog = lower_host(get_or_parse_schema(schema).ir)
        assert specialize.generate_source(prog, "M") == ref_text(schema), \
            seed
        assert specialize.generate_source(prog, "M", with_effects=True) \
            == ref_text(schema, with_effects=True), seed
    # distinct programs, distinct engines
    names = {specialize.module_name(lower_host(
        get_or_parse_schema(s).ir)) for _, s in cases}
    assert len(names) == len({s for _, s in cases})


def test_module_name_covers_the_headers_and_the_cpu(monkeypatch, tmp_path):
    prog = lower_host(get_or_parse_schema(KAFKA).ir)
    first = specialize.module_name(prog)
    copy = tmp_path / "host"
    shutil.copytree(specialize._HOST_DIR, copy)
    monkeypatch.setattr(specialize, "_HOST_DIR", copy)
    assert specialize.module_name(prog) == first
    (copy / "host_vm_core.h").write_text(
        (copy / "host_vm_core.h").read_text() + "\n// edited\n")
    second = specialize.module_name(prog)
    assert second != first
    monkeypatch.setattr(native, "cpu_tag", lambda: "another-cpu")
    assert specialize.module_name(prog) != second
    assert specialize.spec_dir() == native.BUILD_DIR / "_spec"


# -- specialised against the VM and the oracle ----------------------------------


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_specialized_equals_the_vm_and_the_oracle(monkeypatch, name):
    schema = SHAPES[name]
    e = get_or_parse_schema(schema)
    datums = datums_of(name, 400, 31)
    vm = vm_codec(monkeypatch, schema)
    codec = spec_codec(monkeypatch, schema)
    got = codec.decode(datums)
    assert codec._spec is not None, "specialization did not engage"
    want = decode_to_record_batch(datums, e.ir, e.arrow_schema)
    same(got, want)
    same(vm.decode(datums), want)
    assert vm._spec is None
    # a second call reuses the module
    same(codec.decode(datums), want)
    # both encode lanes write the input's wire bytes, as the VM's do
    assert wire(codec.encode(got)) == wire(vm.encode(got)) == \
        [bytes(d) for d in datums]
    assert wire(codec._encode_host_mode(got, got.num_rows)) == \
        wire(vm._encode_host_mode(got, got.num_rows)) == \
        [bytes(d) for d in datums]


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_specialized_random_schema_fuzz(monkeypatch, seed):
    schema = fuzz_schema(seed)
    assert schema is not None, seed
    e = get_or_parse_schema(schema)
    datums = datums_of(schema, 200, seed + 1)
    codec = spec_codec(monkeypatch, schema)
    got = codec.decode(datums)
    assert codec._spec is not None
    same(got, decode_to_record_batch(datums, e.ir, e.arrow_schema))
    assert wire(codec.encode(got)) == [bytes(d) for d in datums]


def test_specialized_truncation_matches_the_vm(monkeypatch):
    datums = datagen.kafka_style_datums(8, seed=5)
    vm = vm_codec(monkeypatch, KAFKA)
    spec = spec_codec(monkeypatch, KAFKA)
    spec.decode(datums)  # engage specialization
    assert spec._spec is not None
    e = get_or_parse_schema(KAFKA)
    whole = datums[3]
    for cut in (0, 1, 2, len(whole) // 2, len(whole) - 1):
        bad = list(datums)
        bad[3] = whole[:cut]
        errs = []
        for codec in (spec, vm):
            with pytest.raises(MalformedAvro) as ei:
                codec.decode(bad)
            errs.append((str(ei.value), ei.value.index, ei.value.tier))
        assert errs[0] == errs[1], f"cut={cut}: {errs}"
        assert errs[0][1] == 3
        # the oracle names the same record
        with pytest.raises(MalformedAvro) as ei:
            decode_to_record_batch(bad, e.ir, e.arrow_schema)
        assert ei.value.index == 3
    # trailing garbage
    bad = list(datums)
    bad[0] = whole + b"\x00"
    with pytest.raises(MalformedAvro, match="record 0"):
        spec.decode(bad)


def test_specialized_empty_and_reuse(monkeypatch):
    codec = spec_codec(monkeypatch, KAFKA)
    assert codec.decode([]).num_rows == 0
    assert codec.decode(datagen.kafka_style_datums(5, seed=9)).num_rows == 5
    assert codec._spec is not None


@pytest.mark.parametrize("engine", ["vm", "spec"])
def test_decode_nthreads_multi(monkeypatch, engine):
    """Row-sharded decode (nthreads > 1) equals one thread on both
    engines, and a bad record in a later shard names its global index."""
    codec = (spec_codec if engine == "spec" else vm_codec)(monkeypatch,
                                                           KAFKA)
    datums = datagen.kafka_style_datums(20_000, seed=29)
    got = codec.decode(datums, nthreads=4)
    assert (codec._spec is not None) == (engine == "spec")
    same(got, codec.decode(datums, nthreads=1))
    e = get_or_parse_schema(KAFKA)
    same(got.slice(0, 500),
         decode_to_record_batch(datums[:500], e.ir, e.arrow_schema))
    bad = list(datums)
    bad[17_803] = datums[17_803][:1]
    with pytest.raises(MalformedAvro, match="record 17803"):
        codec.decode(bad, nthreads=4)


# -- the threshold and the engine's telemetry ---------------------------------


def test_threshold_accumulates_rows(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_SPECIALIZE_ROWS", "10")
    e = get_or_parse_schema(KAFKA)
    codec = NativeHostCodec(e.ir, e.arrow_schema)
    datums = datagen.kafka_style_datums(4, seed=13)
    codec.decode(datums)
    assert codec._spec is None  # 4 rows seen: under threshold
    batch = codec.decode(datums)
    assert codec._spec is None  # 8 rows
    codec.encode(batch)  # encoded rows count too: 12
    assert codec._spec is not None


def test_no_specialize_pins_the_vm(monkeypatch):
    monkeypatch.setenv("PYRUHVRO_TPU_NO_SPECIALIZE", "1")
    monkeypatch.setenv("PYRUHVRO_TPU_SPECIALIZE_ROWS", "0")
    e = get_or_parse_schema(KAFKA)
    codec = NativeHostCodec(e.ir, e.arrow_schema)
    datums = datagen.kafka_style_datums(6, seed=17)
    same(codec.decode(datums),
         decode_to_record_batch(datums, e.ir, e.arrow_schema))
    assert codec._spec is None


def _phase_attrs(snap, name):
    out = []

    def walk(s):
        if s["name"] == name:
            out.append(s.get("attrs") or {})
        for c in s.get("children") or ():
            walk(c)

    for s in snap["spans"]:
        walk(s)
    return out


def test_host_backend_says_which_engine_ran(monkeypatch):
    schema = json.dumps(dict(json.loads(KAFKA), doc="engine attribute"))
    datums = datagen.kafka_style_datums(50, seed=3)
    monkeypatch.setenv("PYRUHVRO_TPU_SPECIALIZE_ROWS", "60")
    first = port.deserialize_array(datums, schema, backend="host")
    second = port.deserialize_array(datums, schema, backend="host")
    same(second, first)
    arrays = port.serialize_record_batch(second, schema, 1, backend="host")
    assert wire(arrays[0]) == [bytes(d) for d in datums]
    snap = telemetry.snapshot()
    assert [a["specialized"] for a in _phase_attrs(snap, "host.vm_s")] == \
        [False, True]
    assert [a["specialized"] for a in
            _phase_attrs(snap, "host.encode_vm_s")] == [True]


# -- the engines plane --------------------------------------------------------------


def test_evicted_engine_is_readmitted_without_a_second_build(monkeypatch):
    # every plane starts empty: a TTL pass far in the future
    monkeypatch.setenv("PYRUHVRO_TPU_CACHE_TTL_S", "1")
    cachelife.sweep(time.monotonic() + 1e6)
    monkeypatch.delenv("PYRUHVRO_TPU_CACHE_TTL_S")
    assert memacct.collect(force=True)["cache.engines"]["items"] == 0
    telemetry.reset()
    monkeypatch.setenv("PYRUHVRO_TPU_CACHE_MAX_ENGINES", "1")
    a = spec_codec(monkeypatch, KAFKA)
    b = spec_codec(monkeypatch, SHAPES["nested_struct"])
    da = datagen.kafka_style_datums(30, seed=1)
    db = datums_of("nested_struct", 30, 2)
    want_a = a.decode(da)
    assert a._spec is not None
    b.decode(db)  # its admission evicts the least recently used: a's
    assert b._spec is not None and a._spec is None
    c = metrics.snapshot()
    assert c.get("specialize.evictions") == 1
    assert c.get("cache.evict.engines.lru") == 1
    builds = c.get("specialize.builds", 0)
    probe = memacct.collect(force=True)["cache.engines"]
    assert probe["items"] == 1 and probe["bytes"] > 0
    # the next call re-admits a's engine from its file: no g++ run
    same(a.decode(da), want_a)
    assert a._spec is not None and b._spec is None
    c = metrics.snapshot()
    assert c.get("specialize.builds", 0) == builds
    assert c.get("specialize.evictions") == 2
    assert cachelife.snapshot_lifecycle()["engines"]["entries"] == 1


def test_engines_plane_in_mem_report_and_knobs(monkeypatch, tmp_path,
                                               capsys):
    codec = spec_codec(monkeypatch, KAFKA)
    codec.decode(datagen.kafka_style_datums(3, seed=4))
    snap = telemetry.snapshot()
    assert snap["memory"]["caches"]["cache.engines"]["items"] >= 1
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(snap, default=str))
    assert telemetry.main(["mem-report", str(path)]) == 0
    assert "cache.engines" in capsys.readouterr().out
    assert telemetry.main(["knobs"]) == 0
    out = capsys.readouterr().out
    for name, default in (("PYRUHVRO_TPU_SPECIALIZE_ROWS", "20000"),
                          ("PYRUHVRO_TPU_NO_SPECIALIZE", "False"),
                          ("PYRUHVRO_TPU_CACHE_MAX_ENGINES", "256")):
        assert f"{name}  [" in out and f"default {default}]" in \
            out.split(name, 1)[1].splitlines()[0]


def test_failed_build_raises(monkeypatch, tmp_path):
    schema = ('{"type":"record","name":"SpecBuildFails","fields":['
              '{"name":"x","type":"long"},{"name":"s","type":"string"}]}')
    e = get_or_parse_schema(schema)
    monkeypatch.setenv("PYRUHVRO_TPU_SPECIALIZE_ROWS", "0")
    codec = NativeHostCodec(e.ir, e.arrow_schema)  # the VM is built
    monkeypatch.setattr(native, "_cxx", lambda: shutil.which("false"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    data = [b"\x02\x02a", b"\x04\x00"]
    for _ in range(2):  # not latched: each call tries again, and raises
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            codec.decode(data)
    assert codec._spec is None
    assert not list((tmp_path / "_spec").glob("*.so"))
    monkeypatch.setenv("PYRUHVRO_TPU_NO_SPECIALIZE", "1")
    assert NativeHostCodec(e.ir, e.arrow_schema).decode(data) \
        .column(0).to_pylist() == [1, 2]
