"""The sanitizer flavours of the port's host modules
(``pyruhvro_tpu_torch/runtime/native.py``, the reference's
``runtime/native/build.py:40-83`` and ``:157-245``), on the CPU.

* The flavours' files: ``.san``, ``.tsan`` and ``.prof`` stems (and
  their combinations) are distinct builds, the flags are the
  reference's, ASan wins when both knobs are set; under either knob a
  ``NativeHostCodec`` pins the VM and ``load_specialized`` raises.
* One subprocess under the ASan+UBSan runtimes' preload builds nothing
  itself (the ``.san`` ``host_codec`` and ``extract`` are built here
  first) and round-trips 2,000 Kafka records and 500 records of each of
  ``chip_smoke.py``'s run schemas through ``backend="host"`` decode and
  encode, the VM's decode at ``nthreads=4`` and the shard runner; it
  must exit 0 with no ``ERROR: AddressSanitizer`` and no UBSan
  ``runtime error:``.
* One subprocess under the ThreadSanitizer runtime's preload does the
  same decodes; no ``WARNING: ThreadSanitizer`` may remain once
  pyarrow's own allocator (``race:libarrow``) is suppressed.

The tests skip only where ``g++ -print-file-name`` finds no runtime.
"""

import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from pyruhvro_tpu_torch.hostpath import specialize  # noqa: E402
from pyruhvro_tpu_torch.hostpath.codec import NativeHostCodec  # noqa: E402
from pyruhvro_tpu_torch.runtime import native  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KNOBS = ("PYRUHVRO_TPU_NATIVE_SAN", "PYRUHVRO_TPU_TSAN",
         "PYRUHVRO_TPU_NATIVE_PROF")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def runtime(name):
    """The sanitizer runtime library ``g++`` links, or None."""
    try:
        out = subprocess.run(["g++", f"-print-file-name={name}"],
                             capture_output=True, text=True).stdout.strip()
    except OSError:
        return None
    return out if os.path.isabs(out) and os.path.exists(out) else None


# -- the flavours' files and flags --------------------------------------------------


def test_flavour_stems_are_distinct():
    paths = {}
    for prof in (False, True):
        for san, tsan in ((False, False), (True, False), (False, True)):
            p = native.build_path("host_codec", prof, san, tsan)
            paths[(prof, san, tsan)] = p
    assert len({p.name for p in paths.values()}) == 6
    stems = {k: p.name.split("-")[0] for k, p in paths.items()}
    assert stems == {
        (False, False, False): "host_codec",
        (False, True, False): "host_codec.san",
        (False, False, True): "host_codec.tsan",
        (True, False, False): "host_codec.prof",
        (True, True, False): "host_codec.san.prof",
        (True, False, True): "host_codec.tsan.prof"}
    # ASan wins: both asked for is the ASan build
    assert native.build_path("extract", False, True, True) == \
        native.build_path("extract", False, True, False)


def test_flags_are_the_references():
    assert native.SAN_FLAGS == ["-fsanitize=address,undefined",
                                "-fno-sanitize-recover=undefined",
                                "-fno-omit-frame-pointer", "-g"]
    assert native.TSAN_FLAGS == ["-fsanitize=thread",
                                 "-fno-omit-frame-pointer", "-g"]
    assert native.flavour_flags(True, True, False) == \
        native.PROF_FLAGS + native.SAN_FLAGS
    assert native.flavour_flags(False, True, True) == native.SAN_FLAGS
    assert native.flavour_flags(False, False, True) == native.TSAN_FLAGS
    assert native.flavour_flags() == []


@pytest.mark.parametrize("san,tsan,want", [
    ("", "", (False, False)), ("1", "", (True, False)),
    ("", "1", (False, True)), ("1", "1", (True, False))])
def test_knobs_select_the_flavour(monkeypatch, san, tsan, want):
    monkeypatch.setenv("PYRUHVRO_TPU_NATIVE_SAN", san)
    monkeypatch.setenv("PYRUHVRO_TPU_TSAN", tsan)
    assert (native.san_active(), native.tsan_active()) == want


def test_locks_per_flavour_and_loaded_reads_the_knob(monkeypatch):
    assert {"host_codec", "host_codec@san", "host_codec@tsan@prof",
            "extract@san@prof", "packer@tsan"} <= set(native._locks)
    native.load_host_codec()
    assert native.loaded("host_codec")
    monkeypatch.setenv("PYRUHVRO_TPU_NATIVE_SAN", "1")
    # the knob's flavour: the plain build does not stand in for it
    assert native.loaded("host_codec") == ("host_codec@san" in native._loaded)
    assert native.loaded("host_codec", san=False)


@pytest.mark.parametrize("knob", ["PYRUHVRO_TPU_NATIVE_SAN",
                                  "PYRUHVRO_TPU_TSAN"])
def test_sanitizer_session_pins_the_vm(monkeypatch, knob):
    """The engine cache does not key the flavour: a sanitized session's
    codec never specialises, and a direct build raises."""
    e = get_or_parse_schema(datagen.KAFKA_SCHEMA_JSON)
    # the plain VM already loaded stands in for the module the codec loads
    plain = native.load_host_codec()
    monkeypatch.setattr(native, "load_host_codec", lambda: plain)
    monkeypatch.setenv("PYRUHVRO_TPU_SPECIALIZE_ROWS", "0")
    monkeypatch.delenv("PYRUHVRO_TPU_NO_SPECIALIZE", raising=False)
    monkeypatch.setenv(knob, "1")
    codec = NativeHostCodec(e.ir, e.arrow_schema)
    assert codec._spec_failed
    datums = datagen.kafka_style_datums(50, seed=3)
    codec.decode(datums)
    assert codec._spec is None
    with pytest.raises(RuntimeError, match="sanitizer"):
        specialize.load_specialized(codec.prog)


# -- the sanitized round trips -------------------------------------------------------

DRIVER = textwrap.dedent("""
    import sys
    import pyruhvro_tpu_torch as port
    from pyruhvro_tpu_torch.hostpath.codec import NativeHostCodec
    from pyruhvro_tpu_torch.runtime import native
    from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema
    from pyruhvro_tpu_torch.utils import datagen
    import chip_smoke

    encode = sys.argv[1] == "encode"
    NativeHostCodec._PER_CHUNK_ROWS = 64
    cases = [(datagen.KAFKA_SCHEMA_JSON,
              datagen.kafka_style_datums(2000, seed=1))]
    for schema in (chip_smoke.RUN_SCHEMA, chip_smoke.NULLABLE_RUN_SCHEMA):
        cases.append((schema, datagen.random_datums(
            get_or_parse_schema(schema).ir, 500, seed=2)))
    for schema, datums in cases:
        e = get_or_parse_schema(schema)
        codec = port.api._native_host_codec(e)
        assert codec.oprog is not codec.prog, schema
        one = codec.decode(datums, nthreads=4)
        assert one.equals(codec.decode(datums, nthreads=1))
        batch = port.deserialize_array(datums, schema, backend="host",
                                       device="cpu")
        assert batch.equals(one)
        chunks = port.deserialize_array_threaded(datums, schema, 4,
                                                 backend="host",
                                                 device="cpu")
        assert sum(b.num_rows for b in chunks) == len(datums)
        if encode:
            for n in (1, 4):
                arrays = port.serialize_record_batch(batch, schema, n,
                                                     backend="host",
                                                     device="cpu")
                wire = [bytes(x) for a in arrays for x in a.to_pylist()]
                assert wire == datums, schema
            host_mode = codec._encode_host_mode(batch, batch.num_rows, 1)
            assert [bytes(x) for x in host_mode.to_pylist()] == datums
    names = [native.load_host_codec().path.name]
    if encode:
        names.append(native.load_extract().path.name)
    print("MODULES", *names)
""")


def run_sanitized(flavour, env_extra, preload, arg):
    env = dict(os.environ)
    for name in KNOBS:
        env.pop(name, None)
    env.update(env_extra)
    env.update({"LD_PRELOAD": " ".join(preload),
                "PYTHONPATH": str(REPO),
                "PYRUHVRO_TPU_NO_SPECIALIZE": "1",
                "PYRUHVRO_TPU_SAMPLE_BUDGET": "0",
                "PYRUHVRO_TPU_NO_AUDIT": "1",
                "PYRUHVRO_TPU_NO_TIMELINE": "1"})
    proc = subprocess.run([sys.executable, "-c", DRIVER, arg], env=env,
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=600)
    return proc, proc.stdout + proc.stderr


def build_flavours(flavours):
    """Build the sanitized modules here, in parallel, so that the
    subprocesses only load them."""
    def build(job):
        name, san, tsan = job
        rel, _mod = native.SOURCES[name]
        native.compile_extension(native.CSRC / rel,
                                 native.build_path(name, False, san, tsan),
                                 flags=native.flavour_flags(False, san, tsan))

    with ThreadPoolExecutor(len(flavours)) as ex:
        list(ex.map(build, flavours))


@pytest.fixture(scope="module")
def built():
    flavours = [("host_codec", True, False), ("extract", True, False),
                ("host_codec", False, True)]
    build_flavours(flavours)
    return flavours


def test_asan_ubsan_round_trip(built):
    preload = [runtime("libasan.so"), runtime("libubsan.so")]
    if None in preload:
        pytest.skip("g++ finds no ASan/UBSan runtime")
    proc, out = run_sanitized(
        "san", {"PYRUHVRO_TPU_NATIVE_SAN": "1",
                "ASAN_OPTIONS": "detect_leaks=0:verify_asan_link_order=0",
                "UBSAN_OPTIONS": "print_stacktrace=1"},
        preload, "encode")
    assert proc.returncode == 0, out[-4000:]
    assert "ERROR: AddressSanitizer" not in out, out[-4000:]
    assert "runtime error:" not in out, out[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("MODULES")][0]
    assert line.split()[1].startswith("host_codec.san-")
    assert line.split()[2].startswith("extract.san-")


def test_tsan_decode(built, tmp_path):
    preload = [runtime("libtsan.so")]
    if None in preload:
        pytest.skip("g++ finds no TSan runtime")
    supp = tmp_path / "tsan.supp"
    # pyarrow's allocator is not instrumented: its frees race with the
    # instrumented reads in the sanitizer's view
    supp.write_text("race:libarrow\n")
    proc, out = run_sanitized(
        "tsan", {"PYRUHVRO_TPU_TSAN": "1",
                 "TSAN_OPTIONS": f"halt_on_error=0 suppressions={supp}"},
        preload, "decode")
    assert proc.returncode == 0, out[-4000:]
    assert "WARNING: ThreadSanitizer" not in out, out[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("MODULES")][0]
    assert line.split()[1].startswith("host_codec.tsan-")
