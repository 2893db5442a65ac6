"""Build and load the port's native host modules (``csrc/packer.cpp``, the
record pack, and ``csrc/host/host_codec.cpp`` / ``csrc/host/extract.cpp``,
the host tier's VM and Arrow-native extractor).

The reference's recipe (``pyruhvro_tpu/runtime/native/build.py``): each
source compiles at first use with the host compiler, ``g++ -O3 -shared
-fPIC -std=c++17 -pthread`` and Python's include directory, trying
``-march=native`` first and falling back to the generic flags, into a
CPython extension under ``build/pyruhvro_tpu_torch/`` at the repository
root. The file name is keyed by a hash of the source and of every header
it includes (followed through ``#include "..."``), the interpreter, the
flags and the CPU's ISA flags (the reference's ``_cpu_tag``): an edited
header, another interpreter or a ``-march=native`` build met on another
CPU rebuilds. The module loads through ``importlib`` from that path. A
failed build raises ``RuntimeError``: nothing falls back to Python code.

The profiled flavour (the reference's ``build.py:157-200`` and
``:266-292``): ``load(name, prof=True)`` builds the same source with
``-DPYRUHVRO_NATIVE_PROF=1`` into its own file (``<stem>.prof-<hash>``),
whose module also exports ``prof_drain()`` (per-opcode hits and self
nanoseconds, ``vm.op.*`` / ``vm.encop.*`` / ``extract.op.*``). Under
``PYRUHVRO_TPU_NATIVE_PROF=1`` :func:`load_host_codec` and
:func:`load_extract` return it; :func:`load_host_codec_prof` returns it
whatever the knob says, for the deep sampler (:mod:`.sampling`). A
failed profiled build raises like any other, where the reference warns
and loads the plain module (``ROADMAP.md`` (c) 7).

The sanitizer flavours (the reference's ``build.py:40-83`` and
``:157-245``): under ``PYRUHVRO_TPU_NATIVE_SAN=1`` every host module
builds with :data:`SAN_FLAGS` (ASan + UBSan) into ``<stem>.san-<hash>``,
under ``PYRUHVRO_TPU_TSAN=1`` with :data:`TSAN_FLAGS` into
``<stem>.tsan-<hash>``; either combines with ``.prof``, and the two
runtimes cannot share a process, so ASan wins when both are set
(:func:`san_active`, :func:`tsan_active`). The flags are part of
:func:`build_path`'s hash and each flavour has its own build lock. An
instrumented module loads only in a Python started under its runtime's
preload (``LD_PRELOAD`` of ``g++ -print-file-name=libasan.so`` and
``libubsan.so``, or of ``libtsan.so``). A failed sanitized build raises,
as every build does. The ``nvcc`` kernels have no sanitizer flavour.

The specialiser (:mod:`..hostpath.specialize`) builds its generated
units with the same recipe (:func:`compile_extension`), into
``build/pyruhvro_tpu_torch/_spec/``.

The ``native_build`` fault seam (:mod:`.faults`) fires at every
:func:`load` and raises into the caller; it is not memoized, so the
module loads again once the spec clears.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import platform
import re
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path

__all__ = ["load_packer", "load_host_codec", "load_host_codec_prof",
           "load_extract", "load", "loaded", "build_path", "source_files",
           "compile_extension", "import_extension", "cpu_tag",
           "prof_active", "san_active", "tsan_active", "flavour_flags",
           "NativeModule", "SOURCES", "SAN_FLAGS", "TSAN_FLAGS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pyruhvro_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
NATIVE_FLAGS = ["-march=native"]
PROF_FLAGS = ["-DPYRUHVRO_NATIVE_PROF=1"]
# the ASan+UBSan flavour and the ThreadSanitizer flavour
SAN_FLAGS = ["-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
             "-fno-omit-frame-pointer", "-g"]
TSAN_FLAGS = ["-fsanitize=thread", "-fno-omit-frame-pointer", "-g"]

# name → (source under csrc/, the PyInit_ name it exports)
SOURCES = {
    "packer": ("packer.cpp", "_pyruhvro_torch_packer"),
    "host_codec": ("host/host_codec.cpp", "_pyruhvro_torch_hostcodec"),
    "extract": ("host/extract.cpp", "_pyruhvro_torch_extract"),
}

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

# the loaded modules; the per-flavour locks below serialise the builds,
# this one only the dict's stores
_loaded_lock = threading.Lock()
_loaded: dict = {}   # guarded-by: _loaded_lock
# one build lock per flavour: "<name>" with "@san" or "@tsan" and "@prof"
# lock-free-ok(built once at import, never mutated)
_locks = {name + san + prof: threading.Lock() for name in SOURCES
          for san in ("", "@san", "@tsan") for prof in ("", "@prof")}


class NativeModule:
    """The loaded extension plus how it was built."""

    def __init__(self, module, path: Path, command, build_s: float):
        self.module = module
        self.path = path
        self.command = command    # the g++ command line (list)
        self.build_s = build_s    # 0.0 when an earlier build was reused


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native host modules build "
                           "with the host C++ compiler")
    return found


def cpu_tag() -> str:
    """A fingerprint of this host's ISA flags (copy of the reference's
    ``_cpu_tag``): a ``-march=native`` build is only reused on a CPU
    with the same flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return hashlib.sha256(
        (platform.machine() + "|" + flags).encode()).hexdigest()[:16]


def source_files(src: Path) -> list:
    """``src`` and every file it includes with ``#include "..."``,
    transitively, resolved beside the including file; each once, in the
    order first met."""
    seen, todo = [], [src.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / inc.decode()).resolve())
    return seen


def prof_active() -> bool:
    """Do the host modules load as their profiled flavour
    (``PYRUHVRO_TPU_NATIVE_PROF``)?"""
    from . import knobs

    return knobs.get_bool("PYRUHVRO_TPU_NATIVE_PROF")


def san_active() -> bool:
    """Do the host modules load as their ASan+UBSan flavour
    (``PYRUHVRO_TPU_NATIVE_SAN``)?"""
    from . import knobs

    return knobs.get_bool("PYRUHVRO_TPU_NATIVE_SAN")


def tsan_active() -> bool:
    """Do the host modules load as their ThreadSanitizer flavour
    (``PYRUHVRO_TPU_TSAN``, unless the ASan flavour is also asked for:
    the two runtimes cannot share a process)?"""
    from . import knobs

    return knobs.get_bool("PYRUHVRO_TPU_TSAN") and not san_active()


def _flavour(san, tsan):
    """``(san, tsan)`` with each ``None`` read from its knob; ASan wins."""
    san = san_active() if san is None else san
    tsan = tsan_active() if tsan is None else tsan
    return san, tsan and not san


def flavour_flags(prof: bool = False, san: bool = False,
                  tsan: bool = False) -> list:
    """The compiler flags a flavour adds to :data:`CXX_FLAGS`."""
    return ((PROF_FLAGS if prof else []) + (SAN_FLAGS if san else [])
            + (TSAN_FLAGS if tsan and not san else []))


def _key(name: str, prof: bool, san: bool, tsan: bool) -> str:
    return (name + ("@san" if san else "@tsan" if tsan else "")
            + ("@prof" if prof else ""))


def build_path(name: str, prof: bool = False, san: bool = False,
               tsan: bool = False) -> Path:
    """Where the build of ``SOURCES[name]`` lives: its name carries a hash
    of the source and its headers, the interpreter, the flags and
    :func:`cpu_tag`; the sanitizer flavours' stems end ``.san`` or
    ``.tsan``, the profiled flavour's ``.prof`` after that."""
    src = CSRC / SOURCES[name][0]
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key = hashlib.sha256()
    for path in source_files(src):
        key.update(path.name.encode() + b"\0" + path.read_bytes())
    tsan = tsan and not san
    flags = CXX_FLAGS + flavour_flags(prof, san, tsan)
    key.update(f"{sys.version}|{include}|{flags}|{NATIVE_FLAGS}|"
               f"{cpu_tag()}".encode())
    stem = (src.stem + (".san" if san else ".tsan" if tsan else "")
            + (".prof" if prof else ""))
    return BUILD_DIR / f"{stem}-{key.hexdigest()[:16]}{suffix}"


def load(name: str, prof: bool = False, san=None, tsan=None) -> NativeModule:
    """Compile the source ``SOURCES[name]`` (once per content of it and
    its headers, interpreter, CPU and flavour) and import it; ``prof``
    selects the profiled flavour, ``san`` and ``tsan`` the sanitizer
    flavours (``None``: as :func:`san_active` / :func:`tsan_active`
    say). Raises ``RuntimeError`` when the build fails, and
    ``FaultInjected`` under a ``native_build`` fault."""
    from . import faults

    faults.fire("native_build")
    san, tsan = _flavour(san, tsan)
    key = _key(name, prof, san, tsan)
    with _locks[key]:
        mod = _loaded.get(key)
        if mod is not None:
            return mod
        rel, module_name = SOURCES[name]
        out = build_path(name, prof, san, tsan)
        cmd, build_s = compile_extension(
            CSRC / rel, out, flags=flavour_flags(prof, san, tsan))
        mod = NativeModule(import_extension(module_name, out), out, cmd,
                           build_s)
        with _loaded_lock:
            _loaded[key] = mod
        if build_s and key == name:
            from . import device_obs

            # carried by the first device launch that uses it
            device_obs.note_build(name, build_s)
        return mod


def compile_extension(src: Path, out: Path, includes=(), flags=()):
    """Build the CPython extension ``out`` from ``src`` unless it exists:
    ``g++`` with :data:`CXX_FLAGS` and a flavour's ``flags``
    (:func:`flavour_flags`), Python's include directory and ``-I`` of each of
    ``includes``, ``-march=native`` first and the generic flags where the
    compiler refuses it. Written to a temporary name and moved into
    place, so that processes building the same file never read half of
    it. Returns the command line that built it and its seconds (0.0 when
    ``out`` was there); raises ``RuntimeError`` when the build fails."""
    cxx = _cxx()
    include = sysconfig.get_paths()["include"]
    base = [cxx, *CXX_FLAGS, *flags,
            f"-I{include}", *(f"-I{d}" for d in includes), str(src), "-o"]
    cmd = [cxx, *NATIVE_FLAGS, *base[1:], str(out)]
    if out.exists():
        return cmd, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd[:-1] + [str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        # a compiler without -march=native (or refusing it here): the
        # generic flags, as the reference falls back
        cmd = base + [str(out)]
        proc = subprocess.run(base + [str(tmp)], capture_output=True,
                              text=True)
    build_s = time.perf_counter() - t0
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {src}:"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return cmd, build_s


def import_extension(module_name: str, path: Path):
    """Import the extension at ``path`` (its ``PyInit_`` name is
    ``module_name``) through ``importlib``, outside ``sys.modules``."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loaded(name: str, prof: bool = False, san=None, tsan=None) -> bool:
    """Is ``SOURCES[name]`` (the profiled flavour with ``prof``; the
    sanitizer flavours as :func:`load` reads them) built and imported in
    this process? Never builds."""
    return _key(name, prof, *_flavour(san, tsan)) in _loaded


def load_packer() -> NativeModule:
    """The native record pack (``csrc/packer.cpp``)."""
    return load("packer")


def load_host_codec() -> NativeModule:
    """The host tier's decode/encode VM (``csrc/host/host_codec.cpp``),
    profiled under ``PYRUHVRO_TPU_NATIVE_PROF=1``."""
    return load("host_codec", prof_active())


def load_host_codec_prof() -> NativeModule:
    """The profiled VM whatever the knob says: the deep sampler runs
    single calls through it while the rest stay on the plain build."""
    return load("host_codec", True)


def load_extract() -> NativeModule:
    """The host tier's Arrow-native extractor and fused encode
    (``csrc/host/extract.cpp``), profiled under
    ``PYRUHVRO_TPU_NATIVE_PROF=1``."""
    return load("extract", prof_active())
