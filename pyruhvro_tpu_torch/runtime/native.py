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
The reference's profiler and sanitizer flavours are not ported.
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

__all__ = ["load_packer", "load_host_codec", "load_extract", "load", "loaded",
           "build_path", "source_files", "cpu_tag", "NativeModule",
           "SOURCES"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pyruhvro_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
NATIVE_FLAGS = ["-march=native"]

# name → (source under csrc/, the PyInit_ name it exports)
SOURCES = {
    "packer": ("packer.cpp", "_pyruhvro_torch_packer"),
    "host_codec": ("host/host_codec.cpp", "_pyruhvro_torch_hostcodec"),
    "extract": ("host/extract.cpp", "_pyruhvro_torch_extract"),
}

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_loaded: dict = {}   # guarded-by: _locks[name]
_locks = {name: threading.Lock() for name in SOURCES}


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


def build_path(name: str) -> Path:
    """Where the build of ``SOURCES[name]`` lives: its name carries a hash
    of the source and its headers, the interpreter, the flags and
    :func:`cpu_tag`."""
    src = CSRC / SOURCES[name][0]
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key = hashlib.sha256()
    for path in source_files(src):
        key.update(path.name.encode() + b"\0" + path.read_bytes())
    key.update(f"{sys.version}|{include}|{CXX_FLAGS}|{NATIVE_FLAGS}|"
               f"{cpu_tag()}".encode())
    return BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}{suffix}"


def load(name: str) -> NativeModule:
    """Compile the source ``SOURCES[name]`` (once per content of it and
    its headers, interpreter and CPU) and import it. Raises
    ``RuntimeError`` when the build fails."""
    with _locks[name]:
        if name in _loaded:
            return _loaded[name]
        rel, module_name = SOURCES[name]
        src = CSRC / rel
        out = build_path(name)
        cxx = _cxx()
        include = sysconfig.get_paths()["include"]
        base = [cxx, *CXX_FLAGS, f"-I{include}", str(src), "-o"]
        cmd = [cxx, *NATIVE_FLAGS, *base[1:], str(out)]
        build_s = 0.0
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(cmd[:-1] + [str(tmp)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                # a compiler without -march=native (or refusing it here):
                # the generic flags, as the reference falls back
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
        spec = importlib.util.spec_from_file_location(module_name, out)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[name] = NativeModule(module, out, cmd, build_s)
        if build_s:
            from . import device_obs

            # carried by the first device launch that uses it
            device_obs.note_build(name, build_s)
        return _loaded[name]


def loaded(name: str) -> bool:
    """Is ``SOURCES[name]`` built and imported in this process? Never
    builds."""
    return name in _loaded


def load_packer() -> NativeModule:
    """The native record pack (``csrc/packer.cpp``)."""
    return load("packer")


def load_host_codec() -> NativeModule:
    """The host tier's decode/encode VM (``csrc/host/host_codec.cpp``)."""
    return load("host_codec")


def load_extract() -> NativeModule:
    """The host tier's Arrow-native extractor and fused encode
    (``csrc/host/extract.cpp``)."""
    return load("extract")
