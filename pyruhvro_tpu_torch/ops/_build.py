"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each source compiles on first use into a shared library with a plain C
interface under ``build/pyruhvro_tpu_torch/`` at the repository root
(file name keyed by the source's content hash, so an edited source
rebuilds), for ``sm_90a`` (Hopper). The library is loaded with ctypes:
every pointer and the CUDA stream pass as ``c_void_p``. The loaded
libraries' file sizes are the memory accounting's ``cache.kernels``
probe.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..runtime import memacct

__all__ = ["load_kernel_library", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pyruhvro_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}  # guarded-by: _lock
_source_locks: dict = {}  # guarded-by: _lock
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build with nvcc "
                       "on a machine with the CUDA toolkit")


class KernelLibrary:
    """A loaded kernel library plus how it was built."""

    def __init__(self, cdll: ctypes.CDLL, path: Path, build_s: float,
                 log: str):
        self.cdll = cdll
        self.path = path
        self.build_s = build_s   # 0.0 when an earlier build was reused
        self.log = log           # nvcc's output (ptxas register counts)


def load_kernel_library(source: str) -> KernelLibrary:
    """Compile ``csrc/<source>`` (once per content) and load it. Builds of
    different sources may run at once, each in its own thread."""
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        source_lock = _source_locks.setdefault(source, threading.Lock())
    with source_lock:
        with _lock:
            lib = _libs.get(source)
        if lib is not None:
            return lib
        src = CSRC / source
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"{src.stem}-{digest}.so"
        build_s, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_s = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {src}:\n{log}"
                )
            os.replace(tmp, out)
        lib = KernelLibrary(ctypes.CDLL(str(out)), out, build_s, log)
        with _lock:
            _libs[source] = lib
        if build_s:
            from ..runtime import device_obs

            # carried by the first launch that uses it (device.compile_s)
            device_obs.note_build(source, build_s)
        return lib


def _kernels_probe():
    """The ``cache.kernels`` plane of the memory accounting: the loaded
    libraries' ``.so`` file sizes. They are shared by every schema and
    never evicted."""
    with _lock:
        libs = list(_libs.values())
    return {"bytes": float(sum(lib.path.stat().st_size for lib in libs)),
            "items": float(len(libs))}


memacct.register_probe("cache.kernels", _kernels_probe)
