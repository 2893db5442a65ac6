"""Build and load the port's native record pack (``csrc/packer.cpp``).

Modelled on ``ops/_build.py``: the source compiles at first use with the
host compiler (``g++ -O3 -shared -fPIC -std=c++17 -pthread`` and
Python's include directory) into a CPython extension under
``build/pyruhvro_tpu_torch/`` at the repository root. The file name is
keyed by a hash of the source, the interpreter and the command, so an
edited source or another interpreter rebuilds; the module loads through
``importlib`` from that path. A failed build raises: nothing falls back
to the Python join.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path

__all__ = ["load_packer", "NativeModule"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pyruhvro_tpu_torch"
MODULE = "_pyruhvro_torch_packer"   # PyInit_ name in csrc/packer.cpp
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_loaded = None  # guarded-by: _lock
_lock = threading.Lock()


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
        raise RuntimeError("g++ not found: the native record pack builds "
                           "with the host C++ compiler")
    return found


def load_packer() -> NativeModule:
    """Compile ``csrc/packer.cpp`` (once per content and interpreter) and
    import it. Raises ``RuntimeError`` when the build fails."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        src = CSRC / "packer.cpp"
        include = sysconfig.get_paths()["include"]
        suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        key = hashlib.sha256(src.read_bytes())
        key.update(f"{sys.version}|{include}|{CXX_FLAGS}".encode())
        out = BUILD_DIR / f"packer-{key.hexdigest()[:16]}{suffix}"
        cmd = [_cxx(), *CXX_FLAGS, f"-I{include}", str(src), "-o", str(out)]
        build_s = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(cmd[:-1] + [str(tmp)], capture_output=True,
                                  text=True)
            build_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}) on {src}:"
                                   f"\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        spec = importlib.util.spec_from_file_location(MODULE, out)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded = NativeModule(module, out, cmd, build_s)
        return _loaded
