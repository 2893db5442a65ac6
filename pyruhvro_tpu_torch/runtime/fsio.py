"""Crash-safe JSON writes: write to a temporary file, then rename (copy of
``pyruhvro_tpu/runtime/fsio.py``).

The routing profile is read by a later process; a process killed in the
middle of ``json.dump`` must never leave a torn file behind.
:func:`atomic_write_json` writes ``<path>.tmp<pid>`` and ``os.replace``\\ s
it into place, so a reader sees the old whole file or the new one.
"""

from __future__ import annotations

import json
import os
from typing import Any

__all__ = ["atomic_write_json"]


def atomic_write_json(path: str, doc: Any, *, indent: int = 1,
                      sort_keys: bool = False, default=str) -> str:
    """Serialize ``doc`` to ``path`` atomically; returns ``path``.
    Raises ``OSError``/``ValueError`` like a plain write would — the
    caller decides whether persistence failure is fatal. The temp file
    is cleaned up on failure."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=indent, sort_keys=sort_keys,
                      default=default)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path
