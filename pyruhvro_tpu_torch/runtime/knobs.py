"""Environment knobs the port reads (copy of the parse rules of
``pyruhvro_tpu/runtime/knobs.py:396-437`` ``get_int``/``get_float``/
``get_bool``, and of the knobs it registers at ``:146-150``, ``:162-167``
and ``:175``, with their defaults).

A knob is read at each call, so setting a variable between calls takes
effect. Unset or empty gives the default; a value that does not parse
gives the default too (the reference also counts it in its metrics,
which the port does not have).
"""

from __future__ import annotations

import os

__all__ = ["get_bool", "get_int", "get_float", "DEFAULTS"]

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")

DEFAULTS = {
    # the double-buffered h2d/compute overlap on device decodes
    "PYRUHVRO_TPU_OVERLAP": True,
    # the fewest rows of one overlap chunk
    "PYRUHVRO_TPU_OVERLAP_ROWS": 4096,
    # hostile-input ceiling: a longer datum is rejected before decode
    # work (0 = unlimited)
    "PYRUHVRO_TPU_MAX_DATUM_BYTES": 0,
    # the host oracle's nesting-depth cap (enforced at schema compile)
    "PYRUHVRO_TPU_MAX_DEPTH": 64,
    # process-wide default per-call deadline in seconds (None = unbounded)
    "PYRUHVRO_TPU_DEADLINE_S": None,
}


def get_bool(name: str) -> bool:
    """1/true/yes/on → True, 0/false/no/off → False (any case); unset,
    empty or anything else → the default."""
    raw = os.environ.get(name, "").strip().lower()
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    return DEFAULTS[name]


def _number(name: str, cast):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return DEFAULTS[name]
    try:
        return cast(raw)
    except ValueError:
        return DEFAULTS[name]


def get_int(name: str) -> int:
    """The integer value; unset, empty or malformed → the default."""
    return _number(name, int)


def get_float(name: str):
    """The float value; unset, empty or malformed → the default."""
    return _number(name, float)
