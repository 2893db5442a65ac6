"""Environment knobs the port reads (copy of the parse rules of
``pyruhvro_tpu/runtime/knobs.py:396-437`` ``get_int``/``get_float``/
``get_bool``, ``get_tristate``, ``get_str``, ``get_raw``, ``is_set`` and
``get_enum`` and ``registry``, and of the knobs it registers at
``:82-100``, ``:146-150``, ``:153-159``, ``:162-167``, ``:170-183``,
``:189-207``, ``:208``, ``:211``, ``:215-219``, ``:220-237``,
``:240-257``, ``:260-266``, ``:271``, ``:275-281``, ``:287-293`` and
``:297-330``, the specialiser's at ``:111-118``, and the
superoptimizer's, the checked writer's and the sanitizer flavours' at
``:131-143`` and ``:283-286``, and ``PYRUHVRO_TPU_PALLAS`` (``:103``),
``PYRUHVRO_TPU_SHARD_THREADS`` (``:125``) and
``PYRUHVRO_TPU_QUARANTINE_STORM`` (``:184``), with their defaults), and
``render_text_table`` / ``render_markdown_table`` for the CLI's ``knobs``
command.

One default departs: ``PYRUHVRO_TPU_ROUTING_PROFILE`` is
``ROUTING_PROFILE.torch.json``, so that the port and the reference, whose
tests share one checkout, never read each other's routing profile.

A knob is read at each call, so setting a variable between calls takes
effect. Unset or empty gives the default; a value that does not parse
gives the default too, and counts ``knob.parse_error`` and
``knob.parse_error.<NAME>`` (deferred, as in the reference: read them
through ``metrics.snapshot()``).
"""

from __future__ import annotations

import os
from typing import Dict

from . import metrics

__all__ = ["get_bool", "get_tristate", "get_int", "get_float", "get_str",
           "get_raw", "get_enum", "is_set", "registry", "DEFAULTS",
           "CHOICES", "ALIASES", "render_text_table",
           "render_markdown_table"]

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
    # the host tier: the pure-Python oracle instead of the C++ VM
    "PYRUHVRO_TPU_NO_NATIVE": False,
    # spans and histograms off from the start (counters stay on)
    "PYRUHVRO_TPU_NO_TELEMETRY": False,
    # the JSON-lines span trace: a file path or "stderr"
    "PYRUHVRO_TPU_TRACE": "",
    # the W3C traceparent that root spans with no other context join
    "PYRUHVRO_TPU_TRACEPARENT": "",
    # launch timing by CUDA events: unset times them, 1 also waits on each
    # launch's end (the deep path's sync mode), 0 records none
    "PYRUHVRO_TPU_DEVICE_SYNC": None,
    # the window, in seconds, of the per-schema recompile-churn guard
    "PYRUHVRO_TPU_RECOMPILE_WINDOW": 60.0,
    # first launches of new buckets within the window that make a storm
    "PYRUHVRO_TPU_RECOMPILE_STORM": 8,
    # backend="auto": the card serves batches of at least n rows, the host
    # tier the smaller ones (replaces the static gate's other signals)
    "PYRUHVRO_TPU_DEVICE_MIN_ROWS": None,
    # the chunk fan-out of host-tier chunked calls: thread or process
    "PYRUHVRO_TPU_POOL": "thread",
    # backend="auto" picks its arm from the learned cost model
    "PYRUHVRO_TPU_AUTOTUNE": False,
    # the share of autotuned calls that try the least-observed arm
    "PYRUHVRO_TPU_EXPLORE": 0.05,
    # where routing knowledge persists ("" set: no persistence)
    "PYRUHVRO_TPU_ROUTING_PROFILE": "ROUTING_PROFILE.torch.json",
    # entries of the routing decision ledger kept
    "PYRUHVRO_TPU_LEDGER_N": 256,
    # the row-padded walk (K4) for eligible schemas: 1/true/mosaic; the
    # reference's interpret has no counterpart, and anything else is off
    "PYRUHVRO_TPU_PALLAS": "off",
    # failures that open a circuit breaker (overrides each one's default)
    "PYRUHVRO_TPU_BREAKER_THRESHOLD": None,
    # the breakers' base backoff in seconds (overrides the default)
    "PYRUHVRO_TPU_BREAKER_BACKOFF": None,
    # quarantined rows of one call that count as a storm
    "PYRUHVRO_TPU_QUARANTINE_STORM": 100,
    # the fast/slow EWMA ratio that counts as latency drift
    "PYRUHVRO_TPU_DRIFT_RATIO": 1.5,
    # drifted observations in a row before a detection fires
    "PYRUHVRO_TPU_DRIFT_SUSTAIN": 5,
    # persist the capacity planner's plans in the routing profile even
    # without autotune
    "PYRUHVRO_TPU_CAPACITY_PERSIST": False,
    # deterministic fault injection: site:kind:rate[:seed][,...]
    "PYRUHVRO_TPU_FAULTS": "",
    # the sleep of the "hang" fault kind, in seconds
    "PYRUHVRO_TPU_FAULT_HANG_S": 2.0,
    # the interleaving harness: the default schedule seed, the seeds a
    # sweep runs per window, and the yield points that take part
    "PYRUHVRO_TPU_SCHED_SEED": None,
    "PYRUHVRO_TPU_SCHED_SEEDS": 20,
    "PYRUHVRO_TPU_SCHED_POINTS": "",
    # the native host modules' per-opcode-profiled build (vm.op.* keys)
    "PYRUHVRO_TPU_NATIVE_PROF": False,
    # the native shard runner's worker cap (0 = auto: the hardware's
    # threads, at most 16); read by csrc/host/shard_runner.h itself
    "PYRUHVRO_TPU_SHARD_THREADS": 0,
    # the host modules' ASan+UBSan and ThreadSanitizer builds (ASan wins
    # when both are set; run Python under the runtime's preload)
    "PYRUHVRO_TPU_NATIVE_SAN": False,
    "PYRUHVRO_TPU_TSAN": False,
    # the host tier's superoptimizer off: the VM runs the raw program
    "PYRUHVRO_TPU_NO_OPT": False,
    # the native encoders check every write against the extractor's bound
    "PYRUHVRO_DEBUG_BOUNDS": False,
    # the deep sampler's share of wall time (<= 0 turns it off)
    "PYRUHVRO_TPU_SAMPLE_BUDGET": 0.01,
    # the JSON file of latency and error objectives for the SLO engine
    "PYRUHVRO_TPU_SLO_FILE": "",
    # the flight recorder: the auto-dump directory (also arms SIGUSR1
    # and SIGUSR2), the ring's size and the dumps kept (0 = no limit)
    "PYRUHVRO_TPU_FLIGHT_DIR": "",
    "PYRUHVRO_TPU_FLIGHT_N": 64,
    "PYRUHVRO_TPU_FLIGHT_MAX_FILES": 32,
    # the obs server: its port at import (0 = any free port; unset: no
    # server), its bind host, and how long a storm, drift or audit
    # mismatch keeps /healthz unhealthy, in seconds
    "PYRUHVRO_TPU_OBS_PORT": None,
    "PYRUHVRO_TPU_OBS_HOST": "127.0.0.1",
    "PYRUHVRO_TPU_HEALTH_WINDOW": 60.0,
    # the differential audit: its share of wall time (<= 0 turns it
    # off), the tiers it shadows (comma list; empty: every tier), and
    # its kill switch
    "PYRUHVRO_TPU_AUDIT_BUDGET": 0.005,
    "PYRUHVRO_TPU_AUDIT_TIERS": "",
    "PYRUHVRO_TPU_NO_AUDIT": False,
    # the timeline: its tick interval in seconds (floored at 0.05), the
    # ticks it keeps, and its kill switch
    "PYRUHVRO_TPU_TIMELINE_INTERVAL_S": 10.0,
    "PYRUHVRO_TPU_TIMELINE_RETENTION": 360,
    "PYRUHVRO_TPU_NO_TIMELINE": False,
    # incident bundles: their directory ("" turns capture off) and the
    # bundles kept (0 = no limit; hand-saved files are never touched)
    "PYRUHVRO_TPU_INCIDENT_DIR": "",
    "PYRUHVRO_TPU_INCIDENT_MAX_FILES": 16,
    # the OTLP/HTTP exporter: the collector's base URL ("" turns it off)
    # and its flush interval in seconds
    "PYRUHVRO_TPU_OTLP_ENDPOINT": "",
    "PYRUHVRO_TPU_OTLP_INTERVAL_S": 5.0,
    # memory accounting and the cache lifecycle: the RSS high water in
    # bytes (0 = off), the idle TTL of cache entries in seconds (0 = no
    # TTL), the schema cache's and the launch-state registry's entry
    # caps (0 = no limit) and the tenant sketch's size
    "PYRUHVRO_TPU_MEM_HIGH_WATER": 0,
    "PYRUHVRO_TPU_CACHE_TTL_S": 0.0,
    "PYRUHVRO_TPU_CACHE_MAX_SCHEMAS": 4096,
    "PYRUHVRO_TPU_CACHE_MAX_EXECUTABLES": 1024,
    "PYRUHVRO_TPU_MEM_TOPK": 64,
    # the host tier's specialiser: the cumulative rows after which a
    # schema's program is unrolled into C++ (0 = at once), its kill
    # switch, and the engines plane's entry cap (0 = no limit)
    "PYRUHVRO_TPU_SPECIALIZE_ROWS": 20_000,
    "PYRUHVRO_TPU_NO_SPECIALIZE": False,
    "PYRUHVRO_TPU_CACHE_MAX_ENGINES": 256,
    # the serving plane: a queue's depth in requests, the policy on a
    # full queue (block or shed), its worker threads, a coalesced
    # batch's row cap, the coalescing window in seconds, the block
    # policy's longest wait for space, a coalesced batch's stall
    # watchdog in seconds, one tenant's share of the queued requests
    # past half full (<= 0 off), the queue pressure at which the
    # brownout ladder starts (> 1 off) and the evaluations over it
    # before a rung engages
    "PYRUHVRO_TPU_SERVE_QUEUE": 256,
    "PYRUHVRO_TPU_SERVE_POLICY": "block",
    "PYRUHVRO_TPU_SERVE_WORKERS": 2,
    "PYRUHVRO_TPU_SERVE_MAX_BATCH_ROWS": 32768,
    "PYRUHVRO_TPU_SERVE_COALESCE_S": 0.002,
    "PYRUHVRO_TPU_SERVE_ENQUEUE_WAIT_S": 1.0,
    "PYRUHVRO_TPU_SERVE_BATCH_TIMEOUT_S": 30.0,
    "PYRUHVRO_TPU_SERVE_TENANT_SHARE": 0.5,
    "PYRUHVRO_TPU_SERVE_BROWNOUT": 0.7,
    "PYRUHVRO_TPU_SERVE_BROWNOUT_SUSTAIN": 3,
}

# the accepted (lower-case) values of the enum knobs
CHOICES = {
    "PYRUHVRO_TPU_POOL": ("thread", "process"),
    "PYRUHVRO_TPU_SERVE_POLICY": ("block", "shed"),
    "PYRUHVRO_TPU_PALLAS": ("off", "mosaic", "interpret"),
}

# spellings an enum knob folds onto one of its choices before the check
# (the reference's ``ops/codec.py:_pallas_mode`` folding)
ALIASES = {
    "PYRUHVRO_TPU_PALLAS": {"1": "mosaic", "true": "mosaic", "0": "off",
                            "false": "off"},
}

# parse errors count through DeferredCounts, as in the reference
# lock-free-ok(setdefault is GIL-atomic and DeferredCount absorbs racing bumps)
_parse_error_counts: Dict[str, metrics.DeferredCount] = {}


def _parse_error(name: str) -> None:
    for key in ("knob.parse_error", "knob.parse_error." + name):
        dc = _parse_error_counts.get(key)
        if dc is None:
            dc = _parse_error_counts.setdefault(
                key, metrics.DeferredCount(key))
        dc.bump()


def _flush_parse_errors() -> None:
    for dc in list(_parse_error_counts.values()):
        dc.flush()


metrics.register_flush_hook(_flush_parse_errors)


def registry() -> Dict[str, object]:
    """A copy of the registered knobs, name → default, in registration
    order (the reference's ``registry()`` maps each name to its typed
    ``Knob``; the incident bundle reads only the names)."""
    return dict(DEFAULTS)


def _boolish(name: str):
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return DEFAULTS[name]
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    _parse_error(name)
    return DEFAULTS[name]


def get_bool(name: str) -> bool:
    """1/true/yes/on → True, 0/false/no/off → False (any case); unset,
    empty or anything else → the default."""
    return _boolish(name)


def get_tristate(name: str):
    """True / False / None (the default: auto), in :func:`get_bool`'s
    vocabulary."""
    return _boolish(name)


def get_str(name: str) -> str:
    """The raw value, or the default when unset or empty."""
    return os.environ.get(name, "") or DEFAULTS[name]


def get_raw(name: str) -> str:
    """The raw value of a registered knob (``""`` when unset)."""
    assert name in DEFAULTS, f"unregistered knob {name}"
    return os.environ.get(name, "")


def is_set(name: str) -> bool:
    """Is the knob in the environment at all (even empty)? For knobs whose
    set-but-empty value differs from unset
    (``PYRUHVRO_TPU_ROUTING_PROFILE``: empty turns persistence off)."""
    assert name in DEFAULTS, f"unregistered knob {name}"
    return name in os.environ


def get_enum(name: str) -> str:
    """The lower-cased value, its alias folded (:data:`ALIASES`), when it
    is one of the knob's choices; unset or empty gives the default,
    anything else the default and a parse error."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return DEFAULTS[name]
    raw = ALIASES.get(name, {}).get(raw, raw)
    if raw in CHOICES[name]:
        return raw
    _parse_error(name)
    return DEFAULTS[name]


def _number(name: str, cast):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return DEFAULTS[name]
    try:
        return cast(raw)
    except ValueError:
        _parse_error(name)
        return DEFAULTS[name]


def get_int(name: str) -> int:
    """The integer value; unset, empty or malformed → the default."""
    return _number(name, int)


def get_float(name: str):
    """The float value; unset, empty or malformed → the default."""
    return _number(name, float)


def _type_of(name: str) -> str:
    if name in CHOICES:
        return "enum"
    default = DEFAULTS[name]
    if default is None:
        return "unset"
    return type(default).__name__


def _default_label(name: str) -> str:
    default = DEFAULTS[name]
    if default is None:
        return "(unset)"
    if default == "":
        return '""'
    return str(default)


def render_text_table() -> str:
    """The registry for ``python -m pyruhvro_tpu_torch.telemetry knobs``:
    one line a knob, with its type, its default and, when set, its
    value."""
    out = []
    for name in DEFAULTS:
        line = f"{name}  [{_type_of(name)}, default {_default_label(name)}]"
        raw = os.environ.get(name)
        if raw is not None:
            line += f"  (set: {raw!r})"
        if name in CHOICES:
            line += "  choices: " + "/".join(CHOICES[name])
        out.append(line)
    return "\n".join(out) + "\n"


def render_markdown_table() -> str:
    """The same registry as a markdown table (``knobs --markdown``)."""
    lines = ["| knob | type | default |", "|---|---|---|"]
    for name in DEFAULTS:
        lines.append(f"| `{name}` | {_type_of(name)} | "
                     f"`{_default_label(name)}` |")
    return "\n".join(lines) + "\n"
