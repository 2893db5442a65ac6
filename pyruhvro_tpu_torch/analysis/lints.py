"""AST invariant lints over the port's source (copy of
``pyruhvro_tpu/analysis/lints.py``).

Four rules, each a machine check of an invariant of the package:

* ``lint.env-read`` — no direct ``os.environ`` / ``os.getenv`` read of
  a ``PYRUHVRO_*`` name outside ``runtime/knobs.py``: every knob goes
  through the typed registry (parse-with-fallback, documented,
  inventoried).
* ``lint.signal-safety`` — no ``metrics.inc``/``merge``/``mark``,
  ``faults.fire``, ``schedtest.yield_point``/``yp`` (a
  yield-point under an active harness parks the thread on a condition
  variable), blocking ``.acquire()`` or ``with <lock>:`` in code
  reachable (same-module call graph) from a function registered via
  ``signal.signal``: the handler may have interrupted the very frame
  that holds the non-reentrant lock. Counters bumped from signal
  context must use ``metrics.DeferredCount``. An audited construct can
  be waived with a ``# signal-ok: <reason>`` comment on the flagged
  line.
* ``lint.json-write`` — no whole-file ``json.dump`` outside
  ``runtime/fsio.py`` (a kill mid-dump leaves a torn artifact; writers
  go through ``fsio.atomic_write_json``). Dumping to
  ``sys.stdout``/``sys.stderr`` is a stream, not a file, and passes.
* ``lint.fault-seam`` — no bare ``except:`` anywhere, and every
  handler that swallows ``FaultInjected`` (the 12 chaos seams of
  ``runtime/faults.py``) must count a metric: a degradation that does
  not count is a degradation nobody will ever see.
* ``lint.metric-keys`` — the telemetry key contract: every
  statically-extracted counter/gauge/mark/span key (plus the C++
  profiler drain keys) must appear in the generated registry table,
  and every key-shaped token in the prose must name a key the code
  still emits (no dead documentation).

The analysis is deliberately path-INsensitive (a ``metrics.inc`` behind
``if counters:`` still flags) — that keeps it trivially sound, and the
``# signal-ok`` waiver documents the audited exceptions in place.

Departures from the reference: the file walk is sorted, so the
generated table is the same on every file system; every path is the
port's
(``pyruhvro_tpu_torch/``, its ``runtime/knobs.py`` and ``runtime/fsio.py``,
the drain keys of ``csrc/host/host_vm_core.h``); the json-write rule
also covers the port's scripts, ``scripts/torch_*.py``; the key
extractor also knows the port's span producer ``telemetry.open_span``
and a conditional of two literal keys (``"a" if hit else "b"``); and the
key contract reads the port's tables from ``pyruhvro_tpu_torch/REGISTRY.md``
(between ``<!-- torch-metric-keys:start/end -->``) and its prose from
that file outside its generated blocks and from README's port section
(between ``<!-- torch-port:start/end -->``). The rest of README is the
reference's and is neither read nor written here.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set

from . import Finding

__all__ = [
    "lint_env_reads",
    "lint_signal_safety",
    "lint_json_writes",
    "lint_fault_seams",
    "metric_key_registry",
    "render_metric_key_table",
    "lint_metric_keys",
    "port_section",
    "run_lints",
    "iter_py_files",
]

_KNOB_PREFIX = "PYRUHVRO_"
_PKG = "pyruhvro_tpu_torch"
_ENV_ALLOWED = (_PKG + "/runtime/knobs.py",)
_JSON_ALLOWED = (_PKG + "/runtime/fsio.py",)
_SIGNAL_WAIVER = "# signal-ok"

# calls that may take the non-reentrant metrics/telemetry locks —
# forbidden in signal-reachable code (DeferredCount.bump is the
# sanctioned counter there). schedtest yield-points park
# the calling thread on a condition variable under an active harness,
# and faults.fire can sleep at a seam — a handler that reaches either
# can wedge the very frame it interrupted.
_UNSAFE_MODULE_CALLS = {
    ("metrics", "inc"), ("metrics", "merge"), ("metrics", "mark"),
    ("faults", "fire"),
    ("schedtest", "yield_point"), ("schedtest", "yp"),
}


def iter_py_files(root: str,
                  subdirs: Sequence[str] = (_PKG,)) -> List[str]:
    out = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        if os.path.isfile(base):
            out.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            # sorted: the walk's order is the file system's, and the
            # registry table lists each key's first sources in it
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("_spec", "__pycache__"))
            out.extend(os.path.join(dirpath, f)
                       for f in sorted(filenames) if f.endswith(".py"))
    return out


def _rel(path: str, root: str) -> str:
    try:
        return os.path.relpath(path, root)
    except ValueError:
        return path


def _parse(path: str):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return ast.parse(src, filename=path), src.splitlines()


# ---------------------------------------------------------------------------
# lint.env-read
# ---------------------------------------------------------------------------


def _env_read_name(node: ast.AST) -> Optional[str]:
    """The literal env-var name when ``node`` reads the environment:
    ``os.environ.get(LIT, ...)``, ``os.getenv(LIT, ...)`` or
    ``os.environ[LIT]`` (Load context)."""
    if isinstance(node, ast.Call):
        f = node.func
        is_get = (isinstance(f, ast.Attribute) and f.attr == "get"
                  and isinstance(f.value, ast.Attribute)
                  and f.value.attr == "environ"
                  and isinstance(f.value.value, ast.Name)
                  and f.value.value.id == "os")
        is_getenv = (isinstance(f, ast.Attribute) and f.attr == "getenv"
                     and isinstance(f.value, ast.Name)
                     and f.value.id == "os")
        if (is_get or is_getenv) and node.args:
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return a.value
    elif isinstance(node, ast.Subscript):
        v = node.value
        if (isinstance(node.ctx, ast.Load)
                and isinstance(v, ast.Attribute) and v.attr == "environ"
                and isinstance(v.value, ast.Name) and v.value.id == "os"):
            s = node.slice
            if isinstance(s, ast.Constant) and isinstance(s.value, str):
                return s.value
    elif isinstance(node, ast.Compare):
        # '"NAME" in os.environ' membership tests read the environment
        # too (knobs.is_set is the sanctioned form)
        if (len(node.ops) == 1
                and isinstance(node.ops[0], (ast.In, ast.NotIn))
                and isinstance(node.left, ast.Constant)
                and isinstance(node.left.value, str)
                and len(node.comparators) == 1):
            c = node.comparators[0]
            if (isinstance(c, ast.Attribute) and c.attr == "environ"
                    and isinstance(c.value, ast.Name)
                    and c.value.id == "os"):
                return node.left.value
    return None


def lint_env_reads(files: Iterable[str], root: str = ".") -> List[Finding]:
    findings = []
    for path in files:
        rel = _rel(path, root)
        if rel.replace(os.sep, "/").endswith(_ENV_ALLOWED):
            continue
        tree, _ = _parse(path)
        for node in ast.walk(tree):
            name = _env_read_name(node)
            if name and name.startswith(_KNOB_PREFIX):
                findings.append(Finding(
                    "lint.env-read", rel,
                    f"direct environment read of {name!r} — go through "
                    "runtime/knobs.py (registered knob, counted parse "
                    "fallback)", node.lineno))
    return findings


# ---------------------------------------------------------------------------
# lint.signal-safety
# ---------------------------------------------------------------------------


def _collect_functions(tree: ast.AST) -> Dict[str, ast.FunctionDef]:
    """All function defs in the module, flattened by name (nested
    handlers included; later defs win, like runtime rebinding would)."""
    out: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


def _called_names(fn: ast.FunctionDef) -> Set[str]:
    """Plain ``name(...)`` calls inside ``fn`` (same-module call graph
    edges; attribute calls are cross-module and judged directly)."""
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            names.add(node.func.id)
    return names


def _handler_names(tree: ast.AST) -> Set[str]:
    """Functions registered via ``signal.signal(<sig>, <fn>)``."""
    out = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "signal"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "signal"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Name)):
            out.add(node.args[1].id)
    return out


def _waived(lines: List[str], lineno: int) -> bool:
    """A ``# signal-ok: <reason>`` waiver on the flagged line or in the
    comment block immediately above it."""
    for ln in range(max(1, lineno - 2), min(lineno, len(lines)) + 1):
        if _SIGNAL_WAIVER in lines[ln - 1]:
            return True
    return False


def _unsafe_in_function(fn: ast.FunctionDef, rel: str,
                        lines: List[str]) -> List[Finding]:
    findings = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and (f.value.id, f.attr) in _UNSAFE_MODULE_CALLS):
                if not _waived(lines, node.lineno):
                    findings.append(Finding(
                        "lint.signal-safety", rel,
                        f"{f.value.id}.{f.attr}() reachable from a "
                        "signal handler may deadlock on the "
                        "non-reentrant lock — defer via "
                        "metrics.DeferredCount (or waive with "
                        "'# signal-ok: <reason>' after an audit)",
                        node.lineno))
            elif isinstance(f, ast.Attribute) and f.attr == "acquire":
                blocking = None
                for kw in node.keywords:
                    if kw.arg == "blocking":
                        blocking = kw.value
                ok = blocking is not None and not (
                    isinstance(blocking, ast.Constant)
                    and blocking.value is True)
                if not ok and not _waived(lines, node.lineno):
                    findings.append(Finding(
                        "lint.signal-safety", rel,
                        "blocking .acquire() reachable from a signal "
                        "handler (pass blocking=False / a caller-"
                        "controlled flag, or waive with '# signal-ok')",
                        node.lineno))
        elif isinstance(node, ast.With):
            for item in node.items:
                ctx = item.context_expr
                nm = (ctx.id if isinstance(ctx, ast.Name)
                      else ctx.attr if isinstance(ctx, ast.Attribute)
                      else "")
                if "lock" in nm.lower() and not _waived(lines,
                                                        node.lineno):
                    findings.append(Finding(
                        "lint.signal-safety", rel,
                        f"'with {nm}:' reachable from a signal handler "
                        "may deadlock on the non-reentrant lock",
                        node.lineno))
    return findings


def lint_signal_safety(files: Iterable[str],
                       root: str = ".") -> List[Finding]:
    findings = []
    for path in files:
        rel = _rel(path, root)
        tree, lines = _parse(path)
        handlers = _handler_names(tree)
        if not handlers:
            continue
        fns = _collect_functions(tree)
        # BFS over the same-module call graph from each handler
        reachable: Set[str] = set()
        frontier = [h for h in handlers if h in fns]
        while frontier:
            name = frontier.pop()
            if name in reachable:
                continue
            reachable.add(name)
            frontier.extend(n for n in _called_names(fns[name])
                            if n in fns and n not in reachable)
        for name in sorted(reachable):
            findings.extend(_unsafe_in_function(fns[name], rel, lines))
    return findings


# ---------------------------------------------------------------------------
# lint.json-write
# ---------------------------------------------------------------------------


def _is_std_stream(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and node.attr in ("stdout", "stderr")
            and isinstance(node.value, ast.Name)
            and node.value.id == "sys")


def lint_json_writes(files: Iterable[str], root: str = ".") -> List[Finding]:
    findings = []
    for path in files:
        rel = _rel(path, root)
        if rel.replace(os.sep, "/").endswith(_JSON_ALLOWED):
            continue
        tree, _ = _parse(path)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "dump"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "json"):
                continue
            if len(node.args) >= 2 and _is_std_stream(node.args[1]):
                continue
            findings.append(Finding(
                "lint.json-write", rel,
                "whole-file json.dump outside runtime/fsio.py — a kill "
                "mid-dump leaves a torn artifact; use "
                "fsio.atomic_write_json", node.lineno))
    return findings


# ---------------------------------------------------------------------------
# lint.fault-seam
# ---------------------------------------------------------------------------


def _catches_fault_injected(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    types = t.elts if isinstance(t, ast.Tuple) else [t] if t else []
    for e in types:
        if isinstance(e, ast.Name) and e.id == "FaultInjected":
            return True
        if isinstance(e, ast.Attribute) and e.attr == "FaultInjected":
            return True
    return False


def _body_counts_metric(handler: ast.ExceptHandler) -> bool:
    """Does the handler body count its degradation? ``metrics.inc`` /
    ``metrics.merge``, a ``DeferredCount.bump``, or a breaker
    ``record_failure`` (the breaker exports its state to telemetry)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            f = node.func
            if (isinstance(f.value, ast.Name) and f.value.id == "metrics"
                    and f.attr in ("inc", "merge")):
                return True
            if f.attr in ("bump", "record_failure"):
                return True
    return False


def _body_reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def lint_fault_seams(files: Iterable[str], root: str = ".") -> List[Finding]:
    findings = []
    for path in files:
        rel = _rel(path, root)
        tree, _ = _parse(path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(Finding(
                    "lint.fault-seam", rel,
                    "bare 'except:' swallows everything including "
                    "KeyboardInterrupt — name the exceptions",
                    node.lineno))
                continue
            if (_catches_fault_injected(node)
                    and not _body_reraises(node)
                    and not _body_counts_metric(node)):
                findings.append(Finding(
                    "lint.fault-seam", rel,
                    "handler swallows FaultInjected without counting a "
                    "metric — a degradation that does not count is one "
                    "nobody will ever see", node.lineno))
    return findings


# ---------------------------------------------------------------------------
# lint.metric-keys: the telemetry key contract
# ---------------------------------------------------------------------------
#
# Every counter/gauge/mark/span key the package emits is statically
# extracted — ``metrics.inc/observe/set_gauge/mark/timer`` and
# ``telemetry.phase/root_span`` first-argument literals (f-string and
# ``"lit" + expr`` call sites register as dotted PREFIXES), plus the
# C++ native-profiler drain keys (``kDomPrefix`` x ``kSlotName`` and
# their ``_s`` self-time twins, parsed with the contract
# parsers). The registry renders as a generated README table between
# the ``<!-- metric-keys:start/end -->`` markers (the knob-table
# pattern: docs generated from code cannot drift) and the gate fails
# both directions: a key emitted but missing from the committed table
# (undocumented), and a key-shaped token in README prose that matches
# no emitted key (dead documentation).

_METRIC_PRODUCERS = {
    ("metrics", "inc"): "counter",
    ("metrics", "observe"): "histogram",
    ("metrics", "set_gauge"): "gauge",
    ("metrics", "mark"): "event",
    ("metrics", "timer"): "seconds",
    ("telemetry", "phase"): "span",
    ("telemetry", "root_span"): "span",
    ("telemetry", "observe"): "span",
    ("telemetry", "observe_value"): "histogram",
    # the port's device spans (runtime/device_obs.py)
    ("telemetry", "open_span"): "span",
    # memory-plane probe names become the mem.<plane>.* gauge namespace
    ("memacct", "register_probe"): "plane",
}

# Dynamically-built keys (f-strings with no literal head, name+suffix
# concatenations, relay loops) declare themselves in place with an
# audited ``# metric-key: <key-pattern>`` comment on or just above the
# producing line — the same in-place-waiver idiom as ``# signal-ok`` /
# ``# blocking-ok``. ``<seg>`` / ``*`` are wildcards.
_KEY_DECL = re.compile(r"#\s*metric-key:\s*(\S+)")

_KEY_TABLE_START = "<!-- torch-metric-keys:start -->"
_KEY_TABLE_END = "<!-- torch-metric-keys:end -->"
_KNOB_TABLE_START = "<!-- torch-knob-table:start -->"
_KNOB_TABLE_END = "<!-- torch-knob-table:end -->"
_PORT_START = "<!-- torch-port:start -->"
_PORT_END = "<!-- torch-port:end -->"
# the port's generated tables, beside its package
REGISTRY_DOC = _PKG + "/REGISTRY.md"


def _key_literals(node: ast.Call):
    """[(key, is_prefix)] of a producer call's first argument: both keys
    of ``"a" if c else "b"``, else :func:`_key_literal`'s one."""
    a = node.args[0] if node.args else None
    if isinstance(a, ast.IfExp) and all(
            isinstance(b, ast.Constant) and isinstance(b.value, str)
            for b in (a.body, a.orelse)):
        return [(a.body.value, False), (a.orelse.value, False)]
    return [_key_literal(node)]


def _key_literal(node: ast.Call):
    """(key, is_prefix) of a producer call's first argument: a constant
    string, the leading constant of an f-string, or the left constant
    of ``"lit" + expr`` — else (None, False) for fully dynamic relays
    (the keys they forward come from literal sites elsewhere)."""
    if not node.args:
        return None, False
    a = node.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, False
    if isinstance(a, ast.JoinedStr) and a.values:
        head = a.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value, True
        return None, False
    if isinstance(a, ast.BinOp) and isinstance(a.op, ast.Add):
        left = a.left
        if isinstance(left, ast.Constant) and isinstance(left.value, str):
            return left.value, True
    return None, False


def metric_key_registry(root: str) -> Dict[str, dict]:
    """key -> {kind, prefix, sources} over the port's package tree plus
    the native profiler's drain-key tables."""
    registry: Dict[str, dict] = {}

    def add(key, kind, src, prefix=False):
        rec = registry.setdefault(key, {"kind": kind, "prefix": prefix,
                                        "sources": []})
        if src not in rec["sources"]:
            rec["sources"].append(src)
        rec["prefix"] = rec["prefix"] or prefix

    for path in iter_py_files(root, (_PKG,)):
        rel = _rel(path, root).replace(os.sep, "/")
        if rel.startswith(_PKG + "/analysis/"):
            continue  # the analyzers' own sources hold example patterns
        tree, lines = _parse(path)
        for ln in lines:
            dm = _KEY_DECL.search(ln)
            if dm:
                add(dm.group(1), "declared", rel,
                    prefix=dm.group(1).endswith("."))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)):
                continue
            kind = _METRIC_PRODUCERS.get(
                (node.func.value.id, node.func.attr))
            if kind is None:
                continue
            for key, prefix in _key_literals(node):
                if key is None:
                    continue
                k = kind
                if k in ("counter", "seconds") and key.endswith("_s"):
                    k = "seconds"
                add(key, k, rel, prefix)

    # the C++ drain keys (hostpath/codec.py feeds them to metrics.inc
    # verbatim, plus the "_s" self-time twin per key)
    from .contracts import parse_cpp_string_array

    rel = _PKG + "/csrc/host/host_vm_core.h"
    vm_core = os.path.join(root, rel)
    try:
        prefixes = parse_cpp_string_array(vm_core, "kDomPrefix")
        slots = parse_cpp_string_array(vm_core, "kSlotName")
    except OSError:  # fixture trees without the native core
        prefixes, slots = [], []
    for p in prefixes:
        for s in slots:
            add(p + s, "counter", rel)
            add(p + s + "_s", "seconds", rel)
    return registry


def render_metric_key_table(registry: Dict[str, dict]) -> str:
    """The generated registry block: the native drain families collapse
    to their ``<prefix>.<opcode>`` wildcard rows (16+ opcode keys per
    domain would drown the table), everything else is one row per key;
    trailing-dot prefixes render with a ``<...>`` placeholder."""
    from .contracts import parse_cpp_string_array  # noqa: F401 (doc)

    rows = []
    seen_fam = set()
    for key in sorted(registry):
        rec = registry[key]
        fam = None
        for dom in ("vm.op.", "vm.encop.", "extract.op."):
            if key.startswith(dom):
                fam = dom
        if fam is not None:
            if fam in seen_fam:
                continue
            seen_fam.add(fam)
            rows.append((f"`{fam}<opcode>[_s]`", "counter/seconds",
                         "native profiler drain (host_vm_core.h "
                         "kDomPrefix x kSlotName)"))
            continue
        shown = f"`{key}<...>`" if rec["prefix"] or key.endswith(".") \
            else f"`{key}`"
        rows.append((shown, rec["kind"],
                     ", ".join(s.rsplit("/", 1)[-1]
                               for s in rec["sources"][:3])))
    out = ["| key | kind | emitted by |", "| --- | --- | --- |"]
    out += [f"| {k} | {kind} | {src} |" for k, kind, src in rows]
    return "\n".join(out) + "\n"


def _doc_key_tokens(text: str, root: str = "."):
    """Key-shaped backtick tokens in the prose: dotted lowercase
    identifiers that are not file paths, module paths, or attribute
    references; ``<...>``/``[...]``/``*`` segments are documentation
    wildcards."""
    out = []
    for m in re.finditer(r"`([^`\n]+)`", text):
        tok = m.group(1)
        if "/" in tok or "(" in tok or " " in tok or "=" in tok:
            continue
        # segments start alphanumeric (or a wildcard): `pool._broken`
        # is an attribute reference, not a key
        if re.fullmatch(
                r"[a-z][a-z0-9_]*(\.[a-z0-9<*\[][a-z0-9_<>.*\[\]]*)+",
                tok):
            if tok.rsplit(".", 1)[-1] in ("py", "json", "md", "cpp",
                                          "h", "jsonl", "yml", "avsc"):
                continue
            # `fallback.decoder.decode_records`-style module/function
            # references: the leading segments name a package module
            segs = tok.split(".")
            if os.path.exists(os.path.join(
                    root, _PKG, segs[0], segs[1] + ".py")):
                continue
            out.append((tok, text[: m.start()].count("\n") + 1))
    return out


def _wild_rx(s: str):
    """Regex for a key with ``<seg>`` / ``[seg]`` / ``*`` wildcards
    (used by both documented tokens and ``# metric-key`` patterns)."""
    parts = re.split(r"(<[^>]*>|\[[^\]]*\]|\*)", s)
    return re.compile("^" + "".join(
        re.escape(p) if i % 2 == 0 else "[A-Za-z0-9_.-]+"
        for i, p in enumerate(parts)) + "$")


def _doc_token_matches(tok: str, registry: Dict[str, dict]) -> bool:
    """Does a documented token name at least one emitted key? Wildcard
    segments match anything on either side; a token that is a dotted
    family prefix of an emitted key (or extends an emitted trailing-dot
    prefix) also matches."""
    tok_rx = _wild_rx(tok)
    sample = re.sub(r"<[^>]*>|\[[^\]]*\]|\*", "x", tok)
    for key, rec in registry.items():
        if "<" in key or "*" in key or "[" in key:
            # a declared pattern: match pattern-vs-sample
            if _wild_rx(key).match(sample):
                return True
            continue
        if tok_rx.match(key):
            return True
        if rec["prefix"] and (sample.startswith(key)
                              or key.startswith(sample)):
            return True
        if key.startswith(tok + ".") or key.startswith(tok + "_"):
            # a documented family name ("slo.breach" covers
            # "slo.breach.<name>")
            return True
    return False


def _block(text: str, start: str, end: str):
    """The match of a generated block's body between its markers, or
    None."""
    return re.search(re.escape(start) + r"\n(.*?)" + re.escape(end), text,
                     flags=re.S)


def port_section(root: str):
    """``(text, first line)`` of README's port section, between
    ``<!-- torch-port:start/end -->``; None when README or a marker is
    missing."""
    try:
        with open(os.path.join(root, "README.md"), encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None
    a, b = text.find(_PORT_START), text.find(_PORT_END)
    if a < 0 or b < a:
        return None
    return text[a:b], text[:a].count("\n") + 1


def lint_metric_keys(root: str, fix: bool = False) -> List[Finding]:
    """Both directions of the key contract: the committed table of
    ``REGISTRY.md`` must equal the fresh registry rendering
    (``--fix-metric-keys`` rewrites it), and every key-shaped token in
    the prose (``REGISTRY.md`` outside its generated blocks, README's
    port section) must name an emitted key."""
    findings: List[Finding] = []
    registry = metric_key_registry(root)
    lint_metric_keys.last_registry = registry  # report material
    doc = os.path.join(root, REGISTRY_DOC)
    try:
        with open(doc, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return [Finding("lint.metric-keys", REGISTRY_DOC,
                        f"{REGISTRY_DOC} unreadable")]
    want = render_metric_key_table(registry)
    m = _block(text, _KEY_TABLE_START, _KEY_TABLE_END)
    if m is None:
        findings.append(Finding(
            "lint.metric-keys", REGISTRY_DOC,
            f"metric-key registry markers missing ({_KEY_TABLE_START} "
            f"... {_KEY_TABLE_END}) — the table is generated from the "
            "statically-extracted key registry"))
    elif m.group(1) != want:
        if fix:
            text = text[: m.start(1)] + want + text[m.end(1):]
            with open(doc, "w", encoding="utf-8") as f:
                f.write(text)
            print("torch_analysis_gate: rewrote the metric-key table of "
                  f"{REGISTRY_DOC} from the extracted registry")
        else:
            findings.append(Finding(
                "lint.metric-keys", REGISTRY_DOC,
                "metric-key table drifted from the emitted keys — a "
                "key was added/removed without documentation; run "
                "scripts/torch_analysis_gate.py --fix-metric-keys",
                text[: m.start(1)].count("\n") + 1))
    # dead documentation: prose keys outside the generated blocks (the
    # offsets read on the text as it now stands) and in README's port
    # section that match no emitted key
    prose = text
    for start, end in ((_KEY_TABLE_START, _KEY_TABLE_END),
                       (_KNOB_TABLE_START, _KNOB_TABLE_END)):
        b = _block(prose, start, end)
        if b is not None:
            # keep the block's newlines, so lines still count true
            prose = (prose[: b.start(1)] + "\n" * b.group(1).count("\n")
                     + prose[b.end(1):])
    scans = [(REGISTRY_DOC, prose, 0)]
    section = port_section(root)
    if section is None:
        findings.append(Finding(
            "lint.metric-keys", "README.md",
            f"README's port section markers missing ({_PORT_START} ... "
            f"{_PORT_END})"))
    else:
        scans.append(("README.md", section[0], section[1] - 1))
    emitted_roots = {k.split(".", 1)[0] for k in registry}
    for rel, body, base in scans:
        for tok, line in _doc_key_tokens(body, root):
            if tok.split(".", 1)[0] not in emitted_roots:
                continue  # not a telemetry family (api params, attrs, ...)
            if not _doc_token_matches(tok, registry):
                findings.append(Finding(
                    "lint.metric-keys", rel,
                    f"documented key {tok!r} is emitted nowhere (dead "
                    "key) — the docs promise telemetry the code no "
                    "longer produces", base + line))
    return findings


# ---------------------------------------------------------------------------
# the combined pass
# ---------------------------------------------------------------------------


def run_lints(root: str = ".", fix_metric_keys: bool = False) -> List[Finding]:
    """All five lints over the port's package tree (plus the port's
    scripts, ``scripts/torch_*.py``, for the json-write rule — CI
    artifacts torn mid-write poison later runs exactly like profile
    files do)."""
    pkg = iter_py_files(root, (_PKG,))
    findings = []
    findings.extend(lint_env_reads(pkg, root))
    findings.extend(lint_signal_safety(pkg, root))
    json_scope = list(pkg)
    scripts = os.path.join(root, "scripts")
    if os.path.isdir(scripts):
        json_scope += [os.path.join(scripts, f)
                       for f in sorted(os.listdir(scripts))
                       if f.startswith("torch_") and f.endswith(".py")]
    findings.extend(lint_json_writes(json_scope, root))
    findings.extend(lint_fault_seams(pkg, root))
    findings.extend(lint_metric_keys(root, fix=fix_metric_keys))
    return findings
