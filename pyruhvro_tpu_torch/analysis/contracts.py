"""Cross-language opcode contract checker (copy of
``pyruhvro_tpu/analysis/contracts.py``).

The host fast path keeps ONE logical contract — opcode kinds, column
types, error bits, per-op aux shapes, profiler slot names — in four
hand-synchronized places:

* ``hostpath/program.py`` — the Python constants the lowering emits;
* ``csrc/host/host_vm_core.h`` — the C++ ``OpKind`` / ``ColType``
  / ``Err`` enums the VM dispatches on, plus the profiler's pseudo-op
  slots (``P_COLLECT`` / ``P_MERGE`` / ``N_SLOT``) and the
  ``kSlotName`` / ``kDomPrefix`` telemetry string tables;
* ``csrc/host/extract_core.h`` — the ``AuxLane`` enum and the
  aux-tuple tag parser both native extraction walks consume;
* ``hostpath/specialize.py`` — the generated translation units' embedded
  ``kOps`` / ``kAux`` static tables.

Nothing but the differential suite stood between a silent drift and a
miscompiled engine. This pass parses each surface INDEPENDENTLY — the
Python side via ``ast`` (no import), the C++ side via comment-stripped
regex over the enum bodies — and fails on any divergence in value,
arity, aux kind, or op-name string. A final generative check lowers a
representative all-op-kinds schema and diffs the specializer's emitted
tables against the program they embed.

Every checker takes the repo root as a parameter so the test suite can
run them against fixture copies with seeded drift.

Departures from the reference: every surface is the port's own
(``pyruhvro_tpu_torch/hostpath/``, ``ops/varint.py`` and
``csrc/host/``), and :func:`check_error_taxonomy` counts slug coverage
in ``tests/test_torch_*.py`` only.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional

from . import Finding

__all__ = ["check_contracts", "EXPECTED_AUX_TAGS"]

# program.py aux tags <-> extract_core.h AuxLane members. The tag
# strings are the wire format of the contract (the C++ parser strcmp's
# them; the specializer's codegen switches on them).
EXPECTED_AUX_TAGS = {
    "uuid": "AUX_UUID",
    "binary": "AUX_BINARY",
    "duration": "AUX_DURATION",
    "decimal": "AUX_DECIMAL",
    "enum": "AUX_ENUM",
}

# C++ snprintf buffer for a drain key in host_vm_core.h prof::drain_py
_DRAIN_KEY_BUF = 48


# ---------------------------------------------------------------------------
# Python-side parsing (AST, no import)
# ---------------------------------------------------------------------------


def _const_eval(node: ast.AST) -> Optional[int]:
    """Evaluate the tiny constant-expression subset the contract files
    use: int literals, ``1 << n``, ``a + b``, ``-a``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_eval(node.operand)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        a, b = _const_eval(node.left), _const_eval(node.right)
        if a is None or b is None:
            return None
        if isinstance(node.op, ast.LShift):
            return a << b
        if isinstance(node.op, ast.Add):
            return a + b
        if isinstance(node.op, ast.Sub):
            return a - b
        if isinstance(node.op, ast.Mult):
            return a * b
    return None


def parse_py_constants(path: str, prefix: str) -> Dict[str, int]:
    """``NAME = <const>`` and ``A, B, ... = v0, v1, ...`` /
    ``= range(n)`` assignments whose names start with ``prefix``."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt, val = node.targets[0], node.value
        if isinstance(tgt, ast.Name) and tgt.id.startswith(prefix):
            v = _const_eval(val)
            if v is not None:
                out[tgt.id] = v
        elif isinstance(tgt, ast.Tuple) and all(
            isinstance(e, ast.Name) for e in tgt.elts
        ):
            names = [e.id for e in tgt.elts]
            if not any(n.startswith(prefix) for n in names):
                continue
            values: Optional[List[int]] = None
            if isinstance(val, ast.Tuple):
                vs = [_const_eval(e) for e in val.elts]
                if None not in vs and len(vs) == len(names):
                    values = vs  # type: ignore[assignment]
            elif (isinstance(val, ast.Call)
                  and isinstance(val.func, ast.Name)
                  and val.func.id == "range"
                  and len(val.args) == 1):
                n = _const_eval(val.args[0])
                if n is not None and n == len(names):
                    values = list(range(n))
            if values is not None:
                for n2, v2 in zip(names, values):
                    if n2.startswith(prefix):
                        out[n2] = v2
    return out


def parse_err_mappings(path: str) -> Dict[str, Dict[str, str]]:
    """The ``ERR_NAMES`` / ``ERR_SLUGS`` dict literals of
    ``ops/varint.py`` as ``{dict_name: {ERR_CONST: string}}`` — the
    Python exception wording (MalformedAvro messages) and the machine
    slugs (quarantine attribution) per error bit."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    out: Dict[str, Dict[str, str]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("ERR_NAMES", "ERR_SLUGS")
                and isinstance(node.value, ast.Dict)):
            continue
        m: Dict[str, str] = {}
        for k, v in zip(node.value.keys, node.value.values):
            if (isinstance(k, ast.Name)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)):
                m[k.id] = v.value
        out[node.targets[0].id] = m
    return out


def check_error_taxonomy(root: str) -> List[Finding]:
    """Every C++ ``Err`` enum value must map to a
    Python exception path — an ``ERR_NAMES`` message (the MalformedAvro
    wording ``hostpath/codec.py`` raises) and an ``ERR_SLUGS`` slug
    (the quarantine channel's attribution) — and each slug must be
    exercised by at least one of the port's tests (the quoted slug
    literal appears in a ``tests/test_torch_*.py``; the reference's
    tests never count as the port's coverage). An error bit no test can
    produce is an error path nobody has ever seen work."""
    findings: List[Finding] = []
    vm_core_h = os.path.join(
        root, "pyruhvro_tpu_torch/csrc/host/host_vm_core.h")
    varint_py = os.path.join(root, "pyruhvro_tpu_torch/ops/varint.py")
    varint_rel = "pyruhvro_tpu_torch/ops/varint.py"
    cpp_errs = parse_cpp_enum(vm_core_h, "Err")
    if not cpp_errs:
        return [Finding("contract.err-taxonomy",
                        "pyruhvro_tpu_torch/csrc/host/host_vm_core.h",
                        "Err enum not parsed")]
    maps = parse_err_mappings(varint_py)
    names = maps.get("ERR_NAMES", {})
    slugs = maps.get("ERR_SLUGS", {})
    if not names or not slugs:
        return [Finding("contract.err-taxonomy", varint_rel,
                        "ERR_NAMES/ERR_SLUGS dicts not parsed")]
    test_dir = os.path.join(root, "tests")
    blob = ""
    try:
        for fn in sorted(os.listdir(test_dir)):
            if fn.startswith("test_torch_") and fn.endswith(".py"):
                with open(os.path.join(test_dir, fn),
                          encoding="utf-8") as f:
                    blob += f.read()
    except OSError:
        pass
    for cname in sorted(cpp_errs):
        if cname not in names:
            findings.append(Finding(
                "contract.err-taxonomy", varint_rel,
                f"C++ Err member {cname} has no ERR_NAMES message — "
                "the native VM can set a bit the Python raise path "
                "cannot word"))
        if cname not in slugs:
            findings.append(Finding(
                "contract.err-taxonomy", varint_rel,
                f"C++ Err member {cname} has no ERR_SLUGS slug — the "
                "quarantine channel cannot attribute it"))
            continue
        slug = slugs[cname]
        if (f'"{slug}"' not in blob) and (f"'{slug}'" not in blob):
            findings.append(Finding(
                "contract.err-taxonomy", "tests/",
                f"error code {cname} (slug {slug!r}) is exercised by "
                "no test — craft a wire input that trips it and assert "
                "MalformedAvro.err_name"))
    return findings


def parse_py_aux_tags(path: str) -> set:
    """The aux TAG strings ``hostpath/program.py`` emits: first elements
    of tuples assigned into ``self.aux[...]``."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    tags = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)):
            continue
        tgt = node.targets[0].value
        if not (isinstance(tgt, ast.Attribute) and tgt.attr == "aux"):
            continue
        val = node.value
        # ("tag", ...) or ("tag",) + tuple(...)
        if isinstance(val, ast.BinOp):
            val = val.left
        if (isinstance(val, ast.Tuple) and val.elts
                and isinstance(val.elts[0], ast.Constant)
                and isinstance(val.elts[0].value, str)):
            tags.add(val.elts[0].value)
    return tags


# ---------------------------------------------------------------------------
# C++-side parsing (comment-stripped regex)
# ---------------------------------------------------------------------------


def _strip_cpp_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _cpp_const_eval(expr: str) -> Optional[int]:
    expr = expr.strip()
    m = re.fullmatch(r"(-?\d+)\s*<<\s*(\d+)", expr)
    if m:
        return int(m.group(1)) << int(m.group(2))
    try:
        return int(expr, 0)
    except ValueError:
        return None


def parse_cpp_enum(path: str, enum_name: str) -> Dict[str, int]:
    """Members of ``enum <name> [: type] { ... };`` as name -> value.
    Implicit (unassigned) members continue from the previous value, like
    the compiler does."""
    with open(path, encoding="utf-8") as f:
        text = _strip_cpp_comments(f.read())
    m = re.search(
        r"enum\s+" + re.escape(enum_name) + r"\s*(?::\s*[\w:]+\s*)?\{(.*?)\}",
        text, flags=re.S,
    )
    if m is None:
        return {}
    return _parse_enum_body(m.group(1))


def parse_cpp_anon_enum_with(path: str, member: str) -> Dict[str, int]:
    """The anonymous ``enum : int { ... };`` that contains ``member``
    (the profiler's pseudo-slot block)."""
    with open(path, encoding="utf-8") as f:
        text = _strip_cpp_comments(f.read())
    for m in re.finditer(r"enum\s*(?::\s*[\w:]+\s*)?\{(.*?)\}", text,
                         flags=re.S):
        body = _parse_enum_body(m.group(1))
        if member in body:
            return body
    return {}


def _parse_enum_body(body: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    nxt = 0
    for ent in body.split(","):
        ent = ent.strip()
        if not ent:
            continue
        if "=" in ent:
            name, expr = ent.split("=", 1)
            v = _cpp_const_eval(expr)
            if v is None:
                continue
            out[name.strip()] = v
            nxt = v + 1
        elif re.fullmatch(r"\w+", ent):
            out[ent] = nxt
            nxt += 1
    return out


def parse_cpp_string_array(path: str, array_name: str) -> List[str]:
    """The quoted strings of ``<array_name>[...] = { "a", "b", ... };``."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    m = re.search(re.escape(array_name) + r"\s*\[[^\]]*\]\s*=\s*\{(.*?)\};",
                  text, flags=re.S)
    if m is None:
        return []
    return re.findall(r'"([^"]*)"', m.group(1))


def parse_cpp_strcmp_tags(path: str) -> set:
    """Aux tag strings the C++ parser compares against
    (``std::strcmp(t, "<tag>")`` in extract_core.h AuxTables::parse)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return set(re.findall(r'strcmp\(t,\s*"(\w+)"\)', text))


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _diff_enum(findings: List[Finding], rule: str, py: Dict[str, int],
               cpp: Dict[str, int], py_path: str, cpp_path: str,
               require_same_names: bool = True) -> None:
    """Shared value-diff: names present on both sides must agree; with
    ``require_same_names`` the name SETS must match too (else C++ may be
    a subset — e.g. ``Err`` lacks the device-only bit)."""
    if not py:
        findings.append(Finding(rule, py_path, "no constants parsed"))
        return
    if not cpp:
        findings.append(Finding(rule, cpp_path, "enum not found/parsed"))
        return
    for name in sorted(set(py) & set(cpp)):
        if py[name] != cpp[name]:
            findings.append(Finding(
                rule, cpp_path,
                f"{name}: C++ value {cpp[name]} != Python value "
                f"{py[name]} ({py_path})",
            ))
    missing_cpp = sorted(set(py) - set(cpp))
    extra_cpp = sorted(set(cpp) - set(py))
    if require_same_names and missing_cpp:
        findings.append(Finding(
            rule, cpp_path,
            f"missing members vs {py_path}: {', '.join(missing_cpp)}",
        ))
    if extra_cpp:
        findings.append(Finding(
            rule, cpp_path,
            f"members with no Python counterpart in {py_path}: "
            f"{', '.join(extra_cpp)}",
        ))


def check_contracts(root: str, generative: bool = True) -> List[Finding]:
    """Run every contract check against the tree at ``root``; returns
    findings (empty = contracts hold). ``generative=False`` skips the
    import-the-package specializer-table diff (fixture trees in tests
    are not importable packages)."""
    findings: List[Finding] = []
    program_py = os.path.join(root, "pyruhvro_tpu_torch/hostpath/program.py")
    varint_py = os.path.join(root, "pyruhvro_tpu_torch/ops/varint.py")
    codec_py = os.path.join(root, "pyruhvro_tpu_torch/hostpath/codec.py")
    specialize_py = os.path.join(root, "pyruhvro_tpu_torch/hostpath/specialize.py")
    vm_core_h = os.path.join(
        root, "pyruhvro_tpu_torch/csrc/host/host_vm_core.h")
    extract_h = os.path.join(
        root, "pyruhvro_tpu_torch/csrc/host/extract_core.h")
    arrow_h = os.path.join(
        root, "pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h")

    # -- 1. opcode kinds --------------------------------------------------
    py_ops = parse_py_constants(program_py, "OP_")
    cpp_ops = parse_cpp_enum(vm_core_h, "OpKind")
    _diff_enum(findings, "contract.opkind", py_ops, cpp_ops,
               "pyruhvro_tpu_torch/hostpath/program.py",
               "pyruhvro_tpu_torch/csrc/host/host_vm_core.h")

    # -- 2. column types --------------------------------------------------
    py_cols = parse_py_constants(program_py, "COL_")
    py_cols.pop("COL_NBUF", None)  # a dict of buffer counts, not a code
    cpp_cols = parse_cpp_enum(vm_core_h, "ColType")
    _diff_enum(findings, "contract.coltype", py_cols, cpp_cols,
               "pyruhvro_tpu_torch/hostpath/program.py",
               "pyruhvro_tpu_torch/csrc/host/host_vm_core.h")

    # -- 3. error bits (C++ may be a strict subset: ERR_ITEM_OVERFLOW is
    #       device-tier-only by design) -----------------------------------
    py_errs = {k: v for k, v in
               parse_py_constants(varint_py, "ERR_").items()
               if isinstance(v, int)}
    cpp_errs = parse_cpp_enum(vm_core_h, "Err")
    _diff_enum(findings, "contract.err", py_errs, cpp_errs,
               "pyruhvro_tpu_torch/ops/varint.py",
               "pyruhvro_tpu_torch/csrc/host/host_vm_core.h",
               require_same_names=False)

    # -- 4. profiler slots + op-name string table -------------------------
    slots = parse_cpp_anon_enum_with(vm_core_h, "P_COLLECT")
    slot_names = parse_cpp_string_array(vm_core_h, "kSlotName")
    vm_core_rel = "pyruhvro_tpu_torch/csrc/host/host_vm_core.h"
    if not slots or not slot_names:
        findings.append(Finding(
            "contract.prof-slots", vm_core_rel,
            "profiler pseudo-slot enum or kSlotName table not parsed"))
    elif py_ops:
        n_ops = len(py_ops)
        if slots.get("P_COLLECT") != n_ops:
            findings.append(Finding(
                "contract.prof-slots", vm_core_rel,
                f"P_COLLECT = {slots.get('P_COLLECT')} but program.py "
                f"defines {n_ops} opcodes (pseudo-slots must start right "
                "after the real ones)"))
        if slots.get("P_MERGE") != slots.get("P_COLLECT", -2) + 1 \
                or slots.get("P_SHARD") != slots.get("P_MERGE", -2) + 1 \
                or slots.get("N_SLOT") != slots.get("P_SHARD", -2) + 1:
            findings.append(Finding(
                "contract.prof-slots", vm_core_rel,
                f"pseudo-slot layout drifted: {slots}"))
        if len(slot_names) != slots.get("N_SLOT"):
            findings.append(Finding(
                "contract.prof-slots", vm_core_rel,
                f"kSlotName has {len(slot_names)} entries, N_SLOT is "
                f"{slots.get('N_SLOT')}"))
        # slot i names opcode value i: OP_DEC_BYTES=14 -> "dec_bytes"
        by_value = {v: k for k, v in py_ops.items()}
        for i, nm in enumerate(slot_names[:n_ops]):
            expect = by_value.get(i, "?")[len("OP_"):].lower()
            if nm != expect:
                findings.append(Finding(
                    "contract.prof-slots", vm_core_rel,
                    f"kSlotName[{i}] is {nm!r}, expected {expect!r} "
                    f"(from {by_value.get(i)})"))
        if slot_names[len(py_ops):] != ["collect", "merge", "shard"]:
            findings.append(Finding(
                "contract.prof-slots", vm_core_rel,
                f"pseudo-slot names drifted: {slot_names[len(py_ops):]}"
                " != ['collect', 'merge', 'shard']"))

    # -- 5. drain-key prefixes: C++ kDomPrefix <-> the telemetry names
    #       hostpath/codec.py documents/consumes, and every full key must
    #       fit the C++ snprintf buffer ------------------------------------
    prefixes = parse_cpp_string_array(vm_core_h, "kDomPrefix")
    codec_rel = "pyruhvro_tpu_torch/hostpath/codec.py"
    if not prefixes:
        findings.append(Finding("contract.drain-keys", vm_core_rel,
                                "kDomPrefix table not parsed"))
    else:
        with open(codec_py, encoding="utf-8") as f:
            codec_src = f.read()
        for p in prefixes:
            if p not in codec_src:
                findings.append(Finding(
                    "contract.drain-keys", codec_rel,
                    f"drain prefix {p!r} (kDomPrefix) is not mentioned "
                    "in hostpath/codec.py — the Python drain consumer "
                    "no longer documents every native domain"))
        for p in prefixes:
            for nm in slot_names:
                # + "_s" suffix the Python side appends for self-time
                if len(p) + len(nm) + len("_s") + 1 > _DRAIN_KEY_BUF:
                    findings.append(Finding(
                        "contract.drain-keys", vm_core_rel,
                        f"drain key {p + nm!r} + '_s' overflows the "
                        f"{_DRAIN_KEY_BUF}-byte snprintf buffer"))

    # -- 6. aux tags: program.py emits <-> extract_core.h parses <->
    #       specialize.py embeds <-> AuxLane enum --------------------------
    py_tags = parse_py_aux_tags(program_py)
    cpp_tags = parse_cpp_strcmp_tags(extract_h)
    aux_enum = parse_cpp_enum(extract_h, "AuxLane")
    extract_rel = "pyruhvro_tpu_torch/csrc/host/extract_core.h"
    if py_tags != set(EXPECTED_AUX_TAGS):
        findings.append(Finding(
            "contract.aux-tags", "pyruhvro_tpu_torch/hostpath/program.py",
            f"aux tags emitted by the lowering drifted: {sorted(py_tags)}"
            f" != {sorted(EXPECTED_AUX_TAGS)} (update EXPECTED_AUX_TAGS "
            "and every consumer together)"))
    missing_parse = py_tags - cpp_tags
    if missing_parse:
        findings.append(Finding(
            "contract.aux-tags", extract_rel,
            f"AuxTables::parse does not handle tag(s) "
            f"{sorted(missing_parse)} that program.py emits"))
    if not aux_enum:
        findings.append(Finding("contract.aux-tags", extract_rel,
                                "AuxLane enum not parsed"))
    else:
        for tag, lane in EXPECTED_AUX_TAGS.items():
            if lane not in aux_enum:
                findings.append(Finding(
                    "contract.aux-tags", extract_rel,
                    f"AuxLane lacks {lane} (tag {tag!r})"))
        # lanes named in specialize.py's codegen and in the fused decode
        # walk must exist in the enum
        for src_path, rel in ((specialize_py,
                               "pyruhvro_tpu_torch/hostpath/specialize.py"),
                              (arrow_h,
                               "pyruhvro_tpu_torch/csrc/host/"
                               "arrow_decode_core.h")):
            with open(src_path, encoding="utf-8") as f:
                used = set(re.findall(r"\b(AUX_\w+)\b", f.read()))
            unknown = used - set(aux_enum)
            if unknown:
                findings.append(Finding(
                    "contract.aux-tags", rel,
                    f"references unknown AuxLane member(s) "
                    f"{sorted(unknown)}"))

    # -- 7. error-taxonomy coverage -----------------------------------------
    findings.extend(check_error_taxonomy(root))

    if generative:
        findings.extend(_check_specializer_tables())
    return findings


# ---------------------------------------------------------------------------
# generative check: the specializer's embedded kOps/kAux tables
# ---------------------------------------------------------------------------

# a schema that lowers to every opcode kind and every aux lane; if an op
# kind is ever added to program.py this check fails loudly until the
# schema below exercises it too
_ALL_OPS_SCHEMA = """
{"type": "record", "name": "AllOps", "fields": [
  {"name": "i",    "type": "int"},
  {"name": "l",    "type": "long"},
  {"name": "f",    "type": "float"},
  {"name": "d",    "type": "double"},
  {"name": "b",    "type": "boolean"},
  {"name": "s",    "type": "string"},
  {"name": "u",    "type": {"type": "string", "logicalType": "uuid"}},
  {"name": "by",   "type": "bytes"},
  {"name": "dec",  "type": {"type": "bytes", "logicalType": "decimal",
                            "precision": 10, "scale": 2}},
  {"name": "fx",   "type": {"type": "fixed", "name": "F8", "size": 8}},
  {"name": "dur",  "type": {"type": "fixed", "name": "Dur", "size": 12,
                            "logicalType": "duration"}},
  {"name": "decf", "type": {"type": "fixed", "name": "DF", "size": 16,
                            "logicalType": "decimal", "precision": 20,
                            "scale": 4}},
  {"name": "e",    "type": {"type": "enum", "name": "E",
                            "symbols": ["A", "B", "C"]}},
  {"name": "n",    "type": "null"},
  {"name": "opt",  "type": ["null", "int"]},
  {"name": "un",   "type": ["int", "string", "null"]},
  {"name": "arr",  "type": {"type": "array", "items": "int"}},
  {"name": "m",    "type": {"type": "map", "values": "string"}},
  {"name": "sub",  "type": {"type": "record", "name": "Sub", "fields":
                            [{"name": "x", "type": "int"}]}}
]}
"""

_LANE_FOR_TAG = {None: "AUX_NONE", "uuid": "AUX_UUID",
                 "binary": "AUX_BINARY", "duration": "AUX_DURATION",
                 "decimal": "AUX_DECIMAL", "enum": "AUX_ENUM"}


def _check_specializer_tables() -> List[Finding]:
    """Lower the all-ops schema, generate the specialized C++, and diff
    the embedded ``kOps`` / ``kAux`` static tables against the program
    they were generated from. Catches codegen drift the enum diffs
    cannot (a transposed field, a dropped aux lane, a stale arity)."""
    findings: List[Finding] = []
    rel = "pyruhvro_tpu_torch/hostpath/specialize.py"
    from ..hostpath.program import lower_host
    from ..hostpath.specialize import generate_source
    from ..schema.parser import parse_schema

    prog = lower_host(parse_schema(_ALL_OPS_SCHEMA))
    kinds = {int(k) for k in prog.ops[:, 0]}
    # every LOWERING-emitted kind (OP_FIXED_RUN=16 is optimizer-only:
    # the specializer consumes raw programs and never sees it)
    expected_kinds = set(range(16))
    if kinds != expected_kinds:
        return [Finding(
            "contract.spec-tables", "pyruhvro_tpu_torch/analysis/contracts.py",
            f"the representative schema no longer covers every opcode "
            f"kind (missing {sorted(expected_kinds - kinds)}) — extend "
            "_ALL_OPS_SCHEMA")]
    src = generate_source(prog, "M")

    m = re.search(r"static const Op kOps\[\] = \{(.*?)\};", src, flags=re.S)
    rows = re.findall(
        r"\{(-?\d+), (-?\d+), (-?\d+), (-?\d+), (-?\d+), 0\},",
        m.group(1) if m else "")
    if len(rows) != len(prog.ops):
        findings.append(Finding(
            "contract.spec-tables", rel,
            f"kOps has {len(rows)} rows, program has {len(prog.ops)}"))
    else:
        for i, row in enumerate(rows):
            want = tuple(int(x) for x in prog.ops[i][:5])
            got = tuple(int(x) for x in row)
            if got != want:
                findings.append(Finding(
                    "contract.spec-tables", rel,
                    f"kOps[{i}] = {got} but HostProgram.ops[{i}] = "
                    f"{want}"))

    m = re.search(r"static const OpAux kAux\[\] = \{(.*?)\};", src,
                  flags=re.S)
    entries = re.findall(r"\{(AUX_\w+), [^,]+, [^,]+, (\w+)\},",
                         m.group(1) if m else "")
    if len(entries) != len(prog.ops):
        findings.append(Finding(
            "contract.spec-tables", rel,
            f"kAux has {len(entries)} entries, program has "
            f"{len(prog.ops)} ops"))
    else:
        for i, (lane, last) in enumerate(entries):
            aux = prog.op_aux[i]
            tag = aux[0] if aux else None
            want_lane = _LANE_FOR_TAG.get(tag)
            if lane != want_lane:
                findings.append(Finding(
                    "contract.spec-tables", rel,
                    f"kAux[{i}] lane {lane} != {want_lane} (op_aux "
                    f"entry {aux!r})"))
                continue
            # arity payload: decimal carries precision, enum its symbol
            # count, in the shared nsyms field
            if tag == "decimal" and int(last) != int(aux[1]):
                findings.append(Finding(
                    "contract.spec-tables", rel,
                    f"kAux[{i}] decimal precision {last} != {aux[1]}"))
            if tag == "enum" and int(last) != len(aux) - 1:
                findings.append(Finding(
                    "contract.spec-tables", rel,
                    f"kAux[{i}] enum symbol count {last} != "
                    f"{len(aux) - 1}"))
    return findings
