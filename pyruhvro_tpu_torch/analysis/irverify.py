"""IR verification plane: abstract interpretation over opcode programs
(copy of ``pyruhvro_tpu/analysis/irverify.py``).

The contract checker (:mod:`.contracts`) diffs *tables* (enum
values, the specializer's embedded ``kOps``/``kAux`` bytes); this pass
machine-checks program *meaning*: every compiled hostpath program —
the generic ``hostpath/program.py`` lowering AND the specializer's
generated translation units, decode and encode directions — is
abstract-executed against the effect contract
(:data:`..hostpath.program.OP_EFFECTS`) and four invariant classes are
proved per program:

1. **Type/effect discipline** (``irverify.effect``) — subtree ``nops``
   tiling (the walk advances strictly and terminates), column-index
   bounds and one-writer-per-column ownership, column-type stack
   effects (each op's primary/key column carries the ColType the
   engines expect), per-axis push-count exactness (every column
   appends exactly once per element of its region axis — item columns
   on the item axis, everything else per record; a column appearing
   off-axis desyncs every later column), aux-table arity/placement
   (required tags,
   enum symbol count == ``op.a``, decimal precision >= 1) and the aux
   consumption matrix (an aux entry no consumer reads is dead weight
   in every embedded table), and validity-chain nesting depth vs the
   ``PYRUHVRO_TPU_MAX_DEPTH`` walker cap.
2. **Wire progress / termination** (``irverify.progress``) — every
   array/map item subtree either consumes >= 1 wire byte per item
   (bounded by the record span) or is reachable only under the
   zero-width budget (``kMaxZeroWidthItems``), whose native guard must
   be anchored in the sources; block loops terminate on the zero count
   by the same anchor discipline. No schema can therefore compile to a
   non-terminating record decode.
3. **Overflow safety** (``irverify.overflow``) — symbolic int32/int64
   analysis of the offset/length/capacity lanes: every int32-narrowing
   sink an op writes (string lens, offsets running totals, merge
   rebase, fused prefix sums, enum expansion, encode positions) must
   carry a declared guard whose *anchor* — a source pattern naming the
   actual range check — is present in the native cores. Deleting a C++
   bound check (or its declaration) fails the gate; this is how the
   >2GiB string-length lane (``string_len_i32``, fixed in this PR) is
   kept fixed.
4. **Generic <-> specialized equivalence** (``irverify.equiv``) — the
   generated source's embedded tables are re-parsed and abstract-
   executed, its ``EFFECTS-v1`` journal (recorded by the code
   generators as they emit) is diffed against this module's own
   abstract walk, and the emitted bodies are censused for column
   references — a strictly stronger check than the contract checker's byte diff
   (a body that pushes the wrong column still embeds the right table).

A generative driver walks the schema-construct lattice (every op kind
x nullable x union-position x nesting depth) and a seeded mutation
self-test proves each invariant class still turns red; both land in
the report :func:`run_ir_verification` returns.

Departures from the reference:

* Every scanned path is the port's own: the native guards and aux
  consumers are anchored in ``pyruhvro_tpu_torch/csrc/host/``, the
  specialiser's codegen in ``pyruhvro_tpu_torch/hostpath/specialize.py``
  and the oracle's reader in ``pyruhvro_tpu_torch/fallback/io.py``; a
  finding's path names the port's file.
* :func:`_default_max_depth` reads the port's knob registry, which maps
  a name to its default (the reference's maps it to a typed knob).
* The report's ``generated_by`` is this module. The port writes no
  report file: :func:`run_ir_verification` returns it to the caller.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from . import Finding

__all__ = [
    "ProgramModel",
    "scan_native_guards",
    "verify_program",
    "verify_structure",
    "verify_progress",
    "verify_overflow",
    "verify_equivalence",
    "verify_optimized",
    "abstract_trace",
    "lattice_points",
    "run_lattice",
    "run_mutation_selftest",
    "run_ir_verification",
    "GUARD_ANCHORS",
    "AUX_CONSUMERS",
]

# ---------------------------------------------------------------------------
# the program model (engine-independent view of one opcode program)
# ---------------------------------------------------------------------------


class ProgramModel:
    """One opcode program as plain Python data: the generic lowering's
    arrays, or the specializer's embedded tables re-parsed out of a
    generated translation unit — both feed the same passes."""

    def __init__(self, ops: List[Tuple[int, int, int, int, int, int]],
                 coltypes: List[int], aux: Sequence, label: str,
                 col_regions: Optional[List[int]] = None):
        self.ops = [tuple(int(x) for x in row) for row in ops]
        self.coltypes = [int(c) for c in coltypes]
        self.aux = tuple(aux)
        self.label = label
        # per-column region id the LOWERING declared (0 = rows, then
        # one id per array/map in pre-order) — None when the model was
        # re-parsed from a generated unit, which embeds no region table
        self.col_regions = col_regions

    @classmethod
    def from_host_program(cls, prog, label: str = "generic"):
        aux = prog.op_aux or tuple(None for _ in range(len(prog.ops)))
        return cls([tuple(int(x) for x in row) for row in prog.ops],
                   [int(c) for c in prog.coltypes], aux, label,
                   col_regions=[int(c.region) for c in prog.cols])

    @classmethod
    def from_generated_source(cls, src: str, coltypes: List[int],
                              label: str = "specialized"):
        """Re-parse the embedded ``kOps``/``kAux`` static tables out of
        a generated translation unit (coltypes are not embedded — the
        caller supplies the program's)."""
        m = re.search(r"static const Op kOps\[\] = \{(.*?)\};", src,
                      flags=re.S)
        rows = re.findall(
            r"\{(-?\d+), (-?\d+), (-?\d+), (-?\d+), (-?\d+), (-?\d+)\},",
            m.group(1) if m else "")
        ops = [tuple(int(x) for x in r) for r in rows]
        # symbol byte arrays: kSym_<op>_<k>[] = {98, 97, 0}
        syms: Dict[Tuple[int, int], bytes] = {}
        for om, km, body in re.findall(
                r"static const char kSym_(\d+)_(\d+)\[\] = \{([^}]*)\};",
                src):
            vals = [int(v) for v in body.split(",") if v.strip()]
            if vals and vals[-1] == 0:
                vals = vals[:-1]  # the NUL terminator
            syms[(int(om), int(km))] = bytes(vals)
        m = re.search(r"static const OpAux kAux\[\] = \{(.*?)\};", src,
                      flags=re.S)
        entries = re.findall(r"\{(AUX_\w+), ([^,]+), [^,]+, (\w+)\},",
                             m.group(1) if m else "")
        aux: List[Optional[tuple]] = []
        for i, (lane, symref, last) in enumerate(entries):
            if lane == "AUX_NONE":
                aux.append(None)
            elif lane == "AUX_UUID":
                aux.append(("uuid",))
            elif lane == "AUX_BINARY":
                aux.append(("binary",))
            elif lane == "AUX_DURATION":
                aux.append(("duration",))
            elif lane == "AUX_DECIMAL":
                aux.append(("decimal", int(last)))
            elif lane == "AUX_ENUM":
                sm = re.match(r"kSyms_(\d+)", symref.strip())
                oi = int(sm.group(1)) if sm else i
                n = int(last)
                aux.append(("enum",) + tuple(syms.get((oi, k), b"")
                                             for k in range(n)))
            else:
                aux.append(("?" + lane,))
        return cls(ops, coltypes, tuple(aux), label)

    @property
    def ncols(self) -> int:
        return len(self.coltypes)


# ---------------------------------------------------------------------------
# native guard anchors: the symbolic pass's link to the real sources
# ---------------------------------------------------------------------------

# guard name -> [(repo-relative file, raw-text regex)]: EVERY pattern
# must match for the guard to count as present. The patterns name the
# actual range checks (or audited design notes) in the native cores and
# the specializer's codegen strings, so deleting a bound check in C++
# breaks the declaration in hostpath/program.py OP_EFFECTS and the gate
# goes red — the declaration cannot rot into a rubber stamp.
GUARD_ANCHORS: Dict[str, List[Tuple[str, str]]] = {
    # OP_INT rejects a zigzag past int32 (ERR_INT_RANGE) in the reader
    # both engines call: the VM's op and the specialiser's codegen
    "int_range_i32": [
        ("pyruhvro_tpu_torch/csrc/host/host_vm_core.h",
         r"v < INT32_MIN \|\| v > INT32_MAX"),
        ("pyruhvro_tpu_torch/csrc/host/host_codec.cpp",
         r"present \? r\.read_int\(\) : 0"),
        ("pyruhvro_tpu_torch/hostpath/specialize.py",
         r'v = "r\.read_int\(\)"'),
    ],
    # rd_string: length bounded by the remaining span...
    "string_len_span": [
        ("pyruhvro_tpu_torch/csrc/host/host_vm_core.h",
         r"len > r\.end - r\.cur"),
    ],
    # ...AND by int32 before landing in the lens lane (the 2GiB lane
    # this PR fixed); the fallback reader mirrors it for tier agreement
    "string_len_i32": [
        ("pyruhvro_tpu_torch/csrc/host/host_vm_core.h",
         r"len > \(int64_t\)INT32_MAX"),
        ("pyruhvro_tpu_torch/fallback/io.py", r"ln > 0x7FFFFFFF"),
    ],
    "enum_range": [
        ("pyruhvro_tpu_torch/csrc/host/host_codec.cpp",
         r"v < 0 \|\| v >= op\.a"),
        ("pyruhvro_tpu_torch/hostpath/specialize.py",
         r"v\{u\} < 0 \|\| v\{u\} >= \{a\}"),
    ],
    "union_branch_range": [
        ("pyruhvro_tpu_torch/csrc/host/host_codec.cpp",
         r"br < 0 \|\| br >= op\.a"),
        ("pyruhvro_tpu_torch/hostpath/specialize.py",
         r"br\{u\} < 0 \|\| br\{u\} >= \{a\}"),
    ],
    # offsets running totals are int32 and checked after each increment
    # in BOTH engines
    "offs_running_i32": [
        ("pyruhvro_tpu_torch/csrc/host/host_codec.cpp",
         r"offs\.running < 0"),
        ("pyruhvro_tpu_torch/hostpath/specialize.py", r"\.running < 0"),
    ],
    # shard-merge rebase of offsets columns
    "merge_offsets_i32": [
        ("pyruhvro_tpu_torch/csrc/host/host_vm_core.h", r"v > INT32_MAX"),
    ],
    # fused finalize: string offsets prefix sums fall back past int32
    "fused_str_offsets_i32": [
        ("pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h",
         r"acc > INT32_MAX"),
    ],
    # fused finalize: enum symbol expansion capped at 2 GiB
    "enum_expand_2gib": [
        ("pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h",
         r"total >= \(\(int64_t\)1 << 31\)"),
    ],
    # fused finalize: repeated-node offsets rebase
    "repeated_offsets_i32": [
        ("pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h",
         r"val > INT32_MAX"),
    ],
    # duration ms total bounded before the int64 store
    "duration_ms_i64": [
        ("pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h",
         r"total > \(uint64_t\)INT64_MAX"),
    ],
    # optimizer-fused member run (OP_FIXED_RUN, a=1): ONE upfront span
    # check justifies every unchecked member read on the bulk lane
    "fixed_run_span": [
        ("pyruhvro_tpu_torch/csrc/host/host_codec.cpp",
         r"op\.b <= \(int64_t\)\(r\.end - r\.cur\)"),
    ],
    # encode wire position checked against int32 offsets per record
    "encode_pos_i32": [
        ("pyruhvro_tpu_torch/csrc/host/host_vm_core.h",
         r"pos > \(size_t\)INT32_MAX"),
    ],
    # zero-width items charge the per-record budget in every engine
    # (and the fallback walker agrees on the constant)
    "zero_width_budget": [
        ("pyruhvro_tpu_torch/csrc/host/host_codec.cpp",
         r"zw > kMaxZeroWidthItems"),
        ("pyruhvro_tpu_torch/hostpath/specialize.py", r"kMaxZeroWidthItems"),
        ("pyruhvro_tpu_torch/fallback/io.py", r"MAX_ZERO_WIDTH_ITEMS"),
    ],
    # block loops terminate on the zero count in both engines
    "block_zero_terminates": [
        ("pyruhvro_tpu_torch/csrc/host/host_codec.cpp", r"count == 0"),
        ("pyruhvro_tpu_torch/hostpath/specialize.py", r"cnt\{u\} == 0"),
    ],
}

# aux tag -> {direction: consumer anchor (file, pattern)}. An aux entry
# whose tag has NO anchored consumer in ANY direction is dead weight in
# every embedded table (irverify.effect.dead-aux). Direction-scoped
# entries carry an audit note exported to the report: the encode
# extractor copies binary bytes verbatim (the UTF-8 contract only
# matters on decode) and trusts pyarrow's decimal128 precision
# enforcement (the declared precision is re-checked on decode only).
AUX_CONSUMERS: Dict[str, Dict[str, Tuple[str, str]]] = {
    "uuid": {
        "decode": ("pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h",
                   r"AUX_UUID"),
        "encode": ("pyruhvro_tpu_torch/csrc/host/extract_core.h",
                   r"aux_\[pc\]\.lane == AUX_UUID"),
    },
    "binary": {
        "decode": ("pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h",
                   r"AUX_BINARY"),
        # encode: NOT consumed — audited: bytes copy verbatim either way
    },
    "duration": {
        "decode": ("pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h",
                   r"AUX_DURATION"),
        "encode": ("pyruhvro_tpu_torch/csrc/host/extract_core.h",
                   r"aux_\[pc\]\.lane == AUX_DURATION"),
    },
    "decimal": {
        "decode": ("pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h",
                   r"AUX_DECIMAL"),
        # encode: NOT consumed — audited: pyarrow enforces precision on
        # the decimal128 column; wr_decimal checks the wire-size fit
    },
    "enum": {
        "decode": ("pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h",
                   r"AUX_ENUM"),
        "encode": ("pyruhvro_tpu_torch/csrc/host/extract_core.h",
                   r"aux_\[pc\]\.lane != AUX_ENUM"),
    },
}

AUX_AUDIT_NOTES = {
    ("binary", "encode"):
        "bytes copy verbatim on encode; the UTF-8 contract is a "
        "decode-direction concern (arrow_decode_core.h string_entry)",
    ("decimal", "encode"):
        "pyarrow enforces declared precision on the decimal128 input "
        "column; the wire-size fit check lives in wr_decimal",
}


def scan_native_guards(root: str) -> Dict[str, bool]:
    """Which guard anchors are actually present in the tree at
    ``root``. Raw-text scan (some anchors are audited comments)."""
    out: Dict[str, bool] = {}
    cache: Dict[str, str] = {}
    for guard, pats in GUARD_ANCHORS.items():
        ok = True
        for rel, pat in pats:
            path = os.path.join(root, rel)
            if path not in cache:
                try:
                    with open(path, encoding="utf-8") as f:
                        cache[path] = f.read()
                except OSError:
                    cache[path] = ""
            if not re.search(pat, cache[path]):
                ok = False
        out[guard] = ok
    return out


def scan_aux_consumers(root: str) -> Dict[str, List[str]]:
    """tag -> directions whose consumer anchor is present at ``root``."""
    out: Dict[str, List[str]] = {}
    cache: Dict[str, str] = {}
    for tag, dirs in AUX_CONSUMERS.items():
        found = []
        for direction, (rel, pat) in dirs.items():
            path = os.path.join(root, rel)
            if path not in cache:
                try:
                    with open(path, encoding="utf-8") as f:
                        cache[path] = f.read()
                except OSError:
                    cache[path] = ""
            if re.search(pat, cache[path]):
                found.append(direction)
        out[tag] = sorted(found)
    return out


# ---------------------------------------------------------------------------
# pass 1: type/effect discipline (+ structural termination)
# ---------------------------------------------------------------------------


def _effects():
    from ..hostpath import program as hp

    return hp


def _default_max_depth() -> int:
    """The PYRUHVRO_TPU_MAX_DEPTH *registered default* — the verifier
    proves programs against the shipped walker cap, not whatever the
    current environment happens to tune it to (a tuned-down knob must
    not turn a pristine tree red)."""
    from ..runtime import knobs

    return int(knobs.registry()["PYRUHVRO_TPU_MAX_DEPTH"])


def verify_structure(m: ProgramModel,
                     max_depth: Optional[int] = None) -> List[Finding]:
    """Subtree tiling, column ownership/typing, push balance, aux
    arity/placement, nesting depth. Structural termination failures
    (``nops < 1`` — the walk would never advance) report under
    ``irverify.progress`` since they are non-termination bugs."""
    hp = _effects()
    findings: List[Finding] = []
    n = len(m.ops)
    path = m.label

    def f(rule, msg, pc=0):
        findings.append(Finding(rule, path, msg, pc))

    if n == 0:
        f("irverify.effect", "empty program")
        return findings
    if max_depth is None:
        max_depth = _default_max_depth()

    if len(m.aux) != n:
        f("irverify.effect",
          f"aux table has {len(m.aux)} entries for {n} ops")

    owners: Dict[int, int] = {}  # col -> pc

    def own(col: int, pc: int, what: str, want_ctype: int):
        if col < 0 or col >= m.ncols:
            f("irverify.effect",
              f"op {pc} ({what}): column index {col} out of range "
              f"[0, {m.ncols})", pc)
            return
        if col in owners:
            f("irverify.effect",
              f"op {pc} ({what}): column {col} already written by op "
              f"{owners[col]} — one writer per column", pc)
        owners[col] = pc
        got = m.coltypes[col]
        if got != want_ctype:
            f("irverify.effect",
              f"op {pc} ({what}): column {col} has ColType {got}, the "
              f"effect contract requires {want_ctype}", pc)

    max_seen_depth = 0

    def check_axis(counts: Dict[int, int], pc: int, what: str):
        """Per-axis push exactness: every column on this region axis
        appends exactly once per axis element — in BOTH execution
        modes (the engines append defaults/advance cursors for absent
        subtrees by construction; the equivalence pass checks the
        generated code actually does)."""
        bad = {c: k for c, k in counts.items() if k != 1}
        if bad:
            f("irverify.effect",
              f"{what}: column(s) {bad} appended != 1 time per "
              "element of their region axis — every later column "
              "would desync", pc)

    next_rid = [1]  # region ids in pre-order, like the lowering

    def region_check(c: int, pc: int, what: str, axis: int):
        """A column must live on the region axis the walk reaches it
        under — the lowering's declared region (prog.cols). An op
        absorbed into the wrong loop (corrupted ``nops``) appends per
        ITEM what the assembler consumes per RECORD."""
        if m.col_regions is None or not (0 <= c < len(m.col_regions)):
            return
        declared = m.col_regions[c]
        if declared != axis:
            f("irverify.effect",
              f"op {pc} ({what}): column {c} is declared in region "
              f"{declared} but the walk reaches it on axis {axis} — "
              "its per-element append cadence would not match the "
              "assembler's", pc)

    # returns (end_pc, counts) where counts maps col -> appends per
    # element of THIS region axis (identical for the present and
    # absent modes by the engines' default-append construction).
    # ``uncond`` tracks whether every ancestor is a plain record (or a
    # fused header inside one) — the reachability fact the optimizer's
    # FLAG_ALWAYS_PRESENT claim must be re-derived against.
    def walk(pc: int, depth: int, axis: int = 0, uncond: bool = True):
        nonlocal max_seen_depth
        max_seen_depth = max(max_seen_depth, depth)
        if pc >= n:
            f("irverify.progress",
              f"walk ran past the program end at pc {pc}", pc)
            return n, {}
        kind, a, b, col, nops, pad = m.ops[pc]
        if kind not in hp.OP_EFFECTS:
            f("irverify.effect", f"op {pc}: unknown kind {kind}", pc)
            return pc + 1, {}
        eff = hp.OP_EFFECTS[kind]
        name = hp.OP_NAMES[kind]
        if nops < 1:
            f("irverify.progress",
              f"op {pc} ({name}): nops={nops} < 1 — the walk cannot "
              "advance (non-terminating decode)", pc)
            return pc + 1, {}
        stop = pc + nops
        if stop > n:
            f("irverify.progress",
              f"op {pc} ({name}): subtree [pc, pc+{nops}) overruns the "
              f"program ({n} ops)", pc)
            stop = n

        # primary column discipline
        if eff["ctype"] is None:
            if col != -1:
                f("irverify.effect",
                  f"op {pc} ({name}): carries column {col} but the "
                  "effect contract declares none", pc)
        else:
            own(col, pc, name, eff["ctype"])
            region_check(col, pc, name, axis)
        if kind == hp.OP_MAP:
            own(b, pc, "map-key", hp.COL_STR)

        # aux placement / arity
        aux = m.aux[pc] if pc < len(m.aux) else None
        allowed = eff["aux"]
        tag = aux[0] if aux else None
        plain = tuple(t.lstrip("!") if isinstance(t, str) else t
                      for t in allowed)
        required = [t[1:] for t in allowed
                    if isinstance(t, str) and t.startswith("!")]
        if tag not in plain:
            f("irverify.effect",
              f"op {pc} ({name}): aux tag {tag!r} not permitted "
              f"(allowed: {plain})", pc)
        elif required and tag not in required:
            f("irverify.effect",
              f"op {pc} ({name}): required aux {required} missing", pc)
        if tag == "enum":
            nsyms = len(aux) - 1
            if nsyms != a or a < 1:
                f("irverify.effect",
                  f"op {pc} (enum): aux carries {nsyms} symbols, op.a "
                  f"= {a} — the fused decode indexes symbols by the "
                  "range check on op.a", pc)
        if tag == "decimal":
            if len(aux) < 2 or int(aux[1]) < 1:
                f("irverify.effect",
                  f"op {pc} ({name}): decimal aux needs precision >= 1 "
                  f"(got {aux[1:]!r})", pc)
        if kind == hp.OP_ENUM and a < 1:
            f("irverify.effect", f"op {pc} (enum): no symbols (a={a})",
              pc)
        if kind == hp.OP_NULLABLE and a not in (0, 1):
            f("irverify.effect",
              f"op {pc} (nullable): null index {a} not 0/1", pc)
        if kind == hp.OP_UNION and a < 1:
            f("irverify.effect", f"op {pc} (union): a={a} arms", pc)
        if kind in (hp.OP_FIXED, hp.OP_DEC_FIXED) and a < 0:
            f("irverify.effect", f"op {pc} ({name}): size a={a} < 0", pc)

        # pad-flag discipline: the optimizer's proof-carrying bits are
        # only meaningful on the ops whose engines read them; a stray
        # bit elsewhere is a corrupted (or misapplied) rewrite
        allowed_pad = 0
        if kind == hp.OP_FIXED_RUN:
            allowed_pad = hp.FLAG_ALWAYS_PRESENT
        elif kind in (hp.OP_ARRAY, hp.OP_MAP):
            allowed_pad = hp.FLAG_STR_ITEMS
        if pad & ~allowed_pad:
            f("irverify.optimize",
              f"op {pc} ({name}): pad flag bits {pad:#x} are not "
              "permitted on this op kind", pc)

        counts: Dict[int, int] = {}

        def push(counts_, c, k=1):
            if c >= 0:
                counts_[c] = counts_.get(c, 0) + k

        if eff["ctype"] is not None:
            push(counts, col)

        if kind == hp.OP_RECORD:
            p = pc + 1
            while p < stop:
                p, cp = walk(p, depth + 1, axis, uncond)
                for c, k in cp.items():
                    push(counts, c, k)
            if p != stop:
                f("irverify.effect",
                  f"op {pc} (record): children end at {p}, nops claims "
                  f"{stop}", pc)
        elif kind == hp.OP_FIXED_RUN:
            # optimizer-emitted header (hostpath/optimize.py): >= 2
            # plain fixed-layout leaves of one record, walked on the
            # SAME axis. Every operand claim is re-derived, never
            # trusted: b must equal the members' summed wire floors
            # (the bulk lane's span pre-check admits exactly b bytes)
            # and a=1 only when every member is exact-width — one span
            # check cannot bound a varint member's reads.
            fusable = {hp.OP_INT: 1, hp.OP_LONG: 1, hp.OP_FLOAT: 4,
                       hp.OP_DOUBLE: 8, hp.OP_BOOL: 1}
            exact_kinds = (hp.OP_FLOAT, hp.OP_DOUBLE, hp.OP_BOOL)
            member_pcs = []
            p = pc + 1
            while p < stop:
                member_pcs.append(p)
                mk = m.ops[p][0]
                maux = m.aux[p] if p < len(m.aux) else None
                if mk not in fusable or maux is not None:
                    f("irverify.optimize",
                      f"op {pc} (fixed_run): member at pc {p} "
                      f"(kind {hp.OP_NAMES.get(mk, mk)}, aux={maux!r}) "
                      "is not a plain fixed-layout leaf — the bulk "
                      "lane would misread the wire", pc)
                p, cp = walk(p, depth + 1, axis, uncond)
                for c, k in cp.items():
                    push(counts, c, k)
            if p != stop:
                f("irverify.effect",
                  f"op {pc} (fixed_run): members end at {p}, nops "
                  f"claims {stop}", pc)
            if len(member_pcs) < 2:
                f("irverify.optimize",
                  f"op {pc} (fixed_run): {len(member_pcs)} member(s) "
                  "— a fused header must absorb >= 2 leaves", pc)
            width = sum(fusable.get(m.ops[q][0], 0)
                        for q in member_pcs)
            if b != width:
                f("irverify.optimize",
                  f"op {pc} (fixed_run): b={b} but the members' wire "
                  f"floors sum to {width} — the span pre-check would "
                  "mis-bound the bulk reads", pc)
            want_exact = int(bool(member_pcs) and all(
                m.ops[q][0] in exact_kinds for q in member_pcs))
            if a != want_exact:
                f("irverify.optimize",
                  f"op {pc} (fixed_run): a={a} but exact-width is "
                  f"{want_exact} — a=1 over varint members licenses "
                  "unchecked reads one span check cannot bound", pc)
            if (pad & hp.FLAG_ALWAYS_PRESENT) and not uncond:
                f("irverify.optimize",
                  f"op {pc} (fixed_run): FLAG_ALWAYS_PRESENT under a "
                  "conditional ancestor chain — the bulk lane would "
                  "consume wire bytes for an absent subtree", pc)
        elif kind == hp.OP_NULLABLE:
            # both the live and the null side execute the inner subtree
            # (live decodes, null appends defaults) — same counts
            p, cp = walk(pc + 1, depth + 1, axis, False)
            for c, k in cp.items():
                push(counts, c, k)
            if p != stop:
                f("irverify.effect",
                  f"op {pc} (nullable): inner ends at {p}, nops claims "
                  f"{stop}", pc)
        elif kind == hp.OP_UNION:
            p = pc + 1
            for _k in range(a):
                if p >= stop:
                    f("irverify.effect",
                      f"op {pc} (union): arm {_k} of {a} missing "
                      f"(subtree exhausted at {p})", pc)
                    break
                p, cp = walk(p, depth + 1, axis, False)
                for c, k in cp.items():
                    push(counts, c, k)
            if p != stop:
                f("irverify.effect",
                  f"op {pc} (union): arms end at {p}, nops claims "
                  f"{stop}", pc)
        elif kind in (hp.OP_ARRAY, hp.OP_MAP):
            # the item subtree appends on the ITEM axis: its own
            # exactness boundary; nothing lands on this axis's counts.
            # Region ids run in pre-order, exactly like the lowering's
            rid = next_rid[0]
            next_rid[0] += 1
            if kind == hp.OP_MAP:
                region_check(b, pc, "map-key", rid)
            if pad & hp.FLAG_STR_ITEMS:
                # the optimizer's pre-decided string block lane: the
                # claim must match the engines' own runtime test
                # (item subtree == exactly one OP_STRING leaf)
                item_kind = m.ops[pc + 1][0] if pc + 1 < n else None
                if nops != 2 or item_kind != hp.OP_STRING:
                    f("irverify.optimize",
                      f"op {pc} ({name}): FLAG_STR_ITEMS but the item "
                      f"subtree is not a single string leaf "
                      f"(nops={nops}, item kind={item_kind}) — the "
                      "string block lane would misread the items", pc)
            p, cp = walk(pc + 1, depth + 1, rid, False)
            if kind == hp.OP_MAP:
                push(cp, b)  # the key column, once per item
            check_axis(cp, pc, f"op {pc} ({name}) item axis")
            if p != stop:
                f("irverify.effect",
                  f"op {pc} ({name}): item subtree ends at {p}, nops "
                  f"claims {stop}", pc)
        else:
            if nops != 1:
                f("irverify.effect",
                  f"op {pc} ({name}): leaf with nops={nops}", pc)
        return stop, counts

    end, counts = walk(0, 1)
    if end != n:
        f("irverify.effect",
          f"program has {n} ops but the root subtree ends at {end}")
    check_axis(counts, 0, "row axis")
    orphans = [c for c in range(m.ncols) if c not in owners]
    if orphans:
        f("irverify.effect",
          f"column(s) {orphans} allocated but written by no op — dead "
          "buffers in every decode")
    if max_seen_depth > max_depth:
        f("irverify.effect",
          f"validity/structure chain nests {max_seen_depth} deep, past "
          f"the PYRUHVRO_TPU_MAX_DEPTH walker cap ({max_depth}) — the "
          "fallback oracle would refuse what the VM accepts")
    return findings


def verify_aux_consumption(m: ProgramModel,
                           consumers: Dict[str, List[str]]) -> List[Finding]:
    """Every aux entry's tag must have at least one anchored consumer
    direction (``irverify.effect.dead-aux``)."""
    findings = []
    for pc, aux in enumerate(m.aux):
        if not aux:
            continue
        tag = aux[0]
        dirs = consumers.get(tag)
        if not dirs:
            findings.append(Finding(
                "irverify.effect", m.label,
                f"op {pc}: aux entry {tag!r} is emitted into the "
                "tables but consumed by no direction (dead aux) — "
                "either a consumer lost its read or the emission is "
                "vestigial", pc))
    return findings


# ---------------------------------------------------------------------------
# pass 2: wire progress / termination
# ---------------------------------------------------------------------------


def _min_wire(m: ProgramModel, pc: int) -> Tuple[int, int]:
    """(end_pc, minimum wire bytes one present execution consumes)."""
    hp = _effects()
    kind, a, b, col, nops, _pad = m.ops[pc]
    stop = pc + max(nops, 1)
    if kind in (hp.OP_RECORD, hp.OP_FIXED_RUN):
        # a fused header consumes nothing itself; its members still
        # account their own floors (op.b only SUMMARIZES them)
        total = 0
        p = pc + 1
        while p < stop:
            p, mb = _min_wire(m, p)
            total += mb
        return stop, total
    if kind == hp.OP_NULLABLE:
        # branch varint (1) + min over {null side: 0, live side}
        return stop, 1
    if kind == hp.OP_UNION:
        # tid varint (1) + the cheapest arm
        p = pc + 1
        arm_min = None
        for _ in range(max(a, 1)):
            if p >= stop:
                break
            p, mb = _min_wire(m, p)
            arm_min = mb if arm_min is None else min(arm_min, mb)
        return stop, 1 + (arm_min or 0)
    if kind in (hp.OP_ARRAY, hp.OP_MAP):
        # zero items: one block-count varint (the 0 terminator)
        return stop, 1
    eff = hp.OP_EFFECTS.get(kind)
    if eff is None:
        return stop, 0
    mw = eff["min_wire"]
    return stop, (a if mw == "a" else mw)


def verify_progress(m: ProgramModel,
                    guards: Dict[str, bool]) -> List[Finding]:
    """Every array/map item loop either consumes >= 1 wire byte per
    item (count bounded by the record span) or is reachable only under
    the anchored zero-width budget; block loops terminate on the zero
    count. Returns loop inventory findings."""
    hp = _effects()
    findings: List[Finding] = []
    loops: List[dict] = []

    def walk(pc: int):
        if pc >= len(m.ops):
            return pc
        kind, a, b, col, nops, _pad = m.ops[pc]
        stop = pc + max(nops, 1)
        if kind in (hp.OP_ARRAY, hp.OP_MAP):
            _, item_min = _min_wire(m, pc + 1)
            if kind == hp.OP_MAP:
                item_min += 1  # the key length varint
            zw = item_min == 0
            loops.append({"pc": pc, "kind": hp.OP_NAMES[kind],
                          "item_min_bytes": item_min,
                          "zw_capped": zw})
            if zw and not guards.get("zero_width_budget"):
                findings.append(Finding(
                    "irverify.progress", m.label,
                    f"op {pc} ({hp.OP_NAMES[kind]}): item subtree "
                    "consumes 0 wire bytes and the zero-width budget "
                    "guard (kMaxZeroWidthItems) is not anchored in the "
                    "engines — a 3-byte block header could demand 2^60 "
                    "items (non-terminating/unbounded decode)", pc))
            if not guards.get("block_zero_terminates"):
                findings.append(Finding(
                    "irverify.progress", m.label,
                    f"op {pc} ({hp.OP_NAMES[kind]}): block loop "
                    "zero-count termination is not anchored in the "
                    "engines", pc))
            walk(pc + 1)
            return stop
        if kind in (hp.OP_RECORD, hp.OP_NULLABLE, hp.OP_UNION,
                    hp.OP_FIXED_RUN):
            p = pc + 1
            while p < stop:
                p = walk(p)
            return stop
        return stop

    walk(0)
    verify_progress.last_loops = loops  # inventory for the report
    return findings


# ---------------------------------------------------------------------------
# pass 3: overflow safety (symbolic int32/int64 lanes vs guard anchors)
# ---------------------------------------------------------------------------

# aux-conditional sinks folded in on top of OP_EFFECTS' static ones
_AUX_SINKS = {
    "duration": (("duration_total", ("duration_ms_i64",)),),
    "enum": (("enum_expand", ("enum_expand_2gib",)),),
}


def verify_overflow(m: ProgramModel,
                    guards: Dict[str, bool]) -> List[Finding]:
    hp = _effects()
    findings: List[Finding] = []
    lanes: List[dict] = []

    def check(pc, op_name, lane, needed):
        missing = [g for g in needed if not guards.get(g)]
        lanes.append({"pc": pc, "op": op_name, "lane": lane,
                      "guards": list(needed),
                      "missing": missing})
        if missing:
            findings.append(Finding(
                "irverify.overflow", m.label,
                f"op {pc} ({op_name}): int32 lane {lane!r} is "
                f"unguarded — native guard anchor(s) {missing} not "
                "found in the sources (a value past the bound would "
                "silently wrap at serving-plane scale)", pc))

    has_ops = False
    for pc, row in enumerate(m.ops):
        kind = row[0]
        eff = hp.OP_EFFECTS.get(kind)
        if eff is None:
            continue
        has_ops = True
        name = hp.OP_NAMES[kind]
        for lane, needed in eff["sinks"]:
            check(pc, name, lane, needed)
        if kind == hp.OP_STRING:
            check(pc, name, "fused_offsets", ("fused_str_offsets_i32",))
        if kind in (hp.OP_ARRAY, hp.OP_MAP):
            check(pc, name, "repeated_offsets",
                  ("repeated_offsets_i32",))
        aux = m.aux[pc] if pc < len(m.aux) else None
        if aux:
            for lane, needed in _AUX_SINKS.get(aux[0], ()):
                check(pc, name, lane, needed)
    if has_ops:
        # the encode wire position is a program-level int32 lane
        check(0, "program", "encode_pos", ("encode_pos_i32",))
    verify_overflow.last_lanes = lanes
    return findings


# ---------------------------------------------------------------------------
# pass 4: generic <-> specialized equivalence
# ---------------------------------------------------------------------------


def abstract_trace(m: ProgramModel) -> List[Tuple[int, int, int, tuple]]:
    """The canonical effect trace: (pc, kind, col, aux-signature) in
    walk order — what any correct engine must do, in the order it must
    do it."""
    out = []
    for pc, row in enumerate(m.ops):
        kind, a, b, col, nops, _pad = row
        aux = m.aux[pc] if pc < len(m.aux) else None
        sig: tuple = ()
        if aux:
            if aux[0] == "enum":
                sig = ("enum", len(aux) - 1, tuple(aux[1:]))
            else:
                sig = tuple(aux)
        out.append((pc, kind, col, sig))
    return out


def _effects_trailer(src: str) -> Optional[dict]:
    m = re.search(r"// EFFECTS-v1 (\{.*\})", src)
    if m is None:
        return None
    try:
        return json.loads(m.group(1))
    except ValueError:
        return None


def verify_equivalence(prog, src: Optional[str] = None,
                       label: str = "specialized") -> List[Finding]:
    """Diff the specializer's generated translation unit against the
    generic program it was generated from: re-parsed embedded tables
    (abstract-executed, not byte-diffed), the generators' EFFECTS-v1
    journals vs this module's abstract walk, and a column-reference
    census of the emitted decode/encode bodies — both directions."""
    from ..hostpath.specialize import generate_source

    findings: List[Finding] = []
    gm = ProgramModel.from_host_program(prog, "generic")
    if src is None:
        src = generate_source(prog, "M", with_effects=True)

    sm = ProgramModel.from_generated_source(src, gm.coltypes, label)
    want = abstract_trace(gm)
    got = abstract_trace(sm)
    if len(got) != len(want):
        findings.append(Finding(
            "irverify.equiv", label,
            f"specialized tables carry {len(got)} ops, the generic "
            f"program {len(want)}"))
    else:
        for (wpc, wk, wc, ws), (gpc, gk, gc, gs) in zip(want, got):
            if (wk, wc, ws) != (gk, gc, gs):
                findings.append(Finding(
                    "irverify.equiv", label,
                    f"effect trace diverges at pc {wpc}: generic "
                    f"(kind={wk}, col={wc}, aux={ws!r}) vs specialized "
                    f"(kind={gk}, col={gc}, aux={gs!r})", wpc))
        for i, (wrow, grow) in enumerate(zip(gm.ops, sm.ops)):
            if tuple(wrow[:5]) != tuple(grow[:5]):
                findings.append(Finding(
                    "irverify.equiv", label,
                    f"kOps[{i}] = {tuple(grow[:5])} but the program "
                    f"row is {tuple(wrow[:5])}", i))

    # the generators' own journals: every op handled live exactly once,
    # in program order, with the table's (kind, col)
    trailer = _effects_trailer(src)
    if trailer is None:
        findings.append(Finding(
            "irverify.equiv", label,
            "generated source carries no EFFECTS-v1 trailer (generate "
            "with with_effects=True)"))
    else:
        n = len(gm.ops)
        for direction in ("decode", "encode"):
            events = trailer.get(direction, [])
            live = [(pc, k, c) for mode, pc, k, c in events
                    if mode in ("live", "cond")]
            live_pcs = [pc for pc, _k, _c in live]
            if sorted(live_pcs) != list(range(n)):
                findings.append(Finding(
                    "irverify.equiv", label,
                    f"{direction} generator handled pcs "
                    f"{sorted(set(live_pcs))[:8]}... live "
                    f"{len(live_pcs)} times for {n} ops — every op "
                    "must be emitted live exactly once"))
                continue
            if live_pcs != sorted(live_pcs):
                findings.append(Finding(
                    "irverify.equiv", label,
                    f"{direction} generator emitted live ops out of "
                    "program order"))
            for pc, k, c in live:
                wk, _a, _b, wc = gm.ops[pc][:4]
                if (k, c) != (wk, wc):
                    findings.append(Finding(
                        "irverify.equiv", label,
                        f"{direction} generator journal at pc {pc}: "
                        f"(kind={k}, col={c}) vs program (kind={wk}, "
                        f"col={wc})", pc))

    # column-reference census: every owned column must be referenced in
    # both emitted bodies (a dropped column compiles fine and silently
    # desyncs the cursors)
    hp = _effects()
    owned = set()
    for row in gm.ops:
        kind, _a, b, col = row[0], row[1], row[2], row[3]
        if col >= 0:
            owned.add(col)
        if kind == hp.OP_MAP and b >= 0:
            owned.add(b)
    dec_m = re.search(
        r"inline void decode_record\(.*?\n\}", src, flags=re.S)
    enc_m = re.search(r"struct EncRec \{.*?\n\};", src, flags=re.S)
    for direction, bm in (("decode", dec_m), ("encode", enc_m)):
        if bm is None:
            findings.append(Finding(
                "irverify.equiv", label,
                f"could not locate the {direction} body in the "
                "generated source"))
            continue
        refs = {int(c) for c in re.findall(r"\bC(\d+)\b", bm.group(0))}
        missing = sorted(owned - refs)
        if missing:
            findings.append(Finding(
                "irverify.equiv", label,
                f"{direction} body never references column(s) "
                f"{missing} the program writes — cursor desync", 0))
    return findings


# ---------------------------------------------------------------------------
# the combined per-program verdict
# ---------------------------------------------------------------------------


def verify_program(prog, guards: Dict[str, bool],
                   consumers: Dict[str, List[str]],
                   label: str = "program",
                   equivalence: bool = True,
                   max_depth: Optional[int] = None) -> List[Finding]:
    m = ProgramModel.from_host_program(prog, label)
    findings = verify_structure(m, max_depth=max_depth)
    findings += verify_aux_consumption(m, consumers)
    findings += verify_progress(m, guards)
    findings += verify_overflow(m, guards)
    if equivalence:
        findings += verify_equivalence(prog, label=label)
    return findings


def verify_optimized(orig, opt, guards: Dict[str, bool],
                     consumers: Dict[str, List[str]],
                     label: str = "optimized") -> List[Finding]:
    """The superoptimizer's equivalence oracle
    (``hostpath/optimize.py``). The optimized program must (1) pass
    every abstract-interpretation pass on its own — including the
    ``irverify.optimize`` re-derivation of each fused header's operand
    claims and flag bits — and (2) strip back to the ORIGINAL program
    byte-for-byte (headers spliced out, flags cleared, ancestor
    ``nops`` restored): a rewrite that cannot round-trip is by
    definition not effect-preserving. Zero findings proves the
    rewrite; ANY finding makes the caller reject the program (it is
    counted, never run)."""
    findings = verify_program(opt, guards, consumers, label=label,
                              equivalence=False)
    try:
        from ..hostpath.optimize import strip_optimizations

        stripped = strip_optimizations(opt)
    except Exception as e:
        findings.append(Finding(
            "irverify.optimize", label,
            f"optimized program does not strip back to a raw program: "
            f"{type(e).__name__}: {e}"))
        return findings
    got = [tuple(int(x) for x in row) for row in stripped.ops]
    want = [tuple(int(x) for x in row) for row in orig.ops]
    if got != want:
        i = next((k for k, (x, y) in enumerate(zip(got, want))
                  if x != y), min(len(got), len(want)))
        findings.append(Finding(
            "irverify.optimize", label,
            f"strip(optimized) != original program: {len(got)} vs "
            f"{len(want)} ops, first divergence at stripped pc {i} — "
            "the rewrite reordered or altered a member op", i))

    def norm_aux(p, count):
        ax = tuple(p.op_aux or ())
        return ax if ax else (None,) * count

    if norm_aux(stripped, len(got)) != norm_aux(orig, len(want)):
        findings.append(Finding(
            "irverify.optimize", label,
            "strip(optimized) aux table != original aux table — the "
            "rewrite moved or dropped a logical-type fact"))
    if [int(c) for c in stripped.coltypes] != \
            [int(c) for c in orig.coltypes]:
        findings.append(Finding(
            "irverify.optimize", label,
            "strip(optimized) coltypes != original coltypes"))
    return findings


# ---------------------------------------------------------------------------
# the schema-construct lattice driver
# ---------------------------------------------------------------------------

# every construct the lowering can emit, each tagged with the op kinds
# it covers; names are uniquified per lattice point (Avro named types)
_CONSTRUCTS = [
    ("int", lambda u: '"int"'),
    ("long", lambda u: '"long"'),
    ("float", lambda u: '"float"'),
    ("double", lambda u: '"double"'),
    ("boolean", lambda u: '"boolean"'),
    ("string", lambda u: '"string"'),
    ("uuid", lambda u: '{"type": "string", "logicalType": "uuid"}'),
    ("bytes", lambda u: '"bytes"'),
    ("dec_bytes", lambda u: '{"type": "bytes", "logicalType": '
                            '"decimal", "precision": 10, "scale": 2}'),
    ("enum", lambda u: '{"type": "enum", "name": "E%s", "symbols": '
                       '["A", "B", "C"]}' % u),
    ("null", lambda u: '"null"'),
    ("nullable", lambda u: '["null", "int"]'),
    ("union", lambda u: '["int", "string", "null"]'),
    ("array", lambda u: '{"type": "array", "items": "int"}'),
    ("map", lambda u: '{"type": "map", "values": "string"}'),
    ("fixed", lambda u: '{"type": "fixed", "name": "F%s", "size": 8}'
                        % u),
    ("duration", lambda u: '{"type": "fixed", "name": "Du%s", "size": '
                           '12, "logicalType": "duration"}' % u),
    ("dec_fixed", lambda u: '{"type": "fixed", "name": "Df%s", "size": '
                            '16, "logicalType": "decimal", '
                            '"precision": 20, "scale": 4}' % u),
    ("record", lambda u: '{"type": "record", "name": "Sub%s", '
                         '"fields": [{"name": "x", "type": "int"}]}'
                         % u),
    # optimizer coverage: records whose adjacent fixed-layout leaves
    # fuse into OP_FIXED_RUN — exact-width (bulk-lane a=1) and
    # varint-mixed (dispatch-only a=0) — so the lattice verifies the
    # fused-op programs the engines actually execute, not just the raw
    # lowerings
    ("exact_run_rec", lambda u: '{"type": "record", "name": "Xr%s", '
                                '"fields": [{"name": "a", "type": '
                                '"double"}, {"name": "b", "type": '
                                '"float"}, {"name": "c", "type": '
                                '"boolean"}]}' % u),
    ("varint_run_rec", lambda u: '{"type": "record", "name": "Vr%s", '
                                 '"fields": [{"name": "a", "type": '
                                 '"long"}, {"name": "b", "type": '
                                 '"int"}, {"name": "c", "type": '
                                 '"double"}]}' % u),
]

_UNION_LIKE = ("nullable", "union")


def lattice_depths() -> Tuple[int, int, int]:
    """Lattice depth samples derived from the shipped walker cap: the
    deepest sample nests to cap - 4 (the wrapping record/union
    constructs add up to 3 more levels), so the deepest verified
    points track the cap instead of silently colliding with it."""
    cap = _default_max_depth()
    return (1, 8, max(3, cap - 4))


def lattice_points(depths: Optional[Sequence[int]] = None) -> List[dict]:
    """The full schema-construct lattice: construct x nullable-wrap x
    union-position x nesting depth. Avro-invalid combinations (a union
    may not immediately contain a union; the null wrap duplicates a
    null arm) are enumerated with their skip reason so coverage is
    measured over the CONSTRUCTIBLE set, with nothing silently
    dropped."""
    if depths is None:
        depths = lattice_depths()
    points = []
    uid = 0
    for cname, mk in _CONSTRUCTS:
        for nullable in (False, True):
            for in_union in (False, True):
                for depth in depths:
                    uid += 1
                    point = {
                        "id": f"{cname}/null={int(nullable)}/"
                              f"union={int(in_union)}/d={depth}",
                        "construct": cname, "nullable": nullable,
                        "in_union": in_union, "depth": depth,
                    }
                    skip = None
                    if cname in _UNION_LIKE and (nullable or in_union):
                        skip = ("Avro forbids a union immediately "
                                "inside a union")
                    elif cname == "null" and nullable:
                        skip = ('["null", "null"] duplicates the null '
                                "arm")
                    if skip:
                        point["status"] = "skipped-invalid"
                        point["reason"] = skip
                        points.append(point)
                        continue
                    inner = mk(uid)
                    if nullable and in_union:
                        # null + construct + partner: nullable inside a
                        # true multi-arm union
                        typ = f'["null", {inner}, "long"]' \
                            if cname != "long" else \
                            f'["null", {inner}, "double"]'
                    elif nullable:
                        typ = f'["null", {inner}]'
                    elif in_union:
                        partners = [p for p in ('"long"', '"double"',
                                                '"boolean"')
                                    if p.strip('"') != cname][:2]
                        typ = f'[{inner}, {", ".join(partners)}]'
                    else:
                        typ = inner
                    for d in range(depth - 1):
                        typ = ('{"type": "record", "name": '
                               f'"D{uid}_{d}", "fields": [{{"name": '
                               f'"f", "type": {typ}}}]}}')
                    point["schema"] = (
                        '{"type": "record", "name": "Top%d", "fields":'
                        ' [{"name": "v", "type": %s}]}' % (uid, typ))
                    points.append(point)
    return points


def run_lattice(guards: Dict[str, bool],
                consumers: Dict[str, List[str]],
                depths: Optional[Sequence[int]] = None,
                equivalence: bool = True,
                optimizer: bool = True):
    """Verify every constructible lattice point; returns
    (findings, report-dict with per-point verdicts + coverage). With
    ``optimizer`` (the default) every point's program is ALSO run
    through the superoptimizer — whose internal oracle re-verifies the
    rewritten program against this module's passes — so the lattice
    covers the fused-op programs the engines actually execute, and a
    rewrite the oracle rejects on any constructible schema is a gate
    finding."""
    from ..hostpath.program import lower_host
    from ..schema.parser import parse_schema

    findings: List[Finding] = []
    points = lattice_points(depths)
    constructible = verified = optimized = fused_runs = 0
    for point in points:
        if point.get("status") == "skipped-invalid":
            continue
        constructible += 1
        label = f"lattice:{point['id']}"
        try:
            prog = lower_host(parse_schema(point["schema"]))
        except Exception as e:  # lowering refused a constructible point
            point["status"] = "error"
            point["reason"] = f"{type(e).__name__}: {e}"
            findings.append(Finding(
                "irverify.lattice", label,
                f"constructible lattice point failed to lower: {e}"))
            continue
        fs = verify_program(prog, guards, consumers, label=label,
                            equivalence=equivalence)
        if optimizer:
            from ..hostpath.optimize import optimize_program

            try:
                _opt, ost = optimize_program(prog)
            except Exception as e:
                fs.append(Finding(
                    "irverify.optimize", label,
                    f"optimizer crashed on a lattice point: "
                    f"{type(e).__name__}: {e}"))
            else:
                if ost.applied or ost.rejected:
                    point["optimizer"] = {
                        "applied": ost.applied,
                        "fused_runs": ost.fused_runs,
                        "always_present": ost.always_present,
                        "str_items": ost.str_items,
                        "rejected": ost.rejected,
                    }
                if ost.applied:
                    optimized += 1
                    fused_runs += ost.fused_runs
                if ost.rejected:
                    fs.append(Finding(
                        "irverify.optimize", label,
                        "optimizer rewrite rejected by the "
                        "equivalence oracle on a constructible "
                        "lattice point — the rewrite pass is unsound "
                        f"here: {ost.findings[:2]!r}"))
        if fs:
            point["status"] = "failed"
            point["findings"] = [f.to_dict() for f in fs]
            findings.extend(fs)
        else:
            point["status"] = "verified"
            verified += 1
    coverage = {
        "points": len(points),
        "constructible": constructible,
        "verified": verified,
        "skipped_invalid": sum(1 for p in points
                               if p.get("status") == "skipped-invalid"),
        "coverage_pct": round(100.0 * verified / constructible, 2)
        if constructible else 0.0,
    }
    if optimizer:
        coverage["optimized"] = optimized
        coverage["fused_runs"] = fused_runs
    return findings, {"points": points, "coverage": coverage}


# ---------------------------------------------------------------------------
# mutation self-test: every invariant class must turn red on a seeded
# perturbation — the verifier is only trustworthy while this passes
# ---------------------------------------------------------------------------

_REF_SCHEMA = """
{"type": "record", "name": "MutRef", "fields": [
  {"name": "i",   "type": "int"},
  {"name": "s",   "type": "string"},
  {"name": "e",   "type": {"type": "enum", "name": "ME",
                           "symbols": ["A", "B"]}},
  {"name": "opt", "type": ["null", "long"]},
  {"name": "un",  "type": ["int", "string", "null"]},
  {"name": "arr", "type": {"type": "array", "items": "int"}},
  {"name": "m",   "type": {"type": "map", "values": "string"}}
]}
"""

_ZW_SCHEMA = """
{"type": "record", "name": "ZwRef", "fields": [
  {"name": "a", "type": {"type": "array", "items": "null"}}
]}
"""

# optimizer-mutation reference: an unconditional exact-width run (x, y,
# k — fused with a=1 + FLAG_ALWAYS_PRESENT) plus a second run under a
# nullable chain (p, q — fused but NOT always-present)
_OPT_SCHEMA = """
{"type": "record", "name": "OptRef", "fields": [
  {"name": "x", "type": "double"},
  {"name": "y", "type": "float"},
  {"name": "k", "type": "boolean"},
  {"name": "opt", "type": ["null", {"type": "record", "name": "OInner",
    "fields": [{"name": "p", "type": "double"},
               {"name": "q", "type": "double"}]}]}
]}
"""


def _leaf_pcs(m: ProgramModel, kinds) -> List[int]:
    return [pc for pc, row in enumerate(m.ops) if row[0] in kinds]


def run_mutation_selftest(guards: Dict[str, bool],
                          consumers: Dict[str, List[str]]):
    """Seeded perturbations, one per invariant class (plus spares):
    each must be caught by the pass that owns its class. Returns
    (findings — nonempty iff a mutation ESCAPED —, report rows)."""
    import copy

    from ..hostpath.program import lower_host
    from ..hostpath.specialize import generate_source
    from ..schema.parser import parse_schema

    hp = _effects()
    prog = lower_host(parse_schema(_REF_SCHEMA))
    zw_prog = lower_host(parse_schema(_ZW_SCHEMA))
    base = ProgramModel.from_host_program(prog, "mutation")

    def model(**over):
        m = ProgramModel(copy.deepcopy(base.ops), list(base.coltypes),
                         copy.deepcopy(base.aux), "mutation",
                         col_regions=list(base.col_regions or []))
        for k, v in over.items():
            setattr(m, k, v)
        return m

    cases = []

    # -- effect class -----------------------------------------------------
    def col_transpose():
        m = model()
        i_pc = _leaf_pcs(m, (hp.OP_INT,))[0]
        s_pc = _leaf_pcs(m, (hp.OP_STRING,))[0]
        oi, os_ = list(m.ops[i_pc]), list(m.ops[s_pc])
        oi[3], os_[3] = os_[3], oi[3]
        m.ops[i_pc], m.ops[s_pc] = tuple(oi), tuple(os_)
        return verify_structure(m)

    def coltype_drift():
        m = model()
        i_pc = _leaf_pcs(m, (hp.OP_INT,))[0]
        m.coltypes[m.ops[i_pc][3]] = hp.COL_F64
        return verify_structure(m)

    def aux_arity():
        m = model()
        e_pc = _leaf_pcs(m, (hp.OP_ENUM,))[0]
        aux = list(m.aux)
        aux[e_pc] = ("enum", b"A")  # one symbol dropped vs op.a == 2
        m.aux = tuple(aux)
        return verify_structure(m)

    def aux_misplaced():
        m = model()
        i_pc = _leaf_pcs(m, (hp.OP_INT,))[0]
        aux = list(m.aux)
        aux[i_pc] = ("duration",)
        m.aux = tuple(aux)
        return verify_structure(m)

    def depth_cap():
        m = model()
        return verify_structure(m, max_depth=2)

    def dead_aux():
        m = model()
        stripped = {t: [] for t in consumers}  # no consumer anchored
        return verify_aux_consumption(m, stripped)

    def region_drift():
        # a lowering bug allocating an item column on the row region:
        # the per-element append cadence would desync the assembler
        m = model()
        a_pc = _leaf_pcs(m, (hp.OP_ARRAY,))[0]
        item_col = m.ops[a_pc + 1][3]
        m.col_regions[item_col] = 0
        return verify_structure(m)

    cases += [("effect", "col-transpose", col_transpose,
               "irverify.effect"),
              ("effect", "region-drift", region_drift,
               "irverify.effect"),
              ("effect", "coltype-drift", coltype_drift,
               "irverify.effect"),
              ("effect", "aux-arity", aux_arity, "irverify.effect"),
              ("effect", "aux-misplaced", aux_misplaced,
               "irverify.effect"),
              ("effect", "depth-cap", depth_cap, "irverify.effect"),
              ("effect", "dead-aux", dead_aux, "irverify.effect")]

    # -- progress class ---------------------------------------------------
    def nops_corrupt():
        m = model()
        a_pc = _leaf_pcs(m, (hp.OP_ARRAY,))[0]
        row = list(m.ops[a_pc + 1])
        row[4] = 0  # the item subtree never advances the walk
        m.ops[a_pc + 1] = tuple(row)
        return verify_structure(m)

    def zw_anchor_strip():
        zm = ProgramModel.from_host_program(zw_prog, "mutation")
        g = dict(guards)
        g["zero_width_budget"] = False  # = the C++ cap check deleted
        return verify_progress(zm, g)

    cases += [("progress", "nops-corrupt", nops_corrupt,
               "irverify.progress"),
              ("progress", "zw-anchor-strip", zw_anchor_strip,
               "irverify.progress")]

    # -- overflow class ---------------------------------------------------
    def strlen_anchor_strip():
        g = dict(guards)
        g["string_len_i32"] = False  # = the 2GiB lens check deleted
        return verify_overflow(model(), g)

    def running_anchor_strip():
        g = dict(guards)
        g["offs_running_i32"] = False
        return verify_overflow(model(), g)

    cases += [("overflow", "strlen-anchor-strip", strlen_anchor_strip,
               "irverify.overflow"),
              ("overflow", "running-anchor-strip",
               running_anchor_strip, "irverify.overflow")]

    # -- equivalence class ------------------------------------------------
    def codegen_col_swap():
        import numpy as np

        mut = copy.deepcopy(prog)
        ops = np.array(mut.ops, copy=True)
        pcs = [pc for pc in range(len(ops))
               if int(ops[pc][0]) in (hp.OP_INT, hp.OP_LONG)]
        i_pc = pcs[0]
        l_pc = _leaf_pcs(base, (hp.OP_LONG,))[0]
        ops[i_pc][3], ops[l_pc][3] = int(ops[l_pc][3]), int(ops[i_pc][3])
        mut.ops = ops
        src = generate_source(mut, "M", with_effects=True)
        return verify_equivalence(prog, src=src)

    def kops_row_tamper():
        src = generate_source(prog, "M", with_effects=True)
        m = re.search(r"static const Op kOps\[\] = \{\n(    \{[^\n]*\n)",
                      src)
        row = m.group(1)
        tampered = re.sub(r"\{(-?\d+),", lambda g: "{%d," %
                          ((int(g.group(1)) + 1) % 16), row, count=1)
        src = src.replace(row, tampered, 1)
        return verify_equivalence(prog, src=src)

    cases += [("equiv", "codegen-col-swap", codegen_col_swap,
               "irverify.equiv"),
              ("equiv", "kops-row-tamper", kops_row_tamper,
               "irverify.equiv")]

    # -- optimize class (superoptimizer rewrites vs the oracle) -----------
    from ..hostpath import optimize as hopt

    opt_raw = lower_host(parse_schema(_OPT_SCHEMA))
    opt_prog, _ost = hopt.optimize_program(opt_raw, verify=False)

    def _mutated_opt(mutfn):
        import numpy as np

        mut = copy.deepcopy(opt_prog)
        ops = np.array(mut.ops, copy=True)
        mutfn(ops)
        mut.ops = ops
        return verify_optimized(opt_raw, mut, guards, consumers)

    def _run_pcs(ops):
        return [i for i in range(len(ops))
                if int(ops[i][0]) == hp.OP_FIXED_RUN]

    def fused_span_tamper():
        # a rewrite that mis-sums the members' wire floors: the bulk
        # lane's span pre-check would admit reads past the record
        def mt(ops):
            ops[_run_pcs(ops)[0]][2] += 1
        return _mutated_opt(mt)

    def reordered_rewrite():
        # members swapped inside the fused run: structure still tiles
        # and the span sum is unchanged — only strip-equality sees it
        def mt(ops):
            pc = _run_pcs(ops)[0]
            ops[[pc + 1, pc + 2]] = ops[[pc + 2, pc + 1]]
        return _mutated_opt(mt)

    def always_present_overclaim():
        # the nullable-chain run flagged always-present: the bulk lane
        # would consume wire bytes when the record is absent
        def mt(ops):
            ops[_run_pcs(ops)[-1]][5] |= hp.FLAG_ALWAYS_PRESENT
        return _mutated_opt(mt)

    cases += [("optimize", "fused-span-tamper", fused_span_tamper,
               "irverify.optimize"),
              ("optimize", "reordered-rewrite", reordered_rewrite,
               "irverify.optimize"),
              ("optimize", "always-present-overclaim",
               always_present_overclaim, "irverify.optimize")]

    findings: List[Finding] = []
    rows = []
    for cls, name, fn, want_rule in cases:
        try:
            fs = fn()
        except Exception as e:  # a crashing pass is NOT a catch
            fs = []
            crash = f"{type(e).__name__}: {e}"
        else:
            crash = None
        caught = any(f.rule.startswith(want_rule) for f in fs)
        rows.append({"class": cls, "name": name, "caught": caught,
                     "rule": want_rule,
                     "findings": len(fs), "crash": crash})
        if not caught:
            findings.append(Finding(
                "irverify.selftest", "pyruhvro_tpu_torch/analysis/irverify.py",
                f"seeded {cls} mutation {name!r} escaped the verifier"
                + (f" (pass crashed: {crash})" if crash else "")))
    return findings, {"cases": rows,
                      "all_caught": all(r["caught"] for r in rows)}


# ---------------------------------------------------------------------------
# the gate entry
# ---------------------------------------------------------------------------


def run_ir_verification(root: str,
                        depths: Optional[Sequence[int]] = None,
                        selftest: bool = True,
                        equivalence: bool = True):
    """The full IR verification run for ``analysis_gate.py --ir``:
    guard-anchor scan, the schema-construct lattice, the aux
    consumption matrix, and the mutation self-test. Returns
    (findings, IR_VERIFY_REPORT-shaped dict). The report is a
    COMMITTED artifact: it carries no timestamp or other run-varying
    field, so a re-run on an unchanged tree is byte-identical and
    leaves the checkout clean."""
    guards = scan_native_guards(root)
    consumers = scan_aux_consumers(root)
    findings: List[Finding] = []

    # a guard named by the contract but anchored nowhere is itself a
    # finding even before any program references it
    for g, ok in guards.items():
        if not ok:
            findings.append(Finding(
                "irverify.overflow", "pyruhvro_tpu_torch/analysis/irverify.py",
                f"guard anchor {g!r} not found in the native sources — "
                "either the range check was deleted or the anchor "
                "pattern rotted (update GUARD_ANCHORS with the code)"))

    lat_findings, lattice = run_lattice(guards, consumers,
                                        depths=depths,
                                        equivalence=equivalence)
    findings += lat_findings

    mut = {"cases": [], "all_caught": None}
    if selftest:
        mut_findings, mut = run_mutation_selftest(guards, consumers)
        findings += mut_findings

    report = {
        "schema_version": 1,
        "generated_by": "pyruhvro_tpu_torch.analysis.irverify",
        "guards": guards,
        "aux_consumers": consumers,
        "aux_audit_notes": {f"{t}/{d}": note for (t, d), note
                            in AUX_AUDIT_NOTES.items()},
        "lattice": lattice,
        "mutation": mut,
        "finding_count": len(findings),
        "findings": [f.to_dict() for f in findings],
    }
    return findings, report
