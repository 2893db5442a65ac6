"""Schema-specialized native codecs: HostProgram → straight-line C++
(copy of ``pyruhvro_tpu/hostpath/specialize.py``, whole but the
departures at the end).

The bytecode VM (``csrc/host/host_codec.cpp``) serves any schema with
zero compile latency, but pays switch dispatch + tree recursion per
field per record. When a schema gets hot (``codec.NativeHostCodec``'s
row threshold, ``PYRUHVRO_TPU_SPECIALIZE_ROWS``), its opcode program is
unrolled into a dedicated C++ translation unit — every column index,
branch index, enum cardinality and fixed size a compile-time constant,
no dispatch, no recursion — compiled with the same flags as the VM and
cached on disk keyed by the generated source (so a schema compiles once
per machine).

Correctness story: the generated code and the VM execute the SAME
per-field leaf helpers and the SAME shard/boundary machinery
(``csrc/host/host_vm_core.h``); only the walk between fields is
specialized. The generator mirrors ``Vm::exec`` case-for-case, and
``tests/test_torch_specialize.py`` runs both engines against the oracle
and holds :func:`generate_source` to the reference's text.

Every loaded engine registers in the ``engines`` cache plane
(:mod:`..runtime.cachelife`, the ``cache.engines`` probe of
:mod:`..runtime.memacct`, ``PYRUHVRO_TPU_CACHE_MAX_ENGINES``); an
evicted engine is re-admitted on the next call by importing its
existing file again, with no second ``g++`` run.

Departures from the reference (``ROADMAP.md`` (c) 7):

* Units and their modules live under ``build/pyruhvro_tpu_torch/_spec/``
  (git-ignored), built by :func:`..runtime.native.compile_extension`
  with ``-I csrc/host``, so the unit includes ``arrow_decode_core.h``
  by name. The module name hashes the unit, ``csrc/host/*.h`` and what
  :func:`..runtime.native.build_path` hashes besides (interpreter,
  flags, :func:`..runtime.native.cpu_tag`: a ``-march=native`` build
  is never reused on another CPU), and is prefixed
  ``_pyruhvro_torch_spec_`` so that it never shadows the reference's.
* A failed ``g++`` build raises ``RuntimeError`` into the call, as
  every native build of the port does; the reference returns ``None``
  and pins the interpreter.
* Under either sanitizer flavour (``PYRUHVRO_TPU_NATIVE_SAN``,
  ``PYRUHVRO_TPU_TSAN``) :func:`load_specialized` raises
  ``RuntimeError``, where the reference returns ``None``: the engine
  cache does not key the flavour, so an instrumented engine would serve
  later plain runs. ``codec.NativeHostCodec`` pins the interpreter under
  either knob, as it does under ``PYRUHVRO_TPU_NATIVE_PROF=1``.
* The generated unit's first line names this module.
"""

from __future__ import annotations

import hashlib
import os
import sys
import sysconfig
import threading
import time
import weakref
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..runtime import schedtest
from .program import HostProgram

__all__ = ["generate_source", "load_specialized", "touch_engine",
           "bind_engine_user", "module_name", "spec_dir"]

# the shared cores the generated units include, by name (-I of this dir)
_HOST_DIR = Path(__file__).resolve().parents[1] / "csrc" / "host"
_CORE = "arrow_decode_core.h"

# ops indices (kind, a, b, col, nops, pad) — see hostpath/program.py
from .program import (  # noqa: E402  (kept near use for readability)
    OP_RECORD, OP_INT, OP_LONG, OP_FLOAT, OP_DOUBLE, OP_BOOL,
    OP_STRING, OP_ENUM, OP_NULL, OP_NULLABLE, OP_UNION,
    OP_ARRAY, OP_MAP, OP_FIXED, OP_DEC_BYTES, OP_DEC_FIXED,
)


class _GenBase:
    """Shared emitter scaffolding for the two code generators.

    ``present`` threads through ``gen`` as the literal ``True`` (field
    is statically reached — the dominant case, which compiles to
    branchless straight-line reads), the literal ``False`` (field is
    statically ABSENT: emit pure default-appends / cursor-skips with no
    wire access — the branch-table arms), or the name of a C ``bool``
    local minted by an enclosing nullable/union.
    """

    # branch-table / two-version codegen is skipped for subtrees larger
    # than this many ops: each union arm (or nullable side) duplicates
    # the whole subtree body, so the cap bounds code-size blowup
    _BRANCH_TABLE_MAX_OPS = 48

    def __init__(self, ops: np.ndarray, indent: int):
        self.ops = ops
        self.lines: List[str] = []
        self.indent = indent
        self.uid = 0
        self.cols_used: set = set()
        # effect-event journal: every subtree the generator
        # emits records (mode, pc, kind, col) — "live" for the
        # present=True spine, "cond" for bodies guarded by a minted
        # bool, "default" for statically-absent bodies. The IR verifier
        # diffs this journal (and the EFFECTS-v1 trailer rendering it)
        # against its own abstract execution of the program, which
        # catches codegen drift the embedded-table diff cannot (a body
        # that pushes the wrong column still embeds the right table).
        self.effects: List[tuple] = []

    def note(self, mode: str, pc: int) -> None:
        kind, _a, _b, col = (int(x) for x in self.ops[pc][:4])
        self.effects.append((mode, pc, kind, col))

    def w(self, line: str) -> None:
        self.lines.append("  " * self.indent + line)

    def c(self, col: int) -> str:
        self.cols_used.add(col)
        return f"C{col}"

    def fresh(self) -> int:
        self.uid += 1
        return self.uid

    def subtree_branchy(self, pc: int) -> bool:
        """Does the subtree at ``pc`` contain nullable/union nodes?
        Two-version nullable codegen is limited to branch-free inners so
        nesting cannot double code size per level."""
        stop = pc + int(self.ops[pc][4])
        for q in range(pc, stop):
            if int(self.ops[q][0]) in (OP_NULLABLE, OP_UNION):
                return True
        return False


class _Gen(_GenBase):
    """Emit the decode body for one opcode subtree."""

    def __init__(self, ops: np.ndarray):
        super().__init__(ops, indent=1)

    def gen_default(self, pc: int) -> int:
        """The statically-ABSENT body: pure default appends, no wire
        reads — what ``Vm::exec(present=false)`` does per row, unrolled.
        The branch-table union arms and the null side of two-version
        nullables are built from this."""
        self.note("default", pc)
        kind, a, b, col, nops, _pad = (int(x) for x in self.ops[pc])
        if kind == OP_RECORD:
            q = pc + 1
            stop = pc + nops
            while q < stop:
                q = self.gen_default(q)
            return q
        if kind in (OP_INT, OP_ENUM):
            self.w(f"{self.c(col)}.i32.push_back(0);")
            return pc + 1
        if kind == OP_LONG:
            self.w(f"{self.c(col)}.i64.push_back(0);")
            return pc + 1
        if kind == OP_FLOAT:
            self.w(f"{self.c(col)}.f32.push_back(0.f);")
            return pc + 1
        if kind == OP_DOUBLE:
            self.w(f"{self.c(col)}.f64.push_back(0.0);")
            return pc + 1
        if kind == OP_BOOL:
            self.w(f"{self.c(col)}.u8.push_back(0);")
            return pc + 1
        if kind == OP_STRING:
            self.w(f"{self.c(col)}.i32.push_back(0);")
            return pc + 1
        if kind == OP_FIXED:
            self.w(f"{self.c(col)}.u8.append_fill({a}, 0);")
            return pc + 1
        if kind in (OP_DEC_BYTES, OP_DEC_FIXED):
            self.w(f"{self.c(col)}.u8.append_fill(16, 0);")
            return pc + 1
        if kind == OP_NULL:
            return pc + 1
        if kind == OP_NULLABLE:
            self.w(f"{self.c(col)}.u8.push_back(0);")
            return self.gen_default(pc + 1)
        if kind == OP_UNION:
            self.w(f"{self.c(col)}.i32.push_back(0);")
            q = pc + 1
            for _ in range(a):
                q = self.gen_default(q)
            return q
        if kind in (OP_ARRAY, OP_MAP):
            offs = self.c(col)
            self.w(f"{offs}.i32.push_back({offs}.running);")
            return pc + 1 + int(self.ops[pc + 1][4])
        raise AssertionError(f"unknown op kind {kind}")  # pragma: no cover

    def gen(self, pc: int, present) -> int:
        """Generate code for the subtree at ``pc``; return next pc.
        Mirrors ``Vm::exec`` (host_codec.cpp) case-for-case."""
        if present is False:
            return self.gen_default(pc)
        self.note("live" if present is True else "cond", pc)
        kind, a, b, col, nops, _pad = (int(x) for x in self.ops[pc])
        p = "true" if present is True else present

        if kind == OP_RECORD:
            q = pc + 1
            stop = pc + nops
            while q < stop:
                q = self.gen(q, present)
            return q

        if kind == OP_INT:
            v = "r.read_int()"
            self.w(f"{self.c(col)}.i32.push_back("
                   + (v if present is True else f"{p} ? {v} : 0") + ");")
            return pc + 1
        if kind == OP_LONG:
            v = "r.read_zigzag()"
            self.w(f"{self.c(col)}.i64.push_back("
                   + (v if present is True else f"{p} ? {v} : 0") + ");")
            return pc + 1
        if kind in (OP_FLOAT, OP_DOUBLE):
            ty, nb, fld = (("float", 4, "f32") if kind == OP_FLOAT
                           else ("double", 8, "f64"))
            u = self.fresh()
            self.w(f"{ty} v{u} = 0;")
            rd = f"r.read_fixed(&v{u}, {nb});"
            self.w(rd if present is True else f"if ({p}) {rd}")
            self.w(f"{self.c(col)}.{fld}.push_back(v{u});")
            return pc + 1
        if kind == OP_BOOL:
            u = self.fresh()
            self.w(f"uint8_t v{u} = 0;")
            body = (f"if (r.cur >= r.end) r.err |= ERR_OVERRUN; "
                    f"else {{ v{u} = r.base[r.cur++]; "
                    f"if (v{u} > 1) r.err |= ERR_BAD_BOOL; }}")
            self.w(body if present is True else f"if ({p}) {{ {body} }}")
            self.w(f"{self.c(col)}.u8.push_back(v{u});")
            return pc + 1
        if kind == OP_STRING:
            self.w(f"rd_string({self.c(col)}, r, {p});")
            return pc + 1
        if kind == OP_FIXED:
            self.w(f"rd_fixed({self.c(col)}, r, {p}, {a});")
            return pc + 1
        if kind == OP_DEC_BYTES:
            self.w(f"rd_decimal({self.c(col)}, r, {p}, -1);")
            return pc + 1
        if kind == OP_DEC_FIXED:
            self.w(f"rd_decimal({self.c(col)}, r, {p}, {a});")
            return pc + 1
        if kind == OP_ENUM:
            u = self.fresh()
            self.w(f"int64_t v{u} = 0;")
            body = (f"v{u} = r.read_zigzag(); "
                    f"if (v{u} < 0 || v{u} >= {a}) "
                    f"{{ r.err |= ERR_BAD_ENUM; v{u} = 0; }}")
            self.w(body if present is True else f"if ({p}) {{ {body} }}")
            self.w(f"{self.c(col)}.i32.push_back((int32_t)v{u});")
            return pc + 1
        if kind == OP_NULL:
            return pc + 1

        if kind == OP_NULLABLE:
            u = self.fresh()
            two_version = (
                present is True
                and nops <= self._BRANCH_TABLE_MAX_OPS
                and not self.subtree_branchy(pc + 1)
            )
            self.w(f"uint8_t valid{u} = 0; bool p{u} = false;")
            body = (f"int64_t br{u} = r.read_zigzag(); "
                    f"if (br{u} == {1 - a}) "
                    f"{{ valid{u} = 1; p{u} = true; }} "
                    f"else if (br{u} != {a}) r.err |= ERR_BAD_BRANCH;")
            self.w("{ " + body + " }" if present is True
                   else f"if ({p}) {{ {body} }}")
            self.w(f"{self.c(col)}.u8.push_back(valid{u});")
            if not two_version:
                return self.gen(pc + 1, f"p{u}")
            # hoist the null-branch check out of the per-leaf path: the
            # live side compiles branchless, the null side is pure
            # default stores (fast lane; bounded by the op cap
            # and branch-free inners so nesting cannot blow up code size)
            self.w(f"(void)p{u};")
            self.w(f"if (valid{u}) {{")
            self.indent += 1
            end = self.gen(pc + 1, True)
            self.indent -= 1
            self.w("} else {")
            self.indent += 1
            self.gen_default(pc + 1)
            self.indent -= 1
            self.w("}")
            return end

        if kind == OP_UNION:
            u = self.fresh()
            self.w(f"int32_t tid{u} = 0;")
            body = (f"int64_t br{u} = r.read_zigzag(); "
                    f"if (br{u} < 0 || br{u} >= {a}) "
                    f"{{ r.err |= ERR_BAD_BRANCH; br{u} = 0; }} "
                    f"tid{u} = (int32_t)br{u};")
            self.w("{ " + body + " }" if present is True
                   else f"if ({p}) {{ {body} }}")
            self.w(f"{self.c(col)}.i32.push_back(tid{u});")
            if nops <= self._BRANCH_TABLE_MAX_OPS:
                # branch-table dispatch: one switch per row; the
                # selected arm decodes straight-line while the others
                # emit their default stores — replaces the per-arm
                # bool-flag chain that re-tested the branch at every leaf
                arm_pcs = []
                q = pc + 1
                for _ in range(a):
                    arm_pcs.append(q)
                    q += int(self.ops[q][4])
                self.w(f"switch (tid{u}) {{")
                for k, apc in enumerate(arm_pcs):
                    self.w(f"case {k}: {{")
                    self.indent += 1
                    for j, jpc in enumerate(arm_pcs):
                        if j == k:
                            self.gen(jpc, present)
                        else:
                            self.gen_default(jpc)
                    self.indent -= 1
                    self.w("} break;")
                # tids are range-checked upstream; the default arm keeps
                # the appends/cursors in sync regardless (the VM's
                # every-arm-absent behavior)
                self.w("default: {")
                self.indent += 1
                for jpc in arm_pcs:
                    self.gen_default(jpc)
                self.indent -= 1
                self.w("} break;")
                self.w("}")
                return q
            q = pc + 1
            for k in range(a):
                sel = (f"tid{u} == {k}" if present is True
                       else f"{p} && tid{u} == {k}")
                v = self.fresh()
                self.w(f"bool p{v} = {sel};")
                q = self.gen(q, f"p{v}")
            return q

        if kind in (OP_ARRAY, OP_MAP):
            u = self.fresh()
            offs = self.c(col)
            self.w("{")
            self.indent += 1
            opened = present is not True
            if opened:
                self.w(f"if ({p}) {{")
                self.indent += 1
            # ≙ Vm::decode_blocks — same checks in the same order
            self.w("for (;;) {")
            self.indent += 1
            self.w(f"if (r.err) goto blk{u}_done;")
            self.w(f"int64_t cnt{u} = r.read_zigzag();")
            self.w(f"if (r.err || cnt{u} == 0) goto blk{u}_done;")
            self.w(f"if (cnt{u} < 0) {{ cnt{u} = -cnt{u}; "
                   f"(void)r.read_raw_varint(); "
                   f"if (r.err) goto blk{u}_done; }}")
            self.w(f"for (int64_t i{u} = 0; i{u} < cnt{u}; i{u}++) {{")
            self.indent += 1
            self.w(f"if (r.err) goto blk{u}_done;")
            self.w(f"if (r.cur > r.end) "
                   f"{{ r.err |= ERR_OVERRUN; goto blk{u}_done; }}")
            # capture before the map key read (an entry with a key is
            # never zero-width) — same rule as Vm::decode_blocks
            self.w(f"int64_t c0_{u} = r.cur;")
            if kind == OP_MAP:
                self.w(f"rd_string({self.c(b)}, r, true);")
                self.w(f"if (r.err) goto blk{u}_done;")
            inner_end = self.gen(pc + 1, True)
            # zero-width item guard — same rule as Vm::decode_blocks:
            # a block of null/empty-record items charges its claimed
            # count against the per-record kMaxZeroWidthItems budget
            self.w(f"if (i{u} == 0 && r.cur == c0_{u}) {{")
            self.w(f"  r.zw += cnt{u};")
            self.w(f"  if (r.zw > kMaxZeroWidthItems) "
                   f"{{ r.err |= ERR_OVERRUN; goto blk{u}_done; }}")
            self.w("}")
            self.w(f"{offs}.running++;")
            self.w(f"if ({offs}.running < 0) "
                   f"{{ r.err |= ERR_OVERRUN; goto blk{u}_done; }}")
            self.indent -= 1
            self.w("}")
            self.indent -= 1
            self.w("}")
            self.w(f"blk{u}_done:;")
            if opened:
                self.indent -= 1
                self.w("}")
            self.indent -= 1
            self.w("}")
            self.w(f"{offs}.i32.push_back({offs}.running);")
            return inner_end

        raise AssertionError(f"unknown op kind {kind}")  # pragma: no cover


class _EncGen(_GenBase):
    """Emit the encode body for one opcode subtree — mirrors
    ``EncVm::exec`` (host_codec.cpp) case-for-case. Entry cursors always
    advance (absent subtrees consume their entries without emitting),
    exactly like the VM."""

    def __init__(self, ops: np.ndarray):
        super().__init__(ops, indent=2)

    def gen_default(self, pc: int) -> int:
        """The statically-ABSENT encode body: advance the entry cursors
        without emitting a byte — what ``EncVm::exec(present=false)``
        does, unrolled (non-selected union arms, null nullable sides)."""
        self.note("default", pc)
        kind, a, b, col, nops, _pad = (int(x) for x in self.ops[pc])
        if kind == OP_RECORD:
            q = pc + 1
            stop = pc + nops
            while q < stop:
                q = self.gen_default(q)
            return q
        if kind in (OP_INT, OP_ENUM, OP_LONG, OP_FLOAT, OP_DOUBLE, OP_BOOL):
            C = self.c(col)
            self.w(f"{C}.cur++;")
            return pc + 1
        if kind == OP_STRING:
            C = self.c(col)
            self.w(f"{C}.bcur += (size_t){C}.i32[{C}.cur++];")
            return pc + 1
        if kind == OP_FIXED:
            C = self.c(col)
            self.w(f"{C}.cur += {a};")
            return pc + 1
        if kind in (OP_DEC_BYTES, OP_DEC_FIXED):
            C = self.c(col)
            self.w(f"{C}.cur += 16;")
            return pc + 1
        if kind == OP_NULL:
            return pc + 1
        if kind == OP_NULLABLE:
            C = self.c(col)
            self.w(f"{C}.cur++;")
            return self.gen_default(pc + 1)
        if kind == OP_UNION:
            C = self.c(col)
            self.w(f"{C}.cur++;")
            q = pc + 1
            for _ in range(a):
                q = self.gen_default(q)
            return q
        if kind in (OP_ARRAY, OP_MAP):
            u = self.fresh()
            C = self.c(col)
            self.w(f"int32_t cnt{u} = {C}.i32[{C}.cur++];")
            self.w(f"for (int32_t i{u} = 0; i{u} < cnt{u}; i{u}++) {{")
            self.indent += 1
            if kind == OP_MAP:
                K = self.c(b)
                self.w(f"{K}.bcur += (size_t){K}.i32[{K}.cur++];")
            inner_end = self.gen_default(pc + 1)
            self.indent -= 1
            self.w("}")
            return inner_end
        raise AssertionError(f"unknown op kind {kind}")  # pragma: no cover

    def gen(self, pc: int, present) -> int:
        if present is False:
            return self.gen_default(pc)
        self.note("live" if present is True else "cond", pc)
        kind, a, b, col, nops, _pad = (int(x) for x in self.ops[pc])
        p = "true" if present is True else present

        if kind == OP_RECORD:
            q = pc + 1
            stop = pc + nops
            while q < stop:
                q = self.gen(q, present)
            return q

        if kind in (OP_INT, OP_ENUM):
            u = self.fresh()
            C = self.c(col)
            self.w(f"int32_t v{u} = {C}.i32[{C}.cur++];")
            wr = f"write_zigzag(out, (int64_t)v{u});"
            self.w(wr if present is True else f"if ({p}) {wr}")
            return pc + 1
        if kind == OP_LONG:
            u = self.fresh()
            C = self.c(col)
            self.w(f"int64_t v{u} = {C}.i64[{C}.cur++];")
            wr = f"write_zigzag(out, v{u});"
            self.w(wr if present is True else f"if ({p}) {wr}")
            return pc + 1
        if kind in (OP_FLOAT, OP_DOUBLE):
            ty, nb, fld = (("float", 4, "f32") if kind == OP_FLOAT
                           else ("double", 8, "f64"))
            u = self.fresh()
            C = self.c(col)
            self.w(f"{ty} v{u} = {C}.{fld}[{C}.cur++];")
            wr = (f"{{ uint8_t b{u}[{nb}]; std::memcpy(b{u}, &v{u}, {nb}); "
                  f"out.append(b{u}, {nb}); }}")
            self.w(wr if present is True else f"if ({p}) {wr}")
            return pc + 1
        if kind == OP_BOOL:
            u = self.fresh()
            C = self.c(col)
            self.w(f"uint8_t v{u} = {C}.u8[{C}.cur++];")
            wr = f"out.push(v{u} ? 1 : 0);"
            self.w(wr if present is True else f"if ({p}) {wr}")
            return pc + 1
        if kind == OP_STRING:
            self.w(f"wr_string(out, {self.c(col)}, {p});")
            return pc + 1
        if kind == OP_FIXED:
            C = self.c(col)
            wr = f"out.append({C}.u8 + {C}.cur, {a});"
            self.w(wr if present is True else f"if ({p}) {wr}")
            self.w(f"{C}.cur += {a};")
            return pc + 1
        if kind in (OP_DEC_BYTES, OP_DEC_FIXED):
            fs = -1 if kind == OP_DEC_BYTES else a
            self.w(f"if (!wr_decimal(out, {self.c(col)}, {p}, {fs})) "
                   f"return false;")
            return pc + 1
        if kind == OP_NULL:
            return pc + 1

        if kind == OP_NULLABLE:
            u = self.fresh()
            C = self.c(col)
            self.w(f"uint8_t valid{u} = {C}.u8[{C}.cur++];")
            wr = (f"write_zigzag(out, valid{u} ? (int64_t){1 - a} "
                  f": (int64_t){a});")
            self.w(wr if present is True else f"if ({p}) {wr}")
            if (present is True and nops <= self._BRANCH_TABLE_MAX_OPS
                    and not self.subtree_branchy(pc + 1)):
                # hoisted null check: live side writes branchless, null
                # side is pure cursor skips (mirrors the decode gen)
                self.w(f"if (valid{u}) {{")
                self.indent += 1
                end = self.gen(pc + 1, True)
                self.indent -= 1
                self.w("} else {")
                self.indent += 1
                self.gen_default(pc + 1)
                self.indent -= 1
                self.w("}")
                return end
            v = self.fresh()
            sel = (f"valid{u} != 0" if present is True
                   else f"{p} && valid{u}")
            self.w(f"bool p{v} = {sel};")
            return self.gen(pc + 1, f"p{v}")

        if kind == OP_UNION:
            u = self.fresh()
            C = self.c(col)
            self.w(f"int32_t tid{u} = {C}.i32[{C}.cur++];")
            wr = f"write_zigzag(out, (int64_t)tid{u});"
            self.w(wr if present is True else f"if ({p}) {wr}")
            if nops <= self._BRANCH_TABLE_MAX_OPS:
                # branch-table dispatch (mirrors the decode gen): the
                # selected arm encodes straight-line, the others skip
                # their cursors
                arm_pcs = []
                q = pc + 1
                for _ in range(a):
                    arm_pcs.append(q)
                    q += int(self.ops[q][4])
                self.w(f"switch (tid{u}) {{")
                for k, apc in enumerate(arm_pcs):
                    self.w(f"case {k}: {{")
                    self.indent += 1
                    for j, jpc in enumerate(arm_pcs):
                        if j == k:
                            self.gen(jpc, present)
                        else:
                            self.gen_default(jpc)
                    self.indent -= 1
                    self.w("} break;")
                # tids are range-checked upstream; the default arm keeps
                # the appends/cursors in sync regardless (the VM's
                # every-arm-absent behavior)
                self.w("default: {")
                self.indent += 1
                for jpc in arm_pcs:
                    self.gen_default(jpc)
                self.indent -= 1
                self.w("} break;")
                self.w("}")
                return q
            q = pc + 1
            for k in range(a):
                sel = (f"tid{u} == {k}" if present is True
                       else f"{p} && tid{u} == {k}")
                v = self.fresh()
                self.w(f"bool p{v} = {sel};")
                q = self.gen(q, f"p{v}")
            return q

        if kind in (OP_ARRAY, OP_MAP):
            u = self.fresh()
            C = self.c(col)
            self.w(f"int32_t cnt{u} = {C}.i32[{C}.cur++];")
            wr = f"if (cnt{u} > 0) write_zigzag(out, (int64_t)cnt{u});"
            self.w(wr if present is True
                   else f"if ({p}) {{ {wr} }}")
            self.w(f"for (int32_t i{u} = 0; i{u} < cnt{u}; i{u}++) {{")
            self.indent += 1
            if kind == OP_MAP:
                self.w(f"wr_string(out, {self.c(b)}, {p});")
            inner_end = self.gen(pc + 1, present)
            self.indent -= 1
            self.w("}")
            term = "out.push(0);  // block terminator"
            self.w(term if present is True else f"if ({p}) {term}")
            return inner_end

        raise AssertionError(f"unknown op kind {kind}")  # pragma: no cover


_TEMPLATE = """\
// AUTO-GENERATED by pyruhvro_tpu_torch.hostpath.specialize — DO NOT EDIT.
// One schema's HostProgram unrolled into straight-line C++ over the
// shared decode/extract cores (host_vm_core.h, extract_core.h).
// Regenerated whenever the program or a core changes (content-hashed
// module name). The embedded opcode/aux tables feed the Arrow-native
// extraction pass, fused ahead of the generated encoder in
// encode_arrow — no VM dispatch anywhere between the Arrow buffers
// and the wire bytes.
#include "{core}"

namespace {{
using namespace pyr;

{static_tables}

inline void decode_record(Reader& r, std::vector<Col>& cols) {{
{col_refs}
{body}
}}

struct EncRec {{
  template <class W>
  inline bool operator()(W& out, std::vector<InCol>& cols) const {{
{enc_col_refs}
{enc_body}
    return true;
  }}
}};

PyObject* py_decode_spec(PyObject*, PyObject* args) {{
  PyObject *coltypes_obj, *list_obj;
  int nthreads = 0;
  if (!PyArg_ParseTuple(args, "OO|i", &coltypes_obj, &list_obj, &nthreads))
    return nullptr;
  return decode_boundary(
      [](Reader& r, std::vector<Col>& cols) {{ decode_record(r, cols); }},
      coltypes_obj, list_obj, nthreads);
}}

PyObject* py_decode_arrow_spec(PyObject*, PyObject* args) {{
  PyObject *coltypes_obj, *list_obj;
  int nthreads = 0;
  if (!PyArg_ParseTuple(args, "OO|i", &coltypes_obj, &list_obj, &nthreads))
    return nullptr;
  return decode_arrow_boundary(
      [](Reader& r, std::vector<Col>& cols) {{ decode_record(r, cols); }},
      kOps, kAux, coltypes_obj, list_obj, nthreads);
}}

PyObject* py_encode_spec(PyObject*, PyObject* args) {{
  PyObject *coltypes_obj, *bufs_obj;
  Py_ssize_t n;
  Py_ssize_t size_hint = 0;
  int checked = 0;
  if (!PyArg_ParseTuple(args, "OOn|ni", &coltypes_obj, &bufs_obj, &n,
                        &size_hint, &checked))
    return nullptr;
  return encode_boundary(EncRec{{}}, coltypes_obj, bufs_obj, n, size_hint,
                         checked);
}}

PyObject* py_encode_arrow_spec(PyObject*, PyObject* args) {{
  PyObject* coltypes_obj;
  unsigned long long addr_a, addr_s;
  Py_ssize_t n;
  int checked = 0, nshards = 1;
  if (!PyArg_ParseTuple(args, "OKKn|ii", &coltypes_obj, &addr_a, &addr_s,
                        &n, &checked, &nshards))
    return nullptr;
  return encode_arrow_boundary(EncRec{{}}, kOps, kAux, coltypes_obj,
                               (uintptr_t)addr_a, (uintptr_t)addr_s, n,
                               checked, nshards);
}}

PyObject* py_shard_stats_spec(PyObject*, PyObject*) {{
  return shard_stats_py();
}}

PyMethodDef methods[] = {{
    {{"decode", py_decode_spec, METH_VARARGS,
     "decode(coltypes, data, nthreads=0) -> (buffers, err_record, err_bits)"}},
    {{"decode_arrow", py_decode_arrow_spec, METH_VARARGS,
     "decode_arrow(coltypes, data, nthreads=0) -> "
     "((tag, payload), err_record, err_bits)"}},
    {{"encode", py_encode_spec, METH_VARARGS,
     "encode(coltypes, buffers, n, size_hint=0) -> (blob, offsets)"}},
    {{"encode_arrow", py_encode_arrow_spec, METH_VARARGS,
     "encode_arrow(coltypes, addr_array, addr_schema, n, checked=0, "
     "nshards=1) -> (blob, offsets, t_extract_s, t_encode_s) | status int"}},
    {{"shard_stats", py_shard_stats_spec, METH_NOARGS,
     "shard_stats() -> {{fanouts, shards, shard_s, wall_s, threads}}"}},
    {{nullptr, nullptr, 0, nullptr}},
}};

PyModuleDef moduledef = {{
    PyModuleDef_HEAD_INIT, "{mod}",
    "schema-specialized Avro decoder", -1, methods,
}};

}}  // namespace

extern "C" PyMODINIT_FUNC PyInit_{mod}(void) {{
  return PyModule_Create(&moduledef);
}}
"""


def _static_tables(prog: HostProgram) -> str:
    """The embedded opcode + aux tables the fused Arrow-native
    extraction walks (extract_core.h ArrowExtractor)."""
    lines = ["static const Op kOps[] = {"]
    for row in prog.ops:
        kind, a, b, col, nops, _pad = (int(x) for x in row)
        lines.append(f"    {{{kind}, {a}, {b}, {col}, {nops}, 0}},")
    lines.append("};")
    aux = prog.op_aux or tuple(None for _ in range(len(prog.ops)))
    entries = []
    for i, e in enumerate(aux):
        if e is None:
            entries.append("    {AUX_NONE, nullptr, nullptr, 0},")
        elif e[0] == "uuid":
            entries.append("    {AUX_UUID, nullptr, nullptr, 0},")
        elif e[0] == "binary":
            entries.append("    {AUX_BINARY, nullptr, nullptr, 0},")
        elif e[0] == "duration":
            entries.append("    {AUX_DURATION, nullptr, nullptr, 0},")
        elif e[0] == "decimal":  # ("decimal", precision)
            entries.append(
                f"    {{AUX_DECIMAL, nullptr, nullptr, {int(e[1])}}},"
            )
        else:  # ("enum", symbol_bytes, ...)
            syms = e[1:]
            for k, s in enumerate(syms):
                bs = ", ".join(str(x) for x in s) + ", 0" if s else "0"
                lines.append(f"static const char kSym_{i}_{k}[] = {{{bs}}};")
            ptrs = ", ".join(f"kSym_{i}_{k}" for k in range(len(syms)))
            lens = ", ".join(str(len(s)) for s in syms)
            lines.append(
                f"static const char* const kSyms_{i}[] = {{{ptrs}}};"
            )
            lines.append(
                f"static const int32_t kSymLens_{i}[] = {{{lens}}};"
            )
            entries.append(
                f"    {{AUX_ENUM, kSyms_{i}, kSymLens_{i}, {len(syms)}}},"
            )
    lines.append("static const OpAux kAux[] = {")
    lines.extend(entries)
    lines.append("};")
    return "\n".join(lines)


def generate_source(prog: HostProgram, mod_name: str,
                    core_include: str = "../arrow_decode_core.h",
                    with_effects: bool = False) -> str:
    """The C++ translation unit for one schema's decoder + encoder.

    ``with_effects=True`` appends the machine-readable ``EFFECTS-v1``
    trailer (the generators' effect-event journals as one JSON line) for
    the IR verifier's equivalence diff; production callers leave it off
    so cached sources stay byte-stable."""
    g = _Gen(prog.ops)
    g.gen(0, True)
    col_refs = "\n".join(
        f"  Col& C{c} = cols[{c}];" for c in sorted(g.cols_used)
    )
    eg = _EncGen(prog.ops)
    eg.gen(0, True)
    enc_col_refs = "\n".join(
        f"    InCol& C{c} = cols[{c}];" for c in sorted(eg.cols_used)
    )
    src = _TEMPLATE.format(
        core=core_include,
        mod=mod_name,
        static_tables=_static_tables(prog),
        col_refs=col_refs,
        body="\n".join(g.lines),
        enc_col_refs=enc_col_refs,
        enc_body="\n".join(eg.lines),
    )
    if with_effects:
        import json as _json

        trailer = _json.dumps(
            {"decode": [list(e) for e in g.effects],
             "encode": [list(e) for e in eg.effects]},
            separators=(",", ":"))
        src += f"\n// EFFECTS-v1 {trailer}\n"
    return src


# -- engine lifecycle / accounting -------------------------------------------
#
# Every loaded specialized engine registers here: its on-disk .so size
# (the byte-accurate part of what dlopen mapped), an LRU clock, and
# weak references to the NativeHostCodec instances serving through it.
# Eviction drops the Python-side references (module memo + each codec's
# ``_spec``) so the next decode re-admits via ``load_specialized`` —
# a pure dlopen of the existing disk artifact, never a recompile. The
# mapped code itself stays resident (CPython never dlcloses extension
# modules); the registry accounts it either way so the footprint an
# operator sees matches what RSS holds.

# the loaded modules by name, and the lock their builds hold
_build_lock = threading.Lock()
_modules: Dict[str, object] = {}  # guarded-by: _build_lock
_eng_lock = threading.Lock()
# mod_name -> {"bytes": so size, "last_used": monotonic, "codecs": WeakSet}
_engines: Dict[str, dict] = {}  # guarded-by: _eng_lock


def _note_engine(mod_name: str, so_path: str) -> dict:
    try:
        size = os.path.getsize(so_path)
    except OSError:
        size = 0
    schedtest.yp("engine.note")
    with _eng_lock:
        rec = _engines.get(mod_name)
        if rec is None:
            rec = _engines[mod_name] = {
                "bytes": float(size),
                "last_used": time.monotonic(),
                "codecs": weakref.WeakSet(),
            }
        else:
            rec["last_used"] = time.monotonic()
            if size:
                rec["bytes"] = float(size)
    return rec


def touch_engine(mod_name: str) -> None:
    """Stamp an engine's LRU clock (called per decode serving through
    it; a dict store under the GIL, no lock on the hot path)."""
    rec = _engines.get(mod_name)
    if rec is not None:
        rec["last_used"] = time.monotonic()


def bind_engine_user(mod_name: str, codec) -> None:
    """Attach a codec to the engine's user set so eviction can unhook
    its ``_spec`` reference."""
    with _eng_lock:
        rec = _engines.get(mod_name)
        if rec is not None:
            rec["codecs"].add(codec)


def _engine_entries():
    with _eng_lock:
        return [(name, rec["last_used"], rec["bytes"])
                for name, rec in _engines.items()]


def _evict_engine(mod_name: str) -> bool:
    from ..runtime import metrics

    schedtest.yp("engine.evict")
    with _eng_lock:
        rec = _engines.pop(mod_name, None)
    if rec is None:
        return False
    with _build_lock:
        _modules.pop(mod_name, None)
    for codec in list(rec["codecs"]):
        # leave _rows_seen and _spec_failed untouched: the schema is
        # still hot, so the NEXT decode re-admits through
        # load_specialized (a disk-cache dlopen, not a g++ run)
        codec._spec = None
        codec._spec_name = None
    metrics.inc("specialize.evictions")
    return True


def _register_lifecycle() -> None:
    from ..runtime import cachelife, knobs, memacct

    cachelife.register(
        "engines",
        entries=_engine_entries,
        evict=_evict_engine,
        capacity=lambda: knobs.get_int("PYRUHVRO_TPU_CACHE_MAX_ENGINES"),
    )

    def _probe():
        with _eng_lock:
            return {
                "bytes": float(sum(r["bytes"]
                                   for r in _engines.values())),
                "items": float(len(_engines)),
            }

    memacct.register_probe("cache.engines", _probe)


_register_lifecycle()


def spec_dir() -> Path:
    """Where the generated units and their modules live."""
    from ..runtime import native

    return native.BUILD_DIR / "_spec"


def module_name(prog: HostProgram) -> str:
    """The engine's module name: a hash of the generated unit (its
    name-independent text), the shared headers ``csrc/host/*.h`` and the
    build context of :func:`..runtime.native.build_path` (interpreter,
    flags, :func:`..runtime.native.cpu_tag`)."""
    from ..runtime import native

    key = hashlib.sha256(generate_source(prog, "M", _CORE).encode())
    for path in sorted(_HOST_DIR.glob("*.h")):
        key.update(b"\0" + path.name.encode() + b"\0" + path.read_bytes())
    key.update(f"{sys.version}|{native.CXX_FLAGS}|{native.NATIVE_FLAGS}|"
               f"{native.cpu_tag()}".encode())
    return f"_pyruhvro_torch_spec_{key.hexdigest()[:12]}"


def load_specialized(prog: HostProgram):
    """Generate + compile + import this program's specialized codec.

    Returns the extension module (its ``decode(coltypes, data,
    nthreads)`` matches the interpreter's minus the ops argument).
    Disk-cached: the module name is a content hash of the generated
    source and the shared headers (:func:`module_name`), so any change
    to either regenerates, and repeat processes just dlopen. Raises
    ``RuntimeError`` when ``g++`` fails, and under either sanitizer
    flavour (the cache is keyed by the source only)."""
    from ..runtime import cachelife, metrics, native

    if native.san_active() or native.tsan_active():
        raise RuntimeError("a sanitizer flavour is active "
                           "(PYRUHVRO_TPU_NATIVE_SAN / PYRUHVRO_TPU_TSAN): "
                           "the specialised engines have no sanitized "
                           "build; the VM serves such a session")
    mod_name = module_name(prog)
    so = spec_dir() / (mod_name + (sysconfig.get_config_var("EXT_SUFFIX")
                                   or ".so"))
    # memo hits read with .get: a concurrent lifecycle eviction may pop
    # the key between a membership check and the read
    mod = _modules.get(mod_name)
    if mod is not None:
        _note_engine(mod_name, str(so))
        return mod
    schedtest.yp("engine.memo")
    with _build_lock:
        mod = _modules.get(mod_name)
        if mod is not None:
            _note_engine(mod_name, str(so))
            return mod
        src = spec_dir() / (mod_name + ".cpp")
        if not src.exists():
            src.parent.mkdir(parents=True, exist_ok=True)
            tmp = src.with_name(f"{src.name}.{os.getpid()}.tmp")
            tmp.write_text(generate_source(prog, mod_name, _CORE))
            os.replace(tmp, src)
        _cmd, build_s = native.compile_extension(src, so,
                                                 includes=(_HOST_DIR,))
        if build_s:
            metrics.inc("specialize.builds")
            metrics.inc("specialize.build_s", build_s)
        mod = native.import_extension(mod_name, so)
        _modules[mod_name] = mod
    # lifecycle registration + admission OUTSIDE the build lock
    # (LRU eviction of another engine must not wait on a compile)
    _note_engine(mod_name, str(so))
    cachelife.admit("engines")
    return mod
