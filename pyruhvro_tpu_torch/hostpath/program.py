"""Schema IR → host bytecode program, the C++ VM's input (copy of
``pyruhvro_tpu/hostpath/program.py``).

Mirrors the device lowering (:mod:`..ops.fieldprog`) in walk order and
column naming — ``path#v`` / ``path#v64`` / ``path#valid`` /
``path#tid`` / ``path#bytes``+``#len`` / ``path#offsets`` — so the
VM's output dict drops straight into ``ops.arrow_build``. Op kinds and
column-type codes are the C++ side's contract
(``csrc/host/host_codec.cpp`` enums; keep in sync).

≙ the role of ``make_decoder`` (``ruhvro/src/fast_decode.rs:176-420``):
the schema compiles once into a flat program, executed by switch
dispatch. ``lower_host`` never emits ``OP_FIXED_RUN`` or the flags:
the superoptimizer (:mod:`.optimize`) rewrites a lowered program into
them, and the IR verifier (:mod:`..analysis.irverify`) proves each
rewrite against ``OP_EFFECTS``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..ops import UnsupportedOnDevice
from ..gate import host_supported
from ..schema.model import (
    Array,
    AvroType,
    Enum,
    Fixed,
    Map,
    Primitive,
    Record,
    Union,
)

__all__ = ["HostProgram", "lower_host", "COL_NBUF", "OP_NAMES",
           "OP_EFFECTS"]

# op kinds (≙ host_codec.cpp OpKind)
OP_RECORD, OP_INT, OP_LONG, OP_FLOAT, OP_DOUBLE, OP_BOOL = 0, 1, 2, 3, 4, 5
OP_STRING, OP_ENUM, OP_NULL, OP_NULLABLE, OP_UNION = 6, 7, 8, 9, 10
OP_ARRAY, OP_MAP, OP_FIXED, OP_DEC_BYTES, OP_DEC_FIXED = 11, 12, 13, 14, 15
# superoptimizer-only op (hostpath/optimize.py): a fused header over a
# run of ≥2 consecutive fixed-layout leaf fields of one record. Never
# emitted by lower_host — only the verified rewrite pass inserts it.
#   a    — 1 when every member is exact-width (float/double/bool): the
#          engines may take the bulk lane (one span pre-check, then
#          unchecked member reads); 0 = dispatch-only grouping
#   b    — total minimum wire bytes of the member run (the bulk lane's
#          span pre-check amount — for all-fixed runs it is exact)
#   nops — 1 + member count (members stay in-stream, unchanged)
OP_FIXED_RUN = 16

# ``pad`` flag bits (optimizer-set; 0 on every lower_host program).
# FLAG_ALWAYS_PRESENT on an OP_FIXED_RUN header asserts the header's
# ancestor chain is unconditional (records only): the engines may skip
# the runtime ``present`` test on the bulk lane. FLAG_STR_ITEMS on an
# OP_ARRAY/OP_MAP asserts the item subtree is exactly one plain
# string/bytes leaf, pre-deciding decode_blocks' string fast lane at
# compile time. Both are PROOF-CARRYING: analysis/irverify.py
# verify_optimized re-derives each claim and rejects the program when
# the flag overclaims (a wrong flag would mean wire reads for absent
# subtrees / string reads over non-string items).
FLAG_ALWAYS_PRESENT = 1
FLAG_STR_ITEMS = 2

# column types (≙ host_codec.cpp ColType)
COL_I32, COL_I64, COL_F32, COL_F64, COL_U8, COL_STR, COL_OFFS = range(7)

# buffers each column type contributes (COL_STR: value bytes + len i32)
COL_NBUF = {COL_STR: 2}

OP_NAMES = {
    OP_RECORD: "record", OP_INT: "int", OP_LONG: "long",
    OP_FLOAT: "float", OP_DOUBLE: "double", OP_BOOL: "bool",
    OP_STRING: "string", OP_ENUM: "enum", OP_NULL: "null",
    OP_NULLABLE: "nullable", OP_UNION: "union", OP_ARRAY: "array",
    OP_MAP: "map", OP_FIXED: "fixed", OP_DEC_BYTES: "dec_bytes",
    OP_DEC_FIXED: "dec_fixed", OP_FIXED_RUN: "fixed_run",
}

# Per-opcode effect contract, the machine-readable half of what the two
# native engines implement (the IR verifier abstract-interprets
# programs against THIS table, and anchors every declared guard to the
# C++ source it names). Fields:
#   ctype      — required ColType of the op's primary column (None = no
#                column); the map KEY column (op.b) is always COL_STR.
#   min_wire   — minimum wire bytes one present execution consumes
#                ("a" = the op's size operand). Array/map items whose
#                subtree floor is 0 are legal ONLY because both engines
#                charge zero-width items against kMaxZeroWidthItems.
#   pushes     — buffer lanes appended per present execution of the op
#                itself (items repeat per item, handled by the walker).
#   sinks      — int32-narrowing lanes this op writes, as
#                (lane, (guard, ...)): every guard names an anchor the
#                verifier greps out of the native sources, so deleting a
#                C++ range check (or this declaration) fails the gate.
#   aux        — aux tags permitted on the op (None = no aux legal);
#                "!tag" marks a REQUIRED tag.
OP_EFFECTS = {
    OP_RECORD: dict(ctype=None, min_wire=0, pushes=(), sinks=(),
                    aux=(None,)),
    OP_INT: dict(ctype=COL_I32, min_wire=1, pushes=("i32",),
                 # a zigzag past int32 is an error (ERR_INT_RANGE), as in
                 # the oracle and the device walks
                 sinks=(("int_value", ("int_range_i32",)),),
                 aux=(None,)),
    OP_LONG: dict(ctype=COL_I64, min_wire=1, pushes=("i64",), sinks=(),
                  aux=(None,)),
    OP_FLOAT: dict(ctype=COL_F32, min_wire=4, pushes=("f32",), sinks=(),
                   aux=(None,)),
    OP_DOUBLE: dict(ctype=COL_F64, min_wire=8, pushes=("f64",), sinks=(),
                    aux=(None,)),
    OP_BOOL: dict(ctype=COL_U8, min_wire=1, pushes=("u8",), sinks=(),
                  aux=(None,)),
    OP_STRING: dict(ctype=COL_STR, min_wire=1, pushes=("u8", "i32"),
                    # the wire length lands in the int32 lens lane: it
                    # must be bounded by the remaining span AND by
                    # int32 (a >2GiB datum could otherwise wrap it)
                    sinks=(("string_len",
                            ("string_len_span", "string_len_i32")),),
                    aux=(None, "uuid", "binary")),
    OP_ENUM: dict(ctype=COL_I32, min_wire=1, pushes=("i32",),
                  sinks=(("enum_index", ("enum_range",)),),
                  aux=("!enum",)),
    OP_NULL: dict(ctype=None, min_wire=0, pushes=(), sinks=(),
                  aux=(None,)),
    OP_NULLABLE: dict(ctype=COL_U8, min_wire=1, pushes=("u8",), sinks=(),
                      aux=(None,)),
    OP_UNION: dict(ctype=COL_I32, min_wire=1, pushes=("i32",),
                   sinks=(("union_tid", ("union_branch_range",)),),
                   aux=(None,)),
    OP_ARRAY: dict(ctype=COL_OFFS, min_wire=1, pushes=("i32",),
                   sinks=(("offs_running", ("offs_running_i32",)),
                          ("merge_rebase", ("merge_offsets_i32",))),
                   aux=(None,)),
    OP_MAP: dict(ctype=COL_OFFS, min_wire=1, pushes=("i32",),
                 sinks=(("offs_running", ("offs_running_i32",)),
                        ("merge_rebase", ("merge_offsets_i32",))),
                 aux=(None,)),
    OP_FIXED: dict(ctype=COL_U8, min_wire="a", pushes=("u8",), sinks=(),
                   aux=(None, "duration")),
    OP_DEC_BYTES: dict(ctype=COL_U8, min_wire=1, pushes=("u8",), sinks=(),
                       aux=("!decimal",)),
    OP_DEC_FIXED: dict(ctype=COL_U8, min_wire="a", pushes=("u8",),
                       sinks=(), aux=("!decimal",)),
    # fused header: consumes no wire bytes itself (its b operand only
    # SUMMARIZES the members' floors for the bulk lane's span
    # pre-check — the members still account their own min_wire), pushes
    # nothing, owns no column. The bulk lane reads members unchecked,
    # which is sound only behind the span pre-check the sink names.
    OP_FIXED_RUN: dict(ctype=None, min_wire=0, pushes=(),
                       sinks=(("bulk_span", ("fixed_run_span",)),),
                       aux=(None,)),
}

# numpy dtypes per buffer, in buffer order
_COL_DTYPES = {
    COL_I32: (np.int32,),
    COL_I64: (np.int64,),
    COL_F32: (np.float32,),
    COL_F64: (np.float64,),
    COL_U8: (np.uint8,),
    COL_STR: (np.uint8, np.int32),
    COL_OFFS: (np.int32,),
}


@dataclass
class ColSpec:
    key: str       # assembler dict key ("" + suffix handled by builder)
    ctype: int
    region: int    # region id (0 = rows), for entry-count bookkeeping


@dataclass
class HostProgram:
    ir: Record
    ops: np.ndarray            # int32 [n_ops, 6]
    cols: List[ColSpec]
    coltypes: np.ndarray       # int32 [n_cols]
    regions: List[str]         # region id -> repeated-field path
    region_parents: List[int]
    # per-op logical facts the flat opcode table cannot carry, shaped
    # for the Arrow-native extractor AND the fused Arrow decoder
    # (runtime/native/extract_core.h / arrow_decode_core.h): one entry
    # per op — None, ("uuid",), ("binary",), ("duration",),
    # ("decimal", precision) or ("enum", symbol_bytes, ...)
    op_aux: tuple = ()

    def op_effects(self) -> List[dict]:
        """Per-op resolved effect rows for the IR verifier:
        the :data:`OP_EFFECTS` contract with the op's operands folded in
        (``min_wire="a"`` resolves to the size operand; required aux
        tags are checked by the verifier, not here)."""
        out = []
        aux = self.op_aux or tuple(None for _ in range(len(self.ops)))
        for pc, row in enumerate(self.ops):
            kind, a, b, col, nops, _pad = (int(x) for x in row)
            eff = OP_EFFECTS[kind]
            mw = eff["min_wire"]
            out.append({
                "pc": pc, "kind": kind, "name": OP_NAMES[kind],
                "a": a, "b": b, "col": col, "nops": nops,
                "ctype": eff["ctype"],
                "min_wire": a if mw == "a" else mw,
                "pushes": eff["pushes"], "sinks": eff["sinks"],
                "aux_allowed": eff["aux"], "aux": aux[pc],
            })
        return out

    def buffer_plan(self) -> List[Tuple[str, object, int]]:
        """Flat (host_key, dtype, region) per returned buffer, in the
        VM's buffer order. Host keys: ``#start``/``#len`` suffixes for
        strings, the col key otherwise."""
        plan = []
        for c in self.cols:
            dts = _COL_DTYPES[c.ctype]
            if c.ctype == COL_STR:
                plan.append((c.key + "#bytes", dts[0], c.region))
                plan.append((c.key + "#len", dts[1], c.region))
            else:
                plan.append((c.key, dts[0], c.region))
        return plan


class _HostLowering:
    def __init__(self) -> None:
        self.ops: List[Tuple[int, int, int, int]] = []  # kind,a,b,col
        self.cols: List[ColSpec] = []
        self.subtree: Dict[int, int] = {}  # op index -> nops
        self.regions: List[str] = [""]
        self.region_parents: List[int] = [-1]
        self.aux: Dict[int, tuple] = {}    # op index -> extractor aux

    def col(self, key: str, ctype: int, region: int) -> int:
        self.cols.append(ColSpec(key, ctype, region))
        return len(self.cols) - 1

    def emit(self, kind: int, a: int = 0, b: int = 0, col: int = -1) -> int:
        self.ops.append((kind, a, b, col))
        i = len(self.ops) - 1
        self.subtree[i] = 1
        return i

    def close(self, i: int) -> None:
        self.subtree[i] = len(self.ops) - i

    def lower_type(self, t: AvroType, path: str, region: int) -> None:
        if isinstance(t, Primitive):
            name = t.name
            if name == "null":
                self.emit(OP_NULL)
            elif name == "int":
                self.emit(OP_INT, col=self.col(path + "#v", COL_I32, region))
            elif name == "long":
                self.emit(OP_LONG, col=self.col(path + "#v64", COL_I64, region))
            elif name == "float":
                self.emit(OP_FLOAT, col=self.col(path + "#v", COL_F32, region))
            elif name == "double":
                self.emit(OP_DOUBLE,
                          col=self.col(path + "#v64", COL_F64, region))
            elif name == "boolean":
                self.emit(OP_BOOL, col=self.col(path + "#v", COL_U8, region))
            elif name == "string":
                # incl. uuid: the wire form is a plain string; the
                # text→16-byte conversion is the assembler's job (the
                # aux tag tells the Arrow-native extractor the column
                # arrives as FixedSizeBinary(16), not text)
                i = self.emit(OP_STRING, col=self.col(path, COL_STR, region))
                if t.logical == "uuid":
                    self.aux[i] = ("uuid",)
            elif name == "bytes":
                if t.logical == "decimal":
                    # wire: length-prefixed big-endian two's complement;
                    # column: 16-byte LE decimal128 words (the aux tag
                    # carries the declared precision for the fused
                    # decoder's native range check)
                    i = self.emit(OP_DEC_BYTES,
                                  col=self.col(path + "#dec", COL_U8,
                                               region))
                    self.aux[i] = ("decimal", t.precision)
                else:
                    # same wire form and builder as string; only the
                    # Arrow assembly differs (Binary, no UTF-8 check —
                    # the aux tag tells the fused decoder to skip it)
                    i = self.emit(OP_STRING,
                                  col=self.col(path, COL_STR, region))
                    self.aux[i] = ("binary",)
            else:  # pragma: no cover — gated by host_supported
                raise UnsupportedOnDevice(f"primitive {name!r} at {path!r}")
        elif isinstance(t, Fixed):
            if t.logical == "decimal":
                i = self.emit(OP_DEC_FIXED, a=t.size,
                              col=self.col(path + "#dec", COL_U8, region))
                self.aux[i] = ("decimal", t.precision)
            else:
                i = self.emit(OP_FIXED, a=t.size,
                              col=self.col(path + "#fix", COL_U8, region))
                if t.logical == "duration":
                    self.aux[i] = ("duration",)
        elif isinstance(t, Enum):
            i = self.emit(OP_ENUM, a=len(t.symbols),
                          col=self.col(path + "#v", COL_I32, region))
            self.aux[i] = ("enum",) + tuple(
                s.encode("utf-8") for s in t.symbols
            )
        elif isinstance(t, Record):
            i = self.emit(OP_RECORD)
            prefix = path + "/" if path else ""
            for f in t.fields:
                self.lower_type(f.type, prefix + f.name, region)
            self.close(i)
        elif isinstance(t, Union):
            if t.is_nullable_pair:
                i = self.emit(
                    OP_NULLABLE, a=t.null_index,
                    col=self.col(path + "#valid", COL_U8, region),
                )
                self.lower_type(t.non_null_variant, path, region)
                self.close(i)
            else:
                i = self.emit(
                    OP_UNION, a=len(t.variants),
                    col=self.col(path + "#tid", COL_I32, region),
                )
                for k, v in enumerate(t.variants):
                    if v.is_null():
                        self.emit(OP_NULL)
                    else:
                        self.lower_type(v, f"{path}/{k}", region)
                self.close(i)
        elif isinstance(t, (Array, Map)):
            rid = len(self.regions)
            self.regions.append(path)
            self.region_parents.append(region)
            offs = self.col(path + "#offsets", COL_OFFS, region)
            if isinstance(t, Array):
                i = self.emit(OP_ARRAY, col=offs)
                self.lower_type(t.items, path + "/@item", rid)
            else:
                key_col = self.col(path + "/@key", COL_STR, rid)
                i = self.emit(OP_MAP, b=key_col, col=offs)
                self.lower_type(t.values, path + "/@val", rid)
            self.close(i)
        else:  # pragma: no cover — gated by is_supported
            raise UnsupportedOnDevice(f"type {type(t).__name__} at {path!r}")


def lower_host(ir: AvroType) -> HostProgram:
    """Lower a top-level record schema to its host bytecode program
    (gate: :func:`..gate.host_supported` — the fast subset plus
    bytes/fixed/duration/time-*/local-timestamp-*)."""
    if not host_supported(ir):
        raise UnsupportedOnDevice("schema is outside the host VM subset")
    lo = _HostLowering()
    lo.lower_type(ir, "", 0)
    n = len(lo.ops)
    ops = np.zeros((n, 6), np.int32)
    for i, (kind, a, b, col) in enumerate(lo.ops):
        ops[i] = (kind, a, b, col, lo.subtree[i], 0)
    return HostProgram(
        ir=ir,
        ops=np.ascontiguousarray(ops),
        cols=lo.cols,
        coltypes=np.ascontiguousarray(
            np.array([c.ctype for c in lo.cols], np.int32)
        ),
        regions=lo.regions,
        region_parents=lo.region_parents,
        op_aux=tuple(lo.aux.get(i) for i in range(n)),
    )
