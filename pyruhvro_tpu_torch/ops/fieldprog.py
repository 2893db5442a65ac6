"""Schema IR → field program (port of ``pyruhvro_tpu/ops/fieldprog.py:162-525``).

The reference lowers a schema into JAX emitters that run one lane per
record. This lowering is torch-free and produces the same ``Program``
contract — every output buffer's key, dtype (a numpy dtype) and region,
plus ``regions``, ``region_parents`` and ``string_cols`` — and, in place
of emitter closures, a flat int32 **field-program code**. Two walks
execute that one code in each engine: a CUDA kernel, one thread per
record with real branches (``csrc/walk_decode.cu``, row-level regions
only; ``csrc/decode_walk.cu``, nested regions too), and a plain PyTorch
walk (``ops/walk_decode.py``, ``ops/decode.py``), vectorized over
records with lane masks like the reference emitters. So the CPU tests hold the code against the JAX
reference, and the card holds the kernel against the plain walk.

Buffers (as in the reference):

* every leaf writes buffers keyed by a path string
  (``"address/street#start"``);
* a repeated field (array/map) writes its items into strided slots
  ``row * item_cap + i`` of its own *region*;
* strings and bytes record ``(start, len)`` descriptors only.

Code (operands are ints; ``buf`` is an index into ``Program.out_keys``,
``pc`` an absolute index into ``Program.code``)::

    LONG   lo hi          int/long varint, zig-zag → (lo, hi) u32
    INT    v              int varint, zig-zag → low word as i32
    FLOAT  v              4 raw bytes (bit pattern kept)
    DOUBLE lo hi          8 raw bytes as two u32 words
    BOOL   v              one byte, > 1 sets ERR_BAD_BOOL
    STRING start len      length varint, then (start, len) descriptor
    FIXED  start size     static-size run, start only
    ENUM   v nsym         index varint with range check
    NULLABLE valid null_idx end_pc
                          branch varint; the inner value's code follows
                          and runs only when the value is present
    UNION  tid n end_pc (start stop)*n
                          branch varint; arm k's code is [start, stop)
                          followed by JUMP end_pc (start = -1: null arm)
    JUMP   pc
    REPEATED count region end_pc
                          block loop; the item code follows, then
    LOOP   repeated_pc    closes one item (end_pc is just past it)
    TRAILING              ERR_TRAILING when the cursor is not at the end
    REBASE start          row-region start += base[row] (the row's offset)
    END

``csrc/walk_decode.cu`` and ``csrc/decode_walk.cu`` define the same
opcode numbers (``tests/test_torch_lowering.py`` checks that they
agree). REBASE serves the row-padded engine only: the pipeline's cursors
are absolute, and its walks skip it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from . import UnsupportedOnDevice
from ..gate import device_supported
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

__all__ = ["Program", "BufSpec", "StringCol", "lower", "ROWS", "OPCODES"]

ROWS = 0  # region id of the per-row region

I32 = np.dtype(np.int32)
U32 = np.dtype(np.uint32)
F32 = np.dtype(np.float32)
U8 = np.dtype(np.uint8)

OP_END = 0
OP_LONG = 1
OP_INT = 2
OP_FLOAT = 3
OP_DOUBLE = 4
OP_BOOL = 5
OP_STRING = 6
OP_FIXED = 7
OP_ENUM = 8
OP_NULLABLE = 9
OP_UNION = 10
OP_JUMP = 11
OP_REPEATED = 12
OP_LOOP = 13
OP_TRAILING = 14
OP_REBASE = 15

OPCODES = {
    name: value for name, value in globals().items()
    if name.startswith("OP_")
}


@dataclass
class BufSpec:
    key: str
    dtype: np.dtype
    region: int


@dataclass
class StringCol:
    """A string-valued column: buffers at ``path#start`` / ``path#len``."""

    path: str
    region: int


@dataclass
class Program:
    """Lowered, schema-static decode program."""

    ir: Record
    buffers: Dict[str, BufSpec]
    regions: List[str]          # region id → path of the repeated field ("" = rows)
    region_parents: List[int]   # region id → parent region (-1 for rows)
    string_cols: List[StringCol]
    out_keys: List[str]         # sorted buffer keys: the code's buffer numbering
    code: np.ndarray            # int32 field-program code

    def region_depth(self, region: int) -> int:
        """Repeated fields enclosing ``region``'s items, itself included
        (0 for the row region, 1 for a row-level array/map)."""
        depth = 0
        while region != ROWS:
            depth += 1
            region = self.region_parents[region]
        return depth

    @property
    def depth(self) -> int:
        """The deepest nesting of repeated fields: the number of block
        loops a walk keeps open at once (its loop stack)."""
        return max(map(self.region_depth, range(len(self.regions))))


class _Lowering:
    def __init__(self) -> None:
        self.buffers: Dict[str, BufSpec] = {}
        self.regions: List[str] = [""]
        self.region_parents: List[int] = [-1]
        self.string_cols: List[StringCol] = []
        # operands that name a buffer stay keys until lowering ends,
        # when the sorted key order is known
        self.code: list = []

    def buf(self, key: str, dtype, region: int) -> str:
        self.buffers[key] = BufSpec(key, dtype, region)
        return key

    def emit(self, *words) -> int:
        at = len(self.code)
        self.code.extend(words)
        return at

    def lower_type(self, t: AvroType, path: str, region: int) -> None:
        if isinstance(t, Primitive):
            return self.lower_primitive(t, path, region)
        if isinstance(t, Fixed):
            self.emit(OP_FIXED, self.buf(path + "#start", I32, region), t.size)
            return None
        if isinstance(t, Enum):
            self.emit(OP_ENUM, self.buf(path + "#v", I32, region),
                      len(t.symbols))
            return None
        if isinstance(t, Record):
            prefix = path + "/" if path else ""
            for f in t.fields:
                self.lower_type(f.type, prefix + f.name, region)
            return None
        if isinstance(t, Union):
            if t.is_nullable_pair:
                return self.lower_nullable(t, path, region)
            return self.lower_union(t, path, region)
        if isinstance(t, (Array, Map)):
            return self.lower_repeated(t, path, region)
        raise UnsupportedOnDevice(f"type {type(t).__name__} at {path!r}")

    def lower_primitive(self, t: Primitive, path: str, region: int) -> None:
        name = t.name
        if name == "null":
            return
        if name == "long":
            self.emit(OP_LONG, self.buf(path + "#lo", U32, region),
                      self.buf(path + "#hi", U32, region))
        elif name == "int":
            self.emit(OP_INT, self.buf(path + "#v", I32, region))
        elif name == "float":
            self.emit(OP_FLOAT, self.buf(path + "#v", F32, region))
        elif name == "double":
            self.emit(OP_DOUBLE, self.buf(path + "#lo", U32, region),
                      self.buf(path + "#hi", U32, region))
        elif name == "boolean":
            self.emit(OP_BOOL, self.buf(path + "#v", U8, region))
        elif name in ("string", "bytes"):
            # one wire form, three Arrow destinations (Utf8, Binary,
            # Decimal128); the host assembly converts
            self.emit(OP_STRING, self.buf(path + "#start", I32, region),
                      self.buf(path + "#len", I32, region))
            self.string_cols.append(StringCol(path, region))
        else:
            raise UnsupportedOnDevice(f"primitive {name!r} at {path!r}")

    def lower_nullable(self, t: Union, path: str, region: int) -> None:
        """2-variant ``["null", T]`` union → validity + inner decode."""
        at = self.emit(OP_NULLABLE, self.buf(path + "#valid", U8, region),
                       t.null_index, None)
        self.lower_type(t.non_null_variant, path, region)
        self.code[at + 3] = len(self.code)

    def lower_union(self, t: Union, path: str, region: int) -> None:
        """N-variant sparse union → type id + one arm's decode."""
        n = len(t.variants)
        at = self.emit(OP_UNION, self.buf(path + "#tid", I32, region), n,
                       None, *([-1, -1] * n))
        jumps = []
        for k, v in enumerate(t.variants):
            if v.is_null():
                continue
            start = len(self.code)
            self.lower_type(v, f"{path}/{k}", region)
            self.code[at + 4 + 2 * k] = start
            self.code[at + 5 + 2 * k] = len(self.code)
            jumps.append(self.emit(OP_JUMP, None))
        end = len(self.code)
        self.code[at + 3] = end
        for j in jumps:
            self.code[j + 1] = end

    def lower_repeated(self, t, path: str, region: int) -> None:
        """Array/map: block loop over items written to strided slots of a
        new region. Nested repetition lowers too (the region's parent is
        then an item region): the pipeline engine walks it, the row-padded
        engine takes row-level regions only."""
        rid = len(self.regions)
        self.regions.append(path)
        self.region_parents.append(region)
        at = self.emit(OP_REPEATED, self.buf(path + "#count", I32, region),
                       rid, None)
        if isinstance(t, Array):
            self.lower_type(t.items, path + "/@item", rid)
        else:  # Map: key string + value
            self.lower_type(Primitive("string"), path + "/@key", rid)
            self.lower_type(t.values, path + "/@val", rid)
        self.emit(OP_LOOP, at)
        self.code[at + 3] = len(self.code)


def lower(ir: AvroType) -> Program:
    """Lower a top-level record schema to its field program.

    Raises :class:`UnsupportedOnDevice` outside the device subset."""
    if not device_supported(ir):
        raise UnsupportedOnDevice("schema is outside the device subset")
    lo = _Lowering()
    lo.lower_type(ir, "", ROWS)
    lo.emit(OP_TRAILING)
    for key in sorted(lo.buffers):
        spec = lo.buffers[key]
        if spec.region == ROWS and key.endswith("#start"):
            lo.emit(OP_REBASE, key)
    lo.emit(OP_END)
    out_keys = sorted(lo.buffers)
    index = {k: i for i, k in enumerate(out_keys)}
    code = np.array(
        [index[w] if isinstance(w, str) else w for w in lo.code], np.int32
    )
    return Program(
        ir=ir,
        buffers=lo.buffers,
        regions=lo.regions,
        region_parents=lo.region_parents,
        string_cols=lo.string_cols,
        out_keys=out_keys,
        code=code,
    )
