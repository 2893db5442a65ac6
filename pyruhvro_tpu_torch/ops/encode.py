"""The encode program (K3): ``DeviceEncoder`` (port of ``pyruhvro_tpu/ops/encode.py:1301-1429``).

Arrow batch → Avro wire bytes, one launch per batch. The host extractor
(``ops/encode_extract.py``) walks the batch into per-path numpy lanes and
a byte bound; the lanes are packed into one uint8 buffer and copied to
the device once; the program computes every row's exact wire size, the
row starts by an int32 ``cumsum``, writes every field at its cursor and
copies the string, bytes, fixed and uuid payloads; one copy brings
``[0, total)`` and the row sizes back, and the host wraps them as a
``BinaryArray``. The wire form is canonical (minimal zig-zag varints,
single-block arrays/maps ``[count, items..., 0]`` or a bare ``0``,
branch indices in schema order), so any correct implementation writes
the same bytes as the reference.

Two implementations of the one program:

* K3, ``csrc/encode.cu``: ``encode_rows``, one thread per row
  interpreting the flat int32 **encode code** of :func:`lower_encoder`
  (size mode, then write mode at the row starts, each block of rows
  whose output span fits :meth:`_EncodeKernel.span_budget` storing it
  whole from shared memory), and ``encode_strings``, a persistent grid
  that copies each payload column's ``#bytes`` window by window of
  ``STRING_WINDOW`` bytes, staged by bulk asynchronous copies.
  :data:`encode_kernel` launches them;
* the plain version, :func:`encode_plain` (= :func:`rows_plain`, the
  ``cumsum`` and :func:`strings_plain`): the reference's emitters
  (``encode.py:160-613``) in PyTorch, vectorised over every lane with
  masks, scatters with ``mode="drop"`` semantics and ``_row_of`` as
  scatter-max plus ``cummax``. It walks the schema IR, not the code, so
  the card is held to an independent implementation.

:func:`run_program` launches the kernels for a buffer on a CUDA device and
takes the plain version only for a CPU buffer; nothing falls back.

Encode code (operands are ints; ``lane`` indexes ``EncProgram.lanes``,
``pc`` is absolute in ``EncProgram.code``). Every value op reads its
lane at the current index: the row, or the item of the innermost open
loop::

    VARINT32 lane            zig-zag varint of an int32 (int, enum)
    VARINT64 lo hi           zig-zag varint of an int64 as two u32 lanes
    F32 lane                 4 raw bytes (the bit pattern)
    F64 lo hi                8 raw bytes
    BOOL lane                1 byte
    STRING len dst           length varint; the payload's position → dst
    PAYLOAD size dst         constant-size payload (fixed, duration)
    DEC_BYTES dlen dec       length varint + big-endian bytes of #dec
    DEC_FIXED size dec       big-endian bytes, sign fill past byte 16
    NULLABLE valid null_idx end_pc
                             branch varint; the value's code follows
    UNION tid n end_pc start*n
                             branch varint; arm k's code at start (−1:
                             null arm), each arm ends with JUMP end_pc
    JUMP pc
    REPEATED count off end_pc
                             count varint (or a bare 0 and end_pc when
                             empty); items [off[i], off[i] + count[i])
                             run the item code that follows, then
    LOOP repeated_pc         next item, or the terminator 0
    END

Telemetry (the reference's, ``encode.py:1387-1419``): the phases
``device.pipeline_s`` (``op="encode"``), ``encode.extract_s``,
``encode.h2d_s`` and ``encode.d2h_s``, the counters
``encode.h2d_bytes`` / ``device.h2d_bytes`` and ``encode.d2h_bytes`` /
``device.d2h_bytes``, and one :func:`..runtime.device_obs.launch` per
batch (kind ``encode.pipeline``) whose entries are timed as
``encode_rows`` (size and write passes) and ``encode_strings``, with the
bytes of :func:`k3_bytes` over :func:`rows_traffic` while
``device_obs.count_walked_bytes`` is on (the walk is host work in
proportion to the batch); on the CPU the plain program is timed whole
as ``encode_plain``.
"""

from __future__ import annotations

import ctypes
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from ..errors import BatchTooLarge
from ..gate import device_supported
from ..runtime import device_obs, metrics, telemetry
from ..runtime.pack import bucket_len
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
from . import UnsupportedOnDevice
from .encode_extract import extract_batch, input_entries
from .fieldprog import ROWS
from .walk_decode import resolve_device

__all__ = ["DeviceEncoder", "EncProgram", "EncodeLaunch", "lower_encoder",
           "rows_traffic", "k3_bytes",
           "encode_plain", "rows_plain", "strings_plain", "run_program",
           "encode_kernel", "MAX_OUTPUT_BYTES", "OPCODES"]

# one launch's output bytes: int32 cursors and the 2^30 drop sentinel
# need the output under 2^30 bytes (``encode.py:1395-1400``); the codec
# halves a batch whose bound reaches it
MAX_OUTPUT_BYTES = 1 << 30
MAX_DEPTH = 16  # open loops a row keeps (csrc/encode.cu kMaxDepth)
ROW_BLOCK = 128  # rows of one encode_rows block (kThreads)
# an encode_rows block stages its output span in shared memory when it
# fits the launch's budget: the largest that costs no resident block, at
# least SPAN_FLOOR, at most SPAN_MAX (kSpanFloor, kSpanMax)
SPAN_FLOOR = 16384
SPAN_MAX = 65536
# encode_strings copies each payload column's #bytes in windows of
# STRING_WINDOW bytes, a block of STRING_THREADS threads staging a
# window's elements STRING_CHUNK at a time; a window stages a quarter
# more elements than the window before it held, and STRING_AHEAD
# (kWindow, kStringThreads, kChunk, kAhead)
STRING_WINDOW = 4096
STRING_THREADS = 256
STRING_CHUNK = 1024
STRING_AHEAD = 64
# a window of at most STRING_FEW elements copies them payload by payload
# with 16-byte stores (kFew); any other maps its bytes one by one
STRING_FEW = 32

OP_END = 0
OP_VARINT32 = 1
OP_VARINT64 = 2
OP_F32 = 3
OP_F64 = 4
OP_BOOL = 5
OP_STRING = 6
OP_PAYLOAD = 7
OP_DEC_BYTES = 8
OP_DEC_FIXED = 9
OP_NULLABLE = 10
OP_UNION = 11
OP_JUMP = 12
OP_REPEATED = 13
OP_LOOP = 14

OPCODES = {
    name: value for name, value in globals().items()
    if name.startswith("OP_")
}


# -- lowering: schema IR → encode code ------------------------------------------


@dataclass
class StrCol:
    """A column whose payload ``encode_strings`` copies: ``#src``,
    ``#len``, ``#bytes`` from the extractor, ``#dst`` written by the
    write pass (the payload's output position, −1 where not written)."""
    path: str
    region: int


@dataclass
class EncProgram:
    ir: Record
    regions: List[str]              # rid → path of the repeated field
    string_cols: List[StrCol]
    code: np.ndarray                # int32
    lanes: List[str]                # lane id → dv key (or #off / #dst)
    depth: int                      # deepest nesting of repeated fields
    _plain: Optional[object] = field(default=None, repr=False)

    def lane_id(self, key: str) -> int:
        return self.lanes.index(key)


class _CodeLowering:
    def __init__(self) -> None:
        self.regions: List[str] = [""]
        self.string_cols: List[StrCol] = []
        self.code: List[int] = []
        self.lanes: List[str] = []
        self.depth = 0

    def lane(self, key: str) -> int:
        if key not in self.lanes:
            self.lanes.append(key)
        return self.lanes.index(key)

    def emit(self, *words) -> int:
        pc = len(self.code)
        self.code.extend(int(w) for w in words)
        return pc

    def lower_type(self, t: AvroType, path: str, region: int,
                   depth: int) -> None:
        if isinstance(t, Primitive):
            self.lower_primitive(t, path, region)
        elif isinstance(t, Fixed):
            if t.logical == "decimal":
                self.emit(OP_DEC_FIXED, t.size, self.lane(path + "#dec"))
            else:
                self.string_cols.append(StrCol(path, region))
                self.emit(OP_PAYLOAD, t.size, self.lane(path + "#dst"))
        elif isinstance(t, Enum):
            self.emit(OP_VARINT32, self.lane(path + "#v"))
        elif isinstance(t, Record):
            prefix = path + "/" if path else ""
            for f in t.fields:
                self.lower_type(f.type, prefix + f.name, region, depth)
        elif isinstance(t, Union):
            if t.is_nullable_pair:
                pc = self.emit(OP_NULLABLE, self.lane(path + "#valid"),
                               t.null_index, -1)
                self.lower_type(t.non_null_variant, path, region, depth)
                self.code[pc + 3] = len(self.code)
            else:
                self.lower_union(t, path, region, depth)
        elif isinstance(t, (Array, Map)):
            self.lower_repeated(t, path, region, depth)
        else:
            raise UnsupportedOnDevice(f"type {type(t).__name__} at {path!r}")

    def lower_primitive(self, t: Primitive, path: str, region: int) -> None:
        name = t.name
        if name == "null":
            return
        if name == "int":
            self.emit(OP_VARINT32, self.lane(path + "#v"))
        elif name == "long":
            self.emit(OP_VARINT64, self.lane(path + "#v:lo"),
                      self.lane(path + "#v:hi"))
        elif name == "float":
            self.emit(OP_F32, self.lane(path + "#v"))
        elif name == "double":
            self.emit(OP_F64, self.lane(path + "#v:lo"),
                      self.lane(path + "#v:hi"))
        elif name == "boolean":
            self.emit(OP_BOOL, self.lane(path + "#v"))
        elif name == "bytes" and t.logical == "decimal":
            self.emit(OP_DEC_BYTES, self.lane(path + "#dlen"),
                      self.lane(path + "#dec"))
        elif name in ("string", "bytes"):
            # uuid arrives as its 36-character text in the string layout
            self.string_cols.append(StrCol(path, region))
            self.emit(OP_STRING, self.lane(path + "#len"),
                      self.lane(path + "#dst"))
        else:
            raise UnsupportedOnDevice(f"primitive {name!r} at {path!r}")

    def lower_union(self, t: Union, path: str, region: int,
                    depth: int) -> None:
        n = len(t.variants)
        pc = self.emit(OP_UNION, self.lane(path + "#tid"), n, -1,
                       *([-1] * n))
        jumps = []
        for k, v in enumerate(t.variants):
            if v.is_null():
                continue
            self.code[pc + 4 + k] = len(self.code)
            self.lower_type(v, f"{path}/{k}", region, depth)
            jumps.append(self.emit(OP_JUMP, -1))
        end = len(self.code)
        self.code[pc + 3] = end
        for j in jumps:
            self.code[j + 1] = end

    def lower_repeated(self, t, path: str, region: int, depth: int) -> None:
        rid = len(self.regions)
        self.regions.append(path)
        depth += 1
        if depth > MAX_DEPTH:
            raise UnsupportedOnDevice(
                f"{path!r} nests {depth} arrays/maps (device limit "
                f"{MAX_DEPTH})")
        self.depth = max(self.depth, depth)
        pc = self.emit(OP_REPEATED, self.lane(path + "#count"),
                       self.lane(path + "#off"), -1)
        if isinstance(t, Array):
            self.lower_type(t.items, path + "/@item", rid, depth)
        else:
            self.lower_type(Primitive("string"), path + "/@key", rid, depth)
            self.lower_type(t.values, path + "/@val", rid, depth)
        self.emit(OP_LOOP, pc)
        self.code[pc + 3] = len(self.code)


def lower_encoder(ir: AvroType) -> EncProgram:
    """Lower a top-level record schema to its encode program (the
    reference's ``lower_encoder``, ``encode.py:556``: the same subset as
    the decode, and the same region and string-column order)."""
    if not device_supported(ir):
        raise UnsupportedOnDevice("schema is outside the device subset")
    lo = _CodeLowering()
    lo.lower_type(ir, "", ROWS, 0)
    lo.emit(OP_END)
    for col in lo.string_cols:  # encode_strings' column table
        for suffix in ("#src", "#len", "#bytes", "#dst"):
            lo.lane(col.path + suffix)
    return EncProgram(ir=ir, regions=lo.regions,
                      string_cols=lo.string_cols,
                      code=np.asarray(lo.code, np.int32), lanes=lo.lanes,
                      depth=lo.depth)


# -- the plain version (≙ the reference's emitters) -----------------------------

_M32 = 0xFFFFFFFF
I64 = torch.int64


def _u32(t: torch.Tensor) -> torch.Tensor:
    """A lane's u32 bit pattern as int64 (int32 lanes hold u32 bits)."""
    return t.to(I64) & _M32


def _take_clip(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return src[torch.clamp(idx, 0, src.numel() - 1)]


def _zigzag32(v: torch.Tensor):
    """Zig-zag of an int32 lane as a (lo, hi = 0) u32 pair."""
    x = v.to(I64)
    return ((x << 1) ^ (x >> 31)) & _M32, torch.zeros_like(x)


def _zigzag64(lo: torch.Tensor, hi: torch.Tensor):
    """Zig-zag of an int64 carried as (lo, hi) u32 words."""
    slo = (lo << 1) & _M32
    shi = ((hi << 1) | (lo >> 31)) & _M32
    m = (-(hi >> 31)) & _M32
    return slo ^ m, shi ^ m


def _varint_size(zlo: torch.Tensor, zhi: torch.Tensor) -> torch.Tensor:
    size = torch.ones_like(zlo)
    for k in range(1, 10):
        bits = 7 * k
        if bits < 32:
            ge = (zhi != 0) | (zlo >= (1 << bits))
        else:
            ge = zhi >= (1 << (bits - 32))
        size = size + ge.to(I64)
    return size


def _put_byte(out: torch.Tensor, idx: torch.Tensor, byte: torch.Tensor,
              mask: torch.Tensor) -> None:
    """``out.at[where(mask, idx, BIG)].set(byte, mode="drop")``."""
    idx = torch.broadcast_to(idx, mask.shape)
    byte = torch.broadcast_to(byte, mask.shape)
    keep = mask & (idx >= 0) & (idx < out.numel())
    out[idx[keep]] = byte[keep].to(torch.uint8)


def _put_varint(out, cursor, zlo, zhi, nbytes, mask) -> None:
    for k in range(10):
        bits = 7 * k
        if bits < 32:
            g = zlo >> bits
            if bits + 7 > 32:
                g = g | (zhi << (32 - bits))
        else:
            g = zhi >> (bits - 32)
        g = g & 0x7F
        byte = torch.where(k < nbytes - 1, g | 0x80, g)
        _put_byte(out, cursor + k, byte, mask & (k < nbytes))


def _row_of(offsets: torch.Tensor, n_entries: int, cap: int) -> torch.Tensor:
    """Entry owning each position j < cap, given the entries' starts: one
    scatter-max (out-of-range starts dropped) and one cummax."""
    idx = offsets[:n_entries].to(I64)
    keep = (idx >= 0) & (idx < cap)
    m = torch.zeros(cap, dtype=I64, device=offsets.device)
    m.scatter_reduce_(0, idx[keep], torch.arange(
        n_entries, dtype=I64, device=offsets.device)[keep], "amax")
    return torch.cummax(m, 0).values


class _Cx:
    """State threaded through the plain emitters."""

    def __init__(self, dv, out):
        self.dv = dv          # key → tensor (int32 lanes hold u32 bits)
        self.out = out        # uint8 output, updated in place
        self.sizes = {}       # memoized size vectors
        self.str_dst = {}     # path → (payload position, write mask)
        self.item = {}        # rid → item-axis bookkeeping


class _PlainLowering:
    """The reference's ``_EncLowering`` (``encode.py:160-554``) with
    PyTorch in place of ``jnp``: ``(size, write)`` closures per type."""

    def __init__(self) -> None:
        self.regions: List[str] = [""]
        self.string_cols: List[StrCol] = []

    def lower_type(self, t: AvroType, path: str, region: int):
        if isinstance(t, Primitive):
            return self.lower_primitive(t, path, region)
        if isinstance(t, Fixed):
            if t.logical == "decimal":
                return self.lower_decimal(path, region, fixed_size=t.size)
            return self.lower_fixed(t, path, region)
        if isinstance(t, Enum):
            return self.lower_varint_leaf(path + "#v", path, wide=False)
        if isinstance(t, Record):
            return self.lower_record(t, path, region)
        if isinstance(t, Union):
            if t.is_nullable_pair:
                return self.lower_nullable(t, path, region)
            return self.lower_union(t, path, region)
        if isinstance(t, (Array, Map)):
            return self.lower_repeated(t, path, region)
        raise UnsupportedOnDevice(f"type {type(t).__name__} at {path!r}")

    def lower_varint_leaf(self, key: str, path: str, wide: bool):
        def pair(cx):
            if wide:
                return _zigzag64(_u32(cx.dv[key + ":lo"]),
                                 _u32(cx.dv[key + ":hi"]))
            return _zigzag32(cx.dv[key])

        def size(cx):
            s = cx.sizes.get(path)
            if s is None:
                s = cx.sizes[path] = _varint_size(*pair(cx))
            return s

        def write(cx, cursor, mask):
            zlo, zhi = pair(cx)
            _put_varint(cx.out, cursor, zlo, zhi, size(cx), mask)

        return size, write

    def lower_primitive(self, t: Primitive, path: str, region: int):
        name = t.name
        active = "#active:%d" % region
        if name == "null":
            return ((lambda cx: torch.zeros(cx.dv[active].shape[0],
                                            dtype=I64,
                                            device=cx.out.device)),
                    (lambda cx, cursor, mask: None))
        if name in ("int", "long"):
            return self.lower_varint_leaf(path + "#v", path,
                                          wide=name == "long")
        if name in ("float", "double", "boolean"):
            words = {"float": ("#v",), "double": ("#v:lo", "#v:hi"),
                     "boolean": ()}[name]

            def size_c(cx):
                n = cx.dv[path + ("#v" if name != "double" else "#v:lo")]
                return torch.full((n.shape[0],), 4 * len(words) or 1,
                                  dtype=I64, device=n.device)

            def write_c(cx, cursor, mask):
                if name == "boolean":
                    _put_byte(cx.out, cursor, cx.dv[path + "#v"].to(I64),
                              mask)
                    return
                for half, word in enumerate(words):
                    w = cx.dv[path + word]
                    w = _u32(w.view(torch.int32) if w.dtype ==
                             torch.float32 else w)
                    for k in range(4):
                        _put_byte(cx.out, cursor + 4 * half + k,
                                  (w >> (8 * k)) & 0xFF, mask)

            return size_c, write_c
        if name == "bytes" and t.logical == "decimal":
            return self.lower_decimal(path, region, fixed_size=None)
        if name in ("string", "bytes"):
            self.string_cols.append(StrCol(path, region))

            def size_s(cx):
                s = cx.sizes.get(path)
                if s is None:
                    lens = cx.dv[path + "#len"]
                    s = cx.sizes[path] = (_varint_size(*_zigzag32(lens))
                                          + lens.to(I64))
                return s

            def write_s(cx, cursor, mask):
                zlo, zhi = _zigzag32(cx.dv[path + "#len"])
                ns = _varint_size(zlo, zhi)
                _put_varint(cx.out, cursor, zlo, zhi, ns, mask)
                cx.str_dst[path] = (cursor + ns, mask)

            return size_s, write_s
        raise UnsupportedOnDevice(f"primitive {name!r} at {path!r}")

    def lower_fixed(self, t: Fixed, path: str, region: int):
        self.string_cols.append(StrCol(path, region))

        def size(cx):
            lens = cx.dv[path + "#len"]
            return torch.full((lens.shape[0],), t.size, dtype=I64,
                              device=lens.device)

        def write(cx, cursor, mask):
            cx.str_dst[path] = (cursor, mask)

        return size, write

    def lower_decimal(self, path: str, region: int,
                      fixed_size: Optional[int]):
        def n_of(cx):
            if fixed_size is not None:
                act = cx.dv["#active:%d" % region]
                return torch.full((act.shape[0],), fixed_size, dtype=I64,
                                  device=act.device)
            return cx.dv[path + "#dlen"].to(I64)

        def write_bytes(cx, at, mask, n):
            dec = cx.dv[path + "#dec"].to(I64)
            ent = torch.arange(n.shape[0], dtype=I64, device=n.device) * 16
            msb = _take_clip(dec, ent + 15)
            fill = torch.where(msb >= 0x80, 0xFF, 0)
            kmax = 17 if fixed_size is None else fixed_size
            for k in range(kmax):
                le = n - 1 - k
                in16 = (le >= 0) & (le < 16)
                b = torch.where(in16, _take_clip(dec, ent + le.clamp(0, 15)),
                                fill)
                _put_byte(cx.out, at + k, b, mask & (k < n))

        if fixed_size is not None:
            def size_f(cx):
                return n_of(cx)

            def write_f(cx, cursor, mask):
                write_bytes(cx, cursor, mask, n_of(cx))

            return size_f, write_f

        def size(cx):
            s = cx.sizes.get(path)
            if s is None:
                n = n_of(cx)
                s = cx.sizes[path] = _varint_size(*_zigzag32(n)) + n
            return s

        def write(cx, cursor, mask):
            n = n_of(cx)
            zlo, zhi = _zigzag32(n)
            ns = _varint_size(zlo, zhi)
            _put_varint(cx.out, cursor, zlo, zhi, ns, mask)
            write_bytes(cx, cursor + ns, mask, n)

        return size, write

    def lower_record(self, t: Record, path: str, region: int):
        prefix = path + "/" if path else ""
        fields = [self.lower_type(f.type, prefix + f.name, region)
                  for f in t.fields]

        def size(cx):
            s = cx.sizes.get(path + "#rec")
            if s is None:
                act = cx.dv["#active:%d" % region]
                s = torch.zeros(act.shape[0], dtype=I64, device=act.device)
                for fsize, _ in fields:
                    s = s + fsize(cx)
                cx.sizes[path + "#rec"] = s
            return s

        def write(cx, cursor, mask):
            for fsize, fwrite in fields:
                fwrite(cx, cursor, mask)
                cursor = cursor + torch.where(mask, fsize(cx), 0)

        return size, write

    def lower_nullable(self, t: Union, path: str, region: int):
        null_idx = t.null_index
        val_idx = 1 - null_idx
        inner_size, inner_write = self.lower_type(t.non_null_variant, path,
                                                  region)

        def branch(cx):
            valid = cx.dv[path + "#valid"] != 0
            return valid, torch.where(valid, val_idx, null_idx)

        def size(cx):
            s = cx.sizes.get(path + "#nul")
            if s is None:
                valid, b = branch(cx)
                s = _varint_size(*_zigzag32(b)) + torch.where(
                    valid, inner_size(cx), 0)
                cx.sizes[path + "#nul"] = s
            return s

        def write(cx, cursor, mask):
            valid, b = branch(cx)
            zlo, zhi = _zigzag32(b)
            ns = _varint_size(zlo, zhi)
            _put_varint(cx.out, cursor, zlo, zhi, ns, mask)
            inner_write(cx, cursor + ns, mask & valid)

        return size, write

    def lower_union(self, t: Union, path: str, region: int):
        arms = [None if v.is_null() else
                self.lower_type(v, f"{path}/{k}", region)
                for k, v in enumerate(t.variants)]

        def size(cx):
            s = cx.sizes.get(path + "#uni")
            if s is None:
                tid = cx.dv[path + "#tid"]
                s = _varint_size(*_zigzag32(tid))
                for k, arm in enumerate(arms):
                    if arm is not None:
                        s = s + torch.where(tid == k, arm[0](cx), 0)
                cx.sizes[path + "#uni"] = s
            return s

        def write(cx, cursor, mask):
            tid = cx.dv[path + "#tid"]
            zlo, zhi = _zigzag32(tid)
            ns = _varint_size(zlo, zhi)
            _put_varint(cx.out, cursor, zlo, zhi, ns, mask)
            for k, arm in enumerate(arms):
                if arm is not None:
                    arm[1](cx, cursor + ns, mask & (tid == k))

        return size, write

    def lower_repeated(self, t, path: str, region: int):
        rid = len(self.regions)
        self.regions.append(path)
        if isinstance(t, Array):
            items = [self.lower_type(t.items, path + "/@item", rid)]
        else:
            items = [
                self.lower_type(Primitive("string"), path + "/@key", rid),
                self.lower_type(t.values, path + "/@val", rid),
            ]

        def axis(cx):
            info = cx.item.get(rid)
            if info is None:
                counts = cx.dv[path + "#count"].to(I64)
                R = counts.shape[0]
                off = torch.cat([counts.new_zeros(1), torch.cumsum(counts,
                                                                   0)])
                T = cx.dv["#active:%d" % rid].shape[0]
                j = torch.arange(T, dtype=I64, device=counts.device)
                row = _row_of(off, R, T)
                active = j < off[-1]
                isize = torch.zeros(T, dtype=I64, device=counts.device)
                for s, _ in items:
                    isize = isize + s(cx)
                isize = torch.where(active, isize, 0)
                ex = torch.cumsum(isize, 0) - isize
                within = ex - _take_clip(ex, _take_clip(off, row))
                per_row = torch.zeros(R, dtype=I64, device=counts.device)
                per_row.index_add_(0, row, isize)
                info = cx.item[rid] = {"counts": counts, "row": row,
                                       "active": active, "within": within,
                                       "per_row": per_row}
            return info

        def size(cx):
            s = cx.sizes.get(path + "#rep")
            if s is None:
                info = axis(cx)
                counts = info["counts"]
                ns = _varint_size(*_zigzag32(counts))
                s = torch.where(counts > 0, ns + info["per_row"] + 1, 1)
                cx.sizes[path + "#rep"] = s
            return s

        def write(cx, cursor, mask):
            info = axis(cx)
            counts = info["counts"]
            zlo, zhi = _zigzag32(counts)
            ns = _varint_size(zlo, zhi)
            nonempty = mask & (counts > 0)
            _put_varint(cx.out, cursor, zlo, zhi, ns, nonempty)
            # the terminator 0 is the block's last byte (an empty block's
            # only byte)
            _put_byte(cx.out, cursor + size(cx) - 1, torch.zeros_like(zlo),
                      mask)
            icur = _take_clip(cursor + ns, info["row"]) + info["within"]
            item_mask = info["active"] & _take_clip(nonempty, info["row"])
            for s, w in items:
                w(cx, icur, item_mask)
                icur = icur + torch.where(item_mask, s(cx), 0)

        return size, write


def _plain_program(prog: EncProgram):
    """The plain emitters of ``prog``'s schema, built once."""
    if prog._plain is None:
        lo = _PlainLowering()
        size, write = lo.lower_record(prog.ir, "", ROWS)
        if lo.regions != prog.regions or [c.path for c in lo.string_cols] \
                != [c.path for c in prog.string_cols]:  # pragma: no cover
            raise AssertionError("plain emitters and encode code disagree")
        prog._plain = (size, write)
    return prog._plain


def rows_plain(dv: Dict[str, torch.Tensor], prog: EncProgram, cap: int):
    """``encode_rows``' plain version, size and write passes with the
    row-start ``cumsum`` between them: ``(out, row_sizes, dst)`` —
    ``out`` uint8 ``[cap]`` with every non-payload byte (zeros elsewhere),
    ``row_sizes`` int32 ``[R]``, ``dst`` each string column's payload
    positions (int32, −1 where the payload is not written)."""
    size, write = _plain_program(prog)
    active = dv["#active:0"] != 0
    out = torch.zeros(cap, dtype=torch.uint8, device=active.device)
    cx = _Cx(dv, out)
    row_sizes = torch.where(active, size(cx), 0)
    start = torch.cumsum(row_sizes, 0) - row_sizes
    write(cx, start, active)
    dst = {}
    for col in prog.string_cols:
        d, mask = cx.str_dst[col.path]
        dst[col.path] = torch.where(mask, d, -1).to(torch.int32)
    return out, row_sizes.to(torch.int32), dst


def strings_plain(out: torch.Tensor, dv: Dict[str, torch.Tensor],
                  prog: EncProgram, dst: Dict[str, torch.Tensor]) -> None:
    """``encode_strings``' plain version (``_write_string_bytes``,
    ``encode.py:579-613``): every source byte finds its element by
    scatter-max + cummax over the element starts and goes to
    ``dst[elem] + position`` when the element is written."""
    for col in prog.string_cols:
        d = dst[col.path].to(I64)
        src = dv[col.path + "#src"]
        lens = dv[col.path + "#len"].to(I64)
        data = dv[col.path + "#bytes"].contiguous().view(torch.uint8)
        V = data.numel()
        j = torch.arange(V, dtype=I64, device=out.device)
        elem = _row_of(src, src.shape[0], V)
        pos = j - _take_clip(src, elem).to(I64)
        ok = (pos >= 0) & (pos < _take_clip(lens, elem)) & \
            (_take_clip(d, elem) >= 0)
        _put_byte(out, _take_clip(d, elem) + pos, data.to(I64), ok)


def encode_plain(dv: Dict[str, torch.Tensor], prog: EncProgram,
                 cap: int) -> torch.Tensor:
    """K3's plain version, on any device: the reference's
    ``DeviceEncoder._program.run`` (``encode.py:1328-1341``) →
    ``[cap bytes | row_sizes int32 [R]]`` as uint8."""
    out, row_sizes, dst = rows_plain(dv, prog, cap)
    strings_plain(out, dv, prog, dst)
    return torch.cat([out, row_sizes.view(torch.uint8)])


# -- one launch: the packed buffer and its tables -------------------------------


def payload_extent(src: np.ndarray, lens: np.ndarray, nbytes: int) -> int:
    """The bytes of a payload column's ``#bytes`` that ``strings_plain``
    may copy: ``[0, extent)``. Every byte past the start of the last
    element that starts inside the buffer belongs to that element
    (``#src`` is non-decreasing, its pads ``_BIG``), so the bytes past its
    end are never copied."""
    k = int(np.searchsorted(src, nbytes, side="left"))
    if k == 0:
        return 0
    return min(nbytes, int(src[k - 1]) + int(lens[k - 1]))


def span_plan(row_sizes: torch.Tensor, n: int, budget: int) -> Tuple[int,
                                                                       int]:
    """``(staged, direct)``: the ``encode_rows`` write blocks whose output
    span, widened down to a 16-B bound, fits ``budget`` (stored whole from
    shared memory) and the others (stored row by row); blocks without
    rows below ``n`` count in neither. The kernel decides the same way."""
    if n == 0:
        return 0, 0
    sizes = row_sizes[:n].to(torch.int64)
    end = torch.cumsum(sizes, 0)
    first = torch.arange(0, n, ROW_BLOCK, device=sizes.device)
    last = torch.clamp(first + ROW_BLOCK, max=n) - 1
    start = end[first] - sizes[first]
    fits = end[last] - (start & ~15) <= budget
    staged = int(fits.sum())
    return staged, first.numel() - staged

_ALIGN = 16
_COL_WORDS = 8  # src len bytes dst lanes, elements, extent, first window, 0


def _aligned(nbytes: int) -> int:
    return (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN


# the extractor's lane dtypes (u32 lanes viewed as int32 bit patterns)
_TORCH = {"uint8": torch.uint8, "int32": torch.int32, "uint32": torch.int32,
          "float32": torch.float32}


class EncodeLaunch:
    """One launch's buffer: ``[code | lane offsets | column table |
    the extractor's lanes, sorted by key | #off per region | #dst per
    string column]``, each part 16-byte aligned. The host builds everything
    before the scratch lanes (:meth:`pack`), one copy moves it to the
    device (:meth:`upload`); ``#off`` (each region's exclusive ``cumsum``
    of its ``#count``, over every lane of the parent axis) and ``#dst``
    are written there."""

    def __init__(self, prog: EncProgram, dv: Dict[str, np.ndarray],
                 cap: int, n: int):
        self.prog, self.cap, self.n = prog, cap, n
        self.R = dv["#active:0"].shape[0]
        self.dv_np = dv
        layout: Dict[str, Tuple[int, str, int]] = {}
        pos = 0
        code = prog.code
        lanes_at = pos = _aligned(code.nbytes)
        pos += _aligned(8 * len(prog.lanes))
        cols_at = pos
        pos += _aligned(4 * _COL_WORDS * len(prog.string_cols))
        self.entries = input_entries(dv)
        for key, dt, ln in self.entries:
            layout[key] = (pos, dt, ln)
            pos += _aligned(np.dtype(dt).itemsize * ln)
        self.in_bytes = pos
        for rid in range(1, len(prog.regions)):
            ln = dv[prog.regions[rid] + "#count"].shape[0] + 1
            layout[prog.regions[rid] + "#off"] = (pos, "int32", ln)
            pos += _aligned(4 * ln)
        self.dst_at = pos
        cols, n_elems, n_windows = [], 0, 0
        for col in prog.string_cols:
            ln = dv[col.path + "#len"].shape[0]
            layout[col.path + "#dst"] = (pos, "int32", ln)
            pos += _aligned(4 * ln)
            extent = payload_extent(dv[col.path + "#src"],
                                    dv[col.path + "#len"],
                                    dv[col.path + "#bytes"].nbytes)
            cols.append([prog.lane_id(col.path + s) for s in
                         ("#src", "#len", "#bytes", "#dst")]
                        + [ln, extent, n_windows, 0])
            n_elems += ln
            n_windows += -(-extent // STRING_WINDOW)
        self.n_elems, self.n_windows = n_elems, n_windows
        self.span_budget: Optional[int] = None  # set by the write launch
        self.total_bytes = pos
        self.layout = layout
        self.lanes_at, self.cols_at = lanes_at, cols_at
        self.lane_offs = np.array([layout[k][0] for k in prog.lanes],
                                  np.int64)
        self.cols = np.asarray(cols, np.int32).reshape(-1, _COL_WORDS)
        self.buf: Optional[torch.Tensor] = None

    def pack(self) -> np.ndarray:
        """The host part of the buffer, ``[0, in_bytes)``."""
        host = np.zeros(self.in_bytes, np.uint8)
        code = self.prog.code
        host[:code.nbytes] = code.view(np.uint8)
        host[self.lanes_at:self.lanes_at + self.lane_offs.nbytes] = \
            self.lane_offs.view(np.uint8)
        host[self.cols_at:self.cols_at + self.cols.nbytes] = \
            self.cols.reshape(-1).view(np.uint8)
        for key, dt, ln in self.entries:
            at = self.layout[key][0]
            arr = np.ascontiguousarray(self.dv_np[key]).view(np.uint8)
            host[at:at + arr.size] = arr.reshape(-1)
        return host

    def upload(self, host: np.ndarray, device) -> torch.Tensor:
        """The whole buffer on ``device``: the host part copied in once,
        the scratch lanes left for the program."""
        self.buf = torch.empty(self.total_bytes, dtype=torch.uint8,
                               device=device)
        self.buf[:self.in_bytes].copy_(torch.from_numpy(host))
        return self.buf

    def view(self, key: str) -> torch.Tensor:
        at, dt, ln = self.layout[key]
        nbytes = np.dtype(dt).itemsize * ln
        return self.buf[at:at + nbytes].view(_TORCH[dt])

    def dv(self) -> Dict[str, torch.Tensor]:
        """The extractor's lanes as typed views of the buffer (u32 lanes
        as int32 bit patterns)."""
        return {key: self.view(key) for key, _dt, _ln in self.entries}

    def code_view(self) -> torch.Tensor:
        return self.buf[:self.prog.code.nbytes].view(torch.int32)

    def lanes_view(self) -> torch.Tensor:
        return self.buf[self.lanes_at:self.lanes_at + 8 * len(
            self.prog.lanes)].view(torch.int64)

    def cols_view(self) -> torch.Tensor:
        return self.buf[self.cols_at:self.cols_at + self.cols.nbytes].view(
            torch.int32)

    def dst(self) -> Dict[str, torch.Tensor]:
        return {c.path: self.view(c.path + "#dst")
                for c in self.prog.string_cols}

    def set_offsets(self) -> None:
        """Each region's ``#off``: 0, then the running sum of ``#count``
        over every lane of its parent axis (the extractor lays the items
        out in that order, masked lanes included)."""
        for rid in range(1, len(self.prog.regions)):
            path = self.prog.regions[rid]
            off = self.view(path + "#off")
            off[:1].zero_()
            torch.cumsum(self.view(path + "#count"), 0, dtype=torch.int32,
                         out=off[1:])

    def clear_dst(self) -> None:
        """Every ``#dst`` to −1: a payload the write pass does not place
        is not copied."""
        self.buf[self.dst_at:].view(torch.int32).fill_(-1)

    def input_bytes(self) -> int:
        """Bytes of the extractor's lanes (what the passes must read)."""
        return sum(np.dtype(dt).itemsize * ln for _k, dt, ln in self.entries)


# -- K3: the kernel --------------------------------------------------------------


class _Entry:
    """One C entry point's launch count; it grows only where the entry
    is launched."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


class _EncodeKernel:
    """Launches ``csrc/encode.cu``: ``rows`` counts ``encode_rows``
    launches (two per batch: size, then write), ``strings`` counts
    ``encode_strings`` launches (one per batch with payload columns)."""

    source = "encode.cu"

    def __init__(self):
        self.rows = _Entry("encode_rows")
        self.strings = _Entry("encode_strings")
        self._lock = threading.Lock()
        self._free: Dict[tuple, int] = {}  # (card, lanes, code) -> bytes

    def library(self):
        from ._build import load_kernel_library

        lib = load_kernel_library(self.source)
        rows = lib.cdll.encode_rows
        if rows.argtypes is None:
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            rows.argtypes = [P, P, I, P, I,  # base code code_len lanes
                                             # n_lanes
                             I, I, I, I, I,  # n R depth write span_budget
                             P, P, P, P,     # cum row_sizes out stream
                             P, P]           # ev0 ev1
            rows.restype = ctypes.c_int
            strings = lib.cdll.encode_strings
            strings.argtypes = [P, P, P, I,  # base lanes cols n_cols
                                LL, P, P,    # n_windows out stream
                                P, P]        # ev0 ev1
            strings.restype = ctypes.c_int
            smem = lib.cdll.encode_rows_smem_bytes
            smem.argtypes = [I, I, I]        # n_lanes code_len span_budget
            smem.restype = ctypes.c_int
            occ = lib.cdll.encode_rows_blocks_per_sm
            occ.argtypes = [I]               # smem_bytes
            occ.restype = ctypes.c_int
        return lib

    def _count(self, entry: _Entry) -> None:
        with self._lock:
            entry.launches += 1

    def free_span_bytes(self, L: EncodeLaunch) -> int:
        """The largest span staging (16-B steps, at most ``SPAN_MAX``) at
        which as many ``encode_rows`` blocks fit an SM as with none, by
        the CUDA occupancy query (on the current card, which
        :meth:`launch_rows` sets to the launch's); kept per card and table
        size."""
        shape = (len(L.prog.lanes), len(L.prog.code))
        key = (L.buf.device, *shape)
        free = self._free.get(key)
        if free is None:
            cdll = self.library().cdll
            smem = cdll.encode_rows_smem_bytes
            per_sm = cdll.encode_rows_blocks_per_sm
            want = per_sm(smem(*shape, 0))
            if want <= 0:
                raise RuntimeError(f"encode_rows occupancy query failed: "
                                   f"CUDA error {-want}")
            lo, hi = 0, SPAN_MAX // 16
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if per_sm(smem(*shape, 16 * mid)) >= want:
                    lo = mid
                else:
                    hi = mid - 1
            with self._lock:
                free = self._free.setdefault(key, 16 * lo)
        return free

    def span_budget(self, L: EncodeLaunch) -> int:
        """The span staging of ``L``'s write launch:
        :meth:`free_span_bytes`, at least ``SPAN_FLOOR`` (a block of 128
        Kafka rows needs a little more than costs no block, and staging
        every block at one block fewer an SM beats storing some row by
        row)."""
        return max(self.free_span_bytes(L), SPAN_FLOOR)

    def launch_rows(self, L: EncodeLaunch, write: bool, row_sizes,
                    cum=None, out=None, budget: int = None) -> None:
        """One ``encode_rows`` launch: size mode writes ``row_sizes``;
        write mode writes every non-payload byte of ``out`` at the row
        starts ``cum - row_sizes`` and the ``#dst`` lanes, each block
        whose span fits ``budget`` (by default :meth:`span_budget`)
        through shared memory."""
        if L.buf.device.type != "cuda":
            raise RuntimeError("encode_kernel takes CUDA tensors")
        if write and budget is None:
            with torch.cuda.device(L.buf.device):
                budget = L.span_budget = self.span_budget(L)
        fn = self.library().cdll.encode_rows
        st = torch.cuda.current_stream(L.buf.device)
        stream = st.cuda_stream
        args = (L.buf.data_ptr(), L.code_view().data_ptr(),
                len(L.prog.code), L.lanes_view().data_ptr(),
                len(L.prog.lanes), L.n, L.R, L.prog.depth, int(write),
                budget if write else 0,
                None if cum is None else cum.data_ptr(),
                row_sizes.data_ptr(), None if out is None else out.data_ptr(),
                stream)
        with torch.cuda.device(L.buf.device), \
                device_obs.timed("encode_rows", L.buf.device, st) as t:
            rc = fn(*args, *t.events)
            if rc != 0:
                raise RuntimeError(f"encode_rows launch failed: CUDA error "
                                   f"{rc}")
        self._count(self.rows)

    def launch_strings(self, L: EncodeLaunch, out) -> None:
        """One ``encode_strings`` launch: every written payload element's
        bytes from ``#bytes`` at ``#src`` to ``out`` at ``#dst``, over
        ``L.n_windows`` windows of ``STRING_WINDOW`` source bytes, each
        block of the grid walking a run of them."""
        if L.buf.device.type != "cuda":
            raise RuntimeError("encode_kernel takes CUDA tensors")
        fn = self.library().cdll.encode_strings
        st = torch.cuda.current_stream(L.buf.device)
        stream = st.cuda_stream
        args = (L.buf.data_ptr(), L.lanes_view().data_ptr(),
                L.cols_view().data_ptr(), len(L.cols), L.n_windows,
                out.data_ptr(), stream)
        with torch.cuda.device(L.buf.device), \
                device_obs.timed("encode_strings", L.buf.device, st) as t:
            rc = fn(*args, *t.events)
            if rc != 0:
                raise RuntimeError(f"encode_strings launch failed: CUDA "
                                   f"error {rc}")
        self._count(self.strings)

    def run(self, L: EncodeLaunch, timings=None):
        """The whole program on ``L``'s buffer: ``(out, row_sizes)``, out
        uint8 ``[cap]`` (only ``[0, total)`` is written) and row_sizes
        int32 ``[R]``. With ``timings``, each phase ends in a synchronise
        and its host seconds are added there."""
        dev = L.buf.device
        clock = _PhaseClock(dev, timings)
        L.set_offsets()
        row_sizes = torch.empty(L.R, dtype=torch.int32, device=dev)
        self.launch_rows(L, False, row_sizes)
        clock.lap("size_s")
        cum = torch.cumsum(row_sizes, 0, dtype=torch.int32)
        clock.lap("cumsum_s")
        out = torch.empty(L.cap, dtype=torch.uint8, device=dev)
        L.clear_dst()
        self.launch_rows(L, True, row_sizes, cum, out)
        clock.lap("write_s")
        if L.n_windows:
            self.launch_strings(L, out)
        clock.lap("strings_s")
        return out, row_sizes


encode_kernel = _EncodeKernel()


class _PhaseClock:
    """Host seconds per phase, each ending in a synchronise (no-op
    without a timings dict)."""

    def __init__(self, dev, timings):
        self.dev, self.timings = dev, timings
        self.t = time.perf_counter()

    def lap(self, key: str) -> None:
        if self.timings is None:
            return
        self.sync()
        now = time.perf_counter()
        self.timings[key] = self.timings.get(key, 0.0) + now - self.t
        self.t = now

    def sync(self) -> None:
        """The phase's end: a synchronise on the card, with a timings
        dict only."""
        if self.timings is not None and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def add(self, key: str, seconds: float) -> None:
        """A phase measured by its telemetry phase (one measurement, two
        views); the next lap starts now."""
        if self.timings is not None:
            self.timings[key] = self.timings.get(key, 0.0) + seconds
        self.t = time.perf_counter()


def run_program(L: EncodeLaunch, timings=None):
    """K3 for the buffer's device: the kernels for a CUDA buffer (phases
    timed into ``timings`` when given), the plain version for a CPU
    buffer. ``(out, row_sizes)``."""
    if L.buf.device.type == "cuda":
        return encode_kernel.run(L, timings)
    if L.buf.device.type == "cpu":
        with device_obs.timed("encode_plain", L.buf.device):
            blob = encode_plain(L.dv(), L.prog, L.cap)
        return blob[:L.cap], blob[L.cap:].view(torch.int32)
    raise RuntimeError(f"no encode for device {L.buf.device}")


# -- the bytes K3 must move (PERF.md's bounds; chip_smoke.py and device_obs
# read the same functions) ------------------------------------------------------


def rows_traffic(L: EncodeLaunch) -> Dict[str, int]:
    """What ``L``'s data needs moved, by a walk of the encode code on the
    host lanes with one mask per axis (the rows below ``n``, then each
    collection's items under its parent's mask): ``"lanes"``, each
    extractor lane entry the code reaches, read once; ``"off"``, the
    ``#off`` entry of each non-empty collection reached; ``"dst"``, 4 B
    of ``#dst`` per payload placed; ``"placed"``, the payloads placed,
    and ``"payload"``, their bytes. A mask covers a prefix of its axis
    (the entries past it are out): the int ``k`` for the first ``k``
    entries whole (the rows below ``n``, and the items of those rows'
    collections, which come first on their axis), else a bool array."""
    prog, dv = L.prog, L.dv_np
    code = prog.code.tolist()
    moved = {"lanes": 0, "off": 0, "dst": 0, "placed": 0, "payload": 0}

    def count(mask) -> int:
        return mask if isinstance(mask, int) else int(np.count_nonzero(mask))

    def lane(pc_lane, mask):
        """The lane's entries over the mask's prefix."""
        values = dv[prog.lanes[pc_lane]]
        return values[:mask if isinstance(mask, int) else mask.size]

    def where(mask, cond):
        """The entries of ``mask`` where ``cond`` (over its prefix)."""
        return cond if isinstance(mask, int) else mask & cond

    def read(pc_lane, mask):
        key = prog.lanes[pc_lane]
        width = 16 if key.endswith("#dec") else dv[key].itemsize
        moved["lanes"] += width * count(mask)

    def block(pc, stop, mask):
        """From ``pc`` to ``stop`` or the JUMP, LOOP or END that closes
        the block; returns where it stopped."""
        while pc != stop and code[pc] not in (OP_JUMP, OP_LOOP, OP_END):
            op = code[pc]
            if op in (OP_VARINT32, OP_F32, OP_BOOL):
                read(code[pc + 1], mask)
                pc += 2
            elif op in (OP_VARINT64, OP_F64, OP_DEC_BYTES):
                read(code[pc + 1], mask)
                read(code[pc + 2], mask)
                pc += 3
            elif op in (OP_STRING, OP_PAYLOAD):
                placed = count(mask)
                if op == OP_STRING:
                    read(code[pc + 1], mask)
                    lens = lane(code[pc + 1], mask)
                    if not isinstance(mask, int):
                        lens = lens * mask
                    moved["payload"] += int(lens.sum(dtype=np.int64))
                else:
                    moved["payload"] += code[pc + 1] * placed
                moved["dst"] += 4 * placed
                moved["placed"] += placed
                pc += 3
            elif op == OP_DEC_FIXED:
                read(code[pc + 2], mask)
                pc += 3
            elif op == OP_NULLABLE:
                read(code[pc + 1], mask)
                pc = block(pc + 4, code[pc + 3],
                           where(mask, lane(code[pc + 1], mask) != 0))
            elif op == OP_UNION:
                read(code[pc + 1], mask)
                tid = lane(code[pc + 1], mask)
                for k in range(code[pc + 2]):
                    if code[pc + 4 + k] >= 0:
                        block(code[pc + 4 + k], code[pc + 3],
                              where(mask, tid == k))
                pc = code[pc + 3]
            elif op == OP_REPEATED:
                read(code[pc + 1], mask)
                counts = np.maximum(lane(code[pc + 1], mask), 0)
                if isinstance(mask, int):
                    moved["off"] += 4 * int(np.count_nonzero(counts))
                    # the items of the first rows come first on their axis
                    items = int(counts.sum(dtype=np.int64))
                else:
                    nonempty = mask & (counts > 0)
                    moved["off"] += 4 * int(np.count_nonzero(nonempty))
                    items = np.repeat(nonempty, counts)
                block(pc + 4, code[pc + 3], items)
                pc = code[pc + 3]
            else:
                raise AssertionError(f"opcode {op} at {pc}")
        return pc

    block(0, len(code), L.n)
    return moved


def k3_bytes(traffic: Dict[str, int], total: int, R: int) -> Tuple[int, int]:
    """``(encode_rows, encode_strings)``: the bytes each entry must move
    for a batch whose wire is ``total`` bytes. ``encode_rows``: the lane
    entries its code reaches and ``#off`` in, the non-payload bytes,
    ``#dst`` and the row sizes out; ``encode_strings``: ``#src``,
    ``#len`` and ``#dst`` of each placed payload in, its bytes in and
    out."""
    rows = (traffic["lanes"] + traffic["off"] + traffic["dst"]
            + (total - traffic["payload"]) + 4 * R)
    strings = 12 * traffic["placed"] + 2 * traffic["payload"]
    return rows, strings


# -- the encoder -------------------------------------------------------------------


class DeviceEncoder:
    """Per-schema encoder: extract → pack → one host-to-device copy → K3
    → one copy of ``[0, total)`` and the row sizes back → ``BinaryArray``
    (the reference's ``DeviceEncoder.encode``, ``encode.py:1378-1429``)."""

    def __init__(self, ir: Record, arrow_schema: pa.Schema, device="cuda",
                 fingerprint: str = None):
        self.device = resolve_device(device)
        self.ir = ir
        self.arrow_schema = arrow_schema
        self.fingerprint = fingerprint  # the launch registry's schema key
        self._launched: set = set()  # buckets launched (first = compile)
        self._lock = threading.Lock()
        self.prog = lower_encoder(ir)  # raises UnsupportedOnDevice
        device_obs.track_holder(self)

    def launch(self, batch: pa.RecordBatch, timings=None) -> EncodeLaunch:
        """Extract, check the budget, pack and upload: the launch that
        :func:`run_program` takes."""
        n = batch.num_rows
        with telemetry.phase("encode.extract_s", rows=n) as ph:
            dv, bound = extract_batch(self.prog, batch, self.ir)
        clock = _PhaseClock(self.device, timings)
        clock.add("extract_s", ph.dt)
        if bound >= MAX_OUTPUT_BYTES:
            # int32 cursors and the drop sentinel need the output under
            # 2^30 bytes; the codec splits the batch
            raise BatchTooLarge(n, bound)
        L = EncodeLaunch(self.prog, dv, bucket_len(bound, minimum=64), n)
        host = L.pack()
        clock.lap("pack_s")
        metrics.inc("encode.h2d_bytes", host.nbytes)
        metrics.inc("device.h2d_bytes", host.nbytes)
        with telemetry.phase("encode.h2d_s", bytes=host.nbytes) as ph:
            L.upload(host, self.device)
            clock.sync()
        clock.add("h2d_s", ph.dt)
        return L

    def _launch(self, L: EncodeLaunch, info) -> device_obs.launch:
        """The launch record of one batch (kind ``encode.pipeline``); its
        bucket is the buffer's input bytes and output capacity."""
        bucket = f"in{L.in_bytes},cap{L.cap}"
        with self._lock:
            first = bucket not in self._launched
            self._launched.add(bucket)
        rec = device_obs.launch("encode.pipeline", bucket, self.fingerprint,
                                first, builds=("encode.cu",),
                                family="encode", info=info)
        if self.device.type == "cuda" and device_obs.walked_bytes():
            traffic = []

            def moved(part):
                def fn(launch):
                    if not traffic:
                        traffic.append(rows_traffic(L))
                    return k3_bytes(traffic[0], launch.info["total"],
                                    L.R)[part]
                return fn

            rec.L.add_bytes("encode_rows", moved(0))
            rec.L.add_bytes("encode_strings", moved(1))
        return rec

    def encode(self, batch: pa.RecordBatch, timings=None) -> pa.Array:
        """Every row as one Avro datum, in a ``BinaryArray``. With a
        ``timings`` dict, the host seconds of each phase are added there,
        each device phase ending in a synchronise; without one, the only
        synchronise is the copy back."""
        n = batch.num_rows
        if n == 0:
            return pa.array([], pa.binary())
        with telemetry.phase("device.pipeline_s", rows=n, op="encode"):
            return self._encode(batch, n, timings)

    def _encode(self, batch: pa.RecordBatch, n: int, timings) -> pa.Array:
        t0 = time.perf_counter()
        L = self.launch(batch, timings)
        info = {"total": 0}
        with self._launch(L, info):
            out, row_sizes = run_program(L, timings)
        with telemetry.phase("encode.d2h_s") as ph:
            sizes = row_sizes[:n].cpu().numpy()
            offsets = np.zeros(n + 1, np.int32)
            np.cumsum(sizes, out=offsets[1:])
            total = int(offsets[-1])
            data = out[:total].cpu().numpy()
        metrics.inc("encode.d2h_bytes", sizes.nbytes + data.nbytes)
        metrics.inc("device.d2h_bytes", sizes.nbytes + data.nbytes)
        info["total"] = total
        device_obs.flush(final=False)
        t2 = time.perf_counter()
        arr = pa.Array.from_buffers(
            pa.binary(), n,
            [None, pa.py_buffer(offsets), pa.py_buffer(data)])
        if timings is not None:
            t3 = time.perf_counter()
            timings.update(d2h_s=ph.dt, wrap_s=t3 - t2, total_s=t3 - t0)
        return arr
