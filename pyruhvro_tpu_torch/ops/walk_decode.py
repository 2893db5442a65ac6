"""The field-program walk on the card (port of ``pyruhvro_tpu/ops/pallas_decode.py``).

The reference runs the lowered field program inside one
``pl.pallas_call`` (``PallasKernelDecoder._build``) over row-padded
``[TILE_R, BW]`` word tiles, then compacts item slots on the host. This
module keeps that pipeline's semantics over an unpadded input:

* the records are concatenated into one flat uint8 buffer (``flat``,
  16 zero bytes of tail for the kernel's aligned copies) with int64
  offsets ``offs[R+1]``; ``BW`` (bucketed max record words, at most 512)
  still defines the reads: byte ``p`` of a record's virtual padded row is
  its byte ``p`` below its length, else 0, and reads clip to word
  ``BW-1``; cursors are record-local;
* the walk writes one buffer per ``Program`` key — ``[R]`` for the row
  region, ``[R * icap]`` for item regions — plus ``#err`` ``[R]``; it
  adds ERR_TRAILING and rebases row-region ``#start`` by ``base[row]``
  (the decoder passes ``base = offs[:R]``: starts index ``flat``);
* an ERR_ITEM_OVERFLOW lane doubles the item caps and reruns the walk
  (8 → 1024); the rung that worked is remembered in ``_caps``;
* the host raises :class:`MalformedAvro` naming the first bad row, with
  every bad row in ``indices`` (the reference names the first only), compacts
  strided item slots into dense arrays + ``#offsets`` (item ``#start``
  rebased by their row's offset) and assembles Arrow.

Two walks execute the program's code: :func:`walk_kernel`, the CUDA
kernel of ``csrc/walk_decode.cu``, and :func:`walk_plain`, the same code
as plain PyTorch over lane masks on the padded rows that one scatter
builds from ``flat`` (:func:`walk_padded` walks such rows directly: the
reference's layout). :func:`walk` takes the kernel for a CUDA tensor and
the plain walk only for a CPU tensor.

The array/map loop bound. The reference bounds the block loop of every
repeated field by one value per tile: ``max(ends - cursor over the
tile's lanes in mask, 0 for the others) + icap + 2``, the max taken
through float32 (``fieldprog.py:440-441``, ``pallas_decode.py:216-220``).
Only malformed or over-cap lanes ever reach it, but it decides their
``#err`` bits, so the port keeps it exactly: the tile is the reference's
``TILE_R`` (``_tile_rows``, from its VMEM budget formula), which also
sets ``R`` and the launch budget. The plain walk computes the tile bound
directly. A kernel thread cannot see its tile, so the kernel first bounds
each lane by its own span (never more than the tile's, so a lane that
finishes is exact) and records each tile's span max; if a lane was cut
short, the wrapper relaunches, and the kernel then bounds the repeated
fields up to the first cut one by the tile spans recorded for them (at
most one relaunch per repeated field; the tables stay on the card).
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..errors import BatchTooLarge, MalformedAvro
from ..runtime.pack import bucket_len, concat_records, record_lengths
from . import UnsupportedOnDevice
from .fieldprog import (
    OP_BOOL,
    OP_DOUBLE,
    OP_END,
    OP_ENUM,
    OP_FIXED,
    OP_FLOAT,
    OP_INT,
    OP_LONG,
    OP_NULLABLE,
    OP_REBASE,
    OP_REPEATED,
    OP_STRING,
    OP_TRAILING,
    OP_UNION,
    ROWS,
    Program,
    lower,
)
from .varint import (
    ERR_BAD_BRANCH,
    ERR_BAD_ENUM,
    ERR_ITEM_OVERFLOW,
    ERR_NAMES,
    ERR_NEG_LEN,
    ERR_OVERRUN,
    ERR_SLUGS,
    ERR_TRAILING,
    U32,
    RowWords,
    read_bool_byte,
    read_f32,
    read_f64_pair,
    read_varint32,
    read_varint64,
    wrap_i32,
    zigzag_decode_pair,
)

__all__ = ["WalkDecoder", "KernelLaunch", "walk", "walk_plain",
           "walk_padded", "walk_kernel", "walk_supported", "resolve_device",
           "padded_rows", "block_spans", "stage_plan", "input_staging"]

_LANE = 128                 # the reference's tile rows are a multiple
_VMEM_TILE_BYTES = 1 << 21  # the reference's per-tile budget (tile rows)
_MAX_BW = 512               # widest row: 512 words = 2 KiB per record
_MAX_CAP = 1 << 10          # item-cap ladder ceiling (per record, per region)
_LAUNCH_BYTES = 1 << 30     # padded input of one launch (int32 offsets)
_THREADS = 128              # kernel block size; divides every tile
_TAIL = 16                  # zero bytes after flat (16-B copy units)
_IN_STAGE_MAX = 32 << 10    # shared memory for one block's record span
_OUT_STAGE_MAX = 48 << 10   # shared memory for one block's output slices


def resolve_device(device) -> torch.device:
    """The device a public entry point runs on: the card by default, the
    CPU only when the caller names it. No card means an error, never a
    silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch walk on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")


def walk_supported(prog: Program) -> bool:
    """Every repeated region hangs off the row region (no nesting)."""
    return all(p == ROWS for p in prog.region_parents[1:])


def _row_bytes(prog: Program, BW: int, caps: Tuple[int, ...]) -> int:
    """Per-record bytes of the reference's tile budget
    (``pallas_decode.py:149-160``)."""
    total = BW * 4 + 4 + 4
    for spec in prog.buffers.values():
        total += 4 * (1 if spec.region == ROWS else caps[spec.region])
    return total + 4 + 4 + 4


def tile_rows(prog: Program, BW: int, caps: Tuple[int, ...]) -> int:
    """The reference's ``TILE_R`` (``pallas_decode.py:162-166``): the rows
    that share one loop bound. 0 means this rung fits no tile."""
    rows = _VMEM_TILE_BYTES // max(_row_bytes(prog, BW, caps), 1)
    return min(1024, (rows // _LANE) * _LANE)


def loop_bound(max_span: torch.Tensor, icap: int) -> torch.Tensor:
    """``max_span + icap + 2`` as the reference computes it: the span
    through float32 (round to nearest, converted back saturating, as
    XLA does) and the sum in wrapping int32."""
    rt = torch.clamp(max_span.to(torch.float32).to(torch.float64),
                     -(1 << 31), (1 << 31) - 1).to(torch.int64)
    return wrap_i32(rt + icap + 2)


def _buf_len(prog: Program, key: str, R: int, caps: Tuple[int, ...]) -> int:
    region = prog.buffers[key].region
    return R if region == ROWS else R * caps[region]


def _alloc_outputs(prog: Program, R: int, caps, device,
                   fill=torch.zeros) -> List[torch.Tensor]:
    """Output buffers in ``out_keys`` order: uint8 for u8 buffers, int32
    (bit pattern) for every 4-byte one. Lanes a walk does not write must
    read 0, as in the reference: zeroed unless the walk writes them all
    (``fill=torch.empty`` for the kernel)."""
    return [
        fill(_buf_len(prog, k, R, caps),
             dtype=torch.uint8 if prog.buffers[k].dtype.itemsize == 1
             else torch.int32, device=device)
        for k in prog.out_keys
    ]


def _slice_bytes(prog: Program, key: str, caps: Tuple[int, ...]) -> int:
    """Bytes of one kernel block's slice of a buffer (a multiple of 16)."""
    spec = prog.buffers[key]
    per_row = 1 if spec.region == ROWS else caps[spec.region]
    return _THREADS * per_row * spec.dtype.itemsize


def stage_plan(prog: Program, caps: Tuple[int, ...],
               budget: int) -> Tuple[List[int], int]:
    """Where each buffer's block slice lives while a kernel block walks:
    ``(offsets, bytes)``, an offset into the block's shared-memory output
    area per buffer in ``out_keys`` order, -1 for a buffer the block
    stores to in device memory. Row-region buffers come first, then item
    buffers in ``out_keys`` order, each while it fits ``budget``."""
    keys = prog.out_keys
    stage, used = [-1] * len(keys), 0
    for b in sorted(range(len(keys)),
                    key=lambda b: prog.buffers[keys[b]].region != ROWS):
        size = _slice_bytes(prog, keys[b], caps)
        if used + size <= budget:
            stage[b], used = used, used + size
    return stage, used


def block_spans(offs: torch.Tensor):
    """Per kernel block of 128 rows: ``(span, nonempty)``, the bytes of
    ``flat`` its records cover widened to 16-B bounds (what its bulk copy
    moves into shared memory), and whether it covers any byte."""
    lo = offs[:-1:_THREADS]
    hi = offs[_THREADS::_THREADS]
    return ((hi + 15) & ~15) - (lo & ~15), hi > lo


def input_staging(offs: torch.Tensor, in_max: int) -> Tuple[int, int, int]:
    """``(in_budget, staged, unstaged)``: the shared memory a launch gives a
    block's record span (the largest span that fits ``in_max``), and the
    blocks whose span fits it and the others, which read ``flat`` in
    device memory (blocks without records count in neither)."""
    span, nonempty = block_spans(offs)
    fits = nonempty & (span <= in_max)
    return tuple(torch.stack([
        torch.where(fits, span, 0).max(), fits.sum(),
        (nonempty & ~fits).sum()]).tolist())


def padded_rows(flat: torch.Tensor, offs: torch.Tensor, BW: int):
    """``(rows [R, BW*4] uint8, lens [R] int32)``: the reference's
    row-padded layout built from the flat records on their device by one
    scatter (``pallas_decode.py:321-335``). A record's bytes past
    ``BW*4`` are cut: the clipped reads never see them."""
    dev = flat.device
    R = offs.numel() - 1
    lens = offs[1:] - offs[:-1]
    first, last = (int(v) for v in offs[[0, -1]].tolist())
    row_of = torch.repeat_interleave(torch.arange(R, device=dev), lens,
                                     output_size=last - first)
    pos = torch.arange(first, last, device=dev)
    col = pos - offs[row_of]
    keep = col < BW * 4
    rows = torch.zeros((R, BW * 4), dtype=torch.uint8, device=dev)
    rows[row_of[keep], col[keep]] = flat[pos[keep]]
    return rows, lens.to(torch.int32)


# -- the plain walk --------------------------------------------------------


class _PlainWalk:
    """The field-program code executed with lane masks (one lane per
    record), in the manner of the reference's JAX emitters."""

    def __init__(self, rows, lens, act, base, prog: Program, caps,
                 tile_r: int):
        self.words = RowWords(rows)
        self.base = base.to(torch.int64)
        self.code = prog.code.tolist()
        self.caps = caps
        self.tile_r = tile_r
        n = rows.shape[0]
        dev = rows.device
        self.lanes = torch.arange(n, dtype=torch.int64, device=dev)
        self.ends = lens.to(torch.int64)
        self.active = act != 0
        self.cursor = torch.zeros(n, dtype=torch.int64, device=dev)
        self.err = torch.zeros(n, dtype=torch.int64, device=dev)
        self.bufs = _alloc_outputs(prog, n, caps, dev)

    # writes ---------------------------------------------------------------

    def put(self, b: int, slot, val, mask) -> None:
        """Masked write: lane-aligned when ``slot`` is None (row region),
        else to item slots, where slot -1 (past the cap) drops."""
        buf = self.bufs[b]
        if buf.dtype == torch.uint8:
            val = (val & 0xFF).to(torch.uint8)
        else:
            val = wrap_i32(val).to(torch.int32)
        if slot is None:
            self.bufs[b] = torch.where(mask, val, buf)
        else:
            m = mask & (slot >= 0)
            buf.index_put_((slot[m],), val[m])

    def err_where(self, mask, bit: int) -> None:
        self.err = self.err | torch.where(mask, bit, 0)

    # readers --------------------------------------------------------------

    def varint(self, mask):
        lo, hi, cur, verr = read_varint64(self.words, self.cursor, mask)
        lo, hi = zigzag_decode_pair(lo, hi)
        self.cursor = cur
        self.err = self.err | verr
        return lo, hi

    def branch(self, mask):
        lo, hi = self.varint(mask)
        self.err_where(mask & (hi != 0), ERR_BAD_BRANCH)
        return wrap_i32(lo)

    # the interpreter ------------------------------------------------------

    def run(self, pc: int, end: int, mask, slot) -> None:
        """Execute ``code[pc:end]`` for the lanes in ``mask``; ``slot`` (None
        for the row region) is where their values go, passed to ``put``."""
        code = self.code
        if not bool(mask.any()):
            return  # every write and cursor move below is masked
        while pc < end:
            op = code[pc]
            if op in (OP_LONG, OP_INT):
                lo, hi = self.varint(mask)
                self.put(code[pc + 1], slot, lo, mask)
                if op == OP_LONG:
                    self.put(code[pc + 2], slot, hi, mask)
                    pc += 3
                else:
                    pc += 2
            elif op == OP_FLOAT:
                v, self.cursor = read_f32(self.words, self.cursor, mask)
                self.put(code[pc + 1], slot, v, mask)
                pc += 2
            elif op == OP_DOUBLE:
                lo, hi, self.cursor = read_f64_pair(self.words, self.cursor,
                                                    mask)
                self.put(code[pc + 1], slot, lo, mask)
                self.put(code[pc + 2], slot, hi, mask)
                pc += 3
            elif op == OP_BOOL:
                b, self.cursor, berr = read_bool_byte(self.words,
                                                      self.cursor, mask)
                self.err = self.err | berr
                self.put(code[pc + 1], slot, b, mask)
                pc += 2
            elif op == OP_STRING:
                lo, hi, cur, verr = read_varint32(self.words, self.cursor,
                                                  mask)
                lo, hi = zigzag_decode_pair(lo, hi)
                slen = wrap_i32(lo)
                bad = mask & ((slen < 0) | (hi != 0))
                self.err = self.err | verr
                self.err_where(bad, ERR_NEG_LEN)
                slen = torch.where(bad, 0, slen)
                new_cur = wrap_i32(cur + torch.where(mask, slen, 0))
                self.err_where(mask & (new_cur > self.ends), ERR_OVERRUN)
                self.put(code[pc + 1], slot, cur, mask)
                self.put(code[pc + 2], slot, slen, mask)
                self.cursor = new_cur
                pc += 3
            elif op == OP_FIXED:
                cur = self.cursor
                new_cur = wrap_i32(cur + torch.where(mask, code[pc + 2], 0))
                self.err_where(mask & (new_cur > self.ends), ERR_OVERRUN)
                self.put(code[pc + 1], slot, cur, mask)
                self.cursor = new_cur
                pc += 3
            elif op == OP_ENUM:
                lo, hi = self.varint(mask)
                idx = wrap_i32(lo)
                self.err_where(
                    mask & ((hi != 0) | (idx < 0) | (idx >= code[pc + 2])),
                    ERR_BAD_ENUM,
                )
                self.put(code[pc + 1], slot, idx, mask)
                pc += 3
            elif op == OP_NULLABLE:
                null_idx, stop = code[pc + 2], code[pc + 3]
                branch = self.branch(mask)
                present = mask & (branch == 1 - null_idx)
                absent = mask & (branch == null_idx)
                self.err_where(mask & ~(present | absent), ERR_BAD_BRANCH)
                self.put(code[pc + 1], slot, torch.ones_like(branch), present)
                self.run(pc + 4, stop, present, slot)
                pc = stop
            elif op == OP_UNION:
                n_arms, stop = code[pc + 2], code[pc + 3]
                branch = self.branch(mask)
                self.err_where(mask & ((branch < 0) | (branch >= n_arms)),
                               ERR_BAD_BRANCH)
                self.put(code[pc + 1], slot, branch, mask)
                for k in range(n_arms):
                    start, arm_end = code[pc + 4 + 2 * k], code[pc + 5 + 2 * k]
                    if start >= 0:
                        self.run(start, arm_end, mask & (branch == k), slot)
                pc = stop
            elif op == OP_REPEATED:
                self.repeated(pc, mask, slot)
                pc = code[pc + 3]
            elif op == OP_TRAILING:
                self.err_where(mask & (self.cursor != self.ends), ERR_TRAILING)
                pc += 1
            elif op == OP_REBASE:
                self.rebase(code[pc + 1], mask)
                pc += 2
            elif op == OP_END:
                return
            else:
                raise RuntimeError(f"bad opcode {op} at {pc}")

    def rebase(self, b: int, mask) -> None:
        """Row-region string starts += the row's base (``OP_REBASE``)."""
        moved = wrap_i32(self.bufs[b].to(torch.int64) + self.base)
        self.bufs[b] = torch.where(mask, moved, 0).to(torch.int32)

    def repeated(self, pc: int, mask, _slot) -> None:
        """The array/map block loop (``fieldprog.py:419-498``), one item per
        live lane per iteration, bounded per tile as the reference. Row
        level only: the enclosing slot is always the row."""
        code = self.code
        count_buf, rid, stop = code[pc + 1], code[pc + 2], code[pc + 3]
        icap = self.caps[rid]
        span = torch.where(mask, wrap_i32(self.ends - self.cursor), 0)
        tile_max = span.view(-1, self.tile_r).amax(dim=1)
        bound = loop_bound(tile_max, icap).repeat_interleave(self.tile_r)
        zero = torch.zeros_like(self.cursor)
        rem, cnt, done = zero, zero, ~mask
        it = 0
        while True:
            live = ~done & (it < bound)
            if not bool(live.any()):
                break
            # 1) lanes needing a block header
            need = live & (rem == 0)
            lo, hi, cur, verr = read_varint32(self.words, self.cursor, need)
            lo, hi = zigzag_decode_pair(lo, hi)
            b = wrap_i32(lo)
            self.err = self.err | verr
            bad_count = need & ~(((hi == 0) & (b >= 0))
                                 | ((hi == U32) & (b < 0)))
            self.err_where(bad_count, ERR_OVERRUN)
            b = torch.where(bad_count, 0, b)
            neg = need & (b < 0)
            # negative count: a byte-size long follows; skip it
            _slo, _shi, cur, serr = read_varint32(self.words, cur, neg)
            self.err = self.err | serr
            b = torch.where(neg, wrap_i32(-b), b)
            self.cursor = cur
            ended = need & (b == 0)
            done = done | ended
            rem = torch.where(need, torch.where(ended, 0, b), rem)
            over = live & ~done & (self.cursor > self.ends)
            self.err_where(over, ERR_OVERRUN)
            done = done | over
            # 2) one item per lane with items pending; lanes past the cap
            # still decode (into dropped slots) so the cursor stays exact
            can = live & ~done & (rem > 0)
            self.err_where(can & (cnt >= icap), ERR_ITEM_OVERFLOW)
            slot = torch.where(cnt < icap, self.lanes * icap + cnt, -1)
            self.run(pc + 4, stop - 2, can, slot)
            rem = rem - can.to(torch.int64)
            cnt = cnt + can.to(torch.int64)
            it += 1
        # ran out of iterations with lanes still open → malformed
        self.err_where(mask & ~done, ERR_OVERRUN)
        self.put(count_buf, None, cnt, mask)


def walk_padded(rows, lens, act, base, prog: Program, caps: Tuple[int, ...],
                tile_r: int):
    """The plain walk over row-padded records (the reference's layout):
    ``rows`` ``[R, BW*4]`` uint8, ``lens``/``act``/``base`` ``[R]``.
    Returns ``(buffers in out_keys order, #err)``, every 4-byte buffer as
    int32 bits."""
    w = _PlainWalk(rows, lens, act, base, prog, caps, tile_r)
    w.run(0, len(w.code), w.active, None)
    return w.bufs, wrap_i32(w.err).to(torch.int32)


def walk_plain(flat, offs, act, BW: int, base, prog: Program,
               caps: Tuple[int, ...], tile_r: int):
    """The kernel's plain version, on any device, with the kernel's
    inputs: the records' bytes ``flat``, ``offs`` ``[R+1]`` int64,
    ``act`` and ``base`` ``[R]`` int32. It builds the padded rows that
    ``BW`` defines and walks them (:func:`walk_padded`)."""
    rows, lens = padded_rows(flat, offs, BW)
    return walk_padded(rows, lens, act, base, prog, caps, tile_r)


# -- the CUDA kernel -------------------------------------------------------


def _check(t, dtype, shape, dev, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() \
            or t.device != dev:
        raise RuntimeError(f"{name} must be contiguous {dtype} {list(shape)} "
                         f"on {dev}")


class KernelLaunch:
    """The device tensors of one ``walk_decode`` launch: inputs, the
    packed tables, the outputs and the span tables, and the launch's use
    of shared memory: ``in_budget`` and the blocks staged or not
    (:func:`input_staging`), ``stage``/``out_bytes`` (:func:`stage_plan`).

    ``in_max`` caps the record span a block stages; ``out_max`` caps its
    output slices, and by default is the most that costs no resident
    block: output staging saves stores to device memory, but the walk is
    bound by latency, so blocks per SM come first."""

    def __init__(self, flat, offs, act, BW: int, base, prog: Program,
                 caps: Tuple[int, ...], tile_r: int,
                 in_max: int = _IN_STAGE_MAX, out_max: int = None):
        dev = flat.device
        if dev.type != "cuda":
            raise RuntimeError("walk_kernel takes CUDA tensors")
        if flat.dtype != torch.uint8 or flat.dim() != 1 \
                or not flat.is_contiguous() or flat.data_ptr() % 16:
            raise RuntimeError("flat must be contiguous 16-B aligned uint8 [N]")
        R = act.numel()
        _check(offs, torch.int64, (R + 1,), dev, "offs")
        _check(act, torch.int32, (R,), dev, "act")
        _check(base, torch.int32, (R,), dev, "base")
        if tile_r % _THREADS or R % tile_r:
            raise RuntimeError(f"R={R} must be a multiple of tile_r={tile_r}, "
                             f"itself a multiple of {_THREADS}")
        if flat.numel() < (int(offs[-1]) + 15) & ~15:
            raise RuntimeError("flat must hold offs[-1] bytes rounded up to 16")
        self.flat, self.offs, self.act, self.base = flat, offs, act, base
        self.BW, self.prog, self.caps, self.tile_r = BW, prog, caps, tile_r
        self.n_regions = len(prog.regions)
        self.n_tiles = R // tile_r
        self.in_budget, self.blocks_staged, self.blocks_global = \
            input_staging(offs, in_max)
        if out_max is None:
            out_max = self._free_out_bytes()
        self.stage, self.out_bytes = stage_plan(prog, caps, out_max)
        esize = [prog.buffers[k].dtype.itemsize for k in prog.out_keys]
        region = [prog.buffers[k].region for k in prog.out_keys]
        self.table = torch.from_numpy(np.concatenate([
            prog.code, np.array(esize + region + self.stage + list(caps),
                                np.int32)]).astype(np.int32)).to(dev)
        self.bufs = _alloc_outputs(prog, R, caps, dev, fill=torch.empty)
        if any(b.data_ptr() % 16 for b in self.bufs):
            raise RuntimeError("output buffers must be 16-B aligned")
        self.ptrs = torch.tensor([b.data_ptr() for b in self.bufs] or [0],
                                 dtype=torch.int64, device=dev)
        self.err = torch.empty(R, dtype=torch.int32, device=dev)
        shape = (self.n_tiles, self.n_regions)
        self.span_max = torch.full(shape, -(1 << 31), dtype=torch.int32,
                                   device=dev)
        self.in_mask = torch.zeros(shape, dtype=torch.int32, device=dev)
        self.cut = torch.zeros(self.n_regions, dtype=torch.int32, device=dev)
        self.fixed_upto = 0  # regions 1..fixed_upto run with tile bounds

    def _free_out_bytes(self) -> int:
        """The largest output staging area (16-B steps, at most
        ``_OUT_STAGE_MAX``) at which as many blocks fit an SM as with
        none, by the CUDA occupancy query."""
        per_sm = walk_kernel.library().cdll.walk_decode_blocks_per_sm
        want = per_sm(self.smem_bytes(0))
        lo, hi = 0, _OUT_STAGE_MAX // 16
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if per_sm(self.smem_bytes(16 * mid)) >= want:
                lo = mid
            else:
                hi = mid - 1
        return 16 * lo

    def output_bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.bufs) \
            + self.err.numel() * 4

    def smem_bytes(self, out_bytes: int = None) -> int:
        """Dynamic shared memory of one block (at ``out_bytes`` of output
        staging, by default the launch's)."""
        return walk_kernel.library().cdll.walk_decode_smem_bytes(
            len(self.prog.code), len(self.prog.out_keys), self.n_regions,
            self.in_budget,
            self.out_bytes if out_bytes is None else out_bytes)

    def reset(self) -> None:
        """The span tables of regions above ``fixed_upto`` and ``cut``
        back to their pre-launch state; those of regions ``1..fixed_upto``
        keep what a launch recorded: the kernel takes their tile bounds
        from them. The kernel writes every output whole."""
        self.span_max[:, self.fixed_upto + 1:].fill_(-(1 << 31))
        self.in_mask[:, self.fixed_upto + 1:].zero_()
        self.cut.zero_()


class _WalkKernel:
    """Launches ``csrc/walk_decode.cu``. ``launches`` counts kernel
    launches; it grows only in :meth:`launch`."""

    source = "walk_decode.cu"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()

    def library(self):
        from ._build import load_kernel_library

        lib = load_kernel_library(self.source)
        fn = lib.cdll.walk_decode
        if fn.argtypes is None:
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [P, P, P, P, I, I,   # flat offs act base R row_words
                           P, I, I, I, P,      # table code_len n_bufs
                                               # n_regions buf_ptrs
                           I, I, I, I,         # tile_r fixed_upto in_budget
                                               # out_bytes
                           P, P, P, P,         # span_max in_mask cut err
                           P]                  # stream
            fn.restype = ctypes.c_int
            smem = lib.cdll.walk_decode_smem_bytes
            smem.argtypes = [I, I, I, I, I]    # code_len n_bufs n_regions
                                               # in_budget out_bytes
            smem.restype = ctypes.c_int
            occ = lib.cdll.walk_decode_blocks_per_sm
            occ.argtypes = [I]                 # smem_bytes
            occ.restype = ctypes.c_int
        return lib

    def launch(self, L: KernelLaunch) -> None:
        """One launch on the current stream; no synchronisation."""
        fn = self.library().cdll.walk_decode
        stream = torch.cuda.current_stream(L.flat.device).cuda_stream
        rc = fn(L.flat.data_ptr(), L.offs.data_ptr(), L.act.data_ptr(),
                L.base.data_ptr(), L.act.numel(), L.BW, L.table.data_ptr(),
                len(L.prog.code), len(L.bufs), L.n_regions,
                L.ptrs.data_ptr(), L.tile_r, L.fixed_upto, L.in_budget,
                L.out_bytes, L.span_max.data_ptr(), L.in_mask.data_ptr(),
                L.cut.data_ptr(), L.err.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"walk_decode launch failed: CUDA error {rc}")
        with self._lock:
            self.launches += 1

    def __call__(self, flat, offs, act, BW: int, base, prog: Program,
                 caps: Tuple[int, ...], tile_r: int):
        return self.run(KernelLaunch(flat, offs, act, BW, base, prog, caps,
                                     tile_r))

    def run(self, L: KernelLaunch):
        """``(buffers, #err)`` of the walk on ``L``'s inputs: launch, and
        relaunch while lanes are cut short by their own loop bound."""
        while True:
            self.launch(L)
            cut = L.cut.cpu().tolist()
            pending = [r for r in range(L.fixed_upto + 1, L.n_regions)
                       if cut[r]]
            if not pending:
                return L.bufs, L.err
            # a lane was cut by its own bound: relaunch with the exact tile
            # bounds of every repeated field up to the first cut one
            L.fixed_upto = pending[0]
            L.reset()


walk_kernel = _WalkKernel()


def walk(flat, offs, act, BW: int, base, prog: Program,
         caps: Tuple[int, ...], tile_r: int):
    """The walk for the tensors' device: the CUDA kernel for CUDA tensors,
    the plain walk for CPU tensors."""
    if flat.device.type == "cuda":
        return walk_kernel(flat, offs, act, BW, base, prog, caps, tile_r)
    if flat.device.type == "cpu":
        return walk_plain(flat, offs, act, BW, base, prog, caps, tile_r)
    raise RuntimeError(f"no walk for device {flat.device}")


# -- the decoder -------------------------------------------------------------


class WalkDecoder:
    """Per-schema decoder: pack → walk (item-cap ladder) → host columns.

    Same contract as the reference's ``PallasKernelDecoder.decode_to_columns``
    (host column dict, row count, meta)."""

    def __init__(self, ir, device="cuda"):
        self.device = resolve_device(device)
        self.prog = lower(ir)
        if not walk_supported(self.prog):
            raise UnsupportedOnDevice(
                "pallas walk kernel v2 covers row-level array/map "
                "(nested repetition runs on the XLA pipeline)"
            )
        self._caps = None  # remembered successful cap-ladder rung
        self.n_regions = len(self.prog.regions)

    def first_caps(self) -> Tuple[int, ...]:
        """The rung a decode starts at: the remembered one, else 8 items."""
        return self._caps or tuple(
            0 if r == 0 else 8 for r in range(self.n_regions)
        )

    @staticmethod
    def row_words(lens: np.ndarray) -> int:
        """``BW``: the bucketed words of the longest record."""
        max_b = int(lens.max(initial=1))
        BW = bucket_len(max(-(-max_b // 4), 1), minimum=4)
        if BW > _MAX_BW:
            raise UnsupportedOnDevice(
                f"record of {max_b} bytes exceeds the pallas tile budget"
            )
        return BW

    def launch_rows(self, n: int, BW: int, caps) -> Tuple[int, int]:
        """``(tile_r, R)`` of one walk over ``n`` records at ``caps``. The
        byte budget is the reference's, over its padded rows, although no
        padded rows are built: the halving of too large batches depends
        on it."""
        tile_r = tile_rows(self.prog, BW, caps)
        if tile_r < _LANE:
            raise UnsupportedOnDevice(
                f"pallas tile cannot fit caps={max(caps)} in VMEM; "
                f"use the XLA pipeline"
            )
        R = max(1, -(-n // tile_r)) * tile_r
        if R * (BW * 4) > _LAUNCH_BYTES:
            raise BatchTooLarge(n, R * BW * 4)
        return tile_r, R

    @staticmethod
    def row_arrays(offsets: np.ndarray, R: int):
        """``(offs [R+1] int64, act [R] int32)`` of one walk over the
        records that ``offsets`` (``[n+1]``) delimit: rows past ``n`` are
        empty and inactive."""
        n = len(offsets) - 1
        offs = np.full(R + 1, offsets[-1], np.int64)
        offs[:n + 1] = offsets
        act = np.zeros(R, np.int32)
        act[:n] = 1
        return offs, act

    def pack(self, data: Sequence[bytes], lens: np.ndarray, R: int):
        """Host arrays of one walk: the concatenated records (tail-padded
        for the device), ``offs`` and ``act``."""
        flat, offsets = concat_records(data, lens, tail=_TAIL,
                                       native=self.device.type == "cuda")
        return (flat, *self.row_arrays(offsets, R))

    def to_device(self, arrays) -> List[torch.Tensor]:
        out = [torch.from_numpy(a).to(self.device) for a in arrays]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def launch_inputs(self, data: Sequence[bytes], caps):
        """``(flat, offs, act, BW, base, tile_r)`` exactly as a decode at
        ``caps`` hands them to the walk."""
        lens = record_lengths(data)
        BW = self.row_words(lens)
        tile_r, R = self.launch_rows(len(data), BW, caps)
        flat, offs, act = self.to_device(self.pack(data, lens, R))
        return flat, offs, act, BW, offs[:-1].to(torch.int32), tile_r

    def decode_to_columns(self, data: Sequence[bytes]):
        """``(host, n, meta)``: host holds every program buffer as numpy in
        its program dtype (item regions dense, plus ``#offsets``); meta
        holds ``item_totals``, ``flat`` (the concatenated records, which
        every ``#start`` descriptor indexes) and ``timings`` (seconds per
        host-visible phase)."""
        t0 = time.perf_counter()
        n = len(data)
        lens = record_lengths(data)
        BW = self.row_words(lens)
        prog = self.prog
        caps = self.first_caps()
        timings = {"pack_s": 0.0, "h2d_s": 0.0, "walk_s": 0.0}
        tile_r, R = self.launch_rows(n, BW, caps)  # may raise BatchTooLarge
        t1 = time.perf_counter()
        flat_np, offsets = concat_records(data, lens, tail=_TAIL,
                                          native=self.device.type == "cuda")
        t2 = time.perf_counter()
        (flat,) = self.to_device([flat_np])
        timings["pack_s"] += t2 - t1
        timings["h2d_s"] += time.perf_counter() - t2
        prev_R = None
        while True:
            if R != prev_R:
                t1 = time.perf_counter()
                row_np = self.row_arrays(offsets, R)
                t2 = time.perf_counter()
                offs, act = self.to_device(row_np)
                base = offs[:-1].to(torch.int32)
                timings["pack_s"] += t2 - t1
                timings["h2d_s"] += time.perf_counter() - t2
                prev_R = R
            t1 = time.perf_counter()
            bufs, err = walk(flat, offs, act, BW, base, prog, caps, tile_r)
            # only #err comes back until a rung is clean
            err_np = err.cpu().numpy().view(np.uint32)
            timings["walk_s"] += time.perf_counter() - t1
            if not (err_np[:n] & ERR_ITEM_OVERFLOW).any():
                break
            if max(caps) >= _MAX_CAP:
                raise UnsupportedOnDevice(
                    f"array/map items exceed the pallas cap ladder "
                    f"({_MAX_CAP}/record); use the XLA pipeline"
                )
            caps = tuple(0 if c == 0 else c * 2 for c in caps)
            tile_r, R = self.launch_rows(n, BW, caps)
        self._caps = caps
        t1 = time.perf_counter()
        host = {
            key: b.cpu().numpy().view(prog.buffers[key].dtype)
            for key, b in zip(prog.out_keys, bufs)
        }
        timings["d2h_s"] = time.perf_counter() - t1
        err = err_np[:n]
        if err.any():
            # every bad row rides in ``indices``, as on the pipeline
            # engine, so a tolerant call quarantines them in one pass
            indices = []
            for r in np.flatnonzero(err):
                v = int(err[r])
                indices.append((int(r), ERR_SLUGS.get(v & -v)))
            i, slug = indices[0]
            bit = int(err[i]) & -int(err[i])
            raise MalformedAvro(
                f"record {i}: {ERR_NAMES.get(bit, f'error bit {bit:#x}')}",
                index=i, err_name=slug, tier="device", indices=indices,
            )
        meta = {"item_totals": {}, "flat": flat_np[:offsets[-1]]}
        t1 = time.perf_counter()
        self._compact_regions(host, n, caps, offsets, meta)
        timings["compact_s"] = time.perf_counter() - t1
        timings["total_s"] = time.perf_counter() - t0
        meta["timings"] = timings
        return host, n, meta

    def _compact_regions(self, host: Dict[str, np.ndarray], n: int,
                         caps: Tuple[int, ...], offsets: np.ndarray,
                         meta) -> None:
        """Strided item slots → dense arrays + ``#offsets`` (the layout the
        Arrow assembly consumes; ``pallas_decode.py:413-454``). Item-region
        ``#start`` descriptors rebase here by their row's offset in
        ``flat``."""
        prog = self.prog
        for rid in range(1, self.n_regions):
            path = prog.regions[rid]
            icap = caps[rid]
            counts = np.ascontiguousarray(host[path + "#count"][:n], np.int32)
            # int32 offsets are a hard bound: zero-byte items (arrays of
            # null / empty records) are NOT bounded by wire bytes
            if int(counts.sum(dtype=np.int64)) >= (1 << 31):
                raise BatchTooLarge(n, -1)
            item_offsets = np.zeros(n + 1, np.int32)
            np.cumsum(counts, out=item_offsets[1:])
            total = int(item_offsets[-1])
            rows = np.repeat(np.arange(n, dtype=np.int64), counts)
            within = np.arange(total, dtype=np.int64) - np.repeat(
                item_offsets[:-1].astype(np.int64), counts
            )
            src = rows * icap + within
            for key, spec in prog.buffers.items():
                if spec.region != rid or key == path + "#count":
                    continue
                dense = host[key][src]
                if key.endswith("#start"):
                    dense = (dense + offsets[rows]).astype(dense.dtype)
                host[key] = dense
            host[path + "#offsets"] = item_offsets
            meta["item_totals"][path] = total

    def decode(self, data: Sequence[bytes], arrow_schema):
        """Straight to a RecordBatch."""
        from .arrow_build import build_record_batch

        host, n, meta = self.decode_to_columns(data)
        return build_record_batch(self.prog.ir, arrow_schema, host, n, meta)
