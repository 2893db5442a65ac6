"""The pipeline engine's kernel protocols, modelled on the CPU.

``csrc/decode_walk.cu`` and ``csrc/decode_finalize.cu`` run only on the
card. What surrounds them does not: ``WalkLaunch`` (the loop-bound key
tables, the relaunch until the bounds settle, the log of writes under
dropped items and its replay) and ``FinalizePlan`` (the job tables, the
blob offsets, the reductions). These tests run both against a Python
model of each kernel that follows its source step by step (block by
block and one lane at a time for the walk, with the walk's staged record
spans, its block counts and per-block fold of the span records; one
pass at a time for the finalize), and hold the
result against the plain versions bit for bit, at every rung of every
pipeline fixture. A fault in the protocol or in the tables shows here;
a fault in the CUDA source itself shows only on the card
(``chip_smoke.py``). The ctypes declarations of the new entry points
are checked here too.
"""

import ctypes
import random
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from pyruhvro_tpu_torch.ops import _build  # noqa: E402
from pyruhvro_tpu_torch.ops import decode  # noqa: E402
from pyruhvro_tpu_torch.ops import fieldprog as fp  # noqa: E402
from pyruhvro_tpu_torch.ops import varint  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu_torch.utils import datagen  # noqa: E402

ROWS = 12
FIXTURES = {name: (schema, datums) for name, schema, datums, _bad in
            chip_smoke.pipeline_fixtures(datagen, parse_schema, ROWS)}
BIG = 1 << 30


def _i32(x: int) -> int:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class _Block:
    """One block of ``decode_walk_kernel``: its staged copy of the words
    (``walk_input_staging``; the block counts itself staged or reading
    device memory in the status), its output ranges zeroed, and its fold
    of the span records of the first ``fold`` keys."""

    def __init__(self, L, st, first: int):
        blk = first // decode.WALK_THREADS
        self.rows = min(decode.WALK_THREADS, L.R - first)
        a, span = int(st["in_a"][blk]), int(st["in_span"][blk])
        staged = bool(st["in_staged"][blk])
        if st["in_covers"][blk]:
            st["status"][st["log_at"] + (1 if staged else 2)] += 1
        self.in_lo, self.in_n = (a, span) if staged else (0, 0)
        self.copy = st["words"][a:a + span].copy() if staged else None
        for buf in st["bufs"]:
            per_row = buf.size // L.R
            buf[first * per_row:(first + self.rows) * per_row] = 0
        self.fold = {}  # key -> [span max, lanes]

    def finish(self, st) -> None:
        """The block's end: one global pair per folded key."""
        T = st["T"]
        for key, (mx, cnt) in self.fold.items():
            st["status"][key] = max(st["status"][key], mx)
            st["status"][T + key] += cnt


class _Lane:
    """One thread of ``decode_walk_kernel``."""

    def __init__(self, L, st, blk: _Block, row: int):
        self.L, self.st, self.blk, self.row = L, st, blk, row
        self.cur = int(st["starts"][row])
        self.end = _i32(self.cur + int(st["lengths"][row]))
        self.err = 0
        self.lv = []  # open loops, outermost first

    def byte(self, c: int, k: int) -> int:
        """From the block's staged copy when the clipped address lies in
        it, else from the words; each read counted."""
        c &= 0xFFFFFFFF
        m = (c & 3) + k
        w = min((c >> 2) + (m >> 2), self.st["last_word"])
        p = 4 * w + (m & 3)
        r = p - self.blk.in_lo
        if 0 <= r < self.blk.in_n:
            self.st["reads"][0] += 1
            return int(self.blk.copy[r])
        self.st["reads"][1] += 1
        return int(self.st["words"][p])

    def word(self, c: int, k: int) -> int:
        return sum(self.byte(c, k + i) << (8 * i) for i in range(4))

    def varint(self):
        c = self.cur & 0xFFFFFFFF
        lo = hi = n = 0
        more = True
        k = 0
        while k < 10 and more:
            b = self.byte(c, k)
            g, s = b & 0x7F, 7 * k
            if s < 32:
                lo |= (g << s) & 0xFFFFFFFF
                if s + 7 > 32:
                    hi |= g >> (32 - s)
            else:
                hi |= (g << (s - 32)) & 0xFFFFFFFF
            n += 1
            more = b >= 0x80
            k += 1
        self.cur = _i32(c + n)
        if more:
            self.err |= varint.ERR_VARINT
        return lo, hi

    def long(self):
        lo, hi = self.varint()
        m = 0xFFFFFFFF if lo & 1 else 0
        return (((lo >> 1) | (hi << 31)) & 0xFFFFFFFF) ^ m, (hi >> 1) ^ m

    def context(self):
        if not self.lv:
            return self.row, False
        S = self.lv[-1]
        slot = _i32(S["base"] * S["icap"] + S["cnt"]) \
            if S["cnt"] < S["icap"] else BIG
        return slot, S["base_wrapped"]

    def put(self, b: int, v: int) -> None:
        st = self.st
        slot, wrapped = self.context()
        size = st["lens"][b]
        s = slot + size if wrapped and slot < 0 else slot
        if not 0 <= s < size:
            return
        if not wrapped:
            buf = st["bufs"][b]
            buf[s] = v & 0xFF if buf.dtype == np.uint8 else _i32(v)
            return
        at = st["status"][st["log_at"]]
        st["status"][st["log_at"]] += 1
        if at >= self.L.log_cap:
            return
        e = st["log"][at]
        e[:] = 0
        e[:4] = (b, s, _i32(v), self.row)
        for i, S in enumerate(self.lv):
            e[4 + i] = S["it"]

    def key_of(self, rid: int) -> int:
        k = 0
        for S in self.lv:
            e = self.st["ext"][S["rid"]]
            if S["it"] >= e:
                return -1
            k = k * e + S["it"]
        return self.st["key_off"][rid] + k

    def record_cut(self, S) -> None:
        st, T = self.st["status"], self.st["T"]
        if S["key"] >= 0:
            st[2 * T + S["key"]] = 1
            return
        nr = self.L.n_regions
        st[3 * T + nr + S["rid"]] = 1
        for A in self.lv[:-1]:
            at = 3 * T + A["rid"]
            st[at] = max(st[at], A["it"])

    def loop_next(self, code) -> bool:
        S = self.lv[-1]
        while True:
            if S["done"] or S["it"] >= S["bound"]:
                if not S["done"]:
                    self.err |= varint.ERR_OVERRUN
                    if S["own"]:
                        self.record_cut(S)
                self.lv.pop()
                self.put(code[S["rep_pc"] + 1], S["cnt"])
                return False
            if S["rem"] == 0:
                lo, hi = self.long()
                b = _i32(lo)
                if not ((hi == 0 and b >= 0) or (hi == 0xFFFFFFFF and b < 0)):
                    self.err |= varint.ERR_OVERRUN
                    b = 0
                if b < 0:
                    self.varint()
                    b = _i32(-b)
                if b == 0:
                    S["done"] = True
                S["rem"] = b
            if not S["done"] and self.cur > self.end:
                self.err |= varint.ERR_OVERRUN
                S["done"] = True
            if not S["done"] and S["rem"] > 0:
                if S["cnt"] >= S["icap"]:
                    self.err |= varint.ERR_ITEM_OVERFLOW
                return True
            if not S["done"] and S["rem"] < 0:
                S["it"] = S["bound"]
                continue
            S["it"] += 1

    def loop_enter(self, code, pc: int) -> bool:
        L, st = self.L, self.st
        rid = code[pc + 2]
        icap = st["caps"][rid]
        span = _i32(self.end - self.cur)
        key = self.key_of(rid)
        if key >= 0 and key < st["fold"]:
            f = self.blk.fold.setdefault(key, [-(1 << 31), 0])
            f[0], f[1] = max(f[0], span), f[1] + 1
        elif key >= 0:
            st["status"][key] = max(st["status"][key], span)
            st["status"][st["T"] + key] += 1
        slot, wrapped = self.context()
        own = key < 0 or st["has_spec"][key] == 0
        self.lv.append(dict(
            rep_pc=pc, rid=rid, icap=icap, key=key, rem=0, cnt=0, it=0,
            done=False, base=slot,
            base_wrapped=bool(self.lv) and (wrapped or slot == BIG),
            own=own, bound=_i32(span + icap + 2) if own
            else int(st["spec"][key])))
        assert len(self.lv) <= L.stack  # the kernel's loop stack
        return self.loop_next(code)

    def run(self, code) -> None:
        pc = 0
        while True:
            op = code[pc]
            if op in (fp.OP_LONG, fp.OP_INT):
                lo, hi = self.long()
                self.put(code[pc + 1], lo)
                if op == fp.OP_LONG:
                    self.put(code[pc + 2], hi)
                pc += 3 if op == fp.OP_LONG else 2
            elif op == fp.OP_FLOAT:
                v = self.word(self.cur, 0)
                self.cur = _i32(self.cur + 4)
                self.put(code[pc + 1], v)
                pc += 2
            elif op == fp.OP_DOUBLE:
                lo, hi = self.word(self.cur, 0), self.word(self.cur, 4)
                self.cur = _i32(self.cur + 8)
                self.put(code[pc + 1], lo)
                self.put(code[pc + 2], hi)
                pc += 3
            elif op == fp.OP_BOOL:
                b = self.byte(self.cur, 0)
                if b > 1:
                    self.err |= varint.ERR_BAD_BOOL
                self.cur = _i32(self.cur + 1)
                self.put(code[pc + 1], b)
                pc += 2
            elif op == fp.OP_STRING:
                lo, hi = self.long()
                slen = _i32(lo)
                if slen < 0 or hi != 0:
                    self.err |= varint.ERR_NEG_LEN
                    slen = 0
                start, nxt = self.cur, _i32(self.cur + slen)
                if nxt > self.end:
                    self.err |= varint.ERR_OVERRUN
                self.put(code[pc + 1], start)
                self.put(code[pc + 2], slen)
                self.cur = nxt
                pc += 3
            elif op == fp.OP_FIXED:
                start, nxt = self.cur, _i32(self.cur + code[pc + 2])
                if nxt > self.end:
                    self.err |= varint.ERR_OVERRUN
                self.put(code[pc + 1], start)
                self.cur = nxt
                pc += 3
            elif op == fp.OP_ENUM:
                lo, hi = self.long()
                idx = _i32(lo)
                if hi != 0 or idx < 0 or idx >= code[pc + 2]:
                    self.err |= varint.ERR_BAD_ENUM
                self.put(code[pc + 1], idx)
                pc += 3
            elif op in (fp.OP_NULLABLE, fp.OP_UNION):
                lo, hi = self.long()
                if hi != 0:
                    self.err |= varint.ERR_BAD_BRANCH
                br = _i32(lo)
                if op == fp.OP_NULLABLE:
                    null_idx = code[pc + 2]
                    present = br == 1 - null_idx
                    if not present and br != null_idx:
                        self.err |= varint.ERR_BAD_BRANCH
                    if present:
                        self.put(code[pc + 1], 1)
                    pc = pc + 4 if present else code[pc + 3]
                else:
                    ok = 0 <= br < code[pc + 2]
                    if not ok:
                        self.err |= varint.ERR_BAD_BRANCH
                    self.put(code[pc + 1], br)
                    start = code[pc + 4 + 2 * br] if ok else -1
                    pc = start if start >= 0 else code[pc + 3]
            elif op == fp.OP_JUMP:
                pc = code[pc + 1]
            elif op == fp.OP_REPEATED:
                pc = pc + 4 if self.loop_enter(code, pc) else code[pc + 3]
            elif op == fp.OP_LOOP:
                S = self.lv[-1]
                S["rem"] -= 1
                S["cnt"] += 1
                S["it"] += 1
                rep = S["rep_pc"]
                pc = rep + 4 if self.loop_next(code) else code[rep + 3]
            elif op == fp.OP_TRAILING:
                if self.cur != self.end:
                    self.err |= varint.ERR_TRAILING
                pc += 1
            elif op == fp.OP_REBASE:
                pc += 2
            else:
                return


def table_parts(code_len: int, n_bufs: int, n_regions: int, n_keys: int):
    """``[(name, int32 words)]`` of the packed table after the buffer
    pointers and lengths, in the order the model reads them (the
    kernel's ``tab_offsets``, checked against the source in
    ``test_torch_walk_staging.py``)."""
    T = max(n_keys, 1)
    return [("code", code_len), ("caps", n_regions), ("esize", n_bufs),
            ("ext", n_regions), ("key_off", n_regions), ("spec", T),
            ("has_spec", T)]


def unpack_table(L):
    """The tables of ``L.table`` as ``decode_walk_kernel`` reads them
    (``csrc/decode_walk.cu`` Params.table)."""
    nb = len(L.bufs)
    t = L.table.numpy()
    head = t[:4 * nb].view(np.int64)
    out = {"ptrs": head[:nb].tolist(), "lens": head[nb:].tolist()}
    at = 4 * nb
    for name, n in table_parts(len(L.prog.code), nb, L.n_regions,
                               L.n_keys):
        out[name] = t[at:at + n].tolist()
        at += n
    assert at == t.size
    return out


def model_walk_launch(L):
    """What one ``decode_walk`` launch does to ``L`` (its status reset
    first, as ``_DecodeWalkKernel.launch`` does), block by block. Returns
    the byte reads ``[from staged copies, from the words]``; the blocks
    staged and reading device memory are counted in its status."""
    L.reset()
    width = 4 + max(L.prog.depth, 1)
    tab = unpack_table(L)
    assert tab["ptrs"] == [b.data_ptr() for b in L.bufs]
    assert tab["lens"] == [b.numel() for b in L.bufs]
    a, span, staged, covers = L.input_staging()
    st = {
        "words": L.words.view(torch.uint8).numpy(),
        "last_word": L.words.numel() - 1,
        "starts": L.starts.numpy(), "lengths": L.lengths.numpy(),
        "bufs": [b.numpy() for b in L.bufs],
        "lens": tab["lens"],
        "status": L.status.numpy(), "T": max(L.n_keys, 1),
        "log_at": L.log_at(),
        "log": L.log.numpy().reshape(L.log_cap, width),
        "in_a": a, "in_span": span, "in_staged": staged, "in_covers": covers,
        "fold": L.fold, "reads": [0, 0], **tab,
    }
    code = tab["code"]
    err = L.err.numpy()
    for first in range(0, L.R, decode.WALK_THREADS):
        blk = _Block(L, st, first)
        for row in range(first, first + blk.rows):
            lane = _Lane(L, st, blk, row)
            if row < L.n:
                lane.run(code)
            err[row] = _i32(lane.err)
        blk.finish(st)
    return st["reads"]


class _ModelWalkKernel(decode._DecodeWalkKernel):
    """``_DecodeWalkKernel`` with the model in place of each launch."""

    def launch(self, L) -> None:
        model_walk_launch(L)
        self.launches += 1


# the launch plan the fixtures run under: the record spans staged
MODEL_PLAN = {"in_max": 32 << 10}


def model_walk(words, starts, lengths, n, prog, caps, **plan):
    """``_DecodeWalkKernel.run`` with the model in place of the launches:
    ``(buffers, #err, launches)``."""
    kernel = _ModelWalkKernel()
    L = decode.WalkLaunch(words, starts, lengths, n, prog, caps, log_cap=4,
                          **(plan or MODEL_PLAN))
    bufs, err = kernel.run(L)
    return bufs, err, kernel.launches


FINALIZE_CU = (Path(_build.CSRC) / "decode_finalize.cu").read_text()


def _cu_int(name: str) -> int:
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         FINALIZE_CU).group(1))


THREADS = _cu_int("kThreads")
# rows of a row tile and positions of a staged span (kTile = kThreads *
# kPerThread)
TILE = THREADS * _cu_int("kPerThread")
# entries of an item tile (kRows = kThreads * kPerEntry)
ITEM_TILE = THREADS * _cu_int("kPerEntry")
# a warp's part of a span (kWarpSpan = kTile / kWarps)
WARP_SPAN = TILE // (THREADS // 32)
AGGREGATE, INCLUSIVE = 1, 2  # a look-back word's flag (value << 2 | flag)
LOOK_BACK = _cu_int("kLookBack")  # words warp 0 reads at once
U32 = 0xFFFFFFFF


class _Words:
    """``FinalizeTables``' int64 words, read as the kernel reads them."""

    HEAD = ("n_seg", "seg_at", "job_at", "ent_at", "n_ent", "len_at",
            "n_red", "n_flag", "n_aux", "n_lvl", "red_off", "tot_off",
            "flag_off", "ticket_off")
    SEG = ("kind", "rid", "n_entries", "tcap", "icap", "counts_src",
           "counts_off", "parent", "pslot_off", "slot_off", "off_at",
           "job_first", "job_end", "tile_first", "n_tiles", "flag_first",
           "aux_first", "n_aux")

    def __init__(self, tab: torch.Tensor):
        self.w = [int(x) for x in tab.cpu().tolist()]
        assert len(self.HEAD) == decode._HEAD_WORDS
        assert len(self.SEG) == decode._SEG_WORDS
        self.h = dict(zip(self.HEAD, self.w[:decode._HEAD_WORDS]))

    def seg(self, s: int) -> dict:
        at = self.h["seg_at"] + s * decode._SEG_WORDS
        return dict(zip(self.SEG, self.w[at:at + decode._SEG_WORDS]))

    def job(self, k: int) -> list:
        at = self.h["job_at"] + k * decode._JOB_WORDS
        return self.w[at:at + decode._JOB_WORDS]

    def entry(self, i: int) -> list:
        at = self.h["ent_at"] + i * decode._ENTRY_WORDS
        return self.w[at:at + decode._ENTRY_WORDS]

    def length(self, src: int) -> int:
        return self.w[self.h["len_at"] + src]


def launch_grid(tables) -> list:
    """``[levels, tail blocks, (first segment, end, blocks) per level]``
    as the kernel's launches need them from the segments: a tiles
    launch's blocks are the tiles of its segments (ceil(R / TILE) row
    tiles times the groups of ``icap`` row jobs, ceil(entries /
    ITEM_TILE) per item region); the tail's one per
    staged span of an item region's positions, at most two an SM, and at
    least one (block 0 writes the reductions)."""
    T = _Words(tables.tab)
    segs = [T.seg(s) for s in range(T.h["n_seg"])]
    levels = decode.region_levels(tables.prog)
    out = [T.h["n_lvl"], max(1, min(sum(
        -(-s["tcap"] // TILE) for s in segs if s["kind"] == decode.SEG_ITEMS),
        decode._TAIL_BLOCKS))]
    for lv in range(1, T.h["n_lvl"] + 1):
        on = [i for i, s in enumerate(segs)
              if (levels[s["rid"]] or 1) == lv]
        assert on == list(range(on[0], on[-1] + 1))
        out += [on[0], on[-1] + 1, sum(
            -(-s["n_entries"] // TILE) * -(-(s["job_end"] - s["job_first"])
                                          // s["icap"])
            if s["kind"] == decode.SEG_ROWS
            else -(-s["n_entries"] // ITEM_TILE) for s in
            (segs[i] for i in on))]
    return out


def span_pieces(addr: int, n: int):
    """How a block stores a staged span of ``n`` bytes that starts at
    device address ``addr`` (``store_span``, and ``zero_span`` the same
    way): single bytes up to the first 16-byte boundary, 16-byte words,
    single bytes after the last word. ``[(offset in the span, length),
    ...]``."""
    a = min(-addr % 16, n)
    b = a + (n - a) // 16 * 16
    return ([(k, 1) for k in range(a)] + [(k, 16) for k in range(a, b, 16)]
            + [(k, 1) for k in range(b, n)])


def warp_spans(p0: int, n_pos: int):
    """The parts ``[w0, w1)`` of the positions ``[p0, p0 + n_pos)`` that
    each warp of a block gathers and stores (``warp_jobs``), in warp
    order; a warp past the span's end has an empty part."""
    return [(p0 + w0, p0 + max(min(w0 + WARP_SPAN, n_pos), w0))
            for w0 in range(0, TILE, WARP_SPAN)]


def tile_spans(at: int, bits: int, n_pos: int, blocks: int):
    """The blob spans ``[g0, g1)`` that the warps of each row tile store of
    a field at ``at`` with elements of ``bits`` bits (1 for a bit-packed
    lane), tile after tile."""
    return [(at + w0 * bits // 8, at + w1 * bits // 8)
            for j0 in range(0, blocks * TILE, TILE)
            for w0, w1 in warp_spans(j0, max(min(TILE, n_pos - j0), 0))]


def item_spans(P: int, end: int):
    """The staged spans ``[c0, c1)`` of positions an item tile whose items
    start at ``P`` stores, below ``end`` (its total or tot_cap)."""
    return [(c0, min(c0 + TILE, end)) for c0 in range(P, end, TILE)]


class _Blob:
    """The blob as the blocks store it: every piece counted per byte."""

    def __init__(self, blob: np.ndarray, addr: int):
        self.blob, self.addr = blob, addr
        self.writes = np.zeros(blob.size, np.int64)
        self.pieces = []  # (block's span, first byte, length)

    def store_span(self, g0: int, g1: int, data: np.ndarray) -> None:
        for off, ln in span_pieces(self.addr + g0, g1 - g0):
            at = g0 + off
            self.blob[at:at + ln] = data[off:off + ln]
            self.writes[at:at + ln] += 1
            self.pieces.append(((g0, g1), at, ln))

    def store_field(self, at: int, bits: int, data: np.ndarray,
                    n_pos: int, blocks: int) -> None:
        """A field of ``n_pos`` elements, its bytes ``data``, stored tile
        by tile."""
        for g0, g1 in tile_spans(at, bits, n_pos, blocks):
            self.store_span(g0, g1, data[g0 - at:g1 - at])

    def put(self, at: int, data) -> None:
        """A store of one thread."""
        data = np.asarray(data).view(np.uint8).reshape(-1)
        self.blob[at:at + data.size] = data
        self.writes[at:at + data.size] += 1


def _sv(scratch: np.ndarray, off: int, dtype, n: int) -> np.ndarray:
    return scratch[off:off + n * np.dtype(dtype).itemsize].view(dtype)


def _wrap(x):
    return ((np.asarray(x, np.int64) + (1 << 31)) & U32) - (1 << 31)


class _Run:
    """One ``decode_finalize_run`` on the CPU: the tables' words, the
    scratch, the sources and the blob, with the kernel's counters."""

    def __init__(self, plan):
        self.plan, self.T = plan, _Words(plan.tables.tab)
        h = self.T.h
        self.sc = plan.scratch.numpy()
        self.srcs = [s.numpy() for s in plan.srcs]
        self.out = _Blob(plan.blob.numpy(), plan.blob.data_ptr())
        nr = len(plan.prog.regions)
        self.red = _sv(self.sc, h["red_off"], np.int32, h["n_red"])
        self.tot = _sv(self.sc, h["tot_off"], np.int64, nr)
        self.flags = _sv(self.sc, h["flag_off"], np.uint64, h["n_flag"])
        self.tickets = _sv(self.sc, h["ticket_off"], np.uint32, h["n_lvl"])

    def take(self, src: int, slot: np.ndarray) -> np.ndarray:
        t = self.srcs[src]
        v = t[np.clip(slot, 0, t.size - 1)]
        return v.astype(np.int64) if t.dtype == np.uint8 \
            else v.view(np.uint32).astype(np.int64)

    def fold(self, r: int, values: np.ndarray) -> None:
        """One block's maximum into red[r], where it is above 0."""
        m = int(values.max()) if values.size else 0
        if r >= 0 and m > 0:
            self.red[r] = max(int(self.red[r]), m)

    def rows_tile(self, S: dict, t: int) -> None:
        """A row tile's group of ``icap`` jobs (the row segment's word)."""
        groups = -(-(S["job_end"] - S["job_first"]) // S["icap"])
        j0 = t // groups * TILE
        j = np.arange(j0, min(j0 + TILE, S["n_entries"]))
        first = S["job_first"] + t % groups * S["icap"]
        self.jobs(range(first, min(first + S["icap"], S["job_end"])), j0, j,
                  None)

    def jobs(self, ks, p0: int, slot: np.ndarray, tcap) -> None:
        """``warp_jobs``: each job over the positions ``p0 + q`` (the
        sources' elements at ``slot``), every warp's part stored whole;
        an item span (``tcap`` given) puts a bit-packed lane's bytes into
        scratch instead."""
        parts = warp_spans(p0, slot.size)
        for k in ks:
            kind, src, src2, at, at2, scr, r, _es = self.T.job(k)
            v = self.take(src, slot)
            if kind == decode.J_ERRFLAG:
                for w0, w1 in parts:
                    self.fold(r, ((v[w0 - p0:w1 - p0]
                                   & ~varint.ERR_ITEM_OVERFLOW & U32) != 0
                                  ).astype(np.int32))
                continue
            if kind == decode.J_BITS8 and tcap is not None:
                _sv(self.sc, scr, np.uint8, tcap)[p0:p0 + slot.size] = v != 0
                continue
            ln = self.take(src2, slot) if kind in (
                decode.J_SL32, decode.J_START_LENC) else None
            if kind == decode.J_COPY32 and scr >= 0:
                _sv(self.sc, scr, np.int32, tcap)[p0:p0 + slot.size] = \
                    v.astype(np.uint32).view(np.int32)
            word = ((v | (ln << 21)) & U32) if kind == decode.J_SL32 else v
            for w0, w1 in parts:
                q = slice(w0 - p0, w1 - p0)
                if ln is not None:
                    self.fold(r, ln[q].astype(np.int32))
                if kind == decode.J_BITS8:
                    self.out.store_span(at + w0 // 8, at + w1 // 8, np.packbits(
                        v[q] != 0, bitorder="little"))
                    continue
                self.out.store_span(at + 4 * w0, at + 4 * w1, word[q].astype(
                    np.uint32).view(np.uint8))
                if kind == decode.J_START_LENC:
                    self.out.store_span(at2 + 2 * w0, at2 + 2 * w1, (
                        ln[q] & 0xFFFF).astype(np.uint16).view(np.uint8))

    def publish(self, S: dict, t: int) -> dict:
        """An item tile's first half: its counts (zero past the parent's
        total for a nested region), their maximum folded, their sum
        published in its look-back word."""
        e0 = t * ITEM_TILE
        e1 = min(e0 + ITEM_TILE, S["n_entries"])
        if S["counts_src"] >= 0:
            counts, n_live = self.srcs[S["counts_src"]], S["n_entries"]
        else:
            counts = _sv(self.sc, S["counts_off"], np.int32, S["n_entries"])
            n_live = min(S["n_entries"], int(self.tot[S["parent"]]))
        cnt = np.zeros(e1 - e0, np.int64)
        live = max(0, min(e1, n_live) - e0)
        cnt[:live] = counts[e0:e0 + live]
        self.fold(S["rid"], cnt.astype(np.int32))
        agg = int(cnt.sum())
        self.flags[S["flag_first"] + t] = np.uint64(
            agg << 2 | (INCLUSIVE if t == 0 else AGGREGATE))
        return dict(S=S, t=t, e0=e0, e1=e1, cnt=cnt, agg=agg)

    def look_back(self, S: dict, t: int) -> int:
        """Warp 0's look-back: ``LOOK_BACK`` predecessors' words at a
        time, nearest first, down to an inclusive one."""
        if t == 0:
            return 0
        P, k = 0, t - 1
        while True:
            w = [int(self.flags[S["flag_first"] + i]) if i >= 0 else INCLUSIVE
                 for i in range(k, k - LOOK_BACK, -1)]
            incl = [x & 3 == INCLUSIVE for x in w]
            stop = incl.index(True) if any(incl) else LOOK_BACK - 1
            assert all(x & 3 for x in w[:stop + 1])  # all published
            P += sum(x >> 2 for x in w[:stop + 1])
            if any(incl):
                return P
            k -= LOOK_BACK

    def finish(self, st: dict) -> None:
        """An item tile's second half: its prefix, its ``#offsets``, its
        entries' items at their positions, span by span."""
        S, t, e0, e1, cnt, agg = (st[k] for k in
                                  ("S", "t", "e0", "e1", "cnt", "agg"))
        P = self.look_back(S, t)
        if t:
            self.flags[S["flag_first"] + t] = np.uint64(
                (P + agg) << 2 | INCLUSIVE)
        last = t == S["n_tiles"] - 1
        if last:
            self.tot[S["rid"]] = P + agg
        lo = P + np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
        off = list(lo) + ([P + agg] if last else [])
        at = S["off_at"]
        self.out.store_span(at + 4 * e0, at + 4 * (e0 + len(off)),
                            (np.array(off, np.int64) & U32).astype(
                                np.uint32).view(np.uint8))
        end = min(P + agg, S["tcap"])
        placed = np.clip(np.minimum(lo + cnt, end) - lo, 0, None)
        ent = np.repeat(np.arange(e0, e1), placed)
        first = np.repeat(lo, placed)
        j = first + (np.arange(ent.size) - np.repeat(
            np.cumsum(placed) - placed, placed))
        assert ent.size == max(0, end - P)
        assert (j == np.arange(P, P + ent.size)).all()  # entries tile the span
        ps = ent if S["pslot_off"] < 0 else _sv(
            self.sc, S["pslot_off"], np.int32, S["n_entries"])[ent]
        slots = _wrap(ps.astype(np.int64) * S["icap"] + j - first)
        for c0, c1 in item_spans(P, end):
            # the span's slot table, entry by entry; then each job
            # position by position
            slot = slots[c0 - P:c1 - P]
            if S["slot_off"] >= 0:
                _sv(self.sc, S["slot_off"], np.int32, S["tcap"])[c0:c1] = slot
            self.jobs(range(S["job_first"], S["job_end"]), c0, slot,
                      S["tcap"])

    def tail(self) -> None:
        """The tail kernel: every item field zeroed past its region's
        total, span by span; the bit-packed lanes packed, one thread a
        byte; then block 0's reductions and resets."""
        T = self.T
        segs = [T.seg(s) for s in range(T.h["n_seg"])]
        for g in range(T.h["n_aux"]):
            S, = [s for s in segs if s["kind"] == decode.SEG_ITEMS
                  and s["aux_first"] <= g < s["aux_first"] + s["n_aux"]]
            c0 = (g - S["aux_first"]) * TILE
            c1 = min(c0 + TILE, S["tcap"])
            total = int(self.tot[S["rid"]])
            z0 = max(c0, min(total, c1))
            for k in range(S["job_first"], S["job_end"]):
                kind, _s, _s2, at, at2, scr, _r, _es = T.job(k)
                if kind == decode.J_BITS8:
                    lane = _sv(self.sc, scr, np.uint8, S["tcap"])
                    for b in range(c0 // 8, c1 // 8):
                        bits = 0
                        for q in range(8):
                            jj = 8 * b + q
                            bits |= int(jj < total and lane[jj] != 0) << q
                        self.out.put(at + b, np.uint8(bits))
                else:
                    self.out.store_span(at + 4 * z0, at + 4 * c1,
                                        np.zeros(4 * (c1 - z0), np.uint8))
                    if kind == decode.J_START_LENC:
                        self.out.store_span(at2 + 2 * z0, at2 + 2 * c1,
                                            np.zeros(2 * (c1 - z0), np.uint8))
        for i in range(T.h["n_ent"]):
            kind, at, a, b, c = T.entry(i)
            if kind == decode.E_MAX:
                self.out.put(at, np.array([self.red[a]], np.int32))
            elif kind == decode.E_SUM:
                self.out.put(at, np.array([_wrap(self.tot[a])], np.int32))
            elif kind == decode.E_ERR:
                self.out.put(at, np.uint8(self.red[a] != 0))
            elif kind == decode.E_STRFIT:
                self.out.put(at, np.uint8(all(
                    self.red[a + k] < c for k in range(b))))
            else:
                assert kind == decode.E_STATUS
                status = np.zeros(decode.STATUS_BYTES, np.uint8)
                status[0] = any(int(self.tot[r]) >= 1 << 31
                                for r in range(1, a))
                self.out.put(at, status)
        self.red[:] = 0
        self.flags[:] = 0
        self.tickets[:] = 0


def model_finalize(plan, log=None, seed: int = 0) -> torch.Tensor:
    """What ``decode_finalize_run``'s launches write, run along the plan's
    own tables and scratch: per level, each block takes a ticket and its
    segment's tile; every item tile publishes its counts' sum, then the
    tiles (in an order drawn from ``seed``, so that a look-back meets both
    published sums and inclusive prefixes) take their prefixes by the
    look-back, write their ``#offsets`` and place their entries' items
    span by span; row tiles store their row payload. Then the tail. Every
    store goes through :class:`_Blob`; ``log``, if given, receives it
    (``"blob"``)."""
    run = _Run(plan)
    assert not run.red.any() and not run.flags.any() and \
        not run.tickets.any()  # the last run left its counters at 0
    rng = random.Random(seed)
    grid = [int(x) for x in plan.tables.plan]
    T = run.T
    for lv in range(grid[0]):
        s0, s1, blocks = grid[2 + 3 * lv:5 + 3 * lv]
        tiles = []
        for _b in range(blocks):
            ticket = int(run.tickets[lv])
            run.tickets[lv] += 1
            S, = [S for S in (T.seg(s) for s in range(s0, s1))
                  if S["tile_first"] <= ticket < S["tile_first"] +
                  S["n_tiles"]]
            tiles.append((S, ticket - S["tile_first"]))
        half = [run.publish(S, t) if S["kind"] == decode.SEG_ITEMS
                else (S, t) for S, t in tiles]
        rng.shuffle(half)
        for st in half:
            if isinstance(st, dict):
                run.finish(st)
            else:
                run.rows_tile(*st)
    run.tail()
    if log is not None:
        log.update(blob=run.out)
    return plan.blob


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rungs(schema, datums):
    """Every rung the CPU decoder's ladder visits from the first rung (no
    host sample), with its packed input."""
    dec = decode.DeviceDecoder(parse_schema(schema), device="cpu")
    dec.seed_caps_from_sample = lambda data, R: None
    seen = []
    real = dec.pipeline

    def recording(packed, R, B, n, item_caps, tot_caps, compact,
                  timings=None):
        seen.append((packed, R, B, n, item_caps, tot_caps, compact))
        return real(packed, R, B, n, item_caps, tot_caps, compact, timings)

    dec.pipeline = recording
    try:
        dec.decode_to_columns(datums)
    except decode.MalformedAvro:
        pass
    return dec, seen


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_kernel_models_match_plain_versions(name):
    schema, datums = FIXTURES[name]
    dec, rungs = _rungs(schema, datums)
    prog = dec.prog
    for packed, R, B, n, item_caps, tot_caps, compact in rungs:
        words, starts, lengths = dec.launch_views(packed, R, B)
        pb, pe = decode.walk_plain(words, starts, lengths, n, prog,
                                   item_caps)
        kb, ke, _launches = model_walk(words, starts, lengths, n, prog,
                                       item_caps)
        for key, k, p in zip(prog.out_keys + ["#err"], kb + [ke],
                             pb + [pe]):
            assert torch.equal(k, p), (name, key, item_caps)
        want = decode.finalize_plain(pb, pe, prog, R, B, item_caps, tot_caps,
                                     compact)
        _hold_model(name, kb, ke, prog, R, B, item_caps, tot_caps, compact,
                    want)


def _hold_model(name, bufs, err, prog, R, B, item_caps, tot_caps, compact,
                want) -> None:
    """The model twice on one cached scratch (the second run finds the
    counters the first left at 0, and meets the look-back words in
    another order), each blob bit-equal to ``want`` with every byte
    written once; and the launch plan as the segments give it."""
    cache = decode.FinalizeCache()
    for seed in (0, 1):
        plan = decode.FinalizePlan(bufs, err, prog, R, B, item_caps,
                                   tot_caps, compact, cache)
        assert plan.tables.plan.tolist() == launch_grid(plan.tables)
        plan.blob.fill_(0xA5)  # every byte must be written
        log = {}
        assert torch.equal(model_finalize(plan, log, seed), want), \
            (name, item_caps, seed)
        assert (log["blob"].writes == 1).all(), (name, item_caps)
    assert len(cache.entries()) == 1


EDGES = {name: (schema, datums) for name, schema, datums, _bad in
         chip_smoke.finalize_edge_fixtures(datagen, parse_schema,
                                           decode.FIN_ROWS)}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_finalize_model_on_tile_edges(name):
    """K2's model on the cases of tile and span edges (the card's gate
    runs the same), at every rung from the first: the plain walk's
    buffers in, the blob bit-equal to the plain finalize's."""
    schema, datums = EDGES[name]
    dec, rungs = _rungs(schema, datums)
    prog, seen = dec.prog, set()
    for packed, R, B, n, item_caps, tot_caps, compact in rungs:
        words, starts, lengths = dec.launch_views(packed, R, B)
        pb, pe = decode.walk_plain(words, starts, lengths, n, prog,
                                   item_caps)
        want = decode.finalize_plain(pb, pe, prog, R, B, item_caps, tot_caps,
                                     compact)
        _hold_model(name, pb, pe, prog, R, B, item_caps, tot_caps, compact,
                    want)
        seen.add((R, item_caps[1]))
    R = rungs[-1][1]
    if name.startswith("tile_edge_"):
        assert R == decode.FIN_ROWS * (1 + (len(datums) > decode.FIN_ROWS))
    if name == "over_icap_first_rung":
        assert rungs[0][4][1] == 8 and len(rungs) > 1
    if name == "entry_over_a_span":
        assert rungs[-1][5][1] > TILE


@pytest.mark.parametrize("counts", [(1 << 30, 1 << 30),
                                    ((1 << 31) - 1,) * 3])
def test_region_total_past_2_31_sets_status_byte_0(counts):
    """A region whose items total 2^31 or more (zero-byte items: only a
    count bounds them) sets status byte 0, and the codec halves the
    batch. The region has no item bytes, so the blob is the plain
    finalize's byte for byte: #offsets and #red:sum truncated to int32."""
    prog = decode.lower(parse_schema(chip_smoke.NULLS_SCHEMA))
    R, B, item_caps, tot_caps = 16, 64, (0, 8), (0, 64)
    bufs = decode.alloc_walk_outputs(prog, R, item_caps, "cpu")
    count = bufs[prog.out_keys.index("xs#count")]
    for i, c in enumerate(counts):
        count[3 + 5 * i] = c
    err = torch.zeros(R, dtype=torch.int32)
    want = decode.finalize_plain(bufs, err, prog, R, B, item_caps, tot_caps)
    assert int(want[-decode.STATUS_BYTES]) == 1
    _hold_model("past_2^31", bufs, err, prog, R, B, item_caps, tot_caps,
                True, want)
    dec = decode.DeviceDecoder(parse_schema(chip_smoke.NULLS_SCHEMA),
                               device="cpu")
    with pytest.raises(decode.BatchTooLarge):
        dec._split(want.numpy(), decode.blob_layout(
            prog, R, B, item_caps, tot_caps), R)


@pytest.mark.parametrize("seed", range(4))
def test_look_back_reads_windows_of_words(seed):
    """Warp 0's look-back over 1,000 tiles of one segment, each tile's
    predecessors published as sums or as inclusive prefixes at random
    (tile 0 always inclusive; seed 0 no other): every tile's prefix is
    the sum of the counts before it, also where no inclusive prefix lies
    within one window of ``LOOK_BACK`` words."""
    rng = random.Random(seed)
    n = 1000
    aggs = [rng.randrange(0, 5000) for _ in range(n)]
    run = types.SimpleNamespace(flags=np.zeros(n, np.uint64))
    for t, a in enumerate(aggs):
        incl = t == 0 or (seed and rng.random() < 0.002 * seed)
        run.flags[t] = np.uint64(
            (sum(aggs[:t + 1]) if incl else a) << 2
            | (INCLUSIVE if incl else AGGREGATE))
    S = {"flag_first": 0}
    for t in range(n):
        assert _Run.look_back(run, S, t) == sum(aggs[:t]), t


def _kafka_rung():
    prog = decode.lower(parse_schema(datagen.KAFKA_SCHEMA_JSON))
    R, B, ic, tc = 64, 4096, (0, 8, 8), (0, 128, 128)
    bufs = decode.alloc_walk_outputs(prog, R, ic, "cpu")
    return prog, bufs, torch.zeros(R, dtype=torch.int32), (R, B, ic, tc)


def test_finalize_cache_keys_tables_per_rung_and_scratch_per_thread():
    """One rung's tables are built once and shared; its scratch is one per
    thread (two threads never share look-back words or maxima); another
    rung gets tables of its own."""
    import threading

    prog, bufs, err, (R, B, ic, tc) = _kafka_rung()
    cache = decode.FinalizeCache()
    a = decode.FinalizePlan(bufs, err, prog, R, B, ic, tc, True, cache)
    b = decode.FinalizePlan(bufs, err, prog, R, B, ic, tc, True, cache)
    assert a.tables is b.tables and a.scratch is b.scratch
    assert a.blob.data_ptr() != b.blob.data_ptr()  # a new blob per call
    other = {}

    def in_thread():
        other["plan"] = decode.FinalizePlan(bufs, err, prog, R, B, ic, tc,
                                            True, cache)

    th = threading.Thread(target=in_thread)
    th.start()
    th.join()
    assert other["plan"].tables is a.tables
    assert other["plan"].scratch is not a.scratch
    wide = decode.FinalizePlan(bufs, err, prog, R, B, ic, (0, 256, 128),
                               True, cache)
    assert wide.tables is not a.tables
    assert len(cache.entries()) == 2
    # the scratch's counters start at 0 and the tables say where they are
    assert not a.view("red", torch.int32, a.tables.words[6]).any()


def test_finalize_cache_is_a_memory_plane():
    """The decoders' finalize caches are the ``finalize`` plane of the
    cache lifecycle and the ``cache.finalize`` probe: entries with their
    card bytes, evicted by rung; a plan made after the eviction builds
    the rung again."""
    from pyruhvro_tpu_torch.runtime import cachelife, memacct

    prog, bufs, err, (R, B, ic, tc) = _kafka_rung()
    dec = decode.DeviceDecoder(parse_schema(datagen.KAFKA_SCHEMA_JSON),
                               device="cpu")
    plan = decode.FinalizePlan(bufs, err, prog, R, B, ic, tc, True,
                               dec._finalize)
    ents = [e for e in cachelife._caches["finalize"].entries()
            if e[0][0] == id(dec._finalize)]
    assert len(ents) == 1
    key, _used, nbytes = ents[0]
    assert nbytes == plan.tables.tab.numel() * 8 + plan.scratch.numel()
    probe = memacct.collect(force=True)["cache.finalize"]
    assert probe["items"] >= 1 and probe["device_bytes"] >= nbytes
    assert probe["bytes"] == 0.0
    assert cachelife._caches["finalize"].evict(key)
    assert dec._finalize.entries() == []
    again = decode.FinalizePlan(bufs, err, prog, R, B, ic, tc, True,
                                dec._finalize)
    assert again.tables is not plan.tables
    assert torch.equal(again.tables.tab, plan.tables.tab)


@pytest.mark.parametrize("P, end", [(0, 0), (0, 1), (5, TILE), (5, TILE + 5),
                                    (TILE - 1, 3 * TILE + 7)])
def test_item_spans_cover_the_tile_once(P, end):
    """An item tile's staged spans cover its positions ``[P, end)`` once,
    each at most ``TILE`` positions, the first at ``P``."""
    spans = item_spans(P, end)
    covered = [j for c0, c1 in spans for j in range(c0, c1)]
    assert covered == list(range(P, end))
    assert all(0 < c1 - c0 <= TILE for c0, c1 in spans)


@pytest.mark.parametrize("bits", [1, 16, 32])
@pytest.mark.parametrize("shift", range(16))
def test_tile_spans_write_every_byte_once(shift, bits):
    """A field at each offset mod 16, stored tile by tile: spans shorter
    than one 16-byte word, one whole tile, and a last partial tile. Every
    byte of the field is written exactly once and nothing around it; every
    16-byte word is aligned and inside its block's span."""
    short = 8 if bits == 1 else 64 // bits  # 1 or 8 bytes
    for n_pos in (short, TILE, 2 * TILE + 40):
        nbytes = n_pos * bits // 8
        at = 32 + shift
        blob = _Blob(np.zeros(at + nbytes + 32, np.uint8), 0)
        data = (np.arange(nbytes) % 251 + 1).astype(np.uint8)
        blocks = -(-n_pos // TILE)
        blob.store_field(at, bits, data, n_pos, blocks)
        assert (blob.blob[at:at + nbytes] == data).all()
        want = np.zeros(blob.blob.size, np.int64)
        want[at:at + nbytes] = 1
        assert (blob.writes == want).all(), n_pos
        for (g0, g1), first, ln in blob.pieces:
            assert g0 <= first and first + ln <= g1
            assert ln == 1 or (ln == 16 and first % 16 == 0)
        spans = [(g0, g1) for g0, g1 in tile_spans(at, bits, n_pos, blocks)]
        if n_pos == short:
            assert not any(ln == 16 for _s, _f, ln in blob.pieces)
        else:  # the last tile's warps store what is left of the field
            per_tile = len(spans) // blocks
            assert sum(g1 - g0 for g0, g1 in spans[-per_tile:]) == \
                (n_pos - (blocks - 1) * TILE) * bits // 8


def test_global_bound_needs_relaunches_with_wider_tables():
    """The nested fixture's cut lanes sit off the first key table (its
    nested regions have no keys until a cut shows their counters), then
    on it without a bound, then with the recorded one."""
    schema, datums = FIXTURES["nested_global_bound"]
    dec, rungs = _rungs(schema, datums)
    packed, R, B, n, item_caps, _t, _c = rungs[0]
    words, starts, lengths = dec.launch_views(packed, R, B)
    *_out, launches = model_walk(words, starts, lengths, n, dec.prog,
                                 item_caps)
    assert launches == 3


def test_bounds_that_do_not_settle_raise_with_the_last_record(monkeypatch):
    """A walk that needs more launches than the limit raises and names
    what its last launch recorded, instead of relaunching on."""
    schema, datums = FIXTURES["nested_global_bound"]
    dec, rungs = _rungs(schema, datums)
    packed, R, B, n, item_caps, _t, _c = rungs[0]
    words, starts, lengths = dec.launch_views(packed, R, B)
    monkeypatch.setattr(decode, "_MAX_WALK_LAUNCHES", 2)
    with pytest.raises(RuntimeError, match=r"did not settle in 2 launches"
                       r".*ran with bounds other than .*extents"):
        model_walk(words, starts, lengths, n, dec.prog, item_caps)


def test_log_replays_writes_under_dropped_items_in_reference_order():
    schema, datums = FIXTURES["nested_overflow"]
    dec, rungs = _rungs(schema, datums)
    packed, R, B, n, item_caps, _t, _c = rungs[0]
    words, starts, lengths = dec.launch_views(packed, R, B)
    L = decode.WalkLaunch(words, starts, lengths, n, dec.prog, item_caps,
                          log_cap=4)
    while True:
        model_walk_launch(L)
        if L.settle():
            break
    # the log grew past its first capacity
    assert int(L.status[L.log_at()]) > 4
    L.apply_log()
    pb, _pe = decode.walk_plain(words, starts, lengths, n, dec.prog,
                                item_caps)
    for k, p in zip(L.bufs, pb):
        assert torch.equal(k, p)


@pytest.mark.parametrize("source, names", [
    ("decode_walk.cu", {"decode_walk", "decode_walk_smem_bytes",
                        "decode_walk_blocks_per_sm"}),
    ("decode_finalize.cu", {"decode_finalize_run"}),
])
def test_kernel_library_declares_every_argument(monkeypatch, source, names):
    """ctypes passes every pointer and the stream as c_void_p, every
    ``long long`` as c_longlong and every ``int`` as c_int, in the order
    of each C entry point; an undeclared pointer is cut to 32 bits."""
    from pyruhvro_tpu_torch.ops import _build

    src = (Path(_build.CSRC) / source).read_text()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(entries) == names
    fns = {name: ctypes.CDLL(None).strlen for name in entries}
    lib = types.SimpleNamespace(cdll=types.SimpleNamespace(**fns))
    monkeypatch.setattr(_build, "load_kernel_library", lambda s: lib)
    wrapper = decode.walk_kernel if source == "decode_walk.cu" \
        else decode.finalize_kernel
    wrapper.library()
    for name, params in entries.items():
        kinds = [ctypes.c_void_p if "*" in p else
                 ctypes.c_longlong if "long long" in p else ctypes.c_int
                 for p in params.split(",")]
        assert fns[name].argtypes == kinds, name
        assert fns[name].restype is ctypes.c_int, name


def test_finalize_source_agrees_on_job_kinds_and_status_bytes():
    from pyruhvro_tpu_torch.ops import _build

    fin = (Path(_build.CSRC) / "decode_finalize.cu").read_text()
    for prefix in ("J", "E", "SEG"):
        enum = re.search(r"enum \{ (%s_\w+(?:, %s_\w+)*) \}" % (prefix, prefix),
                         fin).group(1).split(", ")
        for value, name in enumerate(enum):
            assert getattr(decode, name) == value, name
    assert "#define ERR_ITEM_OVERFLOW 128u" in fin
    for const, value in (("kStatusBytes", decode.STATUS_BYTES),
                         ("kHeadWords", decode._HEAD_WORDS),
                         ("kSegWords", decode._SEG_WORDS),
                         ("kJobWords", decode._JOB_WORDS),
                         ("kEntryWords", decode._ENTRY_WORDS),
                         ("kSrcMax", decode.FIN_SRC_MAX)):
        assert _cu_int(const) == value, const
    # the parameter block: a small Call up to FIN_SRC_SMALL sources
    assert "#define FIN_SRC_SMALL 64" in fin
    assert "constexpr int kSrcSmall = FIN_SRC_SMALL;" in fin
    assert re.findall(r"run<(\w+)>\(", fin) == ["kSrcSmall", "kSrcMax"]
    assert "kTile = kThreads * kPerThread;" in fin
    assert "kRows = kThreads * kPerEntry;" in fin
    assert (TILE, ITEM_TILE) == (decode.FIN_TILE, decode.FIN_ROWS)
    # each word of a table the kernel reads is named where it is defined
    head = re.search(r"kHeadWords = \d+;((?:\s*//[^\n]*)+)", fin).group(1)
    assert head.replace("//", "").split() == list(_Words.HEAD)
    seg = re.search(r"kSegWords = \d+;((?:\s*//[^\n]*)+)", fin).group(1)
    assert seg.replace("//", "").split() == list(_Words.SEG)
    # no position searches for its entry: no binary search, no row_of
    assert "mid" not in re.findall(r"\w+", fin)
    assert "offsets[" not in fin
    # the launches: each level's tiles, then the tail, all in one call
    assert "finalize_tiles_kernel<N><<<(unsigned)P[2], kThreads, 0, s>>>(c);" \
        in fin
    assert "finalize_tail_kernel<N><<<(unsigned)plan[1], kThreads, 0, s>>>(c);" \
        in fin


def test_kernel_library_refuses_more_sources_than_a_launch_holds():
    """The sources' pointers travel in the launch's parameter block: a
    schema with more walk buffers than it holds is refused before any
    launch, with the engine's own error."""
    prog = types.SimpleNamespace(out_keys=[f"k{i}" for i in range(
        decode.FIN_SRC_MAX)], regions=[""], region_parents=[-1],
        string_cols=[], buffers={})
    with pytest.raises(decode.DeviceCapacityExceeded, match="4001 walk"):
        decode.FinalizeTables(prog, 8, 16, (0,), (0,), True, "cpu")


def test_finalize_tables_refuse_an_item_region_without_entries():
    """Every item segment has at least one tile: one that had none would
    leave its ``#offsets`` unwritten and the last run's total in the
    scratch. A rung whose parent region holds no item gives its child no
    entry, and the plain finalize cannot take it either."""
    prog = decode.lower(parse_schema(chip_smoke.PIPELINE_SHAPES[
        "arr_rec_arr"]))
    R, B, ic = 16, 64, (0, 8, 8, 8)
    with pytest.raises(ValueError, match="at least one entry"):
        decode.FinalizeTables(prog, R, B, ic, (0, 0, 8, 8), True, "cpu")
    t = decode.FinalizeTables(prog, R, B, ic, (0, 1, 8, 8), True, "cpu")
    segs = [_Words(t.tab).seg(s) for s in range(int(t.words[0]))]
    assert all(S["n_tiles"] >= 1 for S in segs)


def test_span_pieces_follow_store_span():
    """``span_pieces`` splits a span as the kernel's ``store_span`` does:
    the head up to the first 16-byte boundary of the address, whole
    16-byte words, the tail; a byte's staging offset keeps the address's
    offset mod 16."""
    body = re.search(r"void store_span\(.*?\n\}\n", FINALIZE_CU,
                     re.S).group(0)
    for line in (
            "const uint8_t* s = st + shift_of(d);",
            "const long long a = min((long long)((16 - shift_of(d)) & 15), n);",
            "const long long b = a + ((n - a) & ~15ll);",
            "if (tid < a) d[tid] = s[tid];",
            "if (tid < n - b) d[b + tid] = s[b + tid];",
            "const int tid = threadIdx.x % kGroup;",
            "for (long long k = a + 16 * tid; k < b; k += 16 * kGroup) {",
            "*reinterpret_cast<uint4*>(d + k) = "
            "*reinterpret_cast<const uint4*>(s + k);"):
        assert line in body, line
    # a warp stores its own part of a span; the block its #offsets
    assert FINALIZE_CU.count("store_span<32>(") == 3
    assert "store_span<kThreads>(d, 4 * (e_end - e0), flat);" in FINALIZE_CU
    assert "return (int)(reinterpret_cast<uintptr_t>(g0) & 15u);" in \
        FINALIZE_CU
    # zero_span: the same pieces, zeros for bytes
    zero = re.search(r"void zero_span\(.*?\n\}\n", FINALIZE_CU,
                     re.S).group(0)
    for line in (
            "const long long a = min((long long)((16 - shift_of(d)) & 15), n);",
            "const long long b = a + ((n - a) & ~15ll);",
            "if (tid < a) d[tid] = 0;",
            "if (tid < n - b) d[b + tid] = 0;",
            "for (long long k = a + 16 * tid; k < b; k += 16 * kThreads) {"):
        assert line in zero, line
    for addr in range(32):
        for n in (0, 1, 15, 16, 17, 40):
            a = min((16 - addr % 16) & 15, n)
            b = a + ((n - a) & ~15)
            assert span_pieces(addr, n) == \
                [(k, 1) for k in range(a)] + \
                [(k, 16) for k in range(a, b, 16)] + \
                [(k, 1) for k in range(b, n)]
