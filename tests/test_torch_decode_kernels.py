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
# positions of one block of a gather pass (kTile = kThreads * kPerThread)
TILE = (int(re.search(r"kThreads = (\d+);", FINALIZE_CU).group(1))
        * int(re.search(r"kPerThread = (\d+);", FINALIZE_CU).group(1)))


def pass_grid(p) -> int:
    """The blocks ``decode_finalize_pass`` launches for pass ``p``: tiles
    over its positions, and an item pass's ``#offsets`` entries."""
    work = max(p["n_pos"], p["n_entries"] + 1) if p["rid"] else p["n_pos"]
    return -(-work // TILE)


def span_pieces(addr: int, n: int):
    """How a block stores a staged span of ``n`` bytes that starts at
    device address ``addr`` (``store_span``): single bytes up to the first
    16-byte boundary, 16-byte words, single bytes after the last word.
    ``[(offset in the span, length), ...]``."""
    a = min(-addr % 16, n)
    b = a + (n - a) // 16 * 16
    return ([(k, 1) for k in range(a)] + [(k, 16) for k in range(a, b, 16)]
            + [(k, 1) for k in range(b, n)])


def tile_spans(at: int, bits: int, n_pos: int, blocks: int):
    """The blob span ``[g0, g1)`` that each block stores of a field at
    ``at`` with elements of ``bits`` bits (1 for a bit-packed lane)."""
    return [(at + j0 * bits // 8, at + max(min(j0 + TILE, n_pos), j0)
             * bits // 8) for j0 in range(0, blocks * TILE, TILE)]


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
        """A store of the epilogue (one thread per entry)."""
        data = np.asarray(data).view(np.uint8).reshape(-1)
        self.blob[at:at + data.size] = data
        self.writes[at:at + data.size] += 1


def model_finalize(plan, log=None) -> torch.Tensor:
    """What ``decode_finalize``'s passes and epilogue write, run along the
    plan's own tables: each pass in blocks of ``TILE`` positions, each
    block storing its span of every field it writes through
    :class:`_Blob`, and folding each reducing job's block maximum into
    ``red`` once, where it is above 0. ``log``, if given, receives the
    :class:`_Blob` (``"blob"``)."""
    out = _Blob(plan.blob.numpy(), plan.blob.data_ptr())
    red = plan.red.zero_().numpy()
    ptr = {t.data_ptr(): t for t in list(plan.counts_in.values())
           + list(plan.offsets.values())}
    for p in plan.passes:
        rid, n_pos = p["rid"], p["n_pos"]
        blocks = pass_grid(p)
        j = torch.arange(n_pos)
        if rid == 0:
            slot, in_range = j, torch.ones(n_pos, dtype=torch.bool)
        else:
            n_e = p["n_entries"]
            off = plan.offsets[rid]
            off[0] = 0
            off[1:] = torch.cumsum(plan.counts_in[rid].to(torch.int64), 0)
            out.store_field(p["off_at"], 32,
                            off.to(torch.int32).numpy().view(np.uint8),
                            n_e + 1, blocks)
            in_range = j < off[n_e]
            ent = torch.searchsorted(off[:n_e], j, right=True) - 1
            parent = plan.prog.region_parents[rid]
            ps = plan.slot_map[parent].to(torch.int64)[ent] if parent else ent
            slot = torch.from_numpy(np.array(
                [_i32(int(v)) for v in ps * p["icap"] + j - off[ent]],
                np.int64))
            if rid in plan.slot_map:
                plan.slot_map[rid][:] = slot.to(torch.int32)
        for kind, src, src2, at, at2, scratch, r, _es in p["jobs"]:
            def take(s, gate=in_range):
                t = plan.srcs[s]
                v = t[slot.clamp(0, t.numel() - 1)].to(torch.int64)
                return torch.where(gate, v, 0)
            if kind == decode.J_COPY32:
                v = take(src).to(torch.int32)
                out.store_field(at, 32, v.numpy().view(np.uint8), n_pos,
                                blocks)
                if scratch:
                    ptr[scratch][:] = v
                reduced = v
            elif kind == decode.J_BITS8:
                out.store_field(at, 1, np.packbits(
                    take(src).numpy() != 0, bitorder="little"), n_pos,
                    blocks)
            elif kind in (decode.J_SL32, decode.J_START_LENC):
                s, ln = take(src), take(src2)
                if kind == decode.J_SL32:
                    v = ((s & 0xFFFFFFFF) | (ln << 21)) & 0xFFFFFFFF
                    out.store_field(at, 32, v.numpy().astype(
                        np.uint32).view(np.uint8), n_pos, blocks)
                else:
                    out.store_field(at, 32, s.numpy().astype(
                        np.int32).view(np.uint8), n_pos, blocks)
                    out.store_field(at2, 16, (ln.numpy() & 0xFFFF).astype(
                        np.uint16).view(np.uint8), n_pos, blocks)
                reduced = ln
            elif kind == decode.J_REDUCE:
                reduced = take(src, torch.ones(n_pos, dtype=torch.bool))
            else:
                reduced = (take(src, torch.ones(n_pos, dtype=torch.bool))
                           & 0xFFFFFFFF & ~varint.ERR_ITEM_OVERFLOW) != 0
            if r < 0:
                continue
            for b in range(blocks):
                tile = reduced[b * TILE:(b + 1) * TILE]
                m = max(int(tile.max()), 0) if tile.numel() else 0
                if m > 0:
                    red[r] = max(red[r], m)
    wide = 0
    for kind, at, a, b, c in plan.entries.tolist():
        if kind == decode.E_MAX:
            out.put(at, np.array([red[a]], np.int32))
        elif kind == decode.E_SUM:
            total = int(ptr[a][b])
            wide |= total >= (1 << 31)
            out.put(at, np.array([_i32(total)], np.int32))
        elif kind == decode.E_ERR:
            out.put(at, np.uint8(red[a] != 0))
        elif kind == decode.E_STRFIT:
            out.put(at, np.uint8(all(red[a + k] < c for k in range(b))))
    status = np.zeros(decode.STATUS_BYTES, np.uint8)
    status[0] = wide
    out.put(plan.nbytes, status)
    if log is not None:
        log.update(blob=out)
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
        plan = decode.FinalizePlan(kb, ke, prog, R, B, item_caps, tot_caps,
                                   compact)
        plan.blob.fill_(0xA5)  # every byte must be written
        log = {}
        assert torch.equal(model_finalize(plan, log), want), (name, item_caps)
        assert (log["blob"].writes == 1).all(), (name, item_caps)


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
        else:
            assert spans[-1][1] - spans[-1][0] == \
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
    ("decode_finalize.cu", {"decode_finalize_pass",
                            "decode_finalize_epilogue"}),
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
    for prefix in ("J", "E"):
        enum = re.search(r"enum \{ (%s_\w+(?:, %s_\w+)*) \}" % (prefix, prefix),
                         fin).group(1).split(", ")
        for value, name in enumerate(enum):
            assert getattr(decode, name) == value, name
    assert "#define ERR_ITEM_OVERFLOW 128u" in fin
    assert re.search(r"kStatusBytes = (\d+)", fin).group(1) == \
        str(decode.STATUS_BYTES)
    threads = int(re.search(r"kThreads = (\d+);", fin).group(1))
    per_thread = int(re.search(r"kPerThread = (\d+);", fin).group(1))
    assert "kTile = kThreads * kPerThread;" in fin
    assert threads * per_thread == TILE
    # the grid that pass_grid models
    assert "offsets ? (long long)max(n_pos, n_entries + 1) : " \
        "(long long)n_pos;" in fin
    assert "const long long blocks = (work + kTile - 1) / kTile;" in fin


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
            "for (long long k = a + 16 * tid; k < b; k += 16 * kThreads) {",
            "*reinterpret_cast<uint4*>(d + k) = "
            "*reinterpret_cast<const uint4*>(s + k);"):
        assert line in body, line
    assert "return (int)(reinterpret_cast<uintptr_t>(g0) & 15u);" in \
        FINALIZE_CU
    for addr in range(32):
        for n in (0, 1, 15, 16, 17, 40):
            a = min((16 - addr % 16) & 15, n)
            b = a + ((n - a) & ~15)
            assert span_pieces(addr, n) == \
                [(k, 1) for k in range(a)] + \
                [(k, 16) for k in range(a, b, 16)] + \
                [(k, 1) for k in range(b, n)]
