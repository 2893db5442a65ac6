"""The pipeline engine: ``DeviceDecoder`` (port of ``pyruhvro_tpu/ops/decode.py:285-1003``).

The reference's default decode engine runs, per batch: pack the records
into one launch buffer ``[words | starts | lengths | n]`` → one fused
program (the **walk** of the lowered field program over all lanes, then
the **finalize**: per-region ``#offsets``, strided-to-dense compaction
of item slots, the reductions that drive the capacity ladder, blob
shrinking) → ONE uint8 blob → one device-to-host copy → split, expand,
Arrow assembly. This module keeps that pipeline and its capacity ladder
(item caps and per-``R`` item totals grown from ``#red:max``/``#red:sum``
up to 2^20 items per record, string descriptors widened after
``#red:strfit``), as two kernels and their plain versions:

* K1 ``decode_walk`` (``csrc/decode_walk.cu``) ≙ ``_trace_walk``
  (``decode.py:373-400``); plain version :func:`walk_plain`;
* K2 ``decode_finalize`` (``csrc/decode_finalize.cu``) ≙
  ``build_pipeline.pipeline`` (``decode.py:456-542``); plain version
  :func:`finalize_plain`, the same steps in PyTorch (the reference's
  scatter-max + cummax ``row_of``; the kernel binary-searches);
* K2b, the error lanes (``_err_fn``, ``decode.py:647-666``): K1's
  ``#err`` stays on the device at the same caps and is copied back only
  when ``#red:err`` is set.

:func:`walk` and :func:`finalize` launch the kernel for CUDA tensors and
take the plain version only for CPU tensors; nothing falls back.

Semantics kept bit for bit (the CPU tests hold the plain versions'
blob against the reference's ``build_pipeline`` byte for byte):

* cursors are absolute in the flat word buffer; a read past a record's
  end sees the next record's bytes and a word index past ``B`` clips to
  the last word (:class:`.varint.FlatWords`);
* every repeated loop is bounded by ONE value over all lanes in its
  mask: ``max(ends - cursor, 0 for lanes outside the mask) + icap + 2``
  in wrapping int32, taken anew at every entry of a nested loop (once
  per iteration of the enclosing loops);
* item slot ``parent_slot * icap + cnt`` in wrapping int32, ``_BIG``
  past the cap; a write lands where ``jnp``'s scatter with
  ``mode="drop"`` puts it (negative slots count from the end, slots out
  of range drop, the last of equal slots wins). The children of a
  dropped item (slot ``_BIG``) wrap into the first record's slots; only
  rungs with ERR_ITEM_OVERFLOW lanes ever do that, and the ladder
  retries them.

The host path is the reference's (``decode.py:61-97, 177-203, 336-369,
790-819, 965-1192``): the records joined by the native ``concat`` on the
card (:func:`..runtime.pack.concat_records`), packed into a persistent
per-(R, B, slot, thread) arena (pinned host memory beside a device
buffer of the same shape, copied on a copy stream), the capacity
planner consulted before the first rung and taught after the last
(:mod:`..runtime.capacity`), and, for a batch of ``overlap_chunks(n) >
1`` chunks, the overlapped chunk path
(:meth:`DeviceDecoder.decode_to_columns_overlapped`): chunk ``i + 1``
packs and copies while chunk ``i``'s finalize and blob copy are in
flight, row errors of every chunk are raised once. After a planner miss
the item caps are seeded from the host oracle's decode of the first 128
records (:meth:`DeviceDecoder.seed_caps_from_sample`), as in the
reference; a deadline (:mod:`..runtime.deadline`) is checked at each
ladder rung and each chunk. Out of this slice: persisting the planner's
plans.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..errors import BatchTooLarge, DeviceCapacityExceeded, MalformedAvro
from ..runtime import capacity, deadline, knobs
from ..runtime.chunking import chunk_bounds
from ..runtime.pack import (
    LAUNCH_MAX_BYTES,
    bucket_len,
    concat_records,
    launch_lanes,
    launch_shape,
    pack_launch_into,
    record_lengths,
)
from .fieldprog import ROWS, Program, lower
from .varint import (
    ERR_ITEM_OVERFLOW,
    ERR_NAMES,
    ERR_OVERRUN,
    ERR_SLUGS,
    U32,
    FlatWords,
    read_varint32,
    wrap_i32,
    zigzag_decode_pair,
)
from .walk_decode import _check, _PlainWalk, resolve_device

__all__ = ["DeviceDecoder", "walk", "walk_plain", "walk_kernel",
           "finalize", "finalize_plain", "finalize_kernel", "split_blob",
           "blob_layout", "cap_of", "STATUS_BYTES", "overlap_chunks",
           "raise_aggregated_malformed"]

_BIG = 1 << 30              # slot past the cap: dropped (``fieldprog.py:72``)
_DEFAULT_ITEM_CAP = 8
_DEFAULT_TOT_CAP = 8
_MAX_ITEM_CAP = 1 << 20     # per-record item slots (``decode.py:235``)
_MAX_RUNGS = 24             # ladder rungs before "did not converge"
_SLOT_LIMIT = 1 << 30       # a region's strided slots: _BIG must drop
_WALK_BYTES = 1 << 34       # the walk's strided buffers of one launch
_MIN_LANES = 8              # a launch's fewest lanes (launch_shape)
STATUS_BYTES = 8            # after the blob: byte 0 = an #offsets total >= 2^31


def overlap_chunks(n_rows: int) -> int:
    """How many chunks the overlapped path decodes a batch of ``n_rows``
    in (1: the single launch); copy of ``decode.py:86-97``.
    ``PYRUHVRO_TPU_OVERLAP=0`` disables it; ``PYRUHVRO_TPU_OVERLAP_ROWS``
    (default 4096) is the fewest rows of a chunk; at most 8 chunks."""
    if not knobs.get_bool("PYRUHVRO_TPU_OVERLAP"):
        return 1
    min_rows = max(1, knobs.get_int("PYRUHVRO_TPU_OVERLAP_ROWS"))
    return max(1, min(8, n_rows // min_rows))


def raise_aggregated_malformed(indices) -> None:
    """Raise ONE :class:`MalformedAvro` for the bad rows of several chunks
    (copy of ``decode.py:61-73``): the message names the first bad global
    row, ``indices`` carries every ``(global index, slug)`` pair."""
    indices = sorted(indices)
    i0, slug0 = indices[0]
    bit0 = {v: k for k, v in ERR_SLUGS.items()}.get(slug0, 0)
    raise MalformedAvro(f"record {i0}: {ERR_NAMES.get(bit0, slug0)}",
                        index=i0, err_name=slug0, tier="device",
                        indices=indices)


def _region_counts(ir, batch, path: str):
    """Per-row item counts of the repeated field at ``path`` in an Arrow
    batch (host-side, for cap seeding; copy of ``decode.py:113-145``).
    Path components are record field names or union-arm indices;
    nullable pairs are transparent (Arrow folds them into field
    nullability)."""
    from ..schema.model import Array as _Arr, Map as _Map, Record, Union

    t = ir
    arr = None
    for comp in path.split("/"):
        while isinstance(t, Union) and t.is_nullable_pair:
            t = t.non_null_variant
        if isinstance(t, Record):
            names = [f.name for f in t.fields]
            i = names.index(comp)
            arr = batch.column(comp) if arr is None else arr.field(i)
            t = t.fields[i].type
        elif isinstance(t, Union):
            k = int(comp)
            arr = arr.field(k)
            t = t.variants[k]
        else:
            return None
    while isinstance(t, Union) and t.is_nullable_pair:
        t = t.non_null_variant
    if arr is None or not isinstance(t, (_Arr, _Map)):
        return None
    counts = np.diff(np.asarray(arr.offsets))
    if arr.null_count:
        counts = np.where(
            arr.is_valid().to_numpy(zero_copy_only=False), counts, 0
        )
    return counts


def cap_of(prog: Program, R: int, item_caps, region: int) -> int:
    """Strided slots of ``region``: ``R`` times the item caps down its
    ancestry (``decode.py:379-385``)."""
    cap = R
    while region != ROWS:
        cap *= item_caps[region]
        region = prog.region_parents[region]
    return cap


def check_slots(prog: Program, R: int, item_caps) -> None:
    """Refuse, before any launch, a rung whose slot arithmetic would leave
    int32 or whose strided buffers the card cannot hold: every region's
    slots at most 2^30 (so that ``_BIG`` drops, never wraps), the walk's
    buffers at most ``_WALK_BYTES``. ``BatchTooLarge`` while fewer lanes
    would help (the codec halves the batch), else
    ``DeviceCapacityExceeded``."""
    slots = max((cap_of(prog, R, item_caps, rid)
                 for rid in range(1, len(prog.regions))), default=0)
    nbytes = sum(cap_of(prog, R, item_caps, s.region) * s.dtype.itemsize
                 for s in prog.buffers.values())
    if slots <= _SLOT_LIMIT and nbytes <= _WALK_BYTES:
        return
    if R > _MIN_LANES:
        raise BatchTooLarge(R, nbytes)
    raise DeviceCapacityExceeded(
        f"item caps {tuple(item_caps[1:])} need {slots} slots and {nbytes} "
        f"bytes of walk buffers for {R} lanes (limits {_SLOT_LIMIT} slots, "
        f"{_WALK_BYTES} bytes)")


def _dtype(prog: Program, key: str) -> torch.dtype:
    return torch.uint8 if prog.buffers[key].dtype.itemsize == 1 \
        else torch.int32


def alloc_walk_outputs(prog: Program, R: int, item_caps, device,
                       fill=torch.zeros) -> List[torch.Tensor]:
    """The walk's buffers in ``out_keys`` order at their strided sizes:
    uint8 for u8 buffers, int32 (bit pattern) for every 4-byte one."""
    return [fill(cap_of(prog, R, item_caps, prog.buffers[k].region),
                 dtype=_dtype(prog, k), device=device)
            for k in prog.out_keys]


# -- the plain walk (≙ _trace_walk) -------------------------------------------


class _PipelineWalk(_PlainWalk):
    """The field-program code executed with lane masks over all ``R``
    lanes in lockstep, as the reference's emitters run: the row-padded
    engine's interpreter (:class:`.walk_decode._PlainWalk`) on the flat
    reader, with nested loops. A ``slot`` is None (the row region) or
    ``(item slots, wrapped)``, where ``wrapped`` marks lanes whose slot
    derives from a dropped item."""

    def __init__(self, words, starts, lengths, n: int, prog: Program,
                 item_caps):
        R = starts.numel()
        dev = starts.device
        self.words = FlatWords(words)
        self.code = prog.code.tolist()
        self.caps = item_caps
        self.lanes = torch.arange(R, dtype=torch.int64, device=dev)
        st = starts.to(torch.int64)
        self.cursor = st.clone()
        self.ends = wrap_i32(st + lengths.to(torch.int64))
        self.active = self.lanes < n
        self.err = torch.zeros(R, dtype=torch.int64, device=dev)
        self.bufs = alloc_walk_outputs(prog, R, item_caps, dev)

    def put(self, b: int, slot, val, mask) -> None:
        """Masked write: lane-aligned for the row region, else a scatter
        with ``jnp``'s ``mode="drop"`` rules. Wrapped lanes may share a
        slot; the last lane wins, after every other lane's write."""
        buf = self.bufs[b]
        if buf.dtype == torch.uint8:
            val = (val & 0xFF).to(torch.uint8)
        else:
            val = wrap_i32(val).to(torch.int32)
        if slot is None:
            self.bufs[b] = torch.where(mask, val, buf)
            return
        slot, wrapped = slot
        size = buf.numel()
        idx = torch.where(slot < 0, slot + size, slot)
        ok = mask & (idx >= 0) & (idx < size)
        own = ok & ~wrapped
        buf.index_put_((idx[own],), val[own])
        shared = ok & wrapped
        if bool(shared.any()):
            idx, val = idx[shared], val[shared]
            order = torch.sort(idx, stable=True).indices
            s = idx[order]
            last = torch.ones_like(s, dtype=torch.bool)
            last[:-1] = s[1:] != s[:-1]
            pick = order[last]
            buf.index_put_((idx[pick],), val[pick])

    def rebase(self, b: int, mask) -> None:
        pass  # cursors are absolute here: nothing to rebase

    def repeated(self, pc: int, mask, slot) -> None:
        """The array/map block loop (``fieldprog.py:419-498``): one item
        per live lane per iteration, bounded by one value over all lanes."""
        code = self.code
        count_buf, rid, stop = code[pc + 1], code[pc + 2], code[pc + 3]
        icap = self.caps[rid]
        if slot is None:
            base, base_wrapped = self.lanes, torch.zeros_like(mask)
        else:
            base, wrapped = slot
            base_wrapped = wrapped | (base == _BIG)
        span = torch.where(mask, wrap_i32(self.ends - self.cursor), 0)
        bound = int(wrap_i32(span.max() + icap + 2))
        zero = torch.zeros_like(self.cursor)
        rem, cnt, done = zero, zero, ~mask
        it = 0
        while it < bound and bool((~done).any()):
            # 1) lanes needing a block header
            need = ~done & (rem == 0)
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
            over = ~done & (self.cursor > self.ends)
            self.err_where(over, ERR_OVERRUN)
            done = done | over
            # 2) one item per lane with items pending; lanes past the cap
            # still decode (into dropped slots) so the cursor stays exact
            can = ~done & (rem > 0)
            self.err_where(can & (cnt >= icap), ERR_ITEM_OVERFLOW)
            item = torch.where(cnt < icap, wrap_i32(base * icap + cnt), _BIG)
            self.run(pc + 4, stop - 2, can, (item, base_wrapped))
            rem = rem - can.to(torch.int64)
            cnt = cnt + can.to(torch.int64)
            it += 1
        # ran out of iterations with lanes still open → malformed
        self.err_where(~done, ERR_OVERRUN)
        self.put(count_buf, slot, cnt, mask)


def walk_plain(words, starts, lengths, n: int, prog: Program, item_caps):
    """K1's plain version, on any device: ``words`` the launch's ``B``
    bytes (any 4-byte dtype or uint8), ``starts``/``lengths`` ``[R]``
    int32, ``n`` active lanes. Returns ``(buffers in out_keys order at
    their strided sizes, #err [R] int32)``."""
    check_slots(prog, starts.numel(), item_caps)
    w = _PipelineWalk(words, starts, lengths, n, prog, item_caps)
    w.run(0, len(w.code), w.active, None)
    return w.bufs, wrap_i32(w.err).to(torch.int32)


# -- the blob (≙ build_pipeline's layout) ---------------------------------------


def _item_buffers(prog: Program) -> Dict[int, List[str]]:
    return {rid: sorted(k for k, s in prog.buffers.items() if s.region == rid)
            for rid in range(1, len(prog.regions))}


def _str_mode(prog: Program, B: int, compact: bool):
    if compact and prog.string_cols:
        return "sl32" if B <= (1 << 20) else "len16"
    return None


def _is_row_payload(prog: Program, key: str) -> bool:
    return (prog.buffers[key].region == ROWS
            and key.rpartition("#")[2] != "count")


def blob_layout(prog: Program, R: int, B: int, item_caps, tot_caps,
                compact: bool = True):
    """``[(key, numpy dtype, length), ...]`` of the blob in its byte order
    (copy of ``decode.py:544-576``)."""
    str_mode = _str_mode(prog, B, compact)
    items = _item_buffers(prog)
    sizes: Dict[str, tuple] = {}
    for rid in range(1, len(prog.regions)):
        path = prog.regions[rid]
        parent = prog.region_parents[rid]
        n_entries = R if parent == ROWS else tot_caps[parent]
        sizes[path + "#offsets"] = (np.int32, n_entries + 1)
        for key in items[rid]:
            sizes[key] = (prog.buffers[key].dtype, tot_caps[rid])
        sizes["#red:max:" + path] = (np.int32, 1)
        sizes["#red:sum:" + path] = (np.int32, 1)
    for key in prog.out_keys:
        if _is_row_payload(prog, key):
            sizes[key] = (prog.buffers[key].dtype, R)
    sizes["#red:err"] = (np.uint8, 1)
    if str_mode is not None:
        sizes["#red:strfit"] = (np.uint8, 1)
        for sc in prog.string_cols:
            _dt, ln_s = sizes.pop(sc.path + "#start")
            sizes.pop(sc.path + "#len")
            if str_mode == "sl32":
                sizes[sc.path + "#sl"] = (np.uint32, ln_s)
            else:
                sizes[sc.path + "#start"] = (np.int32, ln_s)
                sizes[sc.path + "#lenc"] = (np.uint16, ln_s)
    for k in list(sizes):
        dt, ln = sizes[k]
        if not k.startswith("#red:") and np.dtype(dt) == np.uint8:
            del sizes[k]
            sizes[k + "@bits"] = (np.uint8, ln // 8)
    return [(k, np.dtype(sizes[k][0]), sizes[k][1]) for k in sorted(sizes)]


def layout_offsets(layout) -> Tuple[Dict[str, int], int]:
    """Byte offset of every key in the blob, and the blob's bytes."""
    at, pos = {}, 0
    for key, dt, ln in layout:
        at[key] = pos
        pos += dt.itemsize * ln
    return at, pos


def split_blob(blob: np.ndarray, layout) -> Dict[str, np.ndarray]:
    """Split one transferred uint8 blob into named host views by the
    static layout (copy of ``decode.py:100-110``)."""
    host: Dict[str, np.ndarray] = {}
    pos = 0
    for key, dt, ln in layout:
        nbytes = np.dtype(dt).itemsize * ln
        host[key] = blob[pos:pos + nbytes].view(dt)
        pos += nbytes
    if pos != blob.nbytes:
        raise RuntimeError("pipeline layout mismatch")
    return host


def expand_host(host: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Undo the blob shrinking on the host dict (copy of
    ``decode.py:578-595``)."""
    for k in list(host):
        if k.endswith("@bits"):
            host[k[:-5]] = np.unpackbits(host[k], bitorder="little")
        elif k.endswith("#sl"):
            v = host[k]
            p = k[:-len("#sl")]
            host[p + "#start"] = (v & np.uint32((1 << 21) - 1)).astype(
                np.int32)
            host[p + "#len"] = (v >> np.uint32(21)).astype(np.int32)
        elif k.endswith("#lenc"):
            host[k[:-len("#lenc")] + "#len"] = host[k].astype(np.int32)
    return host


# -- the plain finalize (≙ build_pipeline.pipeline) ---------------------------


def _take_clip(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return src[torch.clamp(idx, 0, src.numel() - 1)]


def _row_of(offsets: torch.Tensor, n_entries: int, cap: int) -> torch.Tensor:
    """The reference's ``row_of``: for each position j < cap, the entry
    whose range holds it, by one scatter-max and one cummax."""
    dev = offsets.device
    idx = offsets[:n_entries].to(torch.int64)
    idx = torch.where(idx < 0, idx + cap, idx)
    keep = (idx >= 0) & (idx < cap)
    m = torch.zeros(cap, dtype=torch.int64, device=dev)
    m.scatter_reduce_(0, idx[keep],
                      torch.arange(n_entries, device=dev)[keep], "amax")
    return torch.cummax(m, 0).values


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _packbits(x: torch.Tensor) -> torch.Tensor:
    bits = (x != 0).reshape(-1, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=x.device)
    return (bits * weights).sum(1).to(torch.uint8)


def finalize_plain(bufs, err, prog: Program, R: int, B: int, item_caps,
                   tot_caps, compact: bool = True) -> torch.Tensor:
    """K2's plain version, on any device: the walk's buffers and ``#err``
    → the blob (uint8, ``blob_layout``'s bytes) followed by
    ``STATUS_BYTES`` status bytes."""
    dev = err.device
    key_of = {k: i for i, k in enumerate(prog.out_keys)}
    items = _item_buffers(prog)
    str_mode = _str_mode(prog, B, compact)
    out: Dict[str, torch.Tensor] = {}
    slot_maps = {}
    wide = False
    for rid in range(1, len(prog.regions)):
        path = prog.regions[rid]
        parent = prog.region_parents[rid]
        icap, tcap = item_caps[rid], tot_caps[rid]
        counts_raw = bufs[key_of[path + "#count"]]
        if parent == ROWS:
            n_entries = R
            counts_c = counts_raw.to(torch.int64)
            parent_slot = torch.arange(R, dtype=torch.int64, device=dev)
        else:
            parent_slot, parent_in = slot_maps[parent]
            n_entries = tot_caps[parent]
            counts_c = torch.where(parent_in, _take_clip(counts_raw,
                                                         parent_slot), 0)
            counts_c = counts_c.to(torch.int64)
        total = counts_c.sum()
        wide = wide or bool(total >= (1 << 31))
        offsets = wrap_i32(torch.cat([
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.cumsum(counts_c, 0)]))
        out[path + "#offsets"] = offsets.to(torch.int32)
        j = torch.arange(tcap, dtype=torch.int64, device=dev)
        ent = _row_of(offsets, n_entries, tcap)
        slot = wrap_i32(_take_clip(parent_slot, ent) * icap
                        + (j - _take_clip(offsets, ent)))
        in_range = j < offsets[-1]
        slot_maps[rid] = (slot, in_range)
        for key in items[rid]:
            taken = _take_clip(bufs[key_of[key]], slot)
            out[key] = torch.where(in_range, taken, torch.zeros_like(taken))
        out["#red:max:" + path] = counts_c.max().reshape(1).to(torch.int32)
        out["#red:sum:" + path] = offsets[-1:].to(torch.int32)
    for key in prog.out_keys:
        if _is_row_payload(prog, key):
            out[key] = bufs[key_of[key]]
    out["#red:err"] = ((err.to(torch.int64) & ~ERR_ITEM_OVERFLOW & U32) != 0
                       ).any().reshape(1).to(torch.uint8)
    if str_mode is not None:
        limit = (1 << 11) if str_mode == "sl32" else (1 << 16)
        fit = True
        for sc in prog.string_cols:
            fit = fit and bool(out[sc.path + "#len"].max() < limit)
        out["#red:strfit"] = torch.tensor([int(fit)], dtype=torch.uint8,
                                          device=dev)
        for sc in prog.string_cols:
            s = out.pop(sc.path + "#start").to(torch.int64)
            ln = out.pop(sc.path + "#len").to(torch.int64)
            if str_mode == "sl32":
                out[sc.path + "#sl"] = wrap_i32(
                    ((s & U32) | ((ln & U32) << 21)) & U32).to(torch.int32)
            else:
                out[sc.path + "#start"] = s.to(torch.int32)
                out[sc.path + "#lenc"] = (((ln & 0xFFFF) + (1 << 15))
                                          % (1 << 16) - (1 << 15)
                                          ).to(torch.int16)
    for k in list(out):
        if not k.startswith("#red:") and out[k].dtype == torch.uint8:
            out[k + "@bits"] = _packbits(out.pop(k))
    status = torch.zeros(STATUS_BYTES, dtype=torch.uint8, device=dev)
    status[0] = int(wide)
    return torch.cat([_bytes_of(out[k]) for k in sorted(out)] + [status])


# -- K1: the walk kernel ----------------------------------------------------------

_LOG_WORDS = 4              # b, slot, value, lane; then one counter per level
_KEY_LIMIT = 1 << 24        # loop-bound table entries (16 B each)
WALK_THREADS = 128          # lanes of a kernel block (csrc/decode_walk.cu)
WALK_STACKS = (1, 2, 8)     # the kernel's loop-stack instantiations
WALK_KEY_FOLD = 64          # keys a block folds in shared memory (kKeyTab)
_WALK_IN_MAX = 32 << 10     # shared memory for one block's record span
# launches before ``run`` gives up: settling widens the key table about
# once per nesting level, then relaunches once with the recorded bounds,
# and grows the log in one step; no fixture needs more than a handful
_MAX_WALK_LAUNCHES = 64


def walk_stack(depth: int) -> int:
    """The kernel's smallest loop stack that holds ``depth`` open loops."""
    for s in WALK_STACKS:
        if s >= max(depth, 1):
            return s
    raise DeviceCapacityExceeded(
        f"arrays/maps nested {depth} deep (kernel limit {WALK_STACKS[-1]})")


def walk_input_staging(starts, lengths, n: int, n_bytes: int,
                       in_budget: int):
    """The kernel's input staging, block by block (``decode_walk_kernel``
    step 1), as numpy arrays over the blocks of ``WALK_THREADS`` lanes:
    ``(a, span, staged, covers)``. The block's active records (lanes below
    ``n``) are one span of the words, ``starts[first]`` to the last active
    lane's end, widened to 16-B bounds: ``[a, a + span)``. ``staged``: the
    block copies it into shared memory (it covers bytes, lies inside the
    ``n_bytes`` of words and fits ``in_budget``); ``covers``: it covers
    any byte (a block that does and is not staged reads device memory)."""
    st = starts.cpu().numpy().astype(np.int64)
    ln = lengths.cpu().numpy().astype(np.int64)
    first = np.arange(0, st.size, WALK_THREADS)
    last = np.minimum(np.minimum(first + WALK_THREADS, st.size), n) - 1
    active = last >= first
    last = np.where(active, last, first)
    lo, hi = st[first], st[last] + ln[last]
    a = lo & ~15
    span = ((hi + 15) & ~15) - a
    covers = active & (hi > lo)
    staged = covers & (lo >= 0) & (a + span <= n_bytes) & (span <= in_budget)
    return a, np.where(covers, span, 0), staged, covers


def _largest_fitting(fits, cap: int) -> int:
    """The largest multiple of 16 up to ``cap`` where ``fits`` holds
    (``fits`` holds at 0 and turns false once, as sizes grow)."""
    lo, hi = 0, cap // 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(16 * mid):
            lo = mid
        else:
            hi = mid - 1
    return 16 * lo


def walk_budget(per_sm, in_max) -> int:
    """The record span a block of a launch may stage, in bytes. ``in_max``
    given is taken as it is (to 16 B); left None, it is the most (16-B
    steps, at most ``_WALK_IN_MAX``) at which ``per_sm(in_bytes)``, the
    blocks that fit one SM, is as large as with no staging, or
    ``_WALK_IN_MAX`` without ``per_sm`` (no card to ask)."""
    if in_max is not None:
        return in_max // 16 * 16
    if per_sm is None:
        return _WALK_IN_MAX
    want = per_sm(0)
    return _largest_fitting(lambda x: per_sm(x) >= want, _WALK_IN_MAX)


class WalkLaunch:
    """The device tensors of one ``decode_walk`` call and its loop-bound
    tables (see ``csrc/decode_walk.cu``): per region, the extent ``ext``
    of its iteration counter in its descendants' keys and the first
    entry ``key_off`` of its own keys; per key, the bound to use
    (``spec``, where ``has_spec``) and what a launch records (``status``:
    span max, lanes, own-bound cuts; per region the largest counter seen
    off the table and cuts there; the wrapped-write log's length; the
    blocks the kernel staged and those that read device memory). Every
    table the kernel reads goes to the device as one packed tensor
    (``table``), with the status a launch starts from (``status0``).

    ``in_budget`` is the record span a block may stage in shared memory
    (:func:`walk_input_staging`; a block over it reads device memory):
    ``in_max`` when given, else the most that costs no resident block
    (:func:`walk_budget` with the kernel's occupancy query; on the CPU,
    which has none, without it). ``_stack`` (the loop-stack instantiation;
    by default the smallest that holds the schema's depth) and ``_fold``
    (the keys a block folds in shared memory) are there to measure the
    kernel's levers; the decoder leaves them as they are."""

    def __init__(self, words, starts, lengths, n: int, prog: Program,
                 item_caps, log_cap: int = 1 << 12, in_max: int = None, *,
                 _stack: int = None, _fold: int = WALK_KEY_FOLD):
        dev = words.device
        R = starts.numel()
        if words.dtype != torch.int32 or words.dim() != 1 \
                or not words.is_contiguous() or words.data_ptr() % 16:
            raise RuntimeError("words must be contiguous 16-B aligned int32 "
                             "[W]")
        _check(starts, torch.int32, (R,), dev, "starts")
        _check(lengths, torch.int32, (R,), dev, "lengths")
        self.stack = walk_stack(prog.depth) if _stack is None else _stack
        if self.stack not in WALK_STACKS or prog.depth > self.stack:
            raise RuntimeError(f"stack {self.stack} is no instantiation "
                             f"{WALK_STACKS} holding depth {prog.depth}")
        if not 0 <= _fold <= WALK_KEY_FOLD:
            raise RuntimeError(f"fold {_fold} outside 0..{WALK_KEY_FOLD}")
        check_slots(prog, R, item_caps)
        self.words, self.starts, self.lengths, self.n = words, starts, \
            lengths, n
        self.prog, self.caps, self.R = prog, tuple(item_caps), R
        self.n_regions = len(prog.regions)
        self.fold = _fold
        self.in_budget = walk_kernel.budget(prog, self.stack, in_max) \
            if dev.type == "cuda" else walk_budget(None, in_max)
        self.blocks = (0, 0)
        self.esize = [prog.buffers[k].dtype.itemsize for k in prog.out_keys]
        self.bufs = alloc_walk_outputs(prog, R, item_caps, dev,
                                       fill=torch.empty)
        if any(b.data_ptr() % 16 for b in self.bufs):
            raise RuntimeError("walk buffers must be 16-B aligned")
        self.err = torch.empty(R, dtype=torch.int32, device=dev)
        self.ext = [0] * self.n_regions
        self.set_log(log_cap)
        self._tables(keep=None)

    def ancestors(self, region: int) -> List[int]:
        """The repeated fields enclosing ``region``'s loop, outermost first."""
        out = []
        region = self.prog.region_parents[region]
        while region != ROWS:
            out.append(region)
            region = self.prog.region_parents[region]
        return out[::-1]

    def _tables(self, keep) -> None:
        """(Re)build the key tables for the current extents; ``keep`` maps
        row-level regions to the (spec, has_spec) they keep."""
        offs, icap, total = [0] * self.n_regions, [], 0
        for rid in range(1, self.n_regions):
            offs[rid] = total
            n = int(np.prod([self.ext[a] for a in self.ancestors(rid)],
                            dtype=np.int64))
            icap += [self.caps[rid]] * n
            total += n
        if total > _KEY_LIMIT:
            raise DeviceCapacityExceeded(
                f"nested array/map loop bounds need {total} table entries "
                f"(limit {_KEY_LIMIT})")
        self.n_keys = total
        self.key_off = offs
        self.key_icap = np.array(icap, np.int64)
        self.spec = np.zeros(total, np.int32)
        self.has_spec = np.zeros(total, np.int32)
        if keep:
            for rid, (spec, has) in keep.items():
                self.spec[offs[rid]], self.has_spec[offs[rid]] = spec, has
        T, nr = max(total, 1), self.n_regions
        self.status = torch.empty(3 * T + 2 * nr + 3, dtype=torch.int32,
                                  device=self.words.device)
        self.upload()

    def upload(self) -> None:
        """The tables and the status image to the device in one copy:
        ``table`` = buffer pointers and lengths (int64), then code, caps,
        element sizes, ext, key_off, spec and has_spec (int32; in the
        order of ``csrc/decode_walk.cu`` ``tab_offsets``); ``status0`` =
        no span recorded (INT_MIN), no lanes, no cut, counters -1, no log
        entry, no block counted."""
        T, nr = max(self.n_keys, 1), self.n_regions
        head = np.array([b.data_ptr() for b in self.bufs]
                        + [b.numel() for b in self.bufs], np.int64)
        spec, has = np.zeros(T, np.int32), np.zeros(T, np.int32)
        spec[:self.n_keys], has[:self.n_keys] = self.spec, self.has_spec
        status0 = np.zeros(3 * T + 2 * nr + 3, np.int32)
        status0[:T] = -(1 << 31)
        status0[3 * T:3 * T + nr] = -1
        packed = np.concatenate([
            head.view(np.int32), self.prog.code.astype(np.int32),
            np.array(list(self.caps) + self.esize + self.ext + self.key_off,
                     np.int32), spec, has, status0])
        packed = torch.from_numpy(packed).to(self.words.device)
        self.table, self.status0 = packed[:-status0.size], \
            packed[-status0.size:]

    def set_log(self, cap: int) -> None:
        width = _LOG_WORDS + max(self.prog.depth, 1)
        self.log_cap = cap
        self.log = torch.empty(cap * width, dtype=torch.int32,
                               device=self.words.device)

    def reset(self) -> None:
        """The status a launch starts from: one copy of ``status0``."""
        self.status.copy_(self.status0)

    def log_at(self) -> int:
        """Where the status holds the log's length; the two block counts
        follow it."""
        return 3 * max(self.n_keys, 1) + 2 * self.n_regions

    def read_status(self):
        """The launch's status: per key span max, lanes and cuts; per
        region the largest counter off the table and cuts there; the log's
        length; and the blocks ``(staged, reading device memory)``."""
        T, nr, at = max(self.n_keys, 1), self.n_regions, self.log_at()
        s = self.status.cpu().numpy()
        return (s[:T][:self.n_keys], s[T:2 * T][:self.n_keys],
                s[2 * T:3 * T][:self.n_keys], s[3 * T:3 * T + nr],
                s[3 * T + nr:at], int(s[at]),
                (int(s[at + 1]), int(s[at + 2])))

    def input_staging(self):
        """:func:`walk_input_staging` of this launch."""
        return walk_input_staging(self.starts, self.lengths, self.n,
                                  4 * self.words.numel(), self.in_budget)

    def settle(self) -> bool:
        """Check the launch just made: True when every loop ran with the
        bound the reference gives it. Else set up the next launch (a
        larger log, the recorded bounds as the spec, wider tables) and
        return False."""
        rec_max, rec_cnt, cut, it_max, off_cut, log_n, self.blocks = \
            self.read_status()
        if log_n > self.log_cap:
            self.unsettled = f"a log of {log_n} writes past its {self.log_cap}"
            self.set_log(bucket_len(log_n, self.log_cap))
            return False
        present = rec_cnt > 0
        span = np.where(rec_cnt < self.R, np.maximum(rec_max, 0),
                        rec_max).astype(np.int64)
        bound = (((span + self.key_icap + 2 + (1 << 31)) & 0xFFFFFFFF)
                 - (1 << 31)).astype(np.int32)
        has = self.has_spec != 0
        wrong = present & ((has & (self.spec != bound)) | (~has & (cut != 0)))
        if not wrong.any() and not off_cut.any():
            return True
        self.unsettled = (
            f"keys {np.flatnonzero(wrong)[:8].tolist()} ran with bounds "
            f"other than their recorded {bound[wrong][:8].tolist()}, "
            f"regions {np.flatnonzero(off_cut).tolist()} cut off the key "
            f"table (largest counters {it_max.tolist()}, extents {self.ext})")
        self.spec = np.where(present, bound, self.spec).astype(np.int32)
        self.has_spec = (has | present).astype(np.int32)
        if off_cut.any():
            keep = {rid: (self.spec[self.key_off[rid]],
                          self.has_spec[self.key_off[rid]])
                    for rid in range(1, self.n_regions)
                    if self.prog.region_parents[rid] == ROWS}
            for rid in np.flatnonzero(off_cut):
                for a in self.ancestors(int(rid)):
                    self.ext[a] = max(self.ext[a],
                                      bucket_len(int(it_max[a]) + 1, 1))
            self._tables(keep)
        else:
            self.upload()
        return False

    def apply_log(self) -> None:
        """Writes through a dropped item's slot, in the reference's order:
        by buffer and slot, the last event (enclosing counters, outermost
        first) and the last lane win."""
        log_n = int(self.status[self.log_at()])
        if not log_n:
            return
        width = _LOG_WORDS + max(self.prog.depth, 1)
        log = self.log[:log_n * width].view(log_n, width).to(torch.int64)
        perm = torch.arange(log_n, device=log.device)
        for col in [3] + list(range(width - 1, 3, -1)) + [1, 0]:
            perm = perm[torch.sort(log[perm, col], stable=True).indices]
        ent = log[perm]
        last = torch.ones(log_n, dtype=torch.bool, device=log.device)
        last[:-1] = (ent[1:, 0] != ent[:-1, 0]) | (ent[1:, 1] != ent[:-1, 1])
        ent = ent[last]
        for b in torch.unique(ent[:, 0]).tolist():
            rows = ent[ent[:, 0] == b]
            buf = self.bufs[b]
            val = rows[:, 2]
            val = (val & 0xFF).to(torch.uint8) if buf.dtype == torch.uint8 \
                else val.to(torch.int32)
            buf[rows[:, 1]] = val


class _DecodeWalkKernel:
    """Launches ``csrc/decode_walk.cu``. ``launches`` counts kernel
    launches; it grows only in :meth:`launch`."""

    source = "decode_walk.cu"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._budgets = {}  # guarded-by: _lock

    def library(self):
        from ._build import load_kernel_library

        lib = load_kernel_library(self.source)
        cdll = lib.cdll
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if cdll.decode_walk.argtypes is None:
            cdll.decode_walk.argtypes = [
                P, LL, P, P, I, I,      # words n_words starts lengths n R
                P, I, I, I, I, I, I,    # table code_len n_bufs n_regions
                                        # depth stack n_keys
                I, I,                   # in_budget fold
                P, P, I, P, P]          # status log log_cap err stream
            cdll.decode_walk.restype = I
            cdll.decode_walk_smem_bytes.argtypes = [I, I, I, I]
            cdll.decode_walk_smem_bytes.restype = I
            cdll.decode_walk_blocks_per_sm.argtypes = [I, I]
            cdll.decode_walk_blocks_per_sm.restype = I
        return lib

    def smem_bytes(self, prog: Program, in_budget: int) -> int:
        """Dynamic shared memory of one block."""
        return self.library().cdll.decode_walk_smem_bytes(
            len(prog.code), len(prog.out_keys), len(prog.regions),
            in_budget)

    def blocks_per_sm(self, stack: int, smem_bytes: int) -> int:
        """Blocks of the ``stack``-level instantiation that fit one SM at
        ``smem_bytes`` of dynamic shared memory (the CUDA occupancy query)."""
        got = self.library().cdll.decode_walk_blocks_per_sm(stack,
                                                            smem_bytes)
        if got < 0:
            raise RuntimeError(f"decode_walk occupancy query failed: CUDA "
                               f"error {-got}")
        return got

    def budget(self, prog: Program, stack: int, in_max) -> int:
        """:func:`walk_budget` by the occupancy query, once per program
        shape, instantiation and cap given."""
        key = (len(prog.code), len(prog.out_keys), len(prog.regions), stack,
               in_max)
        with self._lock:
            got = self._budgets.get(key)
        if got is None:
            got = walk_budget(lambda x: self.blocks_per_sm(
                stack, self.smem_bytes(prog, x)), in_max)
            with self._lock:
                self._budgets[key] = got
        return got

    def launch(self, L: WalkLaunch) -> None:
        """One launch on the current stream; no synchronisation."""
        if L.words.device.type != "cuda":
            raise RuntimeError("walk_kernel takes CUDA tensors")
        fn = self.library().cdll.decode_walk
        stream = torch.cuda.current_stream(L.words.device).cuda_stream
        L.reset()
        rc = fn(L.words.data_ptr(), L.words.numel(), L.starts.data_ptr(),
                L.lengths.data_ptr(), L.n, L.R, L.table.data_ptr(),
                len(L.prog.code), len(L.bufs), L.n_regions, L.prog.depth,
                L.stack, L.n_keys, L.in_budget, L.fold,
                L.status.data_ptr(), L.log.data_ptr(), L.log_cap,
                L.err.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"decode_walk launch failed: CUDA error {rc}")
        with self._lock:
            self.launches += 1

    def __call__(self, words, starts, lengths, n: int, prog: Program,
                 item_caps):
        return self.run(WalkLaunch(words, starts, lengths, n, prog,
                                   item_caps))

    def run(self, L: WalkLaunch):
        """``(buffers, #err)``: launch, and relaunch until every loop ran
        with the reference's bound (``WalkLaunch.settle``)."""
        for _ in range(_MAX_WALK_LAUNCHES):
            self.launch(L)
            if L.settle():
                L.apply_log()
                return L.bufs, L.err
        raise RuntimeError(f"decode_walk: loop bounds did not settle in "
                           f"{_MAX_WALK_LAUNCHES} launches; the last one "
                           f"recorded {L.unsettled}")


walk_kernel = _DecodeWalkKernel()


def walk(words, starts, lengths, n: int, prog: Program, item_caps):
    """K1 for the tensors' device: the kernel for CUDA tensors, the plain
    walk for CPU tensors."""
    if words.device.type == "cuda":
        return walk_kernel(words, starts, lengths, n, prog, item_caps)
    if words.device.type == "cpu":
        return walk_plain(words, starts, lengths, n, prog, item_caps)
    raise RuntimeError(f"no walk for device {words.device}")


# -- K2: the finalize kernel --------------------------------------------------------

# job kinds of one gather pass (csrc/decode_finalize.cu)
J_COPY32, J_BITS8, J_SL32, J_START_LENC, J_REDUCE, J_ERRFLAG = range(6)
# entries of the reduction epilogue
E_MAX, E_SUM, E_ERR, E_STRFIT, E_STATUS = range(5)
_JOB_WORDS = 8
_ENTRY_WORDS = 5


class FinalizePlan:
    """What ``decode_finalize`` does for one (R, B, caps, tot_caps,
    compact) rung, on the device: one gather pass over the row region,
    one per item region (parents first, each preceded by ``torch.cumsum``
    of its counts into its ``#offsets``), then the reduction epilogue.
    Every blob byte is written by exactly one of them."""

    def __init__(self, bufs, err, prog: Program, R: int, B: int, item_caps,
                 tot_caps, compact: bool = True):
        dev = err.device
        key_of = {k: i for i, k in enumerate(prog.out_keys)}
        for k, b in zip(prog.out_keys, bufs):
            want = cap_of(prog, R, item_caps, prog.buffers[k].region)
            _check(b, _dtype(prog, k), (want,), dev, k)
        _check(err, torch.int32, (R,), dev, "#err")
        self.prog, self.R, self.dev = prog, R, dev
        self.layout = blob_layout(prog, R, B, item_caps, tot_caps, compact)
        at, self.nbytes = layout_offsets(self.layout)
        str_mode = _str_mode(prog, B, compact)
        nr = len(prog.regions)
        self.blob = torch.empty(self.nbytes + STATUS_BYTES,
                                dtype=torch.uint8, device=dev)
        strings = {sc.path for sc in prog.string_cols}
        # reduction slots: red:max per region, then #red:err, then one
        # per string column (its largest length)
        self.red = torch.zeros(nr + 1 + len(strings), dtype=torch.int32,
                               device=dev)
        red_err = nr
        red_str = {p: nr + 1 + i for i, p in enumerate(sorted(strings))}
        self.srcs = list(bufs) + [err]
        covered = set()

        def jobs_for(keys, scratch=None):
            jobs = []
            for key in keys:
                path, _, leaf = key.rpartition("#")
                if leaf == "len" and path in strings:
                    continue
                src = key_of[key]
                if leaf == "start" and path in strings:
                    ln = key_of[path + "#len"]
                    if str_mode == "sl32":
                        jobs.append([J_SL32, src, ln, at[path + "#sl"], 0,
                                     0, red_str[path], 4])
                        covered.add(path + "#sl")
                    elif str_mode == "len16":
                        jobs.append([J_START_LENC, src, ln, at[key],
                                     at[path + "#lenc"], 0, red_str[path], 4])
                        covered.update((key, path + "#lenc"))
                    else:
                        jobs.append([J_COPY32, src, -1, at[key], 0, 0, -1, 4])
                        jobs.append([J_COPY32, ln, -1, at[path + "#len"], 0,
                                     0, -1, 4])
                        covered.update((key, path + "#len"))
                elif prog.buffers[key].dtype.itemsize == 1:
                    jobs.append([J_BITS8, src, -1, at[key + "@bits"], 0, 0,
                                 -1, 1])
                    covered.add(key + "@bits")
                else:
                    sc, red = (scratch or {}).get(key, (None, -1))
                    jobs.append([J_COPY32, src, -1, at[key], 0,
                                 0 if sc is None else sc.data_ptr(), red, 4])
                    covered.add(key)
            return jobs

        # the row pass: row payload, row-level counts' max, the error flag
        row_jobs = jobs_for([k for k in prog.out_keys
                             if _is_row_payload(prog, k)])
        for rid in range(1, nr):
            if prog.region_parents[rid] == ROWS:
                row_jobs.append([J_REDUCE, key_of[prog.regions[rid]
                                                  + "#count"], -1, 0, 0, 0,
                                 rid, 4])
        row_jobs.append([J_ERRFLAG, len(bufs), -1, 0, 0, 0, red_err, 4])
        self.passes = [dict(rid=ROWS, n_pos=R, jobs=row_jobs)]
        # one pass per item region; a child's counts are gathered by its
        # parent's pass into an aligned scratch, its slot map likewise
        self.counts_in = {}
        self.slot_map = {}
        self.offsets = {}
        items = _item_buffers(prog)
        for rid in range(1, nr):
            parent = prog.region_parents[rid]
            n_entries = R if parent == ROWS else tot_caps[parent]
            self.offsets[rid] = torch.empty(n_entries + 1, dtype=torch.int64,
                                            device=dev)
            scratch = {}
            for child in range(rid + 1, nr):
                if prog.region_parents[child] == rid:
                    sc = torch.empty(tot_caps[rid], dtype=torch.int32,
                                     device=dev)
                    self.counts_in[child] = sc
                    scratch[prog.regions[child] + "#count"] = (sc, child)
            if any(prog.region_parents[c] == rid for c in range(rid + 1, nr)):
                self.slot_map[rid] = torch.empty(tot_caps[rid],
                                                 dtype=torch.int32, device=dev)
            if parent == ROWS:
                self.counts_in[rid] = bufs[key_of[prog.regions[rid]
                                                  + "#count"]]
            self.passes.append(dict(
                rid=rid, n_pos=tot_caps[rid], n_entries=n_entries,
                icap=item_caps[rid], jobs=jobs_for(items[rid], scratch),
                off_at=at[prog.regions[rid] + "#offsets"]))
            covered.add(prog.regions[rid] + "#offsets")
        # the epilogue: reductions and the status byte
        entries = []
        for rid in range(1, nr):
            path = prog.regions[rid]
            entries.append([E_MAX, at["#red:max:" + path], rid, 0, 0])
            n_entries = self.offsets[rid].numel() - 1
            entries.append([E_SUM, at["#red:sum:" + path],
                            self.offsets[rid].data_ptr(), n_entries, 0])
            covered.update(("#red:max:" + path, "#red:sum:" + path))
        entries.append([E_ERR, at["#red:err"], red_err, 0, 0])
        covered.add("#red:err")
        if str_mode is not None:
            limit = (1 << 11) if str_mode == "sl32" else (1 << 16)
            entries.append([E_STRFIT, at["#red:strfit"], nr + 1,
                            len(strings), limit])
            covered.add("#red:strfit")
        entries.append([E_STATUS, self.nbytes, 0, 0, 0])
        if covered != {k for k, _dt, _ln in self.layout}:
            raise AssertionError("finalize plan does not cover the blob")
        self.entries = torch.tensor(entries, dtype=torch.int64, device=dev)
        for p in self.passes:
            p["jobs_d"] = torch.tensor(p["jobs"] or [[0] * _JOB_WORDS],
                                       dtype=torch.int64, device=dev)
        self.src_ptrs = torch.tensor([s.data_ptr() for s in self.srcs],
                                     dtype=torch.int64, device=dev)
        self.src_lens = torch.tensor([s.numel() for s in self.srcs],
                                     dtype=torch.int64, device=dev)


class _FinalizeKernel:
    """Launches ``csrc/decode_finalize.cu``. ``launches`` counts kernel
    launches (gather passes and epilogues); it grows only in
    :meth:`launch_pass` and :meth:`launch_epilogue`."""

    source = "decode_finalize.cu"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()

    def library(self):
        from ._build import load_kernel_library

        lib = load_kernel_library(self.source)
        fn = lib.cdll.decode_finalize_pass
        if fn.argtypes is None:
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [P, P, I, I, I,      # offsets parent_slot
                                               # n_entries icap n_pos
                           P, P, I,            # slot_out jobs n_jobs
                           P, P,               # src_ptrs src_lens
                           P, LL, P,           # blob offsets_at red
                           P]                  # stream
            fn.restype = ctypes.c_int
            ep = lib.cdll.decode_finalize_epilogue
            ep.argtypes = [P, I, P, P, P]      # entries n blob red stream
            ep.restype = ctypes.c_int
        return lib

    def _count(self) -> None:
        with self._lock:
            self.launches += 1

    @staticmethod
    def prepare_offsets(plan: FinalizePlan, p) -> None:
        """An item pass's int64 offsets: 0, then ``torch.cumsum`` of the
        region's counts (two PyTorch launches, no kernel of this file)."""
        off = plan.offsets[p["rid"]]
        off[0] = 0
        torch.cumsum(plan.counts_in[p["rid"]], 0, dtype=torch.int64,
                     out=off[1:])

    def launch_pass(self, plan: FinalizePlan, p) -> None:
        """One gather pass; an item pass reads the offsets that
        :meth:`prepare_offsets` made."""
        if plan.dev.type != "cuda":
            raise RuntimeError("finalize_kernel takes CUDA tensors")
        fn = self.library().cdll.decode_finalize_pass
        stream = torch.cuda.current_stream(plan.dev).cuda_stream
        rid = p["rid"]
        if rid == ROWS:
            args = (None, None, plan.R, 1, p["n_pos"], None, -1)
        else:
            parent = plan.prog.region_parents[rid]
            off = plan.offsets[rid]
            pslot = None if parent == ROWS else \
                plan.slot_map[parent].data_ptr()
            smap = plan.slot_map.get(rid)
            args = (off.data_ptr(), pslot, p["n_entries"], p["icap"],
                    p["n_pos"], None if smap is None else smap.data_ptr(),
                    p["off_at"])
        off_p, pslot, n_entries, icap, n_pos, smap, off_at = args
        rc = fn(off_p, pslot, n_entries, icap, n_pos, smap,
                p["jobs_d"].data_ptr(), len(p["jobs"]),
                plan.src_ptrs.data_ptr(), plan.src_lens.data_ptr(),
                plan.blob.data_ptr(), off_at, plan.red.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"decode_finalize launch failed: CUDA error "
                               f"{rc}")
        self._count()

    def launch_epilogue(self, plan: FinalizePlan) -> None:
        fn = self.library().cdll.decode_finalize_epilogue
        stream = torch.cuda.current_stream(plan.dev).cuda_stream
        rc = fn(plan.entries.data_ptr(), plan.entries.shape[0],
                plan.blob.data_ptr(), plan.red.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"decode_finalize epilogue failed: CUDA "
                               f"error {rc}")
        self._count()

    def run(self, plan: FinalizePlan) -> torch.Tensor:
        plan.red.zero_()  # the passes fold maxima into it
        for p in plan.passes:
            if p["rid"] != ROWS:
                self.prepare_offsets(plan, p)
            self.launch_pass(plan, p)
        self.launch_epilogue(plan)
        return plan.blob

    def __call__(self, bufs, err, prog: Program, R: int, B: int, item_caps,
                 tot_caps, compact: bool = True) -> torch.Tensor:
        return self.run(FinalizePlan(bufs, err, prog, R, B, item_caps,
                                     tot_caps, compact))


finalize_kernel = _FinalizeKernel()


def finalize(bufs, err, prog: Program, R: int, B: int, item_caps, tot_caps,
             compact: bool = True) -> torch.Tensor:
    """K2 for the tensors' device: the kernel for CUDA tensors, the plain
    finalize for CPU tensors. Returns the blob and its status bytes."""
    if err.device.type == "cuda":
        return finalize_kernel(bufs, err, prog, R, B, item_caps, tot_caps,
                               compact)
    if err.device.type == "cpu":
        return finalize_plain(bufs, err, prog, R, B, item_caps, tot_caps,
                              compact)
    raise RuntimeError(f"no finalize for device {err.device}")


# -- the decoder --------------------------------------------------------------------


class _Arena:
    """One persistent packed launch input ``[words | starts | lengths |
    n]`` (int32): ``host_t``, in pinned memory on the card path, with
    ``host`` its uint32 numpy view, and ``dev``, the device buffer of the
    same shape (``host_t`` itself on the CPU). ``copied`` is the event of
    the last copy from ``host_t`` to ``dev``, ``consumed`` the event after
    the last launch that read ``dev`` (None before the first)."""

    __slots__ = ("host_t", "host", "dev", "copied", "consumed")

    def __init__(self, words: int, device: torch.device):
        card = device.type == "cuda"
        self.host_t = torch.empty(words, dtype=torch.int32, pin_memory=card)
        self.host = self.host_t.numpy().view(np.uint32)
        self.dev = torch.empty(words, dtype=torch.int32, device=device) \
            if card else self.host_t
        self.copied = self.consumed = None


class _Flight:
    """A chunk whose launch is in flight on the overlapped path: its blob
    on its way to the host (``blob``, pinned on the card; ``done`` the
    event after its copy, None on the CPU), its walk's ``#err`` and the
    rung it ran at."""

    __slots__ = ("i", "blob", "done", "err", "layout", "item_caps",
                 "tot_caps", "compact")

    def __init__(self, i, blob, done, err, layout, item_caps, tot_caps,
                 compact):
        self.i, self.blob, self.done, self.err = i, blob, done, err
        self.layout, self.item_caps = layout, item_caps
        self.tot_caps, self.compact = tot_caps, compact

    def ready(self) -> bool:
        return self.done is None or self.done.query()


class DeviceDecoder:
    """Per-schema decoder: pack → walk + finalize (capacity ladder) → one
    device-to-host copy → host columns. Same contract as the reference's
    ``DeviceDecoder.decode_to_columns`` (host column dict, row count,
    meta) and ``decode_to_columns_overlapped`` (one such triple per
    chunk). ``fingerprint`` keys the capacity planner's plans (the codec
    passes the schema entry's). A decoder built without one does not use
    the planner: the reference derives one from the IR for its sharded
    decoder and bench scripts, which the port does not have, and a plan
    shared by every decoder of an IR would make each decoder's first
    rung depend on what others decoded before."""

    def __init__(self, ir, device="cuda", fingerprint: str = None):
        self.device = resolve_device(device)
        self.prog: Program = lower(ir)
        self.fingerprint = fingerprint
        self._item_caps: List[int] = [0] + [
            _DEFAULT_ITEM_CAP for _ in self.prog.regions[1:]]
        # per-region item-total caps, remembered per R bucket
        self._tot_cap_mem: Dict[Tuple[int, int], int] = {}
        # (R, B) buckets whose string lengths overflowed the compact
        # descriptors: they go straight to the full-width layout
        self._str_full: set = set()
        # persistent launch inputs: (R, B, slot, thread) -> _Arena (slot
        # alternates 0/1 on the overlapped path; the single launch uses 0)
        self._arenas: Dict[tuple, _Arena] = {}
        # R buckets whose converged rung the planner was taught
        self._planned: set = set()
        # (R, region) pairs a host sample was taken for
        self._seed_tried: set = set()
        self._copy_stream = None
        self._lock = threading.Lock()

    # -- capacity bookkeeping (copies of decode.py:723-773) ------------------

    def caps_snapshot(self, R: int):
        """Atomic snapshot of ``(item_caps, tot_caps)`` for an R bucket: a
        region's item total is bounded by its parent's entry total times
        its items per entry (parents precede children)."""
        prog = self.prog
        with self._lock:
            item_caps = tuple(self._item_caps)
            tot_caps = [0]
            for rid in range(1, len(prog.regions)):
                parent = prog.region_parents[rid]
                parent_total = R if parent == ROWS else tot_caps[parent]
                tot_caps.append(min(
                    self._tot_cap_mem.get((R, rid), _DEFAULT_TOT_CAP),
                    parent_total * item_caps[rid]))
        return item_caps, tuple(tot_caps)

    def grow_caps(self, R, item_caps, tot_caps, red_max, red_sum) -> bool:
        """Grow the remembered caps from the observed per-region item max
        and sum; True when any grew (the caller relaunches)."""
        retry = False
        with self._lock:
            for rid in red_max:
                maxc, sumc = red_max[rid], red_sum[rid]
                if maxc > item_caps[rid]:
                    if maxc > _MAX_ITEM_CAP:
                        raise DeviceCapacityExceeded(
                            f"{self.prog.regions[rid]!r} needs {maxc} item "
                            f"slots per record (device limit {_MAX_ITEM_CAP})")
                    self._item_caps[rid] = max(
                        self._item_caps[rid],
                        bucket_len(maxc, minimum=_DEFAULT_ITEM_CAP))
                    retry = True
                if sumc > tot_caps[rid]:
                    self._tot_cap_mem[(R, rid)] = max(
                        self._tot_cap_mem.get((R, rid), 0),
                        bucket_len(max(sumc, 1), minimum=_DEFAULT_TOT_CAP))
                    retry = True
        return retry

    def seed_from_plan(self, R: int) -> bool:
        """Start an R bucket at the capacity planner's learned rung
        (``decode.py:790-806``). A hit also marks the bucket planned, so
        the overlapped path streams every chunk from the first call."""
        hit = capacity.seed_decoder(self, R)
        if hit:
            with self._lock:
                self._planned.add(R)
        return hit

    def seed_caps_from_sample(self, data: Sequence[bytes], R: int) -> None:
        """Estimate the item caps of a fresh ``R`` bucket from the host
        oracle's decode of the first 128 records, so the first launch
        climbs fewer rungs (copy of ``decode.py:670-720``). Estimates
        only: the ladder still catches under-estimates, and a sample that
        does not decode (a malformed head record) is left to the device
        pass, which reports exact per-record errors."""
        prog = self.prog
        if len(prog.regions) <= 1:
            return
        with self._lock:
            need = [rid for rid in range(1, len(prog.regions))
                    if (R, rid) not in self._tot_cap_mem
                    and (R, rid) not in self._seed_tried]
            # one attempt per (R, region): a region the sample cannot
            # resolve must not pay the host decode on every call
            self._seed_tried.update((R, rid) for rid in need)
        if not need:
            return
        from ..fallback.decoder import decode_to_record_batch
        from ..schema.arrow_map import to_arrow_schema

        try:
            sample = decode_to_record_batch(data[:min(len(data), 128)],
                                            prog.ir, to_arrow_schema(prog.ir))
        except (ValueError, OverflowError):
            return
        for rid in need:
            counts = _region_counts(prog.ir, sample, prog.regions[rid])
            if counts is None or counts.size == 0:
                continue
            mx = int(counts.max(initial=0))
            avg = float(counts.mean())
            with self._lock:
                # at most the device's per-record limit, so a record past
                # it still raises DeviceCapacityExceeded on the ladder
                # (the reference seeds past its limit)
                self._item_caps[rid] = max(
                    self._item_caps[rid],
                    min(bucket_len(mx + (mx >> 1) + 1,
                                   minimum=_DEFAULT_ITEM_CAP),
                        _MAX_ITEM_CAP))
                est = int(R * avg * 1.25) + 16
                self._tot_cap_mem[(R, rid)] = max(
                    self._tot_cap_mem.get((R, rid), 0),
                    bucket_len(est, minimum=_DEFAULT_TOT_CAP))

    def _harvest_plan(self, R: int, grew: bool) -> None:
        """Teach the planner this bucket's converged rung, once per bucket
        unless a cap grew (``decode.py:808-819``, without persistence)."""
        with self._lock:
            fresh = R not in self._planned
            self._planned.add(R)
        if fresh or grew:
            capacity.harvest_decoder(self, R)

    def _next_rung(self, R: int, B: int, host, item_caps, tot_caps,
                   compact: bool) -> bool:
        """After a launch at this rung: True when the chunk must run again,
        because a string overflowed the compact descriptors (the bucket is
        remembered full-width) or a cap grew."""
        prog = self.prog
        if compact and "#red:strfit" in host and not host["#red:strfit"][0]:
            self._str_full.add((R, B))
            return True
        red_max = {rid: int(host["#red:max:" + path][0])
                   for rid, path in enumerate(prog.regions) if rid != ROWS}
        red_sum = {rid: int(host["#red:sum:" + path][0])
                   for rid, path in enumerate(prog.regions) if rid != ROWS}
        return self.grow_caps(R, item_caps, tot_caps, red_max, red_sum)

    # -- arenas and copies (decode.py:336-369, 831-839) -----------------------

    def _arena(self, R: int, B: int, slot: int = 0) -> _Arena:
        """The persistent launch input of an (R, B) bucket, the same object
        on every call of this thread: keyed by thread too, so that two
        threads decoding same-bucket batches never overwrite each other's
        packed bytes. Only the largest B per (R, slot, thread) is kept."""
        key = (R, B, slot, threading.get_ident())
        with self._lock:
            arena = self._arenas.get(key)
            if arena is None:
                for old in [k for k in self._arenas
                            if k[0] == R and k[2] == slot
                            and k[3] == key[3] and k[1] < B]:
                    del self._arenas[old]
                arena = self._arenas[key] = _Arena(B // 4 + 2 * R + 1,
                                                   self.device)
        return arena

    def _pack_into(self, arena: _Arena, flat, offsets, R: int,
                   B: int) -> None:
        """Pack one record run into ``arena``'s host buffer, once the
        buffer's last copy to the card has read it."""
        if arena.copied is not None:
            arena.copied.synchronize()
        pack_launch_into(arena.host, flat, offsets, R, B)

    def _put_packed(self, arena: _Arena, timings) -> torch.Tensor:
        """The arena's device buffer, its host buffer copied in: on the card
        one copy from pinned memory on the decoder's copy stream, started
        after the last launch that read the device buffer; the current
        stream waits on its event. The copy's device time goes into
        ``timings["h2d_ms"]`` once the call resolves its events."""
        if self.device.type != "cuda":
            return arena.dev
        with self._lock:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            copy = self._copy_stream
        if arena.consumed is not None:
            copy.wait_event(arena.consumed)
        # written on the copy stream: the allocator must not hand the
        # buffer out again before this copy ends
        arena.dev.record_stream(copy)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(copy)
        with torch.cuda.stream(copy):
            arena.dev.copy_(arena.host_t, non_blocking=True)
        end.record(copy)
        arena.copied = end
        torch.cuda.current_stream(self.device).wait_event(end)
        timings["_events"].append(("h2d_ms", start, end))
        return arena.dev

    def _mark_consumed(self, arena: _Arena) -> None:
        """Record, on the current stream, that every launch so far that
        reads ``arena``'s device buffer is enqueued."""
        if self.device.type == "cuda":
            arena.consumed = torch.cuda.Event()
            arena.consumed.record(torch.cuda.current_stream(self.device))

    def _fetch(self, blob: torch.Tensor, timings):
        """Start the blob's copy to the host: on the card into pinned
        memory, without waiting; ``(host tensor, event after the copy)``.
        On the CPU ``(blob, None)``."""
        if blob.device.type != "cuda":
            return blob, None
        host = torch.empty(blob.numel(), dtype=torch.uint8, pin_memory=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(self.device)
        start.record(stream)
        host.copy_(blob, non_blocking=True)
        end.record(stream)
        timings["_events"].append(("d2h_ms", start, end))
        return host, end

    @staticmethod
    def _new_timings():
        return {"pack_s": 0.0, "h2d_s": 0.0, "walk_s": 0.0,
                "finalize_s": 0.0, "d2h_s": 0.0, "rungs": 0, "reruns": 0,
                "chunks": 1, "overlap_s": 0.0, "overlap_frac": 0.0,
                "h2d_ms": [], "d2h_ms": [], "_events": []}

    @staticmethod
    def _resolve(timings, t0: float) -> None:
        """Close a call's timings: the device times of its copies (every
        event has completed by now) and the call's wall seconds."""
        for key, start, end in timings.pop("_events"):
            end.synchronize()
            timings[key].append(start.elapsed_time(end))
        timings["total_s"] = time.perf_counter() - t0

    # -- one launch ------------------------------------------------------------

    @staticmethod
    def launch_views(packed: torch.Tensor, R: int, B: int):
        """``(words, starts, lengths)`` views of the packed launch buffer."""
        W = B // 4
        return packed[:W], packed[W:W + R], packed[W + R:W + 2 * R]

    def pipeline(self, packed, R: int, B: int, n: int, item_caps, tot_caps,
                 compact: bool, timings=None, sync: bool = True):
        """Walk then finalize on the packed buffer's device: ``(blob with
        status bytes, #err)``, both still on that device. The walk reads
        its status on the host (its loop bounds settle there); the
        finalize is only enqueued unless ``sync``."""
        t0 = time.perf_counter()
        words, starts, lengths = self.launch_views(packed, R, B)
        bufs, err = walk(words, starts, lengths, n, self.prog, item_caps)
        t1 = time.perf_counter()
        blob = finalize(bufs, err, self.prog, R, B, item_caps, tot_caps,
                        compact)
        if sync and blob.device.type == "cuda":
            torch.cuda.synchronize(blob.device)
        if timings is not None:
            timings["walk_s"] += t1 - t0
            timings["finalize_s"] += time.perf_counter() - t1
        return blob, err

    def _split(self, blob_np: np.ndarray, layout, n: int):
        if blob_np[-STATUS_BYTES]:
            # an #offsets total reached 2^31 (zero-byte items): int32
            # offsets cannot hold it; the codec halves the batch
            raise BatchTooLarge(n, -1)
        return split_blob(blob_np[:-STATUS_BYTES], layout)

    def _run_ladder(self, packed, R: int, B: int, n: int, timings):
        """Launch the pipeline, climbing the capacity ladder until the
        reductions converge (``decode.py:838-918``), then teach the
        planner the rung. Returns the split host dict and the last rung's
        device ``#err``."""
        grew = False
        for _attempt in range(_MAX_RUNGS):
            # a deadline stops the climb instead of paying rungs it can
            # no longer afford
            deadline.check(site="device.capacity_ladder")
            item_caps, tot_caps = self.caps_snapshot(R)
            compact = (R, B) not in self._str_full
            layout = blob_layout(self.prog, R, B, item_caps, tot_caps,
                                 compact)
            blob, err = self.pipeline(packed, R, B, n, item_caps, tot_caps,
                                      compact, timings)
            t0 = time.perf_counter()
            blob_np = blob.cpu().numpy()
            timings["d2h_s"] += time.perf_counter() - t0
            host = self._split(blob_np, layout, n)
            timings["rungs"] += 1
            if not self._next_rung(R, B, host, item_caps, tot_caps, compact):
                self._harvest_plan(R, grew)
                return host, err
            grew = True
        # a limit of the engine, not an error of the data (the reference
        # raises MalformedAvro here)
        raise DeviceCapacityExceeded(
            f"array/map item capacity did not converge in {_MAX_RUNGS} "
            f"rungs")

    @staticmethod
    def _raise_row_errors(err: np.ndarray, n: int, base_row: int = 0,
                          collect=None):
        """Raise the first bad row with the reference's message; every bad
        row's ``(index, slug)`` rides in ``indices``
        (``decode.py:920-963``). With ``collect``, append the pairs to it
        instead (the overlapped path raises once for all chunks)."""
        bad = err[:n].view(np.uint32) & ~np.uint32(ERR_ITEM_OVERFLOW)
        bad_rows = np.flatnonzero(bad)
        indices = []
        for r in bad_rows:
            v = int(bad[int(r)])
            b = v & -v
            indices.append((base_row + int(r), ERR_SLUGS.get(b, f"bit_{b:#x}")))
        if collect is not None:
            collect.extend(indices)
            return
        if not indices:
            # the reduction counted an error the rows do not hold
            raise RuntimeError("device reported a malformed record in no row")
        i = int(bad_rows[0])
        v = int(bad[i])
        bit = v & -v
        raise MalformedAvro(
            f"record {base_row + i}: "
            f"{ERR_NAMES.get(bit, f'error bit {bit:#x}')}",
            index=base_row + i,
            err_name=ERR_SLUGS.get(bit, f"bit_{bit:#x}"), tier="device",
            indices=indices)

    def _finish_host(self, host, n: int, flat, timings):
        """Expand a converged host dict into the ``(host, n, meta)`` triple
        (``decode.py:965-974``)."""
        host = expand_host(host)
        meta = {"item_totals": {}, "flat": flat, "timings": timings}
        for rid, path in enumerate(self.prog.regions):
            if rid != ROWS:
                meta["item_totals"][path] = int(host["#red:sum:" + path][0])
        return host, n, meta

    @staticmethod
    def pack(data: Sequence[bytes]):
        """``(flat, lanes, n, R, B)``, one launch's host side: the records
        concatenated, and the ``[starts | lengths | n]`` tail."""
        n = len(data)
        lens = record_lengths(data)
        total = int(lens.sum())
        if total > LAUNCH_MAX_BYTES:
            # int32 cursors bound one launch to 1 GiB of datum bytes
            raise BatchTooLarge(n, total)
        R, B = launch_shape(n, total)
        flat, offsets = concat_records(data, lens)
        return flat, launch_lanes(offsets, R, B), n, R, B

    @staticmethod
    def launch_buffer(flat: np.ndarray, lanes: np.ndarray, B: int,
                      device) -> torch.Tensor:
        """The packed launch buffer ``[words | starts | lengths | n]``
        (int32) on ``device``, outside any arena: the records and the tail
        copied in, the words' zero padding to ``B`` bytes written there."""
        W = B // 4
        packed = torch.empty(W + lanes.size, dtype=torch.int32,
                             device=device)
        words = packed[:W].view(torch.uint8)
        words[:flat.size].copy_(torch.from_numpy(flat))
        words[flat.size:].zero_()
        packed[W:].copy_(torch.from_numpy(lanes.view(np.int32)))
        return packed

    def decode_to_columns(self, data: Sequence[bytes]):
        """One launch (``decode.py:976-1003``). ``(host, n, meta)``: host
        holds the expanded blob (item regions dense, ``#offsets``, the
        reductions); meta holds ``item_totals``, ``flat`` (the
        concatenated records, which every ``#start`` indexes) and
        ``timings`` (seconds per host-visible phase, the rungs climbed,
        the copy's device ms on the card)."""
        t0 = time.perf_counter()
        timings = self._new_timings()
        n = len(data)
        flat, offsets = concat_records(data,
                                       native=self.device.type == "cuda")
        total = int(offsets[-1])
        if total > LAUNCH_MAX_BYTES:
            # int32 cursors bound one launch to 1 GiB of datum bytes
            raise BatchTooLarge(n, total)
        R, B = launch_shape(n, total)
        if not self.seed_from_plan(R):
            self.seed_caps_from_sample(data, R)
        arena = self._arena(R, B)
        self._pack_into(arena, flat, offsets, R, B)
        t1 = time.perf_counter()
        packed = self._put_packed(arena, timings)
        if arena.copied is not None:
            arena.copied.synchronize()
        timings["pack_s"] = t1 - t0
        timings["h2d_s"] = time.perf_counter() - t1
        host, err = self._run_ladder(packed, R, B, n, timings)
        self._mark_consumed(arena)
        if host["#red:err"][0]:
            # K1's #err of the converged rung, copied back only now
            self._raise_row_errors(err.cpu().numpy(), n)
        triple = self._finish_host(host, n, flat, timings)
        self._resolve(timings, t0)
        return triple

    # -- the overlapped chunk path (decode.py:1007-1192) ----------------------

    def decode_to_columns_overlapped(self, data: Sequence[bytes],
                                     n_chunks: int):
        """The batch in ``chunk_bounds(n, n_chunks)`` chunks, one launch
        each at the largest chunk's (R, B); one ``(host, n, meta)`` triple
        per chunk, whose ``meta["flat"]`` is a view of the one concat of
        the whole batch and whose ``meta["timings"]`` is the call's.

        A cold bucket climbs the ladder on chunk 0 first; a warm or planned
        one streams every chunk. At most two chunks are in flight: chunk
        ``i + 1`` is packed into the other arena slot and copied while
        chunk ``i``'s finalize and blob copy run; the walk's status is
        read on the host before the finalize is enqueued, so the loop
        bounds settle as on the single launch. A chunk whose rung
        overflowed (a string past the compact descriptors, or more items
        than the caps) reruns its ladder from its intact arena. Row errors
        of every chunk are raised once, after the last. ``overlap_s`` sums
        the host pack and copy seconds of each chunk after which an
        earlier chunk was still in flight (checked after the host work,
        so it can undercount, never overcount); ``overlap_frac`` is its
        share of the call."""
        t_wall0 = time.perf_counter()
        timings = self._new_timings()
        n_all = len(data)
        flat_all, offsets_all = concat_records(
            data, native=self.device.type == "cuda")
        bounds = chunk_bounds(n_all, n_chunks)
        timings["chunks"] = len(bounds)
        chunk_rows = max(b - a for a, b in bounds)
        chunk_bytes = max(int(offsets_all[b] - offsets_all[a])
                          for a, b in bounds)
        total = int(offsets_all[-1])
        if total > LAUNCH_MAX_BYTES or chunk_bytes > LAUNCH_MAX_BYTES:
            raise BatchTooLarge(n_all, total)
        R, B = launch_shape(chunk_rows, chunk_bytes)
        if not self.seed_from_plan(R):
            self.seed_caps_from_sample(data, R)
        timings["pack_s"] += time.perf_counter() - t_wall0
        arenas: Dict[int, _Arena] = {}

        def chunk_flat(i: int) -> np.ndarray:
            a, b = bounds[i]
            return flat_all[int(offsets_all[a]):int(offsets_all[b])]

        def put_chunk(i: int) -> torch.Tensor:
            t0 = time.perf_counter()
            a, b = bounds[i]
            arena = arenas[i] = self._arena(R, B, slot=i % 2)
            self._pack_into(arena, chunk_flat(i), offsets_all[a:b + 1], R, B)
            t1 = time.perf_counter()
            packed = self._put_packed(arena, timings)
            timings["pack_s"] += t1 - t0
            timings["h2d_s"] += time.perf_counter() - t1
            return packed

        triples = [None] * len(bounds)
        bad: list = []

        def finish(i: int, host, err) -> None:
            a, b = bounds[i]
            self._mark_consumed(arenas[i])
            if host["#red:err"][0]:
                self._raise_row_errors(err.cpu().numpy(), b - a, base_row=a,
                                       collect=bad)
            triples[i] = self._finish_host(host, b - a, chunk_flat(i),
                                           timings)

        with self._lock:
            warm = R in self._planned
        start = 0
        if not warm:
            # a cold bucket converges its ladder on chunk 0 first
            packed = put_chunk(0)
            host, err = self._run_ladder(packed, R, B, bounds[0][1],
                                         timings)
            finish(0, host, err)
            start = 1
        pending: List[_Flight] = []

        def collect_one() -> None:
            f = pending.pop(0)
            a, b = bounds[f.i]
            t0 = time.perf_counter()
            if f.done is not None:
                f.done.synchronize()
            host = self._split(f.blob.numpy(), f.layout, b - a)
            timings["d2h_s"] += time.perf_counter() - t0
            timings["rungs"] += 1
            err = f.err
            if self._next_rung(R, B, host, f.item_caps, f.tot_caps,
                               f.compact):
                # the chunk overflowed the rung it was dispatched at: its
                # arena is intact (slot i % 2 is packed again only for
                # chunk i + 2, after this collect)
                timings["reruns"] += 1
                host, err = self._run_ladder(arenas[f.i].dev, R, B, b - a,
                                             timings)
                # the rerun's ladder starts at the grown caps and records
                # no growth, so teach the planner here (the reference does
                # not, and its planned decoders rerun such chunks again)
                self._harvest_plan(R, True)
            finish(f.i, host, err)

        for i in range(start, len(bounds)):
            deadline.check(index=bounds[i][0], site="device.chunk")
            t0 = time.perf_counter()
            packed = put_chunk(i)
            t_host = time.perf_counter() - t0
            if any(not f.ready() for f in pending):
                timings["overlap_s"] += t_host
            a, b = bounds[i]
            item_caps, tot_caps = self.caps_snapshot(R)
            compact = (R, B) not in self._str_full
            layout = blob_layout(self.prog, R, B, item_caps, tot_caps,
                                 compact)
            blob, err = self.pipeline(packed, R, B, b - a, item_caps,
                                      tot_caps, compact, timings, sync=False)
            self._mark_consumed(arenas[i])
            pending.append(_Flight(i, *self._fetch(blob, timings), err,
                                   layout, item_caps, tot_caps, compact))
            if len(pending) >= 2:
                collect_one()
        while pending:
            collect_one()
        if bad:
            raise_aggregated_malformed(bad)
        self._resolve(timings, t_wall0)
        wall = timings["total_s"]
        timings["overlap_frac"] = min(timings["overlap_s"] / wall, 1.0) \
            if wall > 0 else 0.0
        return triples

    def decode(self, data: Sequence[bytes], arrow_schema):
        """Straight to a RecordBatch."""
        from .arrow_build import build_record_batch

        host, n, meta = self.decode_to_columns(data)
        return build_record_batch(self.prog.ir, arrow_schema, host, n, meta)
