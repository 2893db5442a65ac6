"""Sharded decode: the pipeline engine once per device, one chunk each
(port of ``pyruhvro_tpu/parallel/sharded.py``).

The reference stacks the D chunks' packed inputs ``[D, ...]``, runs the
per-chunk pipeline in one ``shard_map`` launch and fetches ``[D, blob]``.
:class:`ShardedDecoder` runs the same pipeline as K1 and K2 on each
chunk's own device: per rung, K1 is enqueued on every card before any
status is read (so the cards overlap), each walk settles its loop
bounds, K2 is enqueued per card, and one pinned blob copy per card comes
back. The capacity caps are global, as in the reference, where every
shard runs one compiled program: one base :class:`~..ops.decode.
DeviceDecoder` holds the caps, the planner's plans and the string
layout; the shards' ``#red:max``/``#red:sum`` are max-reduced on the host
and every shard reruns at the grown rung. Each shard is one launch, as
in the reference (no overlapped chunks inside a shard).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import torch

from ..errors import BatchTooLarge, DeviceCapacityExceeded
from ..ops.decode import (
    _BUILDS,
    _MAX_RUNGS,
    DeviceDecoder,
    FinalizePlan,
    WalkLaunch,
    _Arena,
    blob_layout,
    bucket_label,
    finalize,
    finalize_bytes,
    finalize_kernel,
    finalize_spec,
    raise_aggregated_malformed,
    walk,
    walk_bytes,
    walk_kernel,
    walk_out_bytes,
)
from ..ops.walk_decode import resolve_device
from ..runtime import deadline, device_obs, metrics, telemetry
from ..runtime.chunking import chunk_bounds
from ..runtime.pack import LAUNCH_MAX_BYTES, concat_records, launch_shape

__all__ = ["ShardedDecoder", "chunk_devices"]


def chunk_devices(devices=None, n_devices: Optional[int] = None
                  ) -> List[torch.device]:
    """The devices of the fan-out, one chunk each (the counterpart of
    ``chunk_mesh``, ``sharded.py:56-69``): ``devices`` as given, or every
    visible card, ``cuda:0`` to ``cuda:{device_count - 1}``; the first
    ``n_devices`` of them when that is given. A device may repeat (the
    counterpart of the reference's spoofed CPU mesh); all are of one type,
    and a card without an index is the current one. Raises
    ``RuntimeError`` when fewer than ``n_devices`` (or none) exist."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(f"need {n_devices} devices for the chunk "
                               f"fan-out, have {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise RuntimeError("no device for the chunk fan-out: no CUDA device "
                           "is visible and none was given")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"the fan-out's devices are of one type, got "
                         f"{[str(d) for d in devs]}")
    return devs


class ShardedDecoder:
    """Decode Avro datums in ``D`` chunks, one per device (≙ the chunk
    fan-out of ``per_datum_deserialize_threaded``,
    ``deserialize.rs:90-121``, with devices in place of threads).

    ``base`` is the decoder whose caps, plans and string layout every
    shard shares (by default a new one on the first device); each device
    gets its own arenas, copy stream and launch state."""

    def __init__(self, ir=None, *, base: Optional[DeviceDecoder] = None,
                 devices=None, n_devices: Optional[int] = None):
        if base is None and ir is None:
            raise ValueError("need a schema IR or a DeviceDecoder")
        self.devices = chunk_devices(devices, n_devices)
        if base is None:
            base = DeviceDecoder(ir, self.devices[0])
        self.base = base
        self.D = len(self.devices)
        self._card = self.devices[0].type == "cuda"
        # persistent launch inputs: (shard, R, B, thread) -> _Arena; keyed
        # by shard, so shards on one device never share a buffer
        self._arenas: Dict[tuple, _Arena] = {}
        self._launched: set = set()  # buckets launched (first = compile)
        self._lock = threading.Lock()
        device_obs.track_holder(self)

    def _arena(self, d: int, R: int, B: int) -> _Arena:
        """Shard ``d``'s launch input of an (R, B) bucket, on its device,
        the same object on every call of this thread; only the largest B
        per (shard, R, thread) is kept (``DeviceDecoder._arena``)."""
        key = (d, R, B, threading.get_ident())
        with self._lock:
            arena = self._arenas.get(key)
            if arena is None:
                for old in [k for k in self._arenas
                            if k[0] == d and k[1] == R and k[3] == key[3]
                            and k[2] < B]:
                    del self._arenas[old]
                arena = self._arenas[key] = _Arena(B // 4 + 2 * R + 1,
                                                   self.devices[d])
                hit = False
            else:
                arena.last_used = time.monotonic()
                hit = True
        metrics.inc("device.arena.hits" if hit else "device.arena.misses")
        return arena

    def _launch(self, R: int, B: int, item_caps, tot_caps, compact: bool,
                sizes: List[int], info) -> device_obs.launch:
        """The launch record of one rung over every shard (kind
        ``decode.sharded``, bucket ``D{D},...`` as in ``sharded.py:170-174``):
        the walks' bytes from each shard's record bytes ``sizes``; the
        finalizes' are set once the rung's blobs are on the host."""
        bucket = f"D{self.D}," + bucket_label(R, B, item_caps, tot_caps,
                                              compact)
        with self._lock:
            first = bucket not in self._launched
            self._launched.add(bucket)
        rec = device_obs.launch("decode.sharded", bucket,
                                self.base.fingerprint, first, builds=_BUILDS,
                                family="decode", info=info)
        if self._card:
            out = walk_out_bytes(self.base.prog, R, item_caps)
            rec.L.add_bytes("walk", sum(walk_bytes(s, R, out)
                                        for s in sizes))
        return rec

    # -- orchestration ----------------------------------------------------

    def decode_to_chunk_columns(self, data: Sequence[bytes]):
        """Decode into exactly ``D`` chunks (reference slicing; empty
        chunks pad a batch of fewer rows than devices). One ``(host, n,
        meta)`` triple per chunk, as the single launch gives; every
        ``meta["timings"]`` is the call's. One ``device.pipeline_s`` span
        (``shards=D``) over the pack, the copies, each rung's launch and
        the blob copies."""
        with telemetry.phase("device.pipeline_s", rows=len(data),
                             op="decode", shards=self.D):
            return self._decode_to_chunk_columns(data)

    def _decode_to_chunk_columns(self, data: Sequence[bytes]):
        t_wall0 = time.perf_counter()
        base, D = self.base, self.D
        timings = base._new_timings()
        timings["chunks"] = D
        n_all = len(data)
        bounds = chunk_bounds(n_all, D)
        while len(bounds) < D:  # fewer records than devices: empty shards
            bounds.append((n_all, n_all))
        ns = [b - a for a, b in bounds]
        # ONE concat of the whole batch; the shards are slices of it
        with telemetry.phase("decode.pack_s", rows=n_all) as ph:
            flat_all, offsets_all = concat_records(data, native=self._card)
        timings["pack_s"] = ph.dt
        sizes = [int(offsets_all[b] - offsets_all[a]) for a, b in bounds]
        if max(sizes) > LAUNCH_MAX_BYTES:
            raise BatchTooLarge(n_all, max(sizes))
        R, B = launch_shape(max(ns), max(sizes))
        if not base.seed_from_plan(R):
            base.seed_caps_from_sample(data, R)
        flats = [flat_all[int(offsets_all[a]):int(offsets_all[b])]
                 for a, b in bounds]
        # shard d's copy starts before shard d + 1 is packed
        arenas: List[_Arena] = []
        packed = []
        overlap_s = 0.0
        with telemetry.phase("decode.h2d_s",
                             bytes=D * 4 * (B // 4 + 2 * R + 1)) as ph:
            for d, (a, b) in enumerate(bounds):
                t0 = time.perf_counter()
                arena = self._arena(d, R, B)
                base._pack_into(arena, flats[d], offsets_all[a:b + 1], R, B)
                dt = time.perf_counter() - t0
                timings["arena_s"] += dt
                if any(x.copied is not None and not x.copied.query()
                       for x in arenas):
                    # an earlier shard's copy was still in flight after this
                    # pack (checked after it: undercounts, never over)
                    overlap_s += dt
                telemetry.observe("decode.shard_pack_s", dt, shard=d,
                                  rows=ns[d])
                packed.append(base._put_packed(arena, timings))
                arenas.append(arena)
        timings["h2d_s"] = ph.dt
        timings["overlap_s"] = overlap_s
        hosts, errs = self._ladder(packed, ns, sizes, R, B, timings)
        for arena in arenas:
            base._mark_consumed(arena)
        if self._card and telemetry.enabled():
            for dev in set(self.devices):
                device_obs.note_memory(dev)
        # every failing shard's rows, re-based to global rows, in ONE
        # MalformedAvro (sharded.py:356-377)
        bad: list = []
        for d, h in enumerate(hosts):
            if h["#red:err"][0]:
                t0 = time.perf_counter()
                base._raise_row_errors(errs[d].cpu().numpy(), ns[d],
                                       base_row=bounds[d][0], collect=bad)
                telemetry.observe("decode.shard_err_s",
                                  time.perf_counter() - t0, shard=d)
        if bad:
            raise_aggregated_malformed(bad)
        base._resolve(timings, t_wall0)
        device_obs.flush(final=False)
        wall = timings["total_s"]
        timings["overlap_frac"] = min(overlap_s / wall, 1.0) \
            if wall > 0 else 0.0
        if overlap_s:
            metrics.inc("device.overlap_s", overlap_s)
            metrics.inc("device.overlap_calls")
            telemetry.annotate(overlap_s=round(overlap_s, 6),
                               overlap_frac=round(timings["overlap_frac"], 4))
        return [base._finish_host(h, ns[d], flats[d], timings)
                for d, h in enumerate(hosts)]

    def _ladder(self, packed, ns, sizes, R: int, B: int, timings):
        """Climb the capacity ladder with every shard at each rung
        (``sharded.py:276-343``): the rung's blobs split on the host, the
        shards' reductions max-reduced into the base decoder's caps, and
        every shard run again at the grown rung. ``device.retries`` counts
        rungs. Returns each shard's split blob and ``#err`` of the last
        rung, and teaches the planner the rung."""
        base = self.base
        grew = False
        for attempt in range(_MAX_RUNGS):
            deadline.check(site="device.capacity_ladder")
            item_caps, tot_caps = base.caps_snapshot(R)
            compact = (R, B) not in base._str_full
            layout = blob_layout(base.prog, R, B, item_caps, tot_caps,
                                 compact)
            info = {}
            with self._launch(R, B, item_caps, tot_caps, compact, sizes,
                              info) as rec:
                blobs, errs, spec = self._rung(packed, ns, R, B, item_caps,
                                               tot_caps, compact, timings)
                if spec is not None:
                    # each shard's at its own item totals (known once the
                    # blobs are on the host; none if the rung raised)
                    rec.add_bytes("finalize", lambda L: sum(
                        finalize_bytes(spec, t)
                        for t in L.info.get("shard_totals", ())))
            with telemetry.phase("decode.d2h_s") as ph:
                fetched = [base._fetch(blob, timings) for blob in blobs]
                hosts = []
                for (host_t, done), n in zip(fetched, ns):
                    if done is not None:
                        done.synchronize()
                    hosts.append(base._split(host_t.numpy(), layout, n))
            timings["d2h_s"] += ph.dt
            nbytes = sum(host_t.numel() for host_t, _done in fetched)
            metrics.inc("decode.d2h_bytes", nbytes)
            metrics.inc("device.d2h_bytes", nbytes)
            info["shard_totals"] = [base._item_totals(h) for h in hosts]
            timings["rungs"] += 1
            if not base._next_rung(R, B, _reduced(hosts), item_caps,
                                   tot_caps, compact, attempt=attempt):
                base._harvest_plan(R, grew)
                return hosts, errs
            grew = True
        # the reference's message (sharded.py:342-343); the port's type for
        # a limit of the engine (``DeviceDecoder._run_ladder``)
        raise DeviceCapacityExceeded(
            "array/map item capacity did not converge")

    def _rung(self, packed, ns, R: int, B: int, item_caps, tot_caps,
              compact: bool, timings):
        """One rung on every shard: ``(blobs, #errs, finalize spec)``. On
        the card K1's first launch is enqueued on every shard before any
        walk's status is read, then each walk settles and its K2 is
        enqueued; nothing waits for K2. On the CPU the plain versions run
        shard by shard."""
        prog = self.base.prog
        t0 = time.perf_counter()
        walks = []
        for p, n in zip(packed, ns):
            words, starts, lengths = DeviceDecoder.launch_views(p, R, B)
            if words.device.type == "cuda":
                L = WalkLaunch(words, starts, lengths, n, prog, item_caps)
                walk_kernel.launch(L)
                walks.append(L)
            else:
                walks.append(walk(words, starts, lengths, n, prog,
                                  item_caps))
        timings["walk_s"] += time.perf_counter() - t0
        blobs, errs, spec = [], [], None
        for w in walks:
            t1 = time.perf_counter()
            bufs, err = walk_kernel.settle(w) \
                if isinstance(w, WalkLaunch) else w
            t2 = time.perf_counter()
            if err.device.type == "cuda":
                plan = FinalizePlan(bufs, err, prog, R, B, item_caps,
                                    tot_caps, compact, self.base._finalize)
                blobs.append(finalize_kernel.run(plan))
                spec = finalize_spec(plan)  # the same for every shard
            else:
                blobs.append(finalize(bufs, err, prog, R, B, item_caps,
                                      tot_caps, compact, self.base._finalize))
            errs.append(err)
            timings["walk_s"] += t2 - t1
            timings["finalize_s"] += time.perf_counter() - t2
        return blobs, errs, spec

    def decode(self, data: Sequence[bytes], ir=None,
               arrow_schema: Optional[pa.Schema] = None
               ) -> List[pa.RecordBatch]:
        """Decode → one RecordBatch per device's chunk
        (``sharded.py:416-430``)."""
        from ..ops.arrow_build import build_record_batch

        ir = ir if ir is not None else self.base.prog.ir
        if arrow_schema is None:
            from ..schema.arrow_map import to_arrow_schema

            arrow_schema = to_arrow_schema(ir)
        return [build_record_batch(ir, arrow_schema, host, n, meta)
                for host, n, meta in self.decode_to_chunk_columns(data)]


def _reduced(hosts) -> Dict[str, np.ndarray]:
    """The shards' capacity reductions as one blob's, for
    ``DeviceDecoder._next_rung``: each ``#red:max``/``#red:sum`` the
    largest over the shards (tot caps bound a shard's item total, so the
    max, not the sum, is the growth signal; ``sharded.py:318-330``), and
    ``#red:strfit`` set only when every shard's strings fit."""
    out = {}
    for key in hosts[0]:
        if key.startswith(("#red:max:", "#red:sum:")):
            out[key] = np.array([max(int(h[key][0]) for h in hosts)])
        elif key == "#red:strfit":
            out[key] = np.array([int(all(h[key][0] for h in hosts))])
    return out
