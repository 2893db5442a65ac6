"""Sharded encode: the encode program once per device, one chunk each
(port of ``pyruhvro_tpu/parallel/sharded_encode.py``; ≙ the chunk
fan-out of ``serialize_record_batch``, ``ruhvro/src/serialize.rs:38-99``,
with devices in place of threads).

The reference pads the chunks' extracted lanes to one shape bucket,
stacks them ``[D, ...]`` and runs the single-chunk program in one
``shard_map`` launch. :class:`ShardedEncoder` extracts each chunk, packs
it into its own launch buffer at the largest chunk bound's output
capacity and runs K3 (``encode_rows`` size and write passes, then
``encode_strings``) on that chunk's device; each chunk's rows come back
as one ``BinaryArray``. The kernels take any lane shape, so the chunks
are not padded to a common one. A chunk with no rows launches nothing.
No public entry takes it (as in the reference): ``serialize_record_batch``
encodes once and slices.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import pyarrow as pa

from ..errors import BatchTooLarge
from ..ops.encode import (
    MAX_OUTPUT_BYTES,
    DeviceEncoder,
    EncodeLaunch,
    k3_bytes,
    rows_traffic,
    run_program,
)
from ..ops.encode_extract import extract_batch
from ..runtime import device_obs, metrics, telemetry
from ..runtime.chunking import chunk_bounds
from ..runtime.pack import bucket_len
from .sharded import chunk_devices

__all__ = ["ShardedEncoder"]


class ShardedEncoder:
    """Encode a RecordBatch in ``D`` chunks, one per device."""

    def __init__(self, ir=None, arrow_schema=None, *,
                 base: Optional[DeviceEncoder] = None, devices=None,
                 n_devices: Optional[int] = None):
        if base is None and ir is None:
            raise ValueError("need a schema IR or a DeviceEncoder")
        self.devices = chunk_devices(devices, n_devices)
        if base is None:
            if arrow_schema is None:
                from ..schema.arrow_map import to_arrow_schema

                arrow_schema = to_arrow_schema(ir)
            base = DeviceEncoder(ir, arrow_schema, self.devices[0])
        self.base = base
        self.D = len(self.devices)
        self._card = self.devices[0].type == "cuda"
        self._launched: set = set()  # buckets launched (first = compile)
        self._lock = threading.Lock()
        device_obs.track_holder(self)

    def _launch(self, launches, cap: int, info) -> device_obs.launch:
        """The launch record of one call over every shard (kind
        ``encode.sharded``, bucket ``D{D},in…,cap…`` as in
        ``sharded_encode.py:99-103``), with K3's bytes summed over the
        shards while ``device_obs.count_walked_bytes`` is on."""
        live = [(d, L) for d, L in enumerate(launches) if L is not None]
        bucket = f"D{self.D},in{sum(L.in_bytes for _d, L in live)},cap{cap}"
        with self._lock:
            first = bucket not in self._launched
            self._launched.add(bucket)
        rec = device_obs.launch("encode.sharded", bucket,
                                self.base.fingerprint, first,
                                builds=("encode.cu",), family="encode",
                                info=info)
        if self._card and device_obs.walked_bytes():
            def moved(part):
                def fn(launch):
                    return sum(k3_bytes(rows_traffic(L),
                                        launch.info["totals"][d], L.R)[part]
                               for d, L in live)
                return fn

            rec.L.add_bytes("encode_rows", moved(0))
            rec.L.add_bytes("encode_strings", moved(1))
        return rec

    def encode(self, batch: pa.RecordBatch) -> List[pa.Array]:
        """Encode → one ``BinaryArray`` per chunk, with the reference's
        chunk bounds (one ``device.pipeline_s`` span, ``shards=D``)."""
        with telemetry.phase("device.pipeline_s", rows=batch.num_rows,
                             op="encode", shards=self.D):
            return self._encode(batch)

    def _encode(self, batch: pa.RecordBatch) -> List[pa.Array]:
        base, D = self.base, self.D
        n_all = batch.num_rows
        bounds = chunk_bounds(n_all, D)
        while len(bounds) < D:  # fewer rows than devices: empty shards
            bounds.append((n_all, n_all))
        with telemetry.phase("encode.extract_s", rows=n_all):
            dvs, bound = [], 16
            for a, b in bounds:
                dv, bd = extract_batch(base.prog, batch.slice(a, b - a),
                                       base.ir)
                dvs.append(dv)
                bound = max(bound, bd)
        if bound >= MAX_OUTPUT_BYTES:
            raise BatchTooLarge(n_all, bound)
        cap = bucket_len(bound, minimum=64)
        launches: List[Optional[EncodeLaunch]] = []
        hosts = []
        for dv, (a, b) in zip(dvs, bounds):
            L = EncodeLaunch(base.prog, dv, cap, b - a) if b > a else None
            launches.append(L)
            hosts.append(None if L is None else L.pack())
        nbytes = sum(h.nbytes for h in hosts if h is not None)
        with telemetry.phase("encode.h2d_s", bytes=nbytes):
            for d, (L, host) in enumerate(zip(launches, hosts)):
                if L is not None:
                    L.upload(host, self.devices[d])
        metrics.inc("encode.h2d_bytes", nbytes)
        metrics.inc("device.h2d_bytes", nbytes)
        info = {"totals": [0] * D}
        # every card's program is enqueued before any copy back waits
        with self._launch(launches, cap, info):
            outs = [None if L is None else run_program(L) for L in launches]
        out: List[pa.Array] = []
        nbytes = 0
        with telemetry.phase("encode.d2h_s"):
            for d, ((a, b), res) in enumerate(zip(bounds, outs)):
                n = b - a
                if res is None:
                    out.append(pa.array([], pa.binary()))
                    continue
                blob, row_sizes = res
                sizes = row_sizes[:n].cpu().numpy()
                offsets = np.zeros(n + 1, np.int32)
                np.cumsum(sizes, out=offsets[1:])
                total = int(offsets[-1])
                data = blob[:total].cpu().numpy()
                nbytes += sizes.nbytes + data.nbytes
                info["totals"][d] = total
                out.append(pa.Array.from_buffers(
                    pa.binary(), n,
                    [None, pa.py_buffer(offsets), pa.py_buffer(data)]))
        metrics.inc("encode.d2h_bytes", nbytes)
        metrics.inc("device.d2h_bytes", nbytes)
        if self._card and telemetry.enabled():
            for dev in set(self.devices):
                device_obs.note_memory(dev)
        device_obs.flush(final=False)
        return out[:len(chunk_bounds(n_all, D))]
