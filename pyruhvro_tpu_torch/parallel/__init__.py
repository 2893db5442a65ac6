"""The multi-device chunk fan-out, K5 (counterpart of
``pyruhvro_tpu/parallel/``).

The reference's one parallel strategy is data-parallel chunking: the
input is cut into independent chunks, one decode per chunk, one
RecordBatch per chunk returned (``ruhvro/src/deserialize.rs:57-68,
90-121``). The JAX package runs it as one ``shard_map`` over a 1-D mesh
of devices. The port runs the same chunks, one per torch device, each
through the hand kernels that already exist (K1 and K2 for decode, K3
for encode) on its own card's streams; the chunks share nothing, so
there are no collectives and no copies between cards.

:func:`chunk_devices` is the counterpart of ``chunk_mesh``; unlike a
``jax.sharding.Mesh`` it accepts one device more than once
(``[torch.device("cpu")] * 8``, ``[torch.device("cuda:0")] * 8``), which
lets the CPU tests and a one-card machine drive the fan-out at several
shards (``ROADMAP.md`` (c) 10). The public path builds only lists of
distinct cards (``ops/codec.py`` ``DeviceCodec._sharded_decoder``).
"""

from .sharded import ShardedDecoder, chunk_devices
from .sharded_encode import ShardedEncoder

__all__ = ["ShardedDecoder", "ShardedEncoder", "chunk_devices"]
