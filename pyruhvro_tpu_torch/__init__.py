"""pyruhvro_tpu_torch — the PyTorch/CUDA port of ``pyruhvro_tpu``.

Avro wire bytes → Arrow RecordBatches and back on an NVIDIA Hopper GPU,
through the reference's five public functions and their keywords
(``backend``, ``on_error``, ``return_errors``, ``timeout_s``; see
:mod:`.api`). The default decode engine runs the walk and the finalize as
CUDA kernels (``csrc/decode_walk.cu``, ``csrc/decode_finalize.cu``);
under ``PYRUHVRO_TPU_PALLAS=1`` the row-padded walk
(``csrc/walk_decode.cu``) serves schemas without nested arrays/maps.
``serialize_record_batch`` encodes with ``csrc/encode.cu``. The kernels
build with ``nvcc`` on first use; ``device="cpu"`` runs their plain
PyTorch versions, and ``backend="host"`` the pure-Python oracle
(:mod:`.fallback`). The package imports torch, numpy and pyarrow, and
nothing of JAX or of ``pyruhvro_tpu``.
"""

from .api import (
    deserialize_array,
    deserialize_array_threaded,
    deserialize_array_threaded_spawn,
    serialize_record_batch,
    serialize_record_batch_spawn,
)
from .errors import BatchTooLarge, DeviceCapacityExceeded, MalformedAvro
from .ops import UnsupportedOnDevice
from .runtime.deadline import DeadlineExceeded
from .runtime.quarantine import QuarantinedRecord
from .runtime.quarantine import last as last_quarantine

__all__ = [
    "deserialize_array",
    "deserialize_array_threaded",
    "deserialize_array_threaded_spawn",
    "serialize_record_batch",
    "serialize_record_batch_spawn",
    "last_quarantine",
    "BatchTooLarge",
    "DeadlineExceeded",
    "DeviceCapacityExceeded",
    "MalformedAvro",
    "QuarantinedRecord",
    "UnsupportedOnDevice",
]
