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
from .gate import device_supported, host_supported, is_supported
from .ops import UnsupportedOnDevice
from .runtime import metrics
from .runtime.deadline import DeadlineExceeded
from .runtime.quarantine import QuarantinedRecord
from .runtime.quarantine import last as last_quarantine
# bound from runtime (not the .telemetry CLI shim): `-m
# pyruhvro_tpu_torch.telemetry` must find its module un-imported, or
# runpy warns about double execution; both names expose the same
# functions
from .runtime import telemetry
from .schema import parse_schema, to_arrow_schema

__version__ = "0.1.0"

__all__ = [
    "deserialize_array",
    "deserialize_array_threaded",
    "deserialize_array_threaded_spawn",
    "serialize_record_batch",
    "serialize_record_batch_spawn",
    "is_supported",
    "host_supported",
    "device_supported",
    "last_quarantine",
    "BatchTooLarge",
    "DeadlineExceeded",
    "DeviceCapacityExceeded",
    "MalformedAvro",
    "QuarantinedRecord",
    "UnsupportedOnDevice",
    "parse_schema",
    "to_arrow_schema",
    "metrics",
    "telemetry",
    "__version__",
]
