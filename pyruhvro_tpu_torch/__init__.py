"""pyruhvro_tpu_torch — the PyTorch/CUDA port of ``pyruhvro_tpu``.

Avro wire bytes → Arrow RecordBatches and back on an NVIDIA Hopper GPU.
The default decode engine runs the walk and the finalize as CUDA kernels
(``csrc/decode_walk.cu``, ``csrc/decode_finalize.cu``); under
``PYRUHVRO_TPU_PALLAS=1`` the row-padded walk (``csrc/walk_decode.cu``)
serves schemas without nested arrays/maps. ``serialize_record_batch``
encodes with ``csrc/encode.cu``. The kernels build with
``nvcc`` on first use; ``device="cpu"`` runs their plain PyTorch
versions. The package imports torch, numpy and pyarrow, and nothing of
JAX or of ``pyruhvro_tpu``.
"""

from .api import (
    deserialize_array,
    deserialize_array_threaded,
    serialize_record_batch,
)
from .errors import BatchTooLarge, DeviceCapacityExceeded, MalformedAvro
from .ops import UnsupportedOnDevice

__all__ = [
    "deserialize_array",
    "deserialize_array_threaded",
    "serialize_record_batch",
    "BatchTooLarge",
    "DeviceCapacityExceeded",
    "MalformedAvro",
    "UnsupportedOnDevice",
]
