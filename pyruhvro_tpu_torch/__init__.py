"""pyruhvro_tpu_torch — the PyTorch/CUDA port of ``pyruhvro_tpu``.

Avro wire bytes → Arrow RecordBatches on an NVIDIA Hopper GPU. The
decode walk is a CUDA kernel (``csrc/walk_decode.cu``) built with ``nvcc``
on first use; ``device="cpu"`` runs the same field program as plain
PyTorch. The package imports torch, numpy and pyarrow, and nothing of
JAX or of ``pyruhvro_tpu``.
"""

from .api import deserialize_array, deserialize_array_threaded
from .errors import BatchTooLarge, MalformedAvro
from .ops import UnsupportedOnDevice

__all__ = [
    "deserialize_array",
    "deserialize_array_threaded",
    "BatchTooLarge",
    "MalformedAvro",
    "UnsupportedOnDevice",
]
