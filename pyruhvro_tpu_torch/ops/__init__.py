"""Device decode and encode ops of the PyTorch/CUDA port (counterpart of
``pyruhvro_tpu/ops/``).

* :mod:`.varint`      — error bits and the plain PyTorch wire readers
* :mod:`.fieldprog`   — Avro schema IR → field program (buffers + code)
* :mod:`.walk_decode` — the walk: CUDA kernel on the card, plain walk on CPU
* :mod:`.decode`      — the pipeline engine: walk and finalize kernels
* :mod:`.arrow_build` — walk outputs → ``pyarrow`` arrays
* :mod:`.encode_extract` — Arrow batch → the encoder's input lanes
* :mod:`.encode`      — the encode program: CUDA kernels on the card
* :mod:`.codec`       — ``get_device_codec(entry, device)``, used by ``api.py``

Submodules import torch; importing this package does not.
"""

__all__ = ["UnsupportedOnDevice"]


class UnsupportedOnDevice(ValueError):
    """Schema or batch is valid but outside what the device walk takes
    (nested repetition, records over the row-width limit, item counts
    past the cap ladder). The port has no host tier yet, so this error
    reaches the caller."""
