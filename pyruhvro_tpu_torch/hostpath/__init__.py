"""The native host tier (port of ``pyruhvro_tpu/hostpath/``): the schema
lowers to a flat opcode program (:mod:`.program`) that the C++ VM
(``csrc/host/``) runs, decoding straight into Arrow's layout and encoding
straight off Arrow's buffers (:mod:`.codec`)."""

from .codec import NativeHostCodec

__all__ = ["NativeHostCodec"]
