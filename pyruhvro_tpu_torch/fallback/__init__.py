"""The host oracle (copy of ``pyruhvro_tpu/fallback/``): the pure-Python
Avro decoder and encoder the device tier is held against, served to
callers by ``backend="host"``."""

from .decoder import compile_reader, decode_records, decode_to_record_batch
from .encoder import compile_writer, encode_record_batch, extract_rows
from .io import MalformedAvro

__all__ = [
    "MalformedAvro",
    "decode_to_record_batch",
    "decode_records",
    "compile_reader",
    "encode_record_batch",
    "compile_writer",
    "extract_rows",
]
