"""Avro wire-format primitives of the host oracle (copy of
``pyruhvro_tpu/fallback/io.py``).

The byte-level readers and writers mirror upstream's
``fast_decode.rs:846-922`` and ``fast_encode.rs:586-599`` with the same
malformed-input policy: bounds are checked and ``MalformedAvro`` (a
``ValueError``) is raised rather than crashing. ``MalformedAvro`` and
``shift_malformed`` are the port's own (:mod:`..errors`), so one class
exists across the oracle and the device tier.

Avro spec recap (wire format):
* int/long: little-endian base-128 varint of the zig-zag encoding
* float/double: 4/8 bytes IEEE-754 little-endian
* boolean: one byte 0/1
* bytes/string: length (long) then payload
* fixed: exactly N bytes
"""

from __future__ import annotations

import struct

from ..errors import MalformedAvro, shift_malformed
from ..runtime import knobs

__all__ = [
    "MalformedAvro",
    "malformed_record",
    "shift_malformed",
    "max_datum_bytes",
    "MAX_ZERO_WIDTH_ITEMS",
    "read_varint",
    "read_long",
    "read_float",
    "read_double",
    "read_bool",
    "read_bytes",
    "zigzag_encode",
    "zigzag_decode",
    "write_long",
    "write_float",
    "write_double",
    "write_bool",
    "write_bytes",
    "long_size",
]

_unpack_f32 = struct.Struct("<f").unpack_from
_unpack_f64 = struct.Struct("<d").unpack_from
_pack_f32 = struct.Struct("<f").pack
_pack_f64 = struct.Struct("<d").pack


def malformed_record(index: int, detail: str, err_name=None, tier=None,
                     indices=None) -> MalformedAvro:
    """The uniform cross-tier error shape: ``record <global_idx>: <why>``."""
    return MalformedAvro(
        f"record {index}: {detail}",
        index=index, err_name=err_name, tier=tier, indices=indices,
    )


def max_datum_bytes() -> int:
    """The PYRUHVRO_TPU_MAX_DATUM_BYTES hostile-input ceiling (0 =
    unlimited, the default). A datum longer than this is rejected (or
    quarantined under a tolerant policy) before any decode work."""
    return knobs.get_int("PYRUHVRO_TPU_MAX_DATUM_BYTES")


# Zero-width array/map items (null / empty-record elements consume no
# wire bytes) are the one spot where a tiny datum can claim unbounded
# output: a 3-byte block header can demand 2^60 items. Items of any
# other type consume >= 1 byte each, so their counts are naturally
# bounded by the remaining datum bytes. This cap bounds the total
# zero-width items per DATUM (the reference's native VM enforces the
# same constant, so its tiers agree on accept-vs-reject).
MAX_ZERO_WIDTH_ITEMS = 1 << 20


def zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else (n << 1)


def read_varint(buf, pos: int):
    """Read an unsigned base-128 varint; returns (value, new_pos)."""
    acc = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise MalformedAvro("truncated varint", err_name="overrun")
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            return acc, pos
        shift += 7
        if shift > 63:
            raise MalformedAvro("varint too long (max 10 bytes)", err_name="varint")


def read_long(buf, pos: int):
    """Read a zig-zag varint long; returns (value, new_pos)
    (≙ ``read_zigzag_long``, ``fast_decode.rs:855-869``)."""
    acc, pos = read_varint(buf, pos)
    # wrap to signed 64-bit like the reference's u64→i64 cast
    acc &= (1 << 64) - 1
    value = (acc >> 1) ^ -(acc & 1)
    if value >= 1 << 63:
        value -= 1 << 64
    elif value < -(1 << 63):
        value += 1 << 64
    return value, pos


def read_float(buf, pos: int):
    if pos + 4 > len(buf):
        raise MalformedAvro("truncated float", err_name="overrun")
    return _unpack_f32(buf, pos)[0], pos + 4


def read_double(buf, pos: int):
    if pos + 8 > len(buf):
        raise MalformedAvro("truncated double", err_name="overrun")
    return _unpack_f64(buf, pos)[0], pos + 8


def read_bool(buf, pos: int):
    if pos >= len(buf):
        raise MalformedAvro("truncated bool", err_name="overrun")
    b = buf[pos]
    if b > 1:
        raise MalformedAvro(f"invalid bool byte {b:#x}", err_name="bad_bool")
    return b == 1, pos + 1


def read_bytes(buf, pos: int):
    ln, pos = read_long(buf, pos)
    if ln < 0:
        raise MalformedAvro(f"negative bytes/string length {ln}", err_name="neg_len")
    if ln > 0x7FFFFFFF:
        # the Arrow Binary offsets are int32, so a >2GiB single value is
        # rejected at the wire, never silently wrapped downstream (the
        # reference's native VM has the same guard)
        raise MalformedAvro(
            f"bytes/string length {ln} exceeds int32 capacity",
            err_name="overrun")
    if pos + ln > len(buf):
        raise MalformedAvro("truncated bytes/string payload", err_name="overrun")
    return bytes(buf[pos : pos + ln]), pos + ln


def long_size(value: int) -> int:
    """Number of wire bytes of a zig-zag varint for ``value``."""
    z = zigzag_encode(value)
    size = 1
    while z >= 0x80:
        z >>= 7
        size += 1
    return size


def write_long(out: bytearray, value: int) -> None:
    if not -(1 << 63) <= value < (1 << 63):
        raise ValueError(f"value {value} out of int64 range for Avro long")
    z = zigzag_encode(value) & ((1 << 64) - 1)
    while z >= 0x80:
        out.append((z & 0x7F) | 0x80)
        z >>= 7
    out.append(z)


def write_float(out: bytearray, value: float) -> None:
    out += _pack_f32(value)


def write_double(out: bytearray, value: float) -> None:
    out += _pack_f64(value)


def write_bool(out: bytearray, value: bool) -> None:
    out.append(1 if value else 0)


def write_bytes(out: bytearray, value) -> None:
    write_long(out, len(value))
    out += value
