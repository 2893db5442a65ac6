"""Avro wire-format primitives as plain PyTorch (port of ``pyruhvro_tpu/ops/varint.py``).

The error bits, names and slugs are the reference's. The readers mirror
its vectorized JAX readers (``varint.py:106-221``): every helper works
on a vector of per-record cursors, one lane per record, advances cursors
only where ``mask`` is set and never faults; malformed input surfaces as
per-lane error bits.

Representation: torch has no full unsigned 32-bit arithmetic, so a u32
value is an ``int64`` tensor holding 0..2^32-1, and an i32 value (a
cursor) is an ``int64`` tensor holding the two's-complement value,
re-wrapped with :func:`wrap_i32` after every add — the reference adds
cursors in wrapping int32, and the port must read the same bytes.

Two byte sources give the readers their bytes (both little-endian u32
words; a read at byte ``k`` of the window at cursor ``c``, read as
unsigned, takes word ``(c >> 2) + (((c & 3) + k) >> 2)``):

* :class:`RowWords`, records packed row-padded as ``[R, BW*4]`` uint8:
  the word is clipped to ``BW - 1`` of the lane's own row (the Pallas
  walk's ``_TileWords.take_words``);
* :class:`FlatWords`, the pipeline's one flat word buffer of the whole
  batch (``jnp.take(words, widx, mode="clip")``, ``varint.py:92-114``):
  cursors are absolute, a read past a record's end sees the next
  record's bytes, and the word is clipped to the buffer's last word (a
  negative index would clip to word 0; the unsigned shift gives none).
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = [
    "RowWords",
    "FlatWords",
    "wrap_i32",
    "get_byte",
    "load_window",
    "read_varint64",
    "read_varint32",
    "zigzag_decode_pair",
    "outside_i32",
    "read_f32",
    "read_f64_pair",
    "read_bool_byte",
    "ERR_VARINT",
    "ERR_NEG_LEN",
    "ERR_OVERRUN",
    "ERR_BAD_BRANCH",
    "ERR_BAD_ENUM",
    "ERR_TRAILING",
    "ERR_BAD_BOOL",
    "ERR_ITEM_OVERFLOW",
    "ERR_DEC_RANGE",
    "ERR_INT_RANGE",
    "ERR_NAMES",
    "ERR_SLUGS",
]

U32 = 0xFFFFFFFF

# per-lane error bits, OR-accumulated during the walk and checked on host
ERR_VARINT = 1 << 0        # varint longer than the wire maximum (10 bytes)
ERR_NEG_LEN = 1 << 1       # negative string/bytes length
ERR_OVERRUN = 1 << 2       # cursor ran past the record's end
ERR_BAD_BRANCH = 1 << 3    # union branch index out of range
ERR_BAD_ENUM = 1 << 4      # enum index out of range
ERR_TRAILING = 1 << 5      # datum not fully consumed (trailing bytes)
ERR_BAD_BOOL = 1 << 6      # boolean byte not 0/1
ERR_ITEM_OVERFLOW = 1 << 7 # array/map items exceeded the slot cap (retry)
ERR_DEC_RANGE = 1 << 8     # decimal outside decimal128 (host VM only)
ERR_INT_RANGE = 1 << 9     # an Avro int whose varint lies past int32

ERR_NAMES = {
    ERR_VARINT: "varint longer than 10 bytes",
    ERR_NEG_LEN: "negative string/bytes length",
    ERR_OVERRUN: "value runs past end of datum",
    ERR_BAD_BRANCH: "union branch index out of range",
    ERR_BAD_ENUM: "enum index out of range",
    ERR_TRAILING: "trailing bytes after datum",
    ERR_BAD_BOOL: "invalid boolean byte",
    ERR_ITEM_OVERFLOW: "array/map item capacity overflow",
    ERR_DEC_RANGE: "decimal outside decimal128 range",
    ERR_INT_RANGE: "int outside the int32 range",
}

# short machine-stable slugs (MalformedAvro.err_name)
ERR_SLUGS = {
    ERR_VARINT: "varint",
    ERR_NEG_LEN: "neg_len",
    ERR_OVERRUN: "overrun",
    ERR_BAD_BRANCH: "bad_branch",
    ERR_BAD_ENUM: "bad_enum",
    ERR_TRAILING: "trailing",
    ERR_BAD_BOOL: "bad_bool",
    ERR_ITEM_OVERFLOW: "item_overflow",
    ERR_DEC_RANGE: "dec_range",
    ERR_INT_RANGE: "int_range",
}


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 tensor to the int32 two's-complement range."""
    return ((x + (1 << 31)) & U32) - (1 << 31)


class RowWords:
    """Byte source over row-padded records ``[R, BW*4]`` uint8."""

    def __init__(self, rows: torch.Tensor):
        n_rows, row_bytes = rows.shape
        self.flat = rows.reshape(-1)
        self.base = torch.arange(n_rows, dtype=torch.int64,
                                 device=rows.device) * row_bytes
        self.last_word = row_bytes // 4 - 1

    def window_byte(self, cursor: torch.Tensor, k: int) -> torch.Tensor:
        """Byte ``k`` of the window at ``cursor``, one per lane, as int64."""
        c = cursor & U32
        m = (c & 3) + k
        w = torch.clamp((c >> 2) + (m >> 2), max=self.last_word)
        return self.flat[self.base + 4 * w + (m & 3)].to(torch.int64)


class FlatWords:
    """Byte source over one flat buffer of ``B`` bytes (``B % 4 == 0``),
    indexed by absolute cursors with the pipeline's clip semantics."""

    def __init__(self, flat: torch.Tensor):
        self.flat = flat.reshape(-1).view(torch.uint8)
        self.last_word = self.flat.numel() // 4 - 1

    def window_byte(self, cursor: torch.Tensor, k: int) -> torch.Tensor:
        """Byte ``k`` of the window at ``cursor``, one per lane, as int64."""
        c = cursor & U32
        m = (c & 3) + k
        w = torch.clamp((c >> 2) + (m >> 2), 0, self.last_word)
        return self.flat[4 * w + (m & 3)].to(torch.int64)


Words = Union[RowWords, FlatWords]


def get_byte(words: Words, idx: torch.Tensor) -> torch.Tensor:
    """Byte ``idx`` of each lane's row (clip semantics), as int64."""
    return words.window_byte(idx, 0)


def load_window(words: Words, cursor: torch.Tensor, nwords: int):
    """``nwords - 1`` u32 words whose byte 0 is the byte at ``cursor``
    (the reference gathers ``nwords`` words and funnel-shifts them)."""
    out = []
    for j in range(nwords - 1):
        v = torch.zeros_like(cursor)
        for b in range(4):
            v = v | (words.window_byte(cursor, 4 * j + b) << (8 * b))
        out.append(v)
    return out


def _read_varint(words: Words, cursor, mask, max_bytes: int):
    lo = torch.zeros_like(cursor)
    hi = torch.zeros_like(cursor)
    more = mask.clone()
    nbytes = torch.zeros_like(cursor)
    for k in range(max_bytes):
        if not bool(more.any()):
            break  # every later byte would be masked out
        b = words.window_byte(cursor, k)
        g = b & 0x7F
        s = 7 * k
        if s < 32:
            lo = lo | torch.where(more, (g << s) & U32, 0)
            if s + 7 > 32:  # the straddling group (k=4, bits 28..34)
                hi = hi | torch.where(more, g >> (32 - s), 0)
        else:
            hi = hi | torch.where(more, (g << (s - 32)) & U32, 0)
        nbytes = nbytes + more.to(torch.int64)
        more = more & (b >= 0x80)
    err = torch.where(more, ERR_VARINT, 0)
    return lo, hi, wrap_i32(cursor + nbytes), err


def read_varint64(words: Words, cursor, mask):
    """One unsigned LEB128 varint (≤ 10 bytes) per active lane:
    ``(lo u32, hi u32, new_cursor i32, err u32)``."""
    return _read_varint(words, cursor, mask, 10)


# callers of this name check that the value fits 32 bits (union branches,
# enum indices, string lengths, block counts); the wire read is the same
read_varint32 = read_varint64


def zigzag_decode_pair(lo, hi):
    """Zig-zag decode a u32 pair: ``(n >> 1) ^ -(n & 1)`` in 64-bit
    two's complement carried as two u32 words."""
    m = (lo & 1) * U32  # 0x00000000 or 0xFFFFFFFF
    lo1 = (lo >> 1) | ((hi << 31) & U32)
    hi1 = hi >> 1
    return lo1 ^ m, hi1 ^ m


def outside_i32(lo, hi):
    """True where a zig-zag decoded u32 pair lies past int32: its high
    word is not the sign extension of its low one (an Avro ``int`` read
    there sets ERR_INT_RANGE)."""
    return hi != (lo >> 31) * U32


def read_f32(words: Words, cursor, mask):
    """IEEE-754 float32 bits (u32), little-endian."""
    (v,) = load_window(words, cursor, 2)
    return v, wrap_i32(cursor + torch.where(mask, 4, 0))


def read_f64_pair(words: Words, cursor, mask):
    """IEEE-754 float64 as a (lo, hi) u32 pair."""
    lo, hi = load_window(words, cursor, 3)
    return lo, hi, wrap_i32(cursor + torch.where(mask, 8, 0))


def read_bool_byte(words: Words, cursor, mask):
    """One boolean byte; bytes > 1 set ERR_BAD_BOOL."""
    b = get_byte(words, cursor)
    err = torch.where(mask & (b > 1), ERR_BAD_BOOL, 0)
    return b, wrap_i32(cursor + torch.where(mask, 1, 0)), err
