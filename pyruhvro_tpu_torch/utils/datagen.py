"""Seeded test data for the port (copy of ``pyruhvro_tpu/utils/datagen.py``,
and of ``mutate_corpus`` in ``tests/test_fuzz_malformed.py:39``).

``random_value`` produces value trees (record→dict, map→list[(k, v)],
union→(branch, value)); ``compile_writer``, the host oracle's writer
(:mod:`..fallback.encoder`), turns them into Avro wire bytes.
``kafka_style_datums`` is the 9-field Kafka workload of upstream's
``scripts/generate_avro.py`` (Faker-free). ``synthetic_schema_variant``,
``random_schema``, ``WIDENED_SCHEMA_JSON`` and ``widened_datums`` draw
from their ``random.Random`` in the reference's order, so every seed
gives the reference's strings and bytes; ``mutate_corpus`` corrupts a
corpus as the reference's malformed fuzz does.
"""

from __future__ import annotations

import random
import string as _string
import struct
from typing import List

from ..fallback.encoder import compile_writer
from ..schema.model import (
    Array,
    AvroType,
    Enum,
    Fixed,
    Map,
    Primitive,
    Record,
    Union,
)

__all__ = [
    "random_value",
    "random_datums",
    "kafka_style_datums",
    "compile_writer",
    "synthetic_schema_variant",
    "random_schema",
    "mutate_corpus",
    "widened_datums",
    "KAFKA_SCHEMA_JSON",
    "WIDENED_SCHEMA_JSON",
    "CRITERION_SHAPES",
]


# -- value generation ---------------------------------------------------------

_WORDS = (
    "alpha bravo charlie delta echo foxtrot golf hotel india juliett kilo lima "
    "mike november oscar papa quebec romeo sierra tango uniform victor whiskey "
    "xray yankee zulu amber birch cedar dune ember flint grove harbor inlet"
).split()


def _word(rng) -> str:
    return rng.choice(_WORDS)


def _text(rng, lo=0, hi=24) -> str:
    n = rng.randint(lo, hi)
    return "".join(rng.choice(_string.ascii_letters + _string.digits + " _@.")
                   for _ in range(n))


def random_value(t: AvroType, rng: random.Random, depth: int = 0):
    if isinstance(t, Primitive):
        name = t.name
        if name == "null":
            return None
        if name == "boolean":
            return rng.random() < 0.5
        if name == "int":
            if t.logical is not None:
                return rng.randint(0, 20_000)
            return rng.randint(-(2**31), 2**31 - 1)
        if name == "long":
            if t.logical is not None:
                return rng.randint(0, 2**41)
            return rng.randint(-(2**63), 2**63 - 1)
        if name == "float":
            # keep float32-representable to make round trips exact
            v = rng.uniform(-1e6, 1e6)
            return struct.unpack("<f", struct.pack("<f", v))[0]
        if name == "double":
            return rng.uniform(-1e12, 1e12)
        if name == "bytes":
            if t.logical == "decimal":
                return rng.randint(-(10**t.precision) + 1, 10**t.precision - 1)
            return bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 16)))
        if name == "string":
            if t.logical == "uuid":
                import uuid
                return str(uuid.UUID(int=rng.getrandbits(128)))
            return _text(rng)
        raise NotImplementedError(name)
    if isinstance(t, Fixed):
        if t.logical == "decimal":
            return rng.randint(-(10**t.precision) + 1, 10**t.precision - 1)
        return bytes(rng.getrandbits(8) for _ in range(t.size))
    if isinstance(t, Enum):
        return rng.choice(t.symbols)
    if isinstance(t, Array):
        n = rng.randint(0, 4 if depth < 2 else 1)
        return [random_value(t.items, rng, depth + 1) for _ in range(n)]
    if isinstance(t, Map):
        n = rng.randint(0, 4 if depth < 2 else 1)
        # distinct keys: Avro maps are logically string→value
        keys = rng.sample(_WORDS, n)
        return [(k, random_value(t.values, rng, depth + 1)) for k in keys]
    if isinstance(t, Union):
        idx = rng.randrange(len(t.variants))
        return (idx, random_value(t.variants[idx], rng, depth + 1))
    if isinstance(t, Record):
        return {f.name: random_value(f.type, rng, depth + 1) for f in t.fields}
    raise NotImplementedError(repr(t))


def random_datums(t: AvroType, n: int, seed: int = 0) -> List[bytes]:
    """n random wire-encoded datums of schema ``t``."""
    rng = random.Random(seed)
    writer = compile_writer(t)
    out = []
    for _ in range(n):
        buf = bytearray()
        writer(buf, random_value(t, rng))
        out.append(bytes(buf))
    return out


# The four schema shapes of the reference's criterion benchmark suite
# (``ruhvro/benches/common/mod.rs:37-165``), reproduced by shape (not
# copied): flat primitives, nullable primitives, a nested struct, and an
# array+map pair. bench.py runs each × {1k, 10k} rows × backends.
CRITERION_SHAPES = {
    "flat_primitives": """{"type":"record","name":"FlatPrimitives","fields":[
        {"name":"id","type":"long"},{"name":"count","type":"int"},
        {"name":"score","type":"double"},{"name":"weight","type":"float"},
        {"name":"flag","type":"boolean"},{"name":"label","type":"string"}]}""",
    "nullable_primitives": """{"type":"record","name":"NullablePrimitives","fields":[
        {"name":"id","type":["null","long"]},
        {"name":"label","type":["null","string"]},
        {"name":"score","type":["null","double"]},
        {"name":"flag","type":["null","boolean"]}]}""",
    "nested_struct": """{"type":"record","name":"Outer","fields":[
        {"name":"id","type":"long"},
        {"name":"inner","type":{"type":"record","name":"Inner","fields":[
            {"name":"name","type":"string"},
            {"name":"value","type":["null","int"]}]}},
        {"name":"maybe","type":["null",{"type":"record","name":"Inner2",
            "fields":[{"name":"x","type":"double"}]}]}]}""",
    "array_and_map": """{"type":"record","name":"ArrayAndMap","fields":[
        {"name":"tags","type":{"type":"array","items":"string"}},
        {"name":"metrics","type":{"type":"map","values":"double"}}]}""",
}


KAFKA_SCHEMA_JSON = """\
{
  "type": "record",
  "name": "User",
  "fields": [
    {"name": "name", "type": ["null", "string"], "default": null},
    {"name": "age", "type": ["null", "int"], "default": null},
    {"name": "emails", "type": {"type": "array", "items": "string"}},
    {"name": "address", "type": ["null", {
      "type": "record", "name": "Address",
      "fields": [
        {"name": "street", "type": "string"},
        {"name": "city", "type": "string"},
        {"name": "zipcode", "type": "string"}
      ]}], "default": null},
    {"name": "phone_numbers", "type": {"type": "map", "values": "string"}},
    {"name": "preferences", "type": ["null", {
      "type": "record", "name": "Preferences",
      "fields": [
        {"name": "contact_method", "type": ["null", "string"], "default": null},
        {"name": "newsletter", "type": "boolean"}
      ]}], "default": null},
    {"name": "status", "type": ["null", "string", "int", "boolean"], "default": null},
    {"name": "created_at", "type": "long"},
    {"name": "class", "type": {"type": "enum", "name": "enum_col",
                               "symbols": ["A", "B", "C"]}}
  ]
}
"""


def kafka_style_datums(n: int, seed: int = 0) -> List[bytes]:
    """Workload equivalent to ``scripts/generate_avro.py`` (Faker-free):
    same 9-field Kafka-style schema, realistic-ish field distributions
    (``generate_avro.py:44-63``)."""
    from ..schema.parser import parse_schema

    t = parse_schema(KAFKA_SCHEMA_JSON)
    rng = random.Random(seed)
    writer = compile_writer(t)
    out = []
    for _ in range(n):
        rec = {
            "name": (1, f"{_word(rng).title()} {_word(rng).title()}")
                    if rng.random() < 0.5 else None,
            "age": (1, rng.randint(18, 80)) if rng.random() < 0.5 else None,
            "emails": [f"{_word(rng)}{rng.randint(0,99)}@example.com"
                       for _ in range(rng.randint(0, 3))],
            "address": (1, {
                "street": f"{rng.randint(1,9999)} {_word(rng).title()} St",
                "city": _word(rng).title(),
                "zipcode": f"{rng.randint(10000,99999)}",
            }) if rng.random() < 0.5 else None,
            "phone_numbers": [
                (k, f"+1-{rng.randint(200,999)}-{rng.randint(1000,9999)}")
                for k in rng.sample(_WORDS, rng.randint(0, 3))
            ],
            "preferences": (1, {
                "contact_method": (1, rng.choice(["email", "phone"]))
                                  if rng.random() < 0.67 else None,
                "newsletter": rng.random() < 0.5,
            }) if rng.random() < 0.5 else None,
            "status": rng.choice([
                (0, None),
                (1, _word(rng)),
                (2, rng.randint(0, 100)),
                (3, rng.random() < 0.5),
            ]),
            "created_at": rng.randint(1_600_000_000, 1_800_000_000),
            "class": rng.choice(["A", "B", "C"]),
        }
        buf = bytearray()
        writer(buf, rec)
        out.append(bytes(buf))
    return out


def synthetic_schema_variant(i: int) -> str:
    """Schema #i of the schema-churn population: thousands
    of DISTINCT schema strings (distinct fingerprints, distinct cache
    entries) that are individually cheap to parse, lower and decode —
    the "millions of users means thousands of schemas" traffic shape
    the cache-lifecycle soak (``scripts/torch_mem_soak.py``) drives. Field
    names vary with ``i`` so no two variants share a schema string."""
    import json

    return json.dumps({
        "type": "record", "name": f"Churn{i}",
        "fields": [
            {"name": f"id_{i % 7}", "type": "long"},
            {"name": f"label_{i % 5}", "type": "string"},
            {"name": f"score_{i % 3}", "type": "double"},
            {"name": "flag", "type": "boolean"},
        ],
    })


# ---------------------------------------------------------------------------
# Random schema generation (differential-fuzz harness)
# ---------------------------------------------------------------------------

def random_schema(seed: int, max_depth: int = 3) -> str:
    """A random record schema drawn from the native host subset (the
    differential strategy, extended from fixed shapes to generated
    ones). Respects Avro's union rules: no nested unions, at
    most one variant per unnamed kind. ``duration`` is excluded — its
    random 12-byte fixeds overflow the oracle's Duration(ms) int64 by
    construction (covered by targeted tests instead); decimals stay
    within precision so both paths are exact."""
    import json as _json

    rng = random.Random(seed)
    counter = [0]

    def fresh(prefix):
        counter[0] += 1
        return f"{prefix}{counter[0]}"

    LEAVES = [
        "string", "bytes", "int", "long", "float", "double", "boolean",
        {"type": "int", "logicalType": "date"},
        {"type": "long", "logicalType": "timestamp-millis"},
        {"type": "long", "logicalType": "timestamp-micros"},
        {"type": "int", "logicalType": "time-millis"},
        {"type": "long", "logicalType": "time-micros"},
        {"type": "long", "logicalType": "local-timestamp-millis"},
        {"type": "long", "logicalType": "local-timestamp-micros"},
        {"type": "string", "logicalType": "uuid"},
    ]

    def gen_type(depth, allow_union=True):
        roll = rng.random()
        if depth >= max_depth or roll < 0.45:
            leaf = rng.choice(LEAVES + [None, None])  # None → named leaf
            if leaf is not None:
                return leaf
            named = rng.random()
            if named < 0.34:
                return {"type": "enum", "name": fresh("E"),
                        "symbols": ["A", "B", "C", "D"][: rng.randint(2, 4)]}
            if named < 0.67:
                return {"type": "fixed", "name": fresh("F"),
                        "size": rng.randint(1, 16)}
            prec = rng.randint(1, 18)
            if rng.random() < 0.5:
                return {"type": "bytes", "logicalType": "decimal",
                        "precision": prec, "scale": rng.randint(0, prec)}
            return {"type": "fixed", "name": fresh("FD"), "size": 16,
                    "logicalType": "decimal", "precision": prec,
                    "scale": rng.randint(0, prec)}
        if roll < 0.60:
            return {"type": "array", "items": gen_type(depth + 1)}
        if roll < 0.72:
            return {"type": "map", "values": gen_type(depth + 1)}
        if roll < 0.84:
            return {"type": "record", "name": fresh("R"), "fields": [
                {"name": f"f{i}", "type": gen_type(depth + 1)}
                for i in range(rng.randint(1, 3))
            ]}
        if allow_union:
            if rng.random() < 0.6:  # nullable pair
                inner = gen_type(depth + 1, allow_union=False)
                pair = ["null", inner]
                rng.shuffle(pair)
                return pair
            # sparse union: distinct kinds only
            kinds = rng.sample(
                ["null", "string", "long", "boolean", "double"],
                rng.randint(2, 4),
            )
            return kinds
        return rng.choice(["string", "long", "double"])

    fields = [
        {"name": f"c{i}", "type": gen_type(0)}
        for i in range(rng.randint(1, 6))
    ]
    return _json.dumps(
        {"type": "record", "name": f"Fuzz{seed}", "fields": fields}
    )


# ---------------------------------------------------------------------------
# widened-surface workload (beyond the reference's fast subset)
# ---------------------------------------------------------------------------

WIDENED_SCHEMA_JSON = """\
{
  "type": "record",
  "name": "Wide",
  "fields": [
    {"name": "b", "type": "bytes"},
    {"name": "nb", "type": ["null", "bytes"]},
    {"name": "f8", "type": {"type": "fixed", "name": "F8", "size": 8}},
    {"name": "nf", "type": ["null", {"type": "fixed", "name": "F3", "size": 3}]},
    {"name": "uid", "type": {"type": "string", "logicalType": "uuid"}},
    {"name": "dur", "type": {"type": "fixed", "name": "Dur", "size": 12,
                             "logicalType": "duration"}},
    {"name": "dec", "type": {"type": "bytes", "logicalType": "decimal",
                             "precision": 20, "scale": 4}},
    {"name": "ndec", "type": ["null", {"type": "bytes", "logicalType": "decimal",
                              "precision": 10, "scale": 2}]},
    {"name": "decf", "type": {"type": "fixed", "name": "DF", "size": 9,
                              "logicalType": "decimal", "precision": 16,
                              "scale": 2}},
    {"name": "tm", "type": {"type": "int", "logicalType": "time-millis"}},
    {"name": "tu", "type": {"type": "long", "logicalType": "time-micros"}},
    {"name": "lts", "type": {"type": "long",
                             "logicalType": "local-timestamp-micros"}},
    {"name": "ab", "type": {"type": "array", "items": "bytes"}}
  ]
}
"""


def widened_datums(n: int, seed: int = 0) -> List[bytes]:
    """Wire datums over the WIDENED type surface — the types the
    reference serves only via its Value-tree fallback (bytes, fixed,
    uuid, duration, decimal, time-*), here first-class on every backend.
    Values stay in-range (duration under int64 ms, decimals within
    precision) so all paths and the oracle agree exactly."""
    import uuid as _uuid

    rng = random.Random(seed)
    out = []

    def vint(buf, v):
        z = (v << 1) ^ (v >> 63) if v < 0 else v << 1
        while z >= 0x80:
            buf.append((z & 0x7F) | 0x80)
            z >>= 7
        buf.append(z)

    def wbytes(buf, b):
        vint(buf, len(b))
        buf += b

    for _ in range(n):
        buf = bytearray()
        wbytes(buf, rng.randbytes(rng.randrange(0, 24)))          # b
        if rng.random() < 0.3:
            vint(buf, 0)                                          # nb null
        else:
            vint(buf, 1)
            wbytes(buf, rng.randbytes(5))
        buf += rng.randbytes(8)                                   # f8
        if rng.random() < 0.5:
            vint(buf, 0)                                          # nf null
        else:
            vint(buf, 1)
            buf += rng.randbytes(3)
        wbytes(buf, str(_uuid.UUID(int=rng.getrandbits(128)))
               .encode())                                         # uid
        for comp in (rng.randrange(0, 12), rng.randrange(0, 28),
                     rng.randrange(0, 86_400_000)):               # dur
            buf += comp.to_bytes(4, "little")
        v = rng.randrange(-(10 ** 19), 10 ** 19)                  # dec
        nb_ = max((abs(v).bit_length() + 8) // 8, 1)
        wbytes(buf, v.to_bytes(nb_, "big", signed=True))
        if rng.random() < 0.4:
            vint(buf, 0)                                          # ndec null
        else:
            vint(buf, 1)
            v = rng.randrange(-(10 ** 9), 10 ** 9)
            nb_ = max((abs(v).bit_length() + 8) // 8, 1)
            wbytes(buf, v.to_bytes(nb_, "big", signed=True))
        v = rng.randrange(-(10 ** 15), 10 ** 15)                  # decf
        buf += v.to_bytes(9, "big", signed=True)
        vint(buf, rng.randrange(0, 86_400_000))                   # tm
        vint(buf, rng.randrange(0, 86_400_000_000))               # tu
        vint(buf, rng.randrange(0, 2 ** 50))                      # lts
        cnt = rng.randrange(0, 4)                                 # ab
        if cnt:
            vint(buf, cnt)
            for _i in range(cnt):
                wbytes(buf, rng.randbytes(rng.randrange(0, 6)))
        vint(buf, 0)
        out.append(bytes(buf))
    return out


def mutate_corpus(datums: List[bytes], seed: int,
                  rate: float = 0.35) -> List[bytes]:
    """Deterministically corrupt about ``rate`` of the corpus:
    truncations, bit flips, and splices of bytes from sibling datums
    (the reference's ``tests/test_fuzz_malformed.py:39``)."""
    rng = random.Random(seed)
    out = []
    for d in datums:
        if rng.random() >= rate or not d:
            out.append(d)
            continue
        kind = rng.randrange(3)
        b = bytearray(d)
        if kind == 0:  # truncate
            b = b[: rng.randrange(len(b))]
        elif kind == 1:  # bit-flip 1..3 bytes
            for _ in range(rng.randint(1, 3)):
                i = rng.randrange(len(b))
                b[i] ^= 1 << rng.randrange(8)
        else:  # splice a window from another datum (or noise)
            src = datums[rng.randrange(len(datums))] or b"\xff\x80\x7f"
            a = rng.randrange(len(b))
            w = rng.randint(1, min(8, len(src)))
            s = rng.randrange(max(len(src) - w, 0) + 1)
            b[a : a + w] = src[s : s + w]
        out.append(bytes(b))
    return out
