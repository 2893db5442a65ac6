"""Seeded test data for the port (copy of ``pyruhvro_tpu/utils/datagen.py:111,127,150,181``).

``random_value`` produces value trees (record→dict, map→list[(k, v)],
union→(branch, value)); ``compile_writer``, the host oracle's writer
(:mod:`..fallback.encoder`), turns them into Avro wire bytes.
``kafka_style_datums`` is the 9-field Kafka workload of upstream's
``scripts/generate_avro.py`` (Faker-free).
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
    "KAFKA_SCHEMA_JSON",
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
