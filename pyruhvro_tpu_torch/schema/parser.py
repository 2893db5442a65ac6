"""Avro JSON schema parser → IR (copy of ``pyruhvro_tpu/schema/parser.py``).

Implements the Avro 1.11 schema-declaration rules (names, namespaces,
aliases, logical types, named-type references) sufficient to cover
everything the reference's ``apache_avro::Schema::parse_str`` accepts in
its test/bench corpus (``ruhvro/src/deserialize.rs``, ``benches/common``),
plus named-type refs, which the reference leaves as ``todo!()``
(``schema_translate.rs:51``).

Recursive schemas are rejected: Arrow has no recursive types, and the
reference would crash on them too.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from .model import (
    LOGICAL_ON_INT,
    LOGICAL_ON_LONG,
    PRIMITIVE_NAMES,
    Array,
    AvroType,
    Enum,
    Fixed,
    Map,
    Primitive,
    Record,
    RecordField,
    Union,
)

__all__ = ["SchemaParseError", "parse_schema", "parse_schema_obj"]


class SchemaParseError(ValueError):
    pass


def parse_schema(schema_json: str) -> AvroType:
    """Parse an Avro schema from its JSON string form."""
    try:
        obj = json.loads(schema_json)
    except json.JSONDecodeError as e:
        # Bare primitive names like `"string"` must be quoted JSON; accept
        # the unquoted form too, as apache_avro does.
        if schema_json.strip() in PRIMITIVE_NAMES:
            obj = schema_json.strip()
        else:
            raise SchemaParseError(f"invalid schema JSON: {e}") from None
    return parse_schema_obj(obj)


def parse_schema_obj(obj) -> AvroType:
    """Parse an already-JSON-decoded schema object."""
    return _Parser().parse(obj, namespace=None)


class _Parser:
    def __init__(self) -> None:
        self.named: Dict[str, AvroType] = {}
        self._in_progress: set = set()

    # -- name handling -----------------------------------------------------
    @staticmethod
    def _fullname(name: str, namespace: Optional[str]) -> str:
        if "." in name or not namespace:
            return name
        return f"{namespace}.{name}"

    def parse(self, obj, namespace: Optional[str]) -> AvroType:
        if isinstance(obj, str):
            return self._parse_name(obj, namespace)
        if isinstance(obj, list):
            return self._parse_union(obj, namespace)
        if isinstance(obj, dict):
            return self._parse_dict(obj, namespace)
        raise SchemaParseError(f"unexpected schema element: {obj!r}")

    def _parse_name(self, name: str, namespace: Optional[str]) -> AvroType:
        if name in PRIMITIVE_NAMES:
            return Primitive(name)
        fullname = self._fullname(name, namespace)
        for candidate in (fullname, name):
            if candidate in self._in_progress:
                raise SchemaParseError(
                    f"recursive schema via {candidate!r} is not supported "
                    "(Arrow cannot represent recursive types)"
                )
            if candidate in self.named:
                return self.named[candidate]
        raise SchemaParseError(f"unknown type name: {name!r}")

    def _parse_union(self, variants: list, namespace: Optional[str]) -> Union:
        if not variants:
            raise SchemaParseError("union must have at least one variant")
        parsed = tuple(self.parse(v, namespace) for v in variants)
        for v in parsed:
            if isinstance(v, Union):
                raise SchemaParseError("unions may not immediately contain unions")
        n_null = sum(1 for v in parsed if v.is_null())
        if n_null > 1:
            raise SchemaParseError("union contains duplicate null variants")
        return Union(parsed)

    def _parse_dict(self, obj: dict, namespace: Optional[str]) -> AvroType:
        if "type" not in obj:
            raise SchemaParseError(f"schema object missing 'type': {obj!r}")
        t = obj["type"]
        if isinstance(t, (dict, list)):
            # {"type": {...}} wrapper
            return self.parse(t, namespace)

        logical = obj.get("logicalType")

        if t in PRIMITIVE_NAMES:
            return self._parse_primitive(t, logical, obj)
        if t == "array":
            if "items" not in obj:
                raise SchemaParseError("array schema missing 'items'")
            return Array(self.parse(obj["items"], namespace))
        if t == "map":
            if "values" not in obj:
                raise SchemaParseError("map schema missing 'values'")
            return Map(self.parse(obj["values"], namespace))
        if t == "record" or t == "error":
            return self._parse_record(obj, namespace)
        if t == "enum":
            return self._parse_enum(obj, namespace)
        if t == "fixed":
            return self._parse_fixed(obj, namespace, logical)
        # a named reference spelled as {"type": "Name"}
        return self._parse_name(t, namespace)

    @staticmethod
    def _parse_primitive(name: str, logical: Optional[str], obj: dict) -> Primitive:
        if logical is None:
            return Primitive(name)
        ok = (
            (name == "int" and logical in LOGICAL_ON_INT)
            or (name == "long" and logical in LOGICAL_ON_LONG)
            or (name == "bytes" and logical == "decimal")
            or (name == "string" and logical == "uuid")
        )
        if not ok:
            # Per spec, unknown logical types are ignored and the underlying
            # type is used (apache_avro behaves likewise for most cases).
            return Primitive(name)
        if logical == "decimal":
            return Primitive(
                name,
                logical="decimal",
                precision=int(obj.get("precision", 0)),
                scale=int(obj.get("scale", 0)),
            )
        return Primitive(name, logical=logical)

    def _name_of(self, obj: dict, namespace: Optional[str]) -> str:
        name = obj.get("name")
        if not name:
            raise SchemaParseError(f"named type missing 'name': {obj!r}")
        ns = obj.get("namespace", namespace)
        if "." in name:
            return name
        return self._fullname(name, ns)

    def _parse_record(self, obj: dict, namespace: Optional[str]) -> Record:
        fullname = self._name_of(obj, namespace)
        ns = fullname.rsplit(".", 1)[0] if "." in fullname else None
        self._in_progress.add(fullname)
        try:
            fields = []
            seen = set()
            for f in obj.get("fields", []):
                fname = f.get("name")
                if not fname:
                    raise SchemaParseError(f"record field missing 'name': {f!r}")
                if fname in seen:
                    raise SchemaParseError(f"duplicate field name {fname!r}")
                seen.add(fname)
                ftype = self.parse(f["type"], ns)
                fields.append(
                    RecordField(
                        name=fname,
                        type=ftype,
                        doc=f.get("doc"),
                        has_default="default" in f,
                        default=f.get("default"),
                        aliases=tuple(f.get("aliases", ())),
                    )
                )
        finally:
            self._in_progress.discard(fullname)
        rec = Record(
            fullname=fullname,
            fields=tuple(fields),
            doc=obj.get("doc"),
            aliases=tuple(obj.get("aliases", ())),
        )
        self.named[fullname] = rec
        return rec

    def _parse_enum(self, obj: dict, namespace: Optional[str]) -> Enum:
        fullname = self._name_of(obj, namespace)
        symbols = obj.get("symbols")
        if not isinstance(symbols, list) or not all(
            isinstance(s, str) for s in symbols
        ):
            raise SchemaParseError(f"enum {fullname!r} has invalid 'symbols'")
        if len(set(symbols)) != len(symbols):
            raise SchemaParseError(f"enum {fullname!r} has duplicate symbols")
        e = Enum(fullname=fullname, symbols=tuple(symbols), doc=obj.get("doc"))
        self.named[fullname] = e
        return e

    def _parse_fixed(
        self, obj: dict, namespace: Optional[str], logical: Optional[str]
    ) -> Fixed:
        fullname = self._name_of(obj, namespace)
        size = obj.get("size")
        if not isinstance(size, int) or size < 0:
            raise SchemaParseError(f"fixed {fullname!r} has invalid 'size'")
        if logical == "duration" and size != 12:
            logical = None
        if logical not in (None, "decimal", "duration"):
            logical = None
        f = Fixed(
            fullname=fullname,
            size=size,
            logical=logical,
            precision=int(obj.get("precision", 0)) if logical == "decimal" else 0,
            scale=int(obj.get("scale", 0)) if logical == "decimal" else 0,
        )
        self.named[fullname] = f
        return f
