"""The port's lowering held against the reference's, on the CPU.

``pyruhvro_tpu_torch.ops.fieldprog.lower`` must give the same ``Program``
contract as ``pyruhvro_tpu.ops.fieldprog.lower``: every buffer's key,
dtype and region, ``regions``, ``region_parents`` and ``string_cols``.
The error tables, the gate and the CUDA source's opcode and error-bit
numbers must agree too.
"""

import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from pyruhvro_tpu import gate as ref_gate  # noqa: E402
from pyruhvro_tpu.ops import fieldprog as ref_fieldprog  # noqa: E402
from pyruhvro_tpu.ops import varint as ref_varint  # noqa: E402
from pyruhvro_tpu.schema.parser import parse_schema as ref_parse  # noqa: E402
from pyruhvro_tpu.utils.datagen import (  # noqa: E402
    CRITERION_SHAPES,
    KAFKA_SCHEMA_JSON,
    WIDENED_SCHEMA_JSON,
    random_schema,
)

from pyruhvro_tpu_torch import gate  # noqa: E402
from pyruhvro_tpu_torch.ops import fieldprog, varint  # noqa: E402
from pyruhvro_tpu_torch.ops.walk_decode import walk_supported  # noqa: E402
from pyruhvro_tpu_torch.schema.arrow_map import to_arrow_schema  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "pyruhvro_tpu_torch" / "csrc"
# the kernels that interpret the field-program code
CU_SOURCES = [CSRC / "walk_decode.cu", CSRC / "decode_walk.cu"]

NAMED = [KAFKA_SCHEMA_JSON, WIDENED_SCHEMA_JSON,
         *(CRITERION_SHAPES[k] for k in sorted(CRITERION_SHAPES))]
RANDOM = [random_schema(seed) for seed in range(50)]


def _assert_same_program(schema: str):
    want = ref_fieldprog.lower(ref_parse(schema))
    got = fieldprog.lower(parse_schema(schema))
    assert sorted(got.buffers) == sorted(want.buffers)
    for key, spec in want.buffers.items():
        mine = got.buffers[key]
        assert mine.dtype == np.dtype(spec.dtype), key
        assert mine.region == spec.region, key
    assert got.regions == want.regions
    assert got.region_parents == want.region_parents
    assert [(c.path, c.region) for c in got.string_cols] == \
        [(c.path, c.region) for c in want.string_cols]
    assert got.out_keys == sorted(want.buffers)
    return got


@pytest.mark.parametrize("schema", NAMED,
                         ids=["kafka", "widened", *sorted(CRITERION_SHAPES)])
def test_named_schemas_lower_like_reference(schema):
    prog = _assert_same_program(schema)
    assert walk_supported(prog)


def test_random_schemas_lower_like_reference():
    lowered = 0
    for schema in RANDOM:
        if not ref_gate.device_supported(ref_parse(schema)):
            continue
        _assert_same_program(schema)
        lowered += 1
    assert lowered >= 40


def test_gate_matches_reference():
    for schema in RANDOM + NAMED:
        assert gate.device_supported(parse_schema(schema)) == \
            ref_gate.device_supported(ref_parse(schema)), schema


def test_arrow_schema_matches_reference():
    from pyruhvro_tpu.schema.arrow_map import to_arrow_schema as ref_arrow

    for schema in RANDOM + NAMED:
        assert to_arrow_schema(parse_schema(schema)).equals(
            ref_arrow(ref_parse(schema)), check_metadata=True), schema


def test_error_tables_match_reference():
    """The reference's error bits, names and slugs, and one bit of the
    port's own: ``ERR_INT_RANGE`` (an Avro int past int32)."""
    names = [n for n in dir(ref_varint) if n.startswith("ERR_")]
    assert names
    extra = {varint.ERR_INT_RANGE: None}
    assert {n for n in dir(varint) if n.startswith("ERR_")} - set(names) \
        == {"ERR_INT_RANGE"}
    assert varint.ERR_INT_RANGE == 1 << 9
    for name in names:
        want = getattr(ref_varint, name)
        if name in ("ERR_NAMES", "ERR_SLUGS"):
            got = getattr(varint, name)
            assert {k: v for k, v in got.items() if k not in extra} == want
            assert got[varint.ERR_INT_RANGE] == {
                "ERR_NAMES": "int outside the int32 range",
                "ERR_SLUGS": "int_range"}[name]
            continue
        assert getattr(varint, name) == want, name


def test_code_references_every_buffer_once_per_write():
    """Every buffer is written by exactly one instruction (REBASE aside),
    and the structured instructions' targets land inside the code."""
    for schema in NAMED + RANDOM:
        if not gate.device_supported(parse_schema(schema)):
            continue
        prog = fieldprog.lower(parse_schema(schema))
        code = prog.code.tolist()
        written = []
        pc = 0
        widths = {fieldprog.OP_LONG: 3, fieldprog.OP_INT: 2,
                  fieldprog.OP_FLOAT: 2, fieldprog.OP_DOUBLE: 3,
                  fieldprog.OP_BOOL: 2, fieldprog.OP_STRING: 3,
                  fieldprog.OP_FIXED: 3, fieldprog.OP_ENUM: 3,
                  fieldprog.OP_NULLABLE: 4, fieldprog.OP_JUMP: 2,
                  fieldprog.OP_REPEATED: 4, fieldprog.OP_LOOP: 2,
                  fieldprog.OP_TRAILING: 1, fieldprog.OP_REBASE: 2}
        two_bufs = (fieldprog.OP_LONG, fieldprog.OP_DOUBLE,
                    fieldprog.OP_STRING)
        while code[pc] != fieldprog.OP_END:
            op = code[pc]
            if op == fieldprog.OP_UNION:
                written.append(code[pc + 1])
                for k in range(code[pc + 2]):
                    start, stop = code[pc + 4 + 2 * k], code[pc + 5 + 2 * k]
                    if start >= 0:
                        assert pc < start <= stop < code[pc + 3]
                        assert code[stop] == fieldprog.OP_JUMP
                        assert code[stop + 1] == code[pc + 3]
                pc += 4 + 2 * code[pc + 2]
                continue
            if op in (fieldprog.OP_NULLABLE, fieldprog.OP_REPEATED):
                assert pc < code[pc + 3] < len(code)
            if op == fieldprog.OP_REPEATED:
                assert code[code[pc + 3] - 2] == fieldprog.OP_LOOP
                assert code[code[pc + 3] - 1] == pc
            if op not in (fieldprog.OP_JUMP, fieldprog.OP_LOOP,
                          fieldprog.OP_TRAILING, fieldprog.OP_REBASE):
                written.append(code[pc + 1])
                if op in two_bufs:
                    written.append(code[pc + 2])
            pc += widths[op]
        assert sorted(written) == list(range(len(prog.out_keys))), schema


def test_cuda_source_agrees_on_opcodes_and_error_bits():
    for source in CU_SOURCES:
        defines = {m.group(1): int(m.group(2).rstrip("u"))
                   for m in re.finditer(r"#define (\w+) (\d+u?)",
                                        source.read_text())}
        for name, value in fieldprog.OPCODES.items():
            assert defines[name] == value, (source.name, name)
        for name in [n for n in defines if n.startswith("ERR_")]:
            assert defines[name] == getattr(varint, name), (source.name, name)
