"""The port's IR verifier (``pyruhvro_tpu_torch/analysis/irverify.py``, a
copy of ``pyruhvro_tpu/analysis/irverify.py``) and its error-taxonomy
check (``analysis/contracts.py``), on the CPU.

* The real tree: every pass green on the port's sources, 100 % of the
  schema-construct lattice, every seeded mutation caught; the same
  lattice point count, mutation cases and guard names as the reference's
  run on its own tree, and as its committed report.
* Per-class red checks: each invariant class (type/effect, progress,
  overflow, equivalence) turns red on a direct seeded perturbation.
* The equivalence diff over 100 random schemas (the generic program
  against the specialiser's generated unit).
* The error taxonomy: every C++ ``Err`` code of
  ``csrc/host/host_vm_core.h`` tripped end to end through the port's VM
  (this file's ``_TAXONOMY_CASES`` are the coverage
  ``check_error_taxonomy`` scans ``tests/test_torch_*.py`` for), and the
  checker red on fixture trees.

The verifier's metric-key lint tests wait for the port's ``lints``.
"""

import copy
import json
import re
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from pyruhvro_tpu.analysis import irverify as ref_irverify  # noqa: E402

from pyruhvro_tpu_torch.analysis import irverify  # noqa: E402
from pyruhvro_tpu_torch.analysis.contracts import (  # noqa: E402
    check_error_taxonomy,
    parse_cpp_enum,
)
from pyruhvro_tpu_torch.errors import MalformedAvro  # noqa: E402
from pyruhvro_tpu_torch.hostpath.codec import NativeHostCodec  # noqa: E402
from pyruhvro_tpu_torch.hostpath.program import (  # noqa: E402
    OP_ARRAY,
    OP_INT,
    OP_LONG,
    OP_STRING,
    lower_host,
)
from pyruhvro_tpu_torch.hostpath.specialize import generate_source  # noqa: E402
from pyruhvro_tpu_torch.ops import UnsupportedOnDevice  # noqa: E402
from pyruhvro_tpu_torch.schema.cache import get_or_parse_schema  # noqa: E402
from pyruhvro_tpu_torch.schema.parser import parse_schema  # noqa: E402
from pyruhvro_tpu.utils.datagen import random_schema  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ROOT = str(REPO)
VM_CORE = "pyruhvro_tpu_torch/csrc/host/host_vm_core.h"

_REF = """
{"type": "record", "name": "R", "fields": [
  {"name": "i", "type": "int"},
  {"name": "s", "type": "string"},
  {"name": "l", "type": "long"},
  {"name": "e", "type": {"type": "enum", "name": "E",
                         "symbols": ["A", "B"]}},
  {"name": "arr", "type": {"type": "array", "items": "int"}}
]}
"""


def _model(schema=_REF):
    prog = lower_host(parse_schema(schema))
    return prog, irverify.ProgramModel.from_host_program(prog, "test")


@pytest.fixture(scope="module")
def guards():
    return irverify.scan_native_guards(ROOT)


@pytest.fixture(scope="module")
def consumers():
    return irverify.scan_aux_consumers(ROOT)


@pytest.fixture(scope="module")
def full_run():
    return irverify.run_ir_verification(ROOT)


@pytest.fixture(scope="module")
def ref_run():
    return ref_irverify.run_ir_verification(ROOT)


# -- the real tree: green ----------------------------------------------------------


def test_real_tree_green(full_run):
    findings, report = full_run
    assert findings == [], [str(f) for f in findings]
    assert report["finding_count"] == 0
    assert report["generated_by"] == "pyruhvro_tpu_torch.analysis.irverify"


def test_lattice_coverage_100(full_run):
    _, report = full_run
    cov = report["lattice"]["coverage"]
    assert cov["coverage_pct"] == 100.0
    assert cov["verified"] == cov["constructible"] > 150
    # every point is verified or carries an explicit Avro-invalidity reason
    for p in report["lattice"]["points"]:
        assert p["status"] in ("verified", "skipped-invalid"), p
        if p["status"] == "skipped-invalid":
            assert p["reason"]


def test_all_guard_anchors_present(guards):
    missing = [g for g, ok in guards.items() if not ok]
    assert missing == []


def test_anchors_are_the_ports_own_files():
    """Every anchor and consumer the verifier scans lies in the port."""
    rels = {rel for pats in irverify.GUARD_ANCHORS.values()
            for rel, _pat in pats}
    rels |= {rel for dirs in irverify.AUX_CONSUMERS.values()
             for rel, _pat in dirs.values()}
    assert rels and all(r.startswith("pyruhvro_tpu_torch/") for r in rels)
    assert all((REPO / r).is_file() for r in rels)


def test_mutation_selftest_all_caught(full_run):
    _, report = full_run
    assert report["mutation"]["all_caught"] is True
    classes = {c["class"] for c in report["mutation"]["cases"]}
    assert classes == {"effect", "progress", "overflow", "equiv",
                       "optimize"}
    for case in report["mutation"]["cases"]:
        assert case["caught"], case


def test_committed_report_matches_tree(full_run):
    """The reference's committed ``IR_VERIFY_REPORT.json`` describes the
    same lattice as the port's run: the port writes no report of its
    own, so its coverage is held against the reference's."""
    with open(REPO / "IR_VERIFY_REPORT.json") as f:
        committed = json.load(f)
    _, fresh = full_run
    assert committed["lattice"]["coverage"] == fresh["lattice"]["coverage"]
    assert committed["finding_count"] == 0
    assert committed["mutation"]["all_caught"] is True


def test_run_is_the_references(full_run, ref_run):
    """The port's run on its tree against the reference's on its own: the
    same lattice points (each point's id, status and optimizer verdict),
    mutation cases, guard and consumer names (``int_range_i32`` for the
    reference's ``int_low32_by_design``), audit notes."""
    (fs, port_rep), (ref_fs, ref_rep) = full_run, ref_run
    assert fs == [] and ref_fs == []
    assert port_rep["lattice"]["coverage"] == ref_rep["lattice"]["coverage"]
    assert port_rep["lattice"]["points"] == ref_rep["lattice"]["points"]
    assert [(c["class"], c["name"], c["caught"], c["rule"])
            for c in port_rep["mutation"]["cases"]] == \
        [(c["class"], c["name"], c["caught"], c["rule"])
         for c in ref_rep["mutation"]["cases"]]
    # one guard renamed: the port's VM rejects an int past int32
    # (int_range_i32) where the reference's keeps its low 32 bits
    ref_guards = {("int_range_i32" if g == "int_low32_by_design" else g): v
                  for g, v in ref_rep["guards"].items()}
    assert port_rep["guards"] == ref_guards
    assert port_rep["aux_consumers"] == ref_rep["aux_consumers"]
    assert port_rep["aux_audit_notes"] == ref_rep["aux_audit_notes"]


def test_run_writes_no_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = sorted(REPO.iterdir())
    irverify.run_ir_verification(ROOT, depths=(1,), selftest=False)
    assert sorted(REPO.iterdir()) == before
    assert list(tmp_path.iterdir()) == []


# -- per-class red checks ----------------------------------------------------------


def _rules(findings):
    return {f.rule for f in findings}


def test_effect_red_on_col_transpose():
    _, m = _model()
    i_pc = next(pc for pc, r in enumerate(m.ops) if r[0] == OP_INT)
    s_pc = next(pc for pc, r in enumerate(m.ops) if r[0] == OP_STRING)
    oi, os_ = list(m.ops[i_pc]), list(m.ops[s_pc])
    oi[3], os_[3] = os_[3], oi[3]
    m.ops[i_pc], m.ops[s_pc] = tuple(oi), tuple(os_)
    assert "irverify.effect" in _rules(irverify.verify_structure(m))


def test_effect_red_on_aux_arity():
    _, m = _model()
    e_pc = next(pc for pc, r in enumerate(m.ops)
                if m.aux[pc] and m.aux[pc][0] == "enum")
    aux = list(m.aux)
    aux[e_pc] = ("enum", b"A")  # a symbol dropped against op.a == 2
    m.aux = tuple(aux)
    assert "irverify.effect" in _rules(irverify.verify_structure(m))


def test_effect_red_on_depth_past_cap():
    _, m = _model()
    fs = irverify.verify_structure(m, max_depth=1)
    assert any("MAX_DEPTH" in f.message for f in fs)


def test_effect_red_on_region_drift():
    """A column declared on the row region but reached on an item axis
    desyncs the assembler's append cadence."""
    _, m = _model()
    a_pc = next(pc for pc, r in enumerate(m.ops) if r[0] == OP_ARRAY)
    item_col = m.ops[a_pc + 1][3]
    m.col_regions[item_col] = 0
    fs = irverify.verify_structure(m)
    assert any("region" in f.message for f in fs)


def test_depth_cap_pinned_to_registered_default(monkeypatch):
    """A tuned-down ``PYRUHVRO_TPU_MAX_DEPTH`` does not turn a pristine
    tree red: the verifier proves against the registered default (the
    port's registry maps the name to it)."""
    monkeypatch.setenv("PYRUHVRO_TPU_MAX_DEPTH", "4")
    typ = '"int"'
    for d in range(20):
        typ = ('{"type": "record", "name": "D%d", "fields": '
               '[{"name": "f", "type": %s}]}' % (d, typ))
    prog = lower_host(parse_schema(typ))
    assert irverify.verify_structure(
        irverify.ProgramModel.from_host_program(prog, "t")) == []
    assert irverify._default_max_depth() == 64


def test_report_is_byte_stable():
    """Two runs on the same tree give identical reports (no timestamp or
    other run-varying field)."""
    _, a = irverify.run_ir_verification(ROOT, depths=(1, 3),
                                        selftest=False)
    _, b = irverify.run_ir_verification(ROOT, depths=(1, 3),
                                        selftest=False)
    assert a == b
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_effect_red_on_dead_aux():
    _, m = _model()
    stripped = {t: [] for t in irverify.AUX_CONSUMERS}
    fs = irverify.verify_aux_consumption(m, stripped)
    assert fs and all("dead aux" in f.message for f in fs)


def test_effect_green_on_real_program():
    _, m = _model()
    assert irverify.verify_structure(m) == []


def test_progress_red_on_corrupt_nops():
    _, m = _model()
    a_pc = next(pc for pc, r in enumerate(m.ops) if r[0] == OP_ARRAY)
    row = list(m.ops[a_pc + 1])
    row[4] = 0
    m.ops[a_pc + 1] = tuple(row)
    fs = irverify.verify_structure(m)
    assert "irverify.progress" in _rules(fs)


def test_progress_red_without_zero_width_budget(guards):
    """An array of zero-width items is safe only because of the
    ``kMaxZeroWidthItems`` budget; with its anchor gone the verifier
    refuses the program."""
    prog = lower_host(parse_schema(
        '{"type": "record", "name": "Z", "fields": '
        '[{"name": "a", "type": {"type": "array", "items": "null"}}]}'))
    m = irverify.ProgramModel.from_host_program(prog, "test")
    g = dict(guards)
    g["zero_width_budget"] = False
    fs = irverify.verify_progress(m, g)
    assert any("kMaxZeroWidthItems" in f.message for f in fs)
    assert irverify.verify_progress(m, guards) == []


def test_progress_loop_inventory(guards):
    """Byte-consuming loops are proven span-bounded, not zw-capped."""
    _, m = _model()
    assert irverify.verify_progress(m, guards) == []
    loops = irverify.verify_progress.last_loops
    assert loops and all(not lp["zw_capped"] for lp in loops)


def test_overflow_red_without_string_len_guard(guards):
    """The wire string length lands in an int32 lens lane; without the
    ``rd_string`` INT32_MAX check (anchor ``string_len_i32``) a >2 GiB
    datum would wrap it."""
    _, m = _model()
    g = dict(guards)
    g["string_len_i32"] = False
    fs = irverify.verify_overflow(m, g)
    assert any(f.rule == "irverify.overflow"
               and "string_len" in f.message for f in fs)
    assert irverify.verify_overflow(m, guards) == []


def test_overflow_red_without_running_guard(guards):
    _, m = _model()
    g = dict(guards)
    g["offs_running_i32"] = False
    fs = irverify.verify_overflow(m, g)
    assert any("offs_running" in f.message for f in fs)


def test_string_len_i32_fix_anchored(guards):
    """Both the native reader and the oracle's reader carry the int32
    length bound."""
    assert guards["string_len_i32"] is True
    assert "len > (int64_t)INT32_MAX" in (REPO / VM_CORE).read_text()


def test_guard_red_when_the_anchor_is_deleted(tmp_path):
    """A fixture tree whose ``rd_string`` bound check is deleted: the
    scan reports the guard absent and the run finds it."""
    for pats in irverify.GUARD_ANCHORS.values():
        for rel, _pat in pats:
            dst = tmp_path / rel
            if not dst.exists():
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(REPO / rel, dst)
    core = tmp_path / VM_CORE
    core.write_text(core.read_text().replace("len > (int64_t)INT32_MAX",
                                             "false"))
    g = irverify.scan_native_guards(str(tmp_path))
    assert [k for k, ok in g.items() if not ok] == ["string_len_i32"]
    fs, _rep = irverify.run_ir_verification(str(tmp_path), depths=(1,),
                                            selftest=False)
    assert any("string_len_i32" in f.message for f in fs)


def test_fallback_rejects_past_i32_length():
    """``fallback/io.py`` ``read_bytes``: a length claim past int32 raises
    the bound error before the truncation check."""
    from pyruhvro_tpu_torch.fallback.io import read_bytes, zigzag_encode

    def varint(v):
        out = bytearray()
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)
        return bytes(out)

    wire = varint(zigzag_encode(1 << 31)) + b"xx"
    with pytest.raises(MalformedAvro) as ei:
        read_bytes(wire, 0)
    assert "exceeds int32" in str(ei.value)
    assert ei.value.err_name == "overrun"


def test_equiv_red_on_codegen_from_mutated_program():
    import numpy as np

    prog, _m = _model()
    mut = copy.deepcopy(prog)
    ops = np.array(mut.ops, copy=True)
    i_pc = next(pc for pc in range(len(ops)) if int(ops[pc][0]) == OP_INT)
    l_pc = next(pc for pc in range(len(ops)) if int(ops[pc][0]) == OP_LONG)
    ops[i_pc][3], ops[l_pc][3] = int(ops[l_pc][3]), int(ops[i_pc][3])
    mut.ops = ops
    src = generate_source(mut, "M", with_effects=True)
    fs = irverify.verify_equivalence(prog, src=src)
    assert "irverify.equiv" in _rules(fs)


def test_equiv_red_on_tampered_ktable():
    prog, _ = _model()
    src = generate_source(prog, "M", with_effects=True)
    m = re.search(r"static const Op kOps\[\] = \{\n(    \{[^\n]*\n)", src)
    row = m.group(1)
    tampered = re.sub(r"\{(-?\d+),",
                      lambda g: "{%d," % ((int(g.group(1)) + 1) % 16),
                      row, count=1)
    fs = irverify.verify_equivalence(prog,
                                     src=src.replace(row, tampered, 1))
    assert "irverify.equiv" in _rules(fs)


def test_equiv_requires_effects_trailer():
    prog, _ = _model()
    src = generate_source(prog, "M")  # production mode: no trailer
    fs = irverify.verify_equivalence(prog, src=src)
    assert any("EFFECTS-v1" in f.message for f in fs)


def test_production_source_stays_trailer_free():
    prog, _ = _model()
    assert "EFFECTS-v1" not in generate_source(prog, "M")
    assert "EFFECTS-v1" in generate_source(prog, "M", with_effects=True)


# -- the equivalence diff over 100 random schemas ---------------------------------


def test_equivalence_over_100_random_schemas():
    lowered = 0
    for seed in range(100):
        try:
            prog = lower_host(parse_schema(random_schema(seed)))
        except UnsupportedOnDevice:
            continue
        lowered += 1
        fs = irverify.verify_equivalence(prog, label=f"seed{seed}")
        assert fs == [], (seed, [str(f) for f in fs])
    assert lowered >= 50


def test_full_verifier_over_random_schemas(guards, consumers):
    for seed in range(0, 100, 7):
        try:
            prog = lower_host(parse_schema(random_schema(seed)))
        except UnsupportedOnDevice:
            continue
        fs = irverify.verify_program(prog, guards, consumers,
                                     label=f"seed{seed}")
        assert fs == [], (seed, [str(f) for f in fs])


# -- the error taxonomy: every C++ Err code through the port's VM ------------------

_TAXONOMY_CASES = [
    # (slug, schema, wire bytes made to trip exactly that bit)
    ("varint",
     '{"type": "record", "name": "T", "fields": '
     '[{"name": "l", "type": "long"}]}',
     b"\xff" * 10 + b"\x01"),
    ("neg_len",
     '{"type": "record", "name": "T", "fields": '
     '[{"name": "s", "type": "string"}]}',
     b"\x01"),  # zigzag -1
    ("overrun",
     '{"type": "record", "name": "T", "fields": '
     '[{"name": "s", "type": "string"}]}',
     b"\xc8\x01"),  # claims 100 bytes, has none
    ("bad_branch",
     '{"type": "record", "name": "T", "fields": '
     '[{"name": "o", "type": ["null", "int"]}]}',
     b"\x0a"),  # branch 5 of a 2-arm union
    ("bad_enum",
     '{"type": "record", "name": "T", "fields": '
     '[{"name": "e", "type": {"type": "enum", "name": "E", '
     '"symbols": ["A", "B"]}}]}',
     b"\x0e"),  # index 7 of 2
    ("trailing",
     '{"type": "record", "name": "T", "fields": '
     '[{"name": "i", "type": "int"}]}',
     b"\x02\x00"),
    ("bad_bool",
     '{"type": "record", "name": "T", "fields": '
     '[{"name": "b", "type": "boolean"}]}',
     b"\x02"),
    ("dec_range",
     '{"type": "record", "name": "T", "fields": '
     '[{"name": "d", "type": {"type": "bytes", "logicalType": '
     '"decimal", "precision": 10, "scale": 2}}]}',
     b"\x22" + b"\x01" + b"\x00" * 16),  # 17 B, not a sign extension
    ("int_range",
     '{"type": "record", "name": "T", "fields": '
     '[{"name": "i", "type": "int"}]}',
     b"\x80\x80\x80\x80\x10"),  # zigzag 2^31: past int32
]


@pytest.mark.parametrize("slug,schema,wire", _TAXONOMY_CASES,
                         ids=[c[0] for c in _TAXONOMY_CASES])
@pytest.mark.parametrize("opt", ["optimized", "raw"])
def test_native_error_taxonomy(monkeypatch, slug, schema, wire, opt):
    monkeypatch.setenv("PYRUHVRO_TPU_NO_SPECIALIZE", "1")
    if opt == "raw":
        monkeypatch.setenv("PYRUHVRO_TPU_NO_OPT", "1")
    else:
        monkeypatch.delenv("PYRUHVRO_TPU_NO_OPT", raising=False)
    e = get_or_parse_schema(schema)
    codec = NativeHostCodec(e.ir, e.arrow_schema)
    with pytest.raises(MalformedAvro) as ei:
        codec.decode([wire])
    assert ei.value.err_name == slug
    assert ei.value.index == 0


def test_taxonomy_cases_cover_every_cpp_err():
    """This file is the coverage the checker scans for: it covers the
    whole C++ enum."""
    cpp = parse_cpp_enum(str(REPO / VM_CORE), "Err")
    from pyruhvro_tpu_torch.ops import varint as v

    slugs = {v.ERR_SLUGS[getattr(v, name)] for name in cpp}
    assert slugs <= {c[0] for c in _TAXONOMY_CASES}


def test_error_taxonomy_checker_green_on_real_tree():
    assert check_error_taxonomy(ROOT) == []


def _taxonomy_fixture(tmp_path):
    for rel in (VM_CORE, "pyruhvro_tpu_torch/ops/varint.py"):
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, dst)


def test_error_taxonomy_checker_red_on_untested_fixture(tmp_path):
    """The real contract files with an empty ``tests/``: every slug is
    untested."""
    _taxonomy_fixture(tmp_path)
    (tmp_path / "tests").mkdir()
    fs = check_error_taxonomy(str(tmp_path))
    assert len(fs) >= 8
    assert all(f.rule == "contract.err-taxonomy" for f in fs)


def test_error_taxonomy_counts_only_the_ports_tests(tmp_path):
    """The reference's tests never count as the port's coverage: a
    ``tests/`` holding only the reference's files leaves every slug
    untested."""
    _taxonomy_fixture(tmp_path)
    (tmp_path / "tests").mkdir()
    for fn in ("test_irverify.py", "test_hostpath.py"):
        shutil.copy(REPO / "tests" / fn, tmp_path / "tests" / fn)
    assert len(check_error_taxonomy(str(tmp_path))) >= 8
    shutil.copy(Path(__file__), tmp_path / "tests" / Path(__file__).name)
    assert check_error_taxonomy(str(tmp_path)) == []


def test_error_taxonomy_checker_red_on_unmapped_code(tmp_path):
    """A C++ Err member with no Python slug is flagged."""
    _taxonomy_fixture(tmp_path)
    core = tmp_path / VM_CORE
    text = core.read_text()
    core.write_text(text.replace(
        "ERR_DEC_RANGE = 1 << 8,",
        "ERR_DEC_RANGE = 1 << 8,\n  ERR_PHANTOM = 1 << 9,"))
    shutil.copytree(REPO / "tests", tmp_path / "tests",
                    ignore=shutil.ignore_patterns("__pycache__"))
    fs = check_error_taxonomy(str(tmp_path))
    assert any("ERR_PHANTOM" in f.message for f in fs)


# -- the program's effect metadata -------------------------------------------------


def test_op_effects_resolution():
    prog = lower_host(parse_schema(_REF))
    rows = prog.op_effects()
    assert len(rows) == len(prog.ops)
    by_kind = {r["kind"]: r for r in rows}
    assert by_kind[OP_STRING]["sinks"] == (
        ("string_len", ("string_len_span", "string_len_i32")),)
    fixed = [r for r in rows if r["name"] == "array"]
    assert fixed and fixed[0]["min_wire"] == 1
