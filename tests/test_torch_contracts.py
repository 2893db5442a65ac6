"""The port's opcode contract checker (``pyruhvro_tpu_torch/analysis/
contracts.py``, a copy of ``pyruhvro_tpu/analysis/contracts.py``), on the
CPU.

Drift is seeded into fixture copies of the port's contract files under
``tmp_path``, one divergence each: the checker catches each seed and
stays quiet on the real tree. The specialiser's embedded tables are
checked generatively (the real package, with ``_static_tables``
patched). The parsers read the port's files as the reference's read the
reference's.
"""

import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from pyruhvro_tpu.analysis import contracts as ref_contracts  # noqa: E402

from pyruhvro_tpu_torch.analysis import contracts  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
VM_CORE = "pyruhvro_tpu_torch/csrc/host/host_vm_core.h"
EXTRACT = "pyruhvro_tpu_torch/csrc/host/extract_core.h"
CODEC = "pyruhvro_tpu_torch/hostpath/codec.py"

_CONTRACT_FILES = (
    "pyruhvro_tpu_torch/hostpath/program.py",
    CODEC,
    "pyruhvro_tpu_torch/hostpath/specialize.py",
    "pyruhvro_tpu_torch/ops/varint.py",
    VM_CORE,
    EXTRACT,
    "pyruhvro_tpu_torch/csrc/host/arrow_decode_core.h",
)


class _FixtureTree:
    """A copy of the contract surfaces, mutable per test."""

    def __init__(self, base):
        self.base = base
        for rel in _CONTRACT_FILES:
            dst = base / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(REPO / rel, dst)

    def __str__(self):
        return str(self.base)

    def mutate(self, rel, old, new, count=1):
        p = self.base / rel
        s = p.read_text()
        assert s.count(old) >= 1, f"seed anchor {old!r} missing in {rel}"
        p.write_text(s.replace(old, new, count))


@pytest.fixture()
def fixture_tree(tmp_path):
    return _FixtureTree(tmp_path)


def check(tree):
    return contracts.check_contracts(str(tree), generative=False)


# -- the real tree -----------------------------------------------------------------


def test_contracts_clean_on_real_tree():
    assert contracts.check_contracts(str(REPO)) == []


def test_fixture_tree_is_clean_but_for_the_taxonomy(fixture_tree):
    """A pristine fixture copy has no drift; only the taxonomy, whose
    tests the fixture has not, speaks."""
    fs = check(fixture_tree)
    assert fs and {f.rule for f in fs} == {"contract.err-taxonomy"}


# -- seeded drift -------------------------------------------------------------------


def test_contracts_catch_enum_value_drift(fixture_tree):
    fixture_tree.mutate(VM_CORE, "OP_MAP = 12,", "OP_MAP = 99,")
    fs = check(fixture_tree)
    assert any(f.rule == "contract.opkind" and "OP_MAP" in f.message
               for f in fs), fs


def test_contracts_catch_missing_enum_member(fixture_tree):
    fixture_tree.mutate(VM_CORE, "OP_DEC_FIXED = 15,", "")
    fs = check(fixture_tree)
    assert any(f.rule == "contract.opkind" and "OP_DEC_FIXED" in f.message
               for f in fs), fs


def test_contracts_catch_coltype_drift(fixture_tree):
    fixture_tree.mutate(VM_CORE, "COL_OFFS = 6,", "COL_OFFS = 7,")
    fs = check(fixture_tree)
    assert any(f.rule == "contract.coltype" for f in fs), fs


def test_contracts_catch_err_bit_drift(fixture_tree):
    fixture_tree.mutate(VM_CORE, "ERR_DEC_RANGE = 1 << 8,",
                        "ERR_DEC_RANGE = 1 << 9,")
    fs = check(fixture_tree)
    assert any(f.rule == "contract.err" and "ERR_DEC_RANGE" in f.message
               for f in fs), fs


def test_contracts_catch_slot_name_drift(fixture_tree):
    fixture_tree.mutate(VM_CORE, '"dec_bytes"', '"decbytes"')
    fs = check(fixture_tree)
    assert any(f.rule == "contract.prof-slots" and "dec_bytes" in f.message
               for f in fs), fs


def test_contracts_catch_pseudo_slot_drift(fixture_tree):
    fixture_tree.mutate(VM_CORE, "P_COLLECT = 17,", "P_COLLECT = 16,")
    fs = check(fixture_tree)
    assert any(f.rule == "contract.prof-slots" for f in fs), fs


def test_contracts_catch_drain_prefix_drift(fixture_tree):
    # the Python drain consumer stops naming a native domain prefix (the
    # port's codec names it in its docstring and in its drain's)
    fixture_tree.mutate(CODEC, "vm.encop.", "vm.encopX.", count=-1)
    fs = check(fixture_tree)
    assert any(f.rule == "contract.drain-keys"
               and "vm.encop." in f.message for f in fs), fs


def test_contracts_catch_aux_tag_drift(fixture_tree):
    # extract_core.h stops parsing a tag program.py emits
    fixture_tree.mutate(EXTRACT, 'strcmp(t, "duration")',
                        'strcmp(t, "durationX")')
    fs = check(fixture_tree)
    assert any(f.rule == "contract.aux-tags" and "duration" in f.message
               for f in fs), fs


def test_contracts_catch_unknown_aux_lane(fixture_tree):
    # the specialiser references an AuxLane member the enum lacks
    fixture_tree.mutate("pyruhvro_tpu_torch/hostpath/specialize.py",
                        "AUX_DECIMAL", "AUX_DECIMAL128")
    fs = check(fixture_tree)
    assert any(f.rule == "contract.aux-tags" and "AUX_DECIMAL128" in
               f.message for f in fs), fs


def test_contracts_catch_aux_arity_drift(monkeypatch):
    """A specialiser that emits the wrong decimal precision (an aux arity
    payload) in its embedded ``kAux`` table is caught by the generative
    diff."""
    from pyruhvro_tpu_torch.hostpath import specialize

    real = specialize._static_tables

    def bad_tables(prog):
        return real(prog).replace("{AUX_DECIMAL, nullptr, nullptr, 10}",
                                  "{AUX_DECIMAL, nullptr, nullptr, 11}")

    monkeypatch.setattr(specialize, "_static_tables", bad_tables)
    fs = contracts._check_specializer_tables()
    assert any(f.rule == "contract.spec-tables" and "precision" in f.message
               for f in fs), fs


def test_contracts_catch_kops_table_drift(monkeypatch):
    from pyruhvro_tpu_torch.hostpath import specialize

    real = specialize._static_tables

    def bad_tables(prog):
        out = real(prog)
        first = out.index("},")
        # corrupt the first kOps row's subtree size
        row_start = out.index("{", out.index("kOps"))
        row = out[row_start:first + 1]
        return out.replace(row, row.replace(", 0}", ", 7}"), 1)

    monkeypatch.setattr(specialize, "_static_tables", bad_tables)
    fs = contracts._check_specializer_tables()
    assert any(f.rule == "contract.spec-tables" for f in fs), fs


# -- the parsers read the port's files as the reference's read its own -------------


# the port's one error bit the reference lacks: an Avro int past int32 is
# an error where it is read (apache-avro's zag_i32), not wrapped
PORT_ERR = {"ERR_INT_RANGE": 1 << 9}
PORT_ERR_TEXT = {"ERR_NAMES": {"ERR_INT_RANGE": "int outside the int32 range"},
                 "ERR_SLUGS": {"ERR_INT_RANGE": "int_range"}}


@pytest.mark.parametrize("header,enum", [
    ("host_vm_core.h", "OpKind"), ("host_vm_core.h", "ColType"),
    ("host_vm_core.h", "Err"), ("extract_core.h", "AuxLane")])
def test_cpp_enums_are_the_references(header, enum):
    port = contracts.parse_cpp_enum(
        str(REPO / "pyruhvro_tpu_torch/csrc/host" / header), enum)
    ref = ref_contracts.parse_cpp_enum(
        str(REPO / "pyruhvro_tpu/runtime/native" / header), enum)
    if enum == "Err":
        ref = {**ref, **PORT_ERR}
    assert port and port == ref


@pytest.mark.parametrize("prefix", ["OP_", "COL_", "FLAG_"])
def test_py_constants_are_the_references(prefix):
    port = contracts.parse_py_constants(
        str(REPO / "pyruhvro_tpu_torch/hostpath/program.py"), prefix)
    ref = ref_contracts.parse_py_constants(
        str(REPO / "pyruhvro_tpu/hostpath/program.py"), prefix)
    assert port and port == ref


def test_string_tables_and_tags_are_the_references():
    here = REPO / "pyruhvro_tpu_torch/csrc/host"
    there = REPO / "pyruhvro_tpu/runtime/native"
    for name in ("kSlotName", "kDomPrefix"):
        assert contracts.parse_cpp_string_array(
            str(here / "host_vm_core.h"), name) == \
            ref_contracts.parse_cpp_string_array(
                str(there / "host_vm_core.h"), name)
    assert contracts.parse_cpp_strcmp_tags(str(here / "extract_core.h")) \
        == ref_contracts.parse_cpp_strcmp_tags(str(there / "extract_core.h"))
    assert contracts.parse_py_aux_tags(
        str(REPO / "pyruhvro_tpu_torch/hostpath/program.py")) == \
        ref_contracts.parse_py_aux_tags(
            str(REPO / "pyruhvro_tpu/hostpath/program.py")) == \
        set(contracts.EXPECTED_AUX_TAGS)
    ref = ref_contracts.parse_err_mappings(
        str(REPO / "pyruhvro_tpu/ops/varint.py"))
    assert contracts.parse_err_mappings(
        str(REPO / "pyruhvro_tpu_torch/ops/varint.py")) == \
        {k: {**v, **PORT_ERR_TEXT[k]} for k, v in ref.items()}


def test_every_checked_path_is_the_ports(fixture_tree):
    """The checker reads only the port's files: a tree holding them and
    the port's tests, and nothing of the reference, is green."""
    tests = fixture_tree.base / "tests"
    tests.mkdir()
    for path in sorted((REPO / "tests").glob("test_torch_*.py")):
        shutil.copy(path, tests / path.name)
    assert not (fixture_tree.base / "pyruhvro_tpu").exists()
    assert check(fixture_tree) == []
