"""The port's analysis gate, ``scripts/torch_analysis_gate.py``, on the CPU.

It is green on a copy of the tree and writes its report only under that
copy's ``build/``; it is red on a seeded direct read of a ``PYRUHVRO_*``
variable; it imports nothing of JAX or of the reference package. Its
``--sanitize`` / ``--tsan`` legs rebuild the host modules under the
sanitizers and run whole test files; they are not run here.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
GATE = REPO / "scripts" / "torch_analysis_gate.py"
REPORT = Path("build") / "pyruhvro_tpu_torch" / "ANALYSIS_REPORT.json"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A copy of what the gate reads: the port's package, README and the
    port's tests (where the error taxonomy finds its slugs exercised)."""
    root = tmp_path_factory.mktemp("gate_tree")
    shutil.copytree(REPO / "pyruhvro_tpu_torch", root / "pyruhvro_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "README.md", root / "README.md")
    (root / "tests").mkdir()
    for test in (REPO / "tests").glob("test_torch_*.py"):
        shutil.copy(test, root / "tests" / test.name)
    (root / "scripts").mkdir()
    shutil.copy(GATE, root / "scripts" / GATE.name)
    return root


def _files(root: Path):
    return {p.relative_to(root).as_posix() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def run_gate(root: Path, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, str(GATE), "--root", str(root),
                           *args], capture_output=True, text=True, env=env,
                          cwd=str(root), timeout=300)


def test_gate_green_on_the_tree_and_writes_only_under_build(tree):
    before = _files(tree)
    proc = run_gate(tree)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
    new = _files(tree) - before
    assert new == {REPORT.as_posix()}, new
    report = json.loads((tree / REPORT).read_text())
    assert report["finding_count"] == 0
    assert list(report["passes"]) == ["contracts", "lints", "concurrency",
                                      "knob_table"]
    assert len(report["knobs"]) == 72
    assert len(report["concurrency"]["locks"]) >= 20
    assert report["concurrency"]["waivers"]
    assert not (tree / "ANALYSIS_REPORT.json").exists()
    assert not (tree / "IR_VERIFY_REPORT.json").exists()


def test_gate_red_on_a_seeded_env_read(tree, tmp_path):
    bad = tmp_path / "bad"
    shutil.copytree(tree, bad, ignore=shutil.ignore_patterns("build"))
    (bad / "pyruhvro_tpu_torch" / "runtime" / "rogue.py").write_text(
        "import os\n\nX = os.environ[\"PYRUHVRO_X\"]\n")
    proc = run_gate(bad, "--skip-generative")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "pyruhvro_tpu_torch/runtime/rogue.py:3: [lint.env-read]" \
        in proc.stdout
    report = json.loads((bad / REPORT).read_text())
    assert report["passes"]["lints"]["count"] == 1


def test_gate_red_on_a_drifted_knob_table_and_fix(tree, tmp_path):
    bad = tmp_path / "drift"
    shutil.copytree(tree, bad, ignore=shutil.ignore_patterns("build"))
    doc = bad / "pyruhvro_tpu_torch" / "REGISTRY.md"
    text = doc.read_text()
    doc.write_text(text.replace("| `PYRUHVRO_TPU_POOL` |",
                                "| `PYRUHVRO_TPU_POOL_GONE` |"))
    proc = run_gate(bad, "--skip-generative")
    assert proc.returncode == 1 and "[docs.knob-table]" in proc.stdout
    proc = run_gate(bad, "--skip-generative", "--fix-knob-table")
    assert proc.returncode == 0, proc.stdout
    assert doc.read_text() == text


def test_gate_imports_neither_jax_nor_the_reference():
    tree = ast.parse(GATE.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    roots = {m.split(".")[0] for m in mods}
    assert "pyruhvro_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "pyruhvro_tpu"}, roots
