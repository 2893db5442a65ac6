"""The port's AST lints (``pyruhvro_tpu_torch/analysis/lints.py``), on the
CPU.

Counterparts of the reference's lint tests (``tests/test_analysis.py``)
and metric-key tests (``tests/test_irverify.py``): each lint fires on a
minimal snippet in a tmp tree and passes its waivers, and every lint is
quiet on the port's real tree; the metric-key registry holds the port's
keys, the contract is green on the real tree, red on a drifted table and
on a dead documented key, and ``fix`` rewrites the table while still
seeing dead keys. The fixtures are tmp copies of ``REGISTRY.md`` and of
README's port section.

The reference's own ``lint_metric_keys`` on the real tree finds nothing
as well: no key that only the port emits has reached README's prose.
"""

from __future__ import annotations

import os
import textwrap

import pytest

from pyruhvro_tpu.analysis import lints as ref_lints
from pyruhvro_tpu_torch.analysis import lints
from pyruhvro_tpu_torch.runtime import knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "pyruhvro_tpu_torch"


def _snippet(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return str(p)


# -- the four AST lints ------------------------------------------------------------


def test_lint_env_read_fires(tmp_path):
    bad = _snippet(tmp_path, "bad_env.py", """
        import os
        x = os.environ.get("PYRUHVRO_TPU_SOMETHING", "1")
        y = os.getenv("PYRUHVRO_TPU_OTHER")
        z = os.environ["PYRUHVRO_TPU_THIRD"]
        w = "PYRUHVRO_TPU_FOURTH" in os.environ
    """)
    fs = lints.lint_env_reads([bad], str(tmp_path))
    assert len(fs) == 4 and all(f.rule == "lint.env-read" for f in fs)


def test_lint_env_read_allows_registry_and_nonliteral(tmp_path):
    ok = _snippet(tmp_path, "ok_env.py", """
        import os
        name = "PYRUHVRO_TPU_DYNAMIC"
        v = os.environ.get(name)          # non-literal: propagation code
        os.environ["PYRUHVRO_TPU_SET"] = "1"   # writes are fine
        w = os.environ.get("CUDA_VISIBLE_DEVICES")  # foreign prefix
    """)
    assert lints.lint_env_reads([ok], str(tmp_path)) == []
    # the port's knobs module is the one place that reads them
    reg = tmp_path / PKG / "runtime"
    reg.mkdir(parents=True)
    (reg / "knobs.py").write_text(
        'import os\nx = os.environ.get("PYRUHVRO_TPU_X")\n')
    assert lints.lint_env_reads([str(reg / "knobs.py")],
                                str(tmp_path)) == []


def test_lint_signal_safety_fires(tmp_path):
    bad = _snippet(tmp_path, "bad_signal.py", """
        import signal
        from . import metrics

        def helper():
            metrics.inc("boom")

        def handler(signum, frame):
            helper()

        signal.signal(signal.SIGUSR1, handler)
    """)
    fs = lints.lint_signal_safety([bad], str(tmp_path))
    assert any("metrics.inc" in f.message for f in fs), fs


def test_lint_signal_safety_lock_and_acquire(tmp_path):
    bad = _snippet(tmp_path, "bad_lock.py", """
        import signal
        import threading
        _lock = threading.Lock()

        def handler(signum, frame):
            _lock.acquire()
            with _lock:
                pass
            ok = _lock.acquire(blocking=False)  # this one is fine

        signal.signal(signal.SIGUSR2, handler)
    """)
    fs = lints.lint_signal_safety([bad], str(tmp_path))
    assert len([f for f in fs if "acquire" in f.message]) == 1, fs
    assert any("with _lock" in f.message for f in fs), fs


def test_lint_signal_safety_flags_yield_points(tmp_path):
    bad = _snippet(tmp_path, "bad_yield.py", """
        import signal
        from . import schedtest

        def handler(signum, frame):
            schedtest.yield_point("x")

        signal.signal(signal.SIGUSR1, handler)
    """)
    fs = lints.lint_signal_safety([bad], str(tmp_path))
    assert any("schedtest.yield_point" in f.message for f in fs), fs


def test_lint_signal_safety_waiver(tmp_path):
    ok = _snippet(tmp_path, "waived.py", """
        import signal
        from . import metrics

        def handler(signum, frame):
            # signal-ok: audited — gated to the non-signal path
            metrics.inc("boom")

        signal.signal(signal.SIGUSR1, handler)
    """)
    assert lints.lint_signal_safety([ok], str(tmp_path)) == []


def test_lint_json_write_fires_and_allows_streams(tmp_path):
    bad = _snippet(tmp_path, "bad_json.py", """
        import json
        import sys
        with open("x.json", "w") as f:
            json.dump({"a": 1}, f)
        json.dump({"a": 1}, sys.stdout)   # streams are fine
        s = json.dumps({"a": 1})          # strings are fine
    """)
    fs = lints.lint_json_writes([bad], str(tmp_path))
    assert len(fs) == 1 and fs[0].rule == "lint.json-write"


def test_lint_fault_seam_fires(tmp_path):
    bad = _snippet(tmp_path, "bad_seam.py", """
        from . import faults, metrics

        def seam():
            try:
                faults.fire("native_build")
            except faults.FaultInjected:
                return None            # swallowed, uncounted

        def bare():
            try:
                seam()
            except:
                pass
    """)
    fs = lints.lint_fault_seams([bad], str(tmp_path))
    assert len(fs) == 2, fs
    assert any("bare" in f.message for f in fs), fs


def test_lint_fault_seam_counted_passes(tmp_path):
    ok = _snippet(tmp_path, "ok_seam.py", """
        from . import faults, metrics

        def seam():
            try:
                faults.fire("native_build")
            except faults.FaultInjected:
                metrics.inc("fault.degraded.native_build")
                return None

        def reraise():
            try:
                seam()
            except faults.FaultInjected:
                raise RuntimeError("wrapped")
    """)
    assert lints.lint_fault_seams([ok], str(tmp_path)) == []


def test_lints_cover_the_port_tree():
    files = lints.iter_py_files(REPO)
    rels = {os.path.relpath(p, REPO).replace(os.sep, "/") for p in files}
    assert f"{PKG}/runtime/knobs.py" in rels and f"{PKG}/api.py" in rels
    assert not any(r.startswith("pyruhvro_tpu/") for r in rels)


def test_lints_quiet_on_real_tree():
    assert lints.run_lints(REPO) == []


# -- the metric-key contract ----------------------------------------------------------


def test_metric_key_registry_contents():
    reg = lints.metric_key_registry(REPO)
    assert "decode.fused" in reg
    assert "vm.op.string" in reg and "vm.op.string_s" in reg
    assert "<op>.quarantined" in reg  # a declared dynamic family
    assert reg["mem.rss_bytes"]["kind"] == "declared"
    # the port's device spans come from telemetry.open_span
    assert reg["device.compile_s"]["kind"] == "span"
    assert reg["device.launch_s"]["kind"] == "span"
    # a conditional of two literal keys gives both
    assert {"device.arena.hits", "device.arena.misses"} <= set(reg)
    # read, never emitted: the port counts no flops
    assert "device.cost.flops" not in reg
    assert "device.sync_waits" in reg
    assert not any(src.startswith(f"{PKG}/analysis/")
                   for r in reg.values() for src in r["sources"])


def test_metric_key_lint_green_on_real_tree():
    assert lints.lint_metric_keys(REPO) == []


def test_reference_metric_key_lint_green_on_real_tree():
    """README's prose outside the port's tables names no key that only
    the port emits (the reference's lint reads all of it)."""
    assert ref_lints.lint_metric_keys(REPO) == []


def test_registry_doc_tables_are_generated():
    with open(os.path.join(REPO, lints.REGISTRY_DOC), encoding="utf-8") as f:
        text = f.read()
    assert knobs.render_markdown_table() in text
    assert lints.render_metric_key_table(
        lints.metric_key_registry(REPO)) in text
    assert lints.port_section(REPO) is not None


def test_registry_table_does_not_follow_the_walk_order(monkeypatch):
    """The table lists each key's first sources in the walk's order: the
    walk is sorted, so a file system that lists a directory in another
    order gives the same table."""
    want = lints.render_metric_key_table(lints.metric_key_registry(REPO))
    walk = os.walk

    def reversed_walk(top, *args, **kwargs):
        for dirpath, dirnames, filenames in walk(top, *args, **kwargs):
            dirnames.reverse()
            filenames.reverse()
            yield dirpath, dirnames, filenames

    monkeypatch.setattr(os, "walk", reversed_walk)
    assert lints.render_metric_key_table(
        lints.metric_key_registry(REPO)) == want


_PORT_README = ("# reference prose with `foo.gone` outside the port\n"
                "<!-- torch-port:start -->\n{body}\n"
                "<!-- torch-port:end -->\n")


def _key_fixture(tmp_path, registry_text, port_prose="port prose"):
    pkg = tmp_path / PKG
    pkg.mkdir(exist_ok=True)
    (pkg / "m.py").write_text(
        "from .runtime import metrics, telemetry\n\n\n"
        "def f(hit):\n"
        '    metrics.inc("foo.bar")\n'
        '    metrics.inc("foo.baz_s", 0.1)\n'
        '    telemetry.open_span("foo.span_s")\n'
        '    metrics.inc("foo.hit" if hit else "foo.miss")\n')
    (pkg / "REGISTRY.md").write_text(registry_text)
    (tmp_path / "README.md").write_text(_PORT_README.format(body=port_prose))
    return str(tmp_path)


def _block(table):
    return ("<!-- torch-metric-keys:start -->\n" + table
            + "<!-- torch-metric-keys:end -->\n")


def test_metric_key_fixture_registry(tmp_path):
    reg = lints.metric_key_registry(_key_fixture(tmp_path, ""))
    assert set(reg) == {"foo.bar", "foo.baz_s", "foo.span_s", "foo.hit",
                        "foo.miss"}
    assert reg["foo.baz_s"]["kind"] == "seconds"
    assert reg["foo.span_s"]["kind"] == "span"


def test_metric_key_lint_red_on_drift(tmp_path):
    root = _key_fixture(tmp_path, "x\n" + _block("stale\n"))
    fs = lints.lint_metric_keys(root)
    assert any("drifted" in f.message for f in fs)
    assert all(f.path == lints.REGISTRY_DOC for f in fs)


def test_metric_key_lint_red_on_missing_markers(tmp_path):
    root = _key_fixture(tmp_path, "no table here\n")
    fs = lints.lint_metric_keys(root)
    assert any("markers missing" in f.message for f in fs)
    (tmp_path / "README.md").write_text("no port section\n")
    fs = lints.lint_metric_keys(root)
    assert any(f.path == "README.md" and "port section" in f.message
               for f in fs)


@pytest.mark.parametrize("where", ["registry", "readme"])
def test_metric_key_lint_red_on_dead_doc_key(tmp_path, where):
    table = lints.render_metric_key_table(
        lints.metric_key_registry(_key_fixture(tmp_path, "")))
    prose = "uses `foo.bar` and the gone `foo.vanished` key\n"
    if where == "registry":
        root = _key_fixture(tmp_path, prose + _block(table))
    else:
        root = _key_fixture(tmp_path, _block(table), port_prose=prose)
    fs = lints.lint_metric_keys(root)
    dead = [f for f in fs if "foo.vanished" in f.message]
    assert len(dead) == 1, fs
    assert dead[0].path == (lints.REGISTRY_DOC if where == "registry"
                            else "README.md")
    if where == "readme":  # the line within all of README
        lines = (tmp_path / "README.md").read_text().splitlines()
        assert "foo.vanished" in lines[dead[0].line - 1]
    assert not any("foo.bar'" in f.message for f in fs)
    # README's prose outside the port section is the reference's
    assert not any("foo.gone" in f.message for f in fs)


def test_metric_key_lint_fix_rewrites(tmp_path):
    root = _key_fixture(tmp_path, _block("stale\n"))
    assert lints.lint_metric_keys(root, fix=True) == []
    assert lints.lint_metric_keys(root) == []
    text = (tmp_path / PKG / "REGISTRY.md").read_text()
    assert "`foo.bar`" in text and "`foo.baz_s`" in text
    assert "`foo.span_s`" in text and "`foo.miss`" in text


def test_metric_key_lint_fix_still_sees_dead_keys(tmp_path):
    """In fix mode the dead-key scan runs over the rewritten text (stale
    offsets would misalign the prose after a longer stale table)."""
    stale = "stale row\n" * 40  # much longer than the fresh table
    root = _key_fixture(tmp_path, _block(stale)
                        + "and the gone `foo.vanished` key\n")
    fs = lints.lint_metric_keys(root, fix=True)
    assert any("foo.vanished" in f.message for f in fs)
    fs2 = lints.lint_metric_keys(root)
    assert any("foo.vanished" in f.message for f in fs2)
    assert not any("drifted" in f.message for f in fs2)
