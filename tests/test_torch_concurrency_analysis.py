"""The port's concurrency pass (``pyruhvro_tpu_torch/analysis/concurrency.py``),
on the CPU.

Counterparts of the reference's analyzer tests (``tests/test_concurrency.py``):
each defect class is seeded into a minimal tmp tree of the port's package
and must be caught, each waiver must pass, and the pass must be quiet on
the port's real tree. One case more: a lock held across the card's wait,
``torch.cuda.synchronize()`` (or an ``Event``'s or a ``Stream``'s), is a
``conc.blocking-seam``.
"""

from __future__ import annotations

import os
import textwrap

import pytest

from pyruhvro_tpu_torch.analysis import concurrency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "pyruhvro_tpu_torch"


def _tree(tmp_path, files):
    """Write a minimal package tree under tmp and analyze it."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return concurrency.analyze(str(tmp_path))


def test_analyzer_catches_lock_order_inversion(tmp_path):
    fs, _ = _tree(tmp_path, {f"{PKG}/mod.py": """
        import threading
        _a = threading.Lock()
        _b = threading.Lock()

        def one():
            with _a:
                with _b:
                    pass

        def two():
            with _b:
                with _a:
                    pass
    """})
    assert any(f.rule == "conc.lock-order" and "cycle" in f.message
               for f in fs), fs


def test_analyzer_catches_interprocedural_inversion(tmp_path):
    """The cycle only exists through the call graph, across modules."""
    fs, _ = _tree(tmp_path, {
        f"{PKG}/a.py": """
            import threading
            from . import b
            _la = threading.Lock()

            def fa():
                with _la:
                    b.fb_inner()

            def fa_inner():
                with _la:
                    pass
        """,
        f"{PKG}/b.py": """
            import threading
            from . import a
            _lb = threading.Lock()

            def fb():
                with _lb:
                    a.fa_inner()

            def fb_inner():
                with _lb:
                    pass
        """,
    })
    assert any(f.rule == "conc.lock-order" and "cycle" in f.message
               for f in fs), fs


def test_analyzer_catches_self_deadlock(tmp_path):
    fs, _ = _tree(tmp_path, {f"{PKG}/mod.py": """
        import threading
        _a = threading.Lock()

        def oops():
            with _a:
                with _a:
                    pass
    """})
    assert any(f.rule == "conc.lock-order" and "self-deadlock"
               in f.message for f in fs), fs


def test_analyzer_rlock_reentry_allowed(tmp_path):
    fs, _ = _tree(tmp_path, {f"{PKG}/mod.py": """
        import threading
        _a = threading.RLock()

        def fine():
            with _a:
                with _a:
                    pass
    """})
    assert fs == [], fs


def test_analyzer_catches_blocking_seam(tmp_path):
    fs, _ = _tree(tmp_path, {f"{PKG}/mod.py": """
        import subprocess
        import threading
        _a = threading.Lock()

        def compile_under_lock():
            with _a:
                subprocess.run(["nvcc"])
    """})
    assert any(f.rule == "conc.blocking-seam" and "subprocess.run"
               in f.message for f in fs), fs


@pytest.mark.parametrize("wait", ["torch.cuda.synchronize()",
                                  "done.synchronize()",
                                  "torch.cuda.current_stream().synchronize()"])
def test_analyzer_catches_a_lock_held_across_the_cards_wait(tmp_path, wait):
    fs, _ = _tree(tmp_path, {f"{PKG}/ops/mod.py": f"""
        import threading
        import torch
        _a = threading.Lock()

        def wait_under_lock(done):
            with _a:
                {wait}
    """})
    seams = [f for f in fs if f.rule == "conc.blocking-seam"]
    assert len(seams) == 1 and ".synchronize()" in seams[0].message, fs


def test_analyzer_sees_the_cards_wait_through_a_call(tmp_path):
    fs, _ = _tree(tmp_path, {f"{PKG}/ops/mod.py": """
        import threading
        import torch
        _a = threading.Lock()

        def drain():
            torch.cuda.synchronize()

        def drain_under_lock():
            with _a:
                drain()
    """})
    assert any(f.rule == "conc.blocking-seam" and "drain()" in f.message
               for f in fs), fs


def test_analyzer_blocking_seam_via_fault_site_and_waiver(tmp_path):
    src = """
        import threading
        from .runtime import faults
        _a = threading.Lock()

        def seam_under_lock():
            with _a:
                faults.fire("vm_decode")
    """
    fs, _ = _tree(tmp_path, {
        f"{PKG}/mod.py": src,
        f"{PKG}/runtime/faults.py": "def fire(site):\n    pass\n",
    })
    assert any(f.rule == "conc.blocking-seam" for f in fs), fs
    waived = src.replace(
        'faults.fire("vm_decode")',
        '# blocking-ok: test audit\n                '
        'faults.fire("vm_decode")')
    fs2, info2 = _tree(tmp_path, {f"{PKG}/mod.py": waived})
    assert not any(f.rule == "conc.blocking-seam" for f in fs2), fs2
    assert any(w["kind"] == "blocking-ok" for w in info2["waivers"])


@pytest.mark.parametrize("scope", ["runtime", "serving"])
def test_analyzer_catches_unguarded_global(tmp_path, scope):
    fs, _ = _tree(tmp_path, {f"{PKG}/{scope}/bad.py": """
        import threading
        _lock = threading.Lock()
        _cache = {}

        def insert(k, v):
            _cache[k] = v
    """})
    assert any(f.rule == "conc.unguarded-global" and "_cache"
               in f.message for f in fs), fs


def test_analyzer_guarded_global_discipline(tmp_path):
    fs, _ = _tree(tmp_path, {f"{PKG}/runtime/bad.py": """
        import threading
        _lock = threading.Lock()
        _cache = {}  # guarded-by: _lock

        def good(k, v):
            with _lock:
                _cache[k] = v

        def bad(k):
            return _cache.pop(k, None)
    """})
    assert len([f for f in fs
                if f.rule == "conc.guard-discipline"]) == 1, fs


def test_analyzer_lock_free_waiver_and_unknown_guard(tmp_path):
    fs, _ = _tree(tmp_path, {f"{PKG}/runtime/mod.py": """
        import threading
        _lock = threading.Lock()
        # lock-free-ok(append-only registry, GIL-atomic)
        _hooks = []
        _memo = {}  # guarded-by: _no_such_lock
        _locks = {k: threading.Lock() for k in "ab"}
        _loaded = {}  # guarded-by: _locks[key]

        def reg(fn):
            _hooks.append(fn)
    """})
    rules = [f.rule for f in fs]
    assert rules.count("conc.unknown-guard") == 2, fs
    # the per-key dict of locks is state too, and has no note
    assert [f.message for f in fs if f.rule == "conc.unguarded-global"] \
        and all("_locks" in f.message for f in fs
                if f.rule == "conc.unguarded-global"), fs


def test_analyzer_global_rebind_requires_guard(tmp_path):
    fs, _ = _tree(tmp_path, {f"{PKG}/runtime/memo.py": """
        import threading
        _lock = threading.Lock()
        _memo = None

        def set_memo(v):
            global _memo
            _memo = v
    """})
    assert any(f.rule == "conc.unguarded-global" and "_memo"
               in f.message for f in fs), fs


def test_analyzer_quiet_on_real_tree():
    """Zero unwaived findings on the port's tree, with the evidence the
    gate ships: the lock inventory, the edges and the audited waivers."""
    findings, info = concurrency.analyze(REPO)
    assert findings == [], findings
    assert len(info["locks"]) >= 20
    assert info["edges"]
    assert all(lk["module"].startswith(PKG + "/") for lk in info["locks"])
    assert any(w["kind"] == "lock-free-ok" for w in info["waivers"])
    assert any(g["module"].endswith("metrics.py") for g in info["guarded"])
    # the host modules' cache: a module lock guards its stores
    assert {"module": f"{PKG}/runtime/native.py", "name": "_loaded",
            "guard": "_loaded_lock"} in info["guarded"]
    waived = {(w["module"], w["kind"]) for w in info["waivers"]}
    assert (f"{PKG}/runtime/native.py", "lock-free-ok") in waived
    assert (f"{PKG}/runtime/knobs.py", "lock-free-ok") in waived
