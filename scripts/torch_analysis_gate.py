#!/usr/bin/env python
"""The port's static-analysis gate: one command over
``pyruhvro_tpu_torch/``, exit non-zero on any finding.

Usage, from the repository root::

    python scripts/torch_analysis_gate.py              # every static pass
    python scripts/torch_analysis_gate.py --ir         # + the IR verifier
    python scripts/torch_analysis_gate.py --sanitize   # + ASan/UBSan suites
    python scripts/torch_analysis_gate.py --tsan       # + TSan suites

Passes, in the order of the reference's gate (``scripts/analysis_gate.py``,
which drives the JAX package and stays its own):

1. the cross-language opcode contract checker
   (``pyruhvro_tpu_torch/analysis/contracts.py``);
2. the AST lints (``analysis/lints.py``): knob reads outside the
   registry, signal-unsafe metrics and locks, non-atomic JSON writes,
   uncounted fault-seam swallows, and the metric-key contract against
   the table of ``pyruhvro_tpu_torch/REGISTRY.md`` (``--fix-metric-keys``
   rewrites it);
3. the concurrency pass (``analysis/concurrency.py``): lock-order
   cycles, locks held across blocking seams, the guarded-by discipline;
   its lock inventory, edges and waivers go into the report;
4. knob-table drift: the table of ``REGISTRY.md`` between
   ``<!-- torch-knob-table:start/end -->`` must equal
   ``knobs.render_markdown_table()`` (``--fix-knob-table`` rewrites it);
5. with ``--ir``, the IR verification plane
   (``analysis/irverify.py`` ``run_ir_verification``);
6. with ``--sanitize`` / ``--tsan``, the port's native differential
   suites under the ASan+UBSan or ThreadSanitizer preload, against the
   host modules' sanitized flavours. A red suite is retried once in a
   fresh interpreter; a real sanitizer report is never retried.

The report goes only to ``build/pyruhvro_tpu_torch/ANALYSIS_REPORT.json``
(``--report`` moves it), written atomically; the IR verifier's report is
part of it.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pyruhvro_tpu_torch.analysis import Finding, concurrency  # noqa: E402
from pyruhvro_tpu_torch.analysis.contracts import check_contracts  # noqa: E402
from pyruhvro_tpu_torch.analysis.lints import (REGISTRY_DOC,  # noqa: E402
                                               run_lints)
from pyruhvro_tpu_torch.runtime import fsio, knobs  # noqa: E402

_TABLE_START = "<!-- torch-knob-table:start -->"
_TABLE_END = "<!-- torch-knob-table:end -->"
REPORT = os.path.join("build", "pyruhvro_tpu_torch", "ANALYSIS_REPORT.json")

# the native differential suites: the host tier against the reference's
# and the oracle, the checked writer on the VM (a sanitized build pins
# the VM, so the specialised engine's cases are left out), the
# malformed-input fuzz
_SAN_SUITES = (
    ("tests/test_torch_hostpath.py", ()),
    ("tests/test_torch_bounds.py", ("-k", "not spec")),
    ("tests/test_torch_fuzz.py", ("-k", "host")),
)
# the same suites hunting races: the threaded and shard-runner decodes
# of the hostpath suite, and the host-tier fuzz
_TSAN_SUITES = (
    ("tests/test_torch_hostpath.py", ()),
    ("tests/test_torch_fuzz.py", ("-k", "host")),
)

_SAN_REPORT_RE = re.compile(
    r"AddressSanitizer|UndefinedBehaviorSanitizer|runtime error:|"
    r"LeakSanitizer|heap-buffer-overflow|heap-use-after-free")
_TSAN_REPORT_RE = re.compile(
    r"WARNING: ThreadSanitizer|ThreadSanitizer: data race|"
    r"ThreadSanitizer: reported \d+ warnings")


def check_knob_table(root: str, fix: bool = False):
    """The knob table of ``REGISTRY.md`` must equal the registry's
    rendering."""
    path = os.path.join(root, REGISTRY_DOC)
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return [Finding("docs.knob-table", REGISTRY_DOC,
                        f"{REGISTRY_DOC} unreadable")]
    want = knobs.render_markdown_table()
    m = re.search(re.escape(_TABLE_START) + r"\n(.*?)" + re.escape(_TABLE_END),
                  text, flags=re.S)
    if m is None:
        return [Finding(
            "docs.knob-table", REGISTRY_DOC,
            f"knob-table markers missing ({_TABLE_START} ... {_TABLE_END})"
            " — the table is generated from runtime/knobs.py")]
    if m.group(1) == want:
        return []
    if fix:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text[: m.start(1)] + want + text[m.end(1):])
        print(f"torch_analysis_gate: rewrote the knob table of "
              f"{REGISTRY_DOC} from the registry")
        return []
    return [Finding(
        "docs.knob-table", REGISTRY_DOC,
        "knob table drifted from runtime/knobs.py — run "
        "scripts/torch_analysis_gate.py --fix-knob-table",
        text[: m.start(1)].count("\n") + 1)]


def knob_inventory() -> list:
    """The registry as JSON rows: name, type, default, and the value when
    set."""
    out = []
    for name, default in knobs.registry().items():
        row = {"name": name, "default": default,
               "choices": list(knobs.CHOICES.get(name, ()))}
        if name in os.environ:
            row["set"] = os.environ[name]
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# sanitizer legs
# ---------------------------------------------------------------------------


def _runtime_libs(names):
    gxx = shutil.which("g++")
    if not gxx:
        return None
    libs = []
    for lib in names:
        p = subprocess.run([gxx, "-print-file-name=" + lib],
                           capture_output=True, text=True).stdout.strip()
        if not p or p == lib or not os.path.exists(p):
            return None
        libs.append(p)
    return libs


def _run_one_suite(suite, env: dict, timeout: int, report_re):
    path, extra = suite
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", path, *extra, "-q", "-m",
             "not slow", "-p", "no:cacheprovider", "-p", "no:randomly"],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=timeout)
        rc, out = proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as e:
        rc = -1
        out = ((e.stdout or "") if isinstance(e.stdout, str) else ""
               ) + f"\n[torch_analysis_gate] suite timed out after {timeout}s"
    return {"suite": " ".join((path,) + tuple(extra)), "returncode": rc,
            "seconds": round(time.monotonic() - t0, 1),
            "sanitizer_report": bool(report_re.search(out)),
            "tail": out.splitlines()[-8:]}


def _drive_suites(suites, env, timeout, summary, tag, what, report_re):
    """Run each suite; a red one without a sanitizer report runs once
    more in a fresh interpreter, and that run is the verdict."""
    findings = []
    for suite in suites:
        res = _run_one_suite(suite, env, timeout, report_re)
        res["isolated_rerun"] = False
        if res["returncode"] != 0 and not res["sanitizer_report"]:
            res = _run_one_suite(suite, env, timeout, report_re)
            res["isolated_rerun"] = True
        summary["suites"].append(res)
        red = res["returncode"] != 0 or res["sanitizer_report"]
        print(f"torch_analysis_gate: {tag} {res['suite']}: "
              f"{'RED' if red else 'clean'} ({res['seconds']}s"
              + (", isolated rerun" if res["isolated_rerun"] else "") + ")")
        if red:
            findings.append(Finding(
                f"{tag}.suite", res["suite"],
                ("sanitizer report in output" if res["sanitizer_report"]
                 else f"suite failed (rc={res['returncode']}) under {what}")
                + " — tail: " + " | ".join(res["tail"][-3:])))
    return findings


def _suite_env(**extra) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               # the interpreter VM serves: the specialised units are
               # built without a sanitizer
               PYRUHVRO_TPU_NO_SPECIALIZE="1",
               PYRUHVRO_TPU_SAMPLE_BUDGET="0", PYRUHVRO_TPU_NO_AUDIT="1",
               PYRUHVRO_TPU_NO_TIMELINE="1")
    for name in ("PYRUHVRO_TPU_NATIVE_SAN", "PYRUHVRO_TPU_TSAN",
                 "PYRUHVRO_TPU_NATIVE_PROF"):
        env.pop(name, None)
    env.update(extra)
    return env


def run_sanitizer_suites(timeout: int = 1800):
    """The differential suites against the ASan+UBSan flavour."""
    libs = _runtime_libs(("libasan.so", "libubsan.so"))
    if libs is None:
        return ({"ran": False,
                 "skipped": "no g++/libasan/libubsan on this host"},
                [Finding("sanitize.toolchain", "scripts/torch_analysis_gate.py",
                         "sanitizer runtimes unavailable — the sanitizer "
                         "leg cannot run")])
    env = _suite_env(
        PYRUHVRO_TPU_NATIVE_SAN="1", LD_PRELOAD=" ".join(libs),
        # CPython's interned objects are not leaks; the runtime comes by
        # preload, not by the link order
        ASAN_OPTIONS="detect_leaks=0:verify_asan_link_order=0",
        UBSAN_OPTIONS="print_stacktrace=1")
    summary = {"ran": True, "preload": libs, "suites": []}
    findings = _drive_suites(_SAN_SUITES, env, timeout, summary, "sanitize",
                             "ASan/UBSan", _SAN_REPORT_RE)
    return summary, findings


def run_tsan_suites(timeout: int = 1800):
    """The differential suites against the ThreadSanitizer flavour."""
    libs = _runtime_libs(("libtsan.so",))
    if libs is None:
        return ({"ran": False, "skipped": "no g++/libtsan on this host"},
                [Finding("tsan.toolchain", "scripts/torch_analysis_gate.py",
                         "ThreadSanitizer runtime unavailable — the TSan "
                         "leg cannot run")])
    supp = os.path.join(REPO, os.path.dirname(REPORT), "tsan.supp")
    os.makedirs(os.path.dirname(supp), exist_ok=True)
    with open(supp, "w", encoding="utf-8") as f:
        # pyarrow's allocator is not instrumented: its frees race with
        # the instrumented reads in the sanitizer's view
        f.write("race:libarrow\n")
    env = _suite_env(
        PYRUHVRO_TPU_TSAN="1", LD_PRELOAD=" ".join(libs),
        TSAN_OPTIONS=f"halt_on_error=0 suppressions={supp}")
    summary = {"ran": True, "preload": libs, "suites": []}
    findings = _drive_suites(_TSAN_SUITES, env, timeout, summary, "tsan",
                             "ThreadSanitizer", _TSAN_REPORT_RE)
    return summary, findings


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="the tree to check (default: this checkout)")
    ap.add_argument("--report", default=None,
                    help=f"where the report goes (default: <root>/{REPORT})")
    ap.add_argument("--fix-knob-table", action="store_true",
                    help="rewrite REGISTRY.md's knob table from the "
                         "registry instead of failing on drift")
    ap.add_argument("--fix-metric-keys", action="store_true",
                    help="rewrite REGISTRY.md's metric-key table from the "
                         "extracted keys instead of failing on drift")
    ap.add_argument("--ir", action="store_true",
                    help="run the IR verification plane")
    ap.add_argument("--sanitize", action="store_true",
                    help="also run the native differential suites under "
                         "ASan+UBSan")
    ap.add_argument("--tsan", action="store_true",
                    help="also run the native differential suites under "
                         "ThreadSanitizer")
    ap.add_argument("--skip-generative", action="store_true",
                    help="skip the import-based specialiser-table check")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    report_path = args.report or os.path.join(root, REPORT)

    passes, seconds = {}, {}

    def timed(name, fn):
        t0 = time.monotonic()
        out = fn()
        seconds[name] = round(time.monotonic() - t0, 3)
        return out

    passes["contracts"] = timed("contracts", lambda: check_contracts(
        root, generative=not args.skip_generative))
    passes["lints"] = timed("lints", lambda: run_lints(
        root, fix_metric_keys=args.fix_metric_keys))
    conc_findings, conc_info = timed("concurrency",
                                     lambda: concurrency.analyze(root))
    passes["concurrency"] = conc_findings
    passes["knob_table"] = check_knob_table(root, fix=args.fix_knob_table)

    ir_summary = {"ran": False}
    if args.ir:
        from pyruhvro_tpu_torch.analysis.irverify import run_ir_verification

        ir_findings, ir_report = timed("ir",
                                       lambda: run_ir_verification(root))
        passes["ir"] = ir_findings
        cov = ir_report["lattice"]["coverage"]
        ir_summary = {"ran": True, "report": ir_report}
        print(f"torch_analysis_gate: ir lattice {cov['verified']}/"
              f"{cov['constructible']} verified ({cov['coverage_pct']}%), "
              "mutation self-test "
              + ("all caught" if ir_report["mutation"]["all_caught"]
                 else "ESCAPES"))

    sanitizer = {"ran": False}
    if args.sanitize:
        sanitizer, passes["sanitize"] = run_sanitizer_suites()
    tsan = {"ran": False}
    if args.tsan:
        tsan, passes["tsan"] = run_tsan_suites()

    all_findings = [f for fs in passes.values() for f in fs]
    report = {
        "schema_version": 1,
        "generated_by": "scripts/torch_analysis_gate.py",
        "time": time.time(),
        "passes": {name: {"count": len(fs),
                          "findings": [f.to_dict() for f in fs]}
                   for name, fs in passes.items()},
        "seconds": seconds,
        "finding_count": len(all_findings),
        "knobs": knob_inventory(),
        "sanitizer": sanitizer,
        "tsan": tsan,
        "ir": ir_summary,
        "concurrency": conc_info,
    }
    os.makedirs(os.path.dirname(report_path), exist_ok=True)
    fsio.atomic_write_json(report_path, report, indent=1)

    for f in all_findings:
        print(f)
    print(f"torch_analysis_gate: {len(all_findings)} finding(s); report -> "
          f"{os.path.relpath(report_path, root)}")
    return 1 if all_findings else 0


if __name__ == "__main__":
    sys.exit(main())
