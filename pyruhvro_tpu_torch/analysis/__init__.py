"""The port's static-analysis plane (copy of
``pyruhvro_tpu/analysis/__init__.py``: :class:`Finding`).

The five passes:

1. :mod:`.contracts` — the cross-language opcode contract checker. The
   host tier's decode path mirrors one contract in four hand-synchronised
   places (``hostpath/program.py``'s constants, the C++ enums in
   ``csrc/host/host_vm_core.h`` / ``extract_core.h``, the profiler's
   pseudo-op slots, and the specialiser's embedded ``kOps``/``kAux``
   tables); this pass makes any divergence in value, arity, aux kind or
   op-name string a machine-checked failure.
2. :mod:`.lints` — the AST invariant lints: knob reads outside
   ``runtime/knobs.py``, signal-unsafe metrics and locks, non-atomic JSON
   writes, uncounted fault-seam swallows, and the metric-key contract
   against ``pyruhvro_tpu_torch/REGISTRY.md``.
3. :mod:`.concurrency` — the lock graph (order cycles, locks held across
   blocking seams, the card's ``synchronize`` among them) and the
   guarded-by discipline over ``runtime/`` and ``serving/`` globals.
4. :mod:`.irverify` — the IR verification plane: abstract interpretation
   over the host tier's opcode programs (the generic lowering, the
   superoptimizer's rewrites and the specialiser's generated units):
   type/effect discipline, wire progress, int32/int64 overflow lanes
   against anchored native guards, and generic <-> specialised effect
   equivalence, over the schema-construct lattice with a seeded mutation
   self-test.
5. The sanitizer builds: :mod:`..runtime.native`'s ASan+UBSan flavour
   (``PYRUHVRO_TPU_NATIVE_SAN``) and ThreadSanitizer flavour
   (``PYRUHVRO_TPU_TSAN``) of the host modules, whose differential suites
   ``scripts/torch_analysis_gate.py --sanitize`` / ``--tsan`` run.

``scripts/torch_analysis_gate.py`` runs them all and fails on any
finding.

Every pass reports plain :class:`Finding` rows.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Finding:
    """One analysis finding: where, which rule, and what diverged."""

    rule: str      # e.g. "contract.opkind", "lint.env-read"
    path: str      # repo-relative file
    message: str
    line: int = 0

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}

    def __str__(self) -> str:  # gate output: one grep-able line each
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


__all__ = ["Finding"]
