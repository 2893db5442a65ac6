"""Verifier-backed opcode superoptimizer (copy of
``pyruhvro_tpu/hostpath/optimize.py``).

Peephole rewrites over compiled host programs (:mod:`.program`), in
the AwkwardForth tradition of optimizing a batched-record DSL program
rather than the decoder: the schema is already lowered to a flat
opcode array, so adjacent fixed-layout field walks can be fused into
bulk ops (``OP_FIXED_RUN`` — the SFVInt-style span-checked member run),
validity tests can be elided under unconditional record chains
(``FLAG_ALWAYS_PRESENT``), and array/map string-item loops can be
pre-decided at compile time (``FLAG_STR_ITEMS``).

Every rewrite is PROOF-CARRYING: the optimized program is re-verified
against the original's effects by the abstract interpreter
(:func:`..analysis.irverify.verify_optimized`) — flatten-equality back
to the raw program plus re-derivation of every flag's claim. A program
that fails the oracle is rejected and COUNTED (``optimize.rejected``),
never run; the caller keeps the raw program. The raw program also
stays the source of truth for the specializer and the encode bound
(hostpath/codec.py keeps both).

The rewrites are pure tree transforms: parse the flat array into the
subtree structure ``nops`` already encodes, rewrite nodes, re-flatten.
:func:`strip_optimizations` is the exact inverse the oracle uses —
dropping every ``OP_FIXED_RUN`` header and clearing the flag bits must
reproduce the original array byte-for-byte.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from . import program as hp

__all__ = ["optimize_program", "strip_optimizations", "OptimizeStats"]

# leaves a fused run may absorb: fixed wire layout, no aux, no subtree
_FUSABLE_MIN_WIRE = {
    hp.OP_INT: 1, hp.OP_LONG: 1, hp.OP_FLOAT: 4, hp.OP_DOUBLE: 8,
    hp.OP_BOOL: 1,
}
# exact-width members (wire bytes == min_wire always): only an
# all-exact run may take the engines' bulk lane, because one upfront
# span check must justify every unchecked member read that follows —
# a varint member (int/long) can legally exceed its floor
_EXACT_WIDTH = (hp.OP_FLOAT, hp.OP_DOUBLE, hp.OP_BOOL)


@dataclass
class _Node:
    kind: int
    a: int
    b: int
    col: int
    pad: int
    aux: Optional[tuple]
    children: List["_Node"] = field(default_factory=list)


def _parse(ops, op_aux) -> _Node:
    """Flat array -> subtree structure (the inverse of the lowering's
    ``nops`` tiling; exact by the verifier's structure pass)."""
    aux = op_aux or tuple(None for _ in range(len(ops)))

    def node(pc: int) -> Tuple[_Node, int]:
        kind, a, b, col, nops, pad = (int(x) for x in ops[pc])
        nd = _Node(kind, a, b, col, pad, aux[pc])
        p, stop = pc + 1, pc + nops
        while p < stop:
            child, p = node(p)
            nd.children.append(child)
        if p != stop:
            raise ValueError(f"op {pc}: children end at {p}, nops "
                             f"claims {stop}")
        return nd, stop

    root, end = node(0)
    if end != len(ops):
        raise ValueError(f"root subtree ends at {end} of {len(ops)} ops")
    return root


def _flatten(root: _Node, drop_headers: bool = False):
    """Tree -> (ops int32[n,6], op_aux). ``drop_headers`` splices
    ``OP_FIXED_RUN`` members back into their parent and clears the pad
    flags — the raw-program inverse the equivalence oracle diffs."""
    rows: List[Optional[tuple]] = []
    auxes: List[Optional[tuple]] = []

    def emit(nd: _Node) -> None:
        if drop_headers and nd.kind == hp.OP_FIXED_RUN:
            for c in nd.children:
                emit(c)
            return
        i = len(rows)
        rows.append(None)
        auxes.append(nd.aux)
        for c in nd.children:
            emit(c)
        pad = 0 if drop_headers else nd.pad
        rows[i] = (nd.kind, nd.a, nd.b, nd.col, len(rows) - i, pad)

    emit(root)
    ops = np.ascontiguousarray(np.array(rows, np.int32))
    return ops, tuple(auxes)


# ---------------------------------------------------------------------------
# the three passes
# ---------------------------------------------------------------------------


def _fuse_fixed_runs(nd: _Node, stats: dict) -> None:
    """Wrap every maximal run of >= 2 consecutive fixed-layout leaf
    fields of a record in one ``OP_FIXED_RUN`` header. ``a=1`` (bulk-
    lane eligible) only when every member is exact-width; a run with
    varint members is grouped for dispatch but decoded per-member."""
    for c in nd.children:
        _fuse_fixed_runs(c, stats)
    if nd.kind != hp.OP_RECORD:
        return
    out: List[_Node] = []
    run: List[_Node] = []

    def close() -> None:
        if len(run) >= 2:
            width = sum(_FUSABLE_MIN_WIRE[m.kind] for m in run)
            exact = all(m.kind in _EXACT_WIDTH for m in run)
            out.append(_Node(hp.OP_FIXED_RUN, int(exact), width, -1, 0,
                             None, list(run)))
            stats["fused_runs"] += 1
            stats["fused_members"] += len(run)
        else:
            out.extend(run)
        run.clear()

    for c in nd.children:
        if c.kind in _FUSABLE_MIN_WIRE and not c.children and c.aux is None:
            run.append(c)
        else:
            close()
            out.append(c)
    close()
    nd.children = out


def _elide_dead_validity(nd: _Node, uncond: bool, stats: dict) -> None:
    """``FLAG_ALWAYS_PRESENT`` on fused headers whose every ancestor is
    a record (or another fused header): the walk can never reach them
    with ``present=false``, so the bulk lane may skip the test. The
    claim is re-proved by the oracle, not trusted."""
    if nd.kind == hp.OP_FIXED_RUN and uncond:
        nd.pad |= hp.FLAG_ALWAYS_PRESENT
        stats["always_present"] += 1
    inner = uncond and nd.kind in (hp.OP_RECORD, hp.OP_FIXED_RUN)
    for c in nd.children:
        _elide_dead_validity(c, inner, stats)


def _widen_string_blocks(nd: _Node, stats: dict) -> None:
    """``FLAG_STR_ITEMS`` on arrays/maps whose item subtree is exactly
    one string leaf: the engines' block loop takes the read-len /
    bulk-copy lane without re-deriving the shape per call."""
    for c in nd.children:
        _widen_string_blocks(c, stats)
    if nd.kind in (hp.OP_ARRAY, hp.OP_MAP) and len(nd.children) == 1:
        item = nd.children[0]
        if item.kind == hp.OP_STRING and not item.children:
            nd.pad |= hp.FLAG_STR_ITEMS
            stats["str_items"] += 1


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@dataclass
class OptimizeStats:
    applied: bool = False
    fused_runs: int = 0
    fused_members: int = 0
    always_present: int = 0
    str_items: int = 0
    rejected: bool = False
    findings: tuple = ()


def _rebuild(prog, ops, op_aux):
    return hp.HostProgram(
        ir=prog.ir, ops=ops, cols=prog.cols, coltypes=prog.coltypes,
        regions=prog.regions, region_parents=prog.region_parents,
        op_aux=op_aux,
    )


def strip_optimizations(prog):
    """The optimized program with every rewrite undone: fused headers
    spliced out, pad flags cleared, ancestor ``nops`` restored. The
    equivalence oracle diffs this against the raw program byte-for-byte
    — a rewrite that cannot round-trip is by definition not
    effect-preserving."""
    root = _parse(prog.ops, prog.op_aux)
    ops, op_aux = _flatten(root, drop_headers=True)
    return _rebuild(prog, ops, op_aux)


# guard/consumer anchor scan for the oracle, once per process (the
# native sources don't change under a running interpreter)
_SCAN_CACHE: Optional[tuple] = None


def _scan_anchors():
    global _SCAN_CACHE
    if _SCAN_CACHE is None:
        from ..analysis import irverify
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        _SCAN_CACHE = (irverify.scan_native_guards(root),
                       irverify.scan_aux_consumers(root))
    return _SCAN_CACHE


def optimize_program(prog, verify: bool = True):
    """Apply the rewrite passes to ``prog``; returns
    ``(program, OptimizeStats)``. With ``verify`` (the default and the
    only mode any production caller uses) the optimized program is
    accepted ONLY when the irverify equivalence oracle reports zero
    findings — otherwise the ORIGINAL program is returned with
    ``stats.rejected`` set and ``optimize.rejected`` counted, so a
    buggy rewrite can cost performance but never correctness."""
    from ..runtime import metrics

    stats = OptimizeStats()
    counters = {"fused_runs": 0, "fused_members": 0, "always_present": 0,
                "str_items": 0}
    root = _parse(prog.ops, prog.op_aux)
    _fuse_fixed_runs(root, counters)
    _elide_dead_validity(root, True, counters)
    _widen_string_blocks(root, counters)
    stats.fused_runs = counters["fused_runs"]
    stats.fused_members = counters["fused_members"]
    stats.always_present = counters["always_present"]
    stats.str_items = counters["str_items"]
    if not (stats.fused_runs or stats.str_items):
        return prog, stats  # nothing to do; keep the raw array identity

    ops, op_aux = _flatten(root)
    opt = _rebuild(prog, ops, op_aux)
    if verify:
        from ..analysis import irverify

        guards, consumers = _scan_anchors()
        findings = irverify.verify_optimized(prog, opt, guards, consumers)
        if findings:
            stats.rejected = True
            stats.findings = tuple(f.to_dict() for f in findings)
            metrics.inc("optimize.rejected")
            return prog, stats
    stats.applied = True
    metrics.inc("optimize.applied")
    if stats.fused_runs:
        metrics.inc("optimize.fused_runs", float(stats.fused_runs))
    return opt, stats
