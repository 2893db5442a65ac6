"""Concurrency-correctness analyzer: lock graph + guarded-by discipline
(copy of ``pyruhvro_tpu/analysis/concurrency.py``).

The package holds about forty locks across some thirty files, and
races found by hand in review (a signal-handler deadlock, eviction
against a call, a memo against eviction) are exactly what this pass
makes machine-checked, the way the contract checker makes the opcode
contracts machine-checked. Three coupled passes over the package AST:

* ``conc.lock-order`` — every lock acquisition site (``with <lock>:``,
  blocking ``.acquire()``) feeds an **acquired-while-held graph**,
  propagated through the call graph (same-module calls, ``self``
  methods, and cross-module calls through import aliases). Any cycle —
  two locks ever taken in both orders on any path — is a deadlock
  waiting for the right interleaving and fails the gate. Lexically
  nesting the *same* non-reentrant lock is reported as a self-deadlock.
* ``conc.blocking-seam`` — no lock may be held across a **blocking
  seam**: fault-injection sites (``faults.fire`` can sleep for the
  chaos ``hang`` kind — and one sits on every native VM call path),
  subprocess launches (the g++ JIT), future/pool waits (``.result``,
  ``pool.map_chunks*``), ``time.sleep``, ``fsio`` artifact writes,
  extension-module execs and device blocking waits. A lock held across
  seconds of blocking work turns every sibling caller into a convoy —
  or a deadline breach. Audited exceptions carry an inline
  ``# blocking-ok: <reason>`` waiver, and every waiver is exported to
  ``ANALYSIS_REPORT.json`` as the audit trail.
* ``conc.unguarded-global`` / ``conc.guard-discipline`` — every
  module-level **mutable** container (and every name rebound through
  ``global``) in ``runtime/`` must declare its synchronization story:
  ``# guarded-by: <lock>`` ties it to a module lock and every mutation
  site is then checked to sit inside a ``with <lock>:`` block;
  ``# lock-free-ok(<reason>)`` records the audited lock-free designs
  (GIL-atomic single stores, append-only registries). State without a
  declaration fails the gate — the declaration is cheap, and its
  absence is exactly how such races get in.

Soundness posture: the analysis is lexical and deliberately
path-INsensitive (an acquisition behind ``if`` still counts as held),
the same trade the lints make. It cannot see through callables
passed as values (``factory()``, registered hooks) — the deterministic
interleaving harness (``runtime/schedtest.py``) and the TSan build
flavor cover the dynamic remainder; the three planes ship as one gate.

Entry points: :func:`analyze` returns ``(findings, info)`` where
``info`` carries the lock inventory, the full edge list and the audited
waiver list for the gate's report; ``scripts/torch_analysis_gate.py``
wires it in as the ``concurrency`` pass.

Departures from the reference: the tree is the port's
(``pyruhvro_tpu_torch/``, guard scopes its ``runtime/`` and ``serving/``),
and the blocking seams add the card's waits: ``synchronize`` of
``torch.cuda``, an ``Event`` or a ``Stream`` stands in for JAX's
``block_until_ready`` (a lock held across one is a convoy on the card).
The ``subprocess.run`` seam covers the ``nvcc`` and ``g++`` builds.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import Finding
from .lints import iter_py_files

__all__ = ["analyze", "run_concurrency"]

# the package subtrees whose module-level mutable state must declare a
# guard: the runtime plane is the one imported by every tier and hit
# from API threads, pool workers, the obs server thread and atexit; the
# serving plane adds its own worker threads and signal-drain thread
_GUARD_SCOPES = ("pyruhvro_tpu_torch/runtime", "pyruhvro_tpu_torch/serving")

_GUARDED_BY = "guarded-by:"
_LOCK_FREE_OK = "lock-free-ok"
_BLOCKING_OK = "# blocking-ok"
_LOCK_ORDER_OK = "# lock-order-ok"

# lock constructors we track. threading.Condition is deliberately NOT a
# lock here: it is a rendezvous (wait() releases it), and treating it
# as a data guard would make every wait look like a held-across-block
_LOCK_CTORS = {"Lock", "RLock"}

# mutable module-global constructors that demand a guard declaration
_MUTABLE_CTORS = {"dict", "list", "set", "defaultdict", "OrderedDict",
                  "deque", "WeakSet", "WeakValueDictionary", "Counter"}

# container mutators: a call of one of these methods on a guarded name
# is a write site
_MUTATORS = {"append", "extend", "insert", "add", "update", "setdefault",
             "pop", "popitem", "remove", "discard", "clear"}

# directly-blocking calls, keyed by (base name-or-resolved-module, attr).
# base "*" matches any receiver expression.
_BLOCKING_MODULE_CALLS = {
    ("subprocess", "run"), ("subprocess", "check_call"),
    ("subprocess", "check_output"), ("subprocess", "call"),
    ("time", "sleep"),
    ("faults", "fire"),          # chaos 'hang' kind sleeps at the seam
    ("fsio", "atomic_write_json"),
    ("pool", "map_chunks"), ("pool", "map_chunks_proc"),
}
_BLOCKING_ANY_ATTRS = {
    "result",                    # concurrent.futures waits
    "exec_module",               # extension-module import/exec
    "block_until_ready",         # device sync barriers
    "synchronize",               # the card's waits: torch.cuda, Event,
                                 # Stream
    "wait",                      # Event/Condition/process waits
}


# ---------------------------------------------------------------------------
# per-module model
# ---------------------------------------------------------------------------


@dataclass
class _Fn:
    """One function/method: its lexical lock events + call-graph edges,
    then the fixed-point summaries."""

    rel: str
    qualname: str
    node: ast.AST
    # direct lexical acquisitions (lock ids) anywhere in the body
    acquires: Set[str] = field(default_factory=set)
    # (held_tuple, lock_id, lineno): a with/acquire entered while held
    edges: List[Tuple[Tuple[str, ...], str, int]] = field(
        default_factory=list)
    # (held_tuple, what, lineno): a DIRECT blocking call while held
    blocking_sites: List[Tuple[Tuple[str, ...], str, int]] = field(
        default_factory=list)
    # (held_tuple, callee_key, lineno): resolved call-graph edges
    calls: List[Tuple[Tuple[str, ...], Tuple[str, str], int]] = field(
        default_factory=list)
    blocks_directly: bool = False
    # fixed-point results
    acq_star: Set[str] = field(default_factory=set)
    blocks_star: bool = False
    block_why: str = ""


@dataclass
class _Module:
    rel: str
    tree: ast.AST
    lines: List[str]
    # import alias -> analyzed module rel path
    aliases: Dict[str, str] = field(default_factory=dict)
    # module-level lock name -> (lock_id, is_rlock)
    mod_locks: Dict[str, Tuple[str, bool]] = field(default_factory=dict)
    # (class, attr) -> (lock_id, is_rlock) for self.<attr> locks
    cls_locks: Dict[Tuple[str, str], Tuple[str, bool]] = field(
        default_factory=dict)
    fns: Dict[str, _Fn] = field(default_factory=dict)
    classes: Set[str] = field(default_factory=set)


def _rel(path: str, root: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def _lock_ctor(node: ast.AST) -> Optional[bool]:
    """Is ``node`` a tracked lock constructor call? Returns is_rlock,
    or None. Matches ``threading.Lock()`` / ``Lock()`` styles."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    name = None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "threading":
        name = f.attr
    elif isinstance(f, ast.Name):
        name = f.id
    if name in _LOCK_CTORS:
        return name == "RLock"
    return None


def _mutable_ctor(node: ast.AST) -> bool:
    """Module-global RHS that demands a guard declaration: a mutable
    literal or a known mutable-container constructor."""
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        name = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else "")
        return name in _MUTABLE_CTORS
    return False


def _is_threading_local(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    return ((isinstance(f, ast.Attribute) and f.attr == "local")
            or (isinstance(f, ast.Name) and f.id == "local"))


def _own_lines(lines: List[str], lineno: int, span: int = 8):
    """The annotation surface OF this statement: its own line, then up
    to ``span`` lines above as long as they are pure comments — so an
    annotation trailing the PREVIOUS assignment can never bleed onto
    this one."""
    if 1 <= lineno <= len(lines):
        yield lines[lineno - 1]
    for ln in range(lineno - 1, max(0, lineno - 1 - span), -1):
        if ln < 1:
            return
        text = lines[ln - 1].strip()
        if not text.startswith("#"):
            return
        yield text


def _comment_near(lines: List[str], lineno: int, token: str,
                  span: int = 8) -> bool:
    """``token`` on the statement's own annotation surface (the shared
    waiver convention of the lints)."""
    return any(token in text for text in _own_lines(lines, lineno, span))


def _declared_guard(lines: List[str], lineno: int) -> Optional[str]:
    """The ``# guarded-by: <lock>`` declaration for an assignment at
    ``lineno`` (same line or contiguous comment lines above)."""
    for text in _own_lines(lines, lineno):
        idx = text.find(_GUARDED_BY)
        if idx >= 0:
            return text[idx + len(_GUARDED_BY):].strip().split()[0]
    return None


def _has_lock_free_waiver(lines: List[str], lineno: int) -> bool:
    return _comment_near(lines, lineno, _LOCK_FREE_OK)


# ---------------------------------------------------------------------------
# import alias resolution
# ---------------------------------------------------------------------------


def _module_parts(rel: str) -> List[str]:
    parts = rel[:-3].split("/")  # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return parts


def _resolve_alias(rel: str, node: ast.ImportFrom,
                   known: Set[str]) -> Dict[str, str]:
    """Map ``from ..x import y [as z]`` aliases to analyzed module rel
    paths (only aliases that name an analyzed MODULE matter here)."""
    out: Dict[str, str] = {}
    parts = _module_parts(rel)
    if node.level:
        base = parts[: len(parts) - node.level]
    else:
        base = (node.module or "").split(".") if node.module else []
    if node.level and node.module:
        base = base + node.module.split(".")
    for alias in node.names:
        target = base + [alias.name]
        cand = "/".join(target) + ".py"
        if cand in known:
            out[alias.asname or alias.name] = cand
    return out


# ---------------------------------------------------------------------------
# pass 1: per-module collection
# ---------------------------------------------------------------------------


def _collect_module(rel: str, path: str, known: Set[str]) -> _Module:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    m = _Module(rel=rel, tree=tree, lines=src.splitlines())

    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            m.aliases.update(_resolve_alias(rel, node, known))
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            rl = _lock_ctor(node.value)
            if rl is not None:
                name = node.targets[0].id
                m.mod_locks[name] = (f"{rel}:{name}", rl)
        if isinstance(node, ast.ClassDef):
            m.classes.add(node.name)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) \
                        and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Attribute) \
                        and isinstance(sub.targets[0].value, ast.Name) \
                        and sub.targets[0].value.id == "self":
                    rl = _lock_ctor(sub.value)
                    if rl is not None:
                        attr = sub.targets[0].attr
                        m.cls_locks[(node.name, attr)] = (
                            f"{rel}:{node.name}.{attr}", rl)
    return m


def _resolve_lock(m: _Module, cls: Optional[str], expr: ast.AST,
                  mods: Optional[Dict[str, "_Module"]] = None
                  ) -> Optional[Tuple[str, bool]]:
    """Resolve an acquisition context expression to a tracked lock."""
    if isinstance(expr, ast.Name):
        return m.mod_locks.get(expr.id)
    if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                     ast.Name):
        base, attr = expr.value.id, expr.attr
        if base == "self":
            if cls and (cls, attr) in m.cls_locks:
                return m.cls_locks[(cls, attr)]
            owners = [v for (c, a), v in m.cls_locks.items() if a == attr]
            if len(owners) == 1:
                return owners[0]
            return None
        target = m.aliases.get(base)
        if target is not None:
            # cross-module module-level lock (e.g. ``with nb._lock:``)
            # — only when the TARGET module actually defines a tracked
            # lock of that name (so its RLock-ness is known and an
            # arbitrary module-attribute context manager never injects
            # phantom graph edges)
            if mods is not None and target in mods:
                return mods[target].mod_locks.get(attr)
            return None
    return None


def _blocking_what(m: _Module, node: ast.Call,
                   held: Tuple[str, ...]) -> Optional[str]:
    """A human tag when ``node`` is a directly-blocking call."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    attr = f.attr
    if isinstance(f.value, ast.Name):
        base = f.value.id
        # normalize through import aliases: `nb.fire` on an alias of
        # runtime/faults.py still matches ("faults", "fire")
        target = m.aliases.get(base)
        if target is not None:
            base = _module_parts(target)[-1]
        if (base, attr) in _BLOCKING_MODULE_CALLS:
            return f"{base}.{attr}()"
    if attr in _BLOCKING_ANY_ATTRS:
        # Condition.wait on a lock you hold RELEASES it — that is the
        # rendezvous working as designed, not a held-across-block
        if attr == "wait":
            rl = _resolve_lock(m, None, f.value)
            if rl is not None and rl[0] in held:
                return None
        return f".{attr}()"
    return None


class _FnWalker:
    """Lexical walk of one function body tracking the held-lock stack."""

    def __init__(self, m: _Module, fn: _Fn, cls: Optional[str],
                 mods: Optional[Dict[str, _Module]] = None):
        self.m = m
        self.fn = fn
        self.cls = cls
        self.mods = mods

    def walk(self, body: Sequence[ast.stmt],
             held: Tuple[str, ...]) -> None:
        for stmt in body:
            self._stmt(stmt, held)

    def _stmt(self, node: ast.stmt, held: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                rl = _resolve_lock(self.m, self.cls,
                                   item.context_expr, self.mods)
                if rl is not None:
                    lock_id, _is_rlock = rl
                    self.fn.acquires.add(lock_id)
                    self.fn.edges.append((inner, lock_id, node.lineno))
                    inner = inner + (lock_id,)
                else:
                    self._expr(item.context_expr, inner)
            self.walk(node.body, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs are separate _Fn entries
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child, held)
            elif isinstance(child, ast.expr):
                self._expr(child, held)

    def _expr(self, node: ast.expr, held: Tuple[str, ...]) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            self._call(sub, held)

    def _call(self, node: ast.Call, held: Tuple[str, ...]) -> None:
        f = node.func
        # explicit .acquire(): an ordering edge when it can block
        if isinstance(f, ast.Attribute) and f.attr == "acquire":
            rl = _resolve_lock(self.m, self.cls, f.value, self.mods)
            if rl is not None:
                nonblocking = any(
                    kw.arg == "blocking"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                    for kw in node.keywords)
                if not nonblocking:
                    self.fn.acquires.add(rl[0])
                    self.fn.edges.append((held, rl[0], node.lineno))
                return
        what = _blocking_what(self.m, node, held)
        if what is not None:
            self.fn.blocks_directly = True
            if held:
                self.fn.blocking_sites.append((held, what, node.lineno))
            return
        # call-graph edges: local functions, self methods, constructor
        # calls, and alias.function cross-module calls
        callee: Optional[Tuple[str, str]] = None
        if isinstance(f, ast.Name):
            if f.id in self.m.classes:
                callee = (self.m.rel, f"{f.id}.__init__")
            else:
                callee = (self.m.rel, f.id)
        elif isinstance(f, ast.Attribute) and isinstance(f.value,
                                                         ast.Name):
            if f.value.id == "self" and self.cls:
                callee = (self.m.rel, f"{self.cls}.{f.attr}")
            else:
                target = self.m.aliases.get(f.value.id)
                if target is not None:
                    callee = (target, f.attr)
        if callee is not None:
            self.fn.calls.append((held, callee, node.lineno))


def _collect_functions(m: _Module,
                       mods: Optional[Dict[str, _Module]] = None) -> None:
    def visit(body, prefix: str, cls: Optional[str]):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{node.name}"
                fn = _Fn(rel=m.rel, qualname=qn, node=node)
                m.fns[qn] = fn
                _FnWalker(m, fn, cls, mods).walk(node.body, ())
                visit(node.body, qn + ".", cls)
            elif isinstance(node, ast.ClassDef):
                visit(node.body, node.name + ".", node.name)

    visit(m.tree.body, "", None)


# ---------------------------------------------------------------------------
# pass 2: whole-program fixed point
# ---------------------------------------------------------------------------


def _fixed_point(mods: Dict[str, _Module]) -> Dict[Tuple[str, str], _Fn]:
    table: Dict[Tuple[str, str], _Fn] = {}
    for m in mods.values():
        for fn in m.fns.values():
            fn.acq_star = set(fn.acquires)
            fn.blocks_star = fn.blocks_directly
            if fn.blocks_directly:
                fn.block_why = "direct blocking call"
            table[(m.rel, fn.qualname)] = fn
    changed = True
    rounds = 0
    while changed and rounds < 50:
        changed = False
        rounds += 1
        for key, fn in table.items():
            for _held, callee, _ln in fn.calls:
                target = table.get(callee)
                if target is None:
                    # unqualified name may be a plain function OR a
                    # method sharing the prefix; try a method lookup in
                    # the same module for self-less helper styles
                    continue
                if not target.acq_star <= fn.acq_star:
                    fn.acq_star |= target.acq_star
                    changed = True
                if target.blocks_star and not fn.blocks_star:
                    fn.blocks_star = True
                    fn.block_why = (f"calls {callee[1]} "
                                    f"({target.block_why})")
                    changed = True
    return table


# ---------------------------------------------------------------------------
# pass 3: findings
# ---------------------------------------------------------------------------


def _lock_graph(mods: Dict[str, _Module],
                table: Dict[Tuple[str, str], _Fn],
                rlocks: Set[str]):
    """-> (edges {(a, b): site}, self_deadlocks, blocking findings
    pre-waiver). Edges fold direct nesting AND call-graph transitive
    acquisitions."""
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    self_dead: List[Tuple[str, str, int]] = []
    blocking: List[Tuple[str, Tuple[str, ...], str, int, str]] = []

    for m in mods.values():
        for fn in m.fns.values():
            for held, lock_id, ln in fn.edges:
                if lock_id in held and lock_id not in rlocks:
                    self_dead.append((lock_id, m.rel, ln))
                    continue
                for h in held:
                    if h != lock_id:
                        edges.setdefault((h, lock_id),
                                         (m.rel, ln, fn.qualname))
            for held, what, ln in fn.blocking_sites:
                blocking.append((m.rel, held, what, ln, fn.qualname))
            for held, callee, ln in fn.calls:
                if not held:
                    continue
                target = table.get(callee)
                if target is None:
                    continue
                for lock_id in target.acq_star:
                    if lock_id in held:
                        if lock_id not in rlocks:
                            self_dead.append((lock_id, m.rel, ln))
                        continue
                    for h in held:
                        edges.setdefault((h, lock_id),
                                         (m.rel, ln, fn.qualname))
                if target.blocks_star:
                    blocking.append(
                        (m.rel, held,
                         f"{callee[1]}() [{target.block_why}]", ln,
                         fn.qualname))
    return edges, self_dead, blocking


def _find_cycles(edges: Dict[Tuple[str, str], Tuple[str, int, str]]
                 ) -> List[List[str]]:
    """Elementary cycles in the lock digraph via iterative DFS over
    SCCs — small graph, simple approach: for each node, DFS for a path
    back to itself; deduplicate by the cycle's canonical rotation."""
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    seen: Set[Tuple[str, ...]] = set()
    cycles: List[List[str]] = []

    def dfs(start: str, node: str, path: List[str],
            visited: Set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start and len(path) > 0:
                cyc = path[:]
                pivot = cyc.index(min(cyc))
                canon = tuple(cyc[pivot:] + cyc[:pivot])
                if canon not in seen:
                    seen.add(canon)
                    cycles.append(list(canon))
            elif nxt not in visited and nxt > start:
                # only explore nodes > start: each cycle is found from
                # its smallest member exactly once
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)
                visited.discard(nxt)

    for n in sorted(graph):
        dfs(n, n, [n], {n})
    return cycles


def _check_guarded_globals(mods: Dict[str, _Module]) -> Tuple[
        List[Finding], List[dict], List[dict]]:
    """The guarded-by discipline over ``runtime/`` module globals."""
    findings: List[Finding] = []
    guarded_inv: List[dict] = []
    waived_inv: List[dict] = []
    for m in mods.values():
        in_scope = any(s in m.rel for s in _GUARD_SCOPES)
        # every name assigned under a `global` declaration anywhere
        rebound: Dict[str, int] = {}
        for node in ast.walk(m.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                declared: Set[str] = set()
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Global):
                        declared.update(sub.names)
                for sub in ast.walk(node):
                    targets = []
                    if isinstance(sub, ast.Assign):
                        targets = sub.targets
                    elif isinstance(sub, ast.AugAssign):
                        targets = [sub.target]
                    for t in targets:
                        if isinstance(t, ast.Name) and t.id in declared:
                            rebound.setdefault(t.id, sub.lineno)
        # module-level mutable containers
        flagged: Dict[str, int] = {}
        for node in m.tree.body:
            tgt = None
            val = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt, val = node.targets[0].id, node.value
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.value is not None:
                tgt, val = node.target.id, node.value
            if tgt is None or val is None:
                continue
            if _is_threading_local(val) or _lock_ctor(val) is not None:
                continue
            # dunders (__all__) and ALL_CAPS names are constants by
            # convention: populated at import, frozen after — the
            # convention IS their declaration
            if tgt.startswith("__") or tgt.isupper():
                continue
            if _mutable_ctor(val) or tgt in rebound:
                flagged[tgt] = node.lineno
        for name, extra_ln in rebound.items():
            if not (name.startswith("__") or name.isupper()):
                flagged.setdefault(name, extra_ln)

        guards: Dict[str, str] = {}
        for name, ln in sorted(flagged.items(), key=lambda kv: kv[1]):
            guard = _declared_guard(m.lines, ln)
            if guard is not None:
                guards[name] = guard
                guarded_inv.append({"module": m.rel, "name": name,
                                    "guard": guard})
                if guard not in m.mod_locks:
                    findings.append(Finding(
                        "conc.unknown-guard", m.rel,
                        f"global {name!r} declares guard {guard!r} but "
                        f"no module-level threading lock of that name "
                        f"exists", ln))
                continue
            if _has_lock_free_waiver(m.lines, ln):
                waived_inv.append({"module": m.rel, "name": name,
                                   "line": ln, "kind": "lock-free-ok"})
                continue
            if in_scope:
                findings.append(Finding(
                    "conc.unguarded-global", m.rel,
                    f"module-level mutable state {name!r} has no "
                    f"declared guard — annotate '# guarded-by: <lock>' "
                    f"(and hold it at every mutation) or "
                    f"'# lock-free-ok(<reason>)' after an audit", ln))

        if guards:
            findings.extend(_check_mutations(m, guards))
    return findings, guarded_inv, waived_inv


def _stmt_mutations(node: ast.stmt, guards: Dict[str, str]):
    """``(name, lineno)`` per mutation of a guarded name in ONE simple
    statement (and in the immediate test/iter expressions of compound
    ones) — nested statement bodies are the recursive visitor's job."""
    out = []
    if isinstance(node, ast.Assign):
        targets = node.targets
        exprs = [node.value]
    elif isinstance(node, ast.AugAssign):
        targets = [node.target]
        exprs = [node.value]
    elif isinstance(node, ast.Delete):
        targets = node.targets
        exprs = []
    else:
        targets = []
        exprs = [v for f in ("value", "test", "iter", "exc")
                 for v in [getattr(node, f, None)] if v is not None]
    for t in targets:
        if isinstance(t, ast.Name) and t.id in guards:
            out.append((t.id, node.lineno))
        elif isinstance(t, ast.Subscript) \
                and isinstance(t.value, ast.Name) \
                and t.value.id in guards:
            out.append((t.value.id, node.lineno))
    for e in exprs:
        for sub in ast.walk(e):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _MUTATORS \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id in guards:
                out.append((sub.func.value.id, sub.lineno))
    return out


def _check_mutations(m: _Module, guards: Dict[str, str]) -> List[Finding]:
    """Every mutation of a guarded global must sit inside a
    ``with <declared lock>:`` block (module top level is import-time
    single-threaded and exempt; ``# lock-free-ok`` waives one site)."""
    findings: List[Finding] = []

    def report(node: ast.stmt, held: Set[str]) -> None:
        for site_name, ln in _stmt_mutations(node, guards):
            if guards[site_name] in held:
                continue
            if _comment_near(m.lines, ln, _LOCK_FREE_OK):
                continue
            findings.append(Finding(
                "conc.guard-discipline", m.rel,
                f"{site_name!r} is declared guarded-by "
                f"{guards[site_name]!r} but this mutation is outside "
                f"any 'with {guards[site_name]}:' block", ln))

    def visit(body, held: Set[str], in_function: bool):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # the repo's `_locked` suffix convention: the function's
                # CONTRACT is that every caller already holds the guard
                # (the lock-order pass still sees callers' with-blocks)
                inner = (set(guards.values())
                         if node.name.endswith("_locked") else set())
                visit(node.body, inner, True)
                continue
            if isinstance(node, ast.ClassDef):
                visit(node.body, held, in_function)
                continue
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = set(held)
                for item in node.items:
                    ctx = item.context_expr
                    # only a bare module-level name satisfies a
                    # module-level guard: 'with self._lock:' or
                    # 'with othermod._lock:' holding a DIFFERENT lock
                    # that merely shares the name must not pass
                    if isinstance(ctx, ast.Name):
                        inner.add(ctx.id)
                visit(node.body, inner, in_function)
                continue
            if in_function:
                report(node, held)
            for f in ("body", "orelse", "finalbody"):
                sub = getattr(node, f, None)
                if sub:
                    visit(sub, held, in_function)
            for h in getattr(node, "handlers", ()) or ():
                visit(h.body, held, in_function)

    visit(m.tree.body, set(), False)
    return findings


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def analyze(root: str, subdirs: Sequence[str] = ("pyruhvro_tpu_torch",)
            ) -> Tuple[List[Finding], Dict]:
    """Run all concurrency passes. Returns ``(findings, info)``;
    ``info`` carries the lock inventory, edge list, and the audited
    waiver list for ``ANALYSIS_REPORT.json``."""
    files = iter_py_files(root, subdirs)
    known = {_rel(p, root) for p in files}
    mods: Dict[str, _Module] = {}
    for p in files:
        rel = _rel(p, root)
        mods[rel] = _collect_module(rel, p, known)
    # second phase: function walks resolve cross-module locks against
    # the full module map (a `with alias.attr:` is only a lock when the
    # target module defines one — RLock-ness included)
    for m in mods.values():
        _collect_functions(m, mods)

    rlocks: Set[str] = set()
    lock_inventory: List[dict] = []
    for m in mods.values():
        for name, (lock_id, is_rlock) in m.mod_locks.items():
            lock_inventory.append({"id": lock_id, "module": m.rel,
                                   "name": name,
                                   "kind": "RLock" if is_rlock
                                   else "Lock"})
            if is_rlock:
                rlocks.add(lock_id)
        for (cls, attr), (lock_id, is_rlock) in m.cls_locks.items():
            lock_inventory.append({"id": lock_id, "module": m.rel,
                                   "name": f"{cls}.{attr}",
                                   "kind": "RLock" if is_rlock
                                   else "Lock"})
            if is_rlock:
                rlocks.add(lock_id)

    table = _fixed_point(mods)
    edges, self_dead, blocking = _lock_graph(mods, table, rlocks)

    findings: List[Finding] = []
    waivers: List[dict] = []

    # lock-order: waive edges whose acquisition site carries the
    # comment, then fail on any remaining cycle
    live_edges = {}
    for (a, b), (rel, ln, qn) in edges.items():
        if _comment_near(mods[rel].lines, ln, _LOCK_ORDER_OK):
            waivers.append({"kind": "lock-order-ok", "module": rel,
                            "line": ln, "edge": [a, b]})
            continue
        live_edges[(a, b)] = (rel, ln, qn)
    for cyc in _find_cycles(live_edges):
        chain = " -> ".join(cyc + [cyc[0]])
        sites = "; ".join(
            f"{live_edges[e][0]}:{live_edges[e][1]}"
            for e in zip(cyc, cyc[1:] + [cyc[0]]) if e in live_edges)
        rel0, ln0, _ = live_edges.get(
            (cyc[0], cyc[1 % len(cyc)]), ("", 0, ""))
        findings.append(Finding(
            "conc.lock-order", rel0 or "pyruhvro_tpu_torch",
            f"lock-order inversion cycle: {chain} (edges at {sites}) — "
            f"two threads taking these locks in opposite order "
            f"deadlock", ln0))
    for lock_id, rel, ln in sorted(set(self_dead)):
        if _comment_near(mods[rel].lines, ln, _LOCK_ORDER_OK):
            waivers.append({"kind": "lock-order-ok", "module": rel,
                            "line": ln, "edge": [lock_id, lock_id]})
            continue
        findings.append(Finding(
            "conc.lock-order", rel,
            f"non-reentrant lock {lock_id} re-acquired while already "
            f"held (self-deadlock)", ln))

    # blocking seams
    for rel, held, what, ln, qn in blocking:
        if _comment_near(mods[rel].lines, ln, _BLOCKING_OK):
            waivers.append({"kind": "blocking-ok", "module": rel,
                            "line": ln, "held": list(held),
                            "call": what})
            continue
        findings.append(Finding(
            "conc.blocking-seam", rel,
            f"{qn} holds {', '.join(held)} across blocking call "
            f"{what} — a stall there convoys every sibling caller "
            f"(waive with '# blocking-ok: <reason>' after an audit)",
            ln))

    g_findings, guarded_inv, lf_waivers = _check_guarded_globals(mods)
    findings.extend(g_findings)
    waivers.extend(lf_waivers)

    info = {
        "locks": sorted(lock_inventory, key=lambda d: d["id"]),
        "edges": sorted(
            [{"from": a, "to": b, "site": f"{s[0]}:{s[1]}"}
             for (a, b), s in edges.items()],
            key=lambda d: (d["from"], d["to"])),
        "guarded": sorted(guarded_inv,
                          key=lambda d: (d["module"], d["name"])),
        "waivers": sorted(waivers,
                          key=lambda d: (d["module"], d["line"])),
    }
    return findings, info


def run_concurrency(root: str = ".") -> List[Finding]:
    """Gate-facing convenience: findings only."""
    return analyze(root)[0]
