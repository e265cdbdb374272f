"""Static lock-discipline analysis (KME-L001 / KME-L002) — the port of
`kme_tpu/analysis/lockgraph.py`, over the port's threaded modules.

Extracts a lock model from the threaded modules without importing
them:

- **Lock sites**: ``self.X = threading.Lock()/RLock()`` inside a class
  (identity ``file::Class.X``) and module-level ``X = threading.Lock()``
  (identity ``file::X``). ``threading.Condition(self._lock)`` aliases
  the condition attribute to the wrapped lock — acquiring the condition
  IS acquiring the lock.

- **Acquisition graph**: within each function, ``with self.X:`` nests
  define edges A -> B (B acquired while A held). Calls made while
  holding A propagate one level: A gains edges to every lock the callee
  acquires directly (self-method and module-function calls). A cycle in
  this graph is a potential deadlock (KME-L001).

- **Thread attribution**: methods passed to ``threading.Thread(
  target=...)`` (including closures that call back into ``self``), and
  ``run`` on ``threading.Thread`` subclasses, execute off the main
  thread. The reachable set closes over self-method calls. An attribute
  stored both from thread-reachable code and from main-thread code,
  with no lock common to every store, is a potential race (KME-L002).
  Stores in ``__init__`` are construction-time (happens-before the
  thread start) and don't count. "Locks held at a store" includes
  caller-held locks when EVERY caller of the enclosing method holds
  them (a guaranteed-held fixpoint), so private helpers called under a
  lock are not false positives.

The runtime half (lockcheck.py, ``KME_LOCKCHECK=1``) validates the
same discipline against real acquisition orders while the tests run.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from kme_tpu_torch.analysis import Finding

# The threaded surface: every module of the port that creates a
# Lock/Condition or spawns a Thread (tests/test_torch_analysis.py derives
# the set from the AST and holds this tuple to it). kme-torch-lint
# re-derives L-family findings over exactly this set, so adding a
# threaded module means adding it here. Beside the JAX package's ten,
# the port has the supervisor's per-group and autoscale-monitor threads
# (bridge/supervise.py), the kernel loader's lock over its builds and
# loaded libraries (native/__init__.py) and the profiler's sampler
# thread (telemetry/profiler.py).
THREADED_MODULES = (
    "kme_tpu_torch/telemetry/journal.py",
    "kme_tpu_torch/telemetry/registry.py",
    "kme_tpu_torch/telemetry/trace.py",
    "kme_tpu_torch/telemetry/audit.py",
    "kme_tpu_torch/telemetry/httpd.py",
    "kme_tpu_torch/telemetry/profiler.py",
    "kme_tpu_torch/bridge/broker.py",
    "kme_tpu_torch/bridge/service.py",
    "kme_tpu_torch/bridge/tcp.py",
    "kme_tpu_torch/bridge/chaos.py",
    "kme_tpu_torch/bridge/supervise.py",
    "kme_tpu_torch/native/__init__.py",
    "kme_tpu_torch/faults.py",
)

_LOCK_CTORS = {"Lock", "RLock"}


def _dotted(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _FuncModel:
    """Per-function lock facts."""

    def __init__(self, qualname: str, node: ast.AST,
                 relpath: str) -> None:
        self.qualname = qualname          # "Class.method" or "func"
        self.node = node
        self.relpath = relpath
        self.direct: Set[str] = set()     # locks acquired in the body
        # (held_locks, lock) at each with-entry, for edge witnesses
        self.acquires: List[Tuple[Tuple[str, ...], str, int]] = []
        # calls made while holding locks: (held, callee_name, lineno);
        # callee_name is "self.M" or a bare module-level name
        self.calls: List[Tuple[Tuple[str, ...], str, int]] = []
        # attribute stores: attr -> list of (held_locks, lineno)
        self.stores: Dict[str, List[Tuple[Tuple[str, ...], int]]] = {}


class _ModuleModel:
    def __init__(self, relpath: str) -> None:
        self.relpath = relpath
        # lock id -> creation lineno
        self.locks: Dict[str, int] = {}
        # alias id -> canonical lock id (Condition wrapping)
        self.aliases: Dict[str, str] = {}
        self.funcs: Dict[str, _FuncModel] = {}   # qualname -> model
        # class -> thread-entry method names (directly identified)
        self.thread_entries: Dict[str, Set[str]] = {}
        self.classes: Set[str] = set()
        self.thread_subclasses: Set[str] = set()


class _Extractor(ast.NodeVisitor):
    def __init__(self, relpath: str) -> None:
        self.m = _ModuleModel(relpath)
        self._cls: Optional[str] = None
        self._fn: Optional[_FuncModel] = None
        self._held: List[str] = []

    # -- identity helpers ----------------------------------------------

    def _lock_id(self, expr: ast.AST) -> Optional[str]:
        """Canonical lock id for an acquisition expression, if the
        expression names a known lock (or alias) of this module."""
        name = _dotted(expr)
        if name is None:
            return None
        if name.startswith("self."):
            if self._cls is None:
                return None
            key = f"{self.m.relpath}::{self._cls}.{name[5:]}"
        else:
            key = f"{self.m.relpath}::{name}"
        key = self.m.aliases.get(key, key)
        return key if key in self.m.locks else None

    def _target_key(self, tgt: ast.AST) -> Optional[str]:
        name = _dotted(tgt)
        if name is None:
            return None
        if name.startswith("self.") and self._cls is not None:
            return f"{self.m.relpath}::{self._cls}.{name[5:]}"
        if "." not in name and self._fn is None:
            return f"{self.m.relpath}::{name}"
        return None

    # -- structure ------------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev = self._cls
        self._cls = node.name
        self.m.classes.add(node.name)
        for base in node.bases:
            if (_dotted(base) or "").endswith("Thread"):
                self.m.thread_subclasses.add(node.name)
        self.generic_visit(node)
        self._cls = prev

    def _enter_fn(self, node) -> None:
        if self._fn is not None:
            # nested function: record as ClassOrOuter.outer.<name> so
            # closures passed to Thread(target=...) resolve
            qual = f"{self._fn.qualname}.{node.name}"
        elif self._cls is not None:
            qual = f"{self._cls}.{node.name}"
        else:
            qual = node.name
        prev_fn, prev_held = self._fn, self._held
        self._fn = _FuncModel(qual, node, self.m.relpath)
        self._held = []
        self.m.funcs[qual] = self._fn
        self.generic_visit(node)
        self._fn, self._held = prev_fn, prev_held

    visit_FunctionDef = _enter_fn
    visit_AsyncFunctionDef = _enter_fn

    # -- lock creation / aliasing ---------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        val = node.value
        if isinstance(val, ast.Call):
            ctor = _dotted(val.func) or ""
            tail = ctor.rsplit(".", 1)[-1]
            for tgt in node.targets:
                key = self._target_key(tgt)
                if key is None:
                    continue
                if tail in _LOCK_CTORS and (
                        ctor.startswith("threading.")
                        or ctor in _LOCK_CTORS):
                    self.m.locks[key] = node.lineno
                elif tail == "Condition":
                    if val.args:
                        wrapped = self._lock_id(val.args[0])
                        if wrapped is not None:
                            self.m.aliases[key] = wrapped
                            continue
                    # Condition() owns a fresh RLock
                    self.m.locks[key] = node.lineno
        self._record_stores(node.targets, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_stores([node.target], node.lineno)
        self.generic_visit(node)

    def _record_stores(self, targets, lineno: int) -> None:
        if self._fn is None:
            return
        for tgt in targets:
            for sub in ast.walk(tgt):
                name = _dotted(sub)
                if name and name.startswith("self.") \
                        and "." not in name[5:]:
                    self._fn.stores.setdefault(name[5:], []).append(
                        (tuple(self._held), lineno))

    # -- acquisition + calls --------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            lock = self._lock_id(item.context_expr)
            if lock is not None and self._fn is not None:
                self._fn.direct.add(lock)
                self._fn.acquires.append(
                    (tuple(self._held), lock, node.lineno))
                self._held.append(lock)
                acquired.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for lock in reversed(acquired):
            self._held.remove(lock)
        # with-items' own expressions (rare nested calls)
        for item in node.items:
            self.visit(item.context_expr)

    def visit_Call(self, node: ast.Call) -> None:
        if self._fn is not None:
            callee = _dotted(node.func)
            if callee is not None:
                if callee.startswith("self.") and "." not in callee[5:]:
                    self._fn.calls.append(
                        (tuple(self._held), f"self.{callee[5:]}",
                         node.lineno))
                elif "." not in callee:
                    self._fn.calls.append(
                        (tuple(self._held), callee, node.lineno))
            # thread entries: threading.Thread(target=X)
            ctor = _dotted(node.func) or ""
            if ctor.rsplit(".", 1)[-1] == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        self._mark_entry(kw.value)
        self.generic_visit(node)

    def _mark_entry(self, target: ast.AST) -> None:
        name = _dotted(target)
        if name is None or self._cls is None:
            return
        ent = self.m.thread_entries.setdefault(self._cls, set())
        if name.startswith("self."):
            ent.add(name[5:])
        else:
            # a closure defined in this function: qualname prefix match
            if self._fn is not None:
                ent.add(f"{self._fn.qualname}.{name}".split(".", 1)[1]
                        if self._cls and self._fn.qualname.startswith(
                            self._cls + ".")
                        else name)


def _resolve_callee(m: _ModuleModel, caller: _FuncModel,
                    callee: str) -> Optional[_FuncModel]:
    if callee.startswith("self."):
        cls = caller.qualname.split(".", 1)[0]
        return m.funcs.get(f"{cls}.{callee[5:]}")
    return m.funcs.get(callee)


def _guaranteed_held(m: _ModuleModel) -> Dict[str, Set[str]]:
    """For each function: locks held at EVERY call site (propagated
    through the intra-module call graph). Functions never called inside
    the module (API entry points) guarantee nothing."""
    callers: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}
    for fn in m.funcs.values():
        for held, callee, _ in fn.calls:
            tgt = _resolve_callee(m, fn, callee)
            if tgt is not None:
                callers.setdefault(tgt.qualname, []).append(
                    (fn.qualname, held))
    guaranteed: Dict[str, Set[str]] = {q: set() for q in m.funcs}
    for _ in range(4):                    # small fixpoint
        changed = False
        for q, sites in callers.items():
            if not sites:
                continue
            agg: Optional[Set[str]] = None
            for caller_q, held in sites:
                eff = set(held) | guaranteed.get(caller_q, set())
                agg = eff if agg is None else (agg & eff)
            agg = agg or set()
            if agg != guaranteed[q]:
                guaranteed[q] = agg
                changed = True
        if not changed:
            break
    return guaranteed


def _construction_only(m: _ModuleModel, reach: Set[str]) -> Set[str]:
    """Methods whose every in-module caller chain roots at __init__
    (and that no thread reaches): they run before any thread that the
    constructor starts, so their stores are happens-before-ordered."""
    callers: Dict[str, Set[str]] = {}
    for fn in m.funcs.values():
        for _, callee, _ in fn.calls:
            tgt = _resolve_callee(m, fn, callee)
            if tgt is not None:
                callers.setdefault(tgt.qualname, set()).add(
                    fn.qualname)
    out: Set[str] = set()
    for _ in range(4):
        changed = False
        for q in m.funcs:
            if q in out or q in reach:
                continue
            cs = callers.get(q)
            if cs and all(
                    c.split(".")[-1] == "__init__" or c in out
                    for c in cs):
                out.add(q)
                changed = True
        if not changed:
            break
    return out


def _edges(models: List[_ModuleModel]):
    """(A, B, witness) edges: B acquired (or acquired by a callee)
    while A held."""
    out = []
    for m in models:
        for fn in m.funcs.values():
            for held, lock, lineno in fn.acquires:
                for h in held:
                    if h != lock:
                        out.append((h, lock, (m.relpath, lineno,
                                              fn.qualname)))
            for held, callee, lineno in fn.calls:
                if not held:
                    continue
                tgt = _resolve_callee(m, fn, callee)
                if tgt is None:
                    continue
                for lock in sorted(tgt.direct):
                    for h in held:
                        if h != lock:
                            out.append((h, lock, (m.relpath, lineno,
                                                  fn.qualname)))
    return out


def _find_cycles(edges) -> List[List[str]]:
    graph: Dict[str, Set[str]] = {}
    for a, b, _ in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycles, seen = [], set()

    def dfs(node, path, on_path):
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key not in seen:
                    seen.add(key)
                    cycles.append(cyc)
            elif (node, nxt) not in visited_edges:
                visited_edges.add((node, nxt))
                on_path.add(nxt)
                dfs(nxt, path + [nxt], on_path)
                on_path.discard(nxt)

    visited_edges: Set[Tuple[str, str]] = set()
    for start in sorted(graph):
        dfs(start, [start], {start})
    return cycles


def _thread_reachable(m: _ModuleModel) -> Set[str]:
    """Qualnames of functions that can run off the main thread."""
    entries: Set[str] = set()
    for cls, names in m.thread_entries.items():
        for n in names:
            for q in m.funcs:
                if q == f"{cls}.{n}" or q.startswith(f"{cls}.{n}."):
                    entries.add(q)
                # closures: "Class.method.closure" where the Thread
                # call named just the closure
                if q.endswith(f".{n}") and q.startswith(cls + "."):
                    entries.add(q)
    for cls in m.thread_subclasses:
        if f"{cls}.run" in m.funcs:
            entries.add(f"{cls}.run")
    # close over self-method calls (and closure method calls on any
    # receiver — over-approximate: `state._write_heartbeat()` in a
    # beater closure reaches the method)
    reach = set(entries)
    for _ in range(6):
        new = set()
        for q in reach:
            fn = m.funcs.get(q)
            if fn is None:
                continue
            cls = q.split(".", 1)[0]
            for _, callee, _ in fn.calls:
                if callee.startswith("self."):
                    tq = f"{cls}.{callee[5:]}"
                    if tq in m.funcs:
                        new.add(tq)
        for fn in m.funcs.values():
            # closures textually inside a reachable function
            for q in reach:
                if fn.qualname.startswith(q + "."):
                    new.add(fn.qualname)
        if new <= reach:
            break
        reach |= new
    # method calls on arbitrary receivers from reachable closures
    extra = set()
    for q in reach:
        fn = m.funcs.get(q)
        if fn is None:
            continue
        node = fn.node
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = _dotted(sub.func) or ""
                if "." in name:
                    meth = name.rsplit(".", 1)[-1]
                    for cls in m.classes:
                        tq = f"{cls}.{meth}"
                        if tq in m.funcs:
                            extra.add(tq)
    reach |= extra
    return reach


def analyze_modules(root: str,
                    modules=THREADED_MODULES) -> List[Finding]:
    models = []
    for rel in modules:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            continue
        with open(path, encoding="utf-8") as f:
            src = f.read()
        ex = _Extractor(rel)
        ex.visit(ast.parse(src, filename=rel))
        models.append(ex.m)
    findings: List[Finding] = []
    edges = _edges(models)
    src_lines: Dict[str, List[str]] = {}

    def line_of(rel, lineno):
        if rel not in src_lines:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                src_lines[rel] = f.read().splitlines()
        lines = src_lines[rel]
        return lines[lineno - 1].strip() if 0 < lineno <= len(lines) \
            else ""

    for cyc in _find_cycles(edges):
        a, b = cyc[0], cyc[1]
        wit = next(w for x, y, w in edges if x == a and y == b)
        rel, lineno, qual = wit
        findings.append(Finding(
            rule="KME-L001", path=rel, line=lineno, col=0, scope=qual,
            message=("lock-order cycle: "
                     + " -> ".join(c.split("::")[-1] for c in cyc)),
            snippet=line_of(rel, lineno)))
    for m in models:
        reach = _thread_reachable(m)
        if not reach:
            continue
        guaranteed = _guaranteed_held(m)
        ctor_only = _construction_only(m, reach)
        # attr -> [(qualname, held+guaranteed, lineno, threaded?)]
        per_attr: Dict[Tuple[str, str], List] = {}
        for fn in m.funcs.values():
            cls = fn.qualname.split(".", 1)[0]
            if cls not in m.classes:
                continue
            meth = fn.qualname.split(".")[-1]
            if meth == "__init__" or fn.qualname in ctor_only:
                continue        # happens-before thread start
            for attr, stores in fn.stores.items():
                for held, lineno in stores:
                    eff = set(held) | guaranteed.get(fn.qualname,
                                                     set())
                    per_attr.setdefault((cls, attr), []).append(
                        (fn.qualname, eff, lineno,
                         fn.qualname in reach))
        for (cls, attr), stores in sorted(per_attr.items()):
            threaded = [s for s in stores if s[3]]
            mainside = [s for s in stores if not s[3]]
            if not threaded or not mainside:
                continue
            common = set.intersection(*(s[1] for s in stores))
            if common:
                continue
            q, _, lineno, _ = threaded[0]
            others = sorted({f"{s[0]}:{s[2]}" for s in mainside})
            findings.append(Finding(
                rule="KME-L002", path=m.relpath, line=lineno, col=0,
                scope=q,
                message=(f"'self.{attr}' stored on a worker thread "
                         f"here and on the main thread at "
                         f"{', '.join(others[:3])} with no common "
                         f"lock"),
                snippet=line_of(m.relpath, lineno)))
    return findings
