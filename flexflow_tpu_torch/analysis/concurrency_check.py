"""Whole-package concurrency auditor: thread roles, lock graphs, races.

PyTorch counterpart of ``flexflow_tpu/analysis/concurrency_check.py``,
the same pure-AST pass (the port imports nothing of the JAX package).
The reference framework gets concurrency safety for free from Legion's
implicit dependence analysis (tasks declare their region accesses and
the runtime serializes conflicts). The port, like the JAX package,
replaces that with hand-rolled Python threading — the Prefetcher
worker (:mod:`..runtime.dataloader`), the serving engine's per-instance
worker pool with its Condition/Lock protocol (:mod:`..serving.engine`),
and the obs ring buffer / metrics registries — and nothing re-checks
those invariants when the code changes. This pass does, statically and
step-free, over the WHOLE package at once:

1. **Thread-role inference** — a call graph is rooted at every
   ``threading.Thread(target=...)`` spawn site (plain functions, worker
   closures, ``self._method`` targets, lambdas) plus the main role (all
   normally-callable functions). Each function belongs to every role
   that can reach it; a function referenced *only* as a thread target is
   worker-only.
2. **Shared-state escape analysis** — ``self`` attributes, attributes of
   module-global objects, and ``global``-declared module variables that
   are accessed from two or more roles.
3. **Lock-context tracking** — ``with self._lock:`` regions (any value
   statically typed as a ``threading`` Lock/RLock/Semaphore/Condition),
   propagated interprocedurally: a callee invoked inside a lock region
   is analyzed with that lock held.

Findings (``CCY0xx`` in :data:`..findings.CODE_CATALOG`):

* **CCY001** unguarded shared mutation (error) / unguarded read of
  lock-guarded shared state (warning)
* **CCY002** lock-acquisition-order cycle — potential ABBA deadlock
* **CCY003** blocking call (queue get/put, thread ``join``, event
  ``wait``, host sync (``.synchronize()``), ``time.sleep``) while
  holding a lock
* **CCY004** Condition discipline: ``wait`` without an enclosing
  predicate loop, or ``wait``/``notify`` outside the condition's lock
* **CCY005** thread leak: a started thread with no ``join`` and no
  stop-event path
* **CCY006** guarded-by inconsistency: one field guarded by different
  locks at different sites

Intentional exceptions are suppressed in source through the shared
pragma grammar (:mod:`.pragmas`) with tool ``concurrency``::

    self.value += n   # concurrency: race-ok (GIL-atomic float add)

Tokens: ``race-ok`` (CCY001), ``order-ok`` (CCY002), ``block-ok``
(CCY003), ``cond-ok`` (CCY004), ``leak-ok`` (CCY005), ``guard-ok``
(CCY006). A pragma without a reason does not suppress.

Soundness posture: the pass over-approximates call targets (an
ambiguous ``obj.method()`` resolves to every package class defining
``method`` unless the receiver's class is statically known from a
constructor assignment or annotation) and under-approximates mutation
(method-call mutation like ``shared_list.append`` and stores through
non-``self`` receivers are not tracked). Findings are therefore
high-confidence on the patterns the runtime actually uses — attribute
state guarded by ``with`` blocks — which is exactly the protocol the
Prefetcher/serving/obs threads follow.

Run as a module for the Makefile's ``concurrency-lint`` gate::

    python -m flexflow_tpu_torch.analysis.concurrency_check flexflow_tpu_torch
"""

from __future__ import annotations

import ast
import dataclasses
import os
import sys
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from . import pragmas
from .findings import Finding, ValidationReport

PRAGMA_TOOL = "concurrency"
# one suppression token per finding class (the review-trail grammar)
PRAGMA_TOKENS = {
    "CCY001": "race-ok",
    "CCY002": "order-ok",
    "CCY003": "block-ok",
    "CCY004": "cond-ok",
    "CCY005": "leak-ok",
    "CCY006": "guard-ok",
}

MAIN_ROLE = "main"

# constructor name -> synchronization kind, for typing self attributes,
# locals and module globals assigned from these calls
_SYNC_CTORS = {
    "Lock": "lock", "RLock": "lock", "Semaphore": "lock",
    "BoundedSemaphore": "lock", "Condition": "condition",
    "Event": "event", "Barrier": "lock", "Thread": "thread",
    "Queue": "queue", "LifoQueue": "queue", "PriorityQueue": "queue",
    "SimpleQueue": "queue", "JoinableQueue": "queue", "deque": "queue",
}
_LOCKY = ("lock", "condition")  # kinds that form `with` lock regions
# method names whose ambiguous (untyped-receiver) resolution is skipped:
# they collide with builtin dict/list/set/str/file/executor methods, so
# an untyped receiver is overwhelmingly NOT a package object
_BUILTIN_METHOD_NAMES = frozenset({
    "get", "put", "pop", "popleft", "append", "appendleft", "extend",
    "clear", "copy", "update", "setdefault", "keys", "values", "items",
    "add", "remove", "discard", "join", "split", "rsplit", "strip",
    "format", "encode", "decode", "read", "write", "readline", "flush",
    "seek", "close", "open", "sort", "reverse", "index", "count",
    "insert", "startswith", "endswith", "replace", "lower", "upper",
    "submit", "result", "done", "cancel", "set", "start", "wait",
    "notify", "notify_all", "acquire", "release", "is_set", "sleep",
})
# __init__-family methods: construction happens-before publication, so
# stores to the OWN class's fields there are not shared-state mutations
_CTOR_METHODS = {"__init__", "__new__", "__post_init__"}


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is best-effort labeling
        return "<expr>"


# =====================================================================
# module scan
# =====================================================================
@dataclasses.dataclass
class _Func:
    qname: str
    rel: str                      # module path relative to the scan root
    cls: Optional[str]            # enclosing class (None for functions)
    node: ast.AST                 # FunctionDef / AsyncFunctionDef / Lambda
    parent: Optional[str]         # enclosing function qname (closures)
    is_method: bool = False       # direct child of a ClassDef
    is_property: bool = False
    nested: Dict[str, str] = dataclasses.field(default_factory=dict)
    # per-function local type environment (forward-pass approximation)
    local_kind: Dict[str, str] = dataclasses.field(default_factory=dict)
    local_classes: Dict[str, Set[str]] = dataclasses.field(
        default_factory=dict)
    # local name -> state key it was derived from (for join coverage)
    derived: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    globals_decl: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _Module:
    rel: str
    path: str                     # absolute path ('' for in-memory source)
    tree: ast.Module
    lines: List[str]
    funcs: Dict[str, _Func] = dataclasses.field(default_factory=dict)
    # class name -> {method name -> qname}; bases by name
    classes: Dict[str, Dict[str, str]] = dataclasses.field(
        default_factory=dict)
    bases: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    top_funcs: Dict[str, str] = dataclasses.field(default_factory=dict)
    # import alias -> (module rel path or None-if-external, name or None)
    imports: Dict[str, Tuple[Optional[str], Optional[str]]] = \
        dataclasses.field(default_factory=dict)
    # module-global objects: name -> class name / sync kind
    global_classes: Dict[str, str] = dataclasses.field(default_factory=dict)
    global_kind: Dict[str, str] = dataclasses.field(default_factory=dict)
    # plain module globals mutated via `global` somewhere in the package
    mutated_globals: Set[str] = dataclasses.field(default_factory=set)
    module_names: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _Spawn:
    fn: str                       # spawning function qname
    rel: str
    lineno: int
    targets: List[str]            # resolved target qnames
    role: str
    daemon: bool
    binding: Optional[tuple]      # state key or ("local", fn, name)


class _ScopeVisitor(ast.NodeVisitor):
    """Collect functions/classes with qualified names and lexical scope."""

    def __init__(self, mod: _Module):
        self.mod = mod
        self._cls: List[str] = []
        self._fn: List[_Func] = []

    def _qname(self, name: str) -> str:
        parts = [f.qname.split("::", 1)[1] for f in self._fn[-1:]]
        if parts:
            return f"{self.mod.rel}::{parts[0]}.{name}"
        if self._cls:
            return f"{self.mod.rel}::{'.'.join(self._cls)}.{name}"
        return f"{self.mod.rel}::{name}"

    def _add_func(self, node, name: str) -> _Func:
        qname = self._qname(name)
        is_method = bool(self._cls) and not self._fn
        f = _Func(qname=qname, rel=self.mod.rel,
                  cls=self._cls[-1] if is_method else
                  (self._fn[-1].cls if self._fn else None),
                  node=node, parent=self._fn[-1].qname if self._fn else None,
                  is_method=is_method)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in node.decorator_list:
                d_name = d.id if isinstance(d, ast.Name) else \
                    d.attr if isinstance(d, ast.Attribute) else None
                if d_name in ("property", "cached_property"):
                    f.is_property = True
        self.mod.funcs[qname] = f
        if self._fn:
            self._fn[-1].nested[name] = qname
        elif self._cls:
            self.mod.classes.setdefault(self._cls[-1], {})[name] = qname
        else:
            self.mod.top_funcs[name] = qname
        return f

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if self._fn:          # classes inside functions: skip (none in repo)
            return
        self.mod.classes.setdefault(node.name, {})
        self.mod.bases[node.name] = [
            b.id if isinstance(b, ast.Name) else b.attr
            for b in node.bases if isinstance(b, (ast.Name, ast.Attribute))]
        self._cls.append(node.name)
        self.generic_visit(node)
        self._cls.pop()

    def _visit_fn(self, node) -> None:
        f = self._add_func(node, node.name)
        self._fn.append(f)
        self.generic_visit(node)
        self._fn.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._add_func(node, f"<lambda@{node.lineno}>")
        self.generic_visit(node)


def _resolve_import(rel: str, module: Optional[str], level: int,
                    known: Set[str]) -> Optional[str]:
    """Map an ImportFrom to a module path relative to the scan root, or
    None when the import leaves the scanned package."""
    if level == 0:
        return None  # absolute imports resolve outside the scan root
    base = rel.replace(os.sep, "/").split("/")[:-1]
    up = level - 1
    if up > len(base):
        return None
    parts = base[:len(base) - up] + (module.split(".") if module else [])
    for cand in ("/".join(parts) + ".py",
                 "/".join(parts + ["__init__"]) + ".py"):
        if cand in known:
            return cand
    return None


def _scan_module(rel: str, path: str, src: str) -> Optional[_Module]:
    try:
        tree = ast.parse(src, filename=path or rel)
    except SyntaxError:
        return None
    mod = _Module(rel=rel, path=path, tree=tree, lines=src.splitlines())
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._ccy_parent = node  # type: ignore[attr-defined]
    _ScopeVisitor(mod).visit(tree)
    for stmt in tree.body:  # module-level bindings
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    mod.module_names.add(t.id)
                    v = stmt.value
                    if isinstance(v, ast.Call):
                        ctor = _call_ctor_name(v)
                        if ctor in _SYNC_CTORS:
                            mod.global_kind[t.id] = _SYNC_CTORS[ctor]
                        elif ctor:
                            mod.global_classes[t.id] = ctor
    return mod


def _call_ctor_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _own_nodes(fn_node: ast.AST):
    """Walk a function body WITHOUT descending into nested function /
    class definitions (those are separate _Funcs)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# =====================================================================
# package model
# =====================================================================
class Package:
    """The scanned package: modules, type facts, call graph, roles."""

    def __init__(self, modules: List[_Module], root: str = ""):
        self.root = root
        self.modules: Dict[str, _Module] = {m.rel: m for m in modules}
        self.funcs: Dict[str, _Func] = {}
        self.methods_by_name: Dict[str, List[str]] = {}
        self.classes_by_name: Dict[str, List[Tuple[str, str]]] = {}
        self.property_names: Set[str] = set()
        # (rel, cls, attr) -> sync kind / set of package class names
        self.attr_kind: Dict[tuple, str] = {}
        self.attr_classes: Dict[tuple, Set[str]] = {}
        self.spawns: List[_Spawn] = []
        self.edges: Dict[str, Set[str]] = {}
        self.call_sites: Dict[str, List[Tuple[ast.Call, Set[str]]]] = {}
        self.roles: Dict[str, Set[str]] = {}        # role -> reachable fns
        self.role_of: Dict[str, Set[str]] = {}      # fn -> roles
        self.contexts: Dict[str, Set[FrozenSet[str]]] = {}
        self.lock_kind: Dict[str, str] = {}         # lock id -> kind
        for m in modules:
            for q, f in m.funcs.items():
                self.funcs[q] = f
                short = q.rsplit(".", 1)[-1]
                if f.is_method:
                    self.methods_by_name.setdefault(short, []).append(q)
                    if f.is_property:
                        self.property_names.add(short)
            for cls in m.classes:
                self.classes_by_name.setdefault(cls, []).append((m.rel, cls))
        self._collect_types()
        self._collect_globals_mutation()
        self._build_calls()
        self._build_roles()
        self._propagate_contexts()

    # ------------------------------------------------------------ typing
    def _collect_types(self) -> None:
        # factory returns first: `def make(): return Impl(...)` lets
        # `self.x = make()` type the attribute with every Impl — the
        # native-with-fallback pattern (_make_batcher) resolves exactly
        self._ret_classes: Dict[Tuple[str, str], Set[str]] = {}
        for m in self.modules.values():
            for name, q in m.top_funcs.items():
                classes: Set[str] = set()
                node = self.funcs[q].node
                for n in _own_nodes(node):
                    if isinstance(n, ast.Return) \
                            and isinstance(n.value, ast.Call):
                        ctor = _call_ctor_name(n.value)
                        if ctor in self.classes_by_name:
                            classes.add(ctor)
                if classes:
                    self._ret_classes[(m.rel, name)] = classes
        # two passes: attribute types discovered in one function (e.g. a
        # subscript store `self._batchers[k] = _make_batcher(...)`) feed
        # receiver typing in every other function on the second pass
        for _ in range(2):
            for m in self.modules.values():
                for f in m.funcs.values():
                    self._scan_fn_types(m, f)

    def _ann_classes(self, ann: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for n in ast.walk(ann):
            name = None
            if isinstance(n, ast.Name):
                name = n.id
            elif isinstance(n, ast.Constant) and isinstance(n.value, str):
                name = n.value
            if name and name in self.classes_by_name:
                out.add(name)
        return out

    def _collect_globals_mutation(self) -> None:
        """Register module globals written through `global` declarations
        so loads of those names can be keyed before findings run."""
        for m in self.modules.values():
            for f in m.funcs.values():
                if not f.globals_decl:
                    continue
                for node in _own_nodes(f.node):
                    if isinstance(node, (ast.Assign, ast.AugAssign,
                                         ast.AnnAssign)):
                        ts = node.targets if isinstance(node, ast.Assign) \
                            else [node.target]
                        for t in ts:
                            if isinstance(t, ast.Name) \
                                    and t.id in f.globals_decl:
                                m.mutated_globals.add(t.id)

    def _scan_fn_types(self, m: _Module, f: _Func) -> None:
        """One forward pass binding local/attr types from constructor
        calls, annotations, and derivations out of self attributes."""
        node = f.node
        if isinstance(node, ast.Lambda):
            return
        args = node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + [x for x in (args.vararg, args.kwarg) if x]):
            if a.annotation is not None:
                classes = self._ann_classes(a.annotation)
                if classes:
                    f.local_classes[a.arg] = classes
        # source order matters: `t = self._workers[k]` must bind before a
        # later `t.join()` is classified (a bare walk is LIFO)
        stmts = sorted(
            (s for s in _own_nodes(node)
             if isinstance(s, (ast.Global, ast.Assign, ast.AnnAssign,
                               ast.For))),
            key=lambda s: (s.lineno, s.col_offset))
        for stmt in stmts:
            if isinstance(stmt, ast.Global):
                f.globals_decl.update(stmt.names)
                continue
            if isinstance(stmt, ast.For):
                self._bind_for(m, f, stmt)
                continue
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            value = stmt.value
            ann = stmt.annotation if isinstance(stmt, ast.AnnAssign) else None
            for t in targets:
                self._bind_target(m, f, t, value, ann)

    def _bind_target(self, m, f, t, value, ann) -> None:
        kind = classes = None
        if isinstance(value, ast.Call):
            ctor = _call_ctor_name(value)
            if ctor in _SYNC_CTORS:
                kind = _SYNC_CTORS[ctor]
            elif ctor and ctor in self.classes_by_name:
                classes = {ctor}
            elif ctor:
                ret = self._ret_classes.get((m.rel, ctor))
                if ret is None:
                    imp = m.imports.get(ctor)
                    if imp and imp[0]:
                        ret = self._ret_classes.get((imp[0], imp[1]))
                if ret:
                    classes = set(ret)
        elif isinstance(value, (ast.List, ast.Tuple, ast.Set)):
            elts: Set[str] = set()
            for e in value.elts:
                elts |= self._value_classes(m, f, e)
            classes = elts or None
        elif value is not None:
            classes = self._value_classes(m, f, value) or None
            kind = self._value_kind(m, f, value)
        if ann is not None and not classes:
            classes = self._ann_classes(ann) or None
        if isinstance(t, ast.Subscript):
            # container-element store: self.X[k] = Impl(...) types the
            # VALUES drawn back out of self.X (matching annotation
            # extraction, which also yields element classes)
            inner = t.value
            while isinstance(inner, ast.Subscript):
                inner = inner.value
            if isinstance(inner, ast.Attribute) \
                    and self._is_self(inner.value, f):
                key = (f.rel, f.cls, inner.attr)
                if classes:
                    self.attr_classes.setdefault(key, set()).update(classes)
                if kind:  # e.g. self._workers[k] = <Thread>
                    self.attr_kind.setdefault(key, kind)
            return
        if isinstance(t, ast.Name):
            if kind:
                f.local_kind[t.id] = kind
            if classes:
                f.local_classes[t.id] = set(classes)
            src_key = self._derivation_key(m, f, value)
            if src_key:
                f.derived[t.id] = src_key
                # values drawn out of a typed container inherit its
                # element classes/kind (t = self._workers[k]; t.join())
                if not classes and src_key in self.attr_classes:
                    f.local_classes[t.id] = set(self.attr_classes[src_key])
                if not kind and src_key in self.attr_kind:
                    f.local_kind.setdefault(t.id, self.attr_kind[src_key])
        elif isinstance(t, ast.Attribute) and self._is_self(t.value, f):
            key = (f.rel, f.cls, t.attr)
            if kind:
                self.attr_kind[key] = kind
            if classes:
                self.attr_classes.setdefault(key, set()).update(classes)
            if ann is not None:
                more = self._ann_classes(ann)
                if more:
                    self.attr_classes.setdefault(key, set()).update(more)

    def _bind_for(self, m, f, stmt: ast.For) -> None:
        src_key = self._derivation_key(m, f, stmt.iter)
        classes = self._value_classes(m, f, stmt.iter)
        if src_key and not classes:
            classes = self.attr_classes.get(src_key, set())
        kind = self.attr_kind.get(src_key) if src_key else None
        names: List[str] = []
        for t in ast.walk(stmt.target):
            if isinstance(t, ast.Name):
                names.append(t.id)
        for n in names:
            if src_key:
                f.derived[n] = src_key
            if classes:
                f.local_classes.setdefault(n, set()).update(classes)
            if kind:
                f.local_kind.setdefault(n, kind)

    def _derivation_key(self, m, f, expr) -> Optional[tuple]:
        """The state key an expression reads through (self.X, self.X[i],
        self.X.values()/items(), dict(self.X), or a derived local)."""
        e = expr
        while True:
            if isinstance(e, ast.Call):
                fe = e.func
                if isinstance(fe, ast.Attribute) and fe.attr in (
                        "values", "items", "keys", "get", "copy", "pop"):
                    e = fe.value
                    continue
                if isinstance(fe, ast.Name) and fe.id in (
                        "list", "dict", "tuple", "sorted", "set") and e.args:
                    e = e.args[0]
                    continue
                return None
            if isinstance(e, ast.Subscript):
                e = e.value
                continue
            break
        if isinstance(e, ast.Attribute) and self._is_self(e.value, f):
            return (f.rel, f.cls, e.attr)
        if isinstance(e, ast.Name) and e.id in f.derived:
            return f.derived[e.id]
        return None

    @staticmethod
    def _is_self(expr, f: _Func) -> bool:
        return isinstance(expr, ast.Name) and expr.id == "self" \
            and f.cls is not None

    def _value_kind(self, m: _Module, f: _Func, expr) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id in f.local_kind:
                return f.local_kind[expr.id]
            return m.global_kind.get(expr.id)
        if isinstance(expr, ast.Attribute):
            if self._is_self(expr.value, f):
                k = self.attr_kind.get((f.rel, f.cls, expr.attr))
                if k:
                    return k
                for rel, cls in self._class_mro(f.rel, f.cls):
                    k = self.attr_kind.get((rel, cls, expr.attr))
                    if k:
                        return k
                return None
            g = self._global_object(m, f, expr.value)
            if g:
                return self.attr_kind.get((g[0], g[1], expr.attr))
        return None

    def _value_classes(self, m: _Module, f: _Func, expr) -> Set[str]:
        if isinstance(expr, ast.Name):
            if expr.id in f.local_classes:
                return f.local_classes[expr.id]
            if expr.id in m.global_classes:
                return {m.global_classes[expr.id]}
            return set()
        if isinstance(expr, ast.Attribute) and self._is_self(expr.value, f):
            out = set(self.attr_classes.get((f.rel, f.cls, expr.attr), ()))
            for rel, cls in self._class_mro(f.rel, f.cls):
                out |= self.attr_classes.get((rel, cls, expr.attr), set())
            return out
        if isinstance(expr, ast.Subscript):
            return self._value_classes(m, f, expr.value)
        return set()

    def _global_object(self, m: _Module, f: _Func,
                       expr) -> Optional[Tuple[str, str]]:
        """(rel, class) of a module-global object referenced by name —
        possibly through an import alias."""
        if not isinstance(expr, ast.Name):
            return None
        cls = m.global_classes.get(expr.id)
        if cls and cls in self.classes_by_name:
            rel = next((r for r, c in self.classes_by_name[cls]), m.rel)
            return (rel, cls)
        return None

    def _class_mro(self, rel: str, cls: Optional[str]
                   ) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        if cls is None:
            return out
        seen = {cls}
        work = list(self.modules[rel].bases.get(cls, ()))
        while work:
            b = work.pop()
            if b in seen:
                continue
            seen.add(b)
            for brel, bcls in self.classes_by_name.get(b, ()):
                out.append((brel, bcls))
                work.extend(self.modules[brel].bases.get(bcls, ()))
        return out

    # ------------------------------------------------------- call graph
    def _lookup_method(self, rel: str, cls: str, name: str
                       ) -> Optional[str]:
        q = self.modules[rel].classes.get(cls, {}).get(name)
        if q:
            return q
        for brel, bcls in self._class_mro(rel, cls):
            q = self.modules[brel].classes.get(bcls, {}).get(name)
            if q:
                return q
        return None

    def _resolve_name_call(self, m: _Module, f: _Func, name: str
                           ) -> Set[str]:
        cur: Optional[_Func] = f
        while cur is not None:  # lexical scope chain for closures
            if name in cur.nested:
                return {cur.nested[name]}
            cur = self.funcs.get(cur.parent) if cur.parent else None
        if f.cls and name in m.classes.get(f.cls, {}):
            return {m.classes[f.cls][name]}
        if name in m.top_funcs:
            return {m.top_funcs[name]}
        imp = m.imports.get(name)
        if imp and imp[0]:
            target = self.modules.get(imp[0])
            if target:
                if imp[1] in target.top_funcs:
                    return {target.top_funcs[imp[1]]}
                if imp[1] in target.classes:
                    init = target.classes[imp[1]].get("__init__")
                    return {init} if init else set()
        if name in m.classes:  # local class instantiation
            init = self._lookup_method(m.rel, name, "__init__")
            return {init} if init else set()
        if name in self.classes_by_name:
            rel, cls = self.classes_by_name[name][0]
            init = self._lookup_method(rel, cls, "__init__")
            return {init} if init else set()
        return set()

    def _resolve_attr_call(self, m: _Module, f: _Func,
                           func: ast.Attribute) -> Set[str]:
        recv, name = func.value, func.attr
        if self._value_kind(m, f, recv) is not None:
            return set()  # lock/queue/thread/... stdlib objects
        if self._is_self(recv, f):
            q = self._lookup_method(f.rel, f.cls, name)
            return {q} if q else set()
        classes = self._value_classes(m, f, recv)
        if classes:
            # typed receiver: resolve ONLY within its classes — a miss
            # means a stdlib/external method, not a package call
            out: Set[str] = set()
            for c in classes:
                for rel, cls in self.classes_by_name.get(c, ()):
                    q = self._lookup_method(rel, cls, name)
                    if q:
                        out.add(q)
            return out
        g = self._global_object(m, f, recv)
        if g:
            q = self._lookup_method(g[0], g[1], name)
            if q:
                return {q}
        imp = m.imports.get(recv.id) if isinstance(recv, ast.Name) else None
        if imp and imp[0] is not None and imp[1] is None:
            target = self.modules.get(imp[0])
            if target and name in target.top_funcs:
                return {target.top_funcs[name]}
        # ambiguous receiver: every package class defining the method —
        # except names that collide with builtin container/str/file
        # methods, where the receiver is overwhelmingly a dict/list/str
        # (`self._models.get(...)` must not resolve to _Channel.get)
        if name in _BUILTIN_METHOD_NAMES:
            return set()
        return set(self.methods_by_name.get(name, ()))

    def _build_calls(self) -> None:
        for m in self.modules.values():
            for f in m.funcs.values():
                sites: List[Tuple[ast.Call, Set[str]]] = []
                out: Set[str] = set()
                for node in _own_nodes(f.node):
                    if isinstance(node, ast.Call):
                        callees = self._resolve_call_node(m, f, node)
                        if callees:
                            sites.append((node, callees))
                            out |= callees
                    elif isinstance(node, ast.Attribute) \
                            and isinstance(node.ctx, ast.Load) \
                            and node.attr in self.property_names \
                            and not isinstance(
                                getattr(node, "_ccy_parent", None),
                                ast.Call):
                        # property access IS a call (no parens in source)
                        for q in self.methods_by_name.get(node.attr, ()):
                            if self.funcs[q].is_property:
                                out.add(q)
                self.call_sites[f.qname] = sites
                self.edges[f.qname] = out
        self._find_spawns()

    def _resolve_call_node(self, m, f, call: ast.Call) -> Set[str]:
        fe = call.func
        if isinstance(fe, ast.Name):
            return self._resolve_name_call(m, f, fe.id)
        if isinstance(fe, ast.Attribute):
            return self._resolve_attr_call(m, f, fe)
        return set()

    # ------------------------------------------------------------ roles
    def _find_spawns(self) -> None:
        for m in self.modules.values():
            for f in m.funcs.values():
                for node in _own_nodes(f.node):
                    if not (isinstance(node, ast.Call) and (
                            (isinstance(node.func, ast.Name)
                             and node.func.id == "Thread")
                            or (isinstance(node.func, ast.Attribute)
                                and node.func.attr == "Thread"))):
                        continue
                    target = name_kw = daemon = None
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target = kw.value
                        elif kw.arg == "name" and isinstance(
                                kw.value, ast.Constant):
                            name_kw = str(kw.value.value)
                        elif kw.arg == "daemon" and isinstance(
                                kw.value, ast.Constant):
                            daemon = bool(kw.value.value)
                    if target is None:
                        continue
                    targets = self._resolve_spawn_target(m, f, target)
                    role = name_kw or (
                        sorted(targets)[0].rsplit(".", 1)[-1]
                        if targets else f"thread@{node.lineno}")
                    self.spawns.append(_Spawn(
                        fn=f.qname, rel=m.rel, lineno=node.lineno,
                        targets=sorted(targets),
                        role=f"{m.rel}:{role}",
                        daemon=bool(daemon),
                        binding=self._spawn_binding(f, node)))

    def _resolve_spawn_target(self, m, f, target) -> Set[str]:
        if isinstance(target, ast.Lambda):
            q = f"{m.rel}::<lambda@{target.lineno}>"
            for cand in m.funcs:
                if cand.endswith(f"<lambda@{target.lineno}>"):
                    return {cand}
            return {q} if q in m.funcs else set()
        if isinstance(target, ast.Name):
            return self._resolve_name_call(m, f, target.id)
        if isinstance(target, ast.Attribute):
            if self._is_self(target.value, f):
                q = self._lookup_method(f.rel, f.cls, target.attr)
                return {q} if q else set()
            classes = self._value_classes(m, f, target.value)
            out: Set[str] = set()
            for c in classes:
                for rel, cls in self.classes_by_name.get(c, ()):
                    q = self._lookup_method(rel, cls, target.attr)
                    if q:
                        out.add(q)
            return out or set(self.methods_by_name.get(target.attr, ()))
        return set()

    def _spawn_binding(self, f: _Func, call: ast.Call) -> Optional[tuple]:
        node = getattr(call, "_ccy_parent", None)
        if isinstance(node, ast.Assign) and node.targets:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                # a local later parked in a self container (the worker-
                # pool pattern: t = Thread(...); self._workers[k] = t)
                # binds to the container — that is what stop() joins
                for n in _own_nodes(f.node):
                    if isinstance(n, ast.Assign) \
                            and isinstance(n.value, ast.Name) \
                            and n.value.id == t.id:
                        for t2 in n.targets:
                            inner = t2
                            while isinstance(inner, ast.Subscript):
                                inner = inner.value
                            if isinstance(inner, ast.Attribute) \
                                    and self._is_self(inner.value, f):
                                return (f.rel, f.cls, inner.attr)
                return ("local", f.qname, t.id)
            if isinstance(t, ast.Attribute) and self._is_self(t.value, f):
                return (f.rel, f.cls, t.attr)
            if isinstance(t, ast.Subscript) \
                    and isinstance(t.value, ast.Attribute) \
                    and self._is_self(t.value.value, f):
                return (f.rel, f.cls, t.value.attr)
        return None

    def _build_roles(self) -> None:
        target_qnames: Set[str] = set()
        for s in self.spawns:
            target_qnames.update(s.targets)
        called: Set[str] = set()
        for outs in self.edges.values():
            called |= outs
        target_only = {q for q in target_qnames if q not in called}

        def reach(roots: Sequence[str]) -> Set[str]:
            seen: Set[str] = set()
            work = [r for r in roots if r in self.funcs]
            while work:
                q = work.pop()
                if q in seen:
                    continue
                seen.add(q)
                work.extend(self.edges.get(q, ()))
            return seen

        # roots = the package's PUBLIC surface (plus dunders — __del__
        # runs from GC, __init__ from construction). Underscore-private
        # functions are reachable only through real call edges, so a
        # "caller must hold the lock" helper inherits its callers' lock
        # contexts instead of a spurious unlocked entry.
        self._main_roots = [
            q for q, f in self.funcs.items()
            if f.parent is None and q not in target_only
            and not isinstance(f.node, ast.Lambda)
            and self._is_public(q)]
        self.roles[MAIN_ROLE] = reach(self._main_roots)
        for s in self.spawns:
            self.roles.setdefault(s.role, set()).update(reach(s.targets))
        for role, fns in self.roles.items():
            for q in fns:
                self.role_of.setdefault(q, set()).add(role)

    def worker_roles(self) -> List[str]:
        return sorted(r for r in self.roles if r != MAIN_ROLE)

    def worker_only(self, qname: str) -> bool:
        roles = self.role_of.get(qname, set())
        return bool(roles - {MAIN_ROLE}) and MAIN_ROLE not in roles

    def worker_only_nodes(self, rel: str) -> List[Tuple[ast.AST, str]]:
        """Worker-only function nodes defined in one module — the set
        HOT002/003 applies to (:mod:`.hotpath_lint` rebases on this)."""
        m = self.modules.get(rel)
        if not m:
            return []
        out = []
        for q, f in m.funcs.items():
            if self.worker_only(q):
                roles = sorted(self.role_of.get(q, set()) - {MAIN_ROLE})
                out.append((f.node, ",".join(roles)))
        return out

    # ------------------------------------------------------ lock contexts
    def _lock_id(self, m: _Module, f: _Func, expr) -> Optional[str]:
        kind = self._value_kind(m, f, expr)
        if kind not in _LOCKY:
            return None
        if isinstance(expr, ast.Attribute) and self._is_self(expr.value, f):
            key = (f.rel, f.cls, expr.attr)
            if key not in self.attr_kind:
                for rel, cls in self._class_mro(f.rel, f.cls):
                    if (rel, cls, expr.attr) in self.attr_kind:
                        key = (rel, cls, expr.attr)
                        break
            lid = f"{key[0]}::{key[1]}.{key[2]}"
        elif isinstance(expr, ast.Name):
            if expr.id in f.local_kind:
                lid = f"{f.qname}::{expr.id}"
            else:
                lid = f"{m.rel}::{expr.id}"
        else:
            lid = f"{m.rel}::{_unparse(expr)}"
        self.lock_kind[lid] = kind
        return lid

    def _local_held(self, m: _Module, f: _Func, node: ast.AST
                    ) -> List[str]:
        """Lock ids of `with` regions strictly enclosing ``node`` inside
        ``f`` (lexical only; interprocedural context adds the rest)."""
        held: List[str] = []
        cur = getattr(node, "_ccy_parent", None)
        while cur is not None and cur is not f.node:
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    lid = self._lock_id(m, f, item.context_expr)
                    if lid:
                        held.append(lid)
            cur = getattr(cur, "_ccy_parent", None)
        return held

    def _with_items_before(self, m, f, withnode, item_idx) -> List[str]:
        out = []
        for item in withnode.items[:item_idx]:
            lid = self._lock_id(m, f, item.context_expr)
            if lid:
                out.append(lid)
        return out

    @staticmethod
    def _is_public(qname: str) -> bool:
        short = qname.rsplit("::", 1)[-1].rsplit(".", 1)[-1]
        return not short.startswith("_") or (
            short.startswith("__") and short.endswith("__"))

    def _propagate_contexts(self, max_ctx: int = 16) -> None:
        for q in self.funcs:
            self.contexts[q] = set()
        work: List[Tuple[str, FrozenSet[str]]] = []
        roots: Set[str] = set(self._main_roots)
        for s in self.spawns:
            roots.update(t for t in s.targets if t in self.funcs)
        for q in roots:
            work.append((q, frozenset()))
        while work:
            q, held = work.pop()
            ctxs = self.contexts[q]
            if held in ctxs or len(ctxs) >= max_ctx:
                continue
            ctxs.add(held)
            m = self.modules[self.funcs[q].rel]
            f = self.funcs[q]
            for call, callees in self.call_sites.get(q, ()):
                out = held | frozenset(self._local_held(m, f, call))
                for c in callees:
                    if c in self.funcs:
                        work.append((c, out))

    def held_at(self, f: _Func, node: ast.AST) -> List[FrozenSet[str]]:
        """Every possible held-lock set at a node: the function's
        incoming contexts each unioned with the lexical `with` stack."""
        m = self.modules[f.rel]
        local = frozenset(self._local_held(m, f, node))
        ctxs = self.contexts.get(f.qname) or {frozenset()}
        return [c | local for c in ctxs]


# =====================================================================
# access collection + findings
# =====================================================================
@dataclasses.dataclass
class _Access:
    key: tuple
    fn: str
    rel: str
    lineno: int
    store: bool
    held: List[FrozenSet[str]]

    def always_held(self) -> FrozenSet[str]:
        out: Optional[FrozenSet[str]] = None
        for h in self.held:
            out = h if out is None else (out & h)
        return out or frozenset()

    def sometimes_unguarded(self) -> bool:
        return any(not h for h in self.held)


class _Auditor:
    def __init__(self, pkg: Package, report: ValidationReport):
        self.pkg = pkg
        self.report = report
        self.suppressed = 0

    # -------------------------------------------------------- plumbing
    def _lines(self, rel: str) -> List[str]:
        return self.pkg.modules[rel].lines

    def _emit(self, code: str, rel: str, lineno: int, message: str,
              severity: str = "error") -> None:
        token = PRAGMA_TOKENS[code]
        if pragmas.line_has(self._lines(rel), lineno, PRAGMA_TOOL, token):
            self.suppressed += 1
            return
        self.report.add(code, message, severity=severity,
                        file=rel, line=lineno)

    @staticmethod
    def _fmt_lock(lid: str) -> str:
        return lid.rsplit("::", 1)[-1]

    def _fmt_key(self, key: tuple) -> str:
        rel, cls, attr = key
        return f"{cls}.{attr}" if cls else f"{rel}:{attr}"

    # ------------------------------------------------------ state audit
    def collect_accesses(self) -> Dict[tuple, List[_Access]]:
        state: Dict[tuple, List[_Access]] = {}
        for m in self.pkg.modules.values():
            for f in m.funcs.values():
                for node in _own_nodes(f.node):
                    for key, store, where in self._node_accesses(m, f, node):
                        if f.cls is not None and key[:2] == (f.rel, f.cls) \
                                and f.qname.rsplit(".", 1)[-1] \
                                in _CTOR_METHODS:
                            continue  # constructor happens-before publish
                        kind = self.pkg.attr_kind.get(key)
                        if kind in ("lock", "condition", "event"):
                            continue  # the sync objects themselves
                        state.setdefault(key, []).append(_Access(
                            key=key, fn=f.qname, rel=m.rel,
                            lineno=where, store=store,
                            held=self.pkg.held_at(f, node)))
        return state

    def _node_accesses(self, m: _Module, f: _Func, node: ast.AST):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if getattr(node, "value", None) is None:
                targets = []  # bare annotation, no store
            for t in targets:
                key = self._target_key(m, f, t)
                if key:
                    yield key, True, t.lineno
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load):
            key = self._attr_key(m, f, node)
            if key:
                yield key, False, node.lineno
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id in m.mutated_globals \
                    and node.id not in f.local_kind \
                    and (node.id in f.globals_decl
                         or not self._binds_locally(f, node.id)):
                yield ("g", m.rel, node.id), False, node.lineno

    def _binds_locally(self, f: _Func, name: str) -> bool:
        for n in _own_nodes(f.node):
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                ts = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in ts:
                    if isinstance(t, ast.Name) and t.id == name:
                        return True
        return False

    def _attr_key(self, m, f, node: ast.Attribute) -> Optional[tuple]:
        if self._is_self(node.value, f):
            key = (f.rel, f.cls, node.attr)
            # attribute inherited from a base class: key on the definer
            if key not in self.pkg.attr_kind \
                    and key not in self.pkg.attr_classes:
                for rel, cls in self.pkg._class_mro(f.rel, f.cls):
                    cand = (rel, cls, node.attr)
                    if cand in self.pkg.attr_kind \
                            or cand in self.pkg.attr_classes:
                        return cand
            return key
        g = self.pkg._global_object(m, f, node.value)
        if g:
            return (g[0], g[1], node.attr)
        return None

    @staticmethod
    def _is_self(expr, f: _Func) -> bool:
        return Package._is_self(expr, f)

    def _target_key(self, m, f, t) -> Optional[tuple]:
        if isinstance(t, ast.Attribute):
            return self._attr_key(m, f, t)
        if isinstance(t, ast.Subscript):
            inner = t.value
            while isinstance(inner, ast.Subscript):
                inner = inner.value
            if isinstance(inner, ast.Attribute):
                return self._attr_key(m, f, inner)
            return None
        if isinstance(t, ast.Name) and t.id in f.globals_decl:
            m.mutated_globals.add(t.id)
            return ("g", m.rel, t.id)
        return None

    def audit_shared_state(self) -> None:
        state = self.collect_accesses()
        for key, accesses in sorted(state.items(), key=lambda kv: str(kv)):
            roles: Set[str] = set()
            for a in accesses:
                roles |= self.pkg.role_of.get(a.fn, set())
            self._audit_guard_consistency(key, accesses)
            if len(roles) < 2:
                continue
            stores = [a for a in accesses if a.store]
            guard = self._common_store_guard(stores)
            for a in stores:
                if a.sometimes_unguarded():
                    others = sorted({self._fmt_lock(l)
                                     for o in accesses if o is not a
                                     for l in o.always_held()})
                    hint = f" (elsewhere guarded by " \
                           f"{', '.join(others)})" if others else ""
                    self._emit(
                        "CCY001", a.rel, a.lineno,
                        f"unguarded write to '{self._fmt_key(key)}' "
                        f"shared by roles {sorted(roles)}{hint} — "
                        f"annotate '# concurrency: race-ok (reason)' "
                        f"if the discipline is external")
            if guard and stores:
                for a in accesses:
                    if not a.store and a.sometimes_unguarded():
                        self._emit(
                            "CCY001", a.rel, a.lineno,
                            f"read of '{self._fmt_key(key)}' outside "
                            f"{', '.join(sorted(self._fmt_lock(g) for g in guard))}"
                            f", which guards its writes (torn/stale "
                            f"read across roles {sorted(roles)})",
                            severity="warning")

    @staticmethod
    def _common_store_guard(stores: List[_Access]) -> FrozenSet[str]:
        guard: Optional[FrozenSet[str]] = None
        for a in stores:
            g = a.always_held()
            if not g:
                return frozenset()
            guard = g if guard is None else (guard & g)
        return guard or frozenset()

    def _audit_guard_consistency(self, key, accesses) -> None:
        guarded = [a for a in accesses if a.always_held()]
        if len(guarded) < 2:
            return
        common = guarded[0].always_held()
        for a in guarded[1:]:
            common = common & a.always_held()
        if common:
            return
        sites = {}
        for a in guarded:
            locks = tuple(sorted(self._fmt_lock(l)
                                 for l in a.always_held()))
            sites.setdefault(locks, (a.rel, a.lineno))
        if len(sites) < 2:
            return  # same lock tuple everywhere (common empty via kinds)
        desc = "; ".join(
            f"{'+'.join(locks)} at {rel}:{line}"
            for locks, (rel, line) in sorted(sites.items()))
        anchor = guarded[0]
        self._emit(
            "CCY006", anchor.rel, anchor.lineno,
            f"'{self._fmt_key(key)}' is guarded by DIFFERENT locks at "
            f"different sites ({desc}) — no mutual exclusion between "
            f"them")

    # -------------------------------------------------------- lock graph
    def audit_lock_order(self) -> None:
        edges: Dict[str, Dict[str, Tuple[str, int]]] = {}
        for m in self.pkg.modules.values():
            for f in m.funcs.values():
                ctxs = self.pkg.contexts.get(f.qname) or {frozenset()}
                for node in _own_nodes(f.node):
                    if not isinstance(node, (ast.With, ast.AsyncWith)):
                        continue
                    outer = self.pkg._local_held(m, f, node)
                    for i, item in enumerate(node.items):
                        lid = self.pkg._lock_id(m, f, item.context_expr)
                        if not lid:
                            continue
                        before = outer + \
                            self.pkg._with_items_before(m, f, node, i)
                        for ctx in ctxs:
                            for a in set(before) | ctx:
                                if a != lid:
                                    edges.setdefault(a, {}).setdefault(
                                        lid, (m.rel, node.lineno))
        for cycle in self._cycles(edges):
            path = " -> ".join(self._fmt_lock(l) for l in cycle)
            sites = [edges[a][b] for a, b in zip(cycle, cycle[1:])]
            if any(pragmas.line_has(self._lines(rel), line, PRAGMA_TOOL,
                                    PRAGMA_TOKENS["CCY002"])
                   for rel, line in sites):
                self.suppressed += 1
                continue
            rel, line = sites[0]
            where = ", ".join(f"{r}:{l}" for r, l in sites)
            self.report.add(
                "CCY002",
                f"lock-acquisition-order cycle {path} (acquired at "
                f"{where}) — two threads taking the ends in opposite "
                f"order deadlock", severity="error", file=rel, line=line)

    @staticmethod
    def _cycles(edges: Dict[str, Dict[str, tuple]]) -> List[List[str]]:
        """Shortest cycle through each back edge (DFS), deduplicated by
        the participating lock set."""
        out: List[List[str]] = []
        seen_sets: Set[FrozenSet[str]] = set()
        for start in sorted(edges):
            stack = [(start, [start])]
            visited = set()
            while stack:
                node, path = stack.pop()
                for nxt in sorted(edges.get(node, ())):
                    if nxt == start:
                        cyc = path + [start]
                        key = frozenset(cyc)
                        if key not in seen_sets:
                            seen_sets.add(key)
                            out.append(cyc)
                    elif nxt not in path and (node, nxt) not in visited:
                        visited.add((node, nxt))
                        if len(path) < 6:
                            stack.append((nxt, path + [nxt]))
        return out

    # ---------------------------------------------------- blocking calls
    # host syncs: a card-wide or event wait blocks the calling thread
    _BLOCKING_ATTRS = {"block_until_ready", "synchronize"}

    def audit_blocking_and_conditions(self) -> None:
        for m in self.pkg.modules.values():
            for f in m.funcs.values():
                for node in _own_nodes(f.node):
                    if isinstance(node, ast.Call):
                        self._audit_call(m, f, node)

    def _audit_call(self, m: _Module, f: _Func, call: ast.Call) -> None:
        fe = call.func
        if not isinstance(fe, ast.Attribute):
            return
        name = fe.attr
        recv_kind = self.pkg._value_kind(m, f, fe.value)
        held_sets = self.pkg.held_at(f, call)
        worst = max(held_sets, key=len) if held_sets else frozenset()

        if recv_kind == "condition" and name in ("wait", "wait_for",
                                                 "notify", "notify_all"):
            self._audit_condition(m, f, call, fe, name, held_sets)
            return
        desc = None
        if recv_kind == "queue" and name in ("get", "put", "join"):
            if any(kw.arg == "block" and isinstance(kw.value, ast.Constant)
                   and kw.value.value is False for kw in call.keywords):
                return
            desc = f"queue .{name}()"
        elif name == "join" and not call.args and recv_kind in (
                "thread", None):
            # zero-positional-arg .join(): thread/queue join ("".join
            # always takes the iterable positionally)
            desc = ".join()"
        elif recv_kind == "event" and name == "wait":
            desc = "event .wait()"
        elif name in self._BLOCKING_ATTRS:
            desc = f".{name}()"
        elif name == "sleep" and isinstance(fe.value, ast.Name) \
                and fe.value.id == "time":
            desc = "time.sleep()"
        if desc is None or not worst:
            return
        if any(h for h in held_sets):
            locks = ", ".join(sorted(self._fmt_lock(l) for l in worst))
            self._emit(
                "CCY003", m.rel, call.lineno,
                f"blocking call {desc} while holding {locks} — every "
                f"other thread needing that lock stalls behind this "
                f"wait (move the blocking call outside the region)")

    def _audit_condition(self, m, f, call, fe, name, held_sets) -> None:
        cid = self.pkg._lock_id(m, f, fe.value)
        if name in ("wait", "wait_for"):
            if cid and any(cid not in h for h in held_sets):
                self._emit(
                    "CCY004", m.rel, call.lineno,
                    f"Condition .{name}() outside `with "
                    f"{self._fmt_lock(cid)}:` — wait() requires the "
                    f"lock (RuntimeError at runtime)")
            if name == "wait" and not self._in_loop(f, call):
                self._emit(
                    "CCY004", m.rel, call.lineno,
                    "Condition .wait() without an enclosing predicate "
                    "loop — spurious wakeups and stolen notifies break "
                    "the invariant (use `while not pred: cond.wait()` "
                    "or wait_for)")
            others = [h - {cid} for h in held_sets if h]
            if cid and others and any(o for o in others):
                locks = sorted({self._fmt_lock(l)
                                for o in others for l in o})
                self._emit(
                    "CCY003", m.rel, call.lineno,
                    f"Condition .{name}() releases only "
                    f"{self._fmt_lock(cid)} but "
                    f"{', '.join(locks)} stays held while blocked — "
                    f"deadlock if the notifier needs it")
        else:  # notify / notify_all
            if cid and any(cid not in h for h in held_sets):
                self._emit(
                    "CCY004", m.rel, call.lineno,
                    f"Condition .{name}() outside `with "
                    f"{self._fmt_lock(cid)}:` — notify without the "
                    f"lock races the waiter's predicate check")

    @staticmethod
    def _in_loop(f: _Func, node: ast.AST) -> bool:
        cur = getattr(node, "_ccy_parent", None)
        while cur is not None and cur is not f.node:
            if isinstance(cur, (ast.While, ast.For, ast.AsyncFor)):
                return True
            cur = getattr(cur, "_ccy_parent", None)
        return False

    # ------------------------------------------------------ thread leaks
    def audit_thread_leaks(self) -> None:
        join_roots = self._join_roots()
        for s in self.pkg.spawns:
            if s.binding and s.binding in join_roots:
                continue
            if s.daemon and self._has_stop_path(s):
                continue
            why = []
            if not s.binding:
                why.append("the Thread object is not retained")
            elif s.binding not in join_roots:
                why.append(f"no .join() reaches "
                           f"{self._binding_desc(s.binding)}")
            if not s.daemon:
                why.append("not a daemon")
            elif not self._has_stop_path(s):
                why.append("its worker has no stop-event/exit path")
            self._emit(
                "CCY005", s.rel, s.lineno,
                f"thread leak: role '{s.role.split(':', 1)[1]}' is "
                f"started but {'; '.join(why)} — shutdown cannot "
                f"reclaim it")

    @staticmethod
    def _binding_desc(binding: tuple) -> str:
        if binding[0] == "local":
            return f"local '{binding[2]}'"
        return f"self.{binding[2]}"

    def _join_roots(self) -> Set[tuple]:
        roots: Set[tuple] = set()
        for m in self.pkg.modules.values():
            for f in m.funcs.values():
                for node in _own_nodes(f.node):
                    if not (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr == "join"
                            and not node.args):
                        continue
                    recv = node.func.value
                    if isinstance(recv, ast.Name):
                        if recv.id in f.derived:
                            roots.add(f.derived[recv.id])
                        roots.add(("local", f.qname, recv.id))
                    elif isinstance(recv, ast.Attribute) \
                            and self._is_self(recv.value, f):
                        roots.add((f.rel, f.cls, recv.attr))
                    elif isinstance(recv, ast.Subscript):
                        inner = recv.value
                        while isinstance(inner, ast.Subscript):
                            inner = inner.value
                        if isinstance(inner, ast.Attribute) \
                                and self._is_self(inner.value, f):
                            roots.add((f.rel, f.cls, inner.attr))
        return roots

    def _has_stop_path(self, s: _Spawn) -> bool:
        seen: Set[str] = set()
        work = [t for t in s.targets if t in self.pkg.funcs]
        while work:
            q = work.pop()
            if q in seen:
                continue
            seen.add(q)
            f = self.pkg.funcs[q]
            m = self.pkg.modules[f.rel]
            for node in _own_nodes(f.node):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "is_set" \
                        and self.pkg._value_kind(
                            m, f, node.func.value) == "event":
                    return True
            work.extend(self.pkg.edges.get(q, ()))
        return False


# =====================================================================
# public API
# =====================================================================
def build_package(paths: Sequence[str]) -> Package:
    """Scan .py files under ``paths`` (dirs or files) into a Package."""
    files: List[Tuple[str, str]] = []  # (rel, abs)
    root = ""
    for p in paths:
        if os.path.isfile(p):
            files.append((os.path.basename(p), os.path.abspath(p)))
            root = root or os.path.dirname(os.path.abspath(p))
            continue
        root = root or os.path.abspath(p)
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    ap = os.path.join(dirpath, fn)
                    files.append((os.path.relpath(ap, p).replace(
                        os.sep, "/"), os.path.abspath(ap)))
    known = {rel for rel, _ in files}
    modules: List[_Module] = []
    broken: List[Tuple[str, str]] = []
    for rel, ap in files:
        try:
            with open(ap, errors="replace") as f:
                src = f.read()
        except OSError:
            continue
        m = _scan_module(rel, ap, src)
        if m is None:
            broken.append((rel, ap))
            continue
        # resolve package-internal ImportFroms now that `known` exists
        for node in ast.walk(m.tree):
            if isinstance(node, ast.ImportFrom):
                target = _resolve_import(rel, node.module, node.level, known)
                for a in node.names:
                    bound = a.asname or a.name
                    if target:
                        sub = target.rsplit("/", 1)[0] + f"/{a.name}.py"
                        if a.name != "*" and sub in known \
                                and target.endswith("__init__.py"):
                            m.imports[bound] = (sub, None)
                        else:
                            m.imports[bound] = (target, a.name)
        modules.append(m)
    pkg = Package(modules, root=root)
    pkg.broken = broken  # type: ignore[attr-defined]
    return pkg


def check_package(paths: Sequence[str]) -> ValidationReport:
    """Run every concurrency check over a package; the main entry the
    gate, the tool, and the tests share."""
    pkg = build_package(paths)
    report = ValidationReport(source=",".join(paths), tag="concurrency")
    for rel, _ in getattr(pkg, "broken", ()):
        report.add("CCY000", f"unparseable module (syntax error): {rel}",
                   severity="error", file=rel, line=0)
    auditor = _Auditor(pkg, report)
    auditor.audit_shared_state()
    auditor.audit_lock_order()
    auditor.audit_blocking_and_conditions()
    auditor.audit_thread_leaks()
    report.findings.sort(key=lambda f: (f.file or "", f.line or 0, f.code))
    report.roles = {  # type: ignore[attr-defined]
        role: {"functions": len(fns),
               "roots": sorted(s.targets for s in pkg.spawns
                               if s.role == role)[:1]}
        for role, fns in sorted(pkg.roles.items())}
    report.suppressed = auditor.suppressed  # type: ignore[attr-defined]
    report.package = pkg  # type: ignore[attr-defined]
    return report


def check_source(src: str, filename: str = "<string>"
                 ) -> List[Finding]:
    """Single-module convenience used by the seeded-fixture tests: the
    module is treated as a one-file package."""
    m = _scan_module(filename, "", src)
    if m is None:
        return [Finding(code="CCY000", severity="error", file=filename,
                        line=0, message="unparseable module")]
    pkg = Package([m])
    report = ValidationReport(source=filename, tag="concurrency")
    auditor = _Auditor(pkg, report)
    auditor.audit_shared_state()
    auditor.audit_lock_order()
    auditor.audit_blocking_and_conditions()
    auditor.audit_thread_leaks()
    report.findings.sort(key=lambda f: (f.line or 0, f.code))
    return report.findings


def module_worker_functions(src: str, filename: str = "<string>"
                            ) -> List[Tuple[ast.AST, str]]:
    """Worker-only function nodes of ONE module source — the standalone
    (no package context) role inference :mod:`.hotpath_lint` uses for
    single-source linting."""
    m = _scan_module(filename, "", src)
    if m is None:
        return []
    pkg = Package([m])
    return pkg.worker_only_nodes(filename)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        argv = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    report = check_package(argv)
    for f in report.findings:
        print(f.format())
    roles = getattr(report, "roles", {})
    print(f"concurrency audit: {len(report.errors)} error(s), "
          f"{len(report.warnings)} warning(s), "
          f"{getattr(report, 'suppressed', 0)} suppressed, "
          f"{len(roles)} role(s) over {', '.join(argv)}")
    return 1 if report.errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
