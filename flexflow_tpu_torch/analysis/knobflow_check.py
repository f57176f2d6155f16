"""Knob-flow auditor: cache-key / cohort-key soundness for config knobs.

PyTorch counterpart of ``flexflow_tpu/analysis/knobflow_check.py``, the
same pure-AST pass over the port's tree.

The paper's central artifact is a *cached* search result — a
parallelization plan keyed by graph + machine + knobs, reused across
compiles ("Beyond Data and Model Parallelism", arXiv:1807.05358; the
strategy cache in :mod:`..search.cache`). That contract has broken by
hand four times (guid-polluted keys, late ``pipeline_interleave``,
retro-stamped ``process_count``, retro-stamped dynamic-shape knobs):
each time a config knob started influencing what compile produces —
or what a perf cohort means — without anyone adding it to the key.
This pass makes the contract *checkable*, statically and step-free,
over the whole package at once (the concurrency auditor's posture, and
its package scanner/call graph are reused verbatim):

1. **Knob universe** — the dataclass fields of ``FFConfig``
   (``config.py``), each anchored at its definition line (where the
   findings land and the suppression pragmas live).
2. **Reachability** — every ``config.<knob>`` / ``cfg.<knob>`` /
   ``getattr(config, "knob", ...)`` read site is collected per
   function, then classified by interprocedural reachability from two
   root sets: the *compile* roots (``FFModel.compile`` /
   ``_run_search`` / the lowering in ``runtime/compiler.py`` / all of
   ``search/`` and ``sim/``) and the *perf* roots (``FFModel.fit`` /
   ``eval``, all of ``serving/``, the dataloader and the bucket
   planner).
3. **Coverage** — the stamped key sets are extracted from source, not
   configured: ``search/cache.py``'s ``_SEARCH_KNOBS`` tuple plus
   every knob-named string constant in ``config_signature`` (the
   conditional-stamp idiom), and ``obs/ledger.py``'s ``_*KNOB_FIELDS``
   tuples plus the constants in ``model_context`` /
   ``serving_knob_context``.

Findings (``KNB0xx`` in :data:`..findings.CODE_CATALOG`):

* **KNB001** (error) a compile-reachable knob is stamped into neither
  ``_SEARCH_KNOBS`` nor ``config_signature`` — a cached plan selected
  under one value would silently replay under another.
* **KNB002** (warning) a perf-reachable knob is absent from the
  ledger cohort context — ``tools/perf_sentinel.py`` would compare
  runs across different settings.
* **KNB003** (warning) dead knob: defined in ``config.py``, read
  nowhere in the scanned source (package + tools + examples +
  scripts).
* **KNB004** CLI-flag parity drift: a ``parse_args`` branch sets an
  unknown field (error), one flag claims two fields (error), or a
  field has no flag at all (warning).
* **KNB005** (error) a serializer version constant (``*_SCHEMA`` /
  ``*_VERSION``) is written into records but no reader anywhere
  compares against it — a layout change would be consumed silently
  instead of demoting to a counted skip.
* **KNB006** a knob is stamped only under a mode guard (the
  conditional-stamp idiom: ``if seq_buckets != "off": stamp(...)``)
  but some reachable read of it is not gated on the same mode knob —
  the knob can influence the artifact while the key omits it (error
  on the compile side, warning on the cohort side).

Intentional exclusions are suppressed in source through the shared
pragma grammar (:mod:`.pragmas`) with tool ``knobflow``, anchored on
the ``config.py`` field definition line (KNB001-004) or the
read/writer line (KNB005/006)::

    validate_pcg: str = "error"  # knobflow: key-ok (gate mode: ...)

Tokens: ``key-ok`` (KNB001), ``cohort-ok`` (KNB002), ``dead-ok``
(KNB003), ``flag-ok`` (KNB004), ``schema-ok`` (KNB005), ``guard-ok``
(KNB006). A pragma without a reason does not suppress — and the repo
sweep must end at 0 errors by FIXING real findings, not suppressing
them; pragmas are for knobs that genuinely cannot change the artifact
(gate modes, observability switches, hyperparameters that ride the
step program as arguments).

Soundness posture: the call graph over-approximates (an ambiguous
``obj.method()`` resolves to every package class defining ``method``),
so reachability errs toward demanding coverage; read detection
under-approximates receivers to names that look like a config
(``config`` / ``cfg`` / ``*.config``), which is the only idiom the
package uses. ``getattr(config, name)`` with a *dynamic* name (the
stamp loops themselves) contributes no read site — the stamp
functions are instead mined for their string constants, so they
self-cover.

Run as a module for the Makefile's ``knob-lint`` gate::

    python -m flexflow_tpu_torch.analysis.knobflow_check flexflow_tpu_torch
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import re
import sys
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from . import pragmas
from .concurrency_check import (Package, _own_nodes, _scan_module,
                                build_package)
from .findings import Finding, ValidationReport

PRAGMA_TOOL = "knobflow"
# one suppression token per finding class (the review-trail grammar)
PRAGMA_TOKENS = {
    "KNB001": "key-ok",
    "KNB002": "cohort-ok",
    "KNB003": "dead-ok",
    "KNB004": "flag-ok",
    "KNB005": "schema-ok",
    "KNB006": "guard-ok",
}

# the config dataclass the knob universe is read from
CONFIG_CLASS = "FFConfig"
# search-key coverage: the knob tuple + the stamp function whose
# string constants (including conditionally-stamped ones) count as
# covered (search/cache.py)
SEARCH_TUPLE = "_SEARCH_KNOBS"
SEARCH_FUNCS = ("config_signature",)
# cohort-key coverage: every module-level ``_*KNOB_FIELDS`` tuple +
# the cohort-context builders (obs/ledger.py)
COHORT_TUPLE_RE = re.compile(r"^_[A-Z_]*KNOB_FIELDS$")
COHORT_FUNCS = ("model_context", "serving_knob_context")
# serializer version constants: module-level ALL-CAPS ints ending in
# SCHEMA or VERSION
VERSION_CONST_RE = re.compile(r"^[A-Z][A-Z0-9_]*(SCHEMA|VERSION)$")

# compile-time root set: everything that decides WHAT gets compiled
# (the search, the lowering, the pipeline resolution). Matched as
# qname prefixes ("rel::Qual" — a bare "dir/" prefix roots a whole
# subtree).
DEFAULT_COMPILE_ROOTS = (
    "runtime/model.py::FFModel.compile",
    "runtime/model.py::FFModel._run_search",
    "runtime/model.py::FFModel._resolve_pipeline",
    "runtime/model.py::FFModel._validate_cached",
    "runtime/compiler.py::",
    "search/",
    "sim/",
)
# perf root set: the measured step/serving loops whose records the
# sentinel cohorts on
DEFAULT_PERF_ROOTS = (
    "runtime/model.py::FFModel.fit",
    "runtime/model.py::FFModel.eval",
    "runtime/dataloader.py::",
    "runtime/buckets.py::",
    "serving/",
)


def _short(qname: str) -> str:
    return qname.split("::", 1)[-1]


def _tuple_strs(value: ast.AST) -> Optional[List[str]]:
    """The string elements of a tuple/list literal, or None."""
    if not isinstance(value, (ast.Tuple, ast.List)):
        return None
    out = []
    for e in value.elts:
        if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
            return None
        out.append(e.value)
    return out


def _config_like(expr: ast.AST, self_ok: bool = False) -> bool:
    """Does ``expr`` look like an FFConfig receiver? Names containing
    ``config``/``cfg`` and attribute chains ending ``.config``/``.cfg``
    (``self.config``, ``ff.config``, ``self._ff.config``, ``pm.cfg``)
    — the only idioms the package uses. ``self`` counts only inside
    the config class itself (``self_ok``)."""
    if isinstance(expr, ast.Name):
        nid = expr.id.lower()
        if self_ok and expr.id == "self":
            return True
        return "config" in nid or nid == "cfg" or nid.endswith("_cfg") \
            or nid.startswith("cfg_")
    if isinstance(expr, ast.Attribute):
        a = expr.attr.lower()
        return a in ("config", "cfg") or "config" in a
    return False


def _knob_reads_in(node: ast.AST, knobs: Set[str],
                   self_ok: bool = False) -> List[Tuple[str, int]]:
    """Every (knob, lineno) read inside ``node``: dotted attribute
    loads off a config-like receiver plus ``getattr(cfg, "knob", ...)``
    with a literal name."""
    out: List[Tuple[str, int]] = []
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load) \
                and n.attr in knobs and _config_like(n.value, self_ok):
            out.append((n.attr, n.lineno))
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == "getattr" and len(n.args) >= 2 \
                and isinstance(n.args[1], ast.Constant) \
                and isinstance(n.args[1].value, str) \
                and n.args[1].value in knobs \
                and _config_like(n.args[0], self_ok):
            out.append((n.args[1].value, n.lineno))
    return out


@dataclasses.dataclass
class KnobRead:
    """One config-knob read site."""

    knob: str
    rel: str
    qname: str       # enclosing function ("" at module level)
    line: int


@dataclasses.dataclass
class _ConfigInfo:
    rel: str
    lines: List[str]
    fields: Dict[str, int]                      # knob -> def lineno
    field_flags: Dict[str, List[str]]           # knob -> CLI flags
    flag_fields: Dict[str, Set[str]]            # flag -> fields set
    unknown_assigns: List[Tuple[str, int]]      # (field, lineno)
    has_parse_args: bool = False


class _KnobFlow:
    """One audit run over a scanned package (+ read-only extras)."""

    def __init__(self, pkg: Package, extras: Sequence[Package],
                 report: ValidationReport,
                 compile_roots: Sequence[str],
                 perf_roots: Sequence[str]):
        self.pkg = pkg
        self.extras = list(extras)
        self.report = report
        self.suppressed = 0
        self.config = self._find_config()
        self.knobs: Set[str] = set(self.config.fields) if self.config \
            else set()
        # read sites inside package functions (reachability-classified)
        self.sites: List[KnobRead] = []
        self.reads_by_func: Dict[str, Set[str]] = {}
        # every knob read ANYWHERE (package + extras, incl. module
        # level) — the deadness denominator
        self.read_anywhere: Set[str] = set()
        if self.config:
            self._collect_reads()
        # coverage: knob -> frozenset of guard knobs ({} = stamped
        # unconditionally)
        self.search_cov: Dict[str, FrozenSet[str]] = {}
        self.cohort_cov: Dict[str, FrozenSet[str]] = {}
        self.cohort_tuple_fields: Set[str] = set()
        self.search_rel: Optional[str] = None
        self.cohort_rel: Optional[str] = None
        self._collect_coverage()
        self.edges = self._build_edges()
        self.compile_from = self._reach(compile_roots)
        self.perf_from = self._reach(perf_roots)

    # ------------------------------------------------------------ emit
    def _lines(self, rel: str) -> List[str]:
        for p in [self.pkg] + self.extras:
            m = p.modules.get(rel)
            if m is not None:
                return m.lines
        return []

    def _emit(self, code: str, rel: str, lineno: int, message: str,
              severity: str = "error") -> None:
        token = PRAGMA_TOKENS[code]
        if pragmas.line_has(self._lines(rel), lineno, PRAGMA_TOOL, token):
            self.suppressed += 1
            return
        self.report.add(code, message, severity=severity, file=rel,
                        line=lineno)

    # ------------------------------------------------------ config side
    def _find_config(self) -> Optional[_ConfigInfo]:
        """The module defining the config dataclass; its AnnAssign
        fields are the knob universe and its ``parse_args`` the CLI
        parity table."""
        for m in self.pkg.modules.values():
            cls = next((n for n in m.tree.body
                        if isinstance(n, ast.ClassDef)
                        and n.name == CONFIG_CLASS), None)
            if cls is None:
                continue
            fields: Dict[str, int] = {}
            for stmt in cls.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    fields[stmt.target.id] = stmt.lineno
            info = _ConfigInfo(rel=m.rel, lines=m.lines, fields=fields,
                               field_flags={k: [] for k in fields},
                               flag_fields={}, unknown_assigns=[])
            pa = m.funcs.get(f"{m.rel}::{CONFIG_CLASS}.parse_args")
            if pa is not None:
                info.has_parse_args = True
                self._collect_flags(info, pa.node)
            return info
        return None

    def _collect_flags(self, info: _ConfigInfo, fn_node: ast.AST) -> None:
        """Walk the parse_args if/elif chain: flag string constants in
        each test, ``cfg.<field> = ...`` stores in each body; and the
        flag tables the port's parse_args keeps (``{"--flag": ("field",
        conv), ...}``: a dict from flag strings to tuples led by the
        field's name)."""
        for node in _own_nodes(fn_node):
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                            and k.value.startswith("-")
                            and isinstance(v, ast.Tuple) and v.elts
                            and isinstance(v.elts[0], ast.Constant)
                            and isinstance(v.elts[0].value, str)):
                        continue
                    field = v.elts[0].value
                    if field in info.fields:
                        info.field_flags[field].append(k.value)
                    else:
                        info.unknown_assigns.append((field, v.lineno))
                    info.flag_fields.setdefault(k.value, set()).add(field)
                continue
            if not isinstance(node, ast.If):
                continue
            flags = [c.value for c in ast.walk(node.test)
                     if isinstance(c, ast.Constant)
                     and isinstance(c.value, str)
                     and c.value.startswith("-")]
            if not flags:
                continue
            fields = []
            for stmt in node.body:
                for n in ast.walk(stmt):
                    if isinstance(n, ast.Attribute) \
                            and isinstance(n.ctx, ast.Store) \
                            and isinstance(n.value, ast.Name) \
                            and _config_like(n.value):
                        fields.append((n.attr, n.lineno))
            for field, lineno in fields:
                if field in info.fields:
                    info.field_flags[field].extend(flags)
                else:
                    info.unknown_assigns.append((field, lineno))
                for fl in flags:
                    info.flag_fields.setdefault(fl, set()).add(field)

    # -------------------------------------------------------- read sites
    def _collect_reads(self) -> None:
        for m in self.pkg.modules.values():
            for f in m.funcs.values():
                self_ok = (m.rel == self.config.rel
                           and f.cls == CONFIG_CLASS)
                hits = self._func_reads(m, f, self_ok)
                if not hits:
                    continue
                self.reads_by_func[f.qname] = {k for k, _ in hits}
                for knob, lineno in hits:
                    self.sites.append(KnobRead(knob, m.rel, f.qname,
                                               lineno))
                    self.read_anywhere.add(knob)
        # extras (tools/examples/scripts) + module-level code: deadness
        # only — whole-tree walks, no reachability
        for p in [self.pkg] + self.extras:
            for m in p.modules.values():
                for knob, _ in _knob_reads_in(m.tree, self.knobs):
                    self.read_anywhere.add(knob)

    def _func_reads(self, m, f, self_ok: bool) -> List[Tuple[str, int]]:
        out: List[Tuple[str, int]] = []
        for node in _own_nodes(f.node):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load) \
                    and node.attr in self.knobs \
                    and _config_like(node.value, self_ok):
                out.append((node.attr, node.lineno))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id == "getattr" \
                    and len(node.args) >= 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str) \
                    and node.args[1].value in self.knobs \
                    and _config_like(node.args[0], self_ok):
                out.append((node.args[1].value, node.lineno))
        return out

    # --------------------------------------------------------- coverage
    def _collect_coverage(self) -> None:
        for m in self.pkg.modules.values():
            for stmt in m.tree.body:
                if not (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)):
                    continue
                name = stmt.targets[0].id
                vals = _tuple_strs(stmt.value)
                if vals is None:
                    continue
                if name == SEARCH_TUPLE:
                    self.search_rel = m.rel
                    for k in vals:
                        self.search_cov[k] = frozenset()
                elif COHORT_TUPLE_RE.match(name):
                    self.cohort_rel = m.rel
                    self.cohort_tuple_fields.update(vals)
                    for k in vals:
                        self.cohort_cov[k] = frozenset()
        if self.search_rel:
            self._cov_from_funcs(self.search_rel, SEARCH_FUNCS,
                                 self.search_cov)
        if self.cohort_rel:
            self._cov_from_funcs(self.cohort_rel, COHORT_FUNCS,
                                 self.cohort_cov)

    def _cov_from_funcs(self, rel: str, fn_names: Sequence[str],
                        cov: Dict[str, FrozenSet[str]]) -> None:
        """Knob-named string constants inside a stamp function count as
        covered; a constant nested under an ``if`` whose test reads a
        mode knob is covered CONDITIONALLY on that knob (the
        conditional-stamp idiom KNB006 polices)."""
        m = self.pkg.modules.get(rel)
        if m is None:
            return
        for fn_name in fn_names:
            f = m.funcs.get(f"{rel}::{fn_name}")
            if f is None:
                continue
            for node in _own_nodes(f.node):
                if not (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and node.value in self.knobs):
                    continue
                guards = self._stamp_guards(f.node, node)
                knob = node.value
                prev = cov.get(knob)
                if prev is None:
                    cov[knob] = guards
                elif prev and guards:
                    cov[knob] = prev & guards
                else:           # any unconditional stamp wins
                    cov[knob] = frozenset()

    def _stamp_guards(self, fn_node: ast.AST,
                      node: ast.AST) -> FrozenSet[str]:
        """Mode knobs guarding a stamp constant: knob reads in the
        tests of enclosing ``if``s (the constant sitting in a test —
        the guard itself — does not count as guarded)."""
        guards: Set[str] = set()
        child, cur = node, getattr(node, "_ccy_parent", None)
        while cur is not None and cur is not fn_node:
            if isinstance(cur, (ast.If, ast.IfExp)) \
                    and child is not cur.test:
                guards.update(k for k, _ in
                              _knob_reads_in(cur.test, self.knobs))
            child, cur = cur, getattr(cur, "_ccy_parent", None)
        return frozenset(guards)

    # ----------------------------------------------------- reachability
    def _build_edges(self) -> Dict[str, Set[str]]:
        """The concurrency scanner's call graph, re-filtered for knob
        flow: dunder attribute calls (``super().__init__()`` resolves
        to EVERY ``__init__`` in the package) would fuse the compile
        and serving/fit paths into one blob, so they are dropped —
        knob reads inside constructors are still collected, and the
        constructor is reached through the ``ClassName(...)`` call
        site, which the scanner resolves precisely."""
        edges: Dict[str, Set[str]] = {}
        for q in self.pkg.funcs:
            out = edges.setdefault(q, set())
            from_calls: Set[str] = set()
            for call, callees in self.pkg.call_sites.get(q, ()):
                from_calls.update(callees)
                fe = call.func
                if isinstance(fe, ast.Attribute) \
                        and fe.attr.startswith("__"):
                    continue
                out.update(callees)
            # property-access edges ride pkg.edges outside call_sites
            out.update(self.pkg.edges.get(q, set()) - from_calls)
        return edges

    def _reach(self, roots: Sequence[str]) -> Dict[str, str]:
        """BFS over the filtered call graph: function qname -> the
        root qname it was first reached from."""
        origin: Dict[str, str] = {}
        frontier: List[str] = []
        for q in self.pkg.funcs:
            if any(q.startswith(r) for r in roots):
                origin[q] = q
                frontier.append(q)
        while frontier:
            nxt: List[str] = []
            for q in frontier:
                for callee in self.edges.get(q, ()):
                    if callee not in origin:
                        origin[callee] = origin[q]
                        nxt.append(callee)
            frontier = nxt
        return origin

    # ------------------------------------------------------------ audits
    def audit_key_coverage(self) -> None:
        """KNB001/KNB002: every reachable knob must be stamped;
        KNB006: conditionally-stamped knobs must be read under the
        same mode guard."""
        compile_sites: Dict[str, KnobRead] = {}
        perf_sites: Dict[str, KnobRead] = {}
        for s in self.sites:
            if s.qname in self.compile_from \
                    and s.knob not in compile_sites:
                # a read whose compile-path origin is the key module
                # itself is key DERIVATION (machine_signature walking
                # num_devices), not a key consumer
                root = self.compile_from[s.qname]
                if self.search_rel is None or \
                        not root.startswith(self.search_rel + "::"):
                    compile_sites[s.knob] = s
            # compile-path reads are the strategy cache's jurisdiction
            # (KNB001); KNB002 tracks knobs that steer runtime behavior
            # OUTSIDE the compile the plan key already captures —
            # without this split every compile knob double-fires
            # because serving's from_onnx reaches compile()
            if s.qname in self.perf_from \
                    and s.qname not in self.compile_from \
                    and s.knob not in perf_sites:
                perf_sites[s.knob] = s
        if self.search_rel is not None:
            for knob, s in sorted(compile_sites.items()):
                if knob not in self.search_cov:
                    self._emit(
                        "KNB001", self.config.rel,
                        self.config.fields[knob],
                        f"compile-determinant knob '{knob}' is read on "
                        f"the compile path ({s.rel}:{s.line}, "
                        f"{self._via(s, self.compile_from)}) but is "
                        f"stamped into neither {SEARCH_TUPLE} nor "
                        f"config_signature — a cached plan selected "
                        f"under one value would silently replay under "
                        f"another")
            self._audit_guards(compile_sites, self.search_cov,
                               "strategy-cache", "error",
                               self.search_rel)
        if self.cohort_rel is not None:
            for knob, s in sorted(perf_sites.items()):
                if knob not in self.cohort_cov:
                    self._emit(
                        "KNB002", self.config.rel,
                        self.config.fields[knob],
                        f"perf-relevant knob '{knob}' is read on the "
                        f"fit/serving path ({s.rel}:{s.line}, "
                        f"{self._via(s, self.perf_from)}) but is "
                        f"absent from the ledger cohort context "
                        f"(_KNOB_FIELDS/{'/'.join(COHORT_FUNCS)}) — "
                        f"perf_sentinel would compare runs across "
                        f"different settings", severity="warning")
            self._audit_guards(perf_sites, self.cohort_cov, "cohort",
                               "warning", self.cohort_rel)

    def _audit_guards(self, reach_sites: Dict[str, KnobRead],
                      cov: Dict[str, FrozenSet[str]], which: str,
                      severity: str, stamp_rel: str) -> None:
        """KNB006 over every reachable read of a conditionally-stamped
        knob: the reading function must also consult the mode knob the
        stamp is guarded on (else the knob can steer the artifact in a
        mode where the key omits it)."""
        reach = self.compile_from if which == "strategy-cache" \
            else self.perf_from
        flagged: Set[Tuple[str, str, int]] = set()
        for s in self.sites:
            guards = cov.get(s.knob)
            if not guards or s.knob in guards:
                continue            # unconditional, uncovered, or the
            if s.qname not in reach:            # mode knob itself
                continue
            if s.rel in (stamp_rel, self.config.rel):
                continue            # the stamp module self-covers
            fn_reads = self.reads_by_func.get(s.qname, set())
            if fn_reads & guards:
                continue
            key = (s.rel, s.knob, s.line)
            if key in flagged:
                continue
            flagged.add(key)
            g = "/".join(sorted(guards))
            self._emit(
                "KNB006", s.rel, s.line,
                f"knob '{s.knob}' is stamped into the {which} key only "
                f"under a '{g}' guard, but this read "
                f"({_short(s.qname)}) is not gated on {g} — the knob "
                f"can influence the run while the key omits it",
                severity=severity)

    def _via(self, s: KnobRead, origin: Dict[str, str]) -> str:
        root = origin.get(s.qname)
        if root is None or root == s.qname:
            return f"in {_short(s.qname)}"
        return f"in {_short(s.qname)}, reachable from {_short(root)}"

    def audit_dead(self) -> None:
        """KNB003: a field nothing reads. Stamp-tuple membership does
        NOT count — a knob that is keyed but never consulted is
        vestigial either way."""
        for knob, lineno in sorted(self.config.fields.items()):
            if knob not in self.read_anywhere:
                self._emit(
                    "KNB003", self.config.rel, lineno,
                    f"dead knob: '{knob}' is defined in "
                    f"{self.config.rel} but never read anywhere in the "
                    f"scanned source", severity="warning")

    def audit_flags(self) -> None:
        """KNB004: CLI-flag <-> config-field parity."""
        info = self.config
        if not info.has_parse_args:
            return
        for field, lineno in info.unknown_assigns:
            self._emit(
                "KNB004", info.rel, lineno,
                f"parse_args sets unknown config field '{field}' — the "
                f"assignment silently creates a new attribute instead "
                f"of failing on the typo")
        for fl, fields in sorted(info.flag_fields.items()):
            if len(fields) > 1:
                first = min(info.fields.get(f, 0) for f in fields)
                self._emit(
                    "KNB004", info.rel, first or 1,
                    f"CLI flag '{fl}' is claimed by multiple branches "
                    f"setting different fields: {sorted(fields)}")
        for knob, lineno in sorted(info.fields.items()):
            if not info.field_flags.get(knob):
                self._emit(
                    "KNB004", info.rel, lineno,
                    f"config field '{knob}' has no CLI flag in "
                    f"parse_args — flag/field parity drift (the "
                    f"reference exposes every knob on the command "
                    f"line)", severity="warning")

    def audit_schema_constants(self) -> None:
        """KNB005: every ``*_SCHEMA``/``*_VERSION`` constant written
        into a record must be COMPARED somewhere — presence-only
        checks consume foreign layouts silently."""
        consts: Dict[str, Tuple[str, int]] = {}
        for m in self.pkg.modules.values():
            for stmt in m.tree.body:
                if isinstance(stmt, ast.Assign) \
                        and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and VERSION_CONST_RE.match(stmt.targets[0].id) \
                        and isinstance(stmt.value, ast.Constant) \
                        and isinstance(stmt.value.value, int):
                    consts[stmt.targets[0].id] = (m.rel, stmt.lineno)
        if not consts:
            return
        writers: Dict[str, Tuple[str, int]] = {}
        compared: Set[str] = set()
        for p in [self.pkg] + self.extras:
            for m in p.modules.values():
                for node in ast.walk(m.tree):
                    if isinstance(node, ast.Compare):
                        for n in ast.walk(node):
                            if isinstance(n, ast.Name) \
                                    and n.id in consts:
                                compared.add(n.id)
                    elif isinstance(node, ast.Dict):
                        for v in node.values:
                            if isinstance(v, ast.Name) \
                                    and v.id in consts \
                                    and v.id not in writers:
                                writers[v.id] = (m.rel, v.lineno)
                    elif isinstance(node, ast.Assign) \
                            and isinstance(node.value, ast.Name) \
                            and node.value.id in consts \
                            and any(isinstance(t, ast.Subscript)
                                    for t in node.targets) \
                            and node.value.id not in writers:
                        writers[node.value.id] = (m.rel, node.lineno)
        for name, (rel, lineno) in sorted(writers.items()):
            if name in compared:
                continue
            self._emit(
                "KNB005", rel, lineno,
                f"serializer version constant {name} is written into "
                f"records here but no reader anywhere compares against "
                f"it — a layout change would be consumed silently "
                f"instead of demoting to a counted skip")

    # ------------------------------------------------------------ tables
    def knob_table(self) -> Dict[str, Dict]:
        """Per-knob coverage row (the JSON line's ``knobs`` table)."""
        compile_k = {s.knob for s in self.sites
                     if s.qname in self.compile_from}
        perf_k = {s.knob for s in self.sites
                  if s.qname in self.perf_from}
        out = {}
        for knob, lineno in sorted(self.config.fields.items()) \
                if self.config else []:
            out[knob] = {
                "line": lineno,
                "flags": sorted(set(
                    self.config.field_flags.get(knob, []))),
                "read": knob in self.read_anywhere,
                "compile_reachable": knob in compile_k,
                "perf_reachable": knob in perf_k,
                "search_covered": knob in self.search_cov,
                "cohort_covered": knob in self.cohort_cov,
            }
        return out


def cohort_cover_hash(fields: Sequence[str]) -> str:
    """8-hex digest over sorted cohort knob-field names — the coverage
    version :func:`..obs.ledger.knob_coverage_version` stamps on every
    record (and :func:`..obs.ledger.cohort_key` keys on), so widening
    ``_KNOB_FIELDS`` splits cohorts cleanly instead of comparing
    old-key records against new-key ones. Defined here AND derived
    live in the ledger; the tests pin both derivations equal."""
    return hashlib.sha256(
        ",".join(sorted(set(fields))).encode()).hexdigest()[:8]


# =====================================================================
# public API
# =====================================================================
def _run(pkg: Package, extras: Sequence[Package],
         report: ValidationReport, compile_roots: Sequence[str],
         perf_roots: Sequence[str]) -> _KnobFlow:
    kf = _KnobFlow(pkg, extras, report, compile_roots, perf_roots)
    if kf.config is not None:
        kf.audit_key_coverage()
        kf.audit_dead()
        kf.audit_flags()
    kf.audit_schema_constants()
    report.findings.sort(key=lambda f: (f.file or "", f.line or 0,
                                        f.code))
    report.suppressed = kf.suppressed  # type: ignore[attr-defined]
    report.knobs = kf.knob_table()  # type: ignore[attr-defined]
    report.coverage = {  # type: ignore[attr-defined]
        "search": sorted(kf.search_cov),
        "cohort": sorted(kf.cohort_cov),
        "conditional": {k: sorted(g) for k, g in
                        sorted({**kf.search_cov,
                                **kf.cohort_cov}.items()) if g},
        "cohort_cover_hash": cohort_cover_hash(
            sorted(kf.cohort_tuple_fields)),
    }
    return kf


@dataclasses.dataclass
class _LightPkg:
    """AST-only stand-in for :class:`Package` over the extra read
    paths: the dead-knob and KNB005 scans only walk ``modules``, so
    the call-graph/role machinery a full Package build pays for
    (~3x the scan cost over tools/) is skipped."""

    modules: Dict[str, object]


def _scan_light(path: str) -> _LightPkg:
    files: List[Tuple[str, str]] = []
    if os.path.isfile(path):
        files.append((os.path.basename(path), os.path.abspath(path)))
    else:
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            files.extend(
                (os.path.relpath(os.path.join(dirpath, fn),
                                 path).replace(os.sep, "/"),
                 os.path.join(dirpath, fn))
                for fn in sorted(filenames) if fn.endswith(".py"))
    modules: Dict[str, object] = {}
    for rel, ap in files:
        try:
            with open(ap, errors="replace") as f:
                src = f.read()
        except OSError:
            continue
        m = _scan_module(rel, ap, src)
        if m is not None:
            modules[rel] = m
    return _LightPkg(modules)


def default_extra_paths(pkg_path: str) -> List[str]:
    """The files beside the package that read the port's knobs: the
    ``tools/torch_*.py`` scripts and ``chip_smoke.py`` (the JAX
    package's tools read a config of the same field names, so they are
    not counted)."""
    root = os.path.dirname(os.path.abspath(pkg_path))
    tools = os.path.join(root, "tools")
    out = [os.path.join(root, "chip_smoke.py")]
    if os.path.isdir(tools):
        out += [os.path.join(tools, f) for f in sorted(os.listdir(tools))
                if f.startswith("torch_") and f.endswith(".py")]
    return out


def check_package(paths: Sequence[str],
                  extra_read_paths: Sequence[str] = (),
                  compile_roots: Optional[Sequence[str]] = None,
                  perf_roots: Optional[Sequence[str]] = None
                  ) -> ValidationReport:
    """Run every knob-flow check over a package. ``extra_read_paths``
    (tools/examples/scripts) contribute read sites to the dead-knob
    scan and comparisons to the KNB005 scan, but no reachability
    roots. The main entry the gate, the tool, and the tests share."""
    pkg = build_package(paths)
    extras = [_scan_light(p) for p in extra_read_paths
              if os.path.isdir(p) or os.path.isfile(p)]
    report = ValidationReport(source=",".join(paths), tag="knobflow")
    for rel, _ in getattr(pkg, "broken", ()):
        report.add("KNB000", f"unparseable module (syntax error): {rel}",
                   severity="error", file=rel, line=0)
    _run(pkg, extras, report,
         compile_roots or DEFAULT_COMPILE_ROOTS,
         perf_roots or DEFAULT_PERF_ROOTS)
    return report


def check_sources(files: Dict[str, str],
                  compile_roots: Sequence[str] = (),
                  perf_roots: Sequence[str] = ()) -> List[Finding]:
    """Multi-module in-memory convenience for the seeded-fixture
    tests: ``files`` maps relative names to source text."""
    modules = []
    report = ValidationReport(source="<memory>", tag="knobflow")
    for rel, src in files.items():
        m = _scan_module(rel, "", src)
        if m is None:
            report.add("KNB000", "unparseable module (syntax error): "
                       f"{rel}", severity="error", file=rel, line=0)
            continue
        modules.append(m)
    _run(Package(modules), [], report, compile_roots, perf_roots)
    return report.findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        argv = [os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))]
    extras = default_extra_paths(argv[0])
    report = check_package(argv, extra_read_paths=extras)
    for f in report.findings:
        print(f.format())
    cov = getattr(report, "coverage", {})
    print(f"knobflow audit: {len(report.errors)} error(s), "
          f"{len(report.warnings)} warning(s), "
          f"{getattr(report, 'suppressed', 0)} suppressed, "
          f"{len(getattr(report, 'knobs', {}))} knob(s), "
          f"{len(cov.get('search', ()))} search-keyed, "
          f"{len(cov.get('cohort', ()))} cohort-keyed "
          f"over {', '.join(argv)}")
    return 1 if report.errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
