"""Hot-path race/sync lint: AST checks over the port's own source.

PyTorch counterpart of ``flexflow_tpu/analysis/hotpath_lint.py``. The
step loop dispatches asynchronously (a bounded in-flight window, metrics
folded on the device, a Prefetcher worker thread), which leaves three
source-level hazard classes no runtime test reliably catches:

* **HOT001 — host sync in the step loop.** ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``float()``/``int()``/``bool()`` of a value,
  ``np.asarray``/``np.array``, ``torch.cuda.synchronize`` or an event's
  ``.synchronize()`` inside the loop that dispatches
  ``train_step``/``eval_step``/``train_k_steps`` waits for the card
  every iteration and reverts the loop to synchronous throughput. The
  *step loop* is found structurally: the innermost ``for``/``while``
  whose body calls one of the step functions.
* **HOT002 — device work on an input-pipeline worker thread.** A call
  into the ``torch`` namespace, ``.cuda()`` or ``.to(...)`` from a
  *worker-only* function allocates or launches on the card from a
  thread the dispatch stream does not order (placement stays on the
  dispatch thread).
* **HOT003 — unsynchronized shared-state mutation in a worker thread.**
  Attribute/subscript stores or augmented assignments in a *worker-only*
  function outside any ``with`` (lock) block and not on a queue.

*Worker-only* is decided by the concurrency auditor's thread-role model
(:func:`.concurrency_check.module_worker_functions`): the call graph is
rooted at every ``threading.Thread(target=...)`` spawn site, and a
function belongs to the worker scope only when it is reachable from a
spawn root and not from the module's public (main-role) surface.

Intentional syncs carry a pragma on the same line, in the shared grammar
of :mod:`.pragmas`: ``# hotpath: sync-ok (<reason>)`` for HOT001/002 and
``# hotpath: lock-ok (<reason>)`` for HOT003. A pragma without a reason
does not suppress.

Run as a module::

    python -m flexflow_tpu_torch.analysis.hotpath_lint flexflow_tpu_torch

Exit status 1 when any finding fires.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Dict, List, Optional, Sequence, Set

from . import pragmas
from .concurrency_check import module_worker_functions
from .findings import Finding

# the pipeline tail program (`self._bwd_last(...)`) marks the schedule
# tick loop as a step-dispatch loop, so HOT001 covers it like fit/eval
STEP_CALLS = {"train_step", "eval_step", "train_k_steps", "_bwd_last"}
# host syncs of a torch value: the attribute calls, the builtin
# conversions and the card-wide waits
SYNC_ATTR_CALLS = {"item", "tolist", "cpu", "numpy", "synchronize"}
SYNC_NAME_CALLS = {"float", "int", "bool"}
SYNC_NP_CALLS = {"asarray", "array"}
# suppression tokens under the shared '# hotpath: <token> (reason)'
# grammar (analysis/pragmas.py)
PRAGMA_TOOL = "hotpath"
SYNC_PRAGMA = "hotpath: sync-ok"
LOCK_PRAGMA = "hotpath: lock-ok"


def _module_aliases(tree: ast.Module) -> Dict[str, Set[str]]:
    """Names bound to the numpy and torch modules in this file."""
    np_alias, torch_alias = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    np_alias.add(a.asname or "numpy")
                if a.name == "torch" or a.name.startswith("torch."):
                    torch_alias.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.split(".")[0] == "torch":
                # `from torch import nn as tnn`: bound submodules and
                # functions do device work; CamelCase names are classes
                # (dtypes, Size, Generator types), not device calls
                for a in node.names:
                    bound = a.asname or a.name
                    if bound[:1].islower():
                        torch_alias.add(bound)
    return {"np": np_alias, "torch": torch_alias}


# host-side torch calls a worker may make: they neither allocate nor
# launch on the card
_TORCH_HOST_CALLS = {"device", "is_available", "device_count", "get_device_name",
                     "is_tensor", "dtype", "finfo", "iinfo", "Size", "get_num_threads",
                     "set_num_threads", "is_grad_enabled", "no_grad", "inference_mode"}


def _device_call(call: ast.Call, aliases: Dict[str, Set[str]]) -> bool:
    """A call that may allocate or launch on the card: into the torch
    namespace (bar the host-side queries), ``.cuda()`` or ``.to(...)``."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in ("cuda", "to", "pin_memory"):
        return not _rooted_at(f, aliases["np"])
    if _rooted_at(f, aliases["torch"]):
        name = f.attr if isinstance(f, ast.Attribute) else f.id
        return name not in _TORCH_HOST_CALLS
    return False


def _attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._hp_parent = node  # type: ignore[attr-defined]


def _innermost_loop(node: ast.AST) -> Optional[ast.AST]:
    cur = getattr(node, "_hp_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
            return cur
        cur = getattr(cur, "_hp_parent", None)
    return None


def _inside_with(node: ast.AST, stop: ast.AST) -> bool:
    cur = getattr(node, "_hp_parent", None)
    while cur is not None and cur is not stop:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            return True
        cur = getattr(cur, "_hp_parent", None)
    return False


def _has_pragma(lines: Sequence[str], node: ast.AST, pragma: str) -> bool:
    """``pragma`` is the legacy "tool: token" string; parsing/validation
    (reason required) is the shared grammar in :mod:`.pragmas`."""
    tool, _, token = pragma.partition(": ")
    return pragmas.line_has(lines, getattr(node, "lineno", 0), tool, token)


def _rooted_at(expr: ast.AST, aliases: Set[str]) -> bool:
    """True when an attribute/name chain is rooted at one of ``aliases``
    (``jax.block_until_ready``, ``np.asarray``, bare ``jnp``...)."""
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return isinstance(expr, ast.Name) and expr.id in aliases


def _is_constant_arg(call: ast.Call) -> bool:
    return bool(call.args) and isinstance(call.args[0], ast.Constant)


def _sync_call_finding(call: ast.Call, aliases: Dict[str, Set[str]]
                       ) -> Optional[str]:
    """Classify one Call as a host sync, returning its description."""
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr in SYNC_ATTR_CALLS:
            return f".{f.attr}()"
        if f.attr in SYNC_NP_CALLS and _rooted_at(f, aliases["np"]):
            return f"np.{f.attr}()"
    elif isinstance(f, ast.Name):
        if f.id in SYNC_NAME_CALLS and call.args \
                and not _is_constant_arg(call) \
                and not _is_host_value(call.args[0]):
            return f"{f.id}()"
    return None


def _is_host_value(arg: ast.AST) -> bool:
    """Arguments that are host values by construction: ``len(...)``,
    arithmetic on constants and host-only builtins."""
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name):
        return arg.func.id in ("len", "round", "min", "max", "sum", "abs", "str")
    return False


def _step_loops(tree: ast.AST) -> List[ast.AST]:
    """The innermost loop enclosing each step-executable call."""
    loops: List[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in STEP_CALLS:
            loop = _innermost_loop(node)
            if loop is not None and loop not in loops:
                loops.append(loop)
    return loops


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    """Lint one module's source. HOT002/003 apply to every function the
    thread-role model classifies as worker-only — no directory scoping."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        findings.append(Finding(
            code="HOT000", severity="error", file=filename,
            line=e.lineno or 0, message=f"syntax error: {e.msg}"))
        return findings
    _attach_parents(tree)
    lines = src.splitlines()
    aliases = _module_aliases(tree)

    # --- HOT001: host syncs inside step loops ------------------------
    for loop in _step_loops(tree):
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call):
                continue
            desc = _sync_call_finding(node, aliases)
            if desc and not _has_pragma(lines, node, SYNC_PRAGMA):
                findings.append(Finding(
                    code="HOT001", severity="error", file=filename,
                    line=node.lineno,
                    message=f"host sync {desc} inside the step loop "
                            f"stalls dispatch every iteration "
                            f"(annotate '# {SYNC_PRAGMA} (reason)' if "
                            f"intentional)"))

    # --- HOT002/HOT003: worker-thread discipline ---------------------
    # Worker scope comes from the concurrency auditor's role model; its
    # nodes are a SEPARATE parse of the same source (line numbers match),
    # so parents are attached per returned function. A nested def that is
    # itself worker-only appears both as its own entry and inside its
    # parent's walk — `seen` dedupes by (code, line).
    if "Thread" not in src:
        return findings  # no spawn sites -> no worker roles, by construction
    seen: Set[tuple] = set()
    for fn, roles in module_worker_functions(src, filename):
        _attach_parents(fn)
        label = getattr(fn, "name", "<lambda>")
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if _device_call(node, aliases) \
                        and ("HOT002", node.lineno) not in seen \
                        and not _has_pragma(lines, node, SYNC_PRAGMA):
                    seen.add(("HOT002", node.lineno))
                    findings.append(Finding(
                        code="HOT002", severity="error", file=filename,
                        line=node.lineno,
                        message=f"torch/device call in thread worker "
                                f"'{label}' (roles: {roles}) allocates or "
                                f"launches on the card off the dispatch "
                                f"thread — keep placement there"))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                shared = [t for t in targets
                          if isinstance(t, (ast.Attribute, ast.Subscript))]
                if shared and not _inside_with(node, fn) \
                        and ("HOT003", node.lineno) not in seen \
                        and not _has_pragma(lines, node, LOCK_PRAGMA):
                    seen.add(("HOT003", node.lineno))
                    findings.append(Finding(
                        code="HOT003", severity="error", file=filename,
                        line=node.lineno,
                        message=f"shared-state store in thread worker "
                                f"'{label}' outside any lock — use a "
                                f"queue or hold a lock (annotate "
                                f"'# {LOCK_PRAGMA} (reason)' if safe)"))
    return findings


def lint_file(path: str) -> List[Finding]:
    with open(path) as f:
        src = f.read()
    return lint_source(src, filename=path)


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    """Lint every .py file under ``paths`` (files or directories)."""
    findings: List[Finding] = []
    for p in paths:
        if os.path.isfile(p):
            findings.extend(lint_file(p))
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    findings.extend(lint_file(os.path.join(dirpath, fn)))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        # default: the package this module lives in
        argv = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    findings = lint_paths(argv)
    for f in findings:
        print(f.format())
    print(f"hotpath lint: {len(findings)} finding(s) over "
          f"{', '.join(argv)}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
