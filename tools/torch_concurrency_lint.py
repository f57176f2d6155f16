#!/usr/bin/env python
"""Concurrency-audit report over the package source: one JSON line.

Runs the whole-package concurrency auditor
(``flexflow_tpu_torch/analysis/concurrency_check.py`` — thread-role inference,
shared-state escape analysis, lock-graph/Condition/leak checks) plus the
shared-pragma hygiene scan (``analysis/pragmas.lint_reasonless``: every
in-repo suppression must carry a reason) and prints ONE machine-readable
JSON line:

    {"modules": {"<rel>": {"errors": N, "warnings": N,
                           "findings": [...]}, ...},
     "roles": {"<role>": {"functions": N, "roots": [...]}, ...},
     "n_roles": N, "n_functions": N,
     "suppressed": N,              # reasoned pragmas that fired
     "reasonless": [{"file", "line", "pragma"}, ...],  # decorative
     "errors": N, "warnings": N,
     "runtime_s": ...,
     "codes": {"CCY001": "...", ...},
     "exit": 0|1}

Exit status 1 when any error-severity CCY finding fired OR any
suppression pragma is missing its reason (a decorative pragma is a
silent hole in the gate) — the port's
concurrency gate. Warnings don't fail the gate.

Usage:
    python tools/torch_concurrency_lint.py                  # flexflow_tpu_torch
    python tools/torch_concurrency_lint.py pkg_dir ...      # explicit paths
    python tools/torch_concurrency_lint.py --out ccy.json   # also write file
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the gate's pragma families; other "# word: token" comments (e.g. plain
# "# note: ..." prose) are not suppressions and must not fail the gate
PRAGMA_TOOLS = ("hotpath", "audit", "concurrency")


def _reasonless(paths):
    from flexflow_tpu_torch.analysis import pragmas

    out = []
    for p in paths:
        files = []
        if os.path.isfile(p):
            files = [p]
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                files.extend(os.path.join(dirpath, fn)
                             for fn in sorted(filenames)
                             if fn.endswith(".py"))
        for path in files:
            try:
                with open(path, errors="replace") as f:
                    src = f.read()
            except OSError:
                continue
            for lineno, pragma in pragmas.lint_reasonless(src):
                if pragma.tool not in PRAGMA_TOOLS:
                    continue
                out.append({"file": os.path.relpath(path),
                            "line": lineno,
                            "pragma": f"{pragma.tool}: {pragma.token}"})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="package dirs/files to audit (default: the "
                         "flexflow_tpu_torch package next to this script)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = args.paths or [os.path.join(root, "flexflow_tpu_torch")]

    from flexflow_tpu_torch.analysis.concurrency_check import check_package
    from flexflow_tpu_torch.analysis.findings import CODE_CATALOG

    t0 = time.perf_counter()
    report = check_package(paths)
    reasonless = _reasonless(paths)
    runtime_s = time.perf_counter() - t0

    modules = {}
    for f in report.findings:
        rel = f.file or "<unknown>"
        doc = modules.setdefault(rel, {"errors": 0, "warnings": 0,
                                       "findings": []})
        doc["errors" if f.severity == "error" else "warnings"] += 1
        doc["findings"].append(f.to_dict())

    roles = getattr(report, "roles", {})
    pkg = getattr(report, "package", None)
    doc = {
        "modules": modules,
        "roles": roles,
        "n_roles": len(roles),
        "n_functions": len(pkg.funcs) if pkg is not None else 0,
        "suppressed": getattr(report, "suppressed", 0),
        "reasonless": reasonless,
        "errors": len(report.errors),
        "warnings": len(report.warnings),
        "runtime_s": round(runtime_s, 4),
        "codes": {k: v for k, v in CODE_CATALOG.items()
                  if k.startswith("CCY")},
        "exit": 1 if (report.errors or reasonless) else 0,
    }
    line = json.dumps(doc, sort_keys=True)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return doc["exit"]


if __name__ == "__main__":
    raise SystemExit(main())
