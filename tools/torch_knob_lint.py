#!/usr/bin/env python
"""Knob-flow audit report over the package source: one JSON line.

Runs the config-knob key-coverage auditor
(``flexflow_tpu_torch/analysis/knobflow_check.py`` — compile/perf
reachability of every ``FFConfig`` knob read, strategy-cache and
ledger-cohort key coverage, dead knobs, CLI-flag parity, serializer
schema validation) plus the shared-pragma hygiene scan
(``analysis/pragmas.lint_reasonless`` over the ``knobflow`` family) and
prints ONE machine-readable JSON line:

    {"modules": {"<rel>": {"errors": N, "warnings": N,
                           "findings": [...]}, ...},
     "knobs": N,                   # FFConfig fields audited
     "coverage": {"search": [...],          # config_signature keys
                  "cohort": [...],          # ledger cohort keys
                  "conditional": {...},     # knob -> its mode guards
                  "cohort_cover_hash": "..."},  # = knob_coverage_version()
     "suppressed": N,              # reasoned pragmas that fired
     "reasonless": [{"file", "line", "pragma"}, ...],  # decorative
     "errors": N, "warnings": N,
     "runtime_s": ...,
     "codes": {"KNB001": "...", ...},
     "exit": 0|1}

Exit status 1 when any error-severity KNB finding fired OR any
``knobflow`` suppression pragma is missing its reason (a decorative
pragma is a silent hole in the gate) — the port's knob-flow
gate. Warnings don't fail the gate.

Usage:
    python tools/torch_knob_lint.py                  # flexflow_tpu_torch
    python tools/torch_knob_lint.py pkg_dir ...      # explicit paths
    python tools/torch_knob_lint.py --out knb.json   # also write file
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# only the knob-flow family: the other pragma tools are owned by their
# own gates (concurrency_lint covers hotpath/audit/concurrency)
PRAGMA_TOOLS = ("knobflow",)


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
    from flexflow_tpu_torch.analysis.findings import CODE_CATALOG
    from flexflow_tpu_torch.analysis.knobflow_check import (check_package,
                                                            default_extra_paths)

    # the port's tools and chip_smoke.py contribute dead-knob reads and
    # KNB005 comparisons (a knob consumed only by a tool is not dead)
    extras = default_extra_paths(paths[0])

    t0 = time.perf_counter()
    report = check_package(paths, extra_read_paths=extras)
    # the pragma hygiene sweep covers the extras too: a decorative
    # knobflow pragma in a tool must fail the same gate
    reasonless = _reasonless(list(paths) + [p for p in extras if os.path.exists(p)])
    runtime_s = time.perf_counter() - t0

    modules = {}
    for f in report.findings:
        rel = f.file or "<unknown>"
        doc = modules.setdefault(rel, {"errors": 0, "warnings": 0,
                                       "findings": []})
        doc["errors" if f.severity == "error" else "warnings"] += 1
        doc["findings"].append(f.to_dict())

    cov = dict(getattr(report, "coverage", {}))
    doc = {
        "modules": modules,
        "knobs": len(getattr(report, "knobs", {})),
        "coverage": {
            "search": sorted(cov.get("search", ())),
            "cohort": sorted(cov.get("cohort", ())),
            "conditional": {k: sorted(v) for k, v in
                            (cov.get("conditional") or {}).items()},
            "cohort_cover_hash": cov.get("cohort_cover_hash"),
        },
        "suppressed": getattr(report, "suppressed", 0),
        "reasonless": reasonless,
        "errors": len(report.errors),
        "warnings": len(report.warnings),
        "runtime_s": round(runtime_s, 4),
        "codes": {k: v for k, v in CODE_CATALOG.items()
                  if k.startswith("KNB")},
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
