#!/usr/bin/env python
"""Static-analysis report over the port's model zoo: one JSON line.

Runs the port's PCG validator (flexflow_tpu_torch/analysis/pcg_check.py)
and strategy linter (analysis/strategy_lint.py) over bundled models — and optionally the
hot-path lint (analysis/hotpath_lint.py) over the package source — and
prints ONE machine-readable JSON line:

    {"reports": {"<model>": {"source", "errors", "warnings",
                             "findings": [{"code", "severity", "layer",
                                           "op_type", "origin",
                                           "message", ...}]},
                 ...,
                 "hotpath"?: {...}},
     "codes": {"PCG001": "...", ...},        # the full code catalog
     "mesh": {"data": 2, "model": 4},     # or "meshes" per model
     "searched": false,
     "exit": 0}

Exit status 1 when any error-severity finding fired (warnings don't
fail the gate). Nothing runs a step: the builders place no weights, so
``--device cpu`` needs no card (the default ``cuda`` raises without one).

Usage:
    python tools/torch_pcg_lint.py                         # all zoo models
    python tools/torch_pcg_lint.py --model mlp,dlrm        # subset
    python tools/torch_pcg_lint.py --mesh data=2,model=4   # lint on a TP mesh
    python tools/torch_pcg_lint.py --search                # searched strategy
    python tools/torch_pcg_lint.py --hotpath               # + source lint
    python tools/torch_pcg_lint.py --out lint.json         # also write file
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parse_mesh(spec):
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        a, _, s = part.partition("=")
        out[a.strip()] = int(s)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="all",
                    help="comma-separated zoo model names, or 'all'")
    ap.add_argument("--mesh", default=None,
                    help="mesh axes, e.g. data=2,model=4 (default: 1-D "
                         "data mesh over the visible cards, 1 on the CPU)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--search", action="store_true",
                    help="validate the SEARCHED strategy (runs the Unity "
                         "search per model) instead of the default plan")
    ap.add_argument("--hotpath", action="store_true",
                    help="also run the hot-path source lint over the "
                         "package")
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    import torch

    from flexflow_tpu_torch.analysis import (ValidationReport, lint_hotpaths,
                                             lint_strategy, report_to_json_line,
                                             validate_pcg)
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.models import zoo_smoke_builders
    from flexflow_tpu_torch.runtime.model import FFModel

    zoo = zoo_smoke_builders()
    names = list(zoo) if args.model == "all" else \
        [m.strip() for m in args.model.split(",")]
    unknown = [m for m in names if m not in zoo]
    if unknown:
        raise SystemExit(f"unknown model(s) {unknown}; have {list(zoo)}")
    n_cards = torch.cuda.device_count() if args.device.startswith("cuda") else 1
    mesh_axes = _parse_mesh(args.mesh) or {"data": max(1, n_cards)}

    reports = {}
    meshes = {}
    for name in names:
        ff = FFModel(FFConfig(batch_size=args.batch_size, device=args.device))
        zoo[name](ff, args.batch_size)
        protected = frozenset({ff._final_output().tensor_id})
        layers, strategies, axes = ff.layers, {}, mesh_axes
        if args.search:
            from flexflow_tpu_torch.search.unity import full_search
            from flexflow_tpu_torch.sim import detect_machine_model

            res = full_search(
                layers, ff._used_inputs(), detect_machine_model(),
                ff.config, beam_width=8, max_pipe=1, protected=protected)
            layers = res.layers or layers
            strategies, axes = res.strategies, res.mesh_shape
        meshes[name] = dict(axes)
        report = validate_pcg(layers, ff._used_inputs(), strategies, axes,
                              protected=protected, config=ff.config,
                              source=name)
        lint = lint_strategy(layers, ff._used_inputs(), strategies, axes,
                             config=ff.config,
                             records=getattr(report, "records", None))
        report.findings.extend(lint.findings)
        reports[name] = report

    if args.hotpath:
        pkg = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "flexflow_tpu_torch")
        hp = ValidationReport(source="hotpath")
        hp.findings.extend(lint_hotpaths([pkg]))
        reports["hotpath"] = hp

    n_errors = sum(len(r.errors) for r in reports.values())
    # per-model meshes: with --search each model validates on the mesh
    # the search CHOSE, not the --mesh argument — report what ran
    line = report_to_json_line(reports, extra={
        "mesh": None if args.search else mesh_axes,
        "meshes": meshes,
        "searched": bool(args.search),
        "exit": 1 if n_errors else 0,
    })
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 1 if n_errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
