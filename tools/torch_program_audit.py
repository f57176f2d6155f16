#!/usr/bin/env python
"""Program-audit report over the port's model zoo: one JSON line.

Compiles every zoo model (``flexflow_tpu_torch.models.zoo_smoke_builders()``)
with the program-audit gate armed (``flexflow_tpu_torch/analysis/
program_audit.py``: one recorded call of each step program) and prints
ONE machine-readable JSON line:

    {"models": {"<model>": {"errors": N, "warnings": N,
                            "findings": [...],
                            "programs": {"train_step": {"ops", "args",
                                         "donated_args", "consts_bytes",
                                         "static_peak_bytes", "record_s",
                                         "walk_s", "host_syncs",
                                         "kernels", ...}, ...},
                            "compile_s": ..., "audit_s": ...,
                            "audit_walk_s": ..., "audit_record_s": ...,
                            "audit_frac": ...},
                ...},
     "donated_reuse": {"errors": N, "findings": [...]},  # caller-side
     "audit_frac_max": ...,       # worst walk/compile ratio
     "codes": {"AUD001": "...", ...},
     "exit": 0|1}

Exit status 1 when any error-severity finding fired (warnings don't
fail the gate). ``audit_frac`` is the walk over the recorded stream
against the compile's wall time; the recorded call itself is a real
step (``record_s``).

Usage:
    python tools/torch_program_audit.py                    # all zoo models
    python tools/torch_program_audit.py --model mlp,gpt    # subset
    python tools/torch_program_audit.py --device cpu       # no card
    python tools/torch_program_audit.py --out audit.json   # also write file
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="all",
                    help="comma-separated zoo model names, or 'all'")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from flexflow_tpu_torch.analysis.findings import CODE_CATALOG
    from flexflow_tpu_torch.analysis.program_audit import lint_donated_reuse_paths
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.ffconst import LossType
    from flexflow_tpu_torch.models import zoo_smoke_builders
    from flexflow_tpu_torch.runtime.model import FFModel
    from flexflow_tpu_torch.runtime.optimizer import SGDOptimizer

    zoo = zoo_smoke_builders()
    names = list(zoo) if args.model == "all" else \
        [m.strip() for m in args.model.split(",")]
    unknown = [m for m in names if m not in zoo]
    if unknown:
        raise SystemExit(f"unknown model(s) {unknown}; have {list(zoo)}")

    models = {}
    n_errors = 0
    frac_max = 0.0
    for name in names:
        bs = args.batch_size
        # gate mode "warn": findings are collected and REPORTED here (the
        # tool owns the exit code); "error" would abort the sweep at the
        # first bad model
        ff = FFModel(FFConfig(batch_size=bs, audit_programs="warn", device=args.device))
        zoo[name](ff, bs)
        t0 = time.perf_counter()
        # MSE pairs every logits shape with a dense label of its shape;
        # warn-mode handle() prints each finding — route those to stderr
        # so stdout stays the advertised ONE parseable JSON line
        with contextlib.redirect_stdout(sys.stderr):
            ff.compile(optimizer=SGDOptimizer(lr=0.01),
                       loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                       metrics=[])
        compile_s = time.perf_counter() - t0
        report = ff.audit_report
        prof = ff.audit_profile or {}
        audit_s = prof.get("wall_time_s", 0.0)
        # the gate's own cost beyond the recorded steps is the walk over
        # their op streams
        walk_s = prof.get("walk_s", audit_s)
        frac = walk_s / compile_s if compile_s > 0 else 0.0
        frac_max = max(frac_max, frac)
        n_errors += len(report.errors)
        models[name] = {
            "errors": len(report.errors),
            "warnings": len(report.warnings),
            "findings": [f.to_dict() for f in report.findings],
            "programs": dict(getattr(report, "programs", {}) or {}),
            "compile_s": round(compile_s, 4),
            "audit_s": round(audit_s, 4),
            "audit_walk_s": round(walk_s, 4),
            "audit_record_s": round(prof.get("record_s", 0.0), 4),
            "audit_frac": round(frac, 4),
        }

    # caller-side AUD002: reuse of donated buffers across the runtime,
    # serving and tools sources
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    reuse = lint_donated_reuse_paths([
        os.path.join(root, "flexflow_tpu_torch", "runtime"),
        os.path.join(root, "flexflow_tpu_torch", "serving"),
        os.path.join(root, "chip_smoke.py"),
    ])
    n_errors += sum(1 for f in reuse if f.severity == "error")

    doc = {
        "models": models,
        "donated_reuse": {
            "errors": sum(1 for f in reuse if f.severity == "error"),
            "findings": [f.to_dict() for f in reuse],
        },
        "audit_frac_max": round(frac_max, 4),
        "codes": {k: v for k, v in CODE_CATALOG.items()
                  if k.startswith("AUD")},
        "exit": 1 if n_errors else 0,
    }
    line = json.dumps(doc, sort_keys=True)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 1 if n_errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
