#!/usr/bin/env python3
"""Time the port's dropout draws and a train step with dropout on a card.

    python3 tools/torch_dropout_cost.py [--tree DIR] [--label L] [--layers 2]
                                        [--iters 20]

Imports ``flexflow_tpu_torch`` from ``--tree`` (default: this checkout), so
that one call can time two checkouts in turns (parent, change, change,
parent). The model has the reference Transformer's widths (batch 8,
sequence 512, width 1024, 16 heads): ``--layers`` attention layers with
attention dropout 0.1, each followed by a Dropout(0.1) layer, then a dense
layer, MSE loss, SGD. Reported, each by CUDA events (median of
``--iters`` after two warm calls) with the bytes allocated at its peak
above what was held before it:

* one (8, 16, 512, 512) mask draw, the checkout's own: a seeded
  ``torch.Generator``'s ``torch.rand`` where ``LowerCtx`` has
  ``generator``, else ``LowerCtx.uniform``;
* an eager train step (``CompiledModel.eager["train_step"]`` where the
  checkout has it, else ``train_step``);
* where the checkout captures the model's steps, the captured train step.

Prints the card's name and power limit first and one JSON object last.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

BATCH, SEQ, WIDTH, HEADS, RATE = 8, 512, 1024, 16, 0.1


def timed(fn, iters: int) -> tuple:
    """(median ms by CUDA events, peak bytes allocated above the start)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    ms.sort()
    return ms[len(ms) // 2], torch.cuda.max_memory_allocated() - held


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import numpy as np
    import torch

    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.core.op import LowerCtx

    if not torch.cuda.is_available():
        print("torch_dropout_cost: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"tree": str(Path(ft.__file__).resolve().parents[1]), "label": args.label,
           "card": card, "layers": args.layers}

    ctx = LowerCtx(rng=3, seed=0)
    shape = (BATCH, HEADS, SEQ, SEQ)
    if hasattr(ctx, "generator"):
        out["draw"] = "torch.rand, seeded torch.Generator"
        draw = lambda: torch.rand(shape, generator=ctx.generator("attn0", dev),  # noqa: E731
                                  device=dev)
    else:
        out["draw"] = "LowerCtx.uniform"
        draw = lambda: ctx.uniform("attn0", shape, dev)  # noqa: E731
    out["mask_ms"], out["mask_peak_bytes"] = timed(draw, args.iters)

    ff = ft.FFModel(ft.FFConfig(batch_size=BATCH, seed=0, audit_programs="off",
                                validate_pcg="off"))
    t = ff.create_tensor((BATCH, SEQ, WIDTH), name="x")
    for i in range(args.layers):
        t = ff.multihead_attention(t, t, t, WIDTH, HEADS, dropout=RATE, name=f"attn{i}")
        t = ff.dropout(t, RATE, name=f"drop{i}")
    ff.dense(t, WIDTH, name="out")
    ff.compile(ft.SGDOptimizer(lr=1e-4), ft.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    cm = ff.compiled
    rng = np.random.default_rng(1)
    xb, yb = (torch.from_numpy(rng.standard_normal((BATCH, SEQ, WIDTH), dtype=np.float32))
              .to(dev) for _ in range(2))
    eager = getattr(cm, "eager", None)
    steps = {"eager": eager["train_step"] if eager else cm.train_step}
    if getattr(cm, "graphs", None) is not None:
        steps["captured"] = cm.train_step
    for mode, fn in steps.items():
        losses = []

        def step():
            cm.params, cm.opt_state, loss, _ = fn(cm.params, cm.opt_state, 7, xb, yb)
            losses.append(loss)

        out[f"step_ms_{mode}"], out[f"step_peak_bytes_{mode}"] = timed(step, args.iters)
        if not all(bool(torch.isfinite(v)) for v in losses):
            print(f"torch_dropout_cost: non-finite loss in the {mode} steps", file=sys.stderr)
            return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
