#!/usr/bin/env python3
"""Time the port's {data: 2} training step and its exposed gradient sync
on one card.

    python3 tools/torch_grad_overlap.py [--tree DIR] [--label L] [--layers 4]
                                        [--steps 5] [--dtypes float32,bfloat16]

Imports ``flexflow_tpu_torch`` from ``--tree`` (default: this checkout), so
that one call can time two checkouts in turns (parent, change, change,
parent). Two ranks share the card over gloo, as ``chip_smoke.py``'s
``phase_parallel`` (a): the reference Transformer's widths (sequence 512,
width 1024, 16 heads) at ``--layers`` layers, 8 samples a rank, SGD 0.01,
MSE loss. For each dtype, after two warm steps, ``--steps`` train steps,
each timed on the host clock up to a ``torch.cuda.synchronize()``, and
each step's exposed sync: host ms from ``torch.autograd.grad``'s return
to the optimizer update's start (``SGDOptimizer.update``), the two marks
every checkout's step has, wrapped for the run: what lies between is the
gradient sync the backward did not hide, with the metrics' and the
loss's small all-reduces. Beside them, rank 0's simulator
estimate of the step on ``SharedCardMachineModel`` with and without the
overlap credit (``search_overlap_backward_update``), from the checkout's
own ``sim/``.

Prints the card's name and power limit first and one JSON object last
(rank 0's numbers, every rank's step medians). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH, SEQ, WIDTH, HEADS, SEED = 8, 512, 1024, 16, 0


def rank_body(rank: int, world: int, tree: str, layers: int, steps: int,
              dtypes: list) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer
    from flexflow_tpu_torch.sim import OpCostModel, SharedCardMachineModel, Simulator
    from flexflow_tpu_torch.sim.machine_model import h100_chip

    torch.backends.cuda.matmul.allow_tf32 = False
    marks: dict = {}
    grad, update = torch.autograd.grad, ft.SGDOptimizer.update

    def stamped_grad(*a, **k):
        out = grad(*a, **k)
        marks["return"] = time.perf_counter()
        return out

    def stamped_update(*a, **k):
        marks["end"] = time.perf_counter()
        return update(*a, **k)

    torch.autograd.grad, ft.SGDOptimizer.update = stamped_grad, stamped_update
    out = {}
    for dt in dtypes:
        batch = BATCH * world
        ff = ft.FFModel(ft.FFConfig(batch_size=batch, compute_dtype=dt, seed=SEED,
                                    mesh_shape={"data": world}))
        build_transformer(ff, batch, TransformerConfig(
            hidden_size=WIDTH, embedding_size=WIDTH, num_heads=HEADS, num_layers=layers,
            sequence_length=SEQ))
        ff.compile(ft.SGDOptimizer(lr=0.01), ft.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        cm = ff.compiled
        rng = np.random.default_rng(SEED + 1)
        ff.set_batch([rng.standard_normal((batch, SEQ, WIDTH), dtype=np.float32)],
                     rng.standard_normal((batch, SEQ, 1), dtype=np.float32))
        step_ms, exposed_ms = [], []
        for i in range(2 + steps):
            torch.cuda.synchronize()
            marks.clear()
            t0 = time.perf_counter()
            cm.params, cm.opt_state, loss, _ = cm.train_step(cm.params, cm.opt_state, None,
                                                             *ff._cur_batch)
            loss.item()
            torch.cuda.synchronize()
            if i >= 2:
                step_ms.append((time.perf_counter() - t0) * 1e3)
                exposed_ms.append((marks["end"] - marks["return"]) * 1e3)
            if not np.isfinite(loss.item()):
                raise RuntimeError(f"{dt}: non-finite loss at step {i}")
        machine = SharedCardMachineModel(h100_chip(dt), world)
        est = {o: Simulator(machine, OpCostModel(machine),
                            overlap_grad_sync=o).simulate_runtime(cm.ops) * 1e3
               for o in (True, False)}
        # the buckets of the last step, where the checkout records them
        buckets = (getattr(cm, "last_sync", None) or {}).get("buckets", [])
        out[dt] = dict(step_ms=step_ms, step_ms_median=statistics.median(step_ms),
                       exposed_ms=exposed_ms, exposed_ms_median=statistics.median(exposed_ms),
                       buckets=len(buckets),
                       before_return=sum(b["before_return"] for b in buckets),
                       est_ms_credit=est[True], est_ms_no_credit=est[False])
        del ff, cm
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args()
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)

    import torch

    from flexflow_tpu_torch.parallel.distributed import spawn

    if not torch.cuda.is_available():
        print("torch_grad_overlap: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ranks = spawn(rank_body, 2, tree, args.layers, args.steps, args.dtypes.split(","))
    out = {"tree": tree, "label": args.label, "card": card, "layers": args.layers,
           **ranks[0],
           "rank_step_ms_median": {dt: [r[dt]["step_ms_median"] for r in ranks]
                                   for dt in ranks[0]}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
