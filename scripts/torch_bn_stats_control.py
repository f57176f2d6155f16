"""The control reading of ``chip_smoke.py``'s (j) check: ResNet-50 at 229 px,
batch 64, over {data: 2}, held to the one-rank run, once with the port's
global batch-norm statistics and once with each rank's own (its half of
the batch; the unbiased correction still uses the global count). A bound of
(j) that the control passes cannot tell the two apart.

Prints one JSON line a run: the running statistics' error after the first
step and after MESH_STEPS steps (:func:`chip_smoke.bn_stats_err`), and the
whole model's update error in 2-norm after the first step and after
MESH_STEPS steps (:func:`chip_smoke.update_err`), beside the card's name
and power limit. Needs one card::

    python3 scripts/torch_bn_stats_control.py
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _local_statistics(x, group, count):
    return torch.var_mean(x.float(), dim=(0, 2, 3), keepdim=True, correction=0)


def local_stats_worker(rank: int, world: int, jobs: list) -> list:
    """:func:`chip_smoke.par_worker` with each rank's own statistics."""
    from flexflow_tpu_torch.ops.conv import BatchNorm

    BatchNorm._global_stats = staticmethod(_local_statistics)
    return cs.par_worker(rank, world, jobs)


def main() -> int:
    from flexflow_tpu_torch.parallel.distributed import spawn

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    os.chdir(ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    opts = dict(device="cuda")
    ref = cs.mesh_fit(opts, "resnet")
    cs.free_device()
    start = cs.as_tensors(ref["start"])
    want, want1 = cs.as_tensors(ref["params"]), cs.as_tensors(ref["first"])
    for name, worker in (("global", cs.par_worker), ("local (control)", local_stats_worker)):
        ranks = spawn(worker, 2, [("mesh", opts, dict(kind="resnet", mesh_shape={"data": 2},
                                                      weights=ref["start"]))])
        r0 = ranks[0][0]
        got, got1 = cs.as_tensors(r0["params"]), cs.as_tensors(r0["first"])
        print(json.dumps(dict(
            statistics=name, card=card,
            running_stats_after_1=cs.bn_stats_err(got1, want1, start, 1),
            running_stats_after_all=cs.bn_stats_err(got, want, start, cs.MESH_STEPS),
            update_after_1=cs.update_err(got1, want1, start),
            update_after_all=cs.update_err(got, want, start),
            steps=cs.MESH_STEPS, bound_stats=cs.MESH_BN_STATS_TOL,
            bound_update=cs.MESH_RESNET_TOL)), flush=True)
        cs.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
