"""Simulator calibration on the card.

PyTorch counterpart of ``flexflow_tpu/sim/calibrate.py``. Calibration fits
the quantity the simulator predicts, whole train steps:

    real_step ≈ scale · simulated_step + step_overhead

by least squares over ``CALIBRATION_CONFIGS`` (a small Transformer that
exposes the fixed per-step cost, the bench Transformer that exposes the
efficiency scale, AlexNet at 229 px that keeps convolutions fitted rather
than extrapolated from Transformers). ``scale`` folds into the chip's
matmul and memory efficiencies, ``step_overhead`` becomes
``ChipSpec.step_overhead``. Each compute dtype is fitted on its own
(``h100`` for f32, ``h100-bf16``). :func:`measure_staging_rate` times the
port's gloo all-reduce among ranks sharing the card (2 ranks in one
group; 4 ranks in groups of 2 and in one group of 4), the readings
``SharedCardMachineModel`` prices a shared card's collectives from.

Usage, on the card::

    from flexflow_tpu_torch.sim.calibrate import calibrate, measure_staging_rate
    print(calibrate().report())                        # f32
    print(calibrate(compute_dtype="bfloat16").report())
    print(measure_staging_rate())
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CalibrationResult:
    chip_name: str
    scale: float            # real/simulated slope (uncalibrated sim)
    step_overhead: float    # fixed per-step seconds
    points: List[Tuple[str, float, float]]  # (config, real_s, calibrated sim_s)
    machine: object         # MachineModel with the fitted chip

    def report(self) -> str:
        lines = [
            "| config | measured step | simulated (calibrated) | ratio |",
            "|---|---|---|---|",
        ]
        for name, real, sim in self.points:
            lines.append(f"| {name} | {real * 1e3:.2f} ms | {sim * 1e3:.2f} ms "
                         f"| {sim / real:.2f} |")
        lines.append("")
        lines.append(f"fit: scale={self.scale:.3f}, step_overhead="
                     f"{self.step_overhead * 1e3:.2f} ms (chip {self.chip_name})")
        return "\n".join(lines)


def _synth(t, gen, device):
    """A random batch for tensor ``t``: standard normal floats, integer
    ids in {0, 1} (valid for every table and class count)."""
    import torch

    if t.dtype.name.startswith("INT"):
        return torch.randint(0, 2, tuple(t.dims), generator=gen, device=device,
                             dtype=t.dtype.to_torch())
    return torch.randn(tuple(t.dims), generator=gen, device=device,
                       dtype=torch.float32).to(t.dtype.to_torch())


def measure_step_time(ff, warmup: int = 3, iters: int = 20) -> float:
    """Seconds of one ``train_step`` of a compiled model on the card:
    CUDA events around ``iters`` steps after ``warmup`` (the same batch,
    synthesized from the compiled inputs' and label's specs)."""
    import torch

    cm = ff.compiled
    dev = cm.device
    if dev.type != "cuda":
        raise ValueError("measure_step_time times steps on a CUDA device")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xs = [_synth(t, gen, dev) for t in cm.input_tensors]
    y = _synth(cm.label_tensor, gen, dev)
    for _ in range(warmup):
        cm.params, cm.opt_state, loss, _ = cm.train_step(cm.params, cm.opt_state, None, *xs, y)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        cm.params, cm.opt_state, loss, _ = cm.train_step(cm.params, cm.opt_state, None, *xs, y)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _build_transformer(batch, layers, seq, hidden, heads, compute_dtype=None,
                       device="cuda"):
    from ..config import FFConfig
    from ..ffconst import LossType
    from ..models.transformer import TransformerConfig, build_transformer
    from ..runtime.model import FFModel
    from ..runtime.optimizer import SGDOptimizer

    cfg = TransformerConfig(hidden_size=hidden, num_heads=heads, num_layers=layers,
                            sequence_length=seq)
    ff = FFModel(FFConfig(batch_size=batch, seed=0, compute_dtype=compute_dtype,
                          device=device))
    build_transformer(ff, batch, cfg)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, metrics=[])
    return ff


def _build_cnn(batch: int, compute_dtype=None, device="cuda"):
    """AlexNet at its native 229x229x3: the convolution-heavy point."""
    from ..config import FFConfig
    from ..ffconst import LossType
    from ..models.alexnet import build_alexnet
    from ..runtime.model import FFModel
    from ..runtime.optimizer import SGDOptimizer

    ff = FFModel(FFConfig(batch_size=batch, seed=0, compute_dtype=compute_dtype,
                          device=device))
    build_alexnet(ff, batch)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, metrics=[])
    return ff


# (name, builder(compute_dtype)): the overhead-dominated Transformer, the
# compute-dominated bench Transformer (transformer.cc:78-86), AlexNet
CALIBRATION_CONFIGS = [
    ("small b8 L4 s256 h512",
     lambda dt: _build_transformer(8, 4, 256, 512, 8, dt)),
    ("bert-base b8 L12 s512 h1024",
     lambda dt: _build_transformer(8, 12, 512, 1024, 16, dt)),
    ("alexnet b64 229x229", lambda dt: _build_cnn(64, dt)),
]


def calibrate(machine=None, configs=None, iters: int = 20,
              compute_dtype: Optional[str] = None) -> CalibrationResult:
    """Fit (scale, step_overhead) on the card for ``compute_dtype`` and
    return a machine model with the fitted chip. The points are simulated
    with a neutral chip (efficiencies 0.55 and 0.8, no step overhead) so
    refitting a calibrated preset does not apply the fit twice."""
    import gc

    import torch

    from . import OpCostModel, SimpleMachineModel, Simulator
    from .machine_model import h100_chip

    if machine is None:
        machine = SimpleMachineModel(h100_chip(compute_dtype), 1)
    configs = configs or CALIBRATION_CONFIGS
    base_chip = dataclasses.replace(machine.chip, mxu_efficiency=0.55,
                                    hbm_efficiency=0.8, step_overhead=0.0)
    base_machine = SimpleMachineModel(base_chip, machine.num_devices())

    pts = []
    for name, build in configs:
        ff = build(compute_dtype)
        real = measure_step_time(ff, iters=iters)
        ops = ff.compiled.ops
        est = Simulator(base_machine, OpCostModel(base_machine)).simulate_runtime(ops)
        pts.append((name, real, est, ops))
        del ff
        gc.collect()
        torch.cuda.empty_cache()

    xs = np.array([p[2] for p in pts])
    ys = np.array([p[1] for p in pts])
    A = np.stack([xs, np.ones_like(xs)], axis=1)
    (scale, overhead), *_ = np.linalg.lstsq(A, ys, rcond=None)
    scale = float(max(scale, 1e-6))
    overhead = float(max(overhead, 0.0))
    chip = dataclasses.replace(
        base_chip, mxu_efficiency=base_chip.mxu_efficiency / scale,
        hbm_efficiency=base_chip.hbm_efficiency / scale, step_overhead=overhead)
    fitted = SimpleMachineModel(chip, machine.num_devices())
    fsim = Simulator(fitted, OpCostModel(fitted))
    points = [(name, real, fsim.simulate_runtime(ops)) for name, real, _e, ops in pts]
    return CalibrationResult(chip.name, scale, overhead, points, fitted)


# (ranks on the card, ranks in each all-reduce group) measured by default:
# the layouts of chip_smoke.py's mesh runs
STAGING_LAYOUTS = ((2, 2), (4, 2), (4, 4))


def _staging_worker(rank: int, world: int, sizes: Sequence[int], device: str,
                    iters: int, degrees: Sequence[int]) -> Dict[int, Dict[int, float]]:
    import time

    import torch

    from ..core.machine import make_mesh
    from ..parallel import collectives

    out: Dict[int, Dict[int, float]] = {}
    for degree in degrees:
        # world // degree groups, all-reducing at once
        group = make_mesh({"model": world // degree, "data": degree}).group(["data"])
        out[degree] = {}
        for nbytes in sizes:
            x = torch.ones(nbytes // 4, device=device)
            collectives.all_reduce_sum(x, group)  # warm the path
            times = []
            for _ in range(iters):
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                collectives.all_reduce_sum(x, group)
                if device == "cuda":
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            # the slowest rank's median finishes the collective
            out[degree][nbytes] = float(np.median(times))
    return out


def measure_staging_rate(sizes: Sequence[int] = (1 << 20, 64 << 20), iters: int = 5,
                         device: str = "cuda",
                         layouts: Sequence[Tuple[int, int]] = STAGING_LAYOUTS) -> List[Dict]:
    """The port's all-reduce among ranks sharing one device over gloo
    (host staging included): for each (ranks, group size) in ``layouts``,
    that many ranks spawned on the device, every group all-reducing at
    once, at each payload size in ``sizes``; the slowest rank's median
    seconds of ``iters`` calls each. Fits ``t = S / rate + latency`` over
    the sizes; returns one ``{"ranks", "degree", "rate": bytes/s,
    "latency": s, "points": {bytes: s}}`` a layout, the readings
    ``SharedCardMachineModel(staging={(ranks, degree): (rate, latency)})``
    prices from."""
    from ..parallel import distributed

    sizes = [int(s) for s in sizes]
    by_world: Dict[int, List[int]] = {}
    for n, d in layouts:
        by_world.setdefault(int(n), []).append(int(d))
    out = []
    for n, degrees in by_world.items():
        ranks = distributed.spawn(_staging_worker, n, sizes, device, iters, degrees)
        for d in degrees:
            ys = np.array([max(r[d][s] for r in ranks) for s in sizes])
            xs = np.array(sizes, dtype=np.float64)
            A = np.stack([xs, np.ones_like(xs)], axis=1)
            (slope, latency), *_ = np.linalg.lstsq(A, ys, rcond=None)
            out.append({"ranks": n, "degree": d, "rate": float(1.0 / max(slope, 1e-15)),
                        "latency": float(max(latency, 0.0)),
                        "points": {int(s): float(y) for s, y in zip(sizes, ys)}})
    return out


if __name__ == "__main__":
    for dt in (None, "bfloat16"):
        print(calibrate(compute_dtype=dt).report())
    print(measure_staging_rate())
