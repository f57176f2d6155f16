#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``flexflow_tpu_torch``).

    python3 chip_smoke.py          # from the repo root, on a machine with one H100

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit (as nvidia-smi gives them),
   the torch/CUDA versions; TF32 is switched off for matmuls and cuDNN;
2. build: every kernel under flexflow_tpu_torch/kernels/csrc, built by nvcc
   for sm_90a, with the compiler's register/spill report;
3. kernels: each kernel at the shapes the main path gives it, held against
   its plain PyTorch version, timed beside the plain version, the one
   PyTorch call that computes the same function, and its bound;
4. serving: the reference Transformer (build_transformer at the
   TransformerConfig defaults: seq 512, hidden 1024, 16 heads, 12 layers)
   at batch 8, served through InferenceEngine.infer_async, in float32 and
   in bfloat16; every answer is held against the same rows run through the
   plain attention path on the card, and the kernel's launch count must be
   12 per forward dispatch;
5. the kernels line, one JSON object;
6. the last line: {"ok": true, "device": {...}}.

Imports torch, numpy and flexflow_tpu_torch only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
DEVICE = "cuda"
BATCH, SEQ, HEADS, HEAD_DIM = 8, 512, 16, 64  # the slice's attention shape
REQUESTS = 64  # per serving run
# H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# kernel vs plain: f32 sums in another order; bf16 outputs may land one
# bf16 ulp apart (2^-7 at magnitudes in [1, 2)); lse is f32 in both
KERNEL_TOL = {torch.float32: {"out": 1e-4, "lse": 1e-4},
              torch.bfloat16: {"out": 1e-2, "lse": 1e-4}}
# serving vs the plain attention path, as a fraction of the largest answer:
# everything but attention runs the same code; the kernel's f32 rounding
# differences (or its bf16 ulp flips) pass through 12 layers
SERVE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    return card


def phase_build() -> None:
    from flexflow_tpu_torch.kernels import _build

    path, seconds, log = _build.build()
    _build.load_library()
    print(f"build: {path.name} in {seconds:.1f} s (nvcc {_build.find_nvcc()})")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "error" in line.lower():
            print(f"  ptxas: {line.strip()}")
    sys.stdout.flush()


def flash_bound(dtype: torch.dtype, causal: bool) -> tuple:
    """(bound_ms, bound_by) of one forward at the slice shape: the larger of
    the bytes it must move (q, k, v read once, out and lse written once)
    over HBM bandwidth and the matmul FLOPs these inputs need (causal:
    only the q >= k pairs) over the peak for their type."""
    bh = BATCH * HEADS
    pairs = SEQ * (SEQ + 1) // 2 if causal else SEQ * SEQ
    flops = 4.0 * bh * pairs * HEAD_DIM
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * bh * SEQ * HEAD_DIM * elem + bh * SEQ * 4
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels() -> list:
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import flash_attention as fa

    variants = []
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    scale = HEAD_DIM ** -0.5
    shape = (BATCH * HEADS, SEQ, HEAD_DIM)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                   for _ in range(3))
        q4, k4, v4 = (t.view(BATCH, HEADS, SEQ, HEAD_DIM) for t in (q, k, v))
        for causal in (False, True):
            out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
            ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
            torch.cuda.synchronize()
            err_out = (out.float() - ref_out.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            tol = KERNEL_TOL[dtype]
            name = f"{str(dtype).removeprefix('torch.')} causal={causal}"
            check(torch.isfinite(out.float()).all().item()
                  and torch.isfinite(lse).all().item(), f"{name}: non-finite output")
            check(err_out <= tol["out"] and err_lse <= tol["lse"],
                  f"{name}: kernel vs plain out err {err_out} lse err {err_lse} "
                  f"over tolerance {tol}")
            ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal, scale), 20)
            plain_ms = time_ms(
                lambda: fa.flash_attention_fwd_reference(q, k, v, causal, scale), 10)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=scale), 20)
            bound_ms, bound_by = flash_bound(dtype, causal)
            row = dict(dtype=str(dtype).removeprefix("torch."), causal=causal,
                       max_abs_err=err_out, lse_max_abs_err=err_lse,
                       tolerance=tol["out"], ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
            print(f"kernel flash_attention_fwd {name} shape {shape}: out err "
                  f"{err_out:.3g} lse err {err_lse:.3g} (tol {tol}); kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} "
                  f"ms, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{bound_ms / ms:.1%} of bound", flush=True)
            variants.append(row)
    return variants


def random_params(ff, seed: int) -> dict:
    """Random params with a variance-preserving scale (std sqrt(gain /
    fan_in), gain 2 after a ReLU) and small random biases. The model's own
    init (Glorot, zero biases) shrinks the activations of every one of the
    12 residual-free layers by orders of magnitude, and answers near the
    bottom of the f32 range would make the comparison with the plain path
    say nothing."""
    rng = np.random.default_rng(seed)
    tree = {}
    for op, ws in ff.compiled.params.items():
        tree[op] = {}
        for w, cur in ws.items():
            shape = tuple(cur.shape)
            if len(shape) == 1 or w.startswith("b"):
                std = 0.1
            else:
                fan_in = shape[0] if w in ("wq", "wk", "wv") else int(np.prod(shape[:-1]))
                std = np.sqrt((2.0 if op.endswith("ff2") else 1.0) / fan_in)
            tree[op][w] = (rng.standard_normal(size=shape, dtype=np.float32)
                           * np.float32(std))
    return tree


def dispatch_breakdown(inst, x: np.ndarray) -> dict:
    """Where one served dispatch's time goes: the host's wall time of
    ModelInstance.infer on a full batch, the device's busy time in it by
    kernel class (torch.profiler), and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inst.infer([x])
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        return {"wall_ms": wall_ms, "device": "not measured"}
    by_class = {"flash_attention_fwd": 0.0, "gemm": 0.0, "memcpy": 0.0, "other": 0.0}
    by_name: dict = {}
    for name, start, end in spans:
        low = name.lower()
        cls = ("flash_attention_fwd" if "flash_fwd_kernel" in name else
               "gemm" if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet"))
               else "memcpy" if "memcpy" in low else "other")
        by_class[cls] += (end - start) / 1e3
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (end - start) / 1e3
    busy_us, last_end = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda t: t[1]):
        busy_us += max(0.0, end - max(start, last_end))
        last_end = max(last_end, end)
    busy_ms = busy_us / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "device_ms_by_class": by_class,
            "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])}


def phase_serving(compute_dtype: str, params, card: str):
    """Serve REQUESTS single-sample requests through InferenceEngine with
    the flash launch count reset just before and read just after; hold the
    answers against the plain attention path. Returns (row, params)."""
    from flexflow_tpu_torch import CompMode, FFConfig, FFModel, load_numpy_params
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    cfg = TransformerConfig()
    ff = FFModel(FFConfig(batch_size=BATCH, computation_mode=CompMode.INFERENCE,
                          compute_dtype=compute_dtype, seed=SEED, device=DEVICE))
    build_transformer(ff, BATCH, cfg)
    ff.compile()
    if params is None:
        params = random_params(ff, SEED)
    load_numpy_params(ff, params)
    cm = ff.compiled
    n_attn = sum(op.op_type.name == "MULTIHEAD_ATTENTION" for op in cm.ops)
    check(n_attn == cfg.num_layers, f"{n_attn} attention ops, want {cfg.num_layers}")

    rng = np.random.default_rng(SEED + 1)
    xs = rng.standard_normal(size=(REQUESTS, cfg.sequence_length, cfg.hidden_size),
                             dtype=np.float32)
    engine = InferenceEngine()
    inst = engine.register_ffmodel(ff, "transformer")
    try:
        engine.infer("transformer", [xs[0]], timeout=600)  # warm-up
        torch.cuda.synchronize()
        d0 = inst.dispatches
        t_done = [0.0] * REQUESTS
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        t_submit, futs = [], []
        for i in range(REQUESTS):
            t_submit.append(time.perf_counter())
            f = engine.infer_async("transformer", [xs[i]])
            f.add_done_callback(
                lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append(f)
        answers = [f.result(600) for f in futs]
        launches = kernels.launch_counts()["flash_attention_fwd"]
    finally:
        engine.stop()
    dispatches = inst.dispatches - d0
    wall = max(t_done) - t0
    lat_ms = np.array([(t_done[i] - t_submit[i]) * 1e3 for i in range(REQUESTS)])
    check(launches == n_attn * dispatches,
          f"flash kernel launched {launches} times for {dispatches} forward "
          f"dispatches (want {n_attn} per dispatch)")

    got = np.stack(answers)
    check(got.shape == (REQUESTS, cfg.sequence_length, 1),
          f"answers of shape {got.shape}")
    check(bool(np.isfinite(got).all()), "non-finite answers")
    xdev = torch.from_numpy(xs[:BATCH]).to(cm.device)
    forward_ms = time_ms(lambda: cm.forward_fn(cm.params, xdev), 5)
    breakdown = dispatch_breakdown(inst, xs[:BATCH])
    refs = []
    for lo in range(0, REQUESTS, BATCH):
        x = torch.from_numpy(xs[lo:lo + BATCH]).to(cm.device)
        refs.append(cm.forward_fn(cm.params, x, plain_kernels=True).cpu().numpy())
    ref = np.concatenate(refs)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max()) / scale
    check(scale > 0 and err <= SERVE_TOL[compute_dtype],
          f"{compute_dtype}: answers vs plain path: {err:.3g} of the largest "
          f"answer ({scale:.3g}) > {SERVE_TOL[compute_dtype]}")
    row = dict(compute_dtype=compute_dtype, requests=REQUESTS,
               dispatches=dispatches, launches=launches,
               requests_per_s=REQUESTS / wall,
               p50_ms=float(np.percentile(lat_ms, 50)),
               p99_ms=float(np.percentile(lat_ms, 99)),
               rel_err_vs_plain=err, answer_scale=scale,
               served_ms_per_dispatch=wall * 1e3 / dispatches,
               forward_device_ms=forward_ms,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               breakdown=breakdown)
    print(f"serving {compute_dtype}: {REQUESTS} requests in {dispatches} "
          f"dispatches, {launches} flash launches; {row['requests_per_s']:.2f} "
          f"req/s, p50 {row['p50_ms']:.1f} ms, p99 {row['p99_ms']:.1f} ms; "
          f"max err vs plain path {err:.3g} of the largest answer "
          f"({scale:.3g}); forward {forward_ms:.2f} ms on device vs "
          f"{row['served_ms_per_dispatch']:.2f} ms served per dispatch "
          f"[{card}]", flush=True)
    print(f"dispatch breakdown {compute_dtype}: {json.dumps(breakdown)}",
          flush=True)
    print("serving_json " + json.dumps(row), flush=True)
    return row, params


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    card = phase_device()
    phase_build()
    variants = phase_kernels()
    rows, params = [], None
    for compute_dtype in ("float32", "bfloat16"):
        row, params = phase_serving(compute_dtype, params, card)
        rows.append(row)
    main_row = next(r for r in variants if r["dtype"] == "float32" and not r["causal"])
    kernel = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "flexflow_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "flexflow_tpu/kernels/flash_attention.py:43",
        "launches": sum(r["launches"] for r in rows),
        "max_abs_err": main_row["max_abs_err"],
        "max_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": [BATCH * HEADS, SEQ, HEAD_DIM],
        "variants": variants,
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
