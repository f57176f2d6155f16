#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``flexflow_tpu_torch``).

    python3 chip_smoke.py          # from the repo root, on a machine with one H100

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit (as nvidia-smi gives them),
   the torch/CUDA versions; TF32 is switched off for matmuls and cuDNN;
2. build: every kernel under flexflow_tpu_torch/kernels/csrc, built by nvcc
   for sm_90a, with each kernel instance's registers and stack frame as
   cuobjdump reads them from the loaded library; the 24 tensor-core
   instances (the bf16 forward, dq and dkv and the split-TF32 f32
   forward, dq and dkv at padded head dims 32/64/128/256) must be there,
   with no stack frame (no spill) up to the padded head dim 128, the 12
   instances of the tensor-core forward above head dim 256 (bf16 and split
   TF32 at group widths 144/192/256, Q resident in shared memory or
   streamed with K) and the 14 of the tensor-core backward above it (dq
   and dkv, bf16 and split TF32, by design, group width and residency);
3. kernels: each kernel at the shapes the main path gives it, held against
   its plain PyTorch version, timed beside the plain version, the one
   PyTorch call that computes the same function, and its bound: the
   flash-attention forward and then its two backward kernels (dq, dkv),
   both dtypes, all on the tensor cores (f32 with split TF32 products),
   each held bitwise equal over two runs, the profiler showing which
   forward and backward kernels ran; then the ragged and
   repaired cases (S = 200, Sq != Skv at 10 and 37, D = 96, D = 256,
   B*H > 65535, and D = 264 and 512, causal and not: the tensor-core
   forward and backward kernels above head dim 256, which the profiler
   must show ran), then GPT's shape (causal, B*H 64, S 1024, D 64);
4. serving: the reference Transformer (build_transformer at the
   TransformerConfig defaults: seq 512, hidden 1024, 16 heads, 12 layers)
   at batch 8, served through InferenceEngine.infer_async, in float32 and
   in bfloat16; every answer is held against the same rows run through the
   plain attention path on the card, and the kernel's launch count must be
   12 per forward dispatch (and 0 for the MoE kernels);
5. training: the same model at the same width and batch, compiled with
   SGDOptimizer(lr=0.01) and the MSE-avg loss, in float32 and in bfloat16:
   one grad_step's gradients at the serving phase's random params, and
   five train_steps' losses and params from the model's own init (as
   bench.py trains it), held against the plain kernels' path;
   FFModel.fit over 64 samples with exactly 12 launches of each flash
   kernel per step (and none of the MoE kernels); then the step time
   (3 rounds of 20 steps, each round's median and the median of all), a
   profiled step's breakdown and the peak memory;
6. GPT: build_gpt at GPTConfig's defaults (vocab 32000, 1024 positions,
   hidden 512, 8 heads, 6 layers), batch 8 at 1024 tokens, in float32 and
   bfloat16. Training with SGDOptimizer(lr=0.01) and sparse categorical
   cross-entropy: one grad_step, five train_steps' losses and params, and
   FFModel.fit of 8 steps (6 launches of each flash kernel a step) replayed
   through the plain path; the step time (median of 20), tokens/s, a
   profiled step's breakdown and device-busy share, the peak memory.
   Generation: Generator(max_length=1024).generate of 128 greedy tokens
   for 8 prompts of 128, every block step's logits held against one full
   causal forward of the generated tokens (6 flash launches), and the
   greedy tokens against its argmax where its top-2 margin exceeds the
   bound; prefill ms, decode ms a token (p50, p99), tokens/s.
   Continuous batching: 4 requests teacher-forced through a PagedDecoder
   (prefill and 8 decode steps) against the dense Generator; then 32
   greedy requests (prompts of 16-512 tokens, 16-128 new) submitted in
   waves through InferenceEngine.register_generator (8 decode slots,
   16-token blocks, max_length 1024), with no kernel launched while
   serving, one decode dispatch a step, and every answer's greedy tokens
   held against its full causal forward (6 flash launches each) by the
   margin rule; the same traffic speculatively (spec_k 3, draft "self:2")
   and with an int8 pool, each held to the plain run's tokens up to a
   first parting where the plain run's margin is within the bound;
   tokens/s, TTFT and decode step ms (p50, p99), prefill dispatches, pool
   high water and bytes, peak memory;
7. the BERT proxy (build_bert_proxy at its defaults: hidden 768, 12
   heads, 12 layers, seq 128): a FFModel.fit of 2 steps at batch 8 in
   float32, launches counted, against the plain path;
8. MoE kernels: row_gather and row_gather_sum, float32 and bfloat16, at
   the MoE model's shape (batch 64, d 784, 5 experts, top-2, capacity 52)
   and at Mixtral-8x7B's widths (hidden 4096, 8 experts, top-2, 4096
   tokens), each held against its plain version and timed beside it,
   F.embedding_bag and its bound; the dispatch's backward (row_gather_sum)
   with x requiring a gradient, against the plain path;
9. MoE serving: build_moe_mnist at the MoeConfig defaults, batch 64,
   served through InferenceEngine.infer_async in float32 and bfloat16;
   every dispatch's exact batch (padding and order included) is replayed
   through the plain path and must give the same answers, with exactly
   one launch of each MoE kernel (and no flash launch) per dispatch;
10. MoE training: the same model with AdamOptimizer(alpha=0.003), sparse
   categorical cross-entropy and accuracy, in float32 and bfloat16: one
   grad_step, five train_steps' losses (the balance term included), a
   FFModel.fit of 8 steps (3 launches of row_gather and 1 of
   row_gather_sum a step) and FFModel.eval, each held against the plain
   path; the step time (median of 20), a profiled step's breakdown and the
   peak memory; then the stacked form once in float32 through fit;
11. serving breadth: (a) the Transformer of phase 4 loaded through
   InferenceEngine.load_repository in float32 and bfloat16, served by
   the native batcher (native/src/batcher.cc) and by the Python one
   (FLEXFLOW_TPU_NATIVE=off), the 64-request burst through each held to
   phase 4's plain-path answers, 12 flash launches a dispatch; (b) 256
   requests at once with an admission bound of 16 and a deadline of two
   dispatches: the shed and deadline-rejected counts beside their
   counters, every served answer right; (c) under the fault plan (the
   worker crashes at its third batch, two transient dispatch failures):
   respawns and retries observed, every answer right; then the failure
   breaker opens, sheds and closes; (d) GPT at GPTConfig's defaults
   through a "generator": true repository entry under the worker plan: 16
   requests all resolve, their greedy tokens held to full causal forwards
   by the margin rule; (e) the span tracer's cost on (a)'s float32 burst
   and every request's five nested spans;
12. the zoo: ResNet-50 with batch norm (229 px, 1000 classes) and DLRM at
   DLRMConfig() (4 tables of 1,000,000 x 64), batch 64, in float32 and
   bfloat16: three FFModel.fit steps (ResNet's first batch norm's running
   statistics held to a float64 computation of the same batches),
   FFModel.eval and 64 requests through register_ffmodel; step ms,
   samples/s, model TFLOP/s and a profiled step's device-busy share;
   AlexNet, ResNeXt-50, Inception-v3, XDL, CANDLE-Uno and NMT at their
   defaults, one fit step and a timed forward each; every model's
   pre-softmax forward on the card held to the same weights on the CPU;
   none of the port's kernels launched;
13. training robustness and dynamic shapes: (a) GPT at GPTConfig() with
   Adam through one fit epoch of 128 rows of lengths 16-1024 on pow2
   sequence buckets with an 8192-token budget, and the same epoch padded
   to 1024, in float32 and bfloat16, the rows shuffled by fit and sorted
   by length: each step's loss and the params held to the pad-max run's,
   one step's gradients at each ragged width of the sorted rows held to
   the plain kernels' path and to the same rows padded to 1024, valid
   tokens/s, step ms, the padded share, dispatches and flash launches by
   width, fit.bucket_compiles; (b) the Transformer at TransformerConfig(),
   batch 8: grad_accum_steps 2 against 1, and steps_per_dispatch 4 with a
   prefetch depth of 2 against the serial loop (params equal), step ms;
   (c) GPT, float32: the TrainingGuard under train.nan_loss (rollback, lr
   backoff, a Generator built before the fault serving the restored
   weights), a child process killed by train.kill and resumed with
   resume_from, its params and Adam moments equal to an uninterrupted
   run's, the checkpoint's bytes and save ms, and both torn-write targets
   falling back to the previous step;
14. the kernels line, one JSON object;
15. the last line: {"ok": true, "device": {...}}.

Imports torch, numpy and flexflow_tpu_torch only.
"""

from __future__ import annotations

import gc
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
DEVICE = "cuda"
BATCH, SEQ, HEADS, HEAD_DIM = 8, 512, 16, 64  # the slice's attention shape
REQUESTS = 64  # per serving run
# H100 SXM data-sheet peaks (dense): bf16 on the tensor cores; f32 at
# f32 accuracy on the tensor cores, as three TF32 products (494.7 TFLOP/s)
# for each f32 one, which the f32 kernels do and which is the
# least time the card can take for f32 work; the CUDA cores' f32 peak,
# the bound of earlier runs, printed beside it; HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 494.7e12 / 3, torch.bfloat16: 989e12}
CUDA_CORE_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# forward kernel vs plain: f32 sums in another order (the f32 kernel's
# split TF32 products land within a few f32 ulps of f32 ones), absolute;
# lse is f32 in both. bf16 out as a fraction of the largest |out|: the bf16
# kernel rounds P to bf16 before P V where the plain version keeps f32, and
# both round O to bf16, so they may land one bf16 ulp apart, which is at
# most 2^-7 of the largest output. A CPU model that rounds where the kernel
# does stays within that of the JAX kernel, and lands one ulp (2^-6) from
# the plain version at the causal main shape, where |out| reaches [2, 4)
# (tests/test_torch_flash_attention.py)
KERNEL_TOL = {torch.float32: {"out": 1e-4, "lse": 1e-4},
              torch.bfloat16: {"out": 2 ** -7, "lse": 1e-4}}
# backward kernels vs plain, as a fraction of each gradient's largest
# element: f32 sums of up to 512 products in another order; bf16 gradients
# one bf16 ulp apart where both round nearly equal f32 results (2^-7 of
# values in [1, 2)), the bf16 kernels also rounding P and dS to bf16 before
# the second products (that rounding alone stays within 2^-7 of the JAX
# kernels: tests/test_torch_flash_attention_bwd.py)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
# serving vs the plain attention path, as a fraction of the largest answer:
# everything but attention runs the same code; the kernel's f32 rounding
# differences (or its bf16 ulp flips) pass through 12 layers
SERVE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TRAIN_SAMPLES = 64  # fit's epoch: 8 steps of batch 8
TIMED_STEPS = 20
# the Transformer step is timed in rounds of TIMED_STEPS, each round's median
# printed: the bf16 step is host-bound, and one median spreads by several ms
STEP_ROUNDS = 3
# training vs the plain kernels' path. Gradients (and the params after
# five steps): per weight, the max error as a fraction of the largest
# gradient (update) of the weight's layer. f32: the kernels' f32 rounding
# passes back through 12 layers, and a ReLU input that rounds to the other
# side of 0 moves its unit's gradient by one row's share (1/4096 of a
# batch). bf16: each bf16 path lands far from the f32 one (bf16 ulp flips
# compound through 12 layers forward and back; the run prints how far);
# two bf16 paths that round at different places may each be that far from
# f32 in opposite directions, so the tolerance is twice the plain bf16
# path's distance from the plain f32 path, measured in the same run.
GRAD_TOL = 1e-3
BF16_FLOOR_FACTOR = 2.0
# losses of five SGD steps, relative: the forward's rounding differences
# (the serving phase's answers show their size), averaged over 4096
# squared errors, plus the small param drift the gradients above make
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the MoE model (MoeConfig defaults) at the JAX FFConfig's default batch
MOE_BATCH = 64
MOE_REQUESTS = 200  # per MoE serving run: 3 full dispatches and a padded one at least
MOE_TRAIN_SAMPLES = 512  # fit's epoch: 8 steps of batch 64
ADAM_ALPHA = 0.003  # as examples/python/native/moe.py trains the model
# Mixtral-8x7B's config.json: hidden_size 4096, num_local_experts 8,
# num_experts_per_tok 2; 4096 tokens at capacity factor 2.0
MIXTRAL = dict(tokens=4096, d=4096, n=8, k=2, alpha=2.0)
# The MoE kernels round each product, and each sum of products in the
# order j = 0..k-1, as their plain versions do (csrc/moe_kernels.cu), so
# they are held to exact agreement. The MoE model's paths then differ in
# nothing else (the same cuBLAS calls on the same inputs), so answers,
# gradients, losses, metrics and params are held exactly too.
MOE_TOL = 0.0
# the GPT causal LM at GPTConfig's defaults (vocab 32000, 1024 positions,
# hidden 512, 8 heads: head dim 64, 6 layers), batch 8 at the full 1024
# positions: its causal attention runs the flash kernels at B*H 64, S 1024
GPT_BATCH, GPT_SEQ = 8, 1024
GPT_TRAIN_SAMPLES = 64  # fit's epoch: 8 steps of batch 8
GPT_LR = 0.01
# generation: Generator(max_length=1024), 8 prompts of 128 tokens, 128 new
# greedy tokens; every step's logits against the full causal forward of
# the generated tokens, as a fraction of its largest |logit|: f32 sums in
# another order (1e-4, as serving), bf16 the serving bf16 rule (SERVE_TOL)
GEN_PROMPT, GEN_NEW, GEN_MAX_LENGTH = 128, 128, 1024
GEN_TOL = {"float32": 1e-4, "bfloat16": SERVE_TOL["bfloat16"]}
# continuous-batching generation: InferenceEngine.register_generator with
# 8 decode slots, 16-token blocks and max_length 1024 (64 blocks a request,
# 513 in the pool); 32 greedy requests of seeded prompts of 16-512 tokens
# and 16-128 new tokens, submitted in waves of 4 (the wave's first request
# joined before the next wave); 4 of them teacher-forced through the
# PagedDecoder for 8 decode steps against the dense Generator; the
# speculative run drafts 3 tokens a round with the target's first 2 blocks
PAGED_REQUESTS, PAGED_WAVE = 32, 4
PAGED_PROMPT, PAGED_NEW = (16, 512), (16, 128)
PAGED_SLOTS, PAGED_BLOCK = 8, 16
PAGED_TF_REQUESTS, PAGED_TF_STEPS = 4, 8
PAGED_SPEC_K, PAGED_DRAFT = 3, "self:2"
# the BERT proxy at its defaults (hidden 768, 12 heads, 12 layers, seq 128):
# one short fit of 2 steps at batch 8, in f32
BERT_BATCH, BERT_STEPS, BERT_LAYERS = 8, 2, 12
# kernel instances of the backward above head dim 256: dq bf16 at W 144,
# 192, 256 with Q and dO resident and at 256 streamed, f32 at 144, 192,
# 256 streamed; dkv bf16 design (b) at 144 and design (a) at 80 and 128
# resident and 128 streamed, f32 (b) at 144 and (a) at 80 and 128 streamed
WIDE_BWD_INSTANCES = 14
# the rest of the zoo, at FFConfig's default batch of 64: ResNet-50 with
# batch norm (229 px, 1000 classes; SGD 0.01 with momentum 0.9, sparse CE)
# and DLRM at DLRMConfig() (4 tables of 1,000,000 x 64, 1.02 GB of f32;
# SGD 0.01, the MSE loss), each through ZOO_FIT_STEPS steps of fit, eval
# and one served burst, their steps timed; AlexNet (229 px), ResNeXt-50
# (224 px), Inception-v3 (299 px), XDL, CANDLE-Uno and NMT at their
# build functions' defaults, a timed forward and one fit step each
ZOO_BATCH = 64
ZOO_FIT_STEPS = 3
ZOO_LR, ZOO_MOMENTUM = 0.01, 0.9
# every model's pre-softmax forward on the card against the same model and
# weights on this machine's CPU, at batch 2. f32, as a fraction of the
# largest |logit|: TF32 off on both sides, sums in other orders and by
# other algorithms (cuDNN may take Winograd or FFT transforms, which round
# more than a direct sum), through up to 50 layers. bf16: within
# BF16_FLOOR_FACTOR times the CPU bf16 path's distance from the CPU f32 one
ZOO_CHECK_BATCH = 2
ZOO_F32_TOL = 1e-3
# ResNet-50's first batch norm's running statistics after the fit steps
# against a float64 computation of the same batches from the same conv
# weights, as a fraction of the largest statistic. f32: the convolution's
# and the statistics' sums in another order. bf16: the reference rounds
# where the step does (the conv's output, the bias add), but cuDNN's f32
# sums round to other bf16 neighbours at a few elements, and the step
# rounds the batch mean and variance to bf16 (2^-9 of each)
ZOO_STATS_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}
# served answers against one forward of the same rows on the card: the
# same kernels on the same padded batch (a row's answer does not depend
# on the others in eval), so only a different algorithm choice could move
# them
ZOO_SERVE_TOL = 1e-5
# training robustness (phase 13). (a) GPT at GPTConfig() with Adam at
# ROB_ALPHA through one bucketed fit epoch: ROB_ROWS rows whose lengths are
# uniform in ROB_LEN, pow2 buckets from 8, ROB_BUDGET tokens a batch, against
# the same epoch padded to the ladder's top. The two runs compute each
# valid token from the same math; they differ in the sums' lengths (a row's
# masked CE, the weight gradients' products over rows x width) and in the
# cuBLAS kernels the shapes pick, so f32 per-step losses agree to the
# rounding of the forward averaged over thousands of tokens plus the
# params' drift, ROB_LOSS_TOL relative (LOSS_TOL's f32 value). The params
# are held within 2 x ROB_ALPHA x steps: Adam moves a weight whose gradient
# is rounding noise (the attention's key bias, whose exact gradient the
# softmax cancels) by up to ROB_ALPHA a step in either run, so that is as
# close as two Adam runs can be held; the sensitive checks are the losses
# and one step's gradients at the ragged widths against the plain path and
# against the same rows padded to 1024 (GRAD_TOL). bf16: within
# BF16_FLOOR_FACTOR times the bf16 pad-max run's distance from the f32 one
ROB_ALPHA = 1e-3
ROB_ROWS, ROB_LEN, ROB_BUDGET = 128, (16, 1024), 8192
ROB_LOSS_TOL = 1e-4
# (b) the Transformer at TransformerConfig(), batch 8: grad_accum_steps 2 vs 1
# over ROB_ACCUM_STEPS SGD steps (held as the kernels are to the plain path,
# GRAD_TOL of each layer's largest update); steps_per_dispatch 4 with
# prefetch depth 2 vs the serial loop over ROB_MULTI_STEPS steps (equal)
ROB_ACCUM_STEPS, ROB_MULTI_STEPS = 3, 8
# (c) GPT at GPTConfig(), f32, batch 8 at 1024 tokens: the guard over 3
# epochs of 2 steps with a NaN at step ROB_NAN_AT; a child killed at step
# ROB_KILL_AT with checkpoints every ROB_CKPT_INTERVAL steps, resumed over
# ROB_RESUME_EPOCHS epochs of 3 steps
ROB_GUARD_ROWS, ROB_NAN_AT = 16, 3
ROB_RESUME_ROWS, ROB_RESUME_EPOCHS = 24, 3
ROB_CKPT_INTERVAL, ROB_KILL_AT = 2, 5


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

    path, seconds = _build.build()
    _build.load_library()
    nvcc = pathlib.Path(_build.find_nvcc())
    print(f"build: {path.name} in {seconds:.1f} s (nvcc {nvcc})")
    # every kernel instance's registers and stack frame (where spills go),
    # read from the loaded library on every run, whether built now or before
    dump = subprocess.run([str(nvcc.with_name("cuobjdump")), "--dump-resource-usage",
                           str(path)], capture_output=True, text=True, timeout=120, check=True)
    usage, name = {}, None
    for line in dump.stdout.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            usage[name] = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", line)}
            name = None
    check(bool(usage), f"cuobjdump listed no kernel of {path.name}")
    names = list(usage)
    cufilt = nvcc.with_name("cu++filt")
    if cufilt.is_file():  # names for the reader; the checks below use the mangled ones
        shown = subprocess.run([str(cufilt), *names], capture_output=True, text=True,
                               timeout=60, check=True).stdout.splitlines()
        names = shown if len(shown) == len(names) else names
    for label, u in zip(names, usage.values()):
        label = label.split(">(")[0] + ">" if ">(" in label else label  # no argument list
        print(f"  resources: {label}: {u.get('REG')} registers, stack {u.get('STACK')} "
              f"bytes, local {u.get('LOCAL')} bytes")
    # the tensor-core kernels (bf16 and split-TF32 forward, dq and dkv at
    # each padded width) have no stack frame, so no spill, up to the padded
    # width 128
    mma = {(m.group(1), int(m.group(2))): u for mangled, u in usage.items()
           for m in [re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel_(?:mma|tf32x3))"
                               r"ILi(\d+)E", mangled)] if m}
    check(len(mma) == 24, f"cuobjdump listed {sorted(mma)} of the 24 tensor-core instances")
    spills = {k: u for k, u in mma.items()
              if k[1] <= 128 and (u.get("STACK", 1) or u.get("LOCAL", 1))}
    check(not spills, f"tensor-core kernels spill at width <= 128: {spills}")
    # the tensor-core forward above head dim 256, bf16 and split TF32, at
    # each group width (its first template argument), Q resident (the last)
    # or streamed
    wide = {(m.group(1), tuple(int(a) for a in re.findall(r"L[ib](\d+)E", m.group(2)))): u
            for mangled, u in usage.items()
            for m in [re.search(r"(flash_fwd_kernel_wide_(?:mma|tf32x3))I((?:L[ib]\d+E)+)",
                                mangled)] if m}
    check(len(wide) == 12, f"cuobjdump listed {sorted(wide)} of the 12 wide forward instances")
    for (kern, args), u in sorted(wide.items()):
        print(f"  wide forward {kern}<{', '.join(map(str, args))}>: {u.get('REG')} registers, "
              f"stack {u.get('STACK')} bytes, local {u.get('LOCAL')} bytes")
    # the tensor-core backward above head dim 256 (csrc/flash_attention_bwd_wide.cu),
    # bf16 and split TF32: dq at group widths 144/192/256 (bf16: Q and dO
    # resident, and streamed past 512 columns), dkv by design, width and
    # residency (WIDE_BWD_INSTANCES)
    wide_bwd = {(m.group(1), tuple(int(a) for a in re.findall(r"L[ib](\d+)E", m.group(2)))): u
                for mangled, u in usage.items()
                for m in [re.search(r"(flash_bwd_(?:dq|dkv)_kernel_wide_(?:mma|tf32x3))"
                                    r"I((?:L[ib]\d+E)+)", mangled)] if m}
    check(len(wide_bwd) == WIDE_BWD_INSTANCES,
          f"cuobjdump listed {sorted(wide_bwd)} of the {WIDE_BWD_INSTANCES} wide backward "
          f"instances")
    for (kern, args), u in sorted(wide_bwd.items()):
        print(f"  wide backward {kern}<{', '.join(map(str, args))}>: {u.get('REG')} "
              f"registers, stack {u.get('STACK')} bytes, local {u.get('LOCAL')} bytes")
    sys.stdout.flush()


def attention_pairs(causal: bool, sq: int, skv: int) -> int:
    """(query, key) pairs attention computes: all of them, or under the
    top-left causal mask the pairs with key <= query."""
    if not causal:
        return sq * skv
    full = min(sq, skv)  # rows 0..full-1 see row + 1 keys, later rows all skv
    return full * (full + 1) // 2 + (sq - full) * skv


def attention_flops(causal: bool, products: int, bh: int = BATCH * HEADS, s: int = SEQ,
                    d: int = HEAD_DIM, skv: int = None) -> float:
    """Operations of ``products`` (sq x d) by (d x skv) matrix products at
    one shape (causal: only the pairs the mask keeps); skv defaults to s."""
    return 2.0 * products * bh * attention_pairs(causal, s, s if skv is None else skv) * d


def attention_bound(dtype: torch.dtype, causal: bool, products: int, q_tensors: int,
                    kv_tensors: int, vectors: int, bh: int = BATCH * HEADS, s: int = SEQ,
                    d: int = HEAD_DIM, skv: int = None) -> tuple:
    """(bound_ms, bound_by) of attention work at one shape: the larger of
    the bytes it must move (``q_tensors`` (bh, s, d) and ``kv_tensors``
    (bh, skv, d) tensors of the type and ``vectors`` (bh, s) f32 vectors
    such as lse, each read or written once) over HBM bandwidth and the
    operations of ``products`` products over the peak for the type."""
    skv = s if skv is None else skv
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (q_tensors * s + kv_tensors * skv) * bh * d * elem + vectors * bh * s * 4
    t_ops = attention_flops(causal, products, bh, s, d, skv) / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_core_ms(causal: bool, products: int) -> float:
    """The operations bound of ``products`` f32 products at the slice shape
    at the CUDA cores' peak, the f32 bound of earlier runs."""
    return attention_flops(causal, products) / CUDA_CORE_F32_FLOPS * 1e3


# (products, (bh, sq, d) tensors, (bh, skv, d) tensors, (bh, sq) f32
# vectors) of each function: the forward does S = QK^T and PV over q, o, k,
# v and lse; the gradient needs S, dP, dQ, dK, dV over q, o, g, dq, k, v,
# dk, dv and lse. As designed the dq kernel recomputes S and dP (3
# products; reads q, o, g, k, v, lse, writes dq and delta) and the dkv
# kernel too (4 products; reads q, g, k, v, lse and delta in place of O,
# writes dk and dv), in both dtypes.
WORK = {"fwd": (2, 2, 2, 1), "bwd": (5, 4, 4, 1), "dq": (3, 4, 2, 2), "dkv": (4, 2, 4, 2)}


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def check_fwd(fa, q, k, v, causal: bool, scale: float, what: str) -> tuple:
    """The forward kernel against its plain version: (out, lse, errors,
    the out tolerance: absolute in f32, of the largest |out| in bf16)."""
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    torch.cuda.synchronize()
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    tol = KERNEL_TOL[q.dtype]
    out_tol = tol["out"] * (ref_out.float().abs().max().item()
                            if q.dtype == torch.bfloat16 else 1.0)
    check(torch.isfinite(out.float()).all().item() and torch.isfinite(lse).all().item(),
          f"{what}: non-finite forward output")
    check(err_out <= out_tol and err_lse <= tol["lse"],
          f"{what}: forward vs plain out err {err_out} (tol {out_tol}) lse err {err_lse} "
          f"(tol {tol['lse']})")
    return out, lse, {"out": err_out, "lse": err_lse}, out_tol


# the forward kernel of each dtype: bf16 products in bf16, split TF32
# products in f32, both on the tensor cores; above head dim 256 the wide
# forward (csrc/flash_attention_fwd_wide.cu)
FWD_KERNEL = {torch.float32: "flash_fwd_kernel_tf32x3", torch.bfloat16: "flash_fwd_kernel_mma"}
WIDE_FWD_KERNEL = {torch.float32: "flash_fwd_kernel_wide_tf32x3",
                   torch.bfloat16: "flash_fwd_kernel_wide_mma"}


def fwd_kernel_ms(fn, dtype: torch.dtype, what: str, iters: int = 10,
                  d: int = HEAD_DIM) -> float:
    """Device ms a call of ``fn`` spends in the forward kernel, by the
    profiler's kernel names; fails unless the dtype's tensor-core kernel
    for head dim ``d`` ran (FWD_KERNEL, WIDE_FWD_KERNEL above 256) and no
    other forward kernel."""
    want = (FWD_KERNEL if d <= 256 else WIDE_FWD_KERNEL)[dtype]
    spans = [(n, ms) for n, ms in device_spans(fn, iters) if "flash_fwd" in n]
    names = {n for n, _ in spans}
    check(bool(names) and all(want in n for n in names),
          f"{what}: the forward ran {names}, want only {want}")
    return sum(ms for _, ms in spans) / iters


def check_fwd_route(breakdown: dict, compute_dtype: str, what: str) -> None:
    """A profiled window ran the dtype's tensor-core forward (bf16 products
    in bf16, split TF32 ones in f32) and no other forward kernel."""
    by_class = breakdown["device_ms_by_class"]
    want = {"bfloat16": "flash_attention_fwd_mma",
            "float32": "flash_attention_fwd_tf32x3"}[compute_dtype]
    fwd = {c: by_class[c] for c, _ in FWD_CLASSES}
    check(fwd[want] > 0 and all(ms == 0 for c, ms in fwd.items() if c != want),
          f"{what}: forward device ms by kernel {fwd}, want only {want}")


def bwd_kernel_ms(fn, dtype: torch.dtype, what: str, iters: int = 10,
                  d: int = HEAD_DIM) -> dict:
    """Device ms a call of ``fn`` spends in the dq and the dkv kernel, by
    the profiler's kernel names; fails unless both ran on the tensor cores,
    bf16 products in bf16 (flash_bwd_*_kernel_mma, above head dim 256
    flash_bwd_*_kernel_wide_mma) and split TF32 products in f32
    (flash_bwd_*_kernel_tf32x3, flash_bwd_*_kernel_wide_tf32x3), and no
    other backward kernel."""
    spans = [(n, ms) for n, ms in device_spans(fn, iters) if "flash_bwd" in n]
    check_bwd_route({n for n, _ in spans}, dtype, what, d)
    total = {kern: sum(ms for n, ms in spans if f"flash_bwd_{kern}_kernel" in n) / iters
             for kern in ("dq", "dkv")}
    check(all(v > 0 for v in total.values()), f"{what}: profiler saw {total}")
    return total


def check_bwd_route(names: set, dtype: torch.dtype, what: str, d: int = HEAD_DIM) -> None:
    """The backward kernels that ran are the tensor-core ones of the dtype
    and head dim: ``_mma`` in bf16, the split-TF32 ``_tf32x3`` in f32,
    ``_wide_`` above head dim 256 (csrc/flash_attention_bwd_wide.cu); both
    dq and dkv ran, and no other backward kernel."""
    kind = "_kernel_wide_" if d > 256 else "_kernel_"
    want = kind + ("mma" if dtype == torch.bfloat16 else "tf32x3")
    check(bool(names) and all(want in n for n in names)
          and all(any(f"flash_bwd_{kern}{want}" in n for n in names) for kern in ("dq", "dkv")),
          f"{what}: the backward ran {names}, want only flash_bwd_{{dq,dkv}}{want}")


def check_bwd(fa, q, k, v, o, g, lse, causal: bool, scale: float, what: str) -> dict:
    """The backward kernels against their plain version: the max abs error
    of dq, dk and dv, each within BWD_TOL of its largest element."""
    got = fa.flash_attention_bwd(q, k, v, o, g, lse, causal, scale)
    want = fa.flash_attention_bwd_reference(q, k, v, o, g, lse, causal, scale)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        err, big = (a - b).abs().max().item(), b.abs().max().item()
        check(torch.isfinite(a).all().item(), f"{what}: non-finite {name}")
        check(err <= BWD_TOL[q.dtype] * big,
              f"{what}: {name} vs plain err {err:.3g} > {BWD_TOL[q.dtype]} of {big:.3g}")
        errs[name] = err
        errs[f"{name}_largest"] = big
    return errs


def as_bhsd(t: torch.Tensor, heads: int) -> torch.Tensor:
    """A (B, H, S, D) view of a (B*H, S, D) tensor for
    scaled_dot_product_attention."""
    return t.view(t.shape[0] // heads, heads, *t.shape[1:])


def sdpa_bwd_ms(F, q, k, v, g, causal: bool, scale: float, heads: int = HEADS) -> float:
    """scaled_dot_product_attention's backward: the device time of its
    forward+backward less that of its forward, on (B, H, S, D) views of the
    same tensors (a loop of autograd calls is bound by the host, so CUDA
    events around it would time the host)."""
    leaves = [as_bhsd(t, heads).detach().requires_grad_(True) for t in (q, k, v)]
    g4 = as_bhsd(g, heads)

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal, scale=scale)

    return (device_ms(lambda: torch.autograd.grad(fwd(), leaves, g4))
            - device_ms(fwd))


def phase_kernels() -> dict:
    """Every kernel at the slice shape (B*H = 128, S = 512, D = 64), both
    dtypes, causal and not; then the ragged and repaired cases. Returns
    {"fwd": rows, "dq": rows, "dkv": rows, "cases": rows}."""
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import flash_attention as fa

    rows = {"fwd": [], "dq": [], "dkv": [], "cases": []}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    scale = HEAD_DIM ** -0.5
    shape = (BATCH * HEADS, SEQ, HEAD_DIM)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                      for _ in range(4))
        q4, k4, v4 = (as_bhsd(t, HEADS) for t in (q, k, v))
        for causal in (False, True):
            name = f"{_name(dtype)} causal={causal}"
            out, lse, ferr, out_tol = check_fwd(fa, q, k, v, causal, scale, name)
            fwd = lambda: fa.flash_attention_fwd(q, k, v, causal, scale)  # noqa: E731
            # each block owns its output rows: two runs agree bit for bit
            first, second = fwd(), fwd()
            fwd_bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
            check(fwd_bitwise, f"{name}: two runs of the forward differ")
            del first, second
            # device time by the profiler: in bf16 a call's host work (checks,
            # allocation, the ctypes call) outlasts the kernel, so CUDA events
            # around a loop of calls time the host; they are printed beside it
            ms = fwd_kernel_ms(fwd, dtype, name, 20)
            event_ms = time_ms(fwd, 20)
            tflops = attention_flops(causal, WORK["fwd"][0]) / ms / 1e9
            plain_ms = time_ms(
                lambda: fa.flash_attention_fwd_reference(q, k, v, causal, scale), 10)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, is_causal=causal, scale=scale)
            library_ms, library_event_ms = device_ms(sdpa), time_ms(sdpa, 20)
            bound_ms, bound_by = attention_bound(dtype, causal, *WORK["fwd"])
            tol = KERNEL_TOL[dtype]
            rows["fwd"].append(dict(
                dtype=_name(dtype), causal=causal, max_abs_err=ferr["out"],
                lse_max_abs_err=ferr["lse"], tolerance=out_tol,
                lse_tolerance=tol["lse"], ms=ms, event_ms=event_ms, tflops=tflops,
                plain_ms=plain_ms, library_ms=library_ms, library_event_ms=library_event_ms,
                bound_ms=bound_ms, bound_by=bound_by, bitwise_equal_runs=fwd_bitwise))
            print(f"kernel flash_attention_fwd {name} shape {shape}: out err "
                  f"{ferr['out']:.3g} (tol {out_tol:.3g}) lse err {ferr['lse']:.3g} (tol "
                  f"{tol['lse']}); kernel {ms:.4f} ms on the device "
                  f"({'bf16' if dtype == torch.bfloat16 else 'split TF32'} on the tensor cores; "
                  f"{event_ms:.4f} ms a call by events), {tflops:.1f} TFLOP/s, plain "
                  f"{plain_ms:.4f} ms, "
                  f"sdpa {library_ms:.4f} ms on the device ({library_event_ms:.4f} by "
                  f"events; kernel {ms / library_ms:.2f}x), bound {bound_ms:.4f} ms "
                  f"({bound_by}"
                  + (f"; CUDA cores {cuda_core_ms(causal, WORK['fwd'][0]):.4f} ms"
                     if dtype == torch.float32 else "")
                  + f"), {bound_ms / ms:.1%} of bound; two runs bitwise equal",
                  flush=True)

            berr = check_bwd(fa, q, k, v, out, g, lse, causal, scale, name)
            bwd = lambda: fa.flash_attention_bwd(q, k, v, out, g, lse, causal, scale)  # noqa: E731
            # each kernel owns its output tiles: two runs agree bit for bit
            first, second = bwd(), bwd()
            bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
            check(bitwise, f"{name}: two runs of the backward pair differ")
            del first, second
            pair_ms = time_ms(bwd, 20)
            split = bwd_kernel_ms(bwd, dtype, name)
            pair_plain_ms = time_ms(lambda: fa.flash_attention_bwd_reference(
                q, k, v, out, g, lse, causal, scale), 5)
            pair_library_ms = sdpa_bwd_ms(F, q, k, v, g, causal, scale)
            pair_bound_ms, pair_bound_by = attention_bound(dtype, causal, *WORK["bwd"])
            f32 = dtype == torch.float32
            for kern, errs in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
                products = WORK[kern][0]
                kbound, kby = attention_bound(dtype, causal, *WORK[kern])
                kms = split[kern]
                ktflops = attention_flops(causal, products) / kms / 1e9
                rows[kern].append(dict(
                    dtype=_name(dtype), causal=causal,
                    max_abs_err=max(berr[e] for e in errs),
                    largest_grad=max(berr[f"{e}_largest"] for e in errs),
                    tolerance=BWD_TOL[dtype], ms=kms, bound_ms=kbound, bound_by=kby,
                    tflops=ktflops, pair_ms=pair_ms, plain_ms=pair_plain_ms,
                    library_ms=pair_library_ms, pair_bound_ms=pair_bound_ms,
                    pair_bound_by=pair_bound_by, bitwise_equal_runs=bitwise,
                    cuda_core_bound_ms=cuda_core_ms(causal, products) if f32 else None))
                err_text = ", ".join(
                    f"{e} {berr[e]:.3g} of {berr[e + '_largest']:.3g}" for e in errs)
                old_bound = (f" (CUDA cores {cuda_core_ms(causal, products):.4f} ms)"
                             if f32 else "")
                print(f"kernel flash_attention_bwd_{kern} {name} shape {shape}: "
                      f"err {err_text} (tol {BWD_TOL[dtype]:.3g} of the largest); "
                      f"kernel {kms:.4f} ms ({'split TF32' if f32 else 'bf16'} on the tensor "
                      f"cores), {ktflops:.1f} TFLOP/s on its {products} products, bound "
                      f"{kbound:.4f} ms ({kby}){old_bound}, {kbound / kms:.1%} of bound",
                      flush=True)
            tf7 = attention_flops(causal, WORK["dq"][0] + WORK["dkv"][0])
            tf5 = attention_flops(causal, WORK["bwd"][0])
            print(f"kernel flash_attention_bwd pair {name} shape {shape}: dq+dkv "
                  f"{pair_ms:.4f} ms ({tf7 / pair_ms / 1e9:.1f} TFLOP/s on the 7 products "
                  f"as designed, {tf5 / pair_ms / 1e9:.1f} on the function's 5), plain "
                  f"{pair_plain_ms:.4f} ms, sdpa backward {pair_library_ms:.4f} ms "
                  f"({pair_ms / pair_library_ms:.2f}x), bound {pair_bound_ms:.4f} ms "
                  f"({pair_bound_by}"
                  + (f"; CUDA cores {cuda_core_ms(causal, WORK['bwd'][0]):.4f} ms"
                     if dtype == torch.float32 else "")
                  + f"), {pair_bound_ms / pair_ms:.1%} of bound; two runs "
                  f"bitwise equal", flush=True)

    # ragged lengths (S 200; Sq != Skv at 10 and 37, lengths no multiple
    # of 8, which the attention op takes) and the repaired limits: any D <=
    # 256 and any B*H (causal), then D above 256 through the wide kernels,
    # once at the ragged lengths
    rows["cases"] = kernel_cases(F, fa, gen, [
        (dtype, bh, s, d, True) for dtype in (torch.float32, torch.bfloat16)
        for bh, s, d in ((BATCH * HEADS, 200, HEAD_DIM), (BATCH * HEADS, (10, 37), HEAD_DIM),
                         (BATCH * HEADS, (37, 10), HEAD_DIM), (BATCH * HEADS, SEQ, 96),
                         (BATCH * HEADS, SEQ, 256), (65536 + 8, 16, 32))])
    rows["cases"] += kernel_cases(F, fa, gen, [
        (dtype, BATCH * HEADS, s, d, causal) for dtype in (torch.float32, torch.bfloat16)
        for s, d, causal in ((SEQ, 264, False), (SEQ, 264, True), (SEQ, 512, False),
                             (SEQ, 512, True), ((37, 10), 264, True))])
    # GPT's attention shape: causal, B*H 64, S 1024, D 64 (GPTConfig's
    # defaults at batch 8), the shape its training and full-sequence
    # forward give the kernels
    rows["gpt_cases"] = kernel_cases(F, fa, gen, [
        (dtype, GPT_BATCH * 8, GPT_SEQ, 64, True) for dtype in (torch.float32, torch.bfloat16)])
    return rows


def kernel_cases(F, fa, gen, cases) -> list:
    """One ``kernel case`` line per (dtype, B*H, S, D, causal), S a length
    or (Sq, Skv): forward and backward against the plain version, each
    timed beside the plain version, SDPA (top-left causal, as the kernels)
    and the bound. Kernel and SDPA times are device time by the profiler
    (at the smaller cases a call's host work outlasts its kernels), which
    shows which forward and which backward kernels ran at every D; the
    plain versions' by CUDA events. SDPA gets (B*H / 8, 8, S, D)
    views: its kernels put B and H on grid dimensions that stop at
    65535."""
    rows = []
    for dtype, bh, s, d, causal in cases:
        sq, skv = s if isinstance(s, tuple) else (s, s)
        q, g = (torch.randn((bh, sq, d), generator=gen, device=DEVICE).to(dtype)
                for _ in range(2))
        k, v = (torch.randn((bh, skv, d), generator=gen, device=DEVICE).to(dtype)
                for _ in range(2))
        sc = d ** -0.5
        shown = s if sq == skv else f"{sq}x{skv}"
        name = f"{_name(dtype)} causal={causal} B*H={bh} S={shown} D={d}"
        out, lse, ferr, _ = check_fwd(fa, q, k, v, causal, sc, name)
        berr = check_bwd(fa, q, k, v, out, g, lse, causal, sc, name)
        q4, k4, v4 = (as_bhsd(t, 8) for t in (q, k, v))
        fwd = lambda: fa.flash_attention_fwd(q, k, v, causal, sc)  # noqa: E731
        bwd = lambda: fa.flash_attention_bwd(q, k, v, out, g, lse, causal, sc)  # noqa: E731
        shape = dict(bh=bh, s=sq, d=d, skv=skv)
        # dq and dkv device ms, the profiler showing the dtype's tensor-core
        # kernels for the head dim ran
        split = bwd_kernel_ms(bwd, dtype, name, d=d)
        case = dict(
            fwd_ms=fwd_kernel_ms(fwd, dtype, name, d=d),
            fwd_plain_ms=time_ms(
                lambda: fa.flash_attention_fwd_reference(q, k, v, causal, sc), 3),
            fwd_library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=sc), 10),
            fwd_bound_ms=attention_bound(dtype, causal, *WORK["fwd"], **shape)[0],
            bwd_ms=split["dq"] + split["dkv"],
            dq_ms=split["dq"], dkv_ms=split["dkv"],
            dq_bound_ms=attention_bound(dtype, causal, *WORK["dq"], **shape)[0],
            dkv_bound_ms=attention_bound(dtype, causal, *WORK["dkv"], **shape)[0],
            bwd_plain_ms=time_ms(lambda: fa.flash_attention_bwd_reference(
                q, k, v, out, g, lse, causal, sc), 3),
            bwd_library_ms=sdpa_bwd_ms(F, q, k, v, g, causal, sc, heads=8),
            bwd_bound_ms=attention_bound(dtype, causal, *WORK["bwd"], **shape)[0])
        rows.append(dict(dtype=_name(dtype), bh=bh, s=sq, skv=skv, d=d, causal=causal,
                         fwd_err=ferr, bwd_err=berr, **case))
        print(f"kernel case {name}: out err {ferr['out']:.3g}, dq/dk/dv err "
              f"{berr['dq']:.3g}/{berr['dk']:.3g}/{berr['dv']:.3g}; " + "; ".join(
                  f"{p} {case[p + '_ms']:.4f} ms, plain {case[p + '_plain_ms']:.4f}, "
                  f"sdpa {case[p + '_library_ms']:.4f} "
                  f"({case[p + '_ms'] / case[p + '_library_ms']:.2f}x sdpa), bound "
                  f"{case[p + '_bound_ms']:.4f} "
                  f"({case[p + '_bound_ms'] / case[p + '_ms']:.1%} of bound)"
                  for p in ("fwd", "bwd"))
              + f"; dq {case['dq_ms']:.4f} ms (bound {case['dq_bound_ms']:.4f}), dkv "
              f"{case['dkv_ms']:.4f} ms (bound {case['dkv_bound_ms']:.4f})", flush=True)
    return rows


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


# kernel classes of a profiled window: (class, test on the kernel's name);
# the forward by kernel: split TF32 (f32), bf16, each above head dim 256,
# any other
FWD_CLASSES = (
    ("flash_attention_fwd_tf32x3", lambda n: "flash_fwd_kernel_tf32x3" in n),
    ("flash_attention_fwd_mma", lambda n: "flash_fwd_kernel_mma" in n),
    ("flash_attention_fwd_wide_tf32x3", lambda n: "flash_fwd_kernel_wide_tf32x3" in n),
    ("flash_attention_fwd_wide_mma", lambda n: "flash_fwd_kernel_wide_mma" in n),
    ("flash_attention_fwd", lambda n: "flash_fwd" in n),
)
SERVE_CLASSES = FWD_CLASSES + (
    ("gemm", lambda n: any(w in n.lower() for w in ("gemm", "xmma", "cutlass", "nvjet"))),
    ("memcpy", lambda n: "memcpy" in n.lower()),
)
TRAIN_CLASSES = FWD_CLASSES + (
    ("flash_attention_bwd_dq", lambda n: "flash_bwd_dq_kernel" in n),
    ("flash_attention_bwd_dkv", lambda n: "flash_bwd_dkv_kernel" in n),
    ("gemm", lambda n: any(w in n.lower() for w in ("gemm", "xmma", "cutlass", "nvjet"))),
    ("memcpy", lambda n: "memcpy" in n.lower()),
)


def profile_breakdown(fn, classes, other: str = "other") -> dict:
    """Where the time of one call of ``fn`` goes: the host's wall time, the
    device's busy time by kernel class (torch.profiler; a kernel no class
    claims counts as ``other``) and the device's idle share."""
    from torch.profiler import ProfilerActivity

    events, wall_ms = device_events(fn, 1, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events]
    by_class = {name: 0.0 for name, _ in classes}
    by_class[other] = 0.0
    by_name: dict = {}
    for name, start, end in spans:
        cls = next((c for c, test in classes if test(name)), other)
        by_class[cls] += (end - start) / 1e3
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (end - start) / 1e3
    busy_us, last_end = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda t: t[1]):
        busy_us += max(0.0, end - max(start, last_end))
        last_end = max(last_end, end)
    busy_ms = busy_us / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "device_ops": len(spans),
            "device_ms_by_class": by_class,
            "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])}


def device_events(fn, iters: int, activities) -> tuple:
    """(the device's events, host ms) of ``iters`` calls of ``fn`` under
    torch.profiler. A session now and then records no device event at all
    (three in a row once, in the kernel cases), so up to five are tried,
    half a second apart, before the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    for attempt in range(5):
        if attempt:
            time.sleep(0.5)
        torch.cuda.synchronize()
        with profile(activities=list(activities)) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            return events, wall_ms
    raise SmokeFailure("profiler saw no device time in five sessions")


def device_spans(fn, iters: int) -> list:
    """(kernel name, device ms) of every kernel and copy that ``iters`` warm
    calls of ``fn`` run, by torch.profiler."""
    from torch.profiler import ProfilerActivity

    fn()
    events, _ = device_events(fn, iters, (ProfilerActivity.CUDA,))
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in events]


def kernel_ms_by_name(fn, names, iters: int = 10) -> dict:
    """Mean device time per call of ``fn`` of each kernel whose name holds
    one of ``names``."""
    spans = device_spans(fn, iters)
    total = {n: sum(ms for name, ms in spans if n in name) / iters for n in names}
    check(all(v > 0 for v in total.values()), f"profiler saw none of {names}: {total}")
    return total


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of ``fn``, without the host's launch gaps."""
    return sum(ms for _, ms in device_spans(fn, iters)) / iters


def phase_serving(compute_dtype: str, params, card: str, plain_f32: np.ndarray = None):
    """Serve REQUESTS single-sample requests through InferenceEngine with
    the flash launch count reset just before and read just after; hold the
    answers against the plain attention path. ``plain_f32``: the float32
    run's plain-path answers, from which the bfloat16 run records how far
    its own plain path lands. Returns (row, params, plain-path answers)."""
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
        counts = kernels.launch_counts()
        launches = counts["flash_attention_fwd"]
    finally:
        engine.stop()
    dispatches = inst.dispatches - d0
    wall = max(t_done) - t0
    lat_ms = np.array([(t_done[i] - t_submit[i]) * 1e3 for i in range(REQUESTS)])
    check(launches == n_attn * dispatches,
          f"flash kernel launched {launches} times for {dispatches} forward "
          f"dispatches (want {n_attn} per dispatch)")
    check(all(counts[name] == 0 for name in kernels.KERNELS
              if name != "flash_attention_fwd"),
          f"backward or MoE kernels launched while serving: {counts}")

    got = np.stack(answers)
    check(got.shape == (REQUESTS, cfg.sequence_length, 1),
          f"answers of shape {got.shape}")
    check(bool(np.isfinite(got).all()), "non-finite answers")
    xdev = torch.from_numpy(xs[:BATCH]).to(cm.device)
    forward_ms = time_ms(lambda: cm.forward_fn(cm.params, xdev), 5)
    breakdown = profile_breakdown(lambda: inst.infer([xs[:BATCH]]), SERVE_CLASSES)
    check_fwd_route(breakdown, compute_dtype, f"serving {compute_dtype}")
    refs = []
    for lo in range(0, REQUESTS, BATCH):
        x = torch.from_numpy(xs[lo:lo + BATCH]).to(cm.device)
        refs.append(cm.forward_fn(cm.params, x, plain_kernels=True).cpu().numpy())
    ref = np.concatenate(refs)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max()) / scale
    # the plain bf16 path's distance from the plain f32 path, as a fraction
    # of the largest f32 answer (recorded, as training's bf16 floor is)
    floor = (None if plain_f32 is None else
             float(np.abs(ref - plain_f32).max() / np.abs(plain_f32).max()))
    check(scale > 0 and err <= SERVE_TOL[compute_dtype],
          f"{compute_dtype}: answers vs plain path: {err:.3g} of the largest "
          f"answer ({scale:.3g}) > {SERVE_TOL[compute_dtype]}")
    row = dict(compute_dtype=compute_dtype, requests=REQUESTS,
               dispatches=dispatches, launches=launches,
               requests_per_s=REQUESTS / wall,
               p50_ms=float(np.percentile(lat_ms, 50)),
               p99_ms=float(np.percentile(lat_ms, 99)),
               rel_err_vs_plain=err, answer_scale=scale, bf16_floor=floor,
               served_ms_per_dispatch=wall * 1e3 / dispatches,
               forward_device_ms=forward_ms,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               breakdown=breakdown)
    print(f"serving {compute_dtype}: {REQUESTS} requests in {dispatches} "
          f"dispatches, {launches} flash launches; {row['requests_per_s']:.2f} "
          f"req/s, p50 {row['p50_ms']:.1f} ms, p99 {row['p99_ms']:.1f} ms; "
          f"max err vs plain path {err:.3g} of the largest answer "
          f"({scale:.3g}){'' if floor is None else f', plain path vs plain f32 {floor:.3g}'}"
          f"; forward {forward_ms:.2f} ms on device vs "
          f"{row['served_ms_per_dispatch']:.2f} ms served per dispatch "
          f"[{card}]", flush=True)
    print(f"dispatch breakdown {compute_dtype}: {json.dumps(breakdown)}",
          flush=True)
    print("serving_json " + json.dumps(row), flush=True)
    return row, params, ref


def layer_err(got: dict, want: dict, start: dict = None, ulps: int = 0) -> tuple:
    """(max error, weight) of two param-shaped trees, each weight's max abs
    error as a fraction of the largest element of its layer in ``want``
    (less ``start``, when given: then the layer's largest update). By
    layer, not by weight: the key bias bk adds q.bk to every logit of a
    row, which the softmax cancels, so its exact gradient is 0 and any two
    paths give rounding noise that no scale of its own can measure.
    ``ulps``: for params after that many updates, each element's error
    counts past that many f32 ulps of its value. Each update rounds the
    param once, and two paths whose updates differ at all may round it
    apart; a LayerNorm scale sits near 1, where one ulp (1.2e-7) can be a
    large share of a few small updates."""
    worst, where = 0.0, ""
    for op, ws in want.items():
        dev = next(iter(got[op].values())).device
        ws = {w: t.to(dev) for w, t in ws.items()}
        ref = {w: (t - start[op][w].to(dev) if start else t) for w, t in ws.items()}
        big = max(r.abs().max().item() for r in ref.values())
        for w, t in ws.items():
            check(bool(torch.isfinite(got[op][w]).all()), f"non-finite {op}.{w}")
            diff = (got[op][w] - t).abs()
            if ulps:
                diff = (diff - ulps * torch.finfo(torch.float32).eps * t.abs()).clamp_min(0)
            err = diff.max().item() / (big if big > 0 else 1.0)
            if err >= worst:
                worst, where = err, f"{op}.{w}"
    return worst, where


def timed_steps(step, rounds: int) -> tuple:
    """(each step's ms, each round's median ms, peak GiB) of ``rounds``
    rounds of TIMED_STEPS calls of ``step``, each timed by CUDA events
    around it (host gaps included: they are part of the step)."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    # earlier phases' models may wait on reference cycles; collect them so
    # the peak counts only what this model's steps hold
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    step_ms, round_medians = [], []
    for _ in range(rounds):
        ms = []
        for _ in range(TIMED_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        round_medians.append(float(np.median(ms)))
        step_ms += ms
    return step_ms, round_medians, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_training(compute_dtype: str, params: dict, card: str, ref: dict = None) -> tuple:
    """Train the reference Transformer at full width through FFModel.compile
    -> grad_step/train_step/fit, against the plain kernels' path. ``ref``:
    the float32 run's plain-path gradients and params, which set the
    bfloat16 run's tolerances. Returns (row, this run's ``ref``)."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType, MetricsType,
                                    SGDOptimizer, kernels, load_numpy_params)
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer

    cfg = TransformerConfig()
    ff = FFModel(FFConfig(batch_size=BATCH, compute_dtype=compute_dtype, seed=SEED,
                          device=DEVICE))
    build_transformer(ff, BATCH, cfg)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               metrics=[MetricsType.MEAN_SQUARED_ERROR])
    cm = ff.compiled
    n_attn = sum(op.op_type.name == "MULTIHEAD_ATTENTION" for op in cm.ops)
    check(n_attn == cfg.num_layers, f"{n_attn} attention ops, want {cfg.num_layers}")
    # the model's own init (Glorot, zero biases), as bench.py trains it
    own_init = {op: {w: t.detach().cpu().numpy().copy() for w, t in ws.items()}
                for op, ws in cm.params.items()}
    own_dev = {op: {w: t.detach().clone() for w, t in ws.items()}
               for op, ws in cm.params.items()}
    rng = np.random.default_rng(SEED + 2)
    x = rng.standard_normal(size=(TRAIN_SAMPLES, cfg.sequence_length, cfg.hidden_size),
                            dtype=np.float32)
    y = rng.standard_normal(size=(TRAIN_SAMPLES, cfg.sequence_length, 1), dtype=np.float32)
    batches = [tuple(torch.from_numpy(a[i * BATCH:(i + 1) * BATCH]).to(cm.device)
                     for a in (x, y)) for i in range(5)]

    def reset(tree):
        load_numpy_params(ff, tree)
        cm.opt_state = cm.optimizer.init_state(cm.params)

    # (a) one grad_step's gradients, kernels vs plain versions, at the
    # variance-preserving random params, where every layer's attention
    # sees inputs of unit scale
    reset(params)
    g_kern = cm.grad_step(cm.params, None, *batches[0])
    g_plain = cm.grad_step(cm.params, None, *batches[0], plain_kernels=True)
    grad_err, grad_worst = layer_err(g_kern, g_plain)
    if ref is None:
        grad_floor, grad_tol = None, GRAD_TOL
    else:
        grad_floor = layer_err(g_plain, ref["grads"])[0]
        grad_tol = BF16_FLOOR_FACTOR * grad_floor
    check(grad_err <= grad_tol,
          f"{compute_dtype}: grads vs plain path: {grad_err:.3g} of the largest "
          f"gradient of {grad_worst}'s layer > {grad_tol:.3g}")
    del g_kern

    # (b) five train_steps on each path from the model's own init. At lr
    # 0.01 the random params above diverge (two steps from them are
    # recorded here), and scaled down far enough to stay finite they lose
    # the stack's output to the first update, as the Glorot init does
    # from the start
    random_losses = []
    for xb, yb in batches[:2]:
        cm.params, cm.opt_state, loss, _ = cm.train_step(cm.params, cm.opt_state,
                                                         None, xb, yb)
        random_losses.append(loss.item())
    losses, final = {}, {}
    for plain in (False, True):
        reset(own_init)
        losses[plain] = []
        for xb, yb in batches:
            cm.params, cm.opt_state, loss, _ = cm.train_step(
                cm.params, cm.opt_state, None, xb, yb, plain_kernels=plain)
            losses[plain].append(loss.item())
        final[plain] = {op: {w: t.clone() for w, t in ws.items()}
                        for op, ws in cm.params.items()}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses[False], losses[True]))
    check(all(np.isfinite(losses[False] + losses[True])),
          f"{compute_dtype}: non-finite losses {losses}")
    check(loss_err <= LOSS_TOL[compute_dtype],
          f"{compute_dtype}: losses {losses[False]} vs plain path {losses[True]}: "
          f"{loss_err:.3g} > {LOSS_TOL[compute_dtype]}")
    # the params the two paths reached, against the layer's largest update:
    # the loss barely sees the deep layers' attention from this init, the
    # f32 updates do. In bf16 rounding outweighs the deep layers' tiny
    # updates from this init (the plain bf16 path lands more than a whole
    # update from the plain f32 one), so there it is recorded, not held.
    update_err, update_worst = layer_err(final[False], final[True], own_dev)
    if ref is None:
        update_floor = None
        check(update_err <= GRAD_TOL,
              f"{compute_dtype}: params after 5 steps vs plain path: {update_err:.3g} "
              f"of the largest update of {update_worst}'s layer > {GRAD_TOL}")
    else:
        update_floor = layer_err(final[True], ref["final"], own_dev)[0]
    # the plain path's results leave the card, so they do not count in the
    # peak memory below
    host = lambda tree: {op: {w: t.cpu() for w, t in ws.items()}  # noqa: E731
                         for op, ws in tree.items()}
    this_ref = {"grads": host(g_plain), "final": host(final[True])}
    del g_plain, final, own_dev

    # (c) fit through the entry point, launch counts read just around it
    reset(own_init)
    steps = TRAIN_SAMPLES // BATCH
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hist = ff.fit(x, y, batch_size=BATCH, epochs=1, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {name: n_attn * steps if name in kernels.FLASH_KERNELS else 0
            for name in kernels.KERNELS}
    check(launches == want,
          f"{compute_dtype}: fit's {steps} steps launched {launches}, want "
          f"{n_attn} of each flash kernel per step and no MoE kernel")
    pm = hist[0]
    check(len(hist) == 1 and pm.train_all == TRAIN_SAMPLES and np.isfinite(pm.mse_loss),
          f"{compute_dtype}: fit's PerfMetrics {pm}")

    # (d) step time, a profiled step, peak memory
    xb, yb = batches[0]

    def step():
        cm.train_step(cm.params, cm.opt_state, None, xb, yb)

    step_ms, round_medians, peak_gib = timed_steps(step, STEP_ROUNDS)
    median_ms = float(np.median(step_ms))
    breakdown = profile_breakdown(step, TRAIN_CLASSES, other="optimizer/elementwise")
    check_fwd_route(breakdown, compute_dtype, f"training {compute_dtype}")
    # the step's backward ran the tensor-core kernels of its dtype (f32:
    # split TF32) and no other backward kernel
    check_bwd_route({n for n, _ in device_spans(step, 1) if "flash_bwd" in n},
                    getattr(torch, compute_dtype), f"training {compute_dtype}")
    row = dict(compute_dtype=compute_dtype, card=card, batch=BATCH,
               grad_rel_err_vs_plain=grad_err, grad_worst_weight=grad_worst,
               grad_tolerance=grad_tol, grad_bf16_floor=grad_floor,
               random_params_losses=random_losses,
               losses=losses[False], plain_losses=losses[True],
               loss_rel_err_vs_plain=loss_err, loss_tolerance=LOSS_TOL[compute_dtype],
               update_rel_err_vs_plain=update_err, update_worst_weight=update_worst,
               update_tolerance=GRAD_TOL if ref is None else None,
               update_bf16_floor=update_floor,
               fit_steps=steps, fit_launches=launches, fit_mse=pm.mse_loss / pm.train_all,
               step_ms_median=median_ms, step_ms_round_medians=round_medians,
               step_ms_min=min(step_ms), step_ms_max=max(step_ms),
               samples_per_s=BATCH * 1e3 / median_ms,
               peak_memory_gib=peak_gib, breakdown=breakdown)
    held = f"tol {GRAD_TOL}" if ref is None else f"bf16 floor {update_floor:.3g}"
    print(f"training {compute_dtype}: grads vs plain path {grad_err:.3g} of the "
          f"layer's largest gradient (worst {grad_worst}; tol {grad_tol:.3g}); "
          f"two steps from those params: losses "
          f"{[f'{v:.6g}' for v in random_losses]}; 5 steps from the model's own "
          f"init: losses {[f'{v:.6f}' for v in losses[False]]} vs plain "
          f"{[f'{v:.6f}' for v in losses[True]]} (max rel err {loss_err:.3g}, tol "
          f"{LOSS_TOL[compute_dtype]}), params after them {update_err:.3g} of the "
          f"layer's largest update (worst {update_worst}; {held}); fit {steps} "
          f"steps, launches {launches}; step {median_ms:.2f} ms median of "
          f"{STEP_ROUNDS}x{TIMED_STEPS} (rounds {', '.join(f'{v:.2f}' for v in round_medians)}"
          f"), {row['samples_per_s']:.1f} samples/s, peak "
          f"{peak_gib:.2f} GiB [{card}]", flush=True)
    print(f"training breakdown {compute_dtype}: {json.dumps(breakdown)}", flush=True)
    print("training_json " + json.dumps(row), flush=True)
    return row, this_ref


# ---- the GPT causal LM and the BERT proxy --------------------------------


def gpt_config():
    from flexflow_tpu_torch.models import GPTConfig

    return GPTConfig()


def gpt_model(compute_dtype: str, training: bool):
    from flexflow_tpu_torch import (CompMode, FFConfig, FFModel, LossType, MetricsType,
                                    SGDOptimizer)
    from flexflow_tpu_torch.models import build_gpt

    cfg = gpt_config()
    mode = CompMode.TRAINING if training else CompMode.INFERENCE
    ff = FFModel(FFConfig(batch_size=GPT_BATCH, computation_mode=mode,
                          compute_dtype=compute_dtype, seed=SEED, device=DEVICE))
    build_gpt(ff, GPT_BATCH, GPT_SEQ, cfg)
    if training:
        ff.compile(optimizer=SGDOptimizer(lr=GPT_LR),
                   loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   metrics=[MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    else:
        ff.compile()
    n_attn = sum(op.op_type.name == "MULTIHEAD_ATTENTION" for op in ff.compiled.ops)
    check(n_attn == cfg.num_layers, f"GPT has {n_attn} attention ops, want {cfg.num_layers}")
    return ff, n_attn


def gpt_data(seed: int, n: int):
    """Tokens from a seeded numpy generator, positions 0..GPT_SEQ-1 and
    labels, the tokens shifted by one."""
    seq = GPT_SEQ
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, gpt_config().vocab_size, size=(n, seq + 1), dtype=np.int32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (n, seq)).copy()
    return tok[:, :-1].copy(), pos, tok[:, 1:].copy()


def gpt_params(ff, seed: int) -> dict:
    """Random GPT params: unit-scale embeddings, LayerNorm scales near 1,
    small biases, the other weights variance-preserving (std 1/sqrt(fan
    in)), so the logits spread over a few units and most top-2 margins
    are far above the comparison's bound."""
    rng = np.random.default_rng(seed)
    tree = {}
    for op, ws in ff.compiled.params.items():
        tree[op] = {}
        for w, cur in ws.items():
            shape = tuple(cur.shape)
            if op in ("wte", "wpe"):
                mean, std = 0.0, 1.0
            elif w == "scale":
                mean, std = 1.0, 0.1
            elif len(shape) == 1 or w.startswith("b"):
                mean, std = 0.0, 0.1
            else:
                fan_in = shape[0] if w in ("wq", "wk", "wv") else int(np.prod(shape[:-1]))
                mean, std = 0.0, 1.0 / np.sqrt(fan_in)
            tree[op][w] = (rng.standard_normal(size=shape, dtype=np.float32)
                           * np.float32(std) + np.float32(mean))
    return tree


def check_flash_launches(counts: dict, fwd: int, bwd: int, what: str) -> None:
    """``fwd`` forward and ``bwd`` launches of each backward kernel, and no
    MoE kernel."""
    want = {name: 0 for name in counts}
    want.update(flash_attention_fwd=fwd, flash_attention_bwd_dq=bwd,
                flash_attention_bwd_dkv=bwd)
    check(counts == want, f"{what}: launched {counts}, want {want}")


def phase_gpt_training(compute_dtype: str, card: str, ref: dict = None) -> tuple:
    """Train GPT at GPTConfig's width through compile -> grad_step /
    train_step / fit, each against the plain kernels' path, under the
    Transformer phase's rules; the step time, a profiled step and the peak
    memory. ``ref``: the float32 run's plain-path gradients and params,
    which set the bfloat16 run's bounds. Returns (row, this run's ref)."""
    from flexflow_tpu_torch import kernels, load_numpy_params

    ff, n_attn = gpt_model(compute_dtype, training=True)
    cm = ff.compiled
    own_init = {op: {w: t.detach().cpu().numpy().copy() for w, t in ws.items()}
                for op, ws in cm.params.items()}
    own_dev = {op: {w: t.detach().clone() for w, t in ws.items()}
               for op, ws in cm.params.items()}
    tok, pos, lab = gpt_data(SEED + 7, GPT_TRAIN_SAMPLES)
    batches = [tuple(torch.from_numpy(a[i * GPT_BATCH:(i + 1) * GPT_BATCH]).to(cm.device)
                     for a in (tok, pos, lab)) for i in range(GPT_TRAIN_SAMPLES // GPT_BATCH)]
    what = f"GPT training {compute_dtype}"

    def reset():
        load_numpy_params(ff, own_init)
        cm.opt_state = cm.optimizer.init_state(cm.params)

    def run_steps(chosen, plain: bool) -> list:
        losses = []
        for batch in chosen:
            cm.params, cm.opt_state, loss, _ = cm.train_step(
                cm.params, cm.opt_state, None, *batch, plain_kernels=plain)
            losses.append(loss.item())
        return losses

    # (a) one grad_step on each path, at the model's own init
    g_kern = cm.grad_step(cm.params, None, *batches[0])
    g_plain = cm.grad_step(cm.params, None, *batches[0], plain_kernels=True)
    grad_err, grad_worst = layer_err(g_kern, g_plain)
    grad_floor = None if ref is None else layer_err(g_plain, ref["grads"])[0]
    grad_tol = GRAD_TOL if ref is None else BF16_FLOOR_FACTOR * grad_floor
    check(grad_err <= grad_tol, f"{what}: grads vs plain path {grad_err:.3g} of the largest "
          f"gradient of {grad_worst}'s layer > {grad_tol:.3g}")
    del g_kern

    # (b) five train_steps on each path from the model's own init
    losses, final = {}, {}
    for plain in (False, True):
        reset()
        losses[plain] = run_steps(batches[:5], plain)
        final[plain] = {op: {w: t.clone() for w, t in ws.items()}
                        for op, ws in cm.params.items()}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses[False], losses[True]))
    check(all(np.isfinite(losses[False] + losses[True]))
          and loss_err <= LOSS_TOL[compute_dtype],
          f"{what}: losses {losses[False]} vs plain path {losses[True]}: {loss_err:.3g} > "
          f"{LOSS_TOL[compute_dtype]}")
    # params against each layer's largest update: held in f32; in bf16
    # recorded beside the plain bf16 path's distance from the plain f32
    # one, as the Transformer phase records them
    update_err, update_worst = layer_err(final[False], final[True], own_dev, ulps=5)
    update_floor = (None if ref is None else
                    layer_err(final[True], ref["final"], own_dev, ulps=5)[0])
    check(ref is not None or update_err <= GRAD_TOL,
          f"{what}: params after 5 steps vs plain path {update_err:.3g} of the largest "
          f"update of {update_worst}'s layer > {GRAD_TOL}")
    host = lambda tree: {op: {w: t.cpu() for w, t in ws.items()}  # noqa: E731
                         for op, ws in tree.items()}
    this_ref = {"grads": host(g_plain), "final": host(final[True])}
    del g_plain, final

    # (c) fit through the entry point, launch counts read just around it;
    # then the same 8 steps through the plain path
    reset()
    steps = len(batches)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hist = ff.fit([tok, pos], lab, batch_size=GPT_BATCH, epochs=1, shuffle=False,
                  verbose=False)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_flash_launches(launches, n_attn * steps, n_attn * steps, f"{what}: fit's {steps} steps")
    fitted = {op: {w: t.clone() for w, t in ws.items()} for op, ws in cm.params.items()}
    reset()
    plain_fit_losses = run_steps(batches, plain=True)
    pm = hist[0]
    fit_ce = pm.sparse_cce_loss / pm.train_all
    plain_ce = float(np.mean(plain_fit_losses))
    fit_err = abs(fit_ce - plain_ce) / plain_ce
    fit_update_err, fit_worst = layer_err(fitted, cm.params, own_dev, ulps=steps)
    check(pm.train_all == GPT_TRAIN_SAMPLES * GPT_SEQ and np.isfinite(fit_ce)
          and fit_err <= LOSS_TOL[compute_dtype]
          and (ref is not None or fit_update_err <= GRAD_TOL),
          f"{what}: fit sparse CE {fit_ce} vs plain {plain_ce} ({fit_err:.3g}), params "
          f"{fit_update_err:.3g} of the largest update of {fit_worst}'s layer")
    del fitted

    # (d) step time, a profiled step, peak memory
    batch = batches[0]

    def step():
        cm.train_step(cm.params, cm.opt_state, None, *batch)

    step_ms, _, peak_gib = timed_steps(step, 1)
    median_ms = float(np.median(step_ms))
    breakdown = profile_breakdown(step, TRAIN_CLASSES, other="optimizer/elementwise")
    check_fwd_route(breakdown, compute_dtype, what)
    check_bwd_route({n for n, _ in device_spans(step, 1) if "flash_bwd" in n},
                    getattr(torch, compute_dtype), what)
    row = dict(compute_dtype=compute_dtype, card=card, batch=GPT_BATCH, seq=GPT_SEQ,
               grad_rel_err_vs_plain=grad_err, grad_worst_weight=grad_worst,
               grad_tolerance=grad_tol, grad_bf16_floor=grad_floor,
               losses=losses[False], plain_losses=losses[True],
               loss_rel_err_vs_plain=loss_err, loss_tolerance=LOSS_TOL[compute_dtype],
               update_rel_err_vs_plain=update_err, update_worst_weight=update_worst,
               update_bf16_floor=update_floor, fit_steps=steps, fit_launches=launches,
               fit_sparse_cce=fit_ce, fit_plain_sparse_cce=plain_ce,
               fit_update_rel_err_vs_plain=fit_update_err, fit_accuracy=pm.accuracy,
               step_ms_median=median_ms, step_ms_min=min(step_ms), step_ms_max=max(step_ms),
               tokens_per_s=GPT_BATCH * GPT_SEQ * 1e3 / median_ms,
               device_busy_share=1.0 - breakdown["device_idle_share"],
               peak_memory_gib=peak_gib, breakdown=breakdown)
    held = f"tol {GRAD_TOL}" if ref is None else f"bf16 floor {update_floor:.3g}"
    print(f"gpt training {compute_dtype}: grads vs plain path {grad_err:.3g} of the layer's "
          f"largest gradient (worst {grad_worst}; tol {grad_tol:.3g}); 5 steps: losses "
          f"{[f'{v:.6f}' for v in losses[False]]} vs plain {[f'{v:.6f}' for v in losses[True]]}"
          f" (max rel err {loss_err:.3g}, tol {LOSS_TOL[compute_dtype]}), params after them "
          f"{update_err:.3g} of the layer's largest update (worst {update_worst}; {held}); fit "
          f"{steps} steps, launches {launches}, sparse CE {fit_ce:.6f} vs plain {plain_ce:.6f}, "
          f"params {fit_update_err:.3g}; step {median_ms:.2f} ms median of {TIMED_STEPS} "
          f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}), "
          f"{row['tokens_per_s']:.0f} tokens/s, device busy "
          f"{row['device_busy_share']:.1%} of a profiled step, peak {peak_gib:.2f} GiB "
          f"[{card}]", flush=True)
    print(f"gpt training breakdown {compute_dtype}: {json.dumps(breakdown)}", flush=True)
    print("gpt_training_json " + json.dumps(row), flush=True)
    return row, this_ref


def phase_gpt_generation(compute_dtype: str, card: str, full_f32: np.ndarray = None) -> tuple:
    """Generate GEN_NEW greedy tokens for GPT_BATCH prompts of GEN_PROMPT
    through Generator(max_length=GEN_MAX_LENGTH).generate, recording each
    block step's logits and time; then one full causal forward of the
    generated tokens (the flash forward, causal) holds every step's logits
    and the greedy tokens. ``full_f32``: the float32 run's full-forward
    logits, from which the bfloat16 run records its distance. Returns (row,
    this run's full-forward logits)."""
    from flexflow_tpu_torch import kernels, load_numpy_params
    from flexflow_tpu_torch.serving import Generator

    ff, n_attn = gpt_model(compute_dtype, training=False)
    load_numpy_params(ff, gpt_params(ff, SEED + 8))
    cm = ff.compiled
    gen = Generator(ff, max_length=GEN_MAX_LENGTH)
    vocab = gpt_config().vocab_size
    prompts = np.random.default_rng(SEED + 9).integers(
        0, vocab, size=(GPT_BATCH, GEN_PROMPT), dtype=np.int32)
    what = f"GPT generation {compute_dtype}"
    step = gen._step
    records = []  # (offset, block length, ms, last position's logits on the host)

    def recording_step(params, tokens, cache, offset):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, tokens, cache, offset)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        records.append((offset, tokens.shape[1], ms, out[:, -1].cpu().numpy()))
        return out

    gen.generate(prompts, 4)  # warm-up
    gen._step = recording_step
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = gen.generate(prompts, GEN_NEW)
    wall = time.perf_counter() - t0
    gen_launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(out.shape == (GPT_BATCH, GEN_PROMPT + GEN_NEW) and np.array_equal(
        out[:, :GEN_PROMPT], prompts), f"{what}: tokens of shape {out.shape}")
    # the cached attention is torch ops, as the reference's is XLA
    check(all(v == 0 for v in gen_launches.values()),
          f"{what}: generate launched {gen_launches}")
    check(len(records) == GEN_NEW and records[0][:2] == (0, GEN_PROMPT)
          and all(r[:2] == (GEN_PROMPT + i, 1) for i, r in enumerate(records[1:])),
          f"{what}: block steps {[r[:2] for r in records]}")

    # the full causal forward of the generated tokens through the kernel
    seq = GEN_PROMPT + GEN_NEW
    tokens = torch.from_numpy(out).to(cm.device)
    positions = torch.arange(seq, dtype=torch.int32, device=cm.device).expand(GPT_BATCH, seq)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    full_dev = cm.forward_fn(cm.params, tokens, positions)
    torch.cuda.synchronize()
    fwd_launches = kernels.launch_counts()
    check_flash_launches(fwd_launches, n_attn, 0, f"{what}: the full forward")
    full = full_dev.cpu().numpy()
    del full_dev
    check(full.shape == (GPT_BATCH, seq, vocab) and bool(np.isfinite(full).all()),
          f"{what}: full-forward logits {full.shape}")
    # step k's logits are those of position GEN_PROMPT - 1 + k
    want = full[:, GEN_PROMPT - 1:seq - 1]
    got = np.stack([r[3] for r in records], axis=1)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    check(err <= GEN_TOL[compute_dtype], f"{what}: step logits vs the full forward {err:.3g} "
          f"of the largest |logit| ({scale:.3g}) > {GEN_TOL[compute_dtype]}")
    # the bf16 path's distance from the f32 one where both read the same
    # tokens (the prompt's positions: the greedy continuations may part)
    floor = (None if full_f32 is None else
             float(np.abs(full[:, :GEN_PROMPT] - full_f32[:, :GEN_PROMPT]).max()
                   / np.abs(full_f32[:, :GEN_PROMPT]).max()))
    # greedy tokens: the full forward's argmax wherever its top-2 margin
    # exceeds the bound
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > GEN_TOL[compute_dtype] * scale
    agree = out[:, GEN_PROMPT:] == want.argmax(-1)
    check(bool(agree[decided].all()), f"{what}: greedy tokens differ from the full "
          f"forward's argmax at {int((~agree & decided).sum())} decided positions")
    decode_ms = np.array([r[2] for r in records[1:]])
    row = dict(compute_dtype=compute_dtype, card=card, batch=GPT_BATCH, prompt=GEN_PROMPT,
               new_tokens=GEN_NEW, max_length=GEN_MAX_LENGTH, prefill_ms=records[0][2],
               decode_ms_p50=float(np.percentile(decode_ms, 50)),
               decode_ms_p99=float(np.percentile(decode_ms, 99)),
               tokens_per_s=GPT_BATCH * GEN_NEW / wall, generate_s=wall,
               generate_launches=gen_launches, full_forward_launches=fwd_launches,
               rel_err_vs_full_forward=err, logit_scale=scale,
               tolerance=GEN_TOL[compute_dtype], bf16_vs_f32_full_forward=floor,
               greedy_checked=int(decided.sum()), greedy_positions=int(decided.size),
               peak_memory_gib=peak_gib)
    print(f"gpt generation {compute_dtype}: {GPT_BATCH} prompts of {GEN_PROMPT} + {GEN_NEW} "
          f"greedy tokens in {wall:.3f} s, {row['tokens_per_s']:.1f} tokens/s; prefill "
          f"{row['prefill_ms']:.2f} ms, decode {row['decode_ms_p50']:.3f} ms p50, "
          f"{row['decode_ms_p99']:.3f} ms p99 a token; step logits vs the full causal forward "
          f"(flash launches {fwd_launches['flash_attention_fwd']}) {err:.3g} of the largest "
          f"|logit| {scale:.3g} (tol {GEN_TOL[compute_dtype]})"
          + ("" if floor is None else f", full forward vs f32's at the prompt {floor:.3g}")
          + f"; greedy tokens equal its argmax at all {row['greedy_checked']} of "
          f"{row['greedy_positions']} positions whose top-2 margin exceeds the bound; peak "
          f"{peak_gib:.2f} GiB [{card}]", flush=True)
    print("gpt_generation_json " + json.dumps(row), flush=True)
    return row, full


def paged_traffic(seed: int) -> list:
    """PAGED_REQUESTS (prompt, max_new_tokens) pairs from a seeded numpy
    generator."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(PAGED_PROMPT[0], PAGED_PROMPT[1] + 1, size=PAGED_REQUESTS)
    news = rng.integers(PAGED_NEW[0], PAGED_NEW[1] + 1, size=PAGED_REQUESTS)
    vocab = gpt_config().vocab_size
    return [(rng.integers(0, vocab, size=int(n), dtype=np.int32), int(m))
            for n, m in zip(lens, news)]


def serve_paged(ff, traffic: list, **kw) -> dict:
    """Serve ``traffic`` through InferenceEngine.register_generator (the
    scheduler's knobs ``kw`` over the phase's geometry), submitted in
    waves; returns the outputs, the scheduler's stats and its decoder, the
    wall time, the kernel launches while serving and the peak memory."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.serving import InferenceEngine

    eng = InferenceEngine()
    inst = eng.register_generator(ff, "lm", decode_slots=PAGED_SLOTS, block_size=PAGED_BLOCK,
                                  max_length=GEN_MAX_LENGTH, **kw)
    calibration_steps = inst.decoder.decode_steps  # an int8 pool's calibration
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    futs, outs = [], [None] * len(traffic)
    for i, (prompt, new) in enumerate(traffic):
        futs.append(eng.generate_async("lm", prompt, new))
        if i % PAGED_WAVE == PAGED_WAVE - 1:
            outs[i - PAGED_WAVE + 1] = futs[i - PAGED_WAVE + 1].result(timeout=600)
    outs = [o if o is not None else f.result(timeout=600) for o, f in zip(outs, futs)]
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = inst.stats()
    decoder = inst.decoder
    eng.stop()
    for (prompt, new), out in zip(traffic, outs):
        check(out.shape == (prompt.size + new,) and np.array_equal(out[:prompt.size], prompt),
              f"paged serving: an answer of shape {out.shape} for a prompt of {prompt.size} "
              f"and {new} new tokens")
    check(all(v == 0 for v in launches.values()),
          f"paged serving launched {launches}: its attention is torch ops")
    check(stats["decode_steps"] == stats["decode_dispatches"]
          == stats["phases"]["decode_step"]["count"] + calibration_steps
          and stats["completed"] == len(traffic)
          and stats["kv"]["in_use"] == 0,
          f"paged serving: {stats['decode_steps']} decode steps, {stats['decode_dispatches']} "
          f"dispatches, {stats['phases']['decode_step']['count']} timed, "
          f"({calibration_steps} calibrating), {stats['completed']} completed, "
          f"{stats['kv']['in_use']} blocks in use")
    generated = sum(new for _, new in traffic)
    phases = stats["phases"]
    return dict(outs=outs, stats=stats, decoder=decoder, wall_s=wall, launches=launches,
                peak_gib=peak_gib, generated=generated, tokens_per_s=generated / wall,
                ttft_ms_p50=phases["ttft"]["p50"] * 1e3, ttft_ms_p99=phases["ttft"]["p99"] * 1e3,
                step_ms_p50=phases["decode_step"]["p50"] * 1e3,
                step_ms_p99=phases["decode_step"]["p99"] * 1e3)


def paged_teacher_forced(ff, traffic: list) -> float:
    """PAGED_TF_REQUESTS requests through the dense Generator, one at a
    time, prefill and PAGED_TF_STEPS greedy steps; then the same tokens
    through one PagedDecoder with those requests in its slots at once.
    Returns the largest |paged - dense| logit as a share of the largest
    dense |logit|."""
    from flexflow_tpu_torch.serving import Generator, PagedDecoder

    gen = Generator(ff, max_length=GEN_MAX_LENGTH, batch_size=1)
    reqs = [p for p, _ in traffic[:PAGED_TF_REQUESTS]]
    dense, fed = [], []
    for prompt in reqs:
        logits, cache, pos = gen.prefill(prompt[None, :])
        rows, toks = [logits[0].cpu().numpy()], []
        for step in range(PAGED_TF_STEPS):
            toks.append(int(rows[-1].argmax()))
            step_tokens = gen._tokens(np.array([[toks[-1]]], np.int32))
            rows.append(gen._step(gen._exec_params(), step_tokens, cache, pos + step)[0, -1]
                        .cpu().numpy())
        dense.append(np.stack(rows))
        fed.append(toks)
    del gen, cache
    dec = PagedDecoder(ff, GEN_MAX_LENGTH, decode_slots=PAGED_SLOTS, block_size=PAGED_BLOCK)
    tables = np.zeros((PAGED_SLOTS, dec.max_blocks_per_request), np.int32)
    seq_lens = np.zeros(PAGED_SLOTS, np.int32)
    paged = [[] for _ in reqs]
    for i, prompt in enumerate(reqs):
        tables[i] = dec.pool.try_admit(prompt.size + PAGED_TF_STEPS + 1)
        paged[i].append(dec.prefill(prompt, tables[i]))
        seq_lens[i] = prompt.size
    for step in range(PAGED_TF_STEPS):
        toks = np.zeros(PAGED_SLOTS, np.int32)
        toks[:len(reqs)] = [f[step] for f in fed]
        logits = dec.decode(toks, tables, seq_lens + step)
        for i in range(len(reqs)):
            paged[i].append(logits[i])
    want = np.stack(dense)
    got = np.stack([np.stack(r) for r in paged])
    check(dec.decode_steps == dec.decode_dispatches == PAGED_TF_STEPS,
          f"teacher-forced PagedDecoder: {dec.decode_steps} steps, "
          f"{dec.decode_dispatches} dispatches")
    return float(np.abs(got - want).max() / np.abs(want).max())


def full_forward_margins(cm, traffic: list, outs: list) -> list:
    """Each answer once through the full causal forward (the flash kernel,
    causal): per request (argmax, top-2 margin, largest |logit|) at the
    positions that predicted its generated tokens."""
    res = []
    for (prompt, _), out in zip(traffic, outs):
        seq = out.size
        tokens = torch.from_numpy(out[None, :]).to(cm.device)
        positions = torch.arange(seq, dtype=torch.int32, device=cm.device)[None, :]
        want = cm.forward_fn(cm.params, tokens, positions)[0, prompt.size - 1:seq - 1]
        check(bool(torch.isfinite(want).all()), "paged serving: full-forward logits not finite")
        top2 = torch.topk(want, 2, dim=-1).values
        res.append((want.argmax(-1).cpu().numpy(), (top2[:, 0] - top2[:, 1]).cpu().numpy(),
                    float(want.abs().max())))
    return res


def first_divergences(outs: list, ref_outs: list, margins: list, bounds: list) -> tuple:
    """Greedy chains part where a token is undecided: each answer must equal
    the reference answer up to its first differing token, where the
    reference's full-forward top-2 margin must be at most the request's
    bound. Returns (requests that part, the largest margin where one
    parts, as a share of its bound)."""
    parted, worst = 0, 0.0
    for i, (out, ref) in enumerate(zip(outs, ref_outs)):
        diff = np.nonzero(out != ref)[0]
        if diff.size == 0:
            continue
        j = int(diff[0]) - (ref.size - margins[i][1].size)
        margin = float(margins[i][1][j])
        check(margin <= bounds[i], f"request {i} parts from the reference at generated token "
              f"{j}, where the reference's top-2 margin {margin:.4g} > the bound "
              f"{bounds[i]:.4g}")
        parted += 1
        worst = max(worst, margin / bounds[i])
    return parted, worst


def phase_gpt_paged_serving(compute_dtype: str, card: str) -> dict:
    """GPT at GPTConfig's defaults served through InferenceEngine.register_generator
    -> GenerationInstance -> ContinuousBatchingScheduler -> PagedDecoder ->
    PagedKVPool: the teacher-forced check against the dense Generator, the
    traffic with every answer's greedy tokens held to one full causal
    forward (the flash kernel), then the same traffic speculatively and
    with an int8 pool, each held to the plain run's tokens by the margin
    rule. Returns the phase's row."""
    from flexflow_tpu_torch import kernels, load_numpy_params

    ff, n_attn = gpt_model(compute_dtype, training=False)
    load_numpy_params(ff, gpt_params(ff, SEED + 8))
    cm = ff.compiled
    what = f"GPT paged serving {compute_dtype}"
    tol = GEN_TOL[compute_dtype]
    traffic = paged_traffic(SEED + 11)
    tf_err = paged_teacher_forced(ff, traffic)
    check(tf_err <= tol, f"{what}: teacher-forced paged logits vs the dense Generator "
          f"{tf_err:.3g} of the largest |logit| > {tol}")
    torch.cuda.empty_cache()

    plain = serve_paged(ff, traffic)
    kernels.reset_launch_counts()
    margins = full_forward_margins(cm, traffic, plain["outs"])
    torch.cuda.synchronize()
    fwd_launches = kernels.launch_counts()
    check_flash_launches(fwd_launches, n_attn * len(traffic), 0, f"{what}: the full forwards")
    decided_n = checked = 0
    for i, ((prompt, _), out) in enumerate(zip(traffic, plain["outs"])):
        argmax, margin, scale = margins[i]
        decided = margin > tol * scale
        agree = out[prompt.size:] == argmax
        check(bool(agree[decided].all()), f"{what}: request {i}'s greedy tokens differ from "
              f"the full forward's argmax at {int((~agree & decided).sum())} decided positions")
        decided_n += int(decided.sum())
        checked += decided.size
    bounds = [tol * m[2] for m in margins]

    spec = serve_paged(ff, traffic, spec_k=PAGED_SPEC_K, draft_ff=PAGED_DRAFT)
    sp = spec["stats"]["spec"]
    check(sp["rounds"] == spec["stats"]["decode_dispatches"] and sp["k"] == PAGED_SPEC_K
          and sp["emitted"] == spec["generated"] - len(traffic),
          f"{what}: spec rounds {sp['rounds']}, decode dispatches "
          f"{spec['stats']['decode_dispatches']}, emitted {sp['emitted']}")
    spec_parted, spec_worst = first_divergences(spec["outs"], plain["outs"], margins, bounds)

    q = serve_paged(ff, traffic, kv_dtype="int8")
    q_dtype, q_div = q["decoder"].kv_dtype, q["decoder"].kv_divergence
    check(q_div is not None and np.isfinite(q_div), f"{what}: int8 kv_divergence {q_div}")
    # int8: tokens decided by more than twice the calibration divergence
    # must agree; after a KVQ001 fallback the pool is the plain run's and
    # the margin rule's bound stands
    q_bounds = [2 * q_div] * len(bounds) if q_dtype == "int8" else bounds
    q_parted, q_worst = first_divergences(q["outs"], plain["outs"], margins, q_bounds)

    def run_row(r):
        st = r["stats"]
        return dict(tokens_per_s=r["tokens_per_s"], wall_s=r["wall_s"],
                    generated=r["generated"], ttft_ms_p50=r["ttft_ms_p50"],
                    ttft_ms_p99=r["ttft_ms_p99"], decode_step_ms_p50=r["step_ms_p50"],
                    decode_step_ms_p99=r["step_ms_p99"], decode_steps=st["decode_steps"],
                    decode_dispatches=st["decode_dispatches"],
                    prefill_dispatches=st["prefill_dispatches"],
                    prefill_prompts=st["prefill_prompts"], high_water=st["kv"]["high_water"],
                    memory_bytes=st["kv"]["memory_bytes"], kv_dtype=st["kv"]["kv_dtype"],
                    peak_memory_gib=r["peak_gib"], launches=r["launches"])

    row = dict(compute_dtype=compute_dtype, card=card, requests=len(traffic),
               prompt_range=list(PAGED_PROMPT), new_range=list(PAGED_NEW),
               decode_slots=PAGED_SLOTS, block_size=PAGED_BLOCK, max_length=GEN_MAX_LENGTH,
               num_blocks=plain["stats"]["kv"]["num_blocks"], tolerance=tol,
               teacher_forced_rel_err=tf_err, full_forward_launches=fwd_launches,
               greedy_checked=decided_n, greedy_positions=checked,
               plain=run_row(plain),
               spec=dict(run_row(spec), k=PAGED_SPEC_K, draft=PAGED_DRAFT,
                         accept_rate=sp["accept_rate"],
                         tokens_per_dispatch=sp["tokens_per_dispatch"], rounds=sp["rounds"],
                         draft_dispatches=sp["draft_dispatches"], parted=spec_parted,
                         worst_parting_margin_share=spec_worst),
               int8=dict(run_row(q), kv_dtype_after_calibration=q_dtype, kv_divergence=q_div,
                         kv_divergence_budget=q["decoder"].kv_divergence_budget,
                         parted=q_parted, worst_parting_margin_share=q_worst))
    p, s, r8 = row["plain"], row["spec"], row["int8"]
    print(f"gpt paged serving {compute_dtype}: {len(traffic)} requests (prompts "
          f"{PAGED_PROMPT[0]}-{PAGED_PROMPT[1]}, {plain['generated']} new greedy tokens) through "
          f"register_generator, {PAGED_SLOTS} slots, {row['num_blocks']} blocks of "
          f"{PAGED_BLOCK}: {p['tokens_per_s']:.1f} tokens/s, TTFT {p['ttft_ms_p50']:.2f} ms p50, "
          f"{p['ttft_ms_p99']:.2f} ms p99, decode step {p['decode_step_ms_p50']:.3f} ms p50, "
          f"{p['decode_step_ms_p99']:.3f} ms p99, {p['decode_steps']} steps = dispatches, "
          f"{p['prefill_dispatches']} prefill dispatches for {p['prefill_prompts']} prompts, "
          f"high water {p['high_water']} blocks, pool {p['memory_bytes'] / 2 ** 30:.3f} GiB, "
          f"peak {p['peak_memory_gib']:.2f} GiB; teacher-forced logits vs the dense Generator "
          f"{tf_err:.3g} of the largest |logit| (tol {tol}); greedy tokens equal the full "
          f"forward's argmax (flash launches {fwd_launches['flash_attention_fwd']}) at all "
          f"{decided_n} of {checked} decided positions [{card}]", flush=True)
    print(f"gpt paged serving {compute_dtype} speculative (k {PAGED_SPEC_K}, draft "
          f"{PAGED_DRAFT}): {s['tokens_per_s']:.1f} tokens/s, acceptance {s['accept_rate']:.4f}, "
          f"{s['tokens_per_dispatch']:.3f} tokens a slot a verify, {s['rounds']} rounds = "
          f"decode dispatches, {s['draft_dispatches']} draft dispatches, decode round "
          f"{s['decode_step_ms_p50']:.3f} ms p50, {s['decode_step_ms_p99']:.3f} ms p99; "
          f"{spec_parted} answers part from the plain run, each where undecided [{card}]",
          flush=True)
    print(f"gpt paged serving {compute_dtype} int8: kv_dtype {q_dtype} after calibration, "
          f"kv_divergence {q_div:.4g} (budget {r8['kv_divergence_budget']}), "
          f"{r8['tokens_per_s']:.1f} tokens/s, decode step {r8['decode_step_ms_p50']:.3f} ms "
          f"p50, {r8['decode_step_ms_p99']:.3f} ms p99, pool "
          f"{r8['memory_bytes'] / 2 ** 30:.3f} GiB (plain {p['memory_bytes'] / 2 ** 30:.3f}); "
          f"{q_parted} answers part from the plain run, each where undecided "
          f"(worst {q_worst:.3g} of its bound) [{card}]", flush=True)
    print("gpt_paged_json " + json.dumps(row), flush=True)
    return row


def phase_bert_fit(card: str) -> dict:
    """One short fit of the BERT proxy at its defaults in float32, launches
    counted, against the same steps through the plain path."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
                                    kernels, load_numpy_params)
    from flexflow_tpu_torch.models import build_bert_proxy

    ff = FFModel(FFConfig(batch_size=BERT_BATCH, seed=SEED, device=DEVICE))
    x_t, _ = build_bert_proxy(ff, BERT_BATCH)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               metrics=[MetricsType.MEAN_SQUARED_ERROR])
    cm = ff.compiled
    n_attn = sum(op.op_type.name == "MULTIHEAD_ATTENTION" for op in cm.ops)
    check(n_attn == BERT_LAYERS, f"BERT proxy has {n_attn} attention ops, want {BERT_LAYERS}")
    init = {op: {w: t.detach().cpu().numpy().copy() for w, t in ws.items()}
            for op, ws in cm.params.items()}
    own_dev = {op: {w: t.detach().clone() for w, t in ws.items()}
               for op, ws in cm.params.items()}
    rng = np.random.default_rng(SEED + 10)
    x = rng.standard_normal(size=(BERT_BATCH * BERT_STEPS,) + x_t.dims[1:], dtype=np.float32)
    y = rng.standard_normal(size=x.shape, dtype=np.float32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = ff.fit(x, y, batch_size=BERT_BATCH, epochs=1, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_flash_launches(launches, n_attn * BERT_STEPS, n_attn * BERT_STEPS, "BERT fit")
    fitted = {op: {w: t.clone() for w, t in ws.items()} for op, ws in cm.params.items()}
    load_numpy_params(ff, init)
    cm.opt_state = cm.optimizer.init_state(cm.params)
    plain_losses = []
    for i in range(BERT_STEPS):
        xb, yb = (torch.from_numpy(a[i * BERT_BATCH:(i + 1) * BERT_BATCH]).to(cm.device)
                  for a in (x, y))
        cm.params, cm.opt_state, loss, _ = cm.train_step(cm.params, cm.opt_state, None, xb, yb,
                                                         plain_kernels=True)
        plain_losses.append(loss.item())
    pm = hist[0]
    fit_mse = pm.mse_loss / (pm.train_all * x.shape[1] * x.shape[2])
    plain_mse = float(np.mean(plain_losses))
    loss_err = abs(fit_mse - plain_mse) / plain_mse
    update_err, worst = layer_err(fitted, cm.params, own_dev, ulps=BERT_STEPS)
    check(np.isfinite(fit_mse) and loss_err <= LOSS_TOL["float32"] and update_err <= GRAD_TOL,
          f"BERT fit: mse {fit_mse} vs plain {plain_mse} ({loss_err:.3g}), params "
          f"{update_err:.3g} of the largest update of {worst}'s layer")
    row = dict(card=card, batch=BERT_BATCH, steps=BERT_STEPS, launches=launches,
               fit_mse=fit_mse, plain_mse=plain_mse, loss_rel_err_vs_plain=loss_err,
               update_rel_err_vs_plain=update_err, fit_s=wall)
    print(f"bert fit float32: {BERT_STEPS} steps of batch {BERT_BATCH} at seq {x.shape[1]}, "
          f"hidden {x.shape[2]}, {n_attn} layers in {wall:.2f} s, launches {launches}; mse "
          f"{fit_mse:.6f} vs plain {plain_mse:.6f} (rel err {loss_err:.3g}), params "
          f"{update_err:.3g} of the "
          f"layer's largest update (worst {worst}) [{card}]", flush=True)
    print("bert_json " + json.dumps(row), flush=True)
    return row


# ---- the MoE slice -------------------------------------------------------


def moe_routing(tokens: int, n: int, k: int, alpha: float, gen):
    """A top-k routing of ``tokens`` tokens over n experts from a random
    gate, as the MoE ops compute it: (assign, gate weights (tokens, k) f32,
    capacity, slot, keep, src, valid)."""
    from flexflow_tpu_torch.kernels import moe_kernels as mk
    from flexflow_tpu_torch.ops.moe_ops import expert_capacity

    gate = torch.randn((tokens, n), generator=gen, device=DEVICE)
    vals, assign = torch.sort(gate, dim=-1, descending=True, stable=True)
    assign = assign[:, :k].to(torch.int32).contiguous()
    w = torch.softmax(vals[:, :k], dim=-1).contiguous()
    capacity = expert_capacity(tokens, k, n, alpha)
    return (assign, w, capacity) + mk.compute_routing(assign, n, capacity)


def rows_bound_ms(x: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                  out: torch.Tensor) -> float:
    """The least time of a row gather: the distinct source rows this run's
    indices read, the indices, the weights and the output, each moved once
    at the card's memory rate (the work does no arithmetic to speak of)."""
    rows = torch.unique(idx).numel()
    nbytes = (rows * x.shape[1] * x.element_size() + idx.numel() * 4
              + weights.numel() * 4 + out.numel() * out.element_size())
    return nbytes / PEAK_BYTES * 1e3


def moe_kernel_row(name: str, what: str, fn, plain, library, bound_ms: float,
                   dtype: torch.dtype, shape: str) -> dict:
    """One MoE kernel at one shape: the kernel against its plain version
    (held to MOE_TOL), timed beside it, F.embedding_bag and its bound.
    ``ms``, ``plain_ms`` and ``library_ms`` are device time per call by the
    profiler (every kernel the call runs): at the model's shape a call's
    host work (checks, allocation, the ctypes call) outlasts its kernel, so
    CUDA events around a loop would time the host. ``call_ms`` is that
    loop's time per call of the wrapper, host included."""
    got, want = fn(), plain()
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name} {what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{name} {what}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    check(err <= MOE_TOL, f"{name} {what}: kernel vs plain err {err:.3g} > {MOE_TOL}")
    kname = f"{name}_kernel"
    row = dict(dtype=_name(dtype), shape=shape, max_abs_err=err, tolerance=MOE_TOL,
               ms=kernel_ms_by_name(fn, (kname,), iters=20)[kname],
               call_ms=time_ms(fn, 50), plain_ms=device_ms(plain),
               library_ms=device_ms(library), bound_ms=bound_ms, bound_by="bytes")
    print(f"kernel {name} {what}: err {err:.3g} (tol {MOE_TOL}); kernel {row['ms']:.4f} "
          f"ms on the device ({row['call_ms']:.4f} ms a call, host included), plain "
          f"{row['plain_ms']:.4f} ms, embedding_bag {row['library_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms (bytes), {bound_ms / row['ms']:.1%} of bound", flush=True)
    return row


def phase_moe_kernels() -> dict:
    """row_gather and row_gather_sum at the MoE model's shape and at
    Mixtral-8x7B's widths, in both dtypes; then the dispatch's backward.
    Returns {"row_gather": rows, "row_gather_sum": rows}."""
    import torch.nn.functional as F

    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.kernels import moe_kernels as mk
    from flexflow_tpu_torch.models.moe import MoeConfig

    cfg = MoeConfig()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    rows = {"row_gather": [], "row_gather_sum": []}
    shapes = (("main", MOE_BATCH, cfg.input_dim, cfg.num_exp, cfg.num_select, cfg.alpha),
              ("mixtral", MIXTRAL["tokens"], MIXTRAL["d"], MIXTRAL["n"], MIXTRAL["k"],
               MIXTRAL["alpha"]))
    for label, tokens, d, n, k, alpha in shapes:
        assign, w, cap, slot, keep, src, valid = moe_routing(tokens, n, k, alpha, gen)
        wk = w * keep
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((tokens, d), generator=gen, device=DEVICE).to(dtype)
            disp = mk.row_gather(x, src, valid)
            shape = (f"{label}: x ({tokens}, {d}) -> ({n * cap}, {d}) slots, "
                     f"capacity {cap}")
            src_l, slot_l = src.long()[:, None], slot.long()
            valid_x, wk_x = valid[:, None].to(dtype), wk.to(dtype)
            rows["row_gather"].append(moe_kernel_row(
                "row_gather", f"{_name(dtype)} {shape}",
                lambda: mk.row_gather(x, src, valid),
                lambda: mk.row_gather_reference(x, src, valid),
                lambda: F.embedding_bag(src_l, x, per_sample_weights=valid_x, mode="sum"),
                rows_bound_ms(x, src, valid, disp), dtype, shape))
            shape = (f"{label}: ({tokens}, {k}) picks of ({n * cap}, {d}) slot rows")
            rows["row_gather_sum"].append(moe_kernel_row(
                "row_gather_sum", f"{_name(dtype)} {shape}",
                lambda: mk.row_gather_sum(disp, slot, wk),
                lambda: mk.row_gather_sum_reference(disp, slot, wk),
                lambda: F.embedding_bag(slot_l, disp, per_sample_weights=wk_x, mode="sum"),
                rows_bound_ms(disp, slot, wk, x), dtype, shape))
            del x, disp

    # the dispatch's backward (row_gather_sum over the slot rows' gradient),
    # which the model's main path never runs: its dispatched input needs
    # no gradient
    assign, w, cap, *_ = moe_routing(MOE_BATCH, cfg.num_exp, cfg.num_select, cfg.alpha, gen)
    for dtype in (torch.float32, torch.bfloat16):
        x0 = torch.randn((MOE_BATCH, cfg.input_dim), generator=gen, device=DEVICE).to(dtype)
        g = torch.randn((cfg.num_exp, cap, cfg.input_dim), generator=gen,
                        device=DEVICE).to(dtype)
        grads = []
        for plain in (False, True):
            x = x0.clone().requires_grad_(True)
            before = kernels.launch_counts()["row_gather_sum"]
            mk.moe_dispatch(x, assign, cfg.num_exp, cap, plain=plain).backward(g)
            torch.cuda.synchronize()
            launched = kernels.launch_counts()["row_gather_sum"] - before
            check(launched == (0 if plain else 1),
                  f"dispatch backward (plain={plain}) launched row_gather_sum {launched} times")
            grads.append(x.grad)
        err = (grads[0].float() - grads[1].float()).abs().max().item()
        check(err <= MOE_TOL and bool(torch.isfinite(grads[0].float()).all()),
              f"dispatch backward {_name(dtype)}: dx vs plain err {err:.3g}")
        print(f"kernel row_gather_sum dispatch backward {_name(dtype)}: dx ({MOE_BATCH}, "
              f"{cfg.input_dim}) from ({cfg.num_exp}, {cap}, {cfg.input_dim}), err vs "
              f"plain {err:.3g} (tol {MOE_TOL})", flush=True)
    return rows


def check_moe_launches(counts: dict, calls: int, gathers: int, what: str) -> None:
    """``calls`` forward passes, ``gathers`` row_gather launches each
    (1 serving, 3 a training step): one row_gather_sum each, no flash."""
    from flexflow_tpu_torch import kernels

    want = {name: 0 for name in kernels.FLASH_KERNELS}
    want.update(row_gather=gathers * calls, row_gather_sum=calls)
    check(counts == want, f"{what}: launched {counts}, want {want}")


def moe_model(compute_dtype: str, training: bool, stacked: bool = False):
    from flexflow_tpu_torch import (AdamOptimizer, CompMode, FFConfig, FFModel,
                                    LossType, MetricsType)
    from flexflow_tpu_torch.models.moe import build_moe_mnist

    mode = CompMode.TRAINING if training else CompMode.INFERENCE
    ff = FFModel(FFConfig(batch_size=MOE_BATCH, computation_mode=mode,
                          compute_dtype=compute_dtype, seed=SEED, device=DEVICE))
    build_moe_mnist(ff, MOE_BATCH, stacked=stacked)
    if training:
        ff.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                   loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   metrics=[MetricsType.ACCURACY,
                            MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    else:
        ff.compile()
    return ff


def phase_moe_serving(compute_dtype: str, card: str) -> dict:
    """Serve MOE_REQUESTS single-sample requests through InferenceEngine at
    the model's own init; record each dispatch's batch as the instance
    runs it, and replay every one, padded as the instance pads it, through
    the plain path."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.models.moe import MoeConfig
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    cfg = MoeConfig()
    ff = moe_model(compute_dtype, training=False)
    cm = ff.compiled
    xs = np.random.default_rng(SEED + 4).standard_normal(
        size=(MOE_REQUESTS, cfg.input_dim), dtype=np.float32)
    engine = InferenceEngine()
    inst = engine.register_ffmodel(ff, "moe")
    served = []  # (the dispatch's rows, their answers), in dispatch order
    infer = inst.infer

    def recording_infer(inputs):
        out = infer(inputs)
        served.append((np.array(inputs[0]), np.array(out[0])))
        return out

    inst.infer = recording_infer
    try:
        engine.infer("moe", [xs[0]], timeout=600)  # warm-up
        torch.cuda.synchronize()
        served.clear()
        d0 = inst.dispatches
        t_done = [0.0] * MOE_REQUESTS
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        t_submit, futs = [], []
        for i in range(MOE_REQUESTS):
            t_submit.append(time.perf_counter())
            f = engine.infer_async("moe", [xs[i]])
            f.add_done_callback(lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append(f)
        answers = [f.result(600) for f in futs]
        counts = kernels.launch_counts()
    finally:
        engine.stop()
    dispatches = inst.dispatches - d0
    wall = max(t_done) - t0
    lat_ms = np.array([(t_done[i] - t_submit[i]) * 1e3 for i in range(MOE_REQUESTS)])
    check_moe_launches(counts, dispatches, 1, f"MoE serving {compute_dtype}")
    got = np.stack(answers)
    check(got.shape == (MOE_REQUESTS, cfg.num_classes) and bool(np.isfinite(got).all()),
          f"MoE answers of shape {got.shape}, finite {np.isfinite(got).all()}")
    check(len(served) == dispatches
          and np.array_equal(np.concatenate([b for b, _ in served]), xs)
          and np.array_equal(np.concatenate([a for _, a in served]), got),
          f"MoE serving {compute_dtype}: the recorded dispatches do not cover the "
          f"requests in order")
    # replay each dispatch's exact batch, padded with zero rows as
    # ModelInstance pads it: routing ranks picks over the whole batch
    err, sizes = 0.0, []
    for batch, out in served:
        padded = np.zeros((MOE_BATCH, cfg.input_dim), np.float32)
        padded[:len(batch)] = batch
        ref = cm.forward_fn(cm.params, torch.from_numpy(padded).to(cm.device),
                            plain_kernels=True)[:len(batch)].cpu().numpy()
        err = max(err, float(np.abs(out - ref).max()))
        sizes.append(len(batch))
    check(err <= MOE_TOL, f"MoE serving {compute_dtype}: answers vs the plain path "
          f"replaying each dispatch: err {err:.3g} > {MOE_TOL}")
    sums = got.sum(axis=1)
    check(bool(np.all(np.abs(sums - 1) < 1e-2)), f"MoE answers are no softmax: {sums[:4]}")
    row = dict(compute_dtype=compute_dtype, requests=MOE_REQUESTS, dispatches=dispatches,
               dispatch_sizes=sizes, launches=counts, requests_per_s=MOE_REQUESTS / wall,
               p50_ms=float(np.percentile(lat_ms, 50)),
               p99_ms=float(np.percentile(lat_ms, 99)), max_abs_err_vs_plain=err,
               served_ms_per_dispatch=wall * 1e3 / dispatches)
    print(f"moe serving {compute_dtype}: {MOE_REQUESTS} requests in {dispatches} "
          f"dispatches of {sizes}, launches row_gather {counts['row_gather']} "
          f"row_gather_sum {counts['row_gather_sum']}; {row['requests_per_s']:.2f} req/s, "
          f"p50 {row['p50_ms']:.2f} ms, p99 {row['p99_ms']:.2f} ms; max err vs the "
          f"plain path replaying each dispatch {err:.3g} [{card}]", flush=True)
    print("moe_serving_json " + json.dumps(row), flush=True)
    return row


def tree_err(got: dict, want: dict) -> float:
    """The largest absolute difference of two param-shaped trees."""
    return max((got[op][w].float() - t.float()).abs().max().item()
               for op, ws in want.items() for w, t in ws.items())


def plain_epoch(ff, x: np.ndarray, y: np.ndarray, train: bool):
    """One epoch of FFModel.fit (no shuffle) or FFModel.eval through the
    plain path: the same whole batches through train_step or eval_step
    with plain_kernels=True. Returns the accumulated PerfMetrics."""
    from flexflow_tpu_torch.runtime.metrics import PerfMetrics

    cm = ff.compiled
    pm = PerfMetrics()
    for lo in range(0, len(x) - MOE_BATCH + 1, MOE_BATCH):
        xb = torch.from_numpy(x[lo:lo + MOE_BATCH]).to(cm.device)
        yb = torch.from_numpy(y[lo:lo + MOE_BATCH]).to(cm.device)
        if train:
            cm.params, cm.opt_state, _, bm = cm.train_step(
                cm.params, cm.opt_state, None, xb, yb, plain_kernels=True)
        else:
            bm = cm.eval_step(cm.params, xb, yb, plain_kernels=True)[2]
        pm.accumulate(bm)
    pm.flush()
    return pm


def same_metrics(got, want) -> bool:
    return (got.train_all == want.train_all and got.train_correct == want.train_correct
            and abs(got.sparse_cce_loss - want.sparse_cce_loss) <= MOE_TOL)


MOE_CLASSES = (
    ("row_gather_sum", lambda n: "row_gather_sum_kernel" in n),
    ("row_gather", lambda n: "row_gather_kernel" in n),
    ("gemm", lambda n: any(w in n.lower() for w in ("gemm", "xmma", "cutlass", "nvjet"))),
    ("memcpy", lambda n: "memcpy" in n.lower()),
)


def moe_data(seed: int, n: int):
    """Inputs and labels that a linear map of the inputs decides."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(size=(n, 784), dtype=np.float32)
    w = rng.standard_normal(size=(784, 10), dtype=np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32).reshape(-1, 1)


def phase_moe_training(compute_dtype: str, card: str, stacked: bool = False) -> dict:
    """Train the MoE model through compile -> grad_step/train_step/fit/eval,
    each against the plain path; the stacked form runs fit only."""
    from flexflow_tpu_torch import kernels, load_numpy_params

    ff = moe_model(compute_dtype, training=True, stacked=stacked)
    cm = ff.compiled
    init = {op: {w: t.detach().cpu().numpy().copy() for w, t in ws.items()}
            for op, ws in cm.params.items()}
    x, y = moe_data(SEED + 5, MOE_TRAIN_SAMPLES)
    xe, ye = moe_data(SEED + 6, 2 * MOE_BATCH)
    batches = [tuple(torch.from_numpy(a[i * MOE_BATCH:(i + 1) * MOE_BATCH]).to(cm.device)
                     for a in (x, y)) for i in range(5)]
    steps = MOE_TRAIN_SAMPLES // MOE_BATCH
    form = "stacked" if stacked else "n-branch"
    what = f"MoE training {form} {compute_dtype}"

    def reset():
        load_numpy_params(ff, init)
        cm.opt_state = cm.optimizer.init_state(cm.params)

    row = dict(compute_dtype=compute_dtype, form=form, card=card, batch=MOE_BATCH)
    if not stacked:
        # (a) one grad_step, (b) five train_steps, on each path
        g_kern = cm.grad_step(cm.params, None, *batches[0])
        g_plain = cm.grad_step(cm.params, None, *batches[0], plain_kernels=True)
        grad_err = tree_err(g_kern, g_plain)
        check(grad_err <= MOE_TOL, f"{what}: grads vs plain path err {grad_err:.3g}")
        losses, final = {}, {}
        for plain in (False, True):
            reset()
            losses[plain] = []
            for xb, yb in batches:
                cm.params, cm.opt_state, loss, _ = cm.train_step(
                    cm.params, cm.opt_state, None, xb, yb, plain_kernels=plain)
                losses[plain].append(loss.item())
            final[plain] = {op: {w: t.clone() for w, t in ws.items()}
                            for op, ws in cm.params.items()}
        loss_err = max(abs(a - b) for a, b in zip(losses[False], losses[True]))
        param_err = tree_err(final[False], final[True])
        check(all(np.isfinite(losses[False])) and loss_err <= MOE_TOL
              and param_err <= MOE_TOL,
              f"{what}: losses {losses[False]} vs plain {losses[True]}, params err "
              f"{param_err:.3g}")
        row.update(grad_err_vs_plain=grad_err, losses=losses[False],
                   plain_losses=losses[True], loss_err_vs_plain=loss_err,
                   param_err_vs_plain=param_err)
        del g_kern, g_plain, final

    # (c) fit through the entry point, launch counts read just around it,
    # against the same steps through the plain path
    reset()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hist = ff.fit(x, y, batch_size=MOE_BATCH, epochs=1, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_moe_launches(launches, steps, 3, f"{what}: fit's {steps} steps")
    fitted = {op: {w: t.clone() for w, t in ws.items()} for op, ws in cm.params.items()}
    reset()
    pm, pm_plain = hist[0], plain_epoch(ff, x, y, train=True)
    fit_err = tree_err(fitted, cm.params)
    check(pm.train_all == MOE_TRAIN_SAMPLES and np.isfinite(pm.sparse_cce_loss)
          and same_metrics(pm, pm_plain) and fit_err <= MOE_TOL,
          f"{what}: fit {pm} vs plain {pm_plain}, params err {fit_err:.3g}")
    row.update(fit_steps=steps, fit_launches=launches, fit_accuracy=pm.accuracy,
               fit_sparse_cce=pm.sparse_cce_loss / pm.train_all,
               fit_param_err_vs_plain=fit_err)
    if stacked:
        print(f"moe training {form} {compute_dtype}: fit {steps} steps, launches "
              f"{launches}, accuracy {pm.accuracy:.4f}, sparse CE "
              f"{row['fit_sparse_cce']:.6f}, equal to the plain path's (params err "
              f"{fit_err:.3g}) [{card}]", flush=True)
        print("moe_training_json " + json.dumps(row), flush=True)
        return row

    # (d) eval through the entry point against the plain path
    kernels.reset_launch_counts()
    pe = ff.eval(xe, ye, batch_size=MOE_BATCH, verbose=False)
    torch.cuda.synchronize()
    check_moe_launches(kernels.launch_counts(), len(xe) // MOE_BATCH, 1, f"{what}: eval")
    pe_plain = plain_epoch(ff, xe, ye, train=False)
    check(same_metrics(pe, pe_plain), f"{what}: eval {pe} vs plain {pe_plain}")

    # (e) step time, a profiled step, peak memory
    xb, yb = batches[0]

    def step():
        cm.train_step(cm.params, cm.opt_state, None, xb, yb)

    step_ms, _, peak_gib = timed_steps(step, 1)
    median_ms = float(np.median(step_ms))
    breakdown = profile_breakdown(step, MOE_CLASSES, other="optimizer/elementwise")
    row.update(eval_accuracy=pe.accuracy, eval_sparse_cce=pe.sparse_cce_loss / pe.train_all,
               step_ms_median=median_ms, step_ms_min=min(step_ms),
               step_ms_max=max(step_ms), samples_per_s=MOE_BATCH * 1e3 / median_ms,
               peak_memory_gib=peak_gib, breakdown=breakdown)
    print(f"moe training {form} {compute_dtype}: grads vs plain path err "
          f"{row['grad_err_vs_plain']:.3g}; 5 steps: losses "
          f"{[f'{v:.6f}' for v in losses[False]]} (balance term included) vs plain err "
          f"{loss_err:.3g}, params err {param_err:.3g}; fit {steps} steps, launches "
          f"{launches}, accuracy {pm.accuracy:.4f} as the plain path's; eval accuracy "
          f"{pe.accuracy:.4f} as the plain path's; step {median_ms:.3f} ms median of "
          f"{TIMED_STEPS}, {row['samples_per_s']:.1f} samples/s, peak {peak_gib:.3f} "
          f"GiB [{card}]", flush=True)
    print(f"moe training breakdown {compute_dtype}: {json.dumps(breakdown)}", flush=True)
    print("moe_training_json " + json.dumps(row), flush=True)
    return row


# ---- serving breadth: repository, batchers, degradation, faults, tracer -


def breadth_burst(engine, xs: np.ndarray, name: str = "transformer") -> dict:
    """Submit every row of ``xs`` at once through ``engine.infer_async``,
    the flash launch count reset just before and read just after; returns
    the answers, req/s, latency percentiles, dispatches and launches."""
    from flexflow_tpu_torch import kernels

    (inst,) = engine.instances(name)
    torch.cuda.synchronize()
    d0 = inst.dispatches
    n = len(xs)
    t_done = [0.0] * n
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    t_submit, futs = [], []
    for i in range(n):
        t_submit.append(time.perf_counter())
        f = engine.infer_async(name, [xs[i]])
        f.add_done_callback(lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
        futs.append(f)
    answers = np.stack([f.result(600) for f in futs])
    counts = kernels.launch_counts()
    wall = max(t_done) - t0
    lat_ms = np.array([(t_done[i] - t_submit[i]) * 1e3 for i in range(n)])
    return dict(answers=answers, requests_per_s=n / wall, wall_s=wall,
                p50_ms=float(np.percentile(lat_ms, 50)), p99_ms=float(np.percentile(lat_ms, 99)),
                dispatches=inst.dispatches - d0, counts=counts,
                launches=counts["flash_attention_fwd"])


def check_served(got: np.ndarray, ref: np.ndarray, tol: float, what: str,
                 scale: float = None) -> float:
    """Answers against the plain path's rows, as a share of the largest
    plain answer (``scale``, by default the largest of ``ref``); returns
    that error."""
    check(got.shape == ref.shape and bool(np.isfinite(got).all()),
          f"{what}: answers of shape {got.shape}, want {ref.shape}, finite")
    scale = float(np.abs(ref).max()) if scale is None else scale
    err = float(np.abs(got - ref).max()) / scale
    check(err <= tol, f"{what}: answers vs plain path {err:.3g} of the largest > {tol}")
    return err


def check_breadth_launches(run: dict, n_attn: int, what: str) -> None:
    check(run["launches"] == n_attn * run["dispatches"]
          and all(v == 0 for k, v in run["counts"].items() if k != "flash_attention_fwd"),
          f"{what}: launched {run['counts']} for {run['dispatches']} dispatches "
          f"(want {n_attn} flash launches a dispatch and nothing else)")


def counter(name: str) -> float:
    from flexflow_tpu_torch.obs import metrics_registry

    m = metrics_registry().get(name)
    return m.value if m is not None else 0.0


def transformer_repository(tmp: pathlib.Path, compute_dtype: str):
    """An engine (the native batcher, or the Python one under
    FLEXFLOW_TPU_NATIVE=off) that load_repository filled with the
    Transformer at the TransformerConfig defaults, batch 8, carrying
    phase_serving's random params (drawn by op order from the same seed).
    The builder sets the compute dtype: compile reads it after the build."""
    from flexflow_tpu_torch import load_numpy_params
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer
    from flexflow_tpu_torch.serving import InferenceEngine

    def build(ff, bs):
        ff.config.compute_dtype = compute_dtype
        build_transformer(ff, bs, TransformerConfig())

    path = tmp / "repository.json"
    path.write_text(json.dumps({"models": {"transformer": {"instances": 1,
                                                           "batch_size": BATCH}}}))
    engine = InferenceEngine()
    placed = engine.load_repository(str(path), builders={"transformer": build})
    check(placed == {"transformer": 1}, f"repository placed {placed}")
    (inst,) = engine.instances("transformer")
    load_numpy_params(inst._ff, random_params(inst._ff, SEED))
    cfg = TransformerConfig()
    engine.infer("transformer", [np.zeros((cfg.sequence_length, cfg.hidden_size), np.float32)],
                 timeout=600)  # warm-up
    return engine, inst


def phase_serving_breadth(card: str, plain: dict) -> dict:
    """The classic engine's breadth on the reference Transformer (the
    serving phase's weights, requests and SERVE_TOL; ``plain``: that
    phase's plain-path answers by dtype) and GPT: (a) load_repository,
    the native batcher against FLEXFLOW_TPU_NATIVE=off, f32 and bf16;
    (b) admission bound and deadlines; (c) the fault plan: worker respawn,
    dispatch retry, then the breaker; (d) a generator entry under the
    worker plan, tokens held to full forwards by the margin rule; (e) the
    tracer's cost and span trees. Returns the phase's row."""
    import os
    import tempfile

    from flexflow_tpu_torch import FFConfig, kernels, load_numpy_params, native_bridge
    from flexflow_tpu_torch.models import TransformerConfig, build_gpt
    from flexflow_tpu_torch.obs import configure_tracer, tracer, validate_chrome_trace
    from flexflow_tpu_torch.runtime import faults
    from flexflow_tpu_torch.serving import (DeadlineExceeded, InferenceEngine, ShedError)
    from flexflow_tpu_torch.serving.engine import _PyBatcher

    cfg = TransformerConfig()
    rng = np.random.default_rng(SEED + 1)  # phase_serving's requests
    xs = rng.standard_normal(size=(REQUESTS, cfg.sequence_length, cfg.hidden_size),
                             dtype=np.float32)
    n_attn = cfg.num_layers
    row = dict(card=card, requests=REQUESTS)
    launches = 0
    tmpdir = tempfile.TemporaryDirectory()
    tmp = pathlib.Path(tmpdir.name)

    # (a) repository and batchers: both engines loaded, their bursts in
    # turns (native, python, python, native) so drift hits both alike
    f32_engines = None
    for compute_dtype in ("float32", "bfloat16"):
        engines = {}
        for batcher in ("native", "python"):
            if batcher == "python":
                os.environ["FLEXFLOW_TPU_NATIVE"] = "off"
            try:
                engines[batcher] = transformer_repository(tmp, compute_dtype)
            finally:
                os.environ.pop("FLEXFLOW_TPU_NATIVE", None)
            kind = type(engines[batcher][0]._batchers["transformer"])
            want = native_bridge.NativeBatcher if batcher == "native" else _PyBatcher
            check(kind is want, f"{batcher} engine serves through {kind.__name__}")
        runs = {"native": [], "python": []}
        for batcher in ("native", "python", "python", "native"):
            run = breadth_burst(engines[batcher][0], xs)
            what = f"serving breadth {compute_dtype} {batcher}"
            check_breadth_launches(run, n_attn, what)
            run["rel_err_vs_plain"] = check_served(
                run["answers"], plain[compute_dtype], SERVE_TOL[compute_dtype], what)
            launches += run["launches"]
            runs[batcher].append({k: v for k, v in run.items()
                                  if k not in ("answers", "counts")})
        row[compute_dtype] = runs
        for batcher, rs in runs.items():
            print(f"serving breadth (a) {compute_dtype} {batcher} batcher "
                  f"({type(engines[batcher][0]._batchers['transformer']).__name__}), two "
                  f"bursts in turns: {REQUESTS} requests in {[r['dispatches'] for r in rs]} "
                  f"dispatches, {[r['launches'] for r in rs]} flash launches, req/s "
                  f"{[round(r['requests_per_s'], 2) for r in rs]}, p50 ms "
                  f"{[round(r['p50_ms'], 1) for r in rs]}, p99 ms "
                  f"{[round(r['p99_ms'], 1) for r in rs]}; err vs plain "
                  f"{max(r['rel_err_vs_plain'] for r in rs):.3g} [{card}]", flush=True)
        if compute_dtype == "float32":
            f32_engines = engines
        else:
            for engine, _ in engines.values():
                engine.stop()
        del engines
        gc.collect()
        torch.cuda.empty_cache()

    # (e) the tracer on (a)'s f32 native burst, in turns: off, on, on, off
    engine, inst = f32_engines["native"]
    tr = tracer()
    trace_runs = {"off": [], "on": []}
    for on in (False, True, True, False):
        configure_tracer(enabled=on)
        tr.clear()
        r = breadth_burst(engine, xs)
        configure_tracer(enabled=False)
        check_breadth_launches(r, n_attn, f"serving breadth float32 trace={on}")
        check_served(r["answers"], plain["float32"], SERVE_TOL["float32"],
                     f"serving breadth float32 trace={on}")
        launches += r["launches"]
        if on:
            check_spans(tr.events(), REQUESTS, validate_chrome_trace)
        trace_runs["on" if on else "off"].append((r["requests_per_s"], tr.event_count()))
    off = [rps for rps, _ in trace_runs["off"]]
    on_rps = [rps for rps, _ in trace_runs["on"]]
    row["tracer"] = dict(requests_per_s_off=off, requests_per_s_on=on_rps,
                         events_per_burst=trace_runs["on"][0][1],
                         events_off=trace_runs["off"][0][1],
                         cost_share=1 - sum(on_rps) / sum(off))
    t = row["tracer"]
    print(f"serving breadth (e) tracer float32: req/s off {t['requests_per_s_off']}, "
          f"on {t['requests_per_s_on']}, {t['events_per_burst']} events a burst "
          f"({t['events_off']} with the tracer off), cost {t['cost_share']:.3g} of req/s; "
          f"every request's five spans nested [{card}]", flush=True)
    for eng, _ in f32_engines.values():
        eng.stop()
    ff32 = inst._ff
    del f32_engines, engine, inst
    f32_native = row["float32"]["native"]
    served_ms = (sum(r["wall_s"] for r in f32_native) * 1e3
                 / sum(r["dispatches"] for r in f32_native))
    ref32 = plain["float32"]
    scale32 = float(np.abs(ref32).max())

    # (b) admission bound and deadlines: 256 requests at once
    deadline_s = 2 * served_ms / 1e3
    eng = InferenceEngine(admission_limit=16, default_deadline_s=deadline_s)
    binst = eng.register_ffmodel(ff32, "transformer")
    shed0, rej0 = counter("serving.shed"), counter("serving.deadline_rejects")
    kernels.reset_launch_counts()
    d0 = binst.dispatches
    accepted, shed = [], 0
    for i in range(256):
        try:
            accepted.append((i % REQUESTS, eng.infer_async("transformer", [xs[i % REQUESTS]])))
        except ShedError:
            shed += 1
    rejected = 0
    got, want = [], []
    for j, f in accepted:
        try:
            got.append(f.result(600))
        except DeadlineExceeded:
            rejected += 1
            continue
        want.append(ref32[j])
    served = len(got)
    counts = kernels.launch_counts()
    if got:
        check_served(np.stack(got), np.stack(want), SERVE_TOL["float32"],
                     "serving breadth (b)", scale32)
    eng.stop()
    b = dict(submitted=256, accepted=len(accepted), shed=shed, deadline_rejected=rejected,
             served=served, deadline_s=deadline_s, dispatches=binst.dispatches - d0,
             shed_counter=counter("serving.shed") - shed0,
             deadline_counter=counter("serving.deadline_rejects") - rej0,
             launches=counts["flash_attention_fwd"], counts=counts)
    check(served + rejected == len(accepted) and shed + len(accepted) == 256
          and 0 < shed and served > 0,
          f"serving breadth (b): {b}")
    check(b["shed_counter"] == shed and b["deadline_counter"] == rejected,
          f"serving breadth (b): counters {b['shed_counter']} shed, "
          f"{b['deadline_counter']} rejected; counted {shed}, {rejected}")
    check_breadth_launches(b, n_attn, "serving breadth (b)")
    launches += b["launches"]
    del b["counts"]
    row["degradation"] = b
    print(f"serving breadth (b) float32: 256 at once, admission 16, deadline "
          f"{deadline_s * 1e3:.1f} ms: {len(accepted)} accepted, {shed} shed "
          f"(serving.shed +{b['shed_counter']:g}), {rejected} deadline-rejected "
          f"(serving.deadline_rejects +{b['deadline_counter']:g}), {served} served right in "
          f"{b['dispatches']} dispatches [{card}]", flush=True)

    # (c) the fault plan: a worker crash at the third batch, two transient
    # dispatch failures, both below the budgets; then the breaker
    plan = {"schema": 1, "seed": 0, "sites": {"serving.worker": {"at_step": 3},
                                              "device_put.transient": {"p": 0.2,
                                                                       "max_fires": 2}}}
    before = {k: counter(k) for k in ("serving.worker_respawns", "retry.serving_dispatch.retries",
                                       "retry.serving_dispatch.giveups", "faults.fired")}
    ff32.config.fault_plan = plan
    eng = InferenceEngine(worker_retry_budget=2)
    cinst = eng.register_ffmodel(ff32, "transformer")  # arms the plan
    ff32.config.fault_plan = None
    check(faults.active(), "serving breadth (c): the plan is not armed")
    run = breadth_burst(eng, xs)
    eng.stop()
    faults.configure_faults(None)
    c = {k.split(".", 1)[1]: counter(k) - v for k, v in before.items()}
    c.update(dispatches=run["dispatches"], launches=run["launches"])
    check(c["worker_respawns"] >= 1 and c["serving_dispatch.retries"] >= 1
          and c["serving_dispatch.giveups"] == 0,
          f"serving breadth (c): {c}")
    check_breadth_launches(run, n_attn, "serving breadth (c)")
    c["rel_err_vs_plain"] = check_served(run["answers"], ref32, SERVE_TOL["float32"],
                                         "serving breadth (c)")
    launches += run["launches"]
    # the breaker: two failing batches open it, it sheds, the cooldown
    # closes it and traffic resumes
    eng = InferenceEngine(breaker_threshold=2, breaker_cooldown_s=0.5)
    inst = eng.register_ffmodel(ff32, "transformer")
    real = inst.infer
    inst.infer = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("dead backend"))
    opens = counter("serving.breaker_opens")
    failed = 0
    for _ in range(2):
        try:
            eng.infer_async("transformer", [xs[0]]).result(600)
        except RuntimeError as e:
            failed += str(e) == "dead backend"
    try:
        eng.infer_async("transformer", [xs[0]])
        shed_fast = False
    except ShedError:
        shed_fast = True
    check(failed == 2 and shed_fast,
          f"serving breadth (c): {failed} of 2 batches failed, shed at once: {shed_fast}")
    inst.infer = real
    time.sleep(0.55)
    kernels.reset_launch_counts()
    got = eng.infer_async("transformer", [xs[0]]).result(600)
    counts = kernels.launch_counts()
    eng.stop()
    launches += counts["flash_attention_fwd"]
    check_breadth_launches(dict(launches=counts["flash_attention_fwd"], dispatches=1,
                                counts=counts), n_attn, "serving breadth (c) breaker")
    check(counter("serving.breaker_opens") - opens == 1,
          f"serving breadth (c): the breaker opened {counter('serving.breaker_opens') - opens}x")
    check_served(got[None], ref32[:1], SERVE_TOL["float32"], "serving breadth (c) breaker",
                 scale32)
    c["breaker"] = "opened after 2 failures, shed, closed after 0.5 s, served"
    row["faults"] = c
    print(f"serving breadth (c) float32 under {json.dumps(plan['sites'])}: {REQUESTS} "
          f"requests all answered right in {c['dispatches']} dispatches, "
          f"{c['worker_respawns']:g} respawns, {c['serving_dispatch.retries']:g} dispatch "
          f"retries, {c['fired']:g} faults fired, err vs plain {c['rel_err_vs_plain']:.3g}; "
          f"breaker {c['breaker']} [{card}]", flush=True)
    del ff32, inst, cinst, binst

    # (d) a generator entry under the worker plan
    path = tmp / "repository_gpt.json"
    path.write_text(json.dumps({"models": {"gpt": {
        "generator": True, "decode_slots": PAGED_SLOTS, "block_size": PAGED_BLOCK,
        "max_length": GEN_MAX_LENGTH}}}))
    eng = InferenceEngine()
    placed = eng.load_repository(str(path), builders={
        "gpt": lambda ff, bs: build_gpt(ff, bs, GPT_SEQ, gpt_config())})
    check(placed == {"gpt": 1}, f"repository placed {placed}")
    ginst = eng.generator("gpt")
    gff = ginst._ff
    load_numpy_params(gff, gpt_params(gff, SEED + 8))
    ginst.decoder.invalidate_params_cache()
    gplan = {"schema": 1, "seed": 0, "sites": {"serving.worker": {"at_step": 5}}}
    faults.configure_faults(FFConfig(device=DEVICE, fault_plan=gplan))
    traffic = paged_traffic(SEED + 11)[:16]
    respawns = counter("serving.worker_respawns")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [eng.generate_async("gpt", p, n) for p, n in traffic]
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    serve_counts = kernels.launch_counts()
    stats = ginst.stats()
    eng.stop()
    faults.configure_faults(None)
    d = dict(requests=len(traffic), generated=sum(n for _, n in traffic), wall_s=wall,
             tokens_per_s=sum(n for _, n in traffic) / wall,
             respawns=counter("serving.worker_respawns") - respawns,
             completed=stats["completed"], decode_steps=stats["decode_steps"])
    check(d["respawns"] >= 1 and d["completed"] == len(traffic)
          and stats["kv"]["in_use"] == 0 and all(v == 0 for v in serve_counts.values()),
          f"serving breadth (d): {d}, pool in use {stats['kv']['in_use']}, "
          f"launches while serving {serve_counts}")
    for (prompt, n), out in zip(traffic, outs):
        check(out.shape == (prompt.size + n,) and np.array_equal(out[:prompt.size], prompt),
              f"serving breadth (d): an answer of shape {out.shape}")
    cm = gff.compiled
    kernels.reset_launch_counts()
    margins = full_forward_margins(cm, traffic, outs)
    torch.cuda.synchronize()
    fwd_counts = kernels.launch_counts()
    check_flash_launches(fwd_counts, 6 * len(traffic), 0, "serving breadth (d) full forwards")
    launches += fwd_counts["flash_attention_fwd"]
    tol = GEN_TOL["float32"]
    decided_n = checked = 0
    for i, ((prompt, _), out) in enumerate(zip(traffic, outs)):
        argmax, margin, scale = margins[i]
        decided = margin > tol * scale
        agree = out[prompt.size:] == argmax
        check(bool(agree[decided].all()), f"serving breadth (d): request {i}'s greedy tokens "
              f"differ from the full forward's argmax at {int((~agree & decided).sum())} "
              f"decided positions")
        decided_n += int(decided.sum())
        checked += decided.size
    argmax_outs = [np.concatenate([p, m[0].astype(np.int32)]) for (p, _), m in zip(traffic, margins)]
    parted, worst = first_divergences(outs, argmax_outs, margins, [tol * m[2] for m in margins])
    d.update(full_forward_launches=fwd_counts["flash_attention_fwd"], greedy_checked=decided_n,
             greedy_positions=checked, parted_from_argmax=parted)
    row["generator"] = d
    print(f"serving breadth (d) GPT float32 generator entry under serving.worker at_step 5: "
          f"{len(traffic)} requests all resolved, {d['respawns']:g} respawns, "
          f"{d['generated']} tokens at {d['tokens_per_s']:.1f} tokens/s; greedy tokens equal "
          f"the full forward's argmax (flash launches {d['full_forward_launches']}) at all "
          f"{decided_n} of {checked} decided positions [{card}]", flush=True)
    del eng, ginst, gff, cm
    tmpdir.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    row["launches"] = launches
    print("serving_breadth_json " + json.dumps(row), flush=True)
    return row


# ---- the rest of the model zoo -------------------------------------------


SPARSE_CE, MSE = "SPARSE_CATEGORICAL_CROSSENTROPY", "MEAN_SQUARED_ERROR_AVG_REDUCE"
# device kernel classes of a profiled zoo step
ZOO_CLASSES = (
    ("conv", lambda n: any(w in n.lower() for w in (
        "conv", "cudnn", "fprop", "dgrad", "wgrad", "winograd", "fft", "implicit"))),
    ("gemm", lambda n: any(w in n.lower() for w in ("gemm", "xmma", "cutlass", "nvjet"))),
    ("memcpy", lambda n: "memcpy" in n.lower()),
)


def zoo_models() -> dict:
    """name -> (build(ff, batch) -> the model's output, loss, SGD momentum)."""
    from flexflow_tpu_torch import models as m

    return {
        "resnet50": (lambda ff, b: m.build_resnet50(ff, b, use_bn=True)[1], SPARSE_CE,
                     ZOO_MOMENTUM),
        "dlrm": (lambda ff, b: m.build_dlrm(ff, b)[1], MSE, 0.0),
        "alexnet": (lambda ff, b: m.build_alexnet(ff, b)[1], SPARSE_CE, 0.0),
        "resnext50": (lambda ff, b: m.build_resnext50(ff, b)[1], SPARSE_CE, 0.0),
        "inception_v3": (lambda ff, b: m.build_inception_v3(ff, b)[1], SPARSE_CE, 0.0),
        "xdl": (lambda ff, b: m.build_xdl(ff, b)[1], MSE, 0.0),
        "candle_uno": (lambda ff, b: m.build_candle_uno(ff, b)[1], MSE, 0.0),
        "nmt": (lambda ff, b: m.build_nmt(ff, b)[2], SPARSE_CE, 0.0),
    }


def zoo_model(name: str, batch: int, device: str, compute_dtype=None, train: bool = True):
    """The zoo model compiled for training (SGD, its loss and the loss as
    the metric), or for its pre-softmax forward alone."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, MetricsType, SGDOptimizer

    build, loss, momentum = zoo_models()[name]
    ff = FFModel(FFConfig(batch_size=batch, seed=SEED, device=device,
                          compute_dtype=compute_dtype))
    out = build(ff, batch)
    if train:
        metric = (MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY if loss == SPARSE_CE
                  else MetricsType.MEAN_SQUARED_ERROR)
        ff.compile(SGDOptimizer(lr=ZOO_LR, momentum=momentum), getattr(LossType, loss),
                   metrics=[metric])
    else:
        layer = out.owner_layer
        ff.compile(logits_tensor=layer.inputs[0] if layer.op_type.name == "SOFTMAX" else out)
    return ff


def zoo_inputs(cm, n: int, rng) -> list:
    """n samples of every input: ids within their table, the rest normal."""
    xs = []
    for t in cm.input_tensors:
        if t.dtype.name == "INT32":
            vocab = min(op.attrs["num_entries"] for op in cm.ops
                        if op.op_type.name == "EMBEDDING"
                        and op.layer.inputs[0].tensor_id == t.tensor_id)
            xs.append(rng.integers(0, vocab, size=(n,) + t.dims[1:], dtype=np.int32))
        else:
            xs.append(rng.standard_normal(size=(n,) + t.dims[1:], dtype=np.float32))
    return xs


def zoo_labels(cm, n: int, rng) -> np.ndarray:
    dims = tuple(cm.logits_tensor.dims)
    if cm.loss_type.name == SPARSE_CE:
        return rng.integers(0, dims[-1], size=(n,) + dims[1:-1], dtype=np.int32).reshape(n, -1)
    return rng.random(size=(n,) + dims[1:], dtype=np.float32)


def zoo_forward_flops(cm) -> float:
    """Multiply-adds x 2 of one forward: convolutions, recurrences, dense."""
    total = 0.0
    for op in cm.ops:
        if hasattr(op, "flops"):
            total += op.flops()
        elif op.op_type.name == "LINEAR":
            total += 2.0 * float(np.prod(op.output_shapes[0].sizes)) * op.in_dim
    return total


def weights_by_order(cm) -> list:
    """The params as numpy, one dict per weighted op in graph order (two
    builds of one model name their unnamed layers differently)."""
    return [{w: t.detach().float().cpu().numpy() for w, t in cm.params[op.name].items()}
            for op in cm.ops if op.name in cm.params]


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def zoo_agreement(name: str, weights: list, card: str) -> dict:
    """The model's pre-softmax forward on the card and on the CPU, f32 and
    bf16, at batch ZOO_CHECK_BATCH with ``weights``: the card's f32 against
    the CPU's within ZOO_F32_TOL, the card's bf16 within BF16_FLOOR_FACTOR
    times the CPU bf16 path's distance from the CPU f32 one."""
    from flexflow_tpu_torch import load_numpy_params

    outs, xs = {}, None
    for device in (DEVICE, "cpu"):
        for dt in ("float32", "bfloat16"):
            ff = zoo_model(name, ZOO_CHECK_BATCH, device, None if dt == "float32" else dt,
                           train=False)
            cm = ff.compiled
            names = [op.name for op in cm.ops if op.name in cm.params]
            load_numpy_params(ff, dict(zip(names, weights)))
            if xs is None:
                xs = zoo_inputs(cm, ZOO_CHECK_BATCH, np.random.default_rng(SEED + 40))
            out = cm.forward_fn(cm.params, *(torch.from_numpy(a).to(cm.device) for a in xs))
            outs[(device, dt)] = out.float().cpu().numpy()
            del ff, cm, out
    ref = outs[("cpu", "float32")]
    row = dict(max_abs_logit=float(np.abs(ref).max()),
               f32_err=rel_err(outs[(DEVICE, "float32")], ref),
               bf16_err=rel_err(outs[(DEVICE, "bfloat16")], ref),
               cpu_bf16_err=rel_err(outs[("cpu", "bfloat16")], ref))
    row["bf16_bound"] = BF16_FLOOR_FACTOR * row["cpu_bf16_err"]
    check(all(np.isfinite(v).all() for v in outs.values()), f"{name}: a forward is not finite")
    check(row["f32_err"] <= ZOO_F32_TOL and row["bf16_err"] <= row["bf16_bound"],
          f"{name} card vs CPU: {row}")
    print(f"zoo {name} card vs cpu at batch {ZOO_CHECK_BATCH}: f32 {row['f32_err']:.3g} of the "
          f"largest |logit| {row['max_abs_logit']:.4g} (tol {ZOO_F32_TOL:g}), bf16 "
          f"{row['bf16_err']:.3g} (bound {row['bf16_bound']:.3g}: twice the CPU bf16 "
          f"path's {row['cpu_bf16_err']:.3g}) [{card}]", flush=True)
    return row


def fit_loss(pm, cm) -> float:
    """The epoch's mean loss from fit's accumulated metrics."""
    if cm.loss_type.name == SPARSE_CE:
        return pm.sparse_cce_loss / max(1, pm.train_all)
    return pm.mse_loss / max(1, pm.train_all * int(np.prod(cm.logits_tensor.dims[1:])))


def bn_stats_reference(conv, bn, params: dict, x: np.ndarray, compute_dtype) -> tuple:
    """(running mean, running var) that ``bn`` (after ``conv``, the
    model's first layers) should hold after one step on ``x``: the conv in
    float64 from the inputs and weights as the step sees them (under bf16:
    rounded to bf16, the output rounded and the bias added in bf16, as the
    step does), the batch mean and unbiased variance over N, H, W in
    float64, and the momentum-0.1 update."""
    import torch.nn.functional as F

    cast = (lambda t: t.to(torch.bfloat16)) if compute_dtype else (lambda t: t)
    p = params[conv.name]
    xin = cast(torch.from_numpy(x).to(DEVICE)).double()
    y = F.conv2d(xin, cast(p["kernel"]).double(), None, conv.stride, conv.padding, 1,
                 conv.groups)
    if compute_dtype:
        # the step rounds the conv's output to bf16 and adds the bias in
        # bf16: on a bf16 value c, c + b rounds to c plus b in whole units
        # of c's last place, an error the same for every c of a binade,
        # which the mean does not average away
        y = (y.to(torch.bfloat16) + cast(p["bias"])[None, :, None, None]).double()
    else:
        y = y + p["bias"].double()[None, :, None, None]
    var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=1)
    q = params[bn.name]
    return (0.9 * q["running_mean"].double() + 0.1 * mean,
            0.9 * q["running_var"].double() + 0.1 * var)


def zoo_full_width(name: str, compute_dtype: str, card: str) -> tuple:
    """ResNet-50 or DLRM at full width and batch ZOO_BATCH: ZOO_FIT_STEPS
    steps of fit (one batch each; ResNet's first batch norm's statistics
    held to bn_stats_reference after each), eval, one served burst of
    ZOO_BATCH requests, then the step time (median of TIMED_STEPS after
    warm-up, by CUDA events), a profiled step and the peak memory. Returns
    (row, the f32 weights by op order or None)."""
    from flexflow_tpu_torch.serving import InferenceEngine

    dt = None if compute_dtype == "float32" else compute_dtype
    ff = zoo_model(name, ZOO_BATCH, DEVICE, dt)
    cm = ff.compiled
    rng = np.random.default_rng(SEED + 41)
    n = ZOO_BATCH * ZOO_FIT_STEPS
    xs, y = zoo_inputs(cm, n, rng), zoo_labels(cm, n, rng)
    conv = next((op for op in cm.ops if op.op_type.name == "CONV2D"), None)
    bn = next((op for op in cm.ops if op.op_type.name == "BATCHNORM"), None)
    losses, stats_err = [], 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ZOO_FIT_STEPS):
        rows = slice(i * ZOO_BATCH, (i + 1) * ZOO_BATCH)
        want = bn_stats_reference(conv, bn, cm.params, xs[0][rows], dt) if bn else None
        pm = ff.fit([a[rows] for a in xs], y[rows], shuffle=False, verbose=False)[0]
        losses.append(fit_loss(pm, cm))
        if bn:
            for got, ref in zip((cm.params[bn.name]["running_mean"],
                                 cm.params[bn.name]["running_var"]), want):
                stats_err = max(stats_err, rel_err(got.double().cpu().numpy(),
                                                   ref.cpu().numpy()))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(all(np.isfinite(losses)), f"{name} {compute_dtype}: fit losses {losses}")
    if bn:
        check(stats_err <= ZOO_STATS_TOL[compute_dtype],
              f"{name} {compute_dtype}: running statistics {stats_err:.3g} from the float64 "
              f"reference (tol {ZOO_STATS_TOL[compute_dtype]:g})")
    ev = ff.eval([a[:ZOO_BATCH] for a in xs], y[:ZOO_BATCH], verbose=False)
    eval_loss = fit_loss(ev, cm)
    check(np.isfinite(eval_loss), f"{name} {compute_dtype}: eval loss {eval_loss}")
    eng = InferenceEngine()
    try:
        eng.register_ffmodel(ff, name)
        t0 = time.perf_counter()
        futs = [eng.infer_async(name, [a[j] for a in xs]) for j in range(ZOO_BATCH)]
        served = np.stack([f.result(300) for f in futs])
        serve_s = time.perf_counter() - t0
    finally:
        eng.stop()
    xb = [torch.from_numpy(a[:ZOO_BATCH]).to(cm.device) for a in xs]
    direct = cm.forward_fn(cm.params, *xb).cpu().numpy()
    serve_err = rel_err(served, direct)
    check(np.isfinite(served).all() and serve_err <= ZOO_SERVE_TOL,
          f"{name} {compute_dtype}: served answers {serve_err:.3g} from the forward")
    weights = weights_by_order(cm) if compute_dtype == "float32" else None
    yb = torch.from_numpy(y[:ZOO_BATCH]).to(cm.device)

    def step():
        cm.train_step(cm.params, cm.opt_state, None, *xb, yb)

    step_ms, _, peak = timed_steps(step, 1)
    ms = float(np.median(step_ms))
    prof = profile_breakdown(step, ZOO_CLASSES)
    flops = 3.0 * zoo_forward_flops(cm)
    row = dict(model=name, compute_dtype=compute_dtype, card=card, batch=ZOO_BATCH,
               fit_steps=ZOO_FIT_STEPS, fit_losses=losses, fit_s=fit_s, eval_loss=eval_loss,
               serve_requests=ZOO_BATCH, serve_s=serve_s, serve_err=serve_err,
               running_stats_err=stats_err if bn else None, step_ms=ms,
               step_ms_p90=float(np.percentile(step_ms, 90)),
               samples_per_s=ZOO_BATCH / (ms / 1e3), train_flops=flops,
               model_tflops=flops / (ms / 1e3) / 1e12, peak_gib=peak,
               device_busy_share=1.0 - prof["device_idle_share"], breakdown=prof)
    print(f"zoo {name} {compute_dtype}: fit {ZOO_FIT_STEPS} steps of batch {ZOO_BATCH} in "
          f"{fit_s:.2f} s, losses {[round(v, 5) for v in losses]}, eval loss "
          f"{eval_loss:.5f}"
          + (f", first batch norm's running stats {stats_err:.3g} from float64 (tol "
             f"{ZOO_STATS_TOL[compute_dtype]:g})" if bn else "")
          + f"; served {ZOO_BATCH} requests in {serve_s:.2f} s (err {serve_err:.3g}); "
          f"step {ms:.2f} ms (median of {len(step_ms)}, p90 {row['step_ms_p90']:.2f}), "
          f"{row['samples_per_s']:.1f} samples/s, {row['model_tflops']:.2f} model TFLOP/s "
          f"({flops / 1e12:.3f} TFLOP a step), device busy "
          f"{row['device_busy_share']:.3f} of a profiled step, peak {peak:.2f} GiB [{card}]",
          flush=True)
    print(f"zoo {name} {compute_dtype} breakdown " + json.dumps(
        {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                              "device_ms_by_class", "top_kernels_ms")}), flush=True)
    del ff, cm, eng, xb, yb
    return row, weights


def zoo_default(name: str, compute_dtype: str, card: str) -> tuple:
    """A model at its build function's defaults and batch ZOO_BATCH: one fit step
    (finite loss) and its forward's time (mean of 5 by CUDA events after
    2 warm-ups). Returns (row, the f32 weights by op order or None)."""
    dt = None if compute_dtype == "float32" else compute_dtype
    ff = zoo_model(name, ZOO_BATCH, DEVICE, dt)
    cm = ff.compiled
    rng = np.random.default_rng(SEED + 42)
    xs, y = zoo_inputs(cm, ZOO_BATCH, rng), zoo_labels(cm, ZOO_BATCH, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = fit_loss(ff.fit(xs, y, shuffle=False, verbose=False)[0], cm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(np.isfinite(loss), f"{name} {compute_dtype}: fit loss {loss}")
    xb = [torch.from_numpy(a).to(cm.device) for a in xs]
    fwd_ms = time_ms(lambda: cm.forward_fn(cm.params, *xb), iters=5, warmup=2)
    n_params = sum(t.numel() for ws in cm.params.values() for t in ws.values())
    row = dict(model=name, compute_dtype=compute_dtype, card=card, batch=ZOO_BATCH,
               params=n_params, fit_loss=loss, fit_step_s=fit_s, forward_ms=fwd_ms,
               forward_flops=zoo_forward_flops(cm))
    print(f"zoo {name} {compute_dtype}: {n_params / 1e6:.1f}M params, one fit step of batch "
          f"{ZOO_BATCH} in {fit_s:.2f} s (loss {loss:.5f}), forward {fwd_ms:.2f} ms "
          f"({row['forward_flops'] / 1e9:.1f} GFLOP) [{card}]", flush=True)
    weights = weights_by_order(cm) if compute_dtype == "float32" else None
    del ff, cm, xb
    return row, weights


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_zoo(card: str) -> dict:
    """The rest of the zoo on the card: ResNet-50 (batch norm) and DLRM at
    full width, the other six at their build functions' defaults, in float32 and
    bfloat16; each model's forward held to the CPU's. The zoo runs none of
    the port's kernels (cuDNN convolutions, cuBLAS products, torch ops), so
    its launch counts must stay 0."""
    from flexflow_tpu_torch import kernels

    kernels.reset_launch_counts()
    rows, agree = [], {}
    for name in ("resnet50", "dlrm"):
        weights = None
        for dt in ("float32", "bfloat16"):
            row, w = zoo_full_width(name, dt, card)
            rows.append(row)
            weights = w if w is not None else weights
            free_device()
        agree[name] = zoo_agreement(name, weights, card)
        del weights
        free_device()
    for name in ("alexnet", "resnext50", "inception_v3", "xdl", "candle_uno", "nmt"):
        weights = None
        for dt in ("float32", "bfloat16"):
            row, w = zoo_default(name, dt, card)
            rows.append(row)
            weights = w if w is not None else weights
            free_device()
        agree[name] = zoo_agreement(name, weights, card)
        del weights
        free_device()
    launches = kernels.launch_counts()
    check(not any(launches.values()), f"the zoo launched the port's kernels: {launches}")
    cuts = (f"ResNet-50 and DLRM: {ZOO_FIT_STEPS} fit steps and {TIMED_STEPS} timed steps; "
            f"the other six: one fit step and 5 timed forwards; every card-vs-CPU check at "
            f"batch {ZOO_CHECK_BATCH}")
    print(f"zoo cuts: {cuts}", flush=True)
    out = {"rows": rows, "agreement": agree, "cuts": cuts}
    print("zoo_json " + json.dumps(out, default=float), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: training robustness and dynamic shapes
def rob_gpt(compute_dtype: str, **cfg):
    """GPT at GPTConfig()'s width for this phase: Adam at ROB_ALPHA, sparse
    CE with accuracy and CE metrics, the config's extra knobs ``cfg``."""
    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel, LossType,
                                    MetricsType)
    from flexflow_tpu_torch.models import build_gpt

    ff = FFModel(FFConfig(batch_size=GPT_BATCH, compute_dtype=compute_dtype, seed=SEED,
                          device=DEVICE, **cfg))
    build_gpt(ff, GPT_BATCH, GPT_SEQ, gpt_config())
    ff.compile(AdamOptimizer(alpha=ROB_ALPHA), LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def ragged_gpt_data(n: int):
    """``n`` rows of random tokens whose lengths are drawn (seed 0)
    uniformly from ROB_LEN; tokens 0 and labels -1 past each length."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(ROB_LEN[0], ROB_LEN[1] + 1, size=n)
    tok = rng.integers(0, gpt_config().vocab_size, size=(n, GPT_SEQ + 1), dtype=np.int32)
    x, y = tok[:, :-1].copy(), tok[:, 1:].copy()
    pad = np.arange(GPT_SEQ)[None, :] >= lengths[:, None]
    x[pad] = 0
    y[pad] = -1
    pos = np.broadcast_to(np.arange(GPT_SEQ, dtype=np.int32), (n, GPT_SEQ)).copy()
    return x, pos, y


def device_copy(tree: dict) -> dict:
    return {op: {w: t.detach().clone() for w, t in ws.items()} for op, ws in tree.items()}


def load_tree(ff, tree: dict) -> None:
    """Copy a params tree into the model in place, with a fresh optimizer
    state."""
    cm = ff.compiled
    with torch.no_grad():
        for op, ws in tree.items():
            for w, t in ws.items():
                cm.params[op][w].copy_(t)
    cm.opt_state = cm.optimizer.init_state(cm.params)


class StepRecorder:
    """Wraps a compiled model's train_step for one fit: each step's width
    and rows (from its labels), loss, CUDA-event time and flash launches.
    Records nothing on the device's critical path but two events."""

    def __init__(self, cm, keep_batches: bool = False):
        self.cm, self.inner, self.keep = cm, cm.train_step, keep_batches
        self.steps, self.batches = [], {}
        cm.train_step = self

    def __call__(self, *args, **kw):
        from flexflow_tpu_torch import kernels

        before = kernels.launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.inner(*args, **kw)
        end.record()
        after = kernels.launch_counts()
        rows, width = args[-1].shape[0], args[-1].shape[1]
        if self.keep and width not in self.batches:
            self.batches[width] = [a.clone() for a in args[3:]]
        self.steps.append(dict(width=int(width), rows=int(rows), loss=out[2], start=start,
                               end=end, launches={k: after[k] - before[k] for k in after}))
        return out

    def close(self) -> list:
        self.cm.train_step = self.inner
        torch.cuda.synchronize()
        for s in self.steps:
            s["ms"] = s.pop("start").elapsed_time(s.pop("end"))
            s["loss"] = s["loss"].item()
        return self.steps


def by_width(steps: list) -> dict:
    """{width: {dispatches, rows, flash launches}} of recorded steps."""
    out = {}
    for s in steps:
        row = out.setdefault(s["width"], {"dispatches": 0, "rows": [], **{
            k: 0 for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv")}})
        row["dispatches"] += 1
        if s["rows"] not in row["rows"]:
            row["rows"].append(s["rows"])
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            row[k] += s["launches"][k]
    return dict(sorted(out.items()))


def rob_fit(ff, x, pos, y, shuffle: bool, keep_batches: bool = False) -> dict:
    """One fit epoch through the entry point with the launch counts set to
    0 just before and read just after; the steps it recorded."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.obs.metrics import metrics_registry

    compiles0 = metrics_registry().counter("fit.bucket_compiles").value
    rec = StepRecorder(ff.compiled, keep_batches)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    (pm,) = ff.fit([x, pos], y, epochs=1, shuffle=shuffle, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    steps = rec.close()
    summed = {k: sum(s["launches"][k] for s in steps) for k in launches}
    check(summed == launches, f"launches by step {summed} vs the fit's {launches}")
    return dict(pm=pm, wall_s=wall, steps=steps, launches=launches, batches=rec.batches,
                profile=ff.fit_profile,
                bucket_compiles=int(metrics_registry().counter("fit.bucket_compiles").value
                                    - compiles0))


def rob_bucket_order(compute_dtype: str, card: str, order: str, ref: dict = None) -> tuple:
    """One data order of (a): GPT at GPTConfig() through one bucketed fit
    epoch (pow2 buckets from 8, token budget ROB_BUDGET) and the same epoch
    padded to the ladder's top, from the same init, then a timed epoch of
    each. ``order``: "shuffled" (fit's shuffle over the rows as drawn) or
    "sorted" (the rows sorted by length, no shuffle: groups of like
    lengths, so the dispatches take several widths and row counts; there
    also one step's gradients at the ragged widths are held to the plain
    kernels' path and to the same rows padded to 1024). ``ref``: the float32
    run's numbers, which set the bfloat16 bounds. Returns (row, ref)."""
    from flexflow_tpu_torch.runtime.buckets import (PackingSpec, build_epoch_plan,
                                                    plan_token_stats, resolve_ladder,
                                                    row_lengths)

    what = f"robustness buckets {compute_dtype} {order}"
    x, pos, y = ragged_gpt_data(ROB_ROWS)
    shuffle = order == "shuffled"
    if not shuffle:
        by_len = np.argsort((y >= 0).sum(axis=1), kind="stable")
        x, pos, y = x[by_len], pos[by_len], y[by_len]
    knobs = dict(seq_buckets="pow2", seq_bucket_min=8, token_budget=ROB_BUDGET)
    ffs = {"bucketed": rob_gpt(compute_dtype, **knobs),
           "pad_max": rob_gpt(compute_dtype, seq_bucket_pad_max="on", **knobs)}
    init = device_copy(ffs["bucketed"].compiled.params)
    load_tree(ffs["pad_max"], init)
    n_attn = gpt_config().num_layers
    runs = {mode: rob_fit(ff, x, pos, y, shuffle, keep_batches=(mode == "bucketed"))
            for mode, ff in ffs.items()}
    # the plan, straight from the bucket module, for the padded shares
    lengths = row_lengths(y)
    ladder = resolve_ladder("pow2", 8, GPT_SEQ)
    perm = (np.random.default_rng(SEED).permutation(ROB_ROWS) if shuffle
            else np.arange(ROB_ROWS))
    shares = {}
    for mode, pad_max in (("bucketed", False), ("pad_max", True)):
        v, t = plan_token_stats(build_epoch_plan(lengths[perm], PackingSpec(
            ladder=ladder, token_budget=ROB_BUDGET, batch_size=GPT_BATCH, pad_max=pad_max)))
        shares[mode] = 1.0 - v / t
        prof = runs[mode]["profile"]["buckets"]
        check(abs(prof["padded_token_fraction"] - shares[mode]) < 1e-6,
              f"{what}: fit's padded share {prof['padded_token_fraction']} vs the plan's "
              f"{shares[mode]}")
        check(runs[mode]["bucket_compiles"] == prof["new_compiles"],
              f"{what}: fit.bucket_compiles {runs[mode]['bucket_compiles']} vs "
              f"{prof['new_compiles']}")
        for s in runs[mode]["steps"]:
            check(all(s["launches"][k] == n_attn for k in (
                "flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")),
                f"{what} {mode}: a step at width {s['width']} launched {s['launches']}")
    valid = int((y >= 0).sum())
    b, p = runs["bucketed"], runs["pad_max"]
    lb, lp = [s["loss"] for s in b["steps"]], [s["loss"] for s in p["steps"]]
    check(len(lb) == len(lp) and all(np.isfinite(lb + lp)),
          f"{what}: losses {lb} vs pad-max {lp}")
    check(b["pm"].train_all == p["pm"].train_all == valid,
          f"{what}: counted {b['pm'].train_all} and {p['pm'].train_all} tokens of {valid}")
    loss_err = max(abs(u - v) / abs(v) for u, v in zip(lb, lp))
    param_diff = tree_err(ffs["bucketed"].compiled.params, ffs["pad_max"].compiled.params)
    n_steps = len(lb)
    pad_final = {op: {w: t.cpu() for w, t in ws.items()}
                 for op, ws in ffs["pad_max"].compiled.params.items()}
    if ref is None:
        loss_tol = ROB_LOSS_TOL
        param_tol = 2 * ROB_ALPHA * n_steps
        loss_floor = param_floor = None
    else:
        loss_floor = max(abs(u - v) / abs(v) for u, v in zip(lp, ref["pad_max_losses"]))
        param_floor = tree_err(pad_final, ref["pad_max_params"])
        loss_tol = BF16_FLOOR_FACTOR * loss_floor
        param_tol = BF16_FLOOR_FACTOR * param_floor
    check(loss_err <= loss_tol, f"{what}: per-step losses {lb} vs pad-max {lp}: "
          f"{loss_err:.3g} > {loss_tol:.3g}")
    check(param_diff <= param_tol, f"{what}: params after the epoch {param_diff:.3g} from "
          f"pad-max's > {param_tol:.3g}")
    update_err, update_worst = layer_err(ffs["bucketed"].compiled.params,
                                         ffs["pad_max"].compiled.params, init)

    grad_rows, grad_ref = [], {}
    if not shuffle:
        # one step's gradients at the ragged widths, from the init: kernels
        # vs the plain path, and the ragged rows vs the same rows padded to
        # 1024
        cm = ffs["bucketed"].compiled
        load_tree(ffs["bucketed"], init)
        for w in sorted(b["batches"]):
            tok, ps, lab = b["batches"][w]
            g_k = cm.grad_step(cm.params, None, tok, ps, lab)
            g_p = cm.grad_step(cm.params, None, tok, ps, lab, plain_kernels=True)
            err, worst = layer_err(g_k, g_p)
            floor = None if ref is None else layer_err(g_p, ref["grads"][w])[0]
            tol = GRAD_TOL if ref is None else BF16_FLOOR_FACTOR * floor
            check(err <= tol, f"{what}: grads at width {w} vs plain path {err:.3g} of the "
                  f"largest gradient of {worst}'s layer > {tol:.3g}")
            padded = [torch.nn.functional.pad(t, (0, GPT_SEQ - w), value=v)
                      for t, v in ((tok, 0), (ps, 0), (lab, -1))]
            g_pad = cm.grad_step(cm.params, None, *padded)
            pad_err, pad_worst = layer_err(g_k, g_pad)
            check(ref is not None or pad_err <= GRAD_TOL,
                  f"{what}: grads at width {w} vs the rows padded to {GPT_SEQ}: {pad_err:.3g}"
                  f" of the largest gradient of {pad_worst}'s layer > {GRAD_TOL}")
            grad_ref[w] = {op: {n: t.cpu() for n, t in ws.items()} for op, ws in g_p.items()}
            grad_rows.append(dict(width=w, rows=int(tok.shape[0]), vs_plain=err, worst=worst,
                                  tolerance=tol, bf16_floor=floor, vs_pad_max_width=pad_err,
                                  pad_worst=pad_worst))
            del g_k, g_p, g_pad
    # a timed epoch of each mode (the first epochs paid the warm-up)
    timed = {mode: rob_fit(ffs[mode], x, pos, y, shuffle) for mode in ("bucketed", "pad_max")}
    rates = {m: valid / r["wall_s"] for m, r in timed.items()}
    step_ms = {m: float(np.median([s["ms"] for s in r["steps"]])) for m, r in timed.items()}
    row = dict(compute_dtype=compute_dtype, card=card, order=order, rows=ROB_ROWS,
               lengths=list(ROB_LEN), token_budget=ROB_BUDGET, ladder=list(ladder),
               valid_tokens=valid, padded_share=shares,
               dispatches={m: len(r["steps"]) for m, r in runs.items()},
               by_width={m: by_width(r["steps"]) for m, r in runs.items()},
               bucket_compiles={m: r["bucket_compiles"] for m, r in runs.items()},
               losses=lb, pad_max_losses=lp, loss_rel_err=loss_err, loss_tolerance=loss_tol,
               loss_bf16_floor=loss_floor, param_max_abs_diff=param_diff,
               param_tolerance=param_tol, param_bf16_floor=param_floor,
               update_rel_err=update_err, update_worst=update_worst, grads=grad_rows,
               valid_tokens_per_s=rates, step_ms_median=step_ms,
               epoch_s={m: r["wall_s"] for m, r in timed.items()},
               launches={k: sum(r["launches"][k] for r in [b, p, *timed.values()])
                         for k in b["launches"]})
    for mode in ("bucketed", "pad_max"):
        print(f"robustness buckets {compute_dtype} {order} {mode}: {len(runs[mode]['steps'])} "
              f"dispatches, {rates[mode]:.0f} valid tokens/s, step {step_ms[mode]:.2f} ms "
              f"median, padded share {shares[mode]:.4f}, fit.bucket_compiles "
              f"{runs[mode]['bucket_compiles']}, by width "
              f"{json.dumps(row['by_width'][mode])} [{card}]", flush=True)
    held = (f"tol {loss_tol:.3g}" if ref is None
            else f"bf16 floor {loss_floor:.3g} x{BF16_FLOOR_FACTOR}")
    print(f"robustness buckets {compute_dtype} {order}: {n_steps} losses vs pad-max max rel "
          f"err {loss_err:.3g} ({held}); params max |diff| {param_diff:.3g} (tol "
          f"{param_tol:.3g}), {update_err:.3g} of the layer's largest update (worst "
          f"{update_worst}); valid tokens/s bucketed / pad-max "
          f"{rates['bucketed'] / rates['pad_max']:.3f}; grads {json.dumps(grad_rows)}",
          flush=True)
    this_ref = {"pad_max_losses": lp, "pad_max_params": pad_final, "grads": grad_ref}
    del ffs, init
    free_device()
    return row, this_ref


def transformer_model(compute_dtype: str, **cfg):
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer

    ff = FFModel(FFConfig(batch_size=BATCH, compute_dtype=compute_dtype, seed=SEED,
                          device=DEVICE, **cfg))
    build_transformer(ff, BATCH, TransformerConfig())
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    return ff


def timed_fit(ff, x, y) -> tuple:
    """(wall ms a step, flash launches) of one fit epoch, no shuffle, the
    counts set to 0 just before."""
    from flexflow_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ff.fit(x, y, epochs=1, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (len(x) // BATCH), kernels.launch_counts()


def trees_equal(a: dict, b: dict) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    return a == b


def rob_transformer(compute_dtype: str, card: str, ref: dict = None) -> tuple:
    """(b) the Transformer at TransformerConfig(), batch 8: grad_accum_steps
    2 against 1 over ROB_ACCUM_STEPS steps; steps_per_dispatch 4 with
    prefetch depth 2 against the serial loop over ROB_MULTI_STEPS steps,
    params EQUAL; step ms of each mode."""
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    what = f"robustness transformer {compute_dtype}"
    cfg = TransformerConfig()
    rng = np.random.default_rng(SEED + 11)
    n = ROB_MULTI_STEPS * BATCH
    x = rng.normal(size=(n, cfg.sequence_length, cfg.hidden_size)).astype(np.float32)
    y = rng.normal(size=(n, cfg.sequence_length, 1)).astype(np.float32)
    ffs = {"serial": transformer_model(compute_dtype),
           "accum2": transformer_model(compute_dtype, grad_accum_steps=2),
           "multi4": transformer_model(compute_dtype, steps_per_dispatch=4, prefetch_depth=2)}
    init = device_copy(ffs["serial"].compiled.params)
    n_attn = cfg.num_layers
    all_launches = []
    # accumulation: ROB_ACCUM_STEPS steps of each from the same init
    xa, ya = x[:ROB_ACCUM_STEPS * BATCH], y[:ROB_ACCUM_STEPS * BATCH]
    accum = {}
    for mode in ("serial", "accum2"):
        load_tree(ffs[mode], init)
        ms, launches = timed_fit(ffs[mode], xa, ya)
        all_launches.append(launches)
        micro = 2 if mode == "accum2" else 1
        check_flash_launches(launches, n_attn * micro * ROB_ACCUM_STEPS,
                             n_attn * micro * ROB_ACCUM_STEPS, f"{what} {mode}")
        accum[mode] = dict(ms_cold=ms, launches=launches,
                           params=device_copy(ffs[mode].compiled.params))
    acc_err, acc_worst = layer_err(accum["accum2"]["params"], accum["serial"]["params"],
                                   init, ulps=ROB_ACCUM_STEPS)
    host = {op: {w: t.cpu() for w, t in ws.items()} for op, ws in accum["serial"]["params"].items()}
    acc_floor = (None if ref is None else
                 layer_err(accum["serial"]["params"], ref["serial"], init, ulps=ROB_ACCUM_STEPS)[0])
    acc_tol = GRAD_TOL if ref is None else BF16_FLOOR_FACTOR * acc_floor
    check(acc_err <= acc_tol, f"{what}: grad_accum_steps 2 vs 1 after {ROB_ACCUM_STEPS} steps: "
          f"{acc_err:.3g} of the largest update of {acc_worst}'s layer > {acc_tol:.3g}")
    # multi-step dispatch against the serial loop, from the same init
    multi = {}
    for mode in ("serial", "multi4"):
        load_tree(ffs[mode], init)
        ms, launches = timed_fit(ffs[mode], x, y)
        all_launches.append(launches)
        check_flash_launches(launches, n_attn * ROB_MULTI_STEPS, n_attn * ROB_MULTI_STEPS,
                             f"{what} {mode}")
        multi[mode] = dict(ms=ms, launches=launches)
    equal = trees_equal(ffs["multi4"].compiled.params, ffs["serial"].compiled.params)
    nondeterministic, bound = None, 0.0
    if not equal:
        # is the serial loop itself deterministic run to run?
        again = device_copy(ffs["serial"].compiled.params)
        load_tree(ffs["serial"], init)
        all_launches.append(timed_fit(ffs["serial"], x, y)[1])
        if trees_equal(again, ffs["serial"].compiled.params):
            check(False, f"{what}: steps_per_dispatch 4 params differ from the serial loop's, "
                  f"which repeats bitwise: max |diff| "
                  f"{tree_err(ffs['multi4'].compiled.params, again)}")
        nondeterministic = "the serial loop differs from itself run to run"
        bound = tree_err(again, ffs["serial"].compiled.params)
        diff = tree_err(ffs["multi4"].compiled.params, again)
        check(diff <= BF16_FLOOR_FACTOR * bound,
              f"{what}: multi-step params {diff:.3g} from serial > 2 x run-to-run {bound:.3g}")
    # the timed modes, warm: one more epoch each
    for mode in ("serial", "multi4"):
        multi[mode]["ms_warm"], launches = timed_fit(ffs[mode], x, y)
        all_launches.append(launches)
    for mode in ("serial", "accum2"):
        accum[mode]["ms"], launches = timed_fit(ffs[mode], xa, ya)
        all_launches.append(launches)
    row = dict(compute_dtype=compute_dtype, card=card, batch=BATCH,
               accum_steps=ROB_ACCUM_STEPS, accum_rel_err=acc_err, accum_worst=acc_worst,
               accum_tolerance=acc_tol, accum_bf16_floor=acc_floor,
               accum_step_ms={m: v["ms"] for m, v in accum.items()},
               accum_step_ms_cold={m: v["ms_cold"] for m, v in accum.items()},
               multi_steps=ROB_MULTI_STEPS, multi_params_equal=equal,
               multi_nondeterministic=nondeterministic, multi_run_to_run=bound,
               multi_step_ms={m: v["ms"] for m, v in multi.items()},
               multi_step_ms_warm={m: v["ms_warm"] for m, v in multi.items()},
               launches={k: sum(c[k] for c in all_launches) for k in all_launches[0]})
    print(f"robustness transformer {compute_dtype}: grad_accum_steps 2 vs 1 after "
          f"{ROB_ACCUM_STEPS} steps {acc_err:.3g} of the layer's largest update (worst "
          f"{acc_worst}; tol {acc_tol:.3g}), step ms {accum['serial']['ms']:.2f} / "
          f"{accum['accum2']['ms']:.2f} (K=1 / K=2, B*H 64 per microbatch, warm epoch); "
          f"steps_per_dispatch 4 + prefetch 2 vs serial over {ROB_MULTI_STEPS} steps: params "
          f"{'EQUAL' if equal else 'not equal: ' + str(nondeterministic)}, step ms "
          f"{multi['serial']['ms_warm']:.2f} serial / {multi['multi4']['ms_warm']:.2f} "
          f"multi-step (warm epoch) [{card}]", flush=True)
    return row, {"serial": host}


def kill_child(ckpt_dir: str) -> None:
    """The crash half of (c), run in a child process: fit with checkpoints
    every ROB_CKPT_INTERVAL steps, killed by train.kill at ROB_KILL_AT
    (os._exit(41) inside fit); returning at all is a failure."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ff = rob_gpt("float32", checkpoint_interval_steps=ROB_CKPT_INTERVAL,
                 checkpoint_dir=ckpt_dir, fault_plan={"schema": 1, "sites": {
                     "train.kill": {"at_step": ROB_KILL_AT, "exit_code": 41}}})
    tok, pos, lab = gpt_data(SEED + 13, ROB_RESUME_ROWS)
    ff.fit([tok, pos], lab, epochs=ROB_RESUME_EPOCHS, verbose=False)


def rob_guard_resume(card: str) -> dict:
    """(c) GPT at GPTConfig(), f32: the guard under train.nan_loss, a
    killed child resumed against an uninterrupted run, both torn-write
    targets."""
    from flexflow_tpu_torch import FFConfig, kernels
    from flexflow_tpu_torch.obs.metrics import metrics_registry
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager
    from flexflow_tpu_torch.runtime.faults import configure_faults
    from flexflow_tpu_torch.runtime.guard import TrainingGuard
    from flexflow_tpu_torch.serving import Generator

    what = "robustness guard/resume float32"
    reg = metrics_registry()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # --- the guard: NaN at step ROB_NAN_AT (epoch 1 of 3), two restores allowed
    tok, pos, lab = gpt_data(SEED + 13, ROB_GUARD_ROWS)
    ff = rob_gpt("float32", fault_plan={"schema": 1, "sites": {
        "train.nan_loss": {"at_step": ROB_NAN_AT}}})
    cm = ff.compiled
    prompt = tok[:GPT_BATCH, :16]
    gen = Generator(ff, max_length=GPT_SEQ)
    gen.prefill(prompt)  # the generator's state before the fault
    at_restore = []

    class Guard(TrainingGuard):
        def recover(self, model, verbose=True):
            ok = super().recover(model, verbose)
            snap_equal = all(torch.equal(cm.params[op][w].cpu(), t)
                             for op, ws in self._snap[0].items() for w, t in ws.items())
            old, fresh = gen.prefill(prompt)[0], Generator(model, max_length=GPT_SEQ).prefill(
                prompt)[0]
            at_restore.append(dict(params_are_snapshot=snap_equal,
                                   old_vs_fresh=(old - fresh).abs().max().item(),
                                   version=cm.params_version))
            return ok

    guard = Guard(max_restores=2)
    version0, lr0 = cm.params_version, ff.optimizer.alpha
    fired0 = reg.counter("faults.train.nan_loss").value
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hist = ff.fit([tok, pos], lab, epochs=ROB_RESUME_EPOCHS, guard=guard, verbose=False)
    torch.cuda.synchronize()
    add(kernels.launch_counts())
    rep = guard.report()
    final_ce = hist[-1].sparse_cce_loss / max(1, hist[-1].train_all)
    check(rep["restores"] == 1 and len(at_restore) == 1 and at_restore[0]["params_are_snapshot"]
          and at_restore[0]["old_vs_fresh"] == 0.0 and at_restore[0]["version"] == version0 + 1
          and ff.optimizer.alpha == lr0 * guard.lr_backoff and np.isfinite(final_ce)
          and reg.counter("faults.train.nan_loss").value == fired0 + 1,
          f"{what}: guard report {rep}, at the restore {at_restore}, alpha "
          f"{ff.optimizer.alpha}, final CE {final_ce}")
    guard_row = dict(report=rep, at_restore=at_restore[0], alpha_after=ff.optimizer.alpha,
                     final_sparse_cce=final_ce)
    print(f"robustness guard float32: NaN at step {ROB_NAN_AT}: restores {rep['restores']}, "
          f"events {[(e['kind'], e.get('scope'), e['step']) for e in rep['events']]}, alpha "
          f"{lr0} -> {ff.optimizer.alpha}, params at the restore equal the snapshot "
          f"{at_restore[0]['params_are_snapshot']}, the earlier Generator vs a fresh one "
          f"{at_restore[0]['old_vs_fresh']} (params version {version0} -> "
          f"{at_restore[0]['version']}), final CE {final_ce:.4f} [{card}]", flush=True)
    del gen, ff, cm, guard, Guard
    configure_faults(FFConfig(device=DEVICE))
    free_device()

    # --- crash and resume
    tok, pos, lab = gpt_data(SEED + 13, ROB_RESUME_ROWS)
    root = pathlib.Path(__file__).resolve().parent
    work = root / ".ffcache" / "smoke_checkpoints"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        ckpt = str(work / "run")
        code = (f"import sys; sys.path.insert(0, {str(root)!r}); import chip_smoke; "
                f"chip_smoke.kill_child({ckpt!r}); sys.exit(0)")
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                               capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        check(child.returncode == 41, f"{what}: the killed child exited {child.returncode}: "
              f"{child.stderr[-2000:]}")
        mgr = CheckpointManager(ckpt, max_to_keep=3)
        last = ROB_KILL_AT - ROB_KILL_AT % ROB_CKPT_INTERVAL
        check(mgr.latest_step() == last, f"{what}: the child left steps {mgr.all_steps()}")
        ckpt_bytes = mgr.payload_bytes(last)
        resumes0 = reg.counter("checkpoint.resumes").value
        resumed = rob_gpt("float32", checkpoint_interval_steps=ROB_CKPT_INTERVAL,
                          checkpoint_dir=ckpt)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        resumed.fit([tok, pos], lab, epochs=ROB_RESUME_EPOCHS, resume_from=ckpt,
                    verbose=False)
        torch.cuda.synchronize()
        add(kernels.launch_counts())
        whole = rob_gpt("float32")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        whole.fit([tok, pos], lab, epochs=ROB_RESUME_EPOCHS, verbose=False)
        torch.cuda.synchronize()
        add(kernels.launch_counts())
        rc, wc = resumed.compiled, whole.compiled
        same_params = trees_equal(rc.params, wc.params)
        same_moments = trees_equal(rc.opt_state, wc.opt_state)
        total = ROB_RESUME_EPOCHS * ROB_RESUME_ROWS // GPT_BATCH
        check(same_params and same_moments and rc.iteration == wc.iteration == total
              and reg.counter("checkpoint.resumes").value == resumes0 + 1,
              f"{what}: resumed vs uninterrupted: params equal {same_params} (max |diff| "
              f"{tree_err(rc.params, wc.params):.3g}), Adam moments equal {same_moments},"
              f" iterations {rc.iteration} / {wc.iteration}")
        # the save's time and size, of the resumed model's state
        times = []
        for step in (total + 1, total + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(resumed, step, extra={"schema": 1})
            times.append((time.perf_counter() - t0) * 1e3)
        resume_row = dict(child_exit=child.returncode, child_s=child_s, resumed_from=last,
                          steps=total, params_equal=same_params, moments_equal=same_moments,
                          checkpoint_bytes=ckpt_bytes, save_ms=times)
        print(f"robustness resume float32: child killed at step {ROB_KILL_AT} (exit "
              f"{child.returncode}, {child_s:.1f} s), resumed from step {last}, {total} steps: "
              f"params {'EQUAL' if same_params else 'differ'}, Adam moments "
              f"{'EQUAL' if same_moments else 'differ'} to the uninterrupted run's; checkpoint "
              f"{ckpt_bytes} bytes, save ms {[f'{t:.0f}' for t in times]} [{card}]", flush=True)
        del whole, rc, wc
        free_device()

        # --- torn writes: the second of two saves torn; restore falls back
        torn = {}
        for target in ("payload", "sidecar"):
            tdir = str(work / f"torn_{target}")
            configure_faults(FFConfig(device=DEVICE, fault_plan={"schema": 1, "sites": {
                "checkpoint.torn_write": {"at_step": 2, "target": target}}}))
            tmgr = CheckpointManager(tdir, max_to_keep=3)
            n_torn = reg.counter("faults.torn_checkpoints").value
            n_fall = reg.counter("checkpoint.corrupt_fallbacks").value
            tmgr.save(resumed, 1, extra={"schema": 1})
            tmgr.save(resumed, 2, extra={"schema": 1})
            configure_faults(FFConfig(device=DEVICE))
            step = tmgr.restore(resumed, require_extra=True)
            torn[target] = dict(
                restored=step, torn=int(reg.counter("faults.torn_checkpoints").value - n_torn),
                fallbacks=int(reg.counter("checkpoint.corrupt_fallbacks").value - n_fall))
            check(torn[target] == dict(restored=1, torn=1, fallbacks=1),
                  f"{what}: torn {target}: {torn[target]}")
        print(f"robustness torn writes float32: {json.dumps(torn)} [{card}]", flush=True)
        del resumed
    finally:
        configure_faults(FFConfig(device=DEVICE))
        shutil.rmtree(work, ignore_errors=True)
    free_device()
    return dict(guard=guard_row, resume=resume_row, torn=torn, launches=launches)


def phase_training_robustness(card: str) -> dict:
    """Training robustness and dynamic shapes: (a) bucketed GPT, (b) the
    Transformer's accumulation and multi-step dispatch, (c) the guard,
    crash and resume, torn writes. Returns the phase's row with its flash
    launches, all and by width."""
    out = {"buckets": [], "transformer": []}
    for order in ("shuffled", "sorted"):
        ref = None
        for dt in ("float32", "bfloat16"):
            row, r = rob_bucket_order(dt, card, order, ref)
            ref = ref or r
            out["buckets"].append(row)
        del ref
    ref = None
    for dt in ("float32", "bfloat16"):
        row, r = rob_transformer(dt, card, ref)
        ref = ref or r
        out["transformer"].append(row)
        free_device()
    del ref
    out["guard_resume"] = rob_guard_resume(card)
    names = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    launches = {k: sum(r["launches"][k] for r in out["buckets"])
                + sum(r["launches"][k] for r in out["transformer"])
                + out["guard_resume"]["launches"].get(k, 0) for k in names}
    widths = {}
    for r in out["buckets"]:
        for mode in ("bucketed", "pad_max"):
            for w, v in r["by_width"][mode].items():
                acc = widths.setdefault(str(w), {k: 0 for k in names})
                for k in names:
                    acc[k] += v[k]
    out["launches"] = launches
    out["bucket_launches_by_width"] = widths
    cuts = (f"GPT bucketed: {ROB_ROWS} rows shuffled and sorted by length, one checked and "
            f"one timed epoch a mode; "
            f"Transformer: {ROB_ACCUM_STEPS} accumulation and {ROB_MULTI_STEPS} multi-step "
            f"steps; guard: 3 epochs of {ROB_GUARD_ROWS // GPT_BATCH} steps, resume: "
            f"{ROB_RESUME_EPOCHS} epochs of {ROB_RESUME_ROWS // GPT_BATCH} steps, at batch "
            f"{GPT_BATCH}, seq {GPT_SEQ}")
    out["cuts"] = cuts
    print(f"robustness cuts: {cuts}", flush=True)
    print("training_robustness_json " + json.dumps(out, default=float), flush=True)
    return out


def check_spans(events: list, n: int, validate) -> None:
    """Every served request has the reference's five spans on its own
    track, nested in its serving.request span."""
    problems = validate({"traceEvents": events})
    check(not problems, f"tracer: {problems[:3]}")
    tracks = {}
    for ev in events:
        if ev.get("cat") == "serving" and ev.get("ph") == "X":
            tracks.setdefault(ev["tid"], []).append(ev)
    want = ["serving.batch_assembly", "serving.infer", "serving.queue_wait", "serving.reply"]
    for evs in tracks.values():
        root = next((e for e in evs if e["name"] == "serving.request"), None)
        check(root is not None and sorted(e["name"] for e in evs if e is not root) == want
              and all(root["ts"] - 0.05 <= e["ts"] and e["ts"] + e["dur"]
                      <= root["ts"] + root["dur"] + 0.05 for e in evs),
              f"tracer: a request's spans {[(e['name'], e['ts'], e['dur']) for e in evs]}")
    check(len(tracks) == n, f"tracer: {len(tracks)} request span trees for {n} requests")


def _kernel_entry(name: str, source: str, replaces: str, rows: list, launches: int,
                  **extra) -> dict:
    """One entry of the kernels line, its numbers from the f32 non-causal
    row at the slice shape (the training and serving paths' variant);
    ``bfloat16`` repeats them from the bf16 non-causal row, which the bf16
    paths run (for the backward, the tensor-core kernels)."""
    main_row = next(r for r in rows if r["dtype"] == "float32" and not r["causal"])
    bf16_row = next(r for r in rows if r["dtype"] == "bfloat16" and not r["causal"])
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": main_row["max_abs_err"],
            "max_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
            "bfloat16": {k: bf16_row[k] for k in keys},
            "shape": [BATCH * HEADS, SEQ, HEAD_DIM], "variants": rows, **extra}


def _moe_entry(name: str, source: str, replaces: str, rows: list, serving: int,
               training: int) -> dict:
    """One MoE kernel's entry of the kernels line, its numbers from the
    float32 row at the MoE model's shape (the serving and training paths'
    variant); ``launches`` counts the MoE serving and fit runs."""
    main_row = next(r for r in rows if r["dtype"] == "float32" and r["shape"].startswith("main"))
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": serving + training, "serving_launches": serving,
            "training_launches": training, "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "library": "F.embedding_bag",
            "shape": main_row["shape"], "variants": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    kern = phase_kernels()
    print(f"phases: kernels done at {time.perf_counter() - t0:.0f} s", flush=True)
    serve, params, plain, plains = [], None, None, {}
    for compute_dtype in ("float32", "bfloat16"):
        row, params, plain = phase_serving(compute_dtype, params, card, plain)
        serve.append(row)
        plains[compute_dtype] = plain
    print(f"phases: serving done at {time.perf_counter() - t0:.0f} s", flush=True)
    row32, ref = phase_training("float32", params, card)
    row16, _ = phase_training("bfloat16", params, card, ref)
    train = [row32, row16]
    del ref
    print(f"phases: training done at {time.perf_counter() - t0:.0f} s", flush=True)
    gpt32, ref = phase_gpt_training("float32", card)
    gpt16, _ = phase_gpt_training("bfloat16", card, ref)
    gpt_train = [gpt32, gpt16]
    del ref
    gen32, full32 = phase_gpt_generation("float32", card)
    gen16, _ = phase_gpt_generation("bfloat16", card, full32)
    gpt_gen = [gen32, gen16]
    del full32
    gpt_paged = [phase_gpt_paged_serving(dt, card) for dt in ("float32", "bfloat16")]
    bert = phase_bert_fit(card)
    print(f"phases: GPT and BERT done at {time.perf_counter() - t0:.0f} s", flush=True)
    moe_kern = phase_moe_kernels()
    print(f"phases: MoE kernels done at {time.perf_counter() - t0:.0f} s", flush=True)
    moe_serve = [phase_moe_serving(dt, card) for dt in ("float32", "bfloat16")]
    moe_train = [phase_moe_training(dt, card) for dt in ("float32", "bfloat16")]
    moe_train.append(phase_moe_training("float32", card, stacked=True))
    print(f"phases: MoE serving and training done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    del params
    breadth = phase_serving_breadth(card, plains)
    del plains
    print(f"phases: serving breadth done at {time.perf_counter() - t0:.0f} s", flush=True)
    free_device()
    phase_zoo(card)
    print(f"phases: zoo done at {time.perf_counter() - t0:.0f} s", flush=True)
    free_device()
    rob = phase_training_robustness(card)
    print(f"phases: training robustness done at {time.perf_counter() - t0:.0f} s", flush=True)
    train_launches = {name: sum(r["fit_launches"][name] for r in train)
                      for name in train[0]["fit_launches"]}
    # GPT's path: its fits and the full-sequence forwards of its dense and
    # paged generation checks; the BERT proxy's fit
    gpt_launches = {name: sum(r["fit_launches"][name] for r in gpt_train)
                    + sum(r["full_forward_launches"][name] for r in gpt_gen + gpt_paged)
                    for name in train[0]["fit_launches"]}
    bert_launches = bert["launches"]
    bwd_src = "flexflow_tpu_torch/kernels/csrc/flash_attention_bwd.cu"
    wide_bwd_src = "flexflow_tpu_torch/kernels/csrc/flash_attention_bwd_wide.cu"
    entries = [
        _kernel_entry("flash_attention_fwd",
                      "flexflow_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
                      "flexflow_tpu/kernels/flash_attention.py:43", kern["fwd"],
                      sum(r["launches"] for r in serve)
                      + train_launches["flash_attention_fwd"]
                      + gpt_launches["flash_attention_fwd"]
                      + bert_launches["flash_attention_fwd"]
                      + breadth["launches"] + rob["launches"]["flash_attention_fwd"],
                      serving_launches=sum(r["launches"] for r in serve),
                      serving_breadth_launches=breadth["launches"],
                      training_launches=train_launches["flash_attention_fwd"],
                      gpt_launches=gpt_launches["flash_attention_fwd"],
                      gpt_full_forward_launches=sum(
                          r["full_forward_launches"]["flash_attention_fwd"] for r in gpt_gen),
                      gpt_paged_full_forward_launches=sum(
                          r["full_forward_launches"]["flash_attention_fwd"] for r in gpt_paged),
                      bert_launches=bert_launches["flash_attention_fwd"],
                      robustness_launches=rob["launches"]["flash_attention_fwd"],
                      robustness_bucket_launches_by_width={
                          w: v["flash_attention_fwd"]
                          for w, v in rob["bucket_launches_by_width"].items()},
                      wide_source="flexflow_tpu_torch/kernels/csrc/flash_attention_fwd_wide.cu",
                      wide_route="D > 256: flash_fwd_kernel_wide_mma (bf16) and "
                                 "flash_fwd_kernel_wide_tf32x3 (f32, split TF32), on the "
                                 "tensor cores; no main path launches them",
                      cases=kern["cases"], gpt_cases=kern["gpt_cases"]),
        _kernel_entry("flash_attention_bwd_dq", bwd_src,
                      "flexflow_tpu/kernels/flash_attention.py:59", kern["dq"],
                      train_launches["flash_attention_bwd_dq"]
                      + gpt_launches["flash_attention_bwd_dq"]
                      + bert_launches["flash_attention_bwd_dq"]
                      + rob["launches"]["flash_attention_bwd_dq"],
                      training_launches=train_launches["flash_attention_bwd_dq"],
                      gpt_launches=gpt_launches["flash_attention_bwd_dq"],
                      bert_launches=bert_launches["flash_attention_bwd_dq"],
                      robustness_launches=rob["launches"]["flash_attention_bwd_dq"],
                      robustness_bucket_launches_by_width={
                          w: v["flash_attention_bwd_dq"]
                          for w, v in rob["bucket_launches_by_width"].items()},
                      plain_and_library_cover="dq, dk and dv (the whole gradient)",
                      wide_source=wide_bwd_src,
                      wide_route="D > 256: flash_bwd_dq_kernel_wide_mma (bf16) and "
                                 "flash_bwd_dq_kernel_wide_tf32x3 (f32, split TF32), on the "
                                 "tensor cores; no main path launches them"),
        _kernel_entry("flash_attention_bwd_dkv", bwd_src,
                      "flexflow_tpu/kernels/flash_attention.py:79", kern["dkv"],
                      train_launches["flash_attention_bwd_dkv"]
                      + gpt_launches["flash_attention_bwd_dkv"]
                      + bert_launches["flash_attention_bwd_dkv"]
                      + rob["launches"]["flash_attention_bwd_dkv"],
                      training_launches=train_launches["flash_attention_bwd_dkv"],
                      gpt_launches=gpt_launches["flash_attention_bwd_dkv"],
                      bert_launches=bert_launches["flash_attention_bwd_dkv"],
                      robustness_launches=rob["launches"]["flash_attention_bwd_dkv"],
                      robustness_bucket_launches_by_width={
                          w: v["flash_attention_bwd_dkv"]
                          for w, v in rob["bucket_launches_by_width"].items()},
                      plain_and_library_cover="dq, dk and dv (the whole gradient)",
                      wide_source=wide_bwd_src,
                      wide_route="D > 256: flash_bwd_dkv_kernel_wide_mma (bf16) and "
                                 "flash_bwd_dkv_kernel_wide_tf32x3 (f32, split TF32), on the "
                                 "tensor cores; no main path launches them"),
    ]
    moe_src = "flexflow_tpu_torch/kernels/csrc/moe_kernels.cu"
    for name, line in (("row_gather", 41), ("row_gather_sum", 74)):
        serving = sum(r["launches"][name] for r in moe_serve)
        training = sum(r["fit_launches"][name] for r in moe_train)
        entries.append(_moe_entry(name, moe_src, f"flexflow_tpu/kernels/moe_kernels.py:{line}",
                                  moe_kern[name], serving, training))
    check(all(e["launches"] > 0 for e in entries),
          f"a kernel never launched on its path: {[(e['name'], e['launches']) for e in entries]}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
