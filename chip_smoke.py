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
14. the device mesh: the same Transformer (TransformerConfig()'s widths at
   6 layers, 8 samples a data rank, SGD 0.01, MSE) through FFModel.compile
   over a mesh_shape ->
   fit, in float32 and bfloat16, on (a) {data: 2} (2 ranks) and (b)
   {data: 2, model: 2} with tp_axis "model" (4 ranks), the ranks spawned
   on this one card over gloo (the collectives staged through the host):
   each rank's backend, local attention shape and flash launches (each
   above 0), the warm step ms, the bytes a step through the host beside
   the bytes counted from the shapes, and the gathered params against the
   one-rank run of the same global batches on the card: f32 after 3 steps,
   within 1e-3 of each layer's largest update; bf16 after 1 step, the
   model's update error in 2-norm within twice the one-rank bf16 run's
   distance from one-rank f32, a bound that must stay under half the
   reading of params left at their start (1); (c) {data: 2, seq: 2} at 2
   layers, ring and a2a, float32, held as f32; ring_all_reduce against
   psum_all_reduce on 64 MB;
15. expert parallelism, ZeRO-1 and the pipeline (A7b), the ranks on this
   card over gloo: (d) build_moe_mnist(stacked=True, expert_axis="data")
   with 8 experts (MoeConfig()'s other widths), batch 64, SGD 0.1, on
   {data: 2} and {data: 4}: at alpha 4.0 (no drops) f32 and bf16 held to
   the one-rank run as (14) holds its runs, at alpha 2.0 f32 checked to
   train; the n-branch MoE at MoeConfig() on {data: 2} (the gathered
   routing) held to one rank; each rank's K4/K5 launches at its local
   shapes (3 and 1 a step), those shapes held against the plain versions,
   the bytes through the host beside the all-to-alls' and gradients' from
   the shapes; (e) the Transformer of (14) with Adam on {data: 2}, ZeRO-1
   on and off: params after 3 steps held to the ZeRO-off run, each run's
   optimizer-state bytes a rank (ratio about 1/2); (f) the same
   Transformer at (14)'s 6 layers through compile(pipeline=...) on
   {pipe: 2}: gpipe on the
   host engine, 1f1b and interleaved (V 2) on the single-call engine,
   f32, and 1f1b single-call in bf16; on {pipe: 2, data: 2} 1f1b
   single-call, f32; each held to (14)'s one-rank run, with the warm step
   ms, the boundary bytes a step sent beside those the shapes give, each
   stage's peak_activation_bytes beside max_memory_allocated, and K1-K3
   launches a stage;
16. the rest of A7b, the ranks and worker processes on this card over
   gloo: (g) parallel/launch.py supervising the Transformer of (14) with
   ZeRO-1 Adam on {data: 2} as two worker processes, 8 steps of 16
   samples, a checkpoint every 2 (MultiHostCheckpointManager): an
   uninterrupted cohort, one whose rank 1 multihost.peer_kill kills at
   step 4 and one whose rank 1 multihost.slow_peer stalls at step 3
   (detected after 10 s without heartbeat progress), run at once, both
   relaunched and resumed with params bitwise equal to the uninterrupted
   cohort's (their digests), then one process resuming the killed
   cohort's checkpoints through restore_elastic; (h) the Transformer of
   (4) over {model: 2} from a repository entry with its tensor-parallel
   strategies, two ranks of a rank group on this card, f32 and bf16: 32
   requests against the one-device instance with the same params (the
   serving bounds), K1 launches by rank at (8*8, 512, 64), req/s; GPT at
   GPTConfig() over {model: 2} through a "generator": true entry and
   through the dense Generator with both ranks in step, 4 prompts of 64
   and 32 greedy tokens each against the one-device Generator (parting
   only where the margin rule allows), tokens/s; (i) DLRM at DLRMConfig()
   with param_axis "model" on {model: 2} (512 MiB of tables a rank), 3
   SGD steps held to the one-rank run as (14) holds f32; (j) ResNet-50
   with batch norm at 229 px, batch 64, on {data: 2} with global batch
   statistics, its first update held to the one-rank run in 2-norm
   within 0.1 (the 3-step error reported), and its stem (7x7/2 conv,
   batch norm, 3x3/2 pool) at 224 px with {"spatial": "model"} on
   {model: 2}, held as (i);
17. the simulator and the search (A8a): (k) sim/calibrate.py's
   calibrate() in float32 and bfloat16 (the small Transformer, the bench
   Transformer and AlexNet at 229 px), each calibrated simulation within
   a factor 2 of its measured step, the gloo staging rate of two ranks
   on this card, and ProfilingCostModel's measured forwards against
   OpCostModel's on the bench Transformer's ops (the five largest gaps);
   (l) TransformerConfig(), batch 8, one rank, float32 and bfloat16,
   compiled with a search through the strategy cache: the plan and its
   estimate beside the measured step, 3 fit steps bitwise equal to a
   compile without search, a recompile hitting the cache with no
   cost-model query; (m) (14)'s Transformer on 4 ranks: a search pinned
   to {data: 2, model: 2}, an unpinned search over the 4 ranks with a
   3-step playoff against data parallelism (the faster kept), and
   {pipe: 2} with schedule="auto", each held to (14)'s one-rank f32 run
   with K1-K3 launches on every rank; the native simulator built from
   the checkout and its replay used;
18. observability and the GraphXfer rule schema (A10, A8b): (n)
   TransformerConfig() at batch 8, float32 and bfloat16, two epochs of 4
   steps with the tracer, divergence, executable telemetry, the cost
   corpus, the watchdog and the obs server on: the compile and fit ledger
   records with the card's fingerprint, the attribution phases summing to
   the measured step within 2 % (each phase's share printed), one grad
   step's flops and peak bytes reconciled with the simulator (the OBS002
   verdict), a corpus row for every op forward and backward (a counted
   pass launching K1-K3), /metrics, /healthz, /runs, /attribution and
   /advice fetched over localhost; (o) the bf16 run's top applicable
   suggestion applied in two adjacent (baseline, candidate) pairs of fits,
   judge_experiment's verdict; (p) GPT at GPTConfig() through
   register_generator, 32 requests: the serving attribution and advice
   published, one serving ledger record, each answer held to one full
   causal forward (K1); (q) the train.stall site past a watchdog armed at
   2 s (the black box: thread stacks, the tracer's tail), then (g)'s job
   as a supervised 2-rank cohort with cohort_obs, rank 1 hung: its dumps,
   the merged ledger (each run id once), the cohort report; (r) a rule
   file in the reference's schema (a Linear+ReLU fusion, a parallel-Linear
   merge) through the search: a json: rewrite wins on an MLP, which trains
   3 steps within 1e-4 of the unrewritten graph; the 2-layer Transformer's
   attention left whole;
19. the kernels line, one JSON object;
20. the last line: {"ok": true, "device": {...}}.

Imports torch, numpy and flexflow_tpu_torch only.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import threading
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


# ---- the device mesh: data, tensor and sequence parallelism ------------
PAR_BATCH = 8  # samples per data rank, as bench.py trains the Transformer
PAR_STEPS, PAR_TIMED = 3, 4  # fit steps held to the one-rank run; timed steps
PAR_SEQ_LAYERS = 2  # (c)'s depth
# (a), (b) and the pipeline's depth, cut from TransformerConfig()'s 12 so
# the script stays near half its time limit (the widths stay); ZeRO-1's
# run keeps the 12
PAR_LAYERS = 6
PAR_F32_TOL = 1e-3  # of each layer's largest update, the training phases' form
# bf16 runs are held after one step, before their rounding compounds; the
# bound must stay under this share of what params left at their start read
PAR_BF16_CONTROL_SHARE = 0.5
PAR_RING_ELEMS = 16 * 2 ** 20  # the collective check's f32 tensor: 64 MB
FLASH_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def par_opts(layers: int = 0) -> dict:
    """What a rank builds (TransformerConfig's widths; ``layers``, default
    its depth): passed to the spawned ranks, which import this script
    afresh."""
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig()
    return dict(device=DEVICE, hidden=cfg.hidden_size, heads=cfg.num_heads,
                seq=cfg.sequence_length, layers=layers or cfg.num_layers)


def par_model(opts: dict, compute_dtype: str, mesh_shape, tp=None, seq_axis=None,
              seq_mode: str = "ring", adam: bool = False, zero: bool = False,
              pipeline: dict = None, config: dict = None):
    """The Transformer over ``mesh_shape``: SGD (lr 0.01), or Adam with
    ``adam`` (ZeRO-1 with ``zero``); ``pipeline``: PipelineConfig's
    fields; ``config``: more FFConfig fields (the search's)."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer
    from flexflow_tpu_torch.parallel.pipeline import PipelineConfig

    data = (mesh_shape or {}).get("data", 1)
    batch = PAR_BATCH * max(data, 2)  # the one-rank run takes the global batch
    cfg = TransformerConfig(hidden_size=opts["hidden"], embedding_size=opts["hidden"],
                            num_heads=opts["heads"], num_layers=opts["layers"],
                            sequence_length=opts["seq"])
    ff = FFModel(FFConfig(batch_size=batch, compute_dtype=compute_dtype, seed=SEED,
                          device=opts["device"], mesh_shape=mesh_shape, zero_optimizer=zero,
                          **(config or {})))
    build_transformer(ff, batch, cfg, tp_axis=tp, seq_axis=seq_axis, seq_mode=seq_mode)
    ff.compile(optimizer=AdamOptimizer(alpha=1e-4) if adam else SGDOptimizer(lr=0.01),
               loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               pipeline=PipelineConfig(**pipeline) if pipeline else None)
    return ff


def par_data(opts: dict, n: int):
    rng = np.random.default_rng(SEED + 15)
    x = rng.standard_normal(size=(n, opts["seq"], opts["hidden"]), dtype=np.float32)
    y = rng.standard_normal(size=(n, opts["seq"], 1), dtype=np.float32)
    return x, y


def par_sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def par_fit(opts: dict, compute_dtype: str, mesh_shape=None, **kw) -> dict:
    """One run of the parallel phase on this rank: FFModel.compile over the
    mesh -> fit of PAR_STEPS global batches, the first one alone (launches
    counted just around them), then PAR_TIMED train_steps timed one by
    one, the bytes staged through the host counted over them. Returns this
    rank's record; rank 0 (or the one-rank run) adds the whole params
    after the first step and after the fit."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import collectives, distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    ff = par_model(opts, compute_dtype, mesh_shape, **kw)
    cm = ff.compiled
    batch = cm.input_tensors[0].dims[0]
    x, y = par_data(opts, batch * PAR_STEPS)
    p0 = ff.numpy_params() if cm.mesh is None else None
    shapes = set()
    fwd = fa.flash_attention_fwd

    def recording_fwd(q, *a, **k):
        shapes.add(tuple(q.shape))
        return fwd(q, *a, **k)

    fa.flash_attention_fwd = recording_fwd
    try:
        par_sync(opts["device"])
        kernels.reset_launch_counts()
        ff.fit(x[:batch], y[:batch], batch_size=batch, epochs=1, shuffle=False, verbose=False)
        first = ff.numpy_params()
        ff.fit(x[batch:], y[batch:], batch_size=batch, epochs=1, shuffle=False, verbose=False)
        par_sync(opts["device"])
        launches = kernels.launch_counts()
    finally:
        fa.flash_attention_fwd = fwd
    params = ff.numpy_params()
    cm = ff.compiled  # a playoff may have kept the data-parallel compile
    rank = cm.mesh.rank if cm.mesh is not None else 0
    if cm.mesh is not None:
        # only rank 0's trees are read; spawned ranks hand them back as files
        params, first = (stash_tree(params), stash_tree(first)) if rank == 0 else (None, None)
    pm = ff.pipelined
    # the bytes a step must stage, from the shapes: this rank's f32
    # gradient blocks in one buffer, and with a model axis the four
    # (rows, seq, hidden) activation all-reduces a layer (two forward, two
    # backward; the first layer's input takes no gradient), each to the
    # host and back; the loss's scalars aside. Under ZeRO-1 the slices of
    # the params all-gathered besides; a pipeline's are its own (below)
    grads = 4 * sum(t.numel() for ws in cm.params.values() for t in ws.values())
    if cm.zero_dims:
        dp = cm.mesh.degree("data")
        whole = sum(cm.params[o][w].numel() for o, w in cm.zero_dims)
        grads += 2 * (whole // dp + whole)  # half of it is one way: x 2 below
    acts = 0
    if kw.get("tp"):
        rows = batch // cm.mesh.degree("data")
        elem = torch.empty((), dtype=getattr(torch, compute_dtype)).element_size()
        acts = (4 * opts["layers"] - 1) * rows * opts["seq"] * opts["hidden"] * elem
    ms = []
    collectives.reset_stats()
    if opts["device"] == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for i in range(PAR_TIMED):
        ff.set_batch([x[:batch]], y[:batch])
        par_sync(opts["device"])
        t0 = time.perf_counter()
        if pm is not None:
            loss, _ = pm.train_step(None, ff._cur_batch[:1], ff._cur_batch[1])
        else:
            cm.params, cm.opt_state, loss, _ = cm.train_step(cm.params, cm.opt_state, None,
                                                             *ff._cur_batch)
        loss.item()
        par_sync(opts["device"])
        ms.append((time.perf_counter() - t0) * 1e3)
    st = collectives.stats()
    local = sorted(shapes)
    extra = {}
    if pm is not None:
        mb = batch // pm.cfg.num_microbatches
        rec = pm.profile(mb)
        dp = cm.mesh.degree("data")
        # the boundary's bytes a step, whole and this data shard's share;
        # what this rank sent (the single-call engine's fixed-width ring
        # carries zeros on idle ticks); the stage's gradients all-reduced
        # over data to the host and back
        stage_grads = 4 * sum(t.numel() for ws in pm.stage_params.values() for t in ws.values())
        extra = dict(stage=pm.stage, engine=pm.engine_name, schedule=pm.cfg.schedule,
                     interleave=pm.cfg.interleave, microbatches=pm.cfg.num_microbatches,
                     ticks=rec["ticks"], boundary_bytes_per_step=rec["boundary_bytes_per_step"],
                     boundary_bytes_per_step_local=rec["boundary_bytes_per_step"] // dp,
                     sent_bytes_per_step=pm.step_sent_bytes,
                     transfers_per_step=pm.step_transfers,
                     peak_activation_bytes=rec["peak_activation_bytes"],
                     stage_grad_bytes=stage_grads,
                     max_memory_allocated=(torch.cuda.max_memory_allocated()
                                           if opts["device"] == "cuda" else None))
    if cm.opt_state is not None and kw.get("adam"):
        extra["opt_state_bytes"] = sum(t.numel() * t.element_size()
                                       for k in ("m", "v") for ws in cm.opt_state[k].values()
                                       for t in ws.values())
        extra["zero_weights"] = len(cm.zero_dims)
    if kw.get("config"):
        extra.update(search=ff.search_profile, playoff=ff._playoff_record,
                     strategies={k: v for k, v in ff._strategies.items() if v},
                     schedule_records=ff._pipe_schedule_records)
    return dict(rank=rank, backend=distributed.backend(), **extra,
                mesh=dict(cm.mesh.shape) if cm.mesh is not None else None,
                local_attention_shapes=[list(t) for t in local], launches=launches,
                step_ms=ms, step_ms_median=float(np.median(ms[1:])),
                host_bytes_per_step=st["staged_bytes"] / PAR_TIMED,
                shape_host_bytes_per_step=(None if cm.mesh is None or kw.get("seq_axis")
                                           or pm is not None or kw.get("config")
                                           else 2 * (grads + acts)),
                collectives_per_step=st["calls"] / PAR_TIMED,
                params=params, first=first, start=p0)


def par_collectives(opts: dict) -> dict:
    """ring_all_reduce against psum_all_reduce over the ``data`` axis of a
    2-rank mesh on a 64 MB f32 tensor: the error of one against the
    other (as a share of the largest |sum|) and each one's ms (median of 3,
    host staging included)."""
    from flexflow_tpu_torch.core.machine import make_mesh
    from flexflow_tpu_torch.parallel import collectives

    mesh = make_mesh({"data": 2})
    gen = torch.Generator(device=opts["device"])
    gen.manual_seed(SEED + mesh.rank)
    x = torch.randn(PAR_RING_ELEMS, generator=gen, device=opts["device"])
    out = {}
    for name, fn in (("ring_all_reduce", collectives.ring_all_reduce),
                     ("psum_all_reduce", collectives.psum_all_reduce)):
        ms = []
        for _ in range(3):
            par_sync(opts["device"])
            t0 = time.perf_counter()
            r = fn(x, mesh, "data")
            par_sync(opts["device"])
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = (r, float(np.median(ms)))
    ring, psum = out["ring_all_reduce"][0], out["psum_all_reduce"][0]
    err = ((ring - psum).abs().max() / psum.abs().max()).item()
    return dict(rank=mesh.rank, bytes=x.numel() * 4, err=err,
                ring_ms=out["ring_all_reduce"][1], psum_ms=out["psum_all_reduce"][1])


# whole param trees a spawned rank hands back, as files (pickling them
# through the result queue took about 20 s a GB); removed by each phase
TREE_DIR = pathlib.Path(".ffcache") / "smoke_trees"
_stashed = [0]


def stash_tree(tree: dict) -> str:
    """Write a {op: {weight: array}} tree to TREE_DIR; returns its path."""
    TREE_DIR.mkdir(parents=True, exist_ok=True)
    _stashed[0] += 1
    path = TREE_DIR / f"{os.getpid()}_{_stashed[0]}.npz"
    np.savez(path, **{f"{op}/{w}": a for op, ws in tree.items() for w, a in ws.items()})
    return str(path)


def read_stashed_tree(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            op, w = key.split("/")
            tree.setdefault(op, {})[w] = z[key]
    return tree


def par_worker(rank: int, world: int, jobs: list) -> list:
    """A spawned rank: run each job in order (every rank the same jobs)."""
    out = []
    run = {"collectives": lambda opts, kw: par_collectives(opts),
           "fit": lambda opts, kw: par_fit(opts, **kw),
           "ep": lambda opts, kw: ep_fit(opts, **kw),
           "mesh": lambda opts, kw: mesh_fit(opts, **kw),
           "tp_gen": lambda opts, kw: tp_generate_job(opts, **kw)}
    for kind, opts, kw in jobs:
        t0 = time.perf_counter()
        out.append(run[kind](opts, kw))
        if rank == 0:
            print(f"phases: rank job {kind} {kw.get('compute_dtype', '')} "
                  f"{kw.get('mesh_shape', '')} took {time.perf_counter() - t0:.1f} s", flush=True)
        gc.collect()
        if opts["device"] == "cuda":
            torch.cuda.empty_cache()
    return out


def as_tensors(tree) -> dict:
    """A numpy tree (or the path :func:`stash_tree` wrote it to) as
    tensors."""
    if isinstance(tree, str):
        tree = read_stashed_tree(tree)
    return {op: {w: torch.from_numpy(np.asarray(a)) for w, a in ws.items()}
            for op, ws in tree.items()}


def update_err(got: dict, want: dict, start: dict) -> tuple:
    """(|got - want| / |want - start|, the layer with the largest part of
    the numerator), each a 2-norm over every param: the relative error of
    the whole model's update. Over the whole model, not layer by layer: a
    bf16 step's gradients cancel over the batch in some layers, where
    rounding alone moves a quarter of the layer's update, while a dropped
    or doubled gradient moves every layer. Params left at ``start`` read
    exactly 1."""
    num = den = most = 0.0
    where = ""
    for op, ws in want.items():
        for w in ws:
            check(bool(torch.isfinite(got[op][w]).all()), f"non-finite {op}.{w}")
        d = sum(float((got[op][w] - t).double().norm() ** 2) for w, t in ws.items())
        num += d
        den += sum(float((t - start[op][w]).double().norm() ** 2) for w, t in ws.items())
        if d >= most:
            most, where = d, op
    return ((num / den) ** 0.5 if den > 0 else 0.0), where


def par_check(name: str, ranks: list, ref: dict, start: dict, card: str,
              bf16: dict = None, flash: bool = True) -> dict:
    """Hold one mesh run (every rank's record) to the one-rank run: f32
    params after PAR_STEPS steps, each layer's largest error within
    PAR_F32_TOL of its largest update; with ``bf16`` (its ``bound``) the
    params after the first step by :func:`update_err`. ``flash``:
    every rank must have launched each flash kernel (sequence-parallel
    attention is torch ops and launches none)."""
    r0 = ranks[0]
    check(len({r["backend"] for r in ranks}) == 1, f"{name}: backends {ranks}")
    if bf16 is None:
        # each of the steps rounds a param once, so each element's error
        # counts past PAR_STEPS f32 ulps of its value (the training phases' form)
        steps, bound, what = PAR_STEPS, PAR_F32_TOL, "of the layer's largest update"
        err, worst = layer_err(as_tensors(r0["params"]), as_tensors(ref["params"]),
                               as_tensors(start), ulps=PAR_STEPS)
    else:
        steps, bound, what = 1, bf16["bound"], "of the model's update (2-norm)"
        err, worst = update_err(as_tensors(r0["first"]), as_tensors(ref["first"]),
                                      as_tensors(start))
    after = f"{steps} step{'s' if steps > 1 else ''}"
    check(err <= bound, f"{name}: params after {after} {err:.3g} {what} from the "
                        f"one-rank run (worst {worst}) > {bound:.3g}")
    per_rank = [{k: r["launches"][k] for k in FLASH_NAMES} for r in ranks]
    if flash and DEVICE == "cuda":
        check(all(v > 0 for lr in per_rank for v in lr.values()),
              f"{name}: a rank launched no flash kernel: {per_rank}")
    shaped = r0["shape_host_bytes_per_step"]
    if shaped is not None and r0["backend"] == "gloo" and DEVICE == "cuda":
        check(abs(r0["host_bytes_per_step"] - shaped) <= 1024,
              f"{name}: {r0['host_bytes_per_step']} bytes a step through the host, the "
              f"shapes give {shaped}")
    row = dict(name=name, card=card, backend=r0["backend"], world=len(ranks),
               mesh=r0["mesh"], local_attention_shapes=[r["local_attention_shapes"] for r in ranks],
               launches_per_rank=per_rank,
               step_ms_median=r0["step_ms_median"],
               step_ms_median_max_rank=max(r["step_ms_median"] for r in ranks),
               one_rank_step_ms_median=ref["step_ms_median"],
               host_bytes_per_step=r0["host_bytes_per_step"],
               shape_host_bytes_per_step=shaped,
               collectives_per_step=r0["collectives_per_step"],
               steps_held=steps, param_err_vs_one_rank=err, param_err_worst=worst,
               bound=bound, bf16=bf16)
    counted = "" if shaped is None else f" (the shapes give {shaped / 2 ** 20:.1f})"
    print(f"parallel {name}: backend {r0['backend']}, world {len(ranks)}, mesh {r0['mesh']}; "
          f"local attention (B*H, S, D) by rank {row['local_attention_shapes']}; flash "
          f"launches by rank {per_rank}; warm step {r0['step_ms_median']:.1f} ms median of "
          f"{PAR_TIMED - 1} (slowest rank {row['step_ms_median_max_rank']:.1f}; one rank "
          f"{ref['step_ms_median']:.1f}); {r0['host_bytes_per_step'] / 2 ** 20:.1f} MiB a step "
          f"through the host{counted} in {r0['collectives_per_step']:.0f} collectives; params "
          f"after {after} {err:.3g} {what} from the one-rank run (worst {worst}; bound "
          f"{bound:.3g}) [{card}]", flush=True)
    return row


def phase_parallel(card: str) -> dict:
    """(a) the reference Transformer at full width and PAR_LAYERS layers on
    {data: 2} and (b) on {data: 2, model: 2} with tp_axis "model", both
    dtypes, 8 samples per
    data rank, spawned ranks sharing this card over gloo (NCCL where each
    rank has a card); (c) {data: 2, seq: 2} at PAR_SEQ_LAYERS layers, ring
    and a2a, float32; every run held to the one-rank run of the same
    global batches on the card; then ring_all_reduce against
    psum_all_reduce on 64 MB."""
    from flexflow_tpu_torch.parallel.distributed import spawn

    t0 = time.perf_counter()
    full, short = par_opts(PAR_LAYERS), par_opts(PAR_SEQ_LAYERS)
    refs = {dt: par_fit(full, dt) for dt in ("float32", "bfloat16")}
    refs["seq"] = par_fit(short, "float32")
    free_device()
    two = spawn(par_worker, 2, [("fit", full, dict(compute_dtype=dt, mesh_shape={"data": 2}))
                                for dt in ("float32", "bfloat16")]
                + [("collectives", full, {})])
    four = spawn(par_worker, 4,
                 [("fit", full, dict(compute_dtype=dt, mesh_shape={"data": 2, "model": 2},
                                     tp="model")) for dt in ("float32", "bfloat16")]
                 + [("fit", short, dict(compute_dtype="float32",
                                        mesh_shape={"data": 2, "seq": 2}, seq_axis="seq",
                                        seq_mode=mode)) for mode in ("ring", "a2a")])
    start = refs["float32"]["start"]
    first16, first32 = (as_tensors(refs[dt]["first"]) for dt in ("bfloat16", "float32"))
    floor = update_err(first16, first32, as_tensors(start))[0]
    control = update_err(as_tensors(start), first16, as_tensors(start))[0]
    bf16 = dict(bound=BF16_FLOOR_FACTOR * floor, floor=floor, control=control)
    print(f"parallel bf16 bound: one-rank bf16 vs f32 after 1 step {floor:.3g} of the model's "
          f"update (2-norm), x{BF16_FLOOR_FACTOR} = {bf16['bound']:.3g}; params left at their "
          f"start read {control:.3g}", flush=True)
    check(bf16["bound"] < PAR_BF16_CONTROL_SHARE * control,
          f"the bf16 bound {bf16['bound']:.3g} is not under {PAR_BF16_CONTROL_SHARE} of the "
          f"unchanged params' reading {control:.3g}: it could pass a run that did not train")
    rows = []
    for i, dt in enumerate(("float32", "bfloat16")):
        for tag, runs in (("(a) {data: 2}", two), ("(b) {data: 2, model: 2}", four)):
            rows.append(par_check(f"{tag} {dt}", [r[i] for r in runs], refs[dt], start, card,
                                  bf16 if dt == "bfloat16" else None))
    for i, mode in enumerate(("ring", "a2a"), start=2):
        rows.append(par_check(f"(c) {{data: 2, seq: 2}} {mode} float32 {PAR_SEQ_LAYERS} layers",
                              [r[i] for r in four], refs["seq"], refs["seq"]["start"], card,
                              flash=False))
    coll = [r[2] for r in two]
    check(all(c["err"] <= 1e-6 for c in coll),
          f"ring_all_reduce vs psum_all_reduce: {[c['err'] for c in coll]}")
    coll_row = dict(bytes=coll[0]["bytes"], err=max(c["err"] for c in coll),
                    ring_ms=coll[0]["ring_ms"], psum_ms=coll[0]["psum_ms"], card=card)
    print(f"parallel collectives: ring_all_reduce vs psum_all_reduce over 2 ranks on "
          f"{coll_row['bytes'] / 2 ** 20:.0f} MiB f32: max err {coll_row['err']:.3g} of the "
          f"largest |sum|, ring {coll_row['ring_ms']:.1f} ms, psum {coll_row['psum_ms']:.1f} ms "
          f"(median of 3, host staging included) [{card}]", flush=True)
    launches = {k: sum(lr[k] for row in rows for lr in row["launches_per_rank"])
                for k in FLASH_NAMES}
    shutil.rmtree(TREE_DIR, ignore_errors=True)
    out = dict(rows=rows, collectives=coll_row, launches=launches,
               seconds=time.perf_counter() - t0)
    print("parallel_json " + json.dumps(out), flush=True)
    # the one-rank runs and the bf16 bound, for phase_parallel_b
    return out, dict(refs=refs, bf16=bf16)


# ---- phase_parallel_b: expert parallelism, ZeRO-1 and the pipeline (A7b)
EP_EXPERTS = 8  # MoeConfig()'s 5 experts split over 5 ranks only; 8 over 2 and 4
EP_STEPS = 3  # fit steps held to the one-rank run
EP_NO_DROP_ALPHA, EP_DROP_ALPHA = 4.0, 2.0
# (schedule, interleave, engine, dtype) on {pipe: 2}; then 1f1b single-call
# on {pipe: 2, data: 2}
PIPE_RUNS = (("gpipe", 1, "host", "float32"), ("1f1b", 1, "compiled", "float32"),
             ("interleaved", 2, "compiled", "float32"), ("1f1b", 1, "compiled", "bfloat16"))


def ep_model(opts: dict, compute_dtype: str, mesh_shape, alpha: float, stacked: bool,
             num_exp: int):
    """build_moe_mnist at MoeConfig()'s widths (784 in, 64 hidden, 10
    classes, k 2, lambda 0.04) with ``num_exp`` experts, batch 64, SGD at
    lr 0.1; stacked ones put the experts on ``data`` (expert parallelism
    over a data mesh, no-op on one rank)."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, MetricsType, SGDOptimizer
    from flexflow_tpu_torch.models.moe import MoeConfig, build_moe_mnist

    ff = FFModel(FFConfig(batch_size=MOE_BATCH, compute_dtype=compute_dtype, seed=SEED,
                          device=opts["device"], mesh_shape=mesh_shape))
    build_moe_mnist(ff, MOE_BATCH, MoeConfig(num_exp=num_exp, alpha=alpha), stacked=stacked,
                    expert_axis="data" if stacked else None)
    ff.compile(optimizer=SGDOptimizer(lr=0.1),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def ep_kernel_check(shapes: set, device: str) -> list:
    """K4 and K5 at each shape this rank launched them with on the path
    (the dispatch, the combine and their backwards), on fresh data: each
    wrapper against its plain version (held exact), and each one's ms
    (CUDA events, median of 20)."""
    from flexflow_tpu_torch.kernels import moe_kernels as mk

    out = []
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 161)
    for name, x_shape, idx_shape, dtype in sorted(shapes):
        dt = getattr(torch, dtype)
        x = torch.randn(x_shape, generator=gen, device=device).to(dt)
        idx = torch.randint(0, x_shape[0], idx_shape, generator=gen, device=device,
                            dtype=torch.int32)
        w = torch.rand(idx_shape, generator=gen, device=device)
        fn = mk.row_gather if name == "row_gather" else mk.row_gather_sum
        plain = mk.row_gather_reference if name == "row_gather" else mk.row_gather_sum_reference
        got, want = fn(x, idx, w), plain(x, idx, w)
        err = (got.float() - want.float()).abs().max().item()
        check(err <= MOE_TOL, f"{name} at the rank's shape {x_shape} <- {idx_shape} {dtype}: "
                              f"{err} from its plain version")
        row = dict(name=name, x=list(x_shape), idx=list(idx_shape), dtype=dtype,
                   max_abs_err=err)
        if device == "cuda":
            row["ms"] = time_ms(lambda: fn(x, idx, w), 20)
            row["plain_ms"] = time_ms(lambda: plain(x, idx, w), 20)
        out.append(row)
    return out


def ep_fit(opts: dict, compute_dtype: str, mesh_shape=None, alpha: float = EP_NO_DROP_ALPHA,
           stacked: bool = True, num_exp: int = EP_EXPERTS) -> dict:
    """One run of (d) on this rank: the MoE model over the mesh, fit of
    EP_STEPS global batches one by one (launches counted around them, the
    shapes the MoE kernels got recorded; the first batch's loss evaluated
    before and after its step), then K4/K5 at those shapes
    against their plain versions, then PAR_TIMED train_steps timed, the
    bytes staged through the host counted over them. Rank 0 (or the
    one-rank run) adds the whole params after the first step and after
    the fit."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.kernels import moe_kernels as mk
    from flexflow_tpu_torch.parallel import collectives, distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    ff = ep_model(opts, compute_dtype, mesh_shape, alpha, stacked, num_exp)
    cm = ff.compiled
    x, y = moe_data(SEED + 16, MOE_BATCH * EP_STEPS)
    p0 = ff.numpy_params() if cm.mesh is None else None
    shapes, real = set(), (mk.row_gather, mk.row_gather_sum)

    def recording(name, fn):
        def run(xt, idx, w):
            shapes.add((name, tuple(xt.shape), tuple(idx.shape), str(xt.dtype).split(".")[-1]))
            return fn(xt, idx, w)
        return run

    def batch0_loss():
        pm = ff.eval(x[:MOE_BATCH], y[:MOE_BATCH], batch_size=MOE_BATCH, verbose=False)
        return pm.sparse_cce_loss / pm.train_all

    # the first batch's loss before and after the first step on it; the
    # launches counted around each fit alone
    losses, first = [batch0_loss()], None
    launches = {}
    mk.row_gather, mk.row_gather_sum = (recording("row_gather", real[0]),
                                        recording("row_gather_sum", real[1]))
    try:
        for i in range(EP_STEPS):
            rows = slice(i * MOE_BATCH, (i + 1) * MOE_BATCH)
            par_sync(opts["device"])
            kernels.reset_launch_counts()
            ff.fit(x[rows], y[rows], batch_size=MOE_BATCH, epochs=1, shuffle=False,
                   verbose=False)
            par_sync(opts["device"])
            for k, v in kernels.launch_counts().items():
                launches[k] = launches.get(k, 0) + v
            if i == 0:
                losses.append(batch0_loss())
                first = ff.numpy_params()
    finally:
        mk.row_gather, mk.row_gather_sum = real
    params = ff.numpy_params()
    rank = cm.mesh.rank if cm.mesh is not None else 0
    held = ep_kernel_check(shapes, opts["device"])
    # the bytes a step must stage under expert parallelism, from the
    # shapes: the dispatch's all-to-all (784-wide rows; the model's input
    # takes no gradient, so it has no backward) and the combine's (64
    # wide) with its backward, each buffer to the host and back; the
    # gate's and head's gradients (the experts' are not all-reduced);
    # scalars aside
    shaped = None
    if cm.mesh is not None and stacked:
        deg = cm.mesh.degree("data")
        exp = next(op for op in cm.ops if op.name == "moe_group")
        es = torch.empty((), dtype=getattr(torch, compute_dtype)).element_size()
        rows_moved = exp.n * (exp.capacity // deg)
        a2a = 2 * rows_moved * (784 + 2 * 64) * es
        dense = 4 * sum(t.numel() for op in ("moe_gate", "moe_head")
                        for t in cm.params[op].values())
        shaped = a2a + 2 * dense
    ms = []
    collectives.reset_stats()
    for i in range(PAR_TIMED):
        ff.set_batch([x[:MOE_BATCH]], y[:MOE_BATCH])
        par_sync(opts["device"])
        t0 = time.perf_counter()
        cm.params, cm.opt_state, loss, _ = cm.train_step(cm.params, cm.opt_state, None,
                                                         *ff._cur_batch)
        loss.item()
        par_sync(opts["device"])
        ms.append((time.perf_counter() - t0) * 1e3)
    st = collectives.stats()
    experts = cm.params["moe_experts"]["kernel"].shape if stacked else None
    return dict(rank=rank, backend=distributed.backend(),
                mesh=dict(cm.mesh.shape) if cm.mesh is not None else None,
                launches=launches, kernels_held=held, expert_block=list(experts) if experts is not None else None,
                losses=losses, step_ms=ms, step_ms_median=float(np.median(ms[1:])),
                host_bytes_per_step=st["staged_bytes"] / PAR_TIMED,
                shape_host_bytes_per_step=shaped,
                collectives_per_step=st["calls"] / PAR_TIMED,
                params=params if rank == 0 else None, first=first if rank == 0 else None,
                start=p0)


def ep_check(name: str, ranks: list, ref: dict, card: str, bf16: dict = None,
             drops: bool = False) -> dict:
    """Hold one (d) run: every rank launched K4 and K5 (3 and 1 a step)
    at its local shapes, held to their plain versions; the staged bytes as
    the shapes give them; then, without drops, the params against the
    one-rank run (f32: each layer's largest error after EP_STEPS steps
    within PAR_F32_TOL of its largest update; bf16: the first step's
    2-norm rule); with drops (per-shard capacity: the one-rank routing
    drops others), that the run trains."""
    r0 = ranks[0]
    per_rank = [{k: r["launches"][k] for k in ("row_gather", "row_gather_sum")} for r in ranks]
    if DEVICE == "cuda":
        check(all(lr == {"row_gather": 3 * EP_STEPS, "row_gather_sum": EP_STEPS}
                  for lr in per_rank) or r0["expert_block"] is None,
              f"{name}: MoE kernel launches by rank {per_rank}")
        check(all(lr["row_gather"] > 0 and lr["row_gather_sum"] > 0 for lr in per_rank),
              f"{name}: a rank launched no MoE kernel: {per_rank}")
    shaped = r0["shape_host_bytes_per_step"]
    if shaped is not None and r0["backend"] == "gloo" and DEVICE == "cuda":
        check(abs(r0["host_bytes_per_step"] - shaped) <= 1024,
              f"{name}: {r0['host_bytes_per_step']} bytes a step through the host, the "
              f"shapes give {shaped}")
    if drops:
        err, worst, bound, what = None, None, None, "trains"
        check(all(np.isfinite(r0["losses"])) and r0["losses"][1] < r0["losses"][0],
              f"{name}: the first step did not lower its batch's loss {r0['losses']}")
    elif bf16 is None:
        bound, what = PAR_F32_TOL, "of the layer's largest update"
        err, worst = layer_err(as_tensors(r0["params"]), as_tensors(ref["params"]),
                               as_tensors(ref["start"]), ulps=EP_STEPS)
        check(err <= bound, f"{name}: params {err:.3g} {what} from the one-rank run "
                            f"(worst {worst}) > {bound}")
    else:
        bound, what = bf16["bound"], "of the model's update (2-norm), 1 step"
        err, worst = update_err(as_tensors(r0["first"]), as_tensors(ref["first"]),
                                as_tensors(ref["start"]))
        check(err <= bound, f"{name}: params {err:.3g} {what} from the one-rank run "
                            f"(worst {worst}) > {bound:.3g}")
    row = dict(name=name, card=card, backend=r0["backend"], world=len(ranks), mesh=r0["mesh"],
               expert_block=r0["expert_block"],
               kernels_held=[r["kernels_held"] for r in ranks], launches_per_rank=per_rank,
               losses=r0["losses"], step_ms_median=r0["step_ms_median"],
               step_ms_median_max_rank=max(r["step_ms_median"] for r in ranks),
               one_rank_step_ms_median=ref["step_ms_median"] if ref else None,
               host_bytes_per_step=r0["host_bytes_per_step"], shape_host_bytes_per_step=shaped,
               collectives_per_step=r0["collectives_per_step"], param_err_vs_one_rank=err,
               param_err_worst=worst, bound=bound)
    counted = "" if shaped is None else f" (the shapes give {shaped / 2 ** 20:.3f})"
    held = "; ".join(f"{v['name']} {v['x']}<-{v['idx']} err {v['max_abs_err']} "
                     f"{v.get('ms', float('nan')):.4f} ms (plain {v.get('plain_ms', float('nan')):.4f})"
                     for v in r0["kernels_held"])
    verdict = (f"the first batch's loss {r0['losses'][0]:.6f} -> {r0['losses'][1]:.6f} after "
               f"its step" if drops else
               f"params vs one rank {err:.3g} {what} (worst {worst}; bound {bound:.3g})")
    print(f"parallel_b {name}: backend {r0['backend']}, world {len(ranks)}, expert block "
          f"{r0['expert_block']}; MoE launches by rank {per_rank}; rank 0 held {held}; warm "
          f"step {r0['step_ms_median']:.1f} ms (slowest rank "
          f"{row['step_ms_median_max_rank']:.1f}"
          + (f"; one rank {ref['step_ms_median']:.1f}" if ref else "") + f"); "
          f"{r0['host_bytes_per_step'] / 2 ** 20:.3f} MiB a step through the host{counted} in "
          f"{r0['collectives_per_step']:.0f} collectives; {verdict} [{card}]", flush=True)
    return row


def zero_check(on: list, off: list, card: str) -> dict:
    """(e): the ZeRO-1 run's params after PAR_STEPS steps against the
    ZeRO-off run's (the same arithmetic on each element: held within
    PAR_F32_TOL of each layer's largest update, and reported bitwise or
    not); the optimizer-state bytes of a rank in each."""
    err, worst = layer_err(as_tensors(on[0]["params"]), as_tensors(off[0]["params"]),
                           as_tensors(off[0]["first"]), ulps=PAR_STEPS)
    got, want = read_stashed_tree(on[0]["params"]), read_stashed_tree(off[0]["params"])
    bitwise = all(np.array_equal(got[op][w], a) for op, ws in want.items() for w, a in ws.items())
    check(err <= PAR_F32_TOL, f"(e) ZeRO-1: params {err:.3g} of the layer's largest update "
                              f"from the ZeRO-off run (worst {worst})")
    ratio = on[0]["opt_state_bytes"] / off[0]["opt_state_bytes"]
    check(ratio < 0.55, f"(e) ZeRO-1: a rank's optimizer state is {ratio:.3f} of the "
                        f"replicated run's")
    shaped = on[0]["shape_host_bytes_per_step"]
    if on[0]["backend"] == "gloo" and DEVICE == "cuda":
        check(abs(on[0]["host_bytes_per_step"] - shaped) <= 1024,
              f"(e): {on[0]['host_bytes_per_step']} bytes a step through the host, the "
              f"shapes give {shaped}")
    row = dict(name="(e) ZeRO-1 {data: 2} Adam float32", card=card,
               opt_state_bytes_zero=on[0]["opt_state_bytes"],
               opt_state_bytes_replicated=off[0]["opt_state_bytes"], ratio=ratio,
               zero_weights=on[0]["zero_weights"], step_ms_median=on[0]["step_ms_median"],
               step_ms_median_replicated=off[0]["step_ms_median"],
               host_bytes_per_step=on[0]["host_bytes_per_step"],
               host_bytes_per_step_replicated=off[0]["host_bytes_per_step"],
               shape_host_bytes_per_step=shaped,
               launches_per_rank=[{k: r["launches"][k] for k in FLASH_NAMES} for r in on],
               param_err_vs_replicated=err, param_err_worst=worst, bitwise=bitwise)
    print(f"parallel_b (e) ZeRO-1 {{data: 2}} Adam float32: optimizer state a rank "
          f"{on[0]['opt_state_bytes'] / 2 ** 20:.1f} MiB vs {off[0]['opt_state_bytes'] / 2 ** 20:.1f}"
          f" replicated ({ratio:.4f}; {on[0]['zero_weights']} weights sharded); warm step "
          f"{on[0]['step_ms_median']:.1f} ms vs {off[0]['step_ms_median']:.1f}; "
          f"{on[0]['host_bytes_per_step'] / 2 ** 20:.1f} MiB a step through the host (the shapes "
          f"give {shaped / 2 ** 20:.1f}) vs {off[0]['host_bytes_per_step'] / 2 ** 20:.1f}; params "
          f"after {PAR_STEPS} steps {err:.3g} of the layer's largest update from ZeRO off "
          f"(worst {worst}; bitwise {bitwise}) [{card}]", flush=True)
    return row


def pipe_check(name: str, ranks: list, ref: dict, start: dict, card: str,
               bf16: dict = None) -> dict:
    """(f): one pipeline run held to the one-rank run (phase_parallel's,
    the same global batches), as par_check holds a mesh run; every rank
    launched each flash kernel; on the host engine the bytes its ranks
    sent across the boundary equal those the shapes give."""
    row = par_check(name, ranks, ref, start, card, bf16)
    by_pipe = {}
    for r in ranks:
        by_pipe.setdefault(r["stage"], []).append(r)
    r0 = ranks[0]
    dp = len(ranks) // len(by_pipe)
    sent = sum(r["sent_bytes_per_step"] for r in ranks) / dp
    if r0["engine"] == "host":
        check(sent == r0["boundary_bytes_per_step"],
              f"{name}: {sent} boundary bytes sent a step, the shapes give "
              f"{r0['boundary_bytes_per_step']}")
    row.update(engine=r0["engine"], schedule=r0["schedule"], interleave=r0["interleave"],
               microbatches=r0["microbatches"], ticks=r0["ticks"],
               boundary_bytes_per_step=r0["boundary_bytes_per_step"],
               sent_bytes_per_step=sent,
               peak_activation_bytes=[r["peak_activation_bytes"]["per_stage"][r["stage"]]
                                      for r in ranks],
               max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
               stages=[r["stage"] for r in ranks])
    print(f"parallel_b {name}: engine {r0['engine']}, {r0['ticks']} ticks, "
          f"{r0['microbatches']} microbatches; boundary bytes a step {sent / 2 ** 20:.1f} MiB "
          f"sent (the shapes give {r0['boundary_bytes_per_step'] / 2 ** 20:.1f}); stages "
          f"{row['stages']}: peak activation bytes {[b / 2 ** 20 for b in row['peak_activation_bytes']]}"
          f" MiB beside max_memory_allocated "
          f"{[None if m is None else round(m / 2 ** 20, 1) for m in row['max_memory_allocated']]}"
          f" MiB [{card}]", flush=True)
    return row


def phase_parallel_b(card: str, par: dict) -> dict:
    """(d) expert parallelism: the stacked MoE (8 experts over ``data``) on
    {data: 2} and {data: 4}, f32 and bf16 at alpha 4.0 (no drops) held to
    the one-rank run, f32 at alpha 2.0 (per-shard drops) checked to train,
    and the n-branch MoE (MoeConfig()) on {data: 2} routing the gathered
    batch, held to one rank; K4/K5 at each rank's local shapes against
    their plain versions. (e) ZeRO-1: the Transformer at full width with
    Adam on {data: 2}, on and off. (f) the pipeline: the Transformer at
    full width on {pipe: 2} (gpipe host; 1f1b and interleaved single-call;
    1f1b single-call bf16) and {pipe: 2, data: 2} (1f1b single-call), at
    PAR_LAYERS layers, held to phase_parallel's one-rank runs. The ranks
    share this card over gloo."""
    from flexflow_tpu_torch.models.moe import MoeConfig
    from flexflow_tpu_torch.parallel.distributed import spawn

    t0 = time.perf_counter()
    # the pipeline at phase_parallel's depth (its one-rank runs); ZeRO-1
    # at TransformerConfig()'s
    opts, full, piped = dict(device=DEVICE), par_opts(), par_opts(PAR_LAYERS)
    refs = {dt: ep_fit(opts, dt) for dt in ("float32", "bfloat16")}
    n_branch = MoeConfig().num_exp
    refs["n-branch"] = ep_fit(opts, "float32", alpha=EP_DROP_ALPHA, stacked=False,
                              num_exp=n_branch)
    start = as_tensors(refs["float32"]["start"])
    floor = update_err(as_tensors(refs["bfloat16"]["first"]),
                       as_tensors(refs["float32"]["first"]), start)[0]
    control = update_err(start, as_tensors(refs["bfloat16"]["first"]), start)[0]
    ep_bf16 = dict(bound=BF16_FLOOR_FACTOR * floor, floor=floor, control=control)
    print(f"parallel_b (d) bf16 bound: one-rank bf16 vs f32 after 1 step {floor:.3g} of the "
          f"model's update (2-norm), x{BF16_FLOOR_FACTOR} = {ep_bf16['bound']:.3g}; params "
          f"left at their start read {control:.3g}", flush=True)
    check(ep_bf16["bound"] < PAR_BF16_CONTROL_SHARE * control,
          f"(d) the bf16 bound {ep_bf16['bound']:.3g} is not under {PAR_BF16_CONTROL_SHARE} of "
          f"the unchanged params' reading {control:.3g}")
    free_device()
    print(f"phases: parallel_b one-rank runs at {time.perf_counter() - t0:.1f} s", flush=True)
    ep_jobs = lambda mesh: [  # noqa: E731
        ("ep", opts, dict(compute_dtype=dt, mesh_shape=mesh)) for dt in ("float32", "bfloat16")
    ] + [("ep", opts, dict(compute_dtype="float32", mesh_shape=mesh, alpha=EP_DROP_ALPHA))]
    pipe = lambda sched, inter, engine: dict(num_stages=2, num_microbatches=4,  # noqa: E731
                                             schedule=sched, interleave=inter, engine=engine)
    two = spawn(par_worker, 2, ep_jobs({"data": 2})
                + [("ep", opts, dict(compute_dtype="float32", mesh_shape={"data": 2},
                                     alpha=EP_DROP_ALPHA, stacked=False,
                                     num_exp=n_branch))]
                + [("fit", full, dict(compute_dtype="float32", mesh_shape={"data": 2},
                                      adam=True, zero=z)) for z in (True, False)]
                + [("fit", piped, dict(compute_dtype=dt, mesh_shape={"pipe": 2},
                                      pipeline=pipe(sched, inter, engine)))
                   for sched, inter, engine, dt in PIPE_RUNS])
    print(f"phases: parallel_b 2 ranks at {time.perf_counter() - t0:.1f} s", flush=True)
    four = spawn(par_worker, 4, ep_jobs({"data": 4})
                 + [("fit", piped, dict(compute_dtype="float32", mesh_shape={"pipe": 2, "data": 2},
                                       pipeline=pipe("1f1b", 1, "compiled")))])
    print(f"phases: parallel_b 4 ranks at {time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for world, runs in ((2, two), (4, four)):
        for i, dt in enumerate(("float32", "bfloat16")):
            rows.append(ep_check(f"(d) {{data: {world}}} stacked, 8 experts, alpha "
                                 f"{EP_NO_DROP_ALPHA} {dt}", [r[i] for r in runs], refs[dt], card,
                                 ep_bf16 if dt == "bfloat16" else None))
        rows.append(ep_check(f"(d) {{data: {world}}} stacked, 8 experts, alpha {EP_DROP_ALPHA} "
                             f"float32", [r[2] for r in runs], None, card, drops=True))
    rows.append(ep_check(f"(d) {{data: 2}} n-branch MoeConfig(), gathered routing float32",
                         [r[3] for r in two], refs["n-branch"], card))
    zero = zero_check([r[4] for r in two], [r[5] for r in two], card)
    prefs, pstart = par["refs"], par["refs"]["float32"]["start"]
    for i, (sched, inter, engine, dt) in enumerate(PIPE_RUNS, start=6):
        rows.append(pipe_check(f"(f) {{pipe: 2}} {sched}{' V 2' if inter > 1 else ''} "
                               f"{engine} {dt}", [r[i] for r in two], prefs[dt], pstart, card,
                               par["bf16"] if dt == "bfloat16" else None))
    rows.append(pipe_check("(f) {pipe: 2, data: 2} 1f1b compiled float32",
                           [r[3] for r in four], prefs["float32"], pstart, card))
    moe = {k: sum(lr[k] for row in rows if "expert_block" in row
                  for lr in row["launches_per_rank"]) for k in ("row_gather", "row_gather_sum")}
    flash = {k: sum(lr[k] for row in rows + [zero] if "launches_per_rank" in row
                    and k in row["launches_per_rank"][0] for lr in row["launches_per_rank"])
             for k in FLASH_NAMES}
    shutil.rmtree(TREE_DIR, ignore_errors=True)
    out = dict(rows=rows, zero=zero, moe_launches=moe, flash_launches=flash,
               seconds=time.perf_counter() - t0)
    print("parallel_b_json " + json.dumps(out), flush=True)
    return out


# ---- phase_parallel_c: multi-process runs, serving over a mesh, sharded
# tables and spatial convolution, global batch statistics (A7b items 4-7)
# (g): the launcher's cohort of 2 workers, ZeRO-1 Adam, 16 samples a step
LAUNCH_SAMPLES, LAUNCH_EPOCHS, LAUNCH_INTERVAL = 32, 4, 2  # 2 steps an epoch: 8 steps
LAUNCH_KILL_STEP, LAUNCH_HANG_STEP, LAUNCH_HANG_S = 4, 3, 10.0
LAUNCH_DIR = pathlib.Path(".ffcache") / "smoke_launch"
# (h): requests through the {model: 2} instance; GPT generation over it
MESH_REQUESTS = 32
MESH_GEN_PROMPTS, MESH_GEN_PROMPT, MESH_GEN_NEW = 4, 64, 32
# (i), (j): SGD steps held to one rank; the stem's image
MESH_STEPS, MESH_RESNET_BATCH, STEM_BATCH, STEM_PX = 3, 64, 16, 224
MESH_LR = 0.01
# ResNet-50's first update held in 2-norm over the whole model: at random
# init a batch norm's backward cancels nearly all of a flat softmax's
# gradient, so two one-rank runs whose convolutions take other algorithms
# part by percents in deep layers (0.5 % of the model's update on the CPU
# between thread counts), while a gradient lost or counted twice over the
# data axis moves it by half or more
MESH_RESNET_TOL = 0.1
# (j)'s running statistics after the first step, by the layer rule of (i)
# and the stem (a batch norm's running mean and variance are its layer):
# both runs read the same params there, so global statistics part only by
# summation order, while per-rank ones over half the batch part by their
# sampling noise: on the H100, 1.0e-7 global and 1.8e-3 per-rank
# (scripts/torch_bn_stats_control.py), so the bound sits a hundredfold from
# each. After MESH_STEPS steps they follow the params' deep-layer
# divergence (0.11 global, 0.98 per-rank) and are reported
MESH_BN_STATS_TOL = 1e-5


def launch_job(config: dict, nproc: int):
    """(g)'s job for ``parallel/launch.py``'s workers (``--job
    chip_smoke:launch_job``): the reference Transformer at full width and
    PAR_LAYERS layers, ZeRO-1 Adam on {data: nproc}, 16 samples a step
    (8 a rank of 2), LAUNCH_SAMPLES samples from par_data's seed."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, LossType, MetricsType
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    opts = par_opts(PAR_LAYERS)
    batch = 2 * PAR_BATCH
    cfg = TransformerConfig(hidden_size=opts["hidden"], embedding_size=opts["hidden"],
                            num_heads=opts["heads"], num_layers=opts["layers"],
                            sequence_length=opts["seq"])
    ff = FFModel(FFConfig(batch_size=batch, seed=SEED, mesh_shape={"data": nproc},
                          zero_optimizer=True, **config))
    build_transformer(ff, batch, cfg)
    ff.compile(optimizer=AdamOptimizer(alpha=1e-4),
               loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               metrics=[MetricsType.MEAN_SQUARED_ERROR])
    x, y = par_data(opts, LAUNCH_SAMPLES)
    return ff, x, y


def par_launch(card: str) -> dict:
    """(g) the uninterrupted cohort, a peer killed by ``multihost.peer_kill``
    at step LAUNCH_KILL_STEP and one stalled by ``multihost.slow_peer`` at
    step LAUNCH_HANG_STEP run at once (six workers sharing this card over
    gloo); then one process resumes the killed cohort's checkpoints. The
    relaunched cohorts' params must equal the uninterrupted one's bit for
    bit (their digests); the shrunk one takes the counted elastic path."""
    from flexflow_tpu_torch.parallel import launch

    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    common = dict(nproc=2, job="chip_smoke:launch_job", epochs=LAUNCH_EPOCHS,
                  interval=LAUNCH_INTERVAL, device=DEVICE, cohort_timeout_s=600.0)
    kill = {"schema": 1, "seed": 0, "sites": {"multihost.peer_kill": {
        "at_step": LAUNCH_KILL_STEP, "exit_code": launch.KILL_EXIT}}}
    hang = {"schema": 1, "seed": 0, "sites": {"multihost.slow_peer": {
        "at_step": LAUNCH_HANG_STEP, "stall_s": 600.0}}}
    runs = {"baseline": dict(max_relaunches=0),
            "kill": dict(fault_plan=kill, fault_rank=1, max_relaunches=2),
            "hang": dict(fault_plan=hang, fault_rank=1, hang_threshold_s=LAUNCH_HANG_S,
                         max_relaunches=2)}
    reps, errors = {}, {}

    def run(name, kw):
        try:
            reps[name] = launch.supervise(run_dir=str(LAUNCH_DIR / name), **common, **kw)
        except BaseException as e:  # noqa: BLE001 (checked below, in the main thread)
            errors[name] = repr(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=item) for item in runs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    together_s = time.perf_counter() - t0
    check(not errors and all(r["ok"] for r in reps.values()),
          f"(g) cohorts failed: {errors or {n: (r.get('error'), r['events']) for n, r in reps.items() if not r['ok']}}")
    base, killed, hung = reps["baseline"], reps["kill"], reps["hang"]
    steps = LAUNCH_EPOCHS * LAUNCH_SAMPLES // (2 * PAR_BATCH)
    check(base["agree"] and base["results"]["0"]["iteration"] == steps,
          f"(g) baseline: ranks agree {base['agree']}, iteration "
          f"{base['results']['0']['iteration']} (want {steps})")
    ev = killed["events"][0] if killed["events"] else {}
    check(killed["relaunches"] == 1 and ev.get("outcome") == "dead"
          and ev.get("failed") == {"1": launch.KILL_EXIT},
          f"(g) kill: {killed['relaunches']} relaunches, first event {ev}")
    check(all(r["resumes"] >= 1 for r in killed["results"].values()),
          "(g) kill: a relaunched rank did not resume from its shard")
    check(hung["relaunches"] == 1 and hung["events"][0]["outcome"] == "hung",
          f"(g) hang: {hung['relaunches']} relaunches, events "
          f"{[e['outcome'] for e in hung['events']]}")
    sha = base["results"]["0"]["params_sha"]
    for name, rep in (("kill", killed), ("hang", hung)):
        check(rep["agree"] and rep["results"]["0"]["params_sha"] == sha,
              f"(g) {name}: the relaunched cohort's params differ from the uninterrupted "
              f"cohort's")
    t1 = time.perf_counter()
    shrunk = launch.supervise(run_dir=str(LAUNCH_DIR / "shrink"), ckpt_dir=killed["ckpt_dir"],
                              max_relaunches=0,
                              **dict(common, nproc=1, epochs=LAUNCH_EPOCHS + 1))
    shrink_s = time.perf_counter() - t1
    check(shrunk["ok"], f"(g) shrink: {shrunk.get('error')} {shrunk['events']}")
    res = shrunk["results"]["0"]
    check(res["elastic_resumes"] >= 1 and res["iteration"] > steps,
          f"(g) shrink 2 -> 1: elastic resumes {res['elastic_resumes']}, iteration "
          f"{res['iteration']} (restored {steps})")
    payload = pathlib.Path(killed["ckpt_dir"]) / "shard-000" / f"step_{steps}.pt"
    ckpt_bytes = payload.stat().st_size
    launches = {k: sum(r["kernel_launches"][k] for rep in list(reps.values()) + [shrunk]
                       for r in rep["results"].values()) for k in FLASH_NAMES}
    row = dict(card=card, steps=steps, together_s=together_s, shrink_s=shrink_s,
               seconds={n: r["seconds"] for n, r in reps.items()},
               kill_events=[e["outcome"] for e in killed["events"]],
               hang_events=[e["outcome"] for e in hung["events"]],
               bitwise_after_kill=True, bitwise_after_hang=True,
               elastic_resumes=res["elastic_resumes"], shrunk_iteration=res["iteration"],
               checkpoint_bytes_a_rank=ckpt_bytes, launches=launches)
    print(f"parallel_c (g) launcher: the Transformer at full width, {PAR_LAYERS} layers, "
          f"ZeRO-1 Adam, {{data: 2}} as two worker processes, {steps} steps, a checkpoint "
          f"every {LAUNCH_INTERVAL}: peer killed at step {LAUNCH_KILL_STEP} -> "
          f"{row['kill_events']} -> relaunched, params bitwise equal to the uninterrupted "
          f"cohort's; peer stalled at step {LAUNCH_HANG_STEP} -> {row['hang_events']} after "
          f"{LAUNCH_HANG_S:g} s without progress -> relaunched, bitwise equal; 2 -> 1 shrink "
          f"resumed through restore_elastic ({res['elastic_resumes']} elastic resume, "
          f"iteration {res['iteration']}); the three cohorts took {together_s:.1f} s together "
          f"(baseline {base['seconds']:.1f}, kill {killed['seconds']:.1f}, hang "
          f"{hung['seconds']:.1f}), the shrunk one {shrink_s:.1f} s; {ckpt_bytes / 2 ** 20:.1f} "
          f"MiB a rank's checkpoint payload; flash launches {launches} [{card}]", flush=True)
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    return row


def mesh_transformer(ff, bs: int) -> None:
    """(h)'s builder, importable by the rank group: the Transformer
    phase_serving serves; the repository entry carries the strategies and
    the compute dtype."""
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer

    build_transformer(ff, bs, TransformerConfig())


def mesh_gpt(ff, bs: int) -> None:
    """(h)'s generator builder: GPT at gpt_config(), heads and MLP over
    ``model``."""
    from flexflow_tpu_torch.models import build_gpt

    build_gpt(ff, bs, MESH_GEN_PROMPT, gpt_config(), tp_axis="model")


def tp_strategies() -> dict:
    """The Transformer's tensor-parallel strategies by layer name (what
    ``tp_axis="model"`` sets), for a repository entry."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer

    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    build_transformer(ff, BATCH, TransformerConfig(), tp_axis="model")
    return {l.name: l.attrs["strategy"] for l in ff.layers if l.attrs.get("strategy")}


def serve_mesh_classic(compute_dtype: str, card: str, tmp: pathlib.Path,
                       f32_ref: np.ndarray = None) -> tuple:
    """(h) the Transformer over {model: 2}: a repository entry with the
    strategies, its two ranks sharing this card, phase_serving's random
    params; MESH_REQUESTS requests against the one-device instance with
    the same params, f32 within SERVE_TOL, bf16 within twice the
    one-device bf16 instance's distance from ``f32_ref`` (the f32
    one-device answers; the rule ROADMAP gives phase_serving's thin bf16
    margin). Returns (row, the one-device answers)."""
    from flexflow_tpu_torch import CompMode, FFConfig, FFModel, load_numpy_params
    from flexflow_tpu_torch.serving import InferenceEngine, ModelInstance

    ff = FFModel(FFConfig(batch_size=BATCH, computation_mode=CompMode.INFERENCE,
                          compute_dtype=compute_dtype, seed=SEED, device=DEVICE))
    mesh_transformer(ff, BATCH)
    ff.compile()
    load_numpy_params(ff, random_params(ff, SEED))
    cm = ff.compiled
    rng = np.random.default_rng(SEED + 61)
    xs = rng.standard_normal(size=(MESH_REQUESTS, SEQ, cm.input_tensors[0].dims[-1]),
                             dtype=np.float32)
    one = ModelInstance(ff, "one")
    ref = np.concatenate([one.infer([xs[i:i + BATCH]])[0] for i in range(0, len(xs), BATCH)])
    weights = weights_by_order(cm)
    n_attn = sum(op.op_type.name == "MULTIHEAD_ATTENTION" for op in cm.ops)
    del one, ff, cm
    free_device()
    path = tmp / f"mesh_repository_{compute_dtype}.json"
    path.write_text(json.dumps({"models": {"tp": {
        "instances": 1, "mesh_shape": {"model": 2}, "batch_size": BATCH,
        "strategies": tp_strategies(),
        "config": {"compute_dtype": compute_dtype, "seed": SEED}}}}))
    eng = InferenceEngine()
    try:
        t0 = time.perf_counter()
        placed = eng.load_repository(str(path), builders={"tp": mesh_transformer},
                                     devices=[DEVICE, DEVICE])
        start_s = time.perf_counter() - t0
        check(placed == {"tp": 1}, f"(h) repository placed {placed}")
        (inst,) = eng.instances("tp")
        inst.load_weights(weights)
        eng.infer("tp", [xs[0]], timeout=600)  # warm-up
        inst.group.call("launch_counts", True)
        d0 = inst.dispatches
        t0 = time.perf_counter()
        futs = [eng.infer_async("tp", [x]) for x in xs]
        got = np.stack([f.result(600) for f in futs])
        serve_s = time.perf_counter() - t0
        counts = inst.group.call("launch_counts", False)
        dispatches = inst.dispatches - d0
        pids = inst.group.pids
    finally:
        eng.stop()
    tol = SERVE_TOL[compute_dtype]
    if f32_ref is not None:
        tol = BF16_FLOOR_FACTOR * float(np.abs(ref - f32_ref).max()) / float(
            np.abs(f32_ref).max())
    err = check_served(got, ref, tol, f"(h) {{model: 2}} Transformer {compute_dtype}")
    fwd = [c["flash_attention_fwd"] for c in counts]
    check(all(f == n_attn * dispatches for f in fwd),
          f"(h) {compute_dtype}: flash launches by rank {fwd}, want {n_attn} a dispatch "
          f"x {dispatches}")
    local = [BATCH * HEADS // 2, SEQ, HEAD_DIM]
    rule = "" if f32_ref is None else ", twice the one-device bf16 instance's distance from f32"
    row = dict(card=card, compute_dtype=compute_dtype, requests=MESH_REQUESTS,
               dispatches=dispatches, req_per_s=MESH_REQUESTS / serve_s, start_s=start_s,
               err_vs_one_device=err, tol=tol,
               flash_launches_by_rank=fwd, local_attention_shape=local, ranks=len(pids))
    print(f"parallel_c (h) {{model: 2}} Transformer {compute_dtype}: load_repository with "
          f"{len(tp_strategies())} strategies, two ranks on this card over gloo (started in "
          f"{start_s:.1f} s); {MESH_REQUESTS} requests in {dispatches} dispatches, "
          f"{row['req_per_s']:.1f} req/s; answers vs the one-device instance {err:.3g} of the "
          f"largest (tol {tol:.3g}{rule}); K1 launches by rank {fwd} at (B*H, S, D) = "
          f"{tuple(local)} [{card}]", flush=True)
    return dict(row, launches=sum(fwd)), ref


def serve_mesh_generation(card: str, tmp: pathlib.Path) -> tuple:
    """(h) GPT at gpt_config() in f32: MESH_GEN_PROMPTS prompts of
    MESH_GEN_PROMPT tokens, MESH_GEN_NEW greedy tokens each, through a
    repository ``"generator": true`` entry over {model: 2} (the rank
    group's paged pools hold 4 of the 8 heads each), against the
    one-device dense Generator with the same params: each answer equal up
    to a first parting where the reference's full-forward top-2 margin is
    within GEN_TOL of its largest |logit|. Returns (row, the prompts, the
    weights by op order, the reference answers and margins) for the dense
    Generator's run over the ranks."""
    from flexflow_tpu_torch import load_numpy_params
    from flexflow_tpu_torch.serving import Generator, InferenceEngine

    ff, _ = gpt_model("float32", training=False)
    load_numpy_params(ff, gpt_params(ff, SEED))
    cm = ff.compiled
    rng = np.random.default_rng(SEED + 71)
    vocab = gpt_config().vocab_size
    prompts = rng.integers(0, vocab, size=(MESH_GEN_PROMPTS, MESH_GEN_PROMPT), dtype=np.int32)
    total = MESH_GEN_PROMPT + MESH_GEN_NEW
    ref = Generator(ff, max_length=total, batch_size=MESH_GEN_PROMPTS).generate(
        prompts, MESH_GEN_NEW)
    traffic = [(p, MESH_GEN_NEW) for p in prompts]
    margins = full_forward_margins(cm, traffic, list(ref))
    bounds = [GEN_TOL["float32"] * m[2] for m in margins]
    weights = weights_by_order(cm)
    del ff, cm
    free_device()
    path = tmp / "mesh_generator.json"
    path.write_text(json.dumps({"models": {"lm": {
        "generator": True, "mesh_shape": {"model": 2}, "batch_size": 1,
        "decode_slots": MESH_GEN_PROMPTS, "block_size": 16, "max_length": total,
        "prefill_buckets": [MESH_GEN_PROMPT, total], "config": {"seed": SEED}}}}))
    eng = InferenceEngine()
    try:
        placed = eng.load_repository(str(path), builders={"lm": mesh_gpt},
                                     devices=[DEVICE, DEVICE])
        check(placed == {"lm": 1}, f"(h) generator repository placed {placed}")
        gen = eng.generator("lm")
        gen.decoder.load_weights(weights)
        t0 = time.perf_counter()
        futs = [eng.generate_async("lm", p, MESH_GEN_NEW) for p in prompts]
        outs = [np.asarray(f.result(600)) for f in futs]
        gen_s = time.perf_counter() - t0
        stats = gen.stats()
    finally:
        eng.stop()
    parted, worst = first_divergences(outs, list(ref), margins, bounds)
    row = dict(card=card, prompts=MESH_GEN_PROMPTS, prompt=MESH_GEN_PROMPT, new=MESH_GEN_NEW,
               tokens_per_s=MESH_GEN_PROMPTS * MESH_GEN_NEW / gen_s,
               decode_steps=stats["decode_steps"], parted=parted, worst_margin_share=worst,
               rank_pool_bytes=gen.decoder.rank_pool_bytes)
    print(f"parallel_c (h) GPT {{model: 2}} GenerationInstance float32: {MESH_GEN_PROMPTS} "
          f"prompts of {MESH_GEN_PROMPT}, {MESH_GEN_NEW} greedy tokens each in "
          f"{stats['decode_steps']} decode steps, {row['tokens_per_s']:.1f} tokens/s; "
          f"{parted} answers part from the one-device Generator's (at margins up to "
          f"{worst:.3g} of the bound); {row['rank_pool_bytes'] / 2 ** 20:.1f} MiB of arenas "
          f"a rank [{card}]", flush=True)
    return row, (prompts, weights, list(ref), margins, bounds)


def stash_weights(weights: list) -> str:
    """Weights by op order to TREE_DIR; returns the path."""
    return stash_tree({str(i): ws for i, ws in enumerate(weights)})


def read_weights(path: str) -> list:
    tree = read_stashed_tree(path)
    return [tree[str(i)] for i in range(len(tree))]


def mesh_model(kind: str, device: str, mesh_shape=None):
    """(i)/(j)'s models: DLRM at DLRMConfig() (tables sharded over
    ``model`` under a mesh), ResNet-50 with batch norm at 229 px, and the
    ResNet-50 stem (7x7/2 conv, batch norm, 3x3/2 pool) at STEM_PX with a
    spatial strategy over ``model`` under a mesh; SGD at MESH_LR."""
    from flexflow_tpu_torch import DataType, FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch import models as m

    on_mesh = bool(mesh_shape)
    batch = {"dlrm": ZOO_BATCH, "resnet": MESH_RESNET_BATCH, "stem": STEM_BATCH}[kind]
    ff = FFModel(FFConfig(batch_size=batch, seed=SEED, device=device, mesh_shape=mesh_shape))
    strategies = None
    if kind == "dlrm":
        m.build_dlrm(ff, batch, param_axis="model" if on_mesh else None)
        loss = LossType.MEAN_SQUARED_ERROR_AVG_REDUCE
    elif kind == "resnet":
        m.build_resnet50(ff, batch, use_bn=True)
        loss = LossType.SPARSE_CATEGORICAL_CROSSENTROPY
    else:
        x = ff.create_tensor((batch, 3, STEM_PX, STEM_PX), DataType.FLOAT, name="stem_in")
        t = ff.conv2d(x, 64, 7, 7, 2, 2, 3, 3, use_bias=False, name="stem_conv")
        t = ff.pool2d(ff.batch_norm(t, name="stem_bn"), 3, 3, 2, 2, 1, 1, name="stem_pool")
        ff.softmax(ff.dense(ff.flat(t), 10, name="stem_head"))
        loss = LossType.SPARSE_CATEGORICAL_CROSSENTROPY
        strategies = {"stem_conv": {"spatial": "model"}} if on_mesh else None
    ff.compile(SGDOptimizer(lr=MESH_LR), loss, strategies=strategies)
    return ff


def mesh_data(cm, kind: str):
    rng = np.random.default_rng(SEED + {"dlrm": 81, "resnet": 82, "stem": 83}[kind])
    n = cm.input_tensors[0].dims[0] * MESH_STEPS
    return zoo_inputs(cm, n, rng), zoo_labels(cm, n, rng)


def mesh_fit(opts: dict, kind: str, mesh_shape=None, weights=None) -> dict:
    """MESH_STEPS SGD steps of ``kind`` (one global batch each, this rank's
    rows), from ``weights`` (by op order, a stashed path) when given; the
    whole params before and after by op order, stashed by rank 0 (or the
    one-rank run). DLRM's tables are cut to the rows the batches read:
    SGD without momentum or decay changes no other row, and the 4 x 256
    MiB tables would not be stashed in time."""
    from flexflow_tpu_torch.serving.group import load_weights_by_order
    from flexflow_tpu_torch.serving.group import weights_by_order as whole_weights

    ff = mesh_model(kind, opts["device"], mesh_shape)
    cm = ff.compiled
    if weights is not None:
        load_weights_by_order(ff, read_weights(weights))
    start = whole_weights(ff)
    xs, y = mesh_data(cm, kind)
    batch = cm.input_tensors[0].dims[0]
    par_sync(opts["device"])
    t0 = time.perf_counter()
    first = None
    for i in range(MESH_STEPS):
        rows = slice(i * batch, (i + 1) * batch)
        ff.fit([a[rows] for a in xs], y[rows], batch_size=batch, epochs=1, shuffle=False,
               verbose=False)
        if i == 0 and kind == "resnet":
            first = whole_weights(ff)
    par_sync(opts["device"])
    fit_s = time.perf_counter() - t0
    after = whole_weights(ff)
    if kind == "dlrm":
        names = [op.name for op in cm.ops if op.name in cm.params]
        start, after = ([{"rows": ws["weight"][np.unique(xs[int(n.split("_")[1])])]}
                         if n.startswith("emb_") else ws for n, ws in zip(names, tree)]
                        for tree in (start, after))
    rank = cm.mesh.rank if cm.mesh is not None else 0
    return dict(params=stash_weights(after) if rank == 0 else None,
                start=stash_weights(start) if rank == 0 else None,
                first=stash_weights(first) if rank == 0 and first is not None else None,
                fit_s=fit_s,
                mesh=dict(cm.mesh.shape) if cm.mesh is not None else None,
                specs={op.name: op.output_shapes[0].partition_spec() for op in cm.ops
                       if op.op_type.name in ("CONV2D", "BATCHNORM", "POOL2D", "EMBEDDING")})


def tp_generate_job(opts: dict, prompts: np.ndarray, weights: str) -> dict:
    """(h)'s dense Generator over {model: 2}, every rank in step: GPT at
    gpt_config() from the stashed weights, MESH_GEN_NEW greedy tokens."""
    from flexflow_tpu_torch import CompMode, FFConfig, FFModel
    from flexflow_tpu_torch.serving import Generator
    from flexflow_tpu_torch.serving.group import load_weights_by_order

    ff = FFModel(FFConfig(batch_size=len(prompts), computation_mode=CompMode.INFERENCE,
                          seed=SEED, device=opts["device"], mesh_shape={"model": 2}))
    mesh_gpt(ff, len(prompts))
    ff.compile()
    load_weights_by_order(ff, read_weights(weights))
    gen = Generator(ff, max_length=MESH_GEN_PROMPT + MESH_GEN_NEW)
    gen.generate(prompts[:, :8], 2)  # warm-up
    par_sync(opts["device"])
    t0 = time.perf_counter()
    out = gen.generate(prompts, MESH_GEN_NEW)
    par_sync(opts["device"])
    return dict(tokens=out, seconds=time.perf_counter() - t0,
                local_heads=sorted({gen.local_heads(op) for op in gen._attn_ops}))


def mesh_check(name: str, ranks: list, ref: dict, card: str, whole: bool = False) -> dict:
    """Hold a mesh run's params (by op order; running statistics among
    them) to the one-rank run's: each layer's largest error within
    PAR_F32_TOL of its largest update, past MESH_STEPS f32 ulps (the
    training phases' form); with ``whole`` the whole model's update error
    in 2-norm after the first step within MESH_RESNET_TOL, the error after
    MESH_STEPS steps reported beside, and each batch norm's running
    statistics after the first step by the layer rule within
    MESH_BN_STATS_TOL (after MESH_STEPS steps reported)."""
    got, want, start = (as_tensors(t) for t in (ranks[0]["params"], ref["params"],
                                                 ref["start"]))
    steps, after, stats = MESH_STEPS, None, None
    if not whole:
        err, worst = layer_err(got, want, start, ulps=MESH_STEPS)
        bound, what = PAR_F32_TOL, "of the layer's largest update"
    else:
        after = update_err(got, want, start)[0]
        first_got, first_want = as_tensors(ranks[0]["first"]), as_tensors(ref["first"])
        err, worst = update_err(first_got, first_want, start)
        bound, what, steps = MESH_RESNET_TOL, "of the model's update (2-norm)", 1
        stats = bn_stats_err(first_got, first_want, start, 1)
        check(stats[0] <= MESH_BN_STATS_TOL,
              f"{name}: running statistics after the first step {stats[0]:.3g} of the "
              f"layer's largest update from the one-rank run (worst {stats[1]}; bound "
              f"{MESH_BN_STATS_TOL:.3g})")
        stats += bn_stats_err(got, want, start, MESH_STEPS)
    check(err <= bound, f"{name}: params after {steps} step(s) {err:.3g} {what} from the "
                        f"one-rank run (worst {worst}; bound {bound:.3g})")
    row = dict(name=name, card=card, mesh=ranks[0]["mesh"], steps_held=steps,
               param_err_vs_one_rank=err, param_err_worst=worst, bound=bound,
               err_after_all_steps=after, fit_s=ranks[0]["fit_s"], one_rank_fit_s=ref["fit_s"],
               specs=ranks[0]["specs"])
    late = "" if after is None else f"; after {MESH_STEPS} steps {after:.3g} (reported)"
    if stats is not None:
        row.update(running_stats_err=stats[0], running_stats_worst=stats[1],
                   running_stats_bound=MESH_BN_STATS_TOL, running_stats_err_after=stats[2])
        late += (f"; running statistics after 1 step {stats[0]:.3g} of the layer's largest "
                 f"update (worst {stats[1]}; bound {MESH_BN_STATS_TOL:.3g}), after "
                 f"{MESH_STEPS} steps {stats[2]:.3g} (reported)")
    print(f"parallel_c {name}: {ranks[0]['mesh']}, params (running statistics among them) "
          f"after {steps} step(s) {err:.3g} {what} from the one-rank run (worst {worst}; "
          f"bound {bound:.3g}){late}; {MESH_STEPS} steps in {ranks[0]['fit_s']:.2f} s (one "
          f"rank {ref['fit_s']:.2f} s) [{card}]", flush=True)
    return row


def bn_stats_err(got: dict, want: dict, start: dict, steps: int) -> tuple:
    """:func:`layer_err` of the batch norms' running mean and variance
    alone (each batch norm one layer), past ``steps`` f32 ulps."""
    def stats(tree: dict) -> dict:
        return {op: {w: t for w, t in ws.items() if w.startswith("running_")}
                for op, ws in tree.items() if "running_mean" in ws}

    return layer_err(stats(got), stats(want), stats(start), ulps=steps)


def phase_parallel_c(card: str) -> dict:
    """(g) the launcher: kill, hang and shrink of a ZeRO-1 Transformer
    cohort; (h) serving over {model: 2}: the Transformer through a
    repository entry with strategies in both dtypes, GPT through a
    generator entry and the dense Generator; (i) DLRM at DLRMConfig() with
    its tables over {model: 2}; (j) ResNet-50 at 229 px over {data: 2} with
    global batch statistics, and its stem with a spatial strategy over
    {model: 2}; every run held to its one-device run. The ranks share this
    card over gloo."""
    from flexflow_tpu_torch.parallel.distributed import spawn

    t0 = time.perf_counter()
    tmp = pathlib.Path(".ffcache") / "smoke_mesh"
    tmp.mkdir(parents=True, exist_ok=True)
    launch_row = par_launch(card)
    print(f"phases: parallel_c (g) at {time.perf_counter() - t0:.1f} s", flush=True)
    free_device()
    row32, ref32 = serve_mesh_classic("float32", card, tmp)
    serving = [row32, serve_mesh_classic("bfloat16", card, tmp, ref32)[0]]
    gen_row, (prompts, gpt_weights, ref_tokens, margins, bounds) = \
        serve_mesh_generation(card, tmp)
    print(f"phases: parallel_c (h) served at {time.perf_counter() - t0:.1f} s", flush=True)
    opts = dict(device=DEVICE)
    refs = {k: mesh_fit(opts, k) for k in ("dlrm", "resnet", "stem")}
    free_device()
    print(f"phases: parallel_c one-rank runs at {time.perf_counter() - t0:.1f} s", flush=True)
    ranks = spawn(par_worker, 2, [
        ("mesh", opts, dict(kind="dlrm", mesh_shape={"model": 2})),
        ("mesh", opts, dict(kind="resnet", mesh_shape={"data": 2},
                            weights=refs["resnet"]["start"])),
        ("mesh", opts, dict(kind="stem", mesh_shape={"model": 2},
                            weights=refs["stem"]["start"])),
        ("tp_gen", opts, dict(prompts=prompts, weights=stash_weights(gpt_weights)))])
    print(f"phases: parallel_c 2 ranks at {time.perf_counter() - t0:.1f} s", flush=True)
    rows = [mesh_check("(i) DLRM DLRMConfig(), tables over {model: 2}",
                       [r[0] for r in ranks], refs["dlrm"], card),
            mesh_check(f"(j) ResNet-50 229 px, batch {MESH_RESNET_BATCH}, {{data: 2}}, global "
                       f"batch-norm statistics", [r[1] for r in ranks], refs["resnet"], card,
                       whole=True),
            mesh_check(f"(j) ResNet-50 stem at {STEM_PX} px, {{spatial: model}} over {{model: 2}}",
                       [r[2] for r in ranks], refs["stem"], card)]
    check(rows[2]["specs"]["stem_conv"][2] == "model" and rows[2]["specs"]["stem_pool"][2] == "model",
          f"(j) the stem's height is not sharded: {rows[2]['specs']}")
    check(all(s[0] == "data" for n, s in rows[1]["specs"].items()),
          f"(j) ResNet-50's batch is not sharded everywhere: {rows[1]['specs']}")
    for row in rows:
        row.pop("specs")
    tp = [r[3] for r in ranks]
    check(tp[0]["tokens"].shape == (MESH_GEN_PROMPTS, MESH_GEN_PROMPT + MESH_GEN_NEW)
          and all(np.array_equal(t["tokens"], tp[0]["tokens"]) for t in tp),
          "(h) the dense Generator's ranks disagree")
    parted, worst = first_divergences(list(tp[0]["tokens"]), ref_tokens, margins, bounds)
    check(tp[0]["local_heads"] == [gpt_config().num_heads // 2],
          f"(h) local heads {tp[0]['local_heads']}")
    dense = dict(tokens_per_s=MESH_GEN_PROMPTS * MESH_GEN_NEW / tp[0]["seconds"],
                 parted=parted, worst_margin_share=worst, local_heads=tp[0]["local_heads"])
    print(f"parallel_c (h) GPT {{model: 2}} dense Generator float32: {MESH_GEN_PROMPTS} x "
          f"{MESH_GEN_NEW} greedy tokens, {dense['tokens_per_s']:.1f} tokens/s, "
          f"{dense['local_heads'][0]} heads a rank; {parted} answers part from the one-device "
          f"Generator's (at margins up to {worst:.3g} of the bound) [{card}]", flush=True)
    shutil.rmtree(TREE_DIR, ignore_errors=True)
    shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(launch_row["launches"])
    launches["flash_attention_fwd"] += sum(r["launches"] for r in serving)
    out = dict(launch=launch_row, serving=serving, generation=gen_row, dense_generation=dense,
               training=rows, flash_launches=launches, seconds=time.perf_counter() - t0)
    print("parallel_c_json " + json.dumps(out), flush=True)
    return out


# ---- phase_search: the simulator and the Unity search (A8a) --------------
# (k): each calibration config's calibrated simulation against its measured
# step must fall within this factor either way (the JAX package's
# calibration gate: search/unity.py adoption_margin's shared-host 2x)
CALIB_RATIO = 2.0
CALIB_ITERS = 20
# (k): the all-reduce payloads the staging readings are fitted over
STAGING_SIZES = (1 << 20, 64 << 20)
# (m): the pinned search adopts its own best sharded plan unless data
# parallelism is predicted faster (search/unity.py adoption_margin)
PINNED_ADOPTION_MARGIN = 1.0
# (l), (m): fit steps after a search; the playoff's timed steps
SEARCH_STEPS, SEARCH_PLAYOFF_STEPS = 3, 3


def search_calibration(card: str) -> dict:
    """(k): calibrate() in f32 and bf16 (every point's calibrated
    simulation within CALIB_RATIO of its measured step), the gloo staging
    readings of ranks sharing this card (calibrate.STAGING_LAYOUTS), and
    ProfilingCostModel against OpCostModel on the bench Transformer's ops
    (the five largest gaps)."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer
    from flexflow_tpu_torch.sim import OpCostModel, ProfilingCostModel, detect_machine_model
    from flexflow_tpu_torch.sim.calibrate import calibrate, measure_staging_rate

    torch.backends.cuda.matmul.allow_tf32 = False
    fits = {}
    for dt in ("float32", "bfloat16"):
        r = calibrate(compute_dtype=None if dt == "float32" else dt, iters=CALIB_ITERS)
        chip = r.machine.chip
        points = [dict(config=n, measured_ms=real * 1e3, simulated_ms=sim * 1e3,
                       ratio=sim / real) for n, real, sim in r.points]
        fits[dt] = dict(chip=chip.name, scale=r.scale, step_overhead_s=r.step_overhead,
                        mxu_efficiency=chip.mxu_efficiency, hbm_efficiency=chip.hbm_efficiency,
                        points=points)
        print(f"search (k) calibrate {dt}: scale {r.scale:.4f}, step_overhead "
              f"{r.step_overhead * 1e3:.3f} ms, mxu_efficiency {chip.mxu_efficiency:.4f}, "
              f"hbm_efficiency {chip.hbm_efficiency:.4f} (chip {chip.name}); "
              + "; ".join(f"{p['config']}: measured {p['measured_ms']:.3f} ms, calibrated "
                          f"simulation {p['simulated_ms']:.3f} ms ({p['ratio']:.3f})"
                          for p in points) + f" [{card}]", flush=True)
        for p in points:
            check(1.0 / CALIB_RATIO <= p["ratio"] <= CALIB_RATIO,
                  f"(k) {dt} {p['config']}: calibrated simulation {p['simulated_ms']:.3f} ms "
                  f"vs measured {p['measured_ms']:.3f} ms, outside x{CALIB_RATIO}")
        free_device()
    staging = measure_staging_rate(STAGING_SIZES)
    for r in staging:
        print(f"search (k) staging: gloo all-reduce, {r['ranks']} ranks on this card in "
              f"groups of {r['degree']}, "
              + ", ".join(f"{b / 2 ** 20:.0f} MiB {t * 1e3:.2f} ms" for b, t in
                          r["points"].items())
              + f": rate {r['rate'] / 1e9:.4f} GB/s of payload, latency "
              f"{r['latency'] * 1e3:.3f} ms [{card}]", flush=True)
        check(r["rate"] > 0 and np.isfinite(r["rate"]), f"(k) staging reading {r}")
    # the bench Transformer's ops, each forward measured and analytic
    ff = FFModel(FFConfig(batch_size=BATCH, seed=SEED, device=DEVICE))
    build_transformer(ff, BATCH, TransformerConfig())
    ff.compile(SGDOptimizer(lr=0.01), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    machine = detect_machine_model(1, device=DEVICE)
    analytic, profiled = OpCostModel(machine), ProfilingCostModel(machine, device=DEVICE)
    ops = []
    for op in ff.compiled.ops:
        a, m = analytic.measure(op).forward_time, profiled.measure(op).forward_time
        ops.append(dict(op=op.name, type=op.op_type.name, analytic_ms=a * 1e3,
                        profiled_ms=m * 1e3, ratio=a / m if m > 0 else None))
    check(not profiled.fallbacks, f"(k) ops the profiler could not time: {profiled.fallbacks}")
    gaps = sorted((o for o in ops if o["ratio"]), key=lambda o: -abs(np.log(o["ratio"])))[:5]
    total_a = sum(o["analytic_ms"] for o in ops)
    total_m = sum(o["profiled_ms"] for o in ops)
    print(f"search (k) ProfilingCostModel vs OpCostModel ({machine.chip.name}) on "
          f"TransformerConfig() batch {BATCH} f32, {len(ops)} ops: forward sums analytic "
          f"{total_a:.3f} ms, profiled {total_m:.3f} ms; five largest gaps "
          + "; ".join(f"{o['op']} ({o['type']}) analytic {o['analytic_ms']:.4f} vs profiled "
                      f"{o['profiled_ms']:.4f} ms" for o in gaps) + f" [{card}]", flush=True)
    del ff
    free_device()
    return dict(fits=fits, staging=staging, ops=ops, gaps=gaps, forward_analytic_ms=total_a,
                forward_profiled_ms=total_m, card=card)


def search_one_rank(compute_dtype: str, card: str, tmp: pathlib.Path) -> dict:
    """(l): TransformerConfig() at batch 8 on one rank compiled with a
    search through the strategy cache in ``tmp``: the plan and its
    estimate beside the measured step; SEARCH_STEPS fit steps with params
    bitwise equal to a compile without a search; a recompile hitting the
    cache with no cost-model query and the same plan."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer, kernels
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer
    from flexflow_tpu_torch.sim import cost_model
    from flexflow_tpu_torch.sim.calibrate import measure_step_time

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig()

    def build(search: bool):
        extra = dict(search_budget=1, search_cache="on", search_cache_dir=str(tmp)) \
            if search else {}
        ff = FFModel(FFConfig(batch_size=BATCH, compute_dtype=compute_dtype, seed=SEED,
                              device=DEVICE, **extra))
        build_transformer(ff, BATCH, cfg)
        ff.compile(SGDOptimizer(lr=0.01), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        return ff

    rng = np.random.default_rng(SEED + 18)
    x = rng.standard_normal((BATCH * SEARCH_STEPS, cfg.sequence_length, cfg.hidden_size),
                            dtype=np.float32)
    y = rng.standard_normal((BATCH * SEARCH_STEPS, cfg.sequence_length, 1), dtype=np.float32)
    ff = build(True)
    prof = dict(ff.search_profile)
    check(prof["cache"] == "miss", f"(l) {compute_dtype}: first compile's cache {prof['cache']}")
    plan = {k: v for k, v in ff._strategies.items() if v}
    kernels.reset_launch_counts()
    ff.fit(x, y, batch_size=BATCH, epochs=1, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    searched = ff.numpy_params()
    measured = measure_step_time(ff, iters=CALIB_ITERS)
    del ff
    free_device()
    ff = build(False)
    ff.fit(x, y, batch_size=BATCH, epochs=1, shuffle=False, verbose=False)
    plain = ff.numpy_params()
    del ff
    free_device()
    same = all(np.array_equal(searched[o][w], plain[o][w]) for o in plain for w in plain[o])
    check(same, f"(l) {compute_dtype}: params after {SEARCH_STEPS} steps differ from a compile "
                f"without search")
    calls = cost_model.MEASURE_CALLS
    ff = build(True)
    hit = dict(ff.search_profile)
    hit_plan = {k: v for k, v in ff._strategies.items() if v}
    queries = cost_model.MEASURE_CALLS - calls
    del ff
    free_device()
    check(hit["cache"] == "hit" and queries == 0 and hit_plan == plan
          and hit["mesh_shape"] == prof["mesh_shape"],
          f"(l) {compute_dtype}: recompile cache {hit['cache']}, {queries} cost-model queries, "
          f"plan {hit_plan} vs {plan}")
    for k in FLASH_NAMES:
        check(launches[k] > 0 or DEVICE != "cuda",
              f"(l) {compute_dtype}: {k} never launched: {launches}")
    row = dict(compute_dtype=compute_dtype, mesh=prof["mesh_shape"], plan=plan,
               est_step_ms=prof["est_step_time"] * 1e3, measured_step_ms=measured * 1e3,
               search_s=prof["search_time_s"], states=prof["states_explored"],
               hit_search_s=hit["search_time_s"], hit_queries=queries,
               launches={k: launches[k] for k in FLASH_NAMES}, card=card)
    print(f"search (l) TransformerConfig() batch {BATCH} {compute_dtype}, one rank: mesh "
          f"{row['mesh']}, plan {plan or 'plain'}, est_step_time {row['est_step_ms']:.3f} ms "
          f"beside the measured step {row['measured_step_ms']:.3f} ms; search "
          f"{row['search_s']:.3f} s ({row['states']} states); params after {SEARCH_STEPS} fit "
          f"steps bitwise equal to a compile without search; recompile: cache hit, {queries} "
          f"cost-model queries, {row['hit_search_s']:.4f} s; flash launches {row['launches']} "
          f"[{card}]", flush=True)
    return row


def search_mesh_check(name: str, ranks: list, ref: dict, start: dict, card: str,
                      pipe: bool = False) -> dict:
    """(m): one searched run held to phase_parallel's one-rank run (the
    f32 bound of (14), or (f)'s through pipe_check), with its plan."""
    row = (pipe_check if pipe else par_check)(name, ranks, ref, start, card)
    r0 = ranks[0]
    row.update(search=r0["search"], playoff=r0["playoff"], strategies=r0["strategies"],
               schedule_records=r0["schedule_records"])
    return row


def phase_search(card: str, par: dict) -> dict:
    """(k) calibration; (l) the search on one rank, f32 and bf16; (m) the
    Transformer at PAR_LAYERS layers on 4 ranks: a search pinned to
    {data: 2, model: 2}, an unpinned search over the 4 ranks with a
    SEARCH_PLAYOFF_STEPS-step playoff, and {pipe: 2} with schedule="auto"
    on 2 ranks, each held to phase_parallel's one-rank f32 run. The ranks
    share this card over gloo."""
    from flexflow_tpu_torch import native_bridge
    from flexflow_tpu_torch.parallel.distributed import spawn

    t0 = time.perf_counter()
    lib, seconds = native_bridge.build_sim(), time.perf_counter() - t0
    print(f"search: the native simulator {lib.name} built from the checkout in "
          f"{seconds:.1f} s", flush=True)
    calib = search_calibration(card)
    print(f"phases: search (k) at {time.perf_counter() - t0:.1f} s", flush=True)
    tmp = pathlib.Path(".ffcache") / "smoke_search"
    shutil.rmtree(tmp, ignore_errors=True)
    one = [search_one_rank(dt, card, tmp / dt) for dt in ("float32", "bfloat16")]
    print(f"phases: search (l) at {time.perf_counter() - t0:.1f} s", flush=True)
    full = par_opts(PAR_LAYERS)
    searched = dict(search_budget=1, profiling=True)
    four = spawn(par_worker, 4, [
        ("fit", full, dict(compute_dtype="float32", mesh_shape={"data": 2, "model": 2},
                           config=dict(searched,
                                       search_adoption_margin=PINNED_ADOPTION_MARGIN))),
        ("fit", full, dict(compute_dtype="float32",
                           config=dict(searched, playoff_steps=SEARCH_PLAYOFF_STEPS)))])
    two = spawn(par_worker, 2, [
        ("fit", full, dict(compute_dtype="float32", mesh_shape={"pipe": 2},
                           config=dict(pipeline_schedule="auto", profiling=True)))])
    print(f"phases: search (m) ranks at {time.perf_counter() - t0:.1f} s", flush=True)
    ref, start = par["refs"]["float32"], par["refs"]["float32"]["start"]
    pinned = search_mesh_check("(m) searched, pinned {data: 2, model: 2} float32",
                               [r[0] for r in four], ref, start, card)
    p = pinned["search"]
    check(p["mesh_shape"] == {"data": 2, "model": 2} and p["cache"] == "off",
          f"(m) pinned search {p}")
    check(bool(pinned["strategies"]), f"(m) the pinned search kept the plain plan: {p}")
    unpinned_ranks = [r[1] for r in four]
    u = unpinned_ranks[0]
    upipe = (u["mesh"] or {}).get("pipe", 1) > 1
    unpinned = search_mesh_check("(m) searched over 4 ranks, playoff float32", unpinned_ranks,
                                 ref, start, card, pipe=upipe and u.get("engine") is not None)
    po = unpinned["playoff"]
    check(po is not None and "kept" in po,
          f"(m) the unpinned search's playoff did not run: {po}, plan "
          f"{unpinned['search']['mesh_shape']} {unpinned['strategies']}")
    check((po["kept"] == "dp") == (po["dp_ms"] < po["searched_ms"]),
          f"(m) the playoff kept the slower plan: {po}")
    check(all(r["playoff"] == po for r in unpinned_ranks), "(m) the ranks' playoffs disagree")
    auto = search_mesh_check("(m) {pipe: 2} schedule auto float32", [r[0] for r in two], ref,
                             start, card, pipe=True)
    check(auto["schedule"] in ("gpipe", "1f1b", "interleaved") and auto["schedule_records"],
          f"(m) auto schedule {auto['schedule']}, records {auto['schedule_records']}")
    auto_est = next(r["est_step_time"] for r in auto["schedule_records"]
                    if r["schedule"] == auto["schedule"])
    # each searched plan's estimate beside its measured step
    ests = [("pinned", p["est_step_time"] * 1e3, pinned["step_ms_median"]),
            ("unpinned (its playoff time)", unpinned["search"]["est_step_time"] * 1e3,
             po["searched_ms"]),
            ("{pipe: 2} auto", auto_est * 1e3, auto["step_ms_median"])]
    for what, est, measured in ests:
        check(1.0 / CALIB_RATIO <= est / measured <= CALIB_RATIO,
              f"(m) {what}: est {est:.3f} ms vs measured {measured:.3f} ms, outside "
              f"x{CALIB_RATIO}")
    print(f"search (m) pinned {{data: 2, model: 2}}: plan {pinned['strategies'] or 'plain'}, "
          f"est {p['est_step_time'] * 1e3:.3f} ms vs measured "
          f"{pinned['step_ms_median']:.1f} ms; unpinned: mesh "
          f"{unpinned['search']['mesh_shape']}, plan {unpinned['strategies'] or 'plain'}, "
          f"schedule {unpinned['search'].get('pipe_schedule')}, est "
          f"{unpinned['search']['est_step_time'] * 1e3:.3f} ms; playoff searched "
          f"{po['searched_ms']:.1f} ms/step vs dp {po['dp_ms']:.1f} ms/step -> {po['kept']}; "
          f"{{pipe: 2}} auto -> {auto['schedule']} on the {auto['engine']} engine ("
          + ", ".join(f"{r['schedule']} {r['est_step_time'] * 1e3:.3f} ms"
                      for r in auto["schedule_records"]) + f"), measured "
          f"{auto['step_ms_median']:.1f} ms; est/measured "
          + ", ".join(f"{what} {est / measured:.3f}" for what, est, measured in ests)
          + f" (bound x{CALIB_RATIO}) [{card}]", flush=True)
    rows = [pinned, unpinned, auto]
    launches = {k: sum(r["launches"][k] for r in one)
                + sum(lr[k] for row in rows for lr in row["launches_per_rank"])
                for k in FLASH_NAMES}
    shutil.rmtree(TREE_DIR, ignore_errors=True)
    shutil.rmtree(tmp, ignore_errors=True)
    check(native_bridge.SIM_CALLS["sim_taskgraph"] > 0,
          "the native task-graph replay never ran: the simulator fell back")
    out = dict(calibration=calib, one_rank=one, mesh=rows, flash_launches=launches,
               est_vs_measured_ms=[dict(run=w, est=e, measured=m) for w, e, m in ests],
               native_sim_calls=dict(native_bridge.SIM_CALLS),
               seconds=time.perf_counter() - t0)
    print("search_json " + json.dumps(out, default=str), flush=True)
    return out


OBS_DIR = pathlib.Path(".ffcache") / "smoke_obs"
OBS_SAMPLES = 32  # (n)'s epoch: 4 steps of batch 8
OBS_EPOCHS = 2
# (o): adjacent baseline/candidate fit pairs the verdict is the median of
OBS_PAIRS = 2
# (p): GPT requests through register_generator
OBS_REQUESTS = 32
OBS_PROMPT, OBS_NEW = (16, 256), (16, 64)
# (q): the stall the train.stall site injects past the armed watchdog's
# threshold, and the cohort's hang threshold and watchdog threshold
OBS_STALL_S, OBS_WATCHDOG_S = 4.0, 2.0
# the cohort runs 3 epochs of 2 steps; rank 1 stalls at step 4, the second
# of its epoch, where the loop's watched section is open (it opens at an
# epoch's second step)
OBS_HANG_S, OBS_COHORT_WATCHDOG_S, OBS_HANG_STEP, OBS_COHORT_EPOCHS = 8.0, 3.0, 4, 3
OBS_COHORT_JOB = "chip_smoke:launch_job"  # (g)'s Transformer at PAR_LAYERS layers
# (r): the rewritten graph trains OBS_RULE_STEPS steps within this share
# of each param's largest |value| of the unrewritten one (f32, summed in
# another order where the merged GEMM replaces two)
OBS_RULE_STEPS, OBS_RULE_TOL = 3, 1e-4
OBS_ATTR_TOL = 0.02  # the attribution table's reconciliation (JAX's DEFAULT_TOLERANCE)


def obs_rules() -> dict:
    """The rule file of (r), in the reference's schema
    (substitution_loader.h:168): a Linear+ReLU fusion and a merge of two
    parallel Linears on one input into a feature concat."""
    def op(kind, inputs, **para):
        return {"type": kind, "input": [{"opId": o, "tsId": t} for o, t in inputs],
                "para": [{"key": k, "value": v} for k, v in para.items()]}

    return {"rule": [
        {"name": "linear_relu_fusion",
         "srcOp": [op("OP_LINEAR", [(-1, 0), (-4, 0)], PM_ACTI=0), op("OP_RELU", [(0, 0)])],
         "dstOp": [op("OP_LINEAR", [(-1, 0), (-4, 0)], PM_ACTI=2)],
         "mappedOutput": [{"srcOpId": 1, "srcTsId": 0, "dstOpId": 0, "dstTsId": 0}]},
        {"name": "parallel_linear_merge",
         "srcOp": [op("OP_LINEAR", [(-1, 0), (-2, 0)], PM_ACTI=0),
                   op("OP_LINEAR", [(-1, 0), (-3, 0)], PM_ACTI=0),
                   op("OP_CONCAT", [(0, 0), (1, 0)], PM_AXIS=2, PM_NUMDIM=3)],
         "dstOp": [op("OP_CONCAT", [(-2, 0), (-3, 0)], PM_AXIS=1, PM_NUMDIM=2),
                   op("OP_LINEAR", [(-1, 0), (0, 0)], PM_ACTI=0)],
         "mappedOutput": [{"srcOpId": 2, "srcTsId": 0, "dstOpId": 1, "dstTsId": 0}]}]}


def obs_get(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read()


def obs_transformer(compute_dtype: str, layers: int = 0, **cfg):
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer

    tc = TransformerConfig()
    if layers:
        tc = TransformerConfig(num_layers=layers)
    ff = FFModel(FFConfig(batch_size=BATCH, compute_dtype=compute_dtype, seed=SEED,
                          device=DEVICE, ledger_dir=str(OBS_DIR / "ledger"), **cfg))
    build_transformer(ff, BATCH, tc)
    ff.compile(SGDOptimizer(lr=0.01), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    return ff, tc


def obs_data(tc, n: int = OBS_SAMPLES):
    rng = np.random.default_rng(SEED + 19)
    x = rng.standard_normal((n, tc.sequence_length, tc.hidden_size), dtype=np.float32)
    y = rng.standard_normal((n, tc.sequence_length, 1), dtype=np.float32)
    return x, y


def obs_fit(compute_dtype: str, card: str) -> dict:
    """(n): TransformerConfig() at batch 8, OBS_EPOCHS epochs with every
    observability knob on; the records, the phase table, the telemetry,
    the corpus, the server and the launches checked."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.obs import costcorpus, ledger
    from flexflow_tpu_torch.obs.attribution import PHASES, format_phase_table
    from flexflow_tpu_torch.obs.server import obs_server
    from flexflow_tpu_torch.obs.trace import configure_tracer, tracer

    what = f"obs (n) {compute_dtype}"
    ff, tc = obs_transformer(compute_dtype, trace="on", divergence="on", exec_telemetry="on",
                             cost_corpus="on",
                             # a corpus a dtype: a row's features are the ops' f32
                             # shapes, so the two dtypes' rows share their keys
                             cost_corpus_dir=str(OBS_DIR / f"corpus_{compute_dtype}"),
                             watchdog="on", obs_server_port=0,
                             watchdog_dir=str(OBS_DIR / "blackbox"))
    x, y = obs_data(tc)
    tracer().clear()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ff.fit(x, y, epochs=OBS_EPOCHS, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    configure_tracer(enabled=False)
    for k in FLASH_NAMES:
        check(launches[k] > 0, f"{what}: {k} never launched: {launches}")
    fp = ff.fit_profile
    n_ops = len(ff.compiled.ops)
    # the ledger: this compile's and this fit's records, the card's fingerprint
    runs = ledger.load_runs(str(OBS_DIR / "ledger"))
    comp = [r for r in runs if r["kind"] == "compile"][-1]
    fit = [r for r in runs if r["kind"] == "fit"][-1]
    m = fit["machine"]
    check(m["backend"] == "cuda" and "H100" in m.get("device_name", "")
          and m.get("capability") == "9.0" and m.get("power_limit")
          and m.get("torch") == torch.__version__,
          f"{what}: the fit record's fingerprint {m}")
    check(comp["model_sig"] == fit["model_sig"] and comp["n_ops"] == n_ops
          and comp["knobs"]["compute_dtype"] == compute_dtype,
          f"{what}: compile record {comp.get('model_sig')} {comp.get('n_ops')}")
    # attribution: the phases sum to the measured step
    att = fp["attribution"]
    rc = att["reconciliation"]
    check(rc["reconciles"] and rc["error"] <= OBS_ATTR_TOL and fit["attribution"] == att,
          f"{what}: attribution does not reconcile: {rc}")
    shares = {p: att["phases"][p]["fraction"] for p in PHASES}
    bases = {p: att["phases"][p]["basis"] for p in PHASES}
    check(bases["host_dispatch"] == "measured", f"{what}: host dispatch {bases}")
    # executable telemetry: flops, the peak and the OBS002 verdict
    tel = ff.exec_telemetry
    prog = tel["programs"]["grad_step"]
    rec_rows = tel.get("reconciliation") or []
    check(prog.get("flops", 0) > 0 and (prog.get("peak_bytes") or 0) > 0 and len(rec_rows) == 1
          and "static_peak_bytes" in rec_rows[0],
          f"{what}: exec telemetry {tel}")
    obs002 = "finding" in rec_rows[0]
    # the corpus: a row for every op, forward and backward
    # the corpus: a row for every op, forward and backward (ops of the same
    # features, the layers' twins, share one key)
    corpus = fp["cost_corpus"]
    check(corpus["appended"] + corpus["duplicates"] == n_ops and corpus["appended"] > 0,
          f"{what}: corpus {corpus} for {n_ops} ops")
    # one more pass, counted: its attention rows run the flash kernels
    kernels.reset_launch_counts()
    rows = costcorpus.build_rows(ff, iters=1)
    torch.cuda.synchronize()
    corpus_launches = kernels.launch_counts()
    check(len(rows) == n_ops and all(r["measured"]["backward_ms"] is not None for r in rows),
          f"{what}: corpus rows {len(rows)} for {n_ops} ops, no backward for "
          f"{[r['name'] for r in rows if r['measured']['backward_ms'] is None]}")
    check(all(corpus_launches[k] > 0 for k in FLASH_NAMES),
          f"{what}: the corpus pass launched {corpus_launches}")
    # divergence: per-op rows, forward and backward
    div = fp["divergence"]
    check(len(div["per_op"]) == n_ops and div["e2e_ratio"] > 0, f"{what}: divergence {div}")
    # the server
    port = obs_server().port
    got = {}
    for path in ("/metrics", "/healthz", "/runs", "/attribution", "/advice"):
        status, body = obs_get(port, path)
        check(status == 200, f"{what}: GET {path} -> {status}")
        got[path] = body
    check(b"flexflow_fit_steps" in got["/metrics"], f"{what}: /metrics lacks fit.steps")
    health = json.loads(got["/healthz"])
    check(health["watchdog"]["enabled"] and health["watchdog"]["dumps"] == 0,
          f"{what}: /healthz {health}")
    check(json.loads(got["/runs"])["runs"][-1]["run_id"] == fit["run_id"],
          f"{what}: /runs does not end with this fit's record")
    check(json.loads(got["/attribution"])["measured_step_s"] == att["measured_step_s"],
          f"{what}: /attribution is not this fit's table")
    advice = fp["advice"]
    check(json.loads(got["/advice"])["suggestions"] == advice["suggestions"],
          f"{what}: /advice is not this fit's report")
    top = advice["suggestions"][0]
    peak = prog["peak_bytes"]
    # the host's time to dispatch one train_step with the card idle before
    # it (median of 5): what the span's host dispatch reads when nothing
    # holds the host back
    cm = ff.compiled
    xb = torch.as_tensor(x[:BATCH], device=cm.device)
    yb = torch.as_tensor(y[:BATCH], device=cm.device)
    idle = []
    for i in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cm.params, cm.opt_state, _, _ = cm.train_step(cm.params, cm.opt_state, i, xb, yb)
        idle.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
    idle_ms = float(np.median(idle))
    row = dict(compute_dtype=compute_dtype, card=card, n_ops=n_ops, fit_s=fit_s,
               idle_dispatch_ms=idle_ms,
               steps=[e["steps"] for e in fp["epochs"]],
               step_ms=att["measured_step_s"] * 1e3, phase_shares=shares, phase_basis=bases,
               dominant=att["dominant_phase"], reconciliation_error=rc["error"],
               predicted_ms={k: v * 1e3 for k, v in att["predicted_step_s"].items()},
               e2e_ratio=div["e2e_ratio"], predicted_step_ms=div["predicted_step_s"] * 1e3,
               flops=prog["flops"], peak_bytes=peak,
               static_peak_bytes=rec_rows[0]["static_peak_bytes"],
               obs002=obs002, peak_ratio=rec_rows[0]["ratio"],
               corpus_appended=corpus["appended"], corpus_launches=corpus_launches,
               top=dict(phase=top["phase"], knob=top["knob"], proposed=top["proposed"],
                        expected_frac=top["expected"]["step_delta_frac"],
                        basis=top["expected"]["basis"]),
               suggestions=[s["id"] for s in advice["suggestions"]],
               fingerprint=m, launches=launches, top_ops=[r["name"] for r in att["top_ops"]])
    print(format_phase_table(att), flush=True)
    print(f"{what}: TransformerConfig() batch {BATCH}, {OBS_EPOCHS} epochs of "
          f"{OBS_SAMPLES // BATCH} steps with trace, divergence, exec telemetry, corpus, "
          f"watchdog and server on, {fit_s:.1f} s: step {row['step_ms']:.3f} ms, phases "
          + ", ".join(f"{p} {shares[p] * 100:.1f}% ({bases[p]})" for p in PHASES)
          + f", reconciliation error {rc['error']:.2e} (tol {OBS_ATTR_TOL}); one train_step "
          f"dispatched onto an idle card {idle_ms:.3f} ms of host time (median of 5); simulator "
          f"{row['predicted_step_ms']:.3f} ms, e2e ratio {div['e2e_ratio']}; one grad step "
          f"{prog['flops'] / 1e12:.3f} TFLOP counted, peak {peak / 2 ** 30:.2f} GiB vs static "
          f"{rec_rows[0]['static_peak_bytes'] / 2 ** 30:.2f} GiB (ratio {rec_rows[0]['ratio']}, "
          f"OBS002 {'fired' if obs002 else 'clean'}); corpus {corpus['appended']} rows appended "
          f"({n_ops} ops, forward and backward; a corpus pass launched {corpus_launches}); "
          f"top suggestion {top['phase']} -> {top['knob']}={top['proposed']} (expected "
          f"-{top['expected']['step_delta_frac'] * 100:.1f}%, {top['expected']['basis']}); "
          f"fingerprint {m.get('device_name')} cap {m.get('capability')} power "
          f"{m.get('power_limit')}; launches {launches} [{card}]", flush=True)
    return dict(row=row, ff=ff, tc=tc, x=x, y=y, top=top, attribution=att,
                steps_per_s=fp["steps_per_s"])


def obs_applicable(advice: dict):
    """The first suggestion a one-card run can apply: every knob an
    FFConfig field, no mesh or process-count change."""
    from flexflow_tpu_torch import FFConfig

    fields = {f.name for f in dataclasses.fields(FFConfig)}
    for s in advice["suggestions"]:
        if all(k in fields and k not in ("mesh_shape",) for k in s["knobs"]):
            return s
    return None


def obs_experiment(base: dict, card: str) -> dict:
    """(o): the bf16 (n) run's top applicable suggestion applied, OBS_PAIRS
    adjacent (baseline, candidate) fits of OBS_EPOCHS epochs each, judged
    by judge_experiment on the targeted phase, whatever it finds."""
    from flexflow_tpu_torch.obs.advisor import judge_experiment

    sug = obs_applicable(base["ff"].fit_profile["advice"])
    check(sug is not None, f"obs (o): no applicable suggestion in "
          f"{[s['id'] for s in base['ff'].fit_profile['advice']['suggestions']]}")
    phase = sug["expected"]["phase"]
    cand, _ = obs_transformer("bfloat16", **sug["knobs"])
    x, y = base["x"], base["y"]

    def side(ff):
        ff.fit(x, y, epochs=OBS_EPOCHS, shuffle=False, verbose=False)
        torch.cuda.synchronize()
        att = ff.fit_profile["attribution"]
        return {"phases": {phase: att["phases"][phase]["seconds"]},
                "steps_per_s": ff.fit_profile["steps_per_s"],
                "step_ms": att["measured_step_s"] * 1e3}

    pairs = []
    for _ in range(OBS_PAIRS):
        b = side(base["ff"])
        c = side(cand)
        pairs.append({"baseline": b, "candidate": c})
    verdict = judge_experiment(sug, pairs)
    row = dict(card=card, suggestion=sug["id"], knobs=sug["knobs"], phase=phase,
               predicted_frac=sug["expected"]["step_delta_frac"], verdict=verdict["verdict"],
               phase_ratio=verdict["phase_ratio"], metric_ratio=verdict["metric_ratio"],
               baseline_step_ms=[p["baseline"]["step_ms"] for p in pairs],
               candidate_step_ms=[p["candidate"]["step_ms"] for p in pairs],
               baseline_phase_ms=[p["baseline"]["phases"][phase] * 1e3 for p in pairs],
               candidate_phase_ms=[p["candidate"]["phases"][phase] * 1e3 for p in pairs])
    print(f"obs (o) bfloat16: {sug['id']} applied ({phase}, predicted "
          f"-{row['predicted_frac'] * 100:.1f}%): {OBS_PAIRS} adjacent pairs of "
          f"{OBS_EPOCHS}-epoch fits, step ms baseline {row['baseline_step_ms']} vs candidate "
          f"{row['candidate_step_ms']}, {phase} ms {row['baseline_phase_ms']} vs "
          f"{row['candidate_phase_ms']}: phase ratio {verdict['phase_ratio']}, steps/s ratio "
          f"{verdict['metric_ratio']} -> {verdict['verdict']} [{card}]", flush=True)
    del cand
    return row


def obs_serving(card: str) -> dict:
    """(p): GPT at GPTConfig() through register_generator, OBS_REQUESTS
    greedy requests: the serving attribution and advice published, one
    serving ledger record, each answer held to one full causal forward
    (K1's launches)."""
    from flexflow_tpu_torch import kernels, load_numpy_params
    from flexflow_tpu_torch.obs import ledger
    from flexflow_tpu_torch.obs.server import latest_advice, latest_attribution

    what = "obs (p) GPT serving float32"
    ff, n_attn = gpt_model("float32", training=False)
    load_numpy_params(ff, gpt_params(ff, SEED + 8))
    rng = np.random.default_rng(SEED + 20)
    lens = rng.integers(OBS_PROMPT[0], OBS_PROMPT[1] + 1, size=OBS_REQUESTS)
    news = rng.integers(OBS_NEW[0], OBS_NEW[1] + 1, size=OBS_REQUESTS)
    traffic = [(rng.integers(0, gpt_config().vocab_size, size=int(n), dtype=np.int32), int(k))
               for n, k in zip(lens, news)]
    before = len(ledger.load_runs(str(OBS_DIR / "ledger"), kind="serving"))
    served = serve_paged(ff, traffic)
    recs = ledger.load_runs(str(OBS_DIR / "ledger"), kind="serving")
    check(len(recs) == before + 1 and recs[-1]["serving_engine"] == "continuous"
          and recs[-1]["completed"] == OBS_REQUESTS and recs[-1]["model"] == "lm",
          f"{what}: serving records {len(recs)} (before {before}): {recs[-1:]}")
    attr = latest_attribution("serving")
    check(attr is not None and attr["kind"] == "serving" and attr["model"] == "lm"
          and attr["completed"] == OBS_REQUESTS,
          f"{what}: /attribution?kind=serving {attr}")
    adv = latest_advice()
    check(adv is not None and adv["kind"] == "serving" and adv["suggestions"],
          f"{what}: /advice {adv}")
    kernels.reset_launch_counts()
    margins = full_forward_margins(ff.compiled, traffic, served["outs"])
    torch.cuda.synchronize()
    fwd_launches = kernels.launch_counts()
    check_flash_launches(fwd_launches, n_attn * len(traffic), 0, f"{what}: the full forwards")
    tol = GEN_TOL["float32"]
    decided_n = 0
    for i, ((prompt, _), out) in enumerate(zip(traffic, served["outs"])):
        argmax, margin, scale = margins[i]
        decided = margin > tol * scale
        check(bool((out[prompt.size:] == argmax)[decided].all()),
              f"{what}: request {i}'s greedy tokens differ from the full forward's argmax")
        decided_n += int(decided.sum())
    phases = {k: v["mean"] * 1e3 for k, v in attr["phases"].items()}
    top = adv["suggestions"][0]
    row = dict(card=card, requests=OBS_REQUESTS, tokens_per_s=served["tokens_per_s"],
               phases_mean_ms=phases, dominant=attr["dominant_phase"],
               top=dict(phase=top["phase"], knob=top["knob"], proposed=top["proposed"],
                        expected_frac=top["expected"]["step_delta_frac"]),
               ledger_record=recs[-1]["run_id"], launches=fwd_launches,
               greedy_checked=decided_n)
    print(f"{what}: {OBS_REQUESTS} requests (prompts {OBS_PROMPT[0]}-{OBS_PROMPT[1]}, "
          f"{OBS_NEW[0]}-{OBS_NEW[1]} new), {served['tokens_per_s']:.1f} tokens/s; serving "
          f"attribution published: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in phases.items())
          + f" (dominant {attr['dominant_phase']}); advice {top['phase']} -> {top['knob']}="
          f"{top['proposed']}; one serving ledger record; full forwards launched "
          f"{fwd_launches['flash_attention_fwd']} K1, greedy tokens equal their argmax at "
          f"{decided_n} decided positions [{card}]", flush=True)
    return row


def obs_stall(card: str) -> dict:
    """(q) the train.stall site past an armed watchdog (a 2-layer
    Transformer at full width), then a supervised 2-rank cohort with
    cohort_obs and one hung rank: the black-box dumps, the merged ledger,
    the cohort report."""
    from flexflow_tpu_torch.obs.trace import configure_tracer
    from flexflow_tpu_torch.obs.watchdog import watchdog
    from flexflow_tpu_torch.parallel import launch
    from flexflow_tpu_torch.obs import ledger

    bb = OBS_DIR / "stall_blackbox"
    plan = {"schema": 1, "sites": {"train.stall": {"at_step": 2, "stall_s": OBS_STALL_S}}}
    ff, tc = obs_transformer("float32", layers=2, trace="on", watchdog="on",
                             watchdog_threshold_s=OBS_WATCHDOG_S, watchdog_dir=str(bb),
                             fault_plan=plan)
    x, y = obs_data(tc, 2 * BATCH * 2)
    ff.fit(x, y, epochs=1, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    configure_tracer(enabled=False)
    from flexflow_tpu_torch.runtime.faults import configure_faults

    configure_faults(None)
    watchdog().disarm()
    boxes = sorted(p for p in bb.iterdir() if p.name.startswith("blackbox-"))
    check(len(boxes) == 1, f"obs (q): {len(boxes)} black boxes after the stall")
    doc = json.loads(boxes[0].read_text())
    main_stack = next(v for k, v in doc["threads"].items() if k.startswith("MainThread"))
    check(doc["reason"] == "stall" and doc["stalled"].get("fit.loop", 0) >= OBS_WATCHDOG_S
          and any("sleep" in ln for ln in main_stack)
          and any(e["name"] == "fit.step" for e in doc["trace_tail"]),
          f"obs (q): the dump {doc['reason']} {doc['stalled']}")
    stall_row = dict(stalled_s=doc["stalled"]["fit.loop"], threads=len(doc["threads"]),
                     trace_tail=len(doc["trace_tail"]), dump=boxes[0].name)
    del ff
    free_device()
    run_dir = OBS_DIR / "cohort"
    hang = {"schema": 1, "seed": 0, "sites": {"multihost.slow_peer": {
        "at_step": OBS_HANG_STEP, "stall_s": 600.0}}}
    t0 = time.perf_counter()
    rep = launch.supervise(nproc=2, run_dir=str(run_dir), job=OBS_COHORT_JOB,
                           epochs=OBS_COHORT_EPOCHS, interval=LAUNCH_INTERVAL, device=DEVICE,
                           cohort_timeout_s=600.0, fault_plan=hang, fault_rank=1,
                           hang_threshold_s=OBS_HANG_S, max_relaunches=1,
                           watchdog_threshold_s=OBS_COHORT_WATCHDOG_S, cohort_obs=True)
    seconds = time.perf_counter() - t0
    check(rep["ok"], f"obs (q) cohort: {rep.get('error')} {rep['events']}")
    ev = rep["events"][0] if rep["events"] else {}
    check(ev.get("outcome") == "hung" and ev.get("blackbox_dumps"),
          f"obs (q) cohort: first event {ev.get('outcome')}, dumps {ev.get('blackbox_dumps')}")
    # the stalled rank dumps; its peer, blocked in the step's collective,
    # may dump too
    dumps = {r: sorted((run_dir / f"blackbox-r{r}").glob("blackbox-*.json")) for r in (0, 1)}
    check(bool(dumps[1]), f"obs (q) cohort: the hung rank left no black box: {dumps}")
    hdoc = json.loads(dumps[1][0].read_text())
    check(hdoc["reason"] == "stall" and "fit.loop" in hdoc["stalled"] and hdoc["threads"]
          and hdoc["trace_tail"]
          and any("sleep" in ln for v in hdoc["threads"].values() for ln in v),
          f"obs (q) cohort: the hung rank's dump {hdoc['reason']} {hdoc['stalled']}")
    lrep = rep["ledger"]
    merged = ledger.scan_ledger(lrep["cohort_dir"])["runs"]
    ids = [r["run_id"] for rr in range(2)
           for r in ledger.scan_ledger(str(run_dir / "ledger" / f"rank-{rr}"))["runs"]]
    fits = [r for r in merged if r["kind"] == "fit"]
    check(lrep["merged"] == len(ids) == len(set(ids)) == len(merged) and lrep["remerged"] == 0
          and {r["knobs"].get("process_count") for r in fits} == {2}
          and len({ledger.cohort_key(r) for r in fits}) == 1,
          f"obs (q) cohort: merged {lrep}, {len(ids)} rank records, {len(merged)} merged")
    coh = rep["cohort"]
    check(coh.get("ranks") == [0, 1] and coh.get("merged_trace_valid") and coh.get("skew")
          and coh["attribution"]["kind"] == "cohort" and coh["ledger_annotated"] == len(fits),
          f"obs (q) cohort report: {json.dumps(coh, default=str)[:800]}")
    launches = {k: sum(r["kernel_launches"][k] for r in rep["results"].values())
                for k in FLASH_NAMES}
    skew = coh["skew"]
    row = dict(card=card, stall=stall_row, cohort_seconds=seconds,
               events=[e["outcome"] for e in rep["events"]],
               dumps_by_rank={r: [p.name for p in v] for r, v in dumps.items()},
               hung_dumps=ev["blackbox_dumps"], merged=lrep["merged"],
               fit_records=len(fits), steady_skew_frac=skew["steady_skew_frac"],
               straggler=skew["straggler_rank"], obs003=[f["code"] for f in coh["findings"]],
               per_rank_mean_step_ms={r: v["mean_step_s"] * 1e3
                                      for r, v in skew["per_rank"].items()},
               launches=launches)
    print(f"obs (q): train.stall {OBS_STALL_S:g} s at step 2 past the watchdog's "
          f"{OBS_WATCHDOG_S:g} s -> {stall_row['dump']} (fit.loop silent "
          f"{stall_row['stalled_s']:.2f} s, {stall_row['threads']} thread stacks, "
          f"{stall_row['trace_tail']} trace events); cohort of 2 ranks (the Transformer at "
          f"full width, {PAR_LAYERS} layers, cohort_obs on, watchdog {OBS_COHORT_WATCHDOG_S:g} "
          f"s), rank 1 hung at step {OBS_HANG_STEP} -> {row['events']} with dumps "
          f"{row['hung_dumps']}, relaunched; ledger merged {lrep['merged']} records (each "
          f"run id once, a second merge adds {lrep['remerged']}), {len(fits)} fit records in "
          f"one cohort; report: merged trace valid over lanes {coh['lanes']}, steady skew "
          f"{skew['steady_skew_frac']}, straggler rank {skew['straggler_rank']}, findings "
          f"{row['obs003']}, per-rank step ms "
          f"{row['per_rank_mean_step_ms']}; {seconds:.1f} s; launches {launches} [{card}]",
          flush=True)
    return row


def obs_branchy(ff, width: int):
    """(r)'s MLP: two parallel Linears on one input into a feature concat,
    a Linear and a ReLU, then the head."""
    x = ff.create_tensor((BATCH * 8, width), name="x")
    a = ff.dense(x, width, name="ba")
    b = ff.dense(x, width, name="bb")
    cat = ff.concat([a, b], axis=-1, name="cat")
    h = ff.relu(ff.dense(cat, width, name="mid"), name="act")
    return ff.dense(h, 16, name="head")


def obs_rule_search(card: str) -> dict:
    """(r): the rule file through the search: a json: rewrite wins on the
    MLP, which then trains OBS_RULE_STEPS steps within OBS_RULE_TOL of the
    unrewritten graph; the Transformer's attention is left whole."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType, SGDOptimizer,
                                    load_numpy_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    path = OBS_DIR / "rules.json"
    path.write_text(json.dumps(obs_rules()))
    width = 1024

    def mlp(rules: bool):
        ff = FFModel(FFConfig(batch_size=BATCH * 8, seed=SEED, device=DEVICE,
                              ledger_dir=str(OBS_DIR / "ledger"),
                              search_budget=1 if rules else 0,
                              substitution_json_path=str(path) if rules else None))
        obs_branchy(ff, width)
        ff.compile(SGDOptimizer(lr=0.01), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
        return ff

    base, rew = mlp(False), mlp(True)
    rewrites = list(rew.search_result.rewrites or [])
    check(rew._search_layers is not None and any(r.startswith("json:") for r in rewrites),
          f"obs (r): no json: rewrite won on the MLP: {rewrites}")
    bp = base.numpy_params()
    rp = rew.numpy_params()
    merged = [n for n in rp if n not in bp]
    tree = {k: v for k, v in bp.items() if k in rp}
    for n in merged:
        tree[n] = {w: np.concatenate([bp["ba"][w], bp["bb"][w]], axis=-1) for w in bp["ba"]}
    load_numpy_params(rew, tree)
    rng = np.random.default_rng(SEED + 21)
    n = BATCH * 8 * OBS_RULE_STEPS
    x = rng.standard_normal((n, width), dtype=np.float32)
    y = rng.integers(0, 16, size=(n, 1), dtype=np.int32)
    for ff in (base, rew):
        ff.fit(x, y, epochs=1, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    bp, rp = base.numpy_params(), rew.numpy_params()
    errs = {}
    for name, ws in rp.items():
        for w, got in ws.items():
            want = (np.concatenate([bp["ba"][w], bp["bb"][w]], axis=-1) if name in merged
                    else bp[name][w])
            errs[f"{name}.{w}"] = float(np.abs(got - want).max() / np.abs(want).max())
    worst = max(errs.values())
    check(worst <= OBS_RULE_TOL, f"obs (r): the rewritten MLP after {OBS_RULE_STEPS} steps "
          f"{worst:.3g} from the unrewritten one (tol {OBS_RULE_TOL}): {errs}")
    xb = torch.as_tensor(x[:BATCH * 8], device=DEVICE)
    with torch.no_grad():
        lb = base.compiled.forward_fn(base.compiled.params, xb)
        lr = rew.compiled.forward_fn(rew.compiled.params, xb)
    logit_err = float((lr - lb).abs().max() / lb.abs().max())
    check(logit_err <= OBS_RULE_TOL, f"obs (r): logits after training {logit_err:.3g}")
    ops_before, ops_after = len(base.compiled.ops), len(rew.compiled.ops)
    del base, rew
    free_device()
    ff, tc = obs_transformer("float32", layers=2, search_budget=1,
                             substitution_json_path=str(path))
    attn = [o for o in ff.compiled.ops if o.op_type.name == "MULTIHEAD_ATTENTION"]
    check(len(attn) == tc.num_layers
          and all(o.attrs.get("_origin_rewrite") is None for o in attn),
          f"obs (r): the Transformer's attention ops {[o.name for o in attn]}")
    t_rewrites = list(ff.search_result.rewrites or []) if ff.search_result else []
    del ff
    free_device()
    row = dict(card=card, rewrites=rewrites, ops_before=ops_before, ops_after=ops_after,
               param_err=worst, logit_err=logit_err, transformer_rewrites=t_rewrites,
               attention_ops=len(attn))
    print(f"obs (r): rule file (Linear+ReLU fusion, parallel-Linear merge) through the "
          f"search: the MLP ({width} wide, batch {BATCH * 8}) took {rewrites}, {ops_before} -> "
          f"{ops_after} ops, and after {OBS_RULE_STEPS} SGD steps its params are within "
          f"{worst:.3g} and its logits {logit_err:.3g} of the unrewritten graph's (tol "
          f"{OBS_RULE_TOL}); the 2-layer Transformer took {t_rewrites or 'no rewrite'}, its "
          f"{len(attn)} attention ops whole [{card}]", flush=True)
    return row


def phase_obs(card: str) -> dict:
    """(n) the observability layer around fit, f32 and bf16; (o) the bf16
    run's top suggestion applied and judged; (p) serving attribution and
    advice; (q) the stall watchdog, alone and in a supervised cohort with a
    hung rank; (r) a GraphXfer rule file through the search."""
    from flexflow_tpu_torch.obs.server import stop_obs_server

    t0 = time.perf_counter()
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    saved = os.environ.get("FLEXFLOW_TPU_LEDGER_DIR")
    os.environ["FLEXFLOW_TPU_LEDGER_DIR"] = str(OBS_DIR / "ledger")
    try:
        f32 = obs_fit("float32", card)
        n32 = f32.pop("row")
        del f32
        free_device()
        bf16 = obs_fit("bfloat16", card)
        print(f"phases: obs (n) at {time.perf_counter() - t0:.1f} s", flush=True)
        exp = obs_experiment(bf16, card)
        n16 = bf16.pop("row")
        del bf16
        free_device()
        print(f"phases: obs (o) at {time.perf_counter() - t0:.1f} s", flush=True)
        serving = obs_serving(card)
        free_device()
        print(f"phases: obs (p) at {time.perf_counter() - t0:.1f} s", flush=True)
        stall = obs_stall(card)
        print(f"phases: obs (q) at {time.perf_counter() - t0:.1f} s", flush=True)
        rules = obs_rule_search(card)
    finally:
        from flexflow_tpu_torch.obs.watchdog import watchdog

        stop_obs_server()
        watchdog().disarm()
        if saved is None:
            os.environ.pop("FLEXFLOW_TPU_LEDGER_DIR", None)
        else:
            os.environ["FLEXFLOW_TPU_LEDGER_DIR"] = saved
    launches = {k: n32["launches"][k] + n16["launches"][k] + stall["launches"][k]
                for k in FLASH_NAMES}
    launches["flash_attention_fwd"] += serving["launches"]["flash_attention_fwd"]
    out = dict(fit=[n32, n16], experiment=exp, serving=serving, stall=stall, rules=rules,
               flash_launches=launches, seconds=time.perf_counter() - t0)
    print("obs_json " + json.dumps(out, default=str), flush=True)
    shutil.rmtree(OBS_DIR, ignore_errors=True)
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
               training: int, expert_parallel: int) -> dict:
    """One MoE kernel's entry of the kernels line, its numbers from the
    float32 row at the MoE model's shape (the serving and training paths'
    variant); ``launches`` counts the MoE serving and fit runs and every
    rank's launches under expert parallelism."""
    main_row = next(r for r in rows if r["dtype"] == "float32" and r["shape"].startswith("main"))
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": serving + training + expert_parallel, "serving_launches": serving,
            "training_launches": training, "expert_parallel_launches": expert_parallel, "max_abs_err": main_row["max_abs_err"],
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
    free_device()
    par, par_refs = phase_parallel(card)
    print(f"phases: parallel done at {time.perf_counter() - t0:.0f} s", flush=True)
    free_device()
    par_b = phase_parallel_b(card, par_refs)
    print(f"phases: parallel_b done at {time.perf_counter() - t0:.0f} s", flush=True)
    free_device()
    par_c = phase_parallel_c(card)
    print(f"phases: parallel_c done at {time.perf_counter() - t0:.0f} s", flush=True)
    free_device()
    search = phase_search(card, par_refs)
    del par_refs
    print(f"phases: search done at {time.perf_counter() - t0:.0f} s", flush=True)
    free_device()
    obs = phase_obs(card)
    print(f"phases: obs done at {time.perf_counter() - t0:.0f} s", flush=True)
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
                      + breadth["launches"] + rob["launches"]["flash_attention_fwd"]
                      + par["launches"]["flash_attention_fwd"]
                      + par_b["flash_launches"]["flash_attention_fwd"]
                      + par_c["flash_launches"]["flash_attention_fwd"]
                      + search["flash_launches"]["flash_attention_fwd"]
                      + obs["flash_launches"]["flash_attention_fwd"],
                      obs_launches=obs["flash_launches"]["flash_attention_fwd"],
                      parallel_launches=par["launches"]["flash_attention_fwd"],
                      search_launches=search["flash_launches"]["flash_attention_fwd"],
                      parallel_b_launches=par_b["flash_launches"]["flash_attention_fwd"],
                      parallel_c_launches=par_c["flash_launches"]["flash_attention_fwd"],
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
                      + rob["launches"]["flash_attention_bwd_dq"]
                      + par["launches"]["flash_attention_bwd_dq"]
                      + par_b["flash_launches"]["flash_attention_bwd_dq"]
                      + par_c["flash_launches"]["flash_attention_bwd_dq"]
                      + search["flash_launches"]["flash_attention_bwd_dq"]
                      + obs["flash_launches"]["flash_attention_bwd_dq"],
                      obs_launches=obs["flash_launches"]["flash_attention_bwd_dq"],
                      parallel_launches=par["launches"]["flash_attention_bwd_dq"],
                      search_launches=search["flash_launches"]["flash_attention_bwd_dq"],
                      parallel_b_launches=par_b["flash_launches"]["flash_attention_bwd_dq"],
                      parallel_c_launches=par_c["flash_launches"]["flash_attention_bwd_dq"],
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
                      + rob["launches"]["flash_attention_bwd_dkv"]
                      + par["launches"]["flash_attention_bwd_dkv"]
                      + par_b["flash_launches"]["flash_attention_bwd_dkv"]
                      + par_c["flash_launches"]["flash_attention_bwd_dkv"]
                      + search["flash_launches"]["flash_attention_bwd_dkv"]
                      + obs["flash_launches"]["flash_attention_bwd_dkv"],
                      obs_launches=obs["flash_launches"]["flash_attention_bwd_dkv"],
                      parallel_launches=par["launches"]["flash_attention_bwd_dkv"],
                      search_launches=search["flash_launches"]["flash_attention_bwd_dkv"],
                      parallel_b_launches=par_b["flash_launches"]["flash_attention_bwd_dkv"],
                      parallel_c_launches=par_c["flash_launches"]["flash_attention_bwd_dkv"],
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
                                  moe_kern[name], serving, training,
                                  par_b["moe_launches"][name]))
    check(all(e["launches"] > 0 for e in entries),
          f"a kernel never launched on its path: {[(e['name'], e['launches']) for e in entries]}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
