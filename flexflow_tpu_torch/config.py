"""Runtime configuration.

PyTorch counterpart of ``flexflow_tpu/config.py``. ``FFConfig`` keeps the
JAX package's field names and defaults for the fields the port reads so
far, and adds ``device``: the port runs on the card unless the caller asks
for the CPU, and a missing card is an error, never a quiet CPU run.
:meth:`FFConfig.parse_args` reads the JAX package's flags for those
fields; :class:`FFIterationConfig` carries the per-iteration sequence
length.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import torch

from .ffconst import CompMode


@dataclasses.dataclass
class FFIterationConfig:
    """Per-iteration dynamic config: ``seq_length`` > 0 truncates the
    sequence dims that ops declare (BatchMatmul's ``a/b_seq_length_dim``)
    for this iteration; -1 truncates nothing."""

    seq_length: int = -1

    def reset(self) -> None:
        self.seq_length = -1


@dataclasses.dataclass
class FFConfig:
    """Global runtime config (the subset of ``flexflow_tpu.FFConfig`` that
    the port reads so far)."""

    batch_size: int = 64
    epochs: int = 1  # fit()'s default epoch count
    # the strategy search is not ported; 0 (no search) is the only value
    search_budget: int = 0
    computation_mode: CompMode = CompMode.TRAINING
    # "bfloat16" runs activations and matmuls in bf16 while the params
    # stay float32; None/"float32" = full precision
    compute_dtype: Optional[str] = None
    seed: int = 0
    # "cuda" (default) or "cpu"; "cuda:N" picks a card
    device: str = "cuda"
    # fuse straight chains of weightless unary ops into one FusedOp at
    # compile (ops/fused.py); the logits tensor is never fused away
    perform_fusion: bool = False
    # --- crash safety (runtime/checkpoint.py) ---
    # > 0: fit saves a full resume checkpoint (params, optimizer state and
    # the step loop's position) every N steps into checkpoint_dir;
    # fit(resume_from=dir) restores the newest intact one and replays the
    # loop from there
    checkpoint_interval_steps: int = 0
    # None = .ffcache/ckpt under the working directory
    checkpoint_dir: Optional[str] = None
    checkpoint_max_to_keep: int = 3
    # a resume whose checkpoint was written under another topology raises
    # CKPT001 unless this opts into the counted portable restore
    elastic_resume: bool = False
    # gradient accumulation: each step splits its batch into K
    # microbatches, sums their gradients and metrics, divides the
    # gradients by K and updates once
    grad_accum_steps: int = 1
    # --- the step loop ---
    # Prefetcher queue depth: a worker thread assembles host batches ahead
    # of the step; 0 = inline assembly
    prefetch_depth: int = 0
    # steps fit keeps in flight on the card before it waits for the oldest
    max_inflight_steps: int = 2
    # K > 1: fit runs K consecutive batches through train_k_steps in one
    # host call (off under seq_buckets or a recompile state)
    steps_per_dispatch: int = 1
    # --- sequence buckets (runtime/buckets.py) ---
    # "off" = pad to the data's width; "pow2" = powers of two from
    # seq_bucket_min up to seq_bucket_max (0 = the data's width); or a
    # comma list ("32,64,128"). Row lengths come from the sparse-CE
    # labels' trailing -1 padding, and -1 positions are masked out of the
    # loss, the metrics and the gradients
    seq_buckets: str = "off"
    seq_bucket_min: int = 8
    seq_bucket_max: int = 0
    # > 0: pack each epoch by tokens (rows x bucket width <= budget)
    # instead of fixed batch_size rows; needs seq_buckets
    token_budget: int = 0
    # "on": keep the packing plan but pad every batch to the ladder's top
    # (the pad-to-max comparison run)
    seq_bucket_pad_max: str = "off"
    # --- continuous-batching generation (serving/scheduler.py): the
    # defaults of a GenerationInstance, each overridable per instance ---
    # decode slots: the fixed batch width of the one decode step
    serving_decode_slots: int = 4
    # paged KV pool: tokens a block, and blocks (0 = auto: one worst-case
    # request a decode slot, plus the null block)
    serving_block_size: int = 16
    serving_num_blocks: int = 0
    # longest sequence served (prompt + generated); 0 = the position
    # embedding's capacity
    serving_max_length: int = 0
    # prefill bucket lengths, comma-separated ("16,64,256"); None = powers
    # of two from 8 up to max_length
    serving_prefill_buckets: Optional[str] = None
    # prompts prefilled between two decode steps while requests are active
    serving_max_prefills_per_step: int = 1
    # > 0: group admitted prompts by bucket, up to budget // bucket a
    # prefill dispatch; 0 = one prompt a dispatch
    serving_prefill_token_budget: int = 0
    # speculative decoding: the draft ("self:N" = the target's first N
    # blocks with its weights, "gpt:layers=..,hidden=..,heads=.." = a fresh
    # GPT) and the proposals a round; "" / 0 = off
    serving_draft_model: str = ""
    serving_spec_k: int = 0
    # arena storage: "float32" (the compute dtype), "bfloat16" or "int8";
    # int8 is held to the divergence budget at construction (0.0 = the
    # default budget, 0.05) and falls back to float32 loudly past it
    serving_kv_dtype: str = "float32"
    serving_kv_divergence_budget: float = 0.0
    # span tracer (obs/trace.py): "on" arms the process-wide recorder at
    # compile/fit/eval; "off" keeps the hot loops span-free
    trace: str = "off"
    # deterministic fault plan (runtime/faults.py), armed at compile, fit
    # and serving-instance construction; None = no chaos
    fault_plan: Optional[dict] = None

    def torch_device(self) -> torch.device:
        """The device the model lives on; raises when it asks for a card
        this process cannot see."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FFConfig.device={self.device!r} but torch sees no CUDA "
                f"device; pass device='cpu' to run on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device!r}")
        return dev

    @staticmethod
    def parse_args(argv: Sequence[str]) -> "FFConfig":
        """The JAX package's command-line flags for the fields the port
        has; unknown flags are ignored, as there."""
        cfg = FFConfig()
        flags = {
            "-e": ("epochs", int), "--epochs": ("epochs", int),
            "-b": ("batch_size", int), "--batch-size": ("batch_size", int),
            "--budget": ("search_budget", int), "--search-budget": ("search_budget", int),
            "--seed": ("seed", int), "--compute-dtype": ("compute_dtype", str),
            "--checkpoint-interval": ("checkpoint_interval_steps", int),
            "--checkpoint-dir": ("checkpoint_dir", str),
            "--checkpoint-keep": ("checkpoint_max_to_keep", int),
            "--grad-accum-steps": ("grad_accum_steps", int),
            "--prefetch-depth": ("prefetch_depth", int),
            "--max-inflight-steps": ("max_inflight_steps", int),
            "--steps-per-dispatch": ("steps_per_dispatch", int),
            "--seq-buckets": ("seq_buckets", str),
            "--seq-bucket-min": ("seq_bucket_min", int),
            "--seq-bucket-max": ("seq_bucket_max", int),
            "--seq-bucket-pad-max": ("seq_bucket_pad_max", str),
            "--token-budget": ("token_budget", int),
            "--serving-decode-slots": ("serving_decode_slots", int),
            "--serving-block-size": ("serving_block_size", int),
            "--serving-num-blocks": ("serving_num_blocks", int),
            "--serving-max-length": ("serving_max_length", int),
            "--serving-prefill-buckets": ("serving_prefill_buckets", str),
            "--serving-max-prefills": ("serving_max_prefills_per_step", int),
            "--serving-prefill-token-budget": ("serving_prefill_token_budget", int),
            "--serving-draft-model": ("serving_draft_model", str),
            "--serving-spec-k": ("serving_spec_k", int),
            "--serving-kv-dtype": ("serving_kv_dtype", str),
            "--serving-kv-divergence-budget": ("serving_kv_divergence_budget", float),
        }
        switches = {"--fusion": ("perform_fusion", True),
                    "--elastic-resume": ("elastic_resume", True),
                    "--trace": ("trace", "on")}
        args = list(argv)
        i = 0
        while i < len(args):
            a = args[i]
            if a in flags and i + 1 < len(args):
                field, conv = flags[a]
                i += 1
                setattr(cfg, field, conv(args[i]))
            elif a in switches:
                setattr(cfg, *switches[a])
            elif a == "--fault-plan" and i + 1 < len(args):
                # a JSON file path; the plan is validated at compile/fit
                i += 1
                with open(args[i]) as f:
                    cfg.fault_plan = json.load(f)
            i += 1
        return cfg
