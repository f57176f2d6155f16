"""Runtime configuration.

PyTorch counterpart of ``flexflow_tpu/config.py``. ``FFConfig`` keeps the
JAX package's field names and defaults for the fields the port reads so
far, and adds ``device``: the port runs on the card unless the caller asks
for the CPU, and a missing card is an error, never a quiet CPU run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .ffconst import CompMode


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
