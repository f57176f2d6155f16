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
