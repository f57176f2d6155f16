"""Hand-written Hopper kernels for the port.

PyTorch counterpart of ``flexflow_tpu/kernels``: each Pallas TPU kernel
becomes a CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built at first
use by :mod:`._build`. Dispatch goes by the tensor's device alone: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the kernel's
plain PyTorch version, which lives beside the wrapper.

* :mod:`.flash_attention` — the flash-attention forward (``_fwd_kernel``)
  and its two backward kernels (``_dq_kernel``, ``_dkv_kernel``), joined by
  a ``torch.autograd.Function``.
* :mod:`.moe_kernels` — the MoE row movement (``_row_gather_kernel``,
  ``_row_gather_sum_kernel``), the capacity routing, and the dispatch and
  combine ``torch.autograd.Function`` classes whose backward passes run the same
  two kernels.

Each wrapper adds one to its launch count where it launches its kernel,
and nowhere else, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import threading
from typing import Dict

FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
MOE_KERNELS = ("row_gather", "row_gather_sum")
KERNELS = FLASH_KERNELS + MOE_KERNELS

_counts_lock = threading.Lock()
_counts: Dict[str, int] = {name: 0 for name in KERNELS}


def count_launch(name: str) -> None:
    with _counts_lock:
        _counts[name] += 1


def launch_counts() -> Dict[str, int]:
    with _counts_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in _counts:
            _counts[name] = 0
