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
kernels. A launch observer (:func:`set_launch_observer`) sees every
launch first and says whether it counts here: the program audit installs
one that keeps a side recording's launches off these counts.

A CUDA graph replays its kernels without running Python, so the counts
follow the graphs: a launch made on a stream being captured
(:func:`capture_launches`) goes into that capture's record instead of the
counts, and every replay of that graph adds its record
(:func:`add_replayed`). Records are kept by the capturing stream, not by
thread: the backward kernels of a captured step launch on the autograd
engine's device thread, on the capture's stream. The counts therefore
hold the launches that ran, eager or replayed. :data:`KERNEL_SYMBOLS`
tells each kernel's device symbols apart, for counts read from a profiler
or from a graph's nodes.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, Mapping, Optional

import torch

FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
MOE_KERNELS = ("row_gather", "row_gather_sum")
KERNELS = FLASH_KERNELS + MOE_KERNELS

# whether a device symbol (a profiler row's name, a graph node's
# function; mangled or not) belongs to the kernel
KERNEL_SYMBOLS: Dict[str, Callable[[str], bool]] = {
    "flash_attention_fwd": lambda s: "flash_fwd" in s,
    "flash_attention_bwd_dq": lambda s: "flash_bwd_dq" in s,
    "flash_attention_bwd_dkv": lambda s: "flash_bwd_dkv" in s,
    "row_gather": lambda s: "row_gather" in s and "row_gather_sum" not in s,
    "row_gather_sum": lambda s: "row_gather_sum" in s,
}

_counts_lock = threading.Lock()
_counts: Dict[str, int] = {name: 0 for name in KERNELS}
# called with each launch's name; False keeps the launch off the counts
_observer: Optional[Callable[[str], bool]] = None
# the records of the captures in progress, by their capturing stream's
# handle (the launches each graph will replay)
_captures: Dict[int, Dict[str, int]] = {}


def set_launch_observer(fn: Optional[Callable[[str], bool]]) -> None:
    """Install the observer :func:`count_launch` calls first (None: none)."""
    global _observer
    _observer = fn


def count_launch(name: str) -> None:
    observer = _observer
    if observer is not None and not observer(name):
        return
    capturing = bool(_captures) and torch.cuda.is_current_stream_capturing()
    stream = torch.cuda.current_stream().cuda_stream if capturing else None
    with _counts_lock:
        record = _captures.get(stream) if capturing else None
        if record is not None:
            record[name] += 1
        else:
            _counts[name] += 1


@contextlib.contextmanager
def capture_launches() -> Iterator[Dict[str, int]]:
    """Record the launches captured on the current stream, which a CUDA
    graph is capturing, inside the block (enter it inside the capture):
    yields the record ({kernel: launches}, filled as the capture runs, on
    whichever thread launches onto the stream), which the caller keeps and
    passes to :func:`add_replayed` at every replay. Other streams' captures
    record into their own records at the same time."""
    stream = torch.cuda.current_stream().cuda_stream
    record = {name: 0 for name in KERNELS}
    with _counts_lock:
        if stream in _captures:
            raise RuntimeError("capture_launches: this stream's capture is already recorded")
        _captures[stream] = record
    try:
        yield record
    finally:
        with _counts_lock:
            del _captures[stream]


def add_replayed(record: Mapping[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``record``."""
    with _counts_lock:
        for name, n in record.items():
            _counts[name] += int(n)


def launch_counts() -> Dict[str, int]:
    with _counts_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in _counts:
            _counts[name] = 0
