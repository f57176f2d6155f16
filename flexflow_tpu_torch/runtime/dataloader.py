"""Data loading.

PyTorch counterpart of the numpy path of ``flexflow_tpu/runtime/
dataloader.py``: the whole dataset stays in host numpy, and each batch is
sliced (through the epoch's shuffle permutation, if any) and copied to the
model's device. The copy is the ``device_put.transient`` fault site and,
while a fault plan is armed, runs behind a seeded retry policy, as the
reference's ``device_put`` does. The native loader, token packing and the
``Prefetcher`` are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .faults import TransientFault
from .faults import active as _faults_active
from .faults import inject as _fault_inject
from .retry import RetryPolicy

# transient copy failures (and the device_put.transient fault site) back
# off briefly and retry; a persistent failure surfaces after the budget.
# Seeded: a replayed plan backs off identically.
_PUT_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.002, max_delay_s=0.02,
                         retry_on=(TransientFault,), label="device_put", seed=0)


def _put_once(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    _fault_inject("device_put.transient", TransientFault)
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)


def _put(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host batch to ``device``, behind the retry policy only while a
    fault plan is armed (the off path is one global read)."""
    if _faults_active():
        return _PUT_RETRY.call(_put_once, batch, device)
    return _put_once(batch, device)


class SingleDataLoader:
    """One tensor's loader. The sample count need not divide into whole
    batches: an epoch takes the whole batches, and a batch that would run
    past the end starts over at the first sample."""

    def __init__(self, full_array: np.ndarray, batch_size: int,
                 device: torch.device):
        self.data = np.ascontiguousarray(full_array)
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.num_samples = self.data.shape[0]
        self.next_index = 0
        # row permutation of the pristine dataset, set by the group
        self.perm: Optional[np.ndarray] = None

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def reset(self) -> None:
        self.next_index = 0

    def next_batch_host(self) -> np.ndarray:
        i = self.next_index
        if i + self.batch_size > self.num_samples:
            i = 0
        rows = slice(i, i + self.batch_size)
        self.next_index = i + self.batch_size
        return self.data[self.perm[rows]] if self.perm is not None else self.data[rows]

    def next_batch(self) -> torch.Tensor:
        return _put(self.next_batch_host(), self.device)


class DataLoaderGroup:
    """Aligned input and label loaders with one shared shuffle: each
    reshuffling reset draws ``np.random.default_rng(seed).permutation`` from
    the group's own generator, as the JAX package's numpy path does."""

    def __init__(self, loaders: List[SingleDataLoader], seed: int = 0,
                 shuffle: bool = False):
        if not loaders:
            raise ValueError("DataLoaderGroup needs at least one loader")
        if len({l.num_samples for l in loaders}) != 1:
            raise ValueError("all loaders must have the same sample count")
        self.loaders = loaders
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    @property
    def num_batches(self) -> int:
        return self.loaders[0].num_batches

    def reset(self, reshuffle: bool = True) -> None:
        for l in self.loaders:
            l.reset()
        if self.shuffle and reshuffle:
            perm = self._rng.permutation(self.loaders[0].num_samples)
            for l in self.loaders:
                l.perm = perm

    def next_batch(self) -> List[torch.Tensor]:
        return [l.next_batch() for l in self.loaders]
