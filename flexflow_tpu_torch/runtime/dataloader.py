"""Data loading.

PyTorch counterpart of the numpy path of ``flexflow_tpu/runtime/
dataloader.py``: the whole dataset stays in host numpy, and each batch is
sliced (through the epoch's shuffle permutation, if any) and copied to the
model's device. The copy is the ``device_put.transient`` fault site and,
while a fault plan is armed, runs behind a seeded retry policy, as the
reference's ``device_put`` does.

With a :class:`~flexflow_tpu_torch.runtime.buckets.PackingSpec`
(``seq_buckets``) the group builds each epoch's packed plan from the
permuted row lengths: batches become (pad_rows, width) groups padded to
their bucket. :class:`Prefetcher` assembles host batches on a worker
thread ahead of the step (``prefetch_depth``) and groups them into stacked
super-batches for ``train_k_steps`` (``steps_per_dispatch``); the consumer
copies them to the card. Batch order is the serial loader's at any depth.
Under a mesh each rank's loader keeps its rows of every global batch
(``rows``), so the shuffle, the batch boundaries and the Prefetcher's
order are every rank's alike. The C++ native loader is not ported.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .buckets import PackingSpec, build_epoch_plan, plan_token_stats
from .faults import TransientFault
from .faults import active as _faults_active
from .faults import inject as _fault_inject
from .retry import RetryPolicy
from ..obs.trace import tracer
from ..obs.watchdog import beat as _wd_beat
from ..obs.watchdog import watch as _wd_watch

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
    past the end starts over at the first sample. ``rows``: this rank's
    rows of each batch (all by default)."""

    def __init__(self, full_array: np.ndarray, batch_size: int,
                 device: torch.device, rows: slice = slice(None)):
        self.data = np.ascontiguousarray(full_array)
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.rows = rows
        self.num_samples = self.data.shape[0]
        self.next_index = 0
        # row permutation of the pristine dataset, set by the group
        self.perm: Optional[np.ndarray] = None

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    @property
    def batch_nbytes(self) -> int:
        """Host bytes one batch moves."""
        row = self.data.nbytes // max(1, self.num_samples)
        return row * min(self.batch_size, self.num_samples)

    def reset(self) -> None:
        self.next_index = 0

    def next_batch_host(self) -> np.ndarray:
        i = self.next_index
        if i + self.batch_size > self.num_samples:
            i = 0
        rows = slice(i, i + self.batch_size)
        self.next_index = i + self.batch_size
        batch = self.data[self.perm[rows]] if self.perm is not None else self.data[rows]
        return batch[self.rows]

    def next_batch(self) -> torch.Tensor:
        return _put(self.next_batch_host(), self.device)


class DataLoaderGroup:
    """Aligned input and label loaders with one shared shuffle: each
    reshuffling reset draws ``np.random.default_rng(seed).permutation`` from
    the group's own generator, as the JAX package's numpy path does. With
    ``packing`` (and the per-row ``lengths``) each reset rebuilds the
    epoch's packed plan; the plan is a pure function of (seed, epoch), so
    :meth:`advance_epochs` and :meth:`skip_batches` replay it on resume."""

    def __init__(self, loaders: List[SingleDataLoader], seed: int = 0,
                 shuffle: bool = False, packing: Optional[PackingSpec] = None,
                 lengths: Optional[np.ndarray] = None,
                 shard: Optional[Tuple[int, int]] = None):
        if not loaders:
            raise ValueError("DataLoaderGroup needs at least one loader")
        if len({l.num_samples for l in loaders}) != 1:
            raise ValueError("all loaders must have the same sample count")
        self.loaders = loaders
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.packing = packing
        # (index, count): this rank's block of every packed batch's rows,
        # the packed row counts being multiples of ``count``
        self.shard = shard
        self._lengths = (np.asarray(lengths, dtype=np.int64)
                         if lengths is not None else None)
        self._pack_plan = None
        self._plan_idx = 0
        self._row_cursor = 0
        self._pack_perm: Optional[np.ndarray] = None
        self.epoch_token_stats: Tuple[int, int] = (0, 0)

    @property
    def num_batches(self) -> int:
        if self.packing is not None:
            if self._pack_plan is None:
                raise RuntimeError("packed loader group used before its first reset()")
            return len(self._pack_plan)
        return self.loaders[0].num_batches

    @property
    def batch_nbytes(self) -> int:
        """Host bytes of one fixed-row batch (packed batches vary; this is
        their estimate)."""
        return sum(l.batch_nbytes for l in self.loaders)

    def reset(self, reshuffle: bool = True) -> None:
        for l in self.loaders:
            l.reset()
        if self.shuffle and reshuffle:
            perm = self._rng.permutation(self.loaders[0].num_samples)
            for l in self.loaders:
                l.perm = perm
        if self.packing is not None:
            perm = self.loaders[0].perm
            if perm is None:  # shuffle off: the epoch runs in dataset order
                perm = np.arange(self.loaders[0].num_samples)
            self._pack_perm = perm
            self._pack_plan = build_epoch_plan(self._lengths[perm], self.packing)
            self._plan_idx = 0
            self._row_cursor = 0
            self.epoch_token_stats = plan_token_stats(self._pack_plan)

    def advance_epochs(self, n: int) -> None:
        """Advance the shuffle stream as ``n`` epoch resets would, so a
        resumed fit draws the permutation the original run drew."""
        for _ in range(max(0, int(n))):
            self.reset(reshuffle=True)

    def skip_batches(self, n: int) -> None:
        """Consume ``n`` batches on the host without copying them (the
        resume's fast-forward within an epoch)."""
        if self.packing is not None:
            for _ in range(max(0, int(n))):
                if self._plan_idx >= len(self._pack_plan):
                    self._plan_idx = 0
                    self._row_cursor = 0
                self._row_cursor += self._pack_plan[self._plan_idx].rows
                self._plan_idx += 1
            return
        for _ in range(max(0, int(n))):
            self.next_batch_host()

    def _next_packed_host(self) -> List[np.ndarray]:
        """One packed group: ``rows`` consecutive permuted samples, the
        sequence dims sliced to the group's width and the rows padded to
        ``pad_rows`` with padding rows (labels -1)."""
        if self._plan_idx >= len(self._pack_plan):
            # wrap: replay the epoch's plan without a new permutation
            self._plan_idx = 0
            self._row_cursor = 0
        g = self._pack_plan[self._plan_idx]
        idx = self._pack_perm[self._row_cursor:self._row_cursor + g.rows]
        self._plan_idx += 1
        self._row_cursor += g.rows
        out = []
        spec = self.packing
        for li, l in enumerate(self.loaders):
            rows = l.data[idx]
            if spec.seq_axes[li]:
                rows = rows[:, :g.width]
            if g.pad_rows > g.rows:
                pad = np.full((g.pad_rows - g.rows,) + rows.shape[1:],
                              spec.pad_values[li], dtype=rows.dtype)
                rows = np.concatenate([rows, pad])
            if self.shard is not None:
                i, n = self.shard
                per = rows.shape[0] // n
                rows = rows[i * per:(i + 1) * per]
            out.append(np.ascontiguousarray(rows))
        return out

    def next_batch_host(self) -> List[np.ndarray]:
        """One batch per loader, on the host."""
        if self.packing is not None:
            return self._next_packed_host()
        return [l.next_batch_host() for l in self.loaders]

    def assemble_host(self, k: int) -> List[np.ndarray]:
        """Host half of a (super-)batch: ``k`` consecutive batches stacked
        on a leading step dim (k = 1: no stack). The Prefetcher's worker
        runs this ahead of the step."""
        if k > 1 and self.packing is not None:
            raise ValueError("packed (bucketed) batches cannot be stacked into a "
                             "super-batch; fit forces steps_per_dispatch=1 under "
                             "seq_buckets")
        if k <= 1:
            return self.next_batch_host()
        host = [self.next_batch_host() for _ in range(k)]
        return [np.stack([h[i] for h in host]) for i in range(len(self.loaders))]

    def place(self, host: List[np.ndarray], k: int = 1) -> List[torch.Tensor]:
        """Device half: one copy per tensor (a super-batch keeps its
        leading step dim)."""
        return [_put(a, l.device) for a, l in zip(host, self.loaders)]

    def next_batch(self) -> List[torch.Tensor]:
        return self.place(self.next_batch_host(), 1)

    def next_super_batch(self, k: int) -> List[torch.Tensor]:
        """``k`` consecutive batches stacked on a new leading step dim, the
        input of ``train_k_steps``."""
        return self.place(self.assemble_host(k), k)


# ------------------------------------------------------------- prefetching
class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()
_CLOSED = object()


class _Channel:
    """Bounded producer/consumer handoff with an explicit close that wakes
    both sides: a producer blocked on a full buffer gets ``False`` (stop),
    a consumer blocked on an empty one gets :data:`_CLOSED`."""

    def __init__(self, capacity: int):
        self._cv = threading.Condition()
        self._items: collections.deque = collections.deque()
        self._capacity = max(1, int(capacity))
        self._closed = False

    def put(self, item) -> bool:
        with self._cv:
            while len(self._items) >= self._capacity and not self._closed:
                self._cv.wait()
            if self._closed:
                return False
            self._items.append(item)
            self._cv.notify_all()
            return True

    def get(self):
        with self._cv:
            while not self._items and not self._closed:
                self._cv.wait()
            if self._items:
                item = self._items.popleft()
                self._cv.notify_all()
                return item
            return _CLOSED

    def depth(self) -> int:
        with self._cv:
            return len(self._items)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class Prefetcher:
    """Bounded ahead-of-step batch pipeline over a DataLoaderGroup.

    ``depth == 0``: inline passthrough, assembly and copy on the caller's
    thread. ``depth > 0``: one daemon worker pulls host batches from the
    group (shuffle gather, packing, super-batch stacking) and parks up to
    ``depth`` of them in a queue; the consumer copies each to the device
    as it takes it. One worker, one group, the serial pull sequence: order
    and values equal the serial loader's. A worker exception is raised on
    the consumer (the ``prefetch.worker`` fault site proves it), and
    closing the epoch, finished or abandoned, joins the worker.

    ``steps_per_item > 1`` groups consecutive batches into stacked
    super-batches for ``train_k_steps``, with the JAX package's sizes
    (:meth:`_plan`)."""

    def __init__(self, group: DataLoaderGroup, depth: int, steps_per_item: int = 1,
                 stats=None):
        self.group = group
        self.depth = max(0, int(depth))
        self.k = max(1, int(steps_per_item))
        # an EpochThroughput (obs/metrics.py): input waits and queue depths
        self.stats = stats

    def _plan(self) -> List[int]:
        """Per-epoch item sizes. With a background queue the super sizes
        ramp (1, 2, 4, ..., k) so the first step waits on one batch; sizes
        are powers of two up to k, and the tail steps down through sizes
        the plan already used. Grouping never changes batch order."""
        nb = self.group.num_batches
        if self.k <= 1:
            return [1] * nb
        plan: List[int] = []
        emitted = {1}
        rem = nb
        size = 1 if self.depth > 0 else self.k
        while rem > 0:
            if size < self.k and rem >= size:  # warm-up ramp: 1, 2, 4, ...
                s = size
                size *= 2
            elif size >= self.k and rem >= self.k:
                s = self.k
            else:
                s = max((e for e in emitted if e <= rem), default=1)
            emitted.add(s)
            plan.append(s)
            rem -= s
        return plan

    def epoch(self, reshuffle: bool = True, skip: int = 0) -> Iterator[Tuple[int, list]]:
        """Reset the group and yield one epoch of ``(n_steps, batch)``
        items on the device; ``batch`` is a stacked super-batch when
        ``n_steps > 1``. ``skip`` fast-forwards past the first steps
        (resume) and must land on an item boundary of the plan."""
        self.group.reset(reshuffle)
        plan = self._plan()
        if skip:
            done = idx = 0
            while idx < len(plan) and done < skip:
                done += plan[idx]
                idx += 1
            if done != skip:
                raise ValueError(
                    f"resume skip={skip} does not align with the dispatch plan's "
                    f"item boundaries (prefix sums {plan[:idx]})")
            self.group.skip_batches(skip)
            plan = plan[idx:]
        tr = tracer()
        # span names follow the loop that drives this (fit or eval), as the
        # registry series the stats feed
        pfx = self.stats.prefix if self.stats is not None else "fit"
        # the consumer loop is a watched section: every resumption (one a
        # dispatch) beats it. The watch opens at the second item, since
        # the first step's dispatch carries the kernels' first launch
        section = None
        if self.depth == 0:
            try:
                for i, k in enumerate(plan):
                    if i == 1:
                        section = _wd_watch(f"{pfx}.loop")
                        section.__enter__()
                    elif i > 1:
                        _wd_beat(f"{pfx}.loop")
                    t0 = time.perf_counter()
                    host = self.group.assemble_host(k)
                    wait = time.perf_counter() - t0
                    if self.stats is not None:
                        # inline assembly is all wait
                        self.stats.record_wait(wait)
                        self.stats.record_depth(0)
                    if tr.enabled:
                        tr.complete(f"{pfx}.input_wait", t0, wait, cat=pfx,
                                    args={"k": k, "mode": "serial"})
                    yield k, self.group.place(host, k)
            finally:
                if section is not None:
                    section.__exit__(None, None, None)
            return
        chan = _Channel(self.depth)

        def _work():
            try:
                for k in plan:
                    # the assembly must make progress; the put may block on
                    # a full channel (consumer pacing), so only the
                    # assembly is watched
                    with _wd_watch("prefetch.worker"):
                        # fault site: a worker exception must reach the
                        # consumer as the raised error and never leak this
                        # thread
                        _fault_inject("prefetch.worker")
                        item = (k, self.group.assemble_host(k))
                    if not chan.put(item):
                        return  # the consumer closed the channel mid-epoch
                chan.put(_DONE)
            except BaseException as e:  # raised on the consumer side
                chan.put(_WorkerError(e))

        worker = threading.Thread(target=_work, daemon=True, name="ff-prefetch")
        worker.start()
        try:
            i = -1
            while True:
                i += 1
                if i == 1:
                    section = _wd_watch(f"{pfx}.loop")
                    section.__enter__()
                elif i > 1:
                    _wd_beat(f"{pfx}.loop")
                depth_sample = chan.depth()
                t0 = time.perf_counter()
                item = chan.get()
                wait = time.perf_counter() - t0
                if item is _DONE or item is _CLOSED:
                    return
                if isinstance(item, _WorkerError):
                    raise item.exc
                if self.stats is not None:
                    self.stats.record_depth(depth_sample)
                    self.stats.record_wait(wait)
                if tr.enabled:
                    tr.complete(f"{pfx}.input_wait", t0, wait, cat=pfx,
                                args={"depth": depth_sample, "mode": "prefetch"})
                k, host = item
                yield k, self.group.place(host, k)
        finally:
            if section is not None:
                section.__exit__(None, None, None)
            # close, then join: a worker blocked on a full channel wakes at
            # once, so an abandoned epoch leaks no thread
            chan.close()
            worker.join()
