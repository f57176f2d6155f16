"""Inference engine: model instances + dynamic micro-batching.

PyTorch counterpart of the classic one-shot serving path in
``flexflow_tpu/serving/engine.py``: a :class:`ModelInstance` wraps one
compiled model and pads each gathered batch up to its compiled batch size;
an :class:`InferenceEngine` owns one dynamic batcher and one worker thread
per registered instance. The batcher is the pure-Python one
(``_PyBatcher``) with the native batcher's semantics: a batch leaves when
it is full or when its oldest request has waited ``batch_timeout_s``.

Not ported yet: the native batcher, admission bounds, deadlines, the
failure breaker, worker respawn, fault sites, placement, ONNX and the
observability spans.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class _PyBatcher:
    """Queue of request ids that hands out batches of at most
    ``max_batch``."""

    def __init__(self, max_batch: int, timeout_s: float):
        self.max_batch = int(max_batch)
        self._timeout = float(timeout_s)
        self._q: collections.deque = collections.deque()  # (id, t_enqueued)
        self._mu = threading.Condition()
        self._closed = False

    def submit(self, request_id: int) -> None:
        with self._mu:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.append((request_id, time.monotonic()))
            self._mu.notify_all()

    def next_batch(self) -> Optional[List[int]]:
        """Block until a batch is due; None once closed and drained."""
        with self._mu:
            while True:
                if self._q:
                    deadline = self._q[0][1] + self._timeout
                    now = time.monotonic()
                    if (len(self._q) >= self.max_batch or self._closed
                            or now >= deadline):
                        ids = []
                        while self._q and len(ids) < self.max_batch:
                            ids.append(self._q.popleft()[0])
                        return ids
                    self._mu.wait(deadline - now)
                else:
                    if self._closed:
                        return None
                    self._mu.wait()

    def close(self) -> None:
        with self._mu:
            self._closed = True
            self._mu.notify_all()


class ModelInstance:
    """One compiled inference model. Requests of any count up to the
    compiled batch size are padded up and run through the forward; rows
    beyond the request count are discarded."""

    def __init__(self, ff, name: str = "model"):
        if ff.compiled is None:
            raise ValueError("compile() the FFModel before serving it")
        self.name = name
        self._ff = ff
        self._cm = ff.compiled
        self.batch_size = self._cm.input_tensors[0].dims[0]
        self.n_inputs = len(self._cm.input_tensors)
        # forward dispatches so far (one per served batch)
        self.dispatches = 0

    def infer(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Run one padded batch. ``inputs``: one array per model input,
        leading dim = request count <= batch_size. Returns per-request
        outputs (padding rows stripped) as float32 numpy arrays."""
        n = int(inputs[0].shape[0])
        if n > self.batch_size:
            raise ValueError(f"{n} requests > compiled batch {self.batch_size}")
        cm = self._cm
        xs = []
        for a in inputs:
            a = np.asarray(a)
            if a.shape[0] < self.batch_size:
                pad = np.zeros((self.batch_size - a.shape[0],) + a.shape[1:],
                               a.dtype)
                a = np.concatenate([a, pad], axis=0)
            xs.append(torch.from_numpy(np.ascontiguousarray(a)).to(cm.device))
        logits = cm.forward_fn(cm.params, *xs)
        self.dispatches += 1
        return [logits[:n].cpu().numpy()]


class InferenceRequest:
    """A queued request: per-input rows + a Future for the result."""

    __slots__ = ("inputs", "future", "request_id")

    def __init__(self, request_id: int, inputs: Sequence[np.ndarray]):
        self.request_id = request_id
        self.inputs = [np.asarray(a) for a in inputs]
        self.future: Future = Future()


class InferenceEngine:
    """Serving engine: each registered model owns one dynamic batcher and
    one worker thread that drains it. Requests are single samples (the
    batch dim is added here)."""

    def __init__(self, batch_timeout_s: float = 0.005):
        self.batch_timeout_s = batch_timeout_s
        self._models: Dict[str, ModelInstance] = {}
        self._batchers: Dict[str, _PyBatcher] = {}
        self._requests: Dict[str, Dict[int, InferenceRequest]] = {}
        self._workers: Dict[str, threading.Thread] = {}
        self._ids = itertools.count()
        # guards the registry dicts and _started; batcher close/submit and
        # worker joins happen outside it so a blocked thread never stalls
        # the registry
        self._mu = threading.Lock()
        self._started = False

    # ---- model repository -------------------------------------------------
    def register(self, instance: ModelInstance) -> None:
        with self._mu:
            if instance.name in self._models:
                raise ValueError(
                    f"{instance.name!r} is already registered (instance "
                    f"groups are not ported yet)")
            self._models[instance.name] = instance
            self._batchers[instance.name] = _PyBatcher(
                instance.batch_size, self.batch_timeout_s)
            self._requests[instance.name] = {}
            if self._started:
                self._spawn(instance.name)

    def register_ffmodel(self, ff, name: str = "model") -> ModelInstance:
        inst = ModelInstance(ff, name=name)
        self.register(inst)
        return inst

    # ---- lifecycle ----------------------------------------------------------
    def _spawn(self, name: str) -> None:
        """Caller holds ``self._mu``."""
        if name not in self._workers:
            t = threading.Thread(target=self._worker, args=(name,),
                                 daemon=True, name=f"ffserve-{name}")
            self._workers[name] = t
            t.start()

    def start(self) -> None:
        with self._mu:
            if self._started:
                return
            self._started = True
            for name in self._models:
                self._spawn(name)

    def stop(self) -> None:
        """Serve every request already queued, stop the workers, and re-arm
        each model with a fresh batcher so a later request starts them
        again. Call it when no ``infer_async`` is in flight: a request
        submitted while it runs may find its batcher closed and raise."""
        with self._mu:
            workers = dict(self._workers)
            batchers = dict(self._batchers)
            self._started = False
        for b in batchers.values():
            b.close()
        for t in workers.values():
            t.join(timeout=60)
            if t.is_alive():
                raise RuntimeError(f"serving worker {t.name} did not stop")
        with self._mu:
            for key in workers:
                self._workers.pop(key, None)
            for name in batchers:
                self._batchers[name] = _PyBatcher(
                    self._models[name].batch_size, self.batch_timeout_s)

    # ---- request path -------------------------------------------------------
    def infer_async(self, model: str, inputs: Sequence[np.ndarray]) -> Future:
        """Submit one request (arrays WITHOUT the batch dim). The future
        resolves to the model's per-request output array."""
        self.start()
        with self._mu:
            inst = self._models[model]
        if len(inputs) != inst.n_inputs:
            raise ValueError(
                f"{model!r} takes {inst.n_inputs} inputs, got {len(inputs)}")
        # validate per-request shapes HERE so one malformed request fails
        # alone instead of poisoning every co-batched request
        for a, t in zip(inputs, inst._cm.input_tensors):
            want = tuple(t.dims[1:])
            if tuple(np.shape(a)) != want:
                raise ValueError(
                    f"{model!r} input {t.name!r}: expected per-request shape "
                    f"{want}, got {np.shape(a)}")
        req = InferenceRequest(next(self._ids),
                               [np.asarray(a)[None, ...] for a in inputs])
        with self._mu:
            batcher = self._batchers[model]
            self._requests[model][req.request_id] = req
        batcher.submit(req.request_id)
        return req.future

    def infer(self, model: str, inputs: Sequence[np.ndarray],
              timeout: Optional[float] = 60.0) -> np.ndarray:
        return self.infer_async(model, inputs).result(timeout)

    # ---- worker -------------------------------------------------------------
    def _worker(self, name: str) -> None:
        with self._mu:
            inst = self._models[name]
            batcher = self._batchers[name]
        while True:
            ids = batcher.next_batch()
            if ids is None:
                return
            with self._mu:
                reqs = [self._requests[name].pop(i) for i in ids]
            try:
                stacked = [np.concatenate([r.inputs[k] for r in reqs], axis=0)
                           for k in range(inst.n_inputs)]
                outs = inst.infer(stacked)[0]
            except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
                for r in reqs:
                    r.future.set_exception(e)
                continue
            for row, r in enumerate(reqs):
                r.future.set_result(outs[row])
