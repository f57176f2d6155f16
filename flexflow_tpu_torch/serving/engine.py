"""Inference engine: model instances, dynamic micro-batching, and
continuous-batching generation instances.

PyTorch counterpart of ``flexflow_tpu/serving/engine.py``: a
:class:`ModelInstance` wraps one compiled model and pads each gathered
batch up to its compiled batch size; an :class:`InferenceEngine` owns one
dynamic batcher and one worker thread per registered instance. The batcher
is the pure-Python one (``_PyBatcher``) with the native batcher's
semantics: a batch leaves when it is full or when its oldest request has
waited ``batch_timeout_s``. A :class:`GenerationInstance`
(``InferenceEngine.register_generator``) serves a causal LM through the
continuous-batching scheduler (``serving/scheduler.py``).

Not ported yet: the native batcher, the classic path's admission bounds,
deadlines, failure breaker and worker respawn (the generation path has
its own), fault sites, placement, ONNX and the observability spans.
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

from .errors import DeadlineExceeded, KVPoolExhausted, ShedError


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


class GenerationInstance:
    """One continuous-batching generation instance: a compiled causal LM
    behind a :class:`~flexflow_tpu_torch.serving.scheduler.ContinuousBatchingScheduler`
    (paged KV pool, prefill and decode steps, in-flight batching). Its knobs
    default to the model config's ``serving_*`` fields; keyword arguments
    override them. ``draft_ff`` may be a compiled draft model or a spec
    string (``"self:N"``, ``"gpt:..."``) for
    :func:`~flexflow_tpu_torch.serving.generation.build_draft_model`; with
    ``spec_k`` and no ``draft_ff``, a non-empty ``serving_draft_model``
    names it."""

    def __init__(self, ff, name: str = "lm", **scheduler_kw):
        if ff.compiled is None:
            raise ValueError("compile() the FFModel before serving it")
        from .generation import build_draft_model
        from .scheduler import ContinuousBatchingScheduler

        cfg = ff.config
        defaults = {
            "decode_slots": cfg.serving_decode_slots,
            "block_size": cfg.serving_block_size,
            "max_prefills_per_step": cfg.serving_max_prefills_per_step,
            "prefill_token_budget": cfg.serving_prefill_token_budget,
            "spec_k": cfg.serving_spec_k,
            "kv_dtype": cfg.serving_kv_dtype or "float32",
        }
        if cfg.serving_kv_divergence_budget:
            defaults["kv_divergence_budget"] = float(cfg.serving_kv_divergence_budget)
        if cfg.serving_num_blocks:
            defaults["num_blocks"] = int(cfg.serving_num_blocks)
        if cfg.serving_max_length:
            defaults["max_length"] = int(cfg.serving_max_length)
        if cfg.serving_prefill_buckets:
            defaults["prefill_buckets"] = [
                int(x) for x in str(cfg.serving_prefill_buckets).split(",") if x.strip()]
        defaults.update(scheduler_kw)
        if (defaults.get("spec_k", 0) and "draft_ff" not in defaults
                and cfg.serving_draft_model):
            defaults["draft_ff"] = str(cfg.serving_draft_model)
        if isinstance(defaults.get("draft_ff"), str):
            defaults["draft_ff"] = build_draft_model(ff, defaults["draft_ff"])
        self.name = name
        self._ff = ff
        self.scheduler = ContinuousBatchingScheduler(ff, name=name, **defaults)

    @property
    def decoder(self):
        return self.scheduler.decoder

    def generate_async(self, prompt, max_new_tokens: int, **kw) -> Future:
        return self.scheduler.submit(prompt, max_new_tokens, **kw)

    def generate(self, prompt, max_new_tokens: int, timeout: Optional[float] = 120.0,
                 **kw) -> np.ndarray:
        return self.scheduler.generate(prompt, max_new_tokens, timeout=timeout, **kw)

    def stats(self) -> Dict:
        return self.scheduler.stats()

    def stop(self) -> None:
        self.scheduler.stop()


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
        # continuous-batching generation instances by name, each with its
        # own scheduler thread
        self._generators: Dict[str, GenerationInstance] = {}
        self._ids = itertools.count()
        # guards the registry dicts and _started; batcher close/submit and
        # worker joins happen outside it so a blocked thread never stalls
        # the registry
        self._mu = threading.Lock()
        self._started = False

    # ---- model repository -------------------------------------------------
    def register(self, instance: ModelInstance) -> None:
        with self._mu:
            if instance.name in self._generators:
                raise ValueError(
                    f"{instance.name!r} already names a generation instance: one "
                    f"name, one model")
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

    def _check_generator_name(self, name: str) -> None:
        """Caller holds ``self._mu``."""
        if name in self._models or name in self._generators:
            raise ValueError(f"{name!r} already registered (generation instances "
                             f"do not form groups: one scheduler owns the pool)")

    def register_generator(self, ff, name: str = "lm", **kw) -> GenerationInstance:
        """Register a continuous-batching generation instance under ``name``
        (a name no model or generator holds). ``kw`` are the scheduler's
        knobs, over the config's ``serving_*`` defaults."""
        with self._mu:
            self._check_generator_name(name)
        inst = GenerationInstance(ff, name=name, **kw)
        with self._mu:
            self._check_generator_name(name)
            self._generators[name] = inst
        return inst

    def generate_async(self, model: str, prompt, max_new_tokens: int, **kw) -> Future:
        """Submit one generation request to a registered generator:
        :class:`ShedError` at admission (queue bound, open breaker, a worst
        case the pool can never hold), :class:`DeadlineExceeded` on the
        future when the deadline passes first."""
        return self.generator(model).generate_async(prompt, max_new_tokens, **kw)

    def generate(self, model: str, prompt, max_new_tokens: int,
                 timeout: Optional[float] = 120.0, **kw) -> np.ndarray:
        return self.generate_async(model, prompt, max_new_tokens, **kw).result(timeout)

    def generators(self) -> List[str]:
        with self._mu:
            return list(self._generators)

    def generator(self, name: str) -> GenerationInstance:
        with self._mu:
            return self._generators[name]

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
        submitted while it runs may find its batcher closed and raise.
        Generation instances stop first (their queued requests fail, their
        active ones finish) and are dropped: register again to serve."""
        with self._mu:
            workers = dict(self._workers)
            batchers = dict(self._batchers)
            generators = dict(self._generators)
            self._generators = {}
            self._started = False
        for g in generators.values():
            g.stop()
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


__all__ = ["DeadlineExceeded", "GenerationInstance", "InferenceEngine", "InferenceRequest",
           "KVPoolExhausted", "ModelInstance", "ShedError"]
