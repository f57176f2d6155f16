"""Inference engine: model instances, dynamic micro-batching, and
continuous-batching generation instances.

PyTorch counterpart of ``flexflow_tpu/serving/engine.py``. A
:class:`ModelInstance` wraps one compiled model on one device and pads
each gathered batch up to its compiled batch size. An
:class:`InferenceEngine` owns one dynamic batcher per model and one worker
thread per instance: repeated registrations under one name form an
instance group on disjoint devices, whose workers drain the shared
batcher. The batcher is the native one (``native/src/batcher.cc`` through
:mod:`flexflow_tpu_torch.native_bridge`); ``FLEXFLOW_TPU_NATIVE=off``
chooses the pure-Python ``_PyBatcher``, with the same semantics: a batch
leaves when it is full or when its oldest request has waited
``batch_timeout_s``. A failed native build raises: the port never falls
back quietly, so a run shows which queue served it. A
:class:`GenerationInstance` (``InferenceEngine.register_generator``)
serves a causal LM through the continuous-batching scheduler
(``serving/scheduler.py``); ``serving/placement.py`` loads a model
repository file into an engine.

Under overload or failure the engine sheds, rejects fast and respawns:

* a bounded admission queue (``admission_limit``): a request past the
  bound raises :class:`ShedError` at once (``serving.shed``);
* deadlines (``deadline_s``, engine default ``default_deadline_s``): a
  request whose deadline passed before a worker picked it up resolves
  with :class:`DeadlineExceeded` (``serving.deadline_rejects``) instead
  of taking a place in a batch;
* a crashed worker respawns under ``worker_retry_budget``
  (``serving.worker_respawns``), requeuing the batch in its hand first, so
  every accepted future resolves; the ``serving.worker`` fault site
  crashes one;
* ``breaker_threshold`` failed batches in a row open a breaker for
  ``breaker_cooldown_s``: new requests shed (``serving.breaker_shed``)
  until the cooldown has passed;
* a dispatch retries transient failures (``TransientFault``, raised by
  the ``device_put.transient`` site in :meth:`ModelInstance.infer`)
  through the seeded retry policy (``retry.serving_dispatch.*``).

With ``FFConfig.trace="on"`` every served request records its span tree
(``serving.request`` over ``queue_wait``, ``batch_assembly``, ``infer``
and ``reply``) on its own virtual track.

An instance over a device mesh is a group of rank processes
(``serving/group.py``): :class:`~flexflow_tpu_torch.serving.group.MeshInstance`
has :class:`ModelInstance`'s surface, so the engine batches for it as for
any instance; a dead or stuck rank fails its batch within the group's
deadline, and the next batch starts a new group. A
:class:`ModelInstance` over a model compiled on a mesh is itself
collective: every rank calls :meth:`ModelInstance.infer` with the same
batch (a group's ranks do).

Each worker's batch in hand is a watched section of the stall watchdog
(``serving.<model>.<idx>``, ``config.watchdog``), and ``stop()`` appends
one serving ledger record. An ONNX file registers through
:meth:`ModelInstance.from_onnx`, :meth:`InferenceEngine.register_onnx` and
:meth:`InferenceEngine.register_onnx_instances` (``onnx_frontend``).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import sys
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.metrics import metrics_registry
from ..obs.trace import VIRTUAL_TID_BASE, tracer
from ..obs.server import configure_obs_server
from ..obs.watchdog import _NULL as _NULL_SECTION
from ..obs.watchdog import configure_watchdog
from ..obs.watchdog import watch as _wd_watch
from ..runtime.faults import InjectedFault, TransientFault, configure_faults
from ..runtime.faults import fire as _fault_fire
from ..runtime.faults import inject as _fault_inject
from ..runtime.retry import RetryPolicy
from .errors import DeadlineExceeded, KVPoolExhausted, ShedError

# transient dispatch failures (the device_put.transient site inside
# ModelInstance.infer among them) back off briefly before the batch fails;
# a persistent error still reaches each request
_DISPATCH_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.002, max_delay_s=0.02,
                              retry_on=(TransientFault,), label="serving_dispatch",
                              seed=0)

# how long stop() waits for each worker before leaving it running
_STOP_JOIN_S = 10.0


class _PyBatcher:
    """Queue of request ids that hands out batches of at most
    ``max_batch``, with the native batcher's semantics."""

    def __init__(self, max_batch: int, timeout_s: float):
        self.max_batch = int(max_batch)
        self._timeout = float(timeout_s)
        self._q: collections.deque = collections.deque()  # (id, t_enqueued)
        self._mu = threading.Condition()
        self._closed = False

    def submit(self, request_id: int) -> None:
        with self._mu:
            if self._closed:
                # an id queued after close() would never be drained: fail
                # fast so the engine resubmits to the re-armed batcher
                raise RuntimeError("batcher is closed")
            self._q.append((request_id, time.monotonic()))
            self._mu.notify_all()

    def pending(self) -> int:
        with self._mu:
            return len(self._q)

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

    def destroy(self) -> None:
        pass


def _make_batcher(max_batch: int, timeout_s: float):
    """The native batcher, or the Python one when ``FLEXFLOW_TPU_NATIVE=off``
    chose it; a native build failure raises."""
    from .. import native_bridge

    if native_bridge.native_disabled():
        return _PyBatcher(max_batch, timeout_s)
    return native_bridge.NativeBatcher(max_batch, timeout_s)


def _canonical_device(dev: torch.device) -> torch.device:
    """``cuda`` and ``cuda:0`` name one card: placement compares devices."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


class ModelInstance:
    """One compiled inference model on one device. Requests of any count up
    to the compiled batch size are padded up and run through the forward;
    rows beyond the request count are discarded. Constructing one arms its
    config's fault plan (a serving-only process never compiles or fits
    under it)."""

    def __init__(self, ff, name: str = "model"):
        if ff.compiled is None:
            raise ValueError("compile() the FFModel before serving it")
        # a serving-only process never fits, so the served model's config
        # arms the stall monitor and the scrape surface here
        configure_watchdog(ff.config)
        configure_obs_server(ff.config)
        configure_faults(ff.config)
        self.name = name
        self._ff = ff
        self._cm = ff.compiled
        self.batch_size = self._cm.input_tensors[0].dims[0]
        self.n_inputs = len(self._cm.input_tensors)
        # (name, per-request dims) of each input, which admission checks
        self.input_shapes = [(t.name, tuple(t.dims[1:])) for t in self._cm.input_tensors]
        # forward dispatches so far (one per served batch)
        self.dispatches = 0

    @classmethod
    def from_onnx(cls, onnx_path: str, config=None, name: str = "model") -> "ModelInstance":
        """Load and compile an ONNX graph for inference, its initializers
        bound (reference: the Triton backend's own ONNX parser,
        triton/src/onnx_parser.cc; here the framework's ONNX frontend
        serves both paths). Structural rewrites are off: a merged layer has
        no mapping for the imported arrays. ``config`` is copied."""
        from ..config import FFConfig
        from ..ffconst import CompMode
        from ..onnx_frontend import ONNXModel
        from ..runtime.model import FFModel

        config = dataclasses.replace(config or FFConfig(computation_mode=CompMode.INFERENCE),
                                     enable_graph_rewrites=False)
        ff = FFModel(config)
        onnx_model = ONNXModel(onnx_path)
        onnx_model.apply(ff, onnx_model.input_tensors(ff, config.batch_size))
        ff.compile(optimizer=None, loss_type=None, metrics=[])
        onnx_model.copy_weights(ff)
        return cls(ff, name=name)

    def spec_signature(self) -> tuple:
        from .group import spec_signature

        return spec_signature(self._cm)

    def load_weights(self, weights) -> None:
        """Whole weights in op order (``group.weights_by_order``)."""
        from .group import load_weights_by_order

        load_weights_by_order(self._ff, weights)

    @property
    def devices(self) -> frozenset:
        """The devices this instance runs on: instances of one group must
        not share any."""
        return frozenset({_canonical_device(self._cm.device)})

    def infer(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Run one padded batch. ``inputs``: one array per model input,
        leading dim = request count <= batch_size. Returns per-request
        outputs (padding rows stripped) as float32 numpy arrays."""
        n = int(inputs[0].shape[0])
        if n > self.batch_size:
            raise ValueError(f"{n} requests > compiled batch {self.batch_size}")
        # fault site: a transient copy or dispatch failure, which the
        # engine's retry policy absorbs (nothing while no plan is armed)
        _fault_inject("device_put.transient", TransientFault)
        cm = self._cm
        xs = []
        for i, a in enumerate(inputs):
            a = np.asarray(a)
            if a.shape[0] < self.batch_size:
                pad = np.zeros((self.batch_size - a.shape[0],) + a.shape[1:], a.dtype)
                a = np.concatenate([a, pad], axis=0)
            # over a mesh this rank's rows (the forward returns them all)
            a = a[cm.batch_rows(i)]
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
    names it. Constructing one arms its config's fault plan."""

    def __init__(self, ff, name: str = "lm", group=None, weights=None, **scheduler_kw):
        from .generation import build_draft_model
        from .scheduler import ContinuousBatchingScheduler

        if group is not None:
            # assigned here, in the constructor: the scheduler's worker reads
            # it, and construction happens before the instance is published
            self.name, self._ff = name, None
            self.scheduler = self._group_scheduler(group, name, weights, scheduler_kw)
            return
        if ff.compiled is None:
            raise ValueError("compile() the FFModel before serving it")
        configure_watchdog(ff.config)
        configure_obs_server(ff.config)
        configure_faults(ff.config)
        cfg = ff.config
        defaults = self._defaults(cfg)
        defaults.update(scheduler_kw)
        if (defaults.get("spec_k", 0) and "draft_ff" not in defaults
                and cfg.serving_draft_model):
            defaults["draft_ff"] = str(cfg.serving_draft_model)
        if isinstance(defaults.get("draft_ff"), str):
            defaults["draft_ff"] = build_draft_model(ff, defaults["draft_ff"])
        self.name = name
        self._ff = ff
        self.scheduler = ContinuousBatchingScheduler(ff, name=name, **defaults)

    # the scheduler's knobs a generation group's ranks take (their decoder's)
    _DECODER_KNOBS = ("max_length", "decode_slots", "block_size", "num_blocks",
                      "prefill_buckets", "kv_dtype", "kv_divergence_budget")

    def _group_scheduler(self, group, name: str, weights, scheduler_kw):
        """The scheduler serving over a group of rank processes (``group``: a
        :class:`~flexflow_tpu_torch.serving.group.GroupSpec` with
        ``generator`` unset): the ranks hold the model over its mesh and
        run each step; the scheduler and the block allocator stay here.
        Speculative decoding needs a one-device generator (the draft reads
        the target's weights in place)."""
        from ..config import FFConfig
        from .group import GroupDecoder
        from .scheduler import ContinuousBatchingScheduler

        cfg = FFConfig(device="cpu", **(group.config or {}))
        configure_faults(cfg)
        defaults = self._defaults(cfg)
        defaults.update(scheduler_kw)
        if defaults.pop("spec_k", 0) or defaults.pop("draft_ff", None) is not None:
            raise ValueError(f"{name!r}: speculative decoding over a rank group is not "
                             f"supported; serve the draft pair on one device")
        knobs = {k: defaults.pop(k) for k in self._DECODER_KNOBS if k in defaults}
        return ContinuousBatchingScheduler(
            None, name=name, decoder=GroupDecoder(dataclasses.replace(group, generator=knobs),
                                                  weights),
            **defaults)

    @staticmethod
    def _defaults(cfg) -> Dict:
        """The scheduler's knobs from a config's ``serving_*`` fields."""
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
        return defaults

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
        """Stop the scheduler; a group's ranks are reaped."""
        self.scheduler.stop()
        stop_ranks = getattr(self.scheduler.decoder, "stop", None)
        if stop_ranks is not None:
            stop_ranks()


class InferenceRequest:
    """A queued request: per-input rows and a Future for the result.
    ``t_enqueue`` (``time.perf_counter``, the workers' clock) anchors its
    span tree, its queue-wait latency and its deadline."""

    __slots__ = ("inputs", "future", "request_id", "t_enqueue", "deadline_s")

    def __init__(self, request_id: int, inputs: Sequence[np.ndarray],
                 deadline_s: Optional[float] = None):
        self.request_id = request_id
        self.inputs = [np.asarray(a) for a in inputs]
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        # seconds after enqueue past which the request is rejected instead
        # of served late (None: no deadline)
        self.deadline_s = deadline_s


class InferenceEngine:
    """Serving engine: each registered model owns one dynamic batcher and
    one instance or more on disjoint devices, one worker thread each.
    Requests are single samples (the batch dim is added here). The knobs
    are the degradation bounds of the module docstring; with their
    defaults (None or 0) the engine accepts everything."""

    def __init__(self, batch_timeout_s: float = 0.005,
                 admission_limit: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 breaker_threshold: int = 0, breaker_cooldown_s: float = 1.0,
                 worker_retry_budget: int = 2):
        self.batch_timeout_s = batch_timeout_s
        self.admission_limit = int(admission_limit) if admission_limit else None
        self.default_deadline_s = float(default_deadline_s) if default_deadline_s else None
        self.breaker_threshold = max(0, int(breaker_threshold))
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.worker_retry_budget = max(0, int(worker_retry_budget))
        self._models: Dict[str, List[ModelInstance]] = {}
        self._batchers: Dict[str, object] = {}
        self._requests: Dict[str, Dict[int, InferenceRequest]] = {}
        self._workers: Dict[Tuple[str, int], threading.Thread] = {}
        # continuous-batching generation instances by name, each with its
        # own scheduler thread
        self._generators: Dict[str, GenerationInstance] = {}
        # breaker state by model: failed batches in a row, and the
        # monotonic time the open breaker closes (inf: a dead model, shed
        # until stop())
        self._consec_failures: Dict[str, int] = {}
        self._breaker_open_until: Dict[str, float] = {}
        # worker slots whose respawn budget is spent; when every slot of a
        # model is here the model is dead
        self._abandoned: set = set()
        self._ids = itertools.count()
        # guards every registry dict, the breaker state and the lifecycle
        # flags; batcher close/submit and worker joins happen outside it,
        # so a blocked thread never stalls the registry
        self._mu = threading.Lock()
        self._started = False
        # set through stop()'s close, join and re-arm: start() does nothing
        # meanwhile, so a racing infer_async cannot spawn workers that
        # stop() would then drop (its request retries into the re-armed
        # batcher, and the next infer spawns the workers that drain it)
        self._stopping = False

    # ---- model repository -------------------------------------------------
    def register(self, instance: ModelInstance) -> None:
        """Register one instance. Registrations under one name form an
        instance group: each must compute what instance 0 computes, on
        devices no other instance of the group uses."""
        with self._mu:
            if instance.name in self._generators:
                raise ValueError(
                    f"{instance.name!r} already names a generation instance: one "
                    f"name, one model")
            group = self._models.get(instance.name)
            if group:
                if instance.spec_signature() != group[0].spec_signature():
                    raise ValueError(
                        f"instance group {instance.name!r} mixes model specs "
                        f"(inputs/outputs/graph must match instance 0)")
                used = frozenset().union(*(i.devices for i in group))
                if instance.devices & used:
                    raise ValueError(
                        f"instance of {instance.name!r} overlaps devices already "
                        f"serving that model: "
                        f"{sorted(str(d) for d in instance.devices & used)}")
                group.append(instance)
            else:
                self._models[instance.name] = [instance]
                self._batchers[instance.name] = _make_batcher(
                    instance.batch_size, self.batch_timeout_s)
                self._requests[instance.name] = {}
            if self._started:
                self._spawn(instance.name)

    def register_ffmodel(self, ff, name: str = "model") -> ModelInstance:
        inst = ModelInstance(ff, name=name)
        self.register(inst)
        return inst

    def register_onnx(self, onnx_path: str, name: str = "model",
                      config=None) -> ModelInstance:
        inst = ModelInstance.from_onnx(onnx_path, config=config, name=name)
        self.register(inst)
        return inst

    def register_onnx_instances(self, onnx_path: str, name: str, devices,
                                batch_size=None) -> List:
        """One instance of an ONNX model on each placement of ``devices``
        (as :meth:`register_built_instances`), every one with the file's
        initializers: bound once on the CPU, then handed on in op order."""
        from ..config import FFConfig
        from ..ffconst import CompMode
        from ..onnx_frontend.model import ONNXBuilder
        from .group import weights_by_order

        bs = int(batch_size or FFConfig.batch_size)
        bound = ModelInstance.from_onnx(onnx_path, config=FFConfig(
            batch_size=bs, computation_mode=CompMode.INFERENCE, device="cpu"))
        return self.register_built_instances(
            ONNXBuilder(onnx_path), name=name, devices=devices, batch_size=bs,
            config={"enable_graph_rewrites": False}, weights=weights_by_order(bound._ff))

    def register_built_instances(self, build, name: str, devices,
                                 batch_size: int = 8, strategies=None,
                                 config=None, weights=None) -> List:
        """One instance of a builder-defined model on each placement of
        ``devices``: a device (or its name), compiled here, or a
        :class:`~flexflow_tpu_torch.serving.placement.MeshPlacement`, a
        group of rank processes compiled over its mesh
        (:class:`~flexflow_tpu_torch.serving.group.MeshInstance`; ``build``
        must then be importable by name). ``build(ff, batch_size)`` adds
        the graph; ``strategies`` (the per-model strategy dict) shard it
        over a placement's mesh; ``config``: further ``FFConfig`` fields.
        Every instance gets instance 0's weights, paired by op order
        (fresh builds get other op names and other init draws), or
        ``weights`` (whole, in op order) when given."""
        from ..config import FFConfig
        from ..ffconst import CompMode
        from ..runtime.model import FFModel
        from .group import GroupSpec, MeshInstance, weights_by_order
        from .placement import MeshPlacement

        out: List = []
        with self._mu:
            used = frozenset().union(*(i.devices for i in self._models.get(name, [])))
        for dev in devices:
            wanted = {_canonical_device(torch.device(d)) for d in
                      (dev.devices if isinstance(dev, MeshPlacement) else [dev])}
            if wanted & used:
                # refused before a compile or a rank group starts
                raise ValueError(f"instance of {name!r} overlaps devices already serving "
                                 f"that model: {sorted(str(d) for d in wanted & used)}")
            if isinstance(dev, MeshPlacement):
                spec = GroupSpec(build, dict(dev.mesh_shape), tuple(str(d) for d in dev.devices),
                                 int(batch_size), strategies, dict(config or {}))
                inst = MeshInstance(spec, name=name, weights=weights)
                try:
                    self.register(inst)
                except BaseException:
                    inst.stop()  # no rank outlives a refused registration
                    raise
            else:
                ff = FFModel(FFConfig(batch_size=int(batch_size),
                                      computation_mode=CompMode.INFERENCE, device=str(dev),
                                      **(config or {})))
                build(ff, int(batch_size))
                ff.compile(strategies=strategies)
                inst = ModelInstance(ff, name=name)
                if weights is not None:
                    inst.load_weights(weights)
                self.register(inst)
            if weights is None:
                weights = inst.weights if isinstance(inst, MeshInstance) else \
                    weights_by_order(inst._ff)
            out.append(inst)
        return out

    def load_repository(self, path: str, builders=None, devices=None) -> Dict[str, int]:
        """A model repository file -> placed instance groups and generators
        (``serving/placement.py``)."""
        from .placement import load_repository

        return load_repository(self, path, builders=builders, devices=devices)

    def register_generator(self, ff, name: str = "lm", **kw) -> GenerationInstance:
        """Register a continuous-batching generation instance under ``name``
        (a name no model or generator holds). The engine's degradation
        knobs are the scheduler's defaults; ``kw`` (the scheduler's knobs)
        override them and the config's ``serving_*`` defaults. With
        ``group=`` (a :class:`~flexflow_tpu_torch.serving.group.GroupSpec`)
        and ``ff`` None the model runs over a group of rank processes."""
        defaults = dict(admission_limit=self.admission_limit,
                        default_deadline_s=self.default_deadline_s,
                        breaker_threshold=self.breaker_threshold,
                        breaker_cooldown_s=self.breaker_cooldown_s,
                        worker_retry_budget=self.worker_retry_budget)
        defaults.update(kw)
        with self._mu:
            self._check_generator_name(name)
        inst = GenerationInstance(ff, name=name, **defaults)
        with self._mu:
            self._check_generator_name(name)
            self._generators[name] = inst
        return inst

    def _check_generator_name(self, name: str) -> None:
        """Caller holds ``self._mu``."""
        if name in self._models or name in self._generators:
            raise ValueError(f"{name!r} already registered (generation instances "
                             f"do not form groups: one scheduler owns the pool)")

    def generate_async(self, model: str, prompt, max_new_tokens: int, **kw) -> Future:
        """Submit one generation request to a registered generator:
        :class:`ShedError` at admission (queue bound, open breaker, a worst
        case the pool can never hold), :class:`DeadlineExceeded` on the
        future when the deadline passes first."""
        return self.generator(model).generate_async(prompt, max_new_tokens, **kw)

    def generate(self, model: str, prompt, max_new_tokens: int,
                 timeout: Optional[float] = 120.0, **kw) -> np.ndarray:
        return self.generate_async(model, prompt, max_new_tokens, **kw).result(timeout)

    def models(self) -> List[str]:
        with self._mu:
            return list(self._models)

    def instances(self, name: str) -> List[ModelInstance]:
        with self._mu:
            return list(self._models[name])

    def generators(self) -> List[str]:
        with self._mu:
            return list(self._generators)

    def generator(self, name: str) -> GenerationInstance:
        with self._mu:
            return self._generators[name]

    # ---- lifecycle ----------------------------------------------------------
    def _spawn(self, name: str) -> None:
        """Caller holds ``self._mu`` (a new worker waits on it until the
        registry change is complete)."""
        for idx in range(len(self._models[name])):
            if (name, idx) in self._workers:
                continue
            t = threading.Thread(target=self._worker_main, args=(name, idx),
                                 daemon=True, name=f"ffserve-{name}-{idx}")
            self._workers[(name, idx)] = t
            t.start()

    def _start_locked(self) -> None:
        if self._started or self._stopping:
            return
        self._started = True
        for name in self._models:
            self._spawn(name)

    def start(self) -> None:
        with self._mu:
            self._start_locked()

    def stop(self) -> None:
        """Serve every request already queued, stop the workers, and re-arm
        each model with a fresh batcher, so a later request starts them
        again. A request parked in a closed batcher after its workers left
        (a submit racing ``stop()``) fails with ``"engine stopped"``. A
        worker that does not stop within ``_STOP_JOIN_S`` is left running,
        its batcher leaked rather than freed under it. Generation instances stop first
        (their queued requests fail, their active ones finish) and are
        dropped: register again to serve."""
        with self._mu:
            workers = dict(self._workers)
            batchers = dict(self._batchers)
            generators = dict(self._generators)
            self._generators = {}
            # the first registered model's config gates the session's
            # ledger record (ledger="off" disables every append)
            first = next(iter(self._models.values()), None)
            ledger_cfg = (getattr(getattr(first[0], "_ff", None), "config", None)
                          if first else None)
            self._started = False
            self._stopping = True
        # generation schedulers stop first, each writing its own record
        for g in generators.values():
            g.stop()
        for b in batchers.values():
            b.close()
        still_alive = set()
        for (name, _idx), t in workers.items():
            t.join(timeout=_STOP_JOIN_S)
            if t.is_alive():
                still_alive.add(name)
        # the workers that left drained their batchers; ids a racing submit
        # parked after that are collected here and failed below, never left
        # to hang (next_batch does not block on a closed batcher)
        leftover: Dict[str, List[int]] = {}
        for name, b in batchers.items():
            if name in still_alive:
                continue
            ids: List[int] = []
            while True:
                batch = b.next_batch()
                if not batch:
                    break
                ids.extend(batch)
            if ids:
                leftover[name] = ids
        with self._mu:
            for key in workers:
                self._workers.pop(key, None)
            for name, b in batchers.items():
                if name not in still_alive:
                    for i in leftover.get(name, ()):
                        req = self._requests[name].pop(i, None)
                        if req is not None and not req.future.done():
                            req.future.set_exception(RuntimeError("engine stopped"))
                    b.destroy()
                self._batchers[name] = _make_batcher(
                    self._models[name][0].batch_size, self.batch_timeout_s)
            groups = [i for insts in self._models.values() for i in insts
                      if hasattr(i, "stop")]
            # a stopped engine is a clean slate: a restart probes again
            self._abandoned.clear()
            self._breaker_open_until.clear()
            self._consec_failures.clear()
            self._stopping = False
        # every rank of an instance over a mesh is reaped; its next batch
        # starts a new group
        for inst in groups:
            inst.stop()
        # one ledger record a classic serving session (counters and latency
        # percentiles; never raises, ledger.errors counts)
        if batchers:
            from ..obs.ledger import record_serving

            record_serving({"models": sorted(batchers)}, config=ledger_cfg)

    # ---- request path -------------------------------------------------------
    def infer_async(self, model: str, inputs: Sequence[np.ndarray],
                    deadline_s: Optional[float] = None) -> Future:
        """Submit one request (arrays without the batch dim). The future
        resolves to the model's per-request output array. Raises
        :class:`ShedError` when the queue is at ``admission_limit`` or the
        model's breaker is open; ``deadline_s`` (default: the engine's
        ``default_deadline_s``) rejects the request with
        :class:`DeadlineExceeded` if no worker picks it up in time."""
        with self._mu:
            self._start_locked()
            inst = self._models[model][0]  # a group's instances share the spec
            until = self._breaker_open_until.get(model, 0.0)
            breaker_open = False
            if until:
                if time.monotonic() < until:
                    breaker_open = True
                else:  # the cooldown passed: close the breaker, let traffic probe
                    self._breaker_open_until.pop(model, None)
                    self._consec_failures[model] = 0
        reg = metrics_registry()
        if breaker_open:
            reg.counter("serving.breaker_shed").inc()
            reg.counter("serving.shed").inc()
            raise ShedError(
                f"{model!r}: failure breaker is open ({self.breaker_threshold} "
                f"consecutive batch failures); shedding until the cooldown elapses")
        if self.admission_limit is not None:
            # pending() takes the batcher's own lock, never _mu: two racing
            # submits may both pass at limit - 1, and the queue stays bounded
            with self._mu:
                batcher0 = self._batchers[model]
            if batcher0.pending() >= self.admission_limit:
                reg.counter("serving.shed").inc()
                raise ShedError(f"{model!r}: admission queue at its bound "
                                f"({self.admission_limit}); shedding")
        # validate per-request shapes HERE so one malformed request fails
        # alone instead of poisoning every co-batched request
        if len(inputs) != inst.n_inputs:
            raise ValueError(f"{model!r} takes {inst.n_inputs} inputs, got {len(inputs)}")
        for a, (in_name, want) in zip(inputs, inst.input_shapes):
            if tuple(np.shape(a)) != want:
                raise ValueError(
                    f"{model!r} input {in_name!r}: expected per-request shape "
                    f"{want}, got {np.shape(a)}")
        # the deadline is coerced here, so a malformed one fails the caller
        # and never a worker with a batch in hand
        req = InferenceRequest(
            next(self._ids), [np.asarray(a)[None, ...] for a in inputs],
            deadline_s=(float(deadline_s) if deadline_s is not None
                        else self.default_deadline_s))
        for _ in range(64):
            with self._mu:
                batcher = self._batchers[model]
                self._requests[model][req.request_id] = req
            try:
                batcher.submit(req.request_id)
                break
            except RuntimeError:
                # a concurrent stop() closed this batcher after the read
                # above: unregister and retry into the re-armed one
                with self._mu:
                    self._requests[model].pop(req.request_id, None)
                time.sleep(0.005)
        else:
            raise RuntimeError(f"{model!r}: batcher stayed closed across retries "
                               f"(engine is shutting down?)")
        # the submit may have landed in a batcher re-armed by a concurrent
        # stop(), which leaves the engine stopped: spawn the workers that
        # drain it (nothing to do when already started)
        self.start()
        reg.counter("serving.requests").inc()
        reg.histogram("serving.queue_depth").observe(batcher.pending())
        return req.future

    def infer(self, model: str, inputs: Sequence[np.ndarray],
              timeout: Optional[float] = 60.0) -> np.ndarray:
        return self.infer_async(model, inputs).result(timeout)

    # ---- worker -------------------------------------------------------------
    def _worker_main(self, name: str, idx: int = 0) -> None:
        """Respawn supervisor: run the drain loop again after a crash, up to
        ``worker_retry_budget`` times. A closed batcher ends the thread; a
        crash past the budget abandons the slot loudly (counted, printed)
        and the group's other workers keep serving."""
        reg = metrics_registry()
        for crashes in range(self.worker_retry_budget + 1):
            try:
                self._worker(name, idx)
                return  # batcher closed: normal shutdown
            except Exception as e:  # noqa: BLE001 — the drain loop died
                reg.counter("serving.worker_crashes").inc()
                if crashes >= self.worker_retry_budget:
                    reg.counter("serving.worker_abandoned").inc()
                    print(f"[serving] worker {name}/{idx} crashed {crashes + 1}x "
                          f"({type(e).__name__}: {e}); respawn budget exhausted, "
                          f"abandoning", file=sys.stderr, flush=True)
                    self._abandon(name, idx)
                    return
                reg.counter("serving.worker_respawns").inc()
                print(f"[serving] worker {name}/{idx} crashed ({type(e).__name__}: "
                      f"{e}); respawning ({crashes + 1}/{self.worker_retry_budget})",
                      file=sys.stderr, flush=True)

    def _abandon(self, name: str, idx: int) -> None:
        """A slot spent its budget. When it was the model's last worker no
        one will drain the queue: every pending future fails (accepted
        futures always resolve) and the breaker stays open, so admission
        sheds. ``stop()`` clears that state."""
        with self._mu:
            self._abandoned.add((name, idx))
            group = self._models.get(name) or []
            dead = all((name, i) in self._abandoned for i in range(len(group)))
            pending: List[InferenceRequest] = []
            if dead:
                self._breaker_open_until[name] = float("inf")
                pending = list(self._requests[name].values())
                self._requests[name].clear()
        if not pending:
            return
        metrics_registry().counter("serving.abandoned_failed").inc(len(pending))
        err = RuntimeError(f"{name!r}: all workers exhausted their respawn budget; "
                           f"request failed (engine sheds until stop()/restart)")
        for r in pending:
            if not r.future.done():
                r.future.set_exception(err)

    def _requeue(self, name: str, ids: List[int]) -> None:
        """Put a crashing worker's batch back on the queue, so its futures
        resolve through the respawned worker. A batcher closed by a
        concurrent stop() refuses; those futures fail here."""
        with self._mu:
            batcher = self._batchers[name]
        for i in ids:
            try:
                batcher.submit(i)
            except RuntimeError:
                with self._mu:
                    req = self._requests[name].pop(i, None)
                if req is not None and not req.future.done():
                    req.future.set_exception(RuntimeError("engine stopped during respawn"))

    def _worker(self, name: str, idx: int = 0) -> None:
        with self._mu:
            inst = self._models[name][idx]
            batcher = self._batchers[name]
        reg = metrics_registry()
        first_batch = True
        while True:
            ids = batcher.next_batch()
            if ids is None:
                return
            # fault site: a worker crash with a batch in hand, which is
            # requeued first so its futures resolve through the respawn
            rule = _fault_fire("serving.worker")
            if rule is not None:
                self._requeue(name, ids)
                raise InjectedFault(f"injected fault at site 'serving.worker' ({rule})")
            with self._mu:
                reqs = [self._requests[name].pop(i) for i in ids
                        if i in self._requests[name]]
            if not reqs:
                continue
            t_pickup = time.perf_counter()
            # the watchdog watches a batch in hand, not the idle wait for
            # one; the first batch runs unwatched (its kernels' first
            # launch, and on a group its ranks' start, is not a stall)
            section = _NULL_SECTION if first_batch else _wd_watch(f"serving.{name}.{idx}")
            first_batch = False
            section.__enter__()
            try:
                # from the pop above to set_result below, any failure must
                # resolve the popped futures (the except arm does): they can
                # never be delivered again
                expired = [r for r in reqs if r.deadline_s is not None
                           and t_pickup - r.t_enqueue > r.deadline_s]
                for r in expired:
                    reg.counter("serving.deadline_rejects").inc()
                    if not r.future.done():
                        r.future.set_exception(DeadlineExceeded(
                            f"request {r.request_id} waited {t_pickup - r.t_enqueue:.3f}s "
                            f"> deadline {r.deadline_s:.3f}s"))
                if expired:
                    reqs = [r for r in reqs if r not in expired]
                if not reqs:
                    continue
                stacked = [np.concatenate([r.inputs[k] for r in reqs], axis=0)
                           for k in range(inst.n_inputs)]
                t_assembled = time.perf_counter()
                outs = _DISPATCH_RETRY.call(inst.infer, stacked)[0]
                t_infer = time.perf_counter()
                row = 0
                ends = []
                for r in reqs:
                    cnt = r.inputs[0].shape[0]
                    r.future.set_result(outs[row:row + cnt][0] if cnt == 1
                                        else outs[row:row + cnt])
                    row += cnt
                    ends.append(time.perf_counter())
                reg.counter("serving.batches").inc()
                reg.histogram("serving.batch_size").observe(row)
                reg.histogram("serving.infer_s").observe(t_infer - t_assembled)
                for r, t_end in zip(reqs, ends):
                    reg.histogram("serving.queue_wait_s").observe(t_pickup - r.t_enqueue)
                    reg.histogram("serving.e2e_s").observe(t_end - r.t_enqueue)
                self._record_request_spans(name, reqs, t_pickup, t_assembled, t_infer,
                                           ends)
                if self.breaker_threshold:
                    with self._mu:  # a served batch ends the failure streak
                        self._consec_failures[name] = 0
            except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
                reg.counter("serving.errors").inc()
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                if self.breaker_threshold:
                    with self._mu:
                        n = self._consec_failures.get(name, 0) + 1
                        self._consec_failures[name] = n
                        # on the transition only: failures draining behind
                        # an open breaker must not extend its cooldown
                        if n == self.breaker_threshold:
                            self._breaker_open_until[name] = (
                                time.monotonic() + self.breaker_cooldown_s)
                    if n == self.breaker_threshold:
                        reg.counter("serving.breaker_opens").inc()
            finally:
                section.__exit__(None, None, None)

    @staticmethod
    def _record_request_spans(model: str, reqs, t_pickup, t_assembled, t_infer,
                              ends) -> None:
        """One span tree a request, each on its own virtual track
        (``VIRTUAL_TID_BASE + request_id``), so concurrent requests never
        partially overlap: ``serving.request`` over ``queue_wait`` ->
        ``batch_assembly`` -> ``infer`` -> ``reply``. The batch's phases
        repeat in every member's tree."""
        tr = tracer()
        if not tr.enabled:
            return
        for r, t_end in zip(reqs, ends):
            tid = VIRTUAL_TID_BASE + r.request_id
            tr.complete("serving.request", r.t_enqueue, t_end - r.t_enqueue,
                        cat="serving", tid=tid,
                        args={"model": model, "request_id": r.request_id})
            tr.complete("serving.queue_wait", r.t_enqueue, t_pickup - r.t_enqueue,
                        cat="serving", tid=tid)
            tr.complete("serving.batch_assembly", t_pickup, t_assembled - t_pickup,
                        cat="serving", tid=tid)
            tr.complete("serving.infer", t_assembled, t_infer - t_assembled,
                        cat="serving", tid=tid)
            tr.complete("serving.reply", t_infer, t_end - t_infer, cat="serving",
                        tid=tid)


__all__ = ["DeadlineExceeded", "GenerationInstance", "InferenceEngine", "InferenceRequest",
           "KVPoolExhausted", "ModelInstance", "ShedError"]
