"""An inference instance over a device mesh: a group of rank processes.

The JAX package serves an instance over a submesh as one program over its
devices in one process (``serving/placement.py`` carves the submesh). The
port runs one process a rank (SPMD over ``torch.distributed``), so an
instance over a mesh is a group of rank processes that the engine drives.
The engine is no rank: it steers the ranks over queues.

* **start**: the engine spawns one process a rank (the ``spawn`` start
  method), each with its own request queue and one shared reply queue. The
  ranks join a process group of their own (a file rendezvous in a fresh
  temporary directory; ``nccl`` when every rank has a card of its own,
  ``gloo`` on the CPU and when ranks share a card), build the model with
  ``builder(ff, batch_size)`` (a function importable by name), compile it
  over ``mesh_shape`` with the strategies, load the weights they were
  handed (whole arrays in op order; each rank keeps its blocks) and reply
  ready. Rank 0's reply carries the model's signature, its whole weights
  and, for a generator, its decoder's geometry.
* **dispatch**: the engine puts ``(seq, method, args)`` on every rank's
  queue; every rank runs the method (``ModelInstance.infer``, a
  ``PagedDecoder`` step, a weight load, or the ranks' kernel launch
  counts) with its collectives, and rank 0 replies with the result. A rank that raises replies with its traceback and exits.
* **failure**: while it waits for rank 0's reply the engine polls every
  rank's process. A rank that died, an error reply, or no reply within the
  dispatch deadline fails the dispatch with :class:`GroupFailure` and
  kills the whole group; the process group's own timeout is
  ``group_timeout_s`` (30 s by default, well under
  ``distributed.TIMEOUT_S``), so no rank waits in a collective for long
  either. The next dispatch starts a new group with the weights of the
  last (counted on ``serving.group_restarts``).
* **stop**: every rank gets a stop message; the engine joins them and
  kills whatever is left, so no rank outlives :meth:`RankGroup.close`.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.metrics import metrics_registry

# how long a rank's collective may wait on a peer; a dispatch's default
# deadline; how long the ranks may take to start, build and compile
GROUP_TIMEOUT_S = 30.0
DISPATCH_TIMEOUT_S = 60.0
STARTUP_TIMEOUT_S = 900.0


class GroupFailure(RuntimeError):
    """A rank group failed a dispatch: a rank died, raised, or the group
    gave no answer within the deadline. The group is killed; the next
    dispatch starts a new one."""


@dataclasses.dataclass
class GroupSpec:
    """What every rank of a group builds. ``builder(ff, batch_size)`` adds
    the graph (importable by name: the ranks unpickle it); ``devices``:
    one device name a rank, in rank order; ``config``: further
    ``FFConfig`` fields (``compute_dtype``, ``seed``); ``generator``: the
    ``PagedDecoder`` knobs of a generation group (None: a classic
    instance)."""

    builder: Callable
    mesh_shape: Dict[str, int]
    devices: Tuple[str, ...]
    batch_size: int
    strategies: Optional[Dict[str, Dict[str, str]]] = None
    config: Optional[Dict[str, Any]] = None
    generator: Optional[Dict[str, Any]] = None

    @property
    def world(self) -> int:
        return len(self.devices)

    def backend(self) -> str:
        """``nccl`` when every rank has a card of its own, else ``gloo``."""
        devs = [torch.device(d) for d in self.devices]
        if all(d.type == "cuda" for d in devs) and \
                len({d.index or 0 for d in devs}) == len(devs):
            return "nccl"
        return "gloo"


def weights_by_order(ff) -> List[Dict[str, np.ndarray]]:
    """The whole weights of every op that has any, in op order (a
    collective over a mesh: every rank calls it)."""
    params = ff.numpy_params()
    return [params[op.name] for op in ff.compiled.ops if op.name in params]


def load_weights_by_order(ff, weights: Sequence[Dict[str, np.ndarray]]) -> None:
    """Copy whole weights in op order into a compiled model (each rank its
    blocks): a second build of one model gets other op names, the same
    order."""
    from ..runtime.model import load_numpy_params

    names = [op.name for op in ff.compiled.ops if op.name in ff.compiled.params]
    if len(names) != len(weights):
        raise ValueError(f"{len(weights)} weighted ops given, the model has {len(names)}")
    load_numpy_params(ff, dict(zip(names, weights)))
    ff.compiled.bump_params_version()


def spec_signature(cm) -> tuple:
    """What a compiled model computes: batch, inputs, output and the op
    types and shapes in order (not op names: a second build of one model
    gets other names and is the same function)."""
    return (cm.input_tensors[0].dims[0], len(cm.input_tensors),
            tuple((tuple(t.dims), t.dtype) for t in cm.input_tensors),
            tuple(cm.logits_tensor.dims),
            tuple((o.op_type, tuple(tuple(t.dims) for t in o.layer.outputs))
                  for o in cm.ops))


class _Target:
    """A rank's end of the protocol: the methods a dispatch may name."""

    def __init__(self, ff, spec: GroupSpec):
        from .engine import ModelInstance
        from .generation import PagedDecoder

        self.ff = ff
        if spec.generator is None:
            self.instance = ModelInstance(ff, name="rank")
            self.decoder = None
        else:
            from .scheduler import _position_capacity

            knobs = dict(spec.generator)
            max_length = knobs.pop("max_length", None) or _position_capacity(ff)
            self.decoder = PagedDecoder(ff, max_length, **knobs)

    def infer(self, inputs):
        return self.instance.infer(inputs)

    def prefill_many(self, prompts, tables):
        return self.decoder.prefill_many(prompts, tables)

    def decode(self, tokens, tables, seq_lens):
        return self.decoder.decode(tokens, tables, seq_lens)

    def verify(self, tokens, tables, seq_lens):
        return self.decoder.verify(tokens, tables, seq_lens)

    def load_weights(self, weights):
        load_weights_by_order(self.ff, weights)

    def launch_counts(self, reset: bool = False) -> list:
        """Every rank's kernel launch counts, in rank order (collective);
        zeroed after the read with ``reset``."""
        from .. import kernels
        from ..parallel.collectives import all_gather_objects

        counts = all_gather_objects(kernels.launch_counts())
        if reset:
            kernels.reset_launch_counts()
        return counts

    def info(self) -> Dict[str, Any]:
        cm = self.ff.compiled
        out = {"signature": spec_signature(cm),
               "input_shapes": [(t.name, tuple(t.dims[1:])) for t in cm.input_tensors]}
        d = self.decoder
        if d is not None:
            out["decoder"] = dict(
                decode_slots=d.decode_slots, block_size=d.block_size, max_length=d.max_length,
                max_blocks_per_request=d.max_blocks_per_request,
                prefill_buckets=list(d.prefill_buckets), kv_dtype=d.kv_dtype,
                kv_divergence=d.kv_divergence, kv_divergence_budget=d.kv_divergence_budget,
                kv_quant_report=d.kv_quant_report, num_blocks=d.pool.num_blocks,
                pool_bytes=d.pool.memory_bytes())
        return out


def _rank_main(rank: int, spec: GroupSpec, init_file: str, weights, inq, outq,
               group_timeout_s: float) -> None:
    """One rank: join the group, build, compile, serve dispatches until a
    stop message; any failure replies with its traceback and exits."""
    try:
        import torch.distributed as dist

        from ..config import FFConfig
        from ..ffconst import CompMode
        from ..parallel.distributed import init_process_group
        from ..runtime.model import FFModel

        dev = torch.device(spec.devices[rank])
        if dev.type != "cuda":
            torch.set_num_threads(1)
        init_process_group(rank, spec.world, f"file://{init_file}", spec.world,
                           backend=spec.backend(), timeout_s=group_timeout_s)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        ff = FFModel(FFConfig(batch_size=spec.batch_size, computation_mode=CompMode.INFERENCE,
                              device=str(dev), mesh_shape=dict(spec.mesh_shape),
                              **(spec.config or {})))
        spec.builder(ff, spec.batch_size)
        ff.compile(strategies=spec.strategies)
        if weights is not None:
            load_weights_by_order(ff, weights)
        target = _Target(ff, spec)
        whole = weights_by_order(ff)  # collective: every rank gathers
        info = target.info()
        outq.put((rank, "ready", dict(info, weights=whole) if rank == 0 else None))
        del whole
        while True:
            msg = inq.get()
            if msg is None:
                break
            seq, method, args = msg
            value = getattr(target, method)(*args)
            if rank == 0:
                outq.put((rank, seq, value))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — the traceback is the reply
        outq.put((rank, "error", traceback.format_exc()))
        outq.close()
        outq.join_thread()
        os._exit(1)
    outq.close()
    outq.join_thread()
    # skip the interpreter's teardown, where a process group's C++
    # threads were seen to abort (as parallel/distributed.spawn does)
    os._exit(0)


class RankGroup:
    """The engine's end of one group of rank processes (see the module
    docstring for the protocol)."""

    def __init__(self, spec: GroupSpec, weights=None,
                 dispatch_timeout_s: float = DISPATCH_TIMEOUT_S,
                 group_timeout_s: float = GROUP_TIMEOUT_S):
        self.spec = spec
        self.weights = weights
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self.group_timeout_s = float(group_timeout_s)
        self.info: Optional[Dict[str, Any]] = None
        self._procs: List[Any] = []
        self._inqs: List[Any] = []
        self._outq = None
        self._tmp: Optional[str] = None
        self._seq = 0

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def start(self) -> "RankGroup":
        """Spawn the ranks and wait until every one is ready; rank 0's
        whole weights become :attr:`weights`."""
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="ff_group_")
        self._outq = ctx.Queue()
        self._inqs = [ctx.Queue() for _ in range(self.spec.world)]
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, self.spec, os.path.join(self._tmp, "init"),
                                         self.weights, self._inqs[r], self._outq,
                                         self.group_timeout_s))
                       for r in range(self.spec.world)]
        for p in self._procs:
            p.start()
        ready = set()
        deadline = time.monotonic() + STARTUP_TIMEOUT_S
        try:
            while len(ready) < self.spec.world:
                rank, tag, value = self._next_reply(deadline, "start")
                if tag == "ready":
                    ready.add(rank)
                    if rank == 0:
                        self.weights = value.pop("weights")
                        self.info = value
        except GroupFailure:
            self.close(graceful=False)
            raise
        return self

    def _next_reply(self, deadline: float, what: str) -> tuple:
        """The next reply, polling the ranks' processes; a rank that died
        or raised, or the deadline, is a :class:`GroupFailure`."""
        while True:
            try:
                rank, tag, value = self._outq.get(timeout=0.05)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                if dead:
                    raise GroupFailure(
                        f"rank {dead[0]} of the group exited with code "
                        f"{self._procs[dead[0]].exitcode} during {what}")
                if time.monotonic() >= deadline:
                    raise GroupFailure(f"the group gave no answer to {what} in time")
                continue
            if tag == "error":
                raise GroupFailure(f"rank {rank} failed during {what}:\n{value}")
            return rank, tag, value

    def call(self, method: str, *args, timeout: Optional[float] = None):
        """Run ``method(*args)`` on every rank; rank 0's result. Any
        failure kills the group and raises :class:`GroupFailure`."""
        if not self.alive:
            raise GroupFailure("the group is not running")
        self._seq += 1
        seq = self._seq
        for q in self._inqs:
            q.put((seq, method, args))
        deadline = time.monotonic() + (self.dispatch_timeout_s if timeout is None else timeout)
        try:
            while True:
                _, tag, value = self._next_reply(deadline, method)
                if tag == seq:
                    return value
        except GroupFailure:
            self.close(graceful=False)
            raise

    def close(self, graceful: bool = True) -> None:
        """Stop every rank (a stop message first when ``graceful``), then
        kill what is left and remove the rendezvous directory."""
        if graceful:
            for q, p in zip(self._inqs, self._procs):
                if p.is_alive():
                    q.put(None)
            deadline = time.monotonic() + 10.0
            for p in self._procs:
                p.join(timeout=max(0.1, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
        for q in self._inqs + ([self._outq] if self._outq is not None else []):
            q.close()
            q.cancel_join_thread()
        self._procs, self._inqs, self._outq = [], [], None
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None


class _GroupClient:
    """The engine's hold on a :class:`RankGroup`: every call goes through
    :meth:`_call`, which first replaces a group that a failure killed by a
    new one with its spec, weights and timeouts (counted on
    :attr:`restarts` and ``serving.group_restarts``)."""

    group: RankGroup
    restarts: int

    def _call(self, method: str, *args):
        g = self.group
        if not g.alive:
            g.close(graceful=False)
            metrics_registry().counter("serving.group_restarts").inc()
            self.group = RankGroup(g.spec, g.weights, g.dispatch_timeout_s,
                                   g.group_timeout_s).start()
            self.restarts += 1
        return self.group.call(method, *args)

    def load_weights(self, weights: Sequence[Dict[str, np.ndarray]]) -> None:
        """Whole weights in op order into every rank (and into every group
        a restart starts)."""
        self._call("load_weights", list(weights))
        self.group.weights = list(weights)

    def stop(self) -> None:
        """Reap every rank; a later call starts a new group."""
        self.group.close()


class MeshInstance(_GroupClient):
    """A classic instance over a mesh: the engine-side face of a
    :class:`RankGroup`, with :class:`~flexflow_tpu_torch.serving.engine.ModelInstance`'s
    surface. A failed dispatch raises :class:`GroupFailure` (the engine
    fails that batch and counts it toward its breaker); the next dispatch
    starts a new group with the same weights."""

    def __init__(self, spec: GroupSpec, name: str = "model", weights=None,
                 dispatch_timeout_s: float = DISPATCH_TIMEOUT_S,
                 group_timeout_s: float = GROUP_TIMEOUT_S):
        self.name = name
        self.spec = spec
        self.group = RankGroup(spec, weights, dispatch_timeout_s, group_timeout_s).start()
        info = self.group.info
        self._signature = info["signature"]
        self.input_shapes = info["input_shapes"]
        self.batch_size = self._signature[0]
        self.n_inputs = self._signature[1]
        self.dispatches = 0
        self.restarts = 0

    @property
    def devices(self) -> frozenset:
        from .engine import _canonical_device

        return frozenset(_canonical_device(torch.device(d)) for d in self.spec.devices)

    @property
    def weights(self):
        return self.group.weights

    def spec_signature(self) -> tuple:
        return self._signature

    def infer(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        n = int(np.asarray(inputs[0]).shape[0])
        if n > self.batch_size:
            raise ValueError(f"{n} requests > compiled batch {self.batch_size}")
        out = self._call("infer", [np.asarray(a) for a in inputs])
        self.dispatches += 1
        return out


class GroupDecoder(_GroupClient):
    """A generation group's engine-side decoder: the scheduler's surface of
    :class:`~flexflow_tpu_torch.serving.generation.PagedDecoder`, its steps
    run by the ranks (each holding its heads' arenas) and its block
    allocator here (the ranks read the tables each step hands them)."""

    def __init__(self, spec: GroupSpec, weights=None,
                 dispatch_timeout_s: float = DISPATCH_TIMEOUT_S,
                 group_timeout_s: float = GROUP_TIMEOUT_S):
        from .kv_cache import PagedKVPool

        self.spec = spec
        self.group = RankGroup(spec, weights, dispatch_timeout_s, group_timeout_s).start()
        d = self.group.info["decoder"]
        self.decode_slots = d["decode_slots"]
        self.block_size = d["block_size"]
        self.max_length = d["max_length"]
        self.max_blocks_per_request = d["max_blocks_per_request"]
        self.prefill_buckets = list(d["prefill_buckets"])
        self.kv_dtype = d["kv_dtype"]
        self.kv_divergence = d["kv_divergence"]
        self.kv_divergence_budget = d["kv_divergence_budget"]
        self.kv_quant_report = d["kv_quant_report"]
        self.rank_pool_bytes = d["pool_bytes"]
        # the allocator only: no arena lives in this process
        self.pool = PagedKVPool({}, num_blocks=d["num_blocks"], block_size=self.block_size,
                                max_blocks_per_request=self.max_blocks_per_request,
                                kv_dtype=self.kv_dtype, device="cpu")
        self.decode_steps = 0
        self.decode_dispatches = 0
        self.restarts = 0

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds the largest prefill "
                         f"bucket {self.prefill_buckets[-1]}")

    def prefill_many(self, prompts, tables) -> np.ndarray:
        return self._call("prefill_many", [np.asarray(p) for p in prompts],
                          [np.asarray(t) for t in tables])

    def decode(self, tokens, tables, seq_lens) -> np.ndarray:
        self.decode_steps += 1
        self.decode_dispatches += 1
        return self._call("decode", np.asarray(tokens), np.asarray(tables),
                          np.asarray(seq_lens))

    def verify(self, tokens, tables, seq_lens) -> np.ndarray:
        self.decode_steps += 1
        self.decode_dispatches += 1
        return self._call("verify", np.asarray(tokens), np.asarray(tables),
                          np.asarray(seq_lens))


__all__ = ["GroupDecoder", "GroupFailure", "GroupSpec", "MeshInstance", "RankGroup",
           "load_weights_by_order", "spec_signature", "weights_by_order"]
