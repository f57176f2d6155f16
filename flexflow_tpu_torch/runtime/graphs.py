"""CUDA-graph capture of the compiled step programs.

The JAX package compiles each step into one program: ``jax.jit`` of
``train_step``/``train_k_steps`` with the params and optimizer state
donated, of ``grad_step``, ``eval_step`` and ``forward_fn``
(``flexflow_tpu/runtime/compiler.py``), of the ``Generator``'s block step
and of the ``PagedDecoder``'s decode, prefill and verify steps
(``flexflow_tpu/serving/generation.py``), one executable per static
signature. The port's counterpart is a CUDA graph per step and per key:

* the first call at a new key runs eagerly on a side stream and does the
  step's real work (the warm-up whole-network capture needs);
* the next call at that key captures the step once into a graph, from
  static input buffers, then replays it;
* every later call copies its inputs into the static buffers and replays.

The key holds what JAX takes as static: the step kind, each input's shape
and dtype and the step's static arguments (``seq_length``,
``plain_kernels``, the compute dtype). The tensors a step reads and
writes in place (params, optimizer state, KV caches, the optimizer's
device hyperparameters: the *bound* tensors) are captured by address, so
an entry is valid for the addresses it was captured with: a call whose
bound tensors live elsewhere captures the key again. Updating them in
place (``load_numpy_params``, a guard rollback, a checkpoint restore)
keeps the graph valid. Integer arguments (a dropout key, a decode offset)
are 0-d int64 buffers filled before each replay.

A replay's static outputs are overwritten by the next replay of any graph
of the pool, which is what donation does in JAX: :meth:`StepGraphs.run`
therefore returns device copies of them, so a caller may keep a step's
loss, metrics or logits. Every graph of one compiled model shares one
memory pool; :meth:`StepGraphs.stats` reports each graph's capture time,
the bytes its capture added to the pool, its replays and the kernel
launches each replay makes (``kernels.capture_launches``).

What is captured is decided at compile time by :func:`capture_rule`, and
a capture that fails raises :class:`GraphCaptureError` naming the step
and the key: nothing falls back to eager. Captures run one at a time in
the process (models served side by side may reach theirs together);
replays and eager calls on other threads go on meanwhile.

A second count of a replay's launches, read from the graphs themselves
rather than from the wrappers: after :func:`keep_graphs_for_print`, each
graph captured keeps its node list, and :meth:`StepGraphs.kernel_nodes`
counts the kernel nodes of each graph by kernel in CUDA's DOT print of it.
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
import time
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .. import kernels


class GraphCaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


# one capture at a time in the process: each starts from an idle card
# (torch.cuda.graph synchronizes and empties the allocator's cache) and
# reads its own growth of the pool
_CAPTURE_LOCK = threading.Lock()
# graphs captured from now on keep their node list for the DOT print
_keep_for_print = False


def keep_graphs_for_print() -> None:
    """Make every graph captured from now on in this process keep its node
    list (``CUDAGraph(keep_graph=True)``, instantiated at once), so that
    :meth:`StepGraphs.kernel_nodes` can print it. Costs host memory only."""
    global _keep_for_print
    _keep_for_print = True


def count_kernel_nodes(dot: str) -> Dict[str, int]:
    """{kernel: nodes} of a graph's DOT print (``cudaGraphDebugDotPrint``):
    a node counts for the kernel whose symbol its text names
    (:data:`kernels.KERNEL_SYMBOLS`). Also ``"nodes"``, every node, and
    ``"kernel_nodes"``, the nodes of type KERNEL."""
    counts = dict.fromkeys(kernels.KERNELS, 0)
    nodes = kernel_nodes = 0
    for chunk in re.split(r'\n(?=\s*"?[\w.]+"?\s*\[)', dot):
        head = chunk.lstrip().split("[", 1)[0]
        if "node" not in head:
            continue
        nodes += 1
        kernel_nodes += "KERNEL" in chunk
        for name, test in kernels.KERNEL_SYMBOLS.items():
            if test(chunk):
                counts[name] += 1
                break
    return dict(counts, nodes=nodes, kernel_nodes=kernel_nodes)


def graph_kernel_nodes(graph: "torch.cuda.CUDAGraph") -> Dict[str, int]:
    """:func:`count_kernel_nodes` of a graph captured after
    :func:`keep_graphs_for_print`."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the print's own DEBUG notices
            graph.debug_dump(path)
        if not os.path.exists(path):
            raise RuntimeError("the graph kept no node list to print: call "
                               "keep_graphs_for_print() before its capture")
        with open(path, encoding="utf-8", errors="replace") as f:
            return count_kernel_nodes(f.read())


def capture_rule(device: torch.device, mesh=None) -> Tuple[bool, str]:
    """(captured, reason): whether a compiled model's steps go through CUDA
    graphs. One CUDA device is captured; a mesh (a pipeline runs on one)
    stays eager, because its collectives go through gloo, which stages
    through the host; the CPU runs eagerly. The ``plain_kernels=True``
    reference path stays eager at every call."""
    if torch.device(device).type != "cuda":
        return False, f"device {device}: steps run eagerly on the host"
    if mesh is not None:
        return False, (f"mesh {dict(mesh.shape)}: its collectives go through gloo, "
                       f"staged through the host, so the steps stay eager")
    return True, "one CUDA device: each step is captured once per key and replayed"


def graph_key(kind: str, args: Sequence[Any], **static: Any) -> tuple:
    """The capture key of a call: its kind, each argument's (shape, dtype)
    (an int argument counts as a 0-d int64 tensor, ``None`` as absent)
    and the static arguments by name."""
    sig = []
    for a in args:
        if a is None:
            sig.append(None)
        elif isinstance(a, torch.Tensor):
            sig.append((tuple(a.shape), str(a.dtype)))
        else:
            sig.append(((), "int"))
    return (kind, tuple(sig), tuple(sorted((k, str(v)) for k, v in static.items())))


def tensor_leaves(*trees: Any) -> List[torch.Tensor]:
    """The tensors of nested dicts, lists and tuples, in order."""
    out: List[torch.Tensor] = []

    def walk(node: Any) -> None:
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    for t in trees:
        walk(t)
    return out


def clone_tree(tree: Any) -> Any:
    """Device copies of a tree's tensors (other leaves as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


class _Entry:
    __slots__ = ("graph", "static_in", "static_out", "bound", "launches", "nbytes",
                 "capture_s", "replays", "nodes")

    def __init__(self, graph, static_in, static_out, bound, launches, nbytes, capture_s):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.bound = bound
        self.launches = launches
        self.nbytes = nbytes
        self.capture_s = capture_s
        self.replays = 0
        self.nodes: Optional[Dict[str, int]] = None


class StepGraphs:
    """The capture cache of one compiled model (see the module docstring):
    static input buffers, one graph per key and its static outputs, one
    memory pool. Thread-safe: a call's copies, replay and output copies
    run under one lock."""

    def __init__(self, device: torch.device, label: str = "model"):
        self.device = torch.device(device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.label = label
        self._lock = threading.RLock()
        self._entries: Dict[tuple, _Entry] = {}
        self._warm: set = set()
        self._pool = None
        self._side: Optional[torch.cuda.Stream] = None
        self.captures = 0
        self.eager_calls = 0

    # ---- the call ------------------------------------------------------------
    def run(self, key: tuple, fn: Callable[..., Any], args: Sequence[Any],
            bound: Iterable[torch.Tensor] = (),
            after_replay: Optional[Callable[[], None]] = None) -> Any:
        """``fn(*args)`` through the cache: eager at the key's first call,
        captured at its second (or when the ``bound`` tensors moved), then
        replayed. ``args``: tensors (copied into the static buffers), ints
        (0-d int64 buffers) and ``None`` (passed through); ``fn`` reads and
        writes ``bound`` in place. ``after_replay`` runs after each replay.
        Returns ``fn``'s output tree (device copies on a replay)."""
        sig = tuple(t.data_ptr() for t in bound)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.bound != sig:
                if key not in self._warm:
                    self._warm.add(key)
                    return self._warm_up(fn, args)
                entry = self._capture(key, fn, args, sig)
            out = self._replay(entry, args)
        if after_replay is not None:
            after_replay()
        return out

    def _on_device(self, a: Any) -> Any:
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(self.device, non_blocking=True)
        return torch.full((), int(a), dtype=torch.int64, device=self.device)

    def _warm_up(self, fn, args):
        """The key's first call: eager, on a side stream."""
        self.eager_calls += 1
        main = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(*[self._on_device(a) for a in args])
        main.wait_stream(side)
        return out

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _capture(self, key: tuple, fn, args, sig: tuple) -> _Entry:
        old = self._entries.pop(key, None)
        if old is not None:
            del old  # its graph's memory returns to the pool first
        static = [torch.empty(a.shape, dtype=a.dtype, device=self.device).copy_(a)
                  if isinstance(a, torch.Tensor) else self._on_device(a) for a in args]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=_keep_for_print)
        with _CAPTURE_LOCK:
            torch.cuda.synchronize(self.device)  # concurrency: block-ok (once a key: a capture is exclusive, so it runs under the capture lock and starts on an idle card)
            # the capture empties the allocator's cache first: empty it
            # before the reading, so the growth is the pool's
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    with kernels.capture_launches() as launches:
                        out = fn(*static)
                if _keep_for_print:
                    graph.instantiate()
            except Exception as e:
                raise GraphCaptureError(
                    f"{self.label}: capturing {key[0]} at key {key} failed: "
                    f"{type(e).__name__}: {e}") from e
            nbytes = torch.cuda.memory_reserved(self.device) - before
        capture_s = time.perf_counter() - t0
        entry = _Entry(graph, static, out, sig, dict(launches), nbytes, capture_s)
        self._entries[key] = entry
        self.captures += 1
        return entry

    def _replay(self, entry: _Entry, args) -> Any:
        for s, a in zip(entry.static_in, args):
            if s is None:
                continue
            if isinstance(a, torch.Tensor):
                if a.data_ptr() != s.data_ptr():
                    s.copy_(a, non_blocking=True)
            else:
                s.fill_(int(a))
        entry.graph.replay()
        kernels.add_replayed(entry.launches)
        entry.replays += 1
        return clone_tree(entry.static_out)

    # ---- reports ---------------------------------------------------------------
    def kernel_nodes(self) -> List[Dict[str, Any]]:
        """Every captured graph's kernel nodes by kernel, read from the
        graph (:func:`graph_kernel_nodes`; captured after
        :func:`keep_graphs_for_print`), beside the launches the tally adds
        at each of its replays."""
        with self._lock:
            out = []
            for k, e in self._entries.items():
                if e.nodes is None:
                    e.nodes = graph_kernel_nodes(e.graph)
                out.append({"kind": k[0], "key": repr(k), "nodes": dict(e.nodes),
                            "launches_per_replay": dict(e.launches)})
            return out

    def stats(self) -> Dict[str, Any]:
        """Every captured graph: kind, key, capture seconds, bytes its
        capture added to the pool, replays and kernel launches a replay;
        with the totals."""
        with self._lock:
            graphs = [{"kind": k[0], "key": repr(k), "capture_s": e.capture_s,
                       "bytes": int(e.nbytes), "replays": e.replays,
                       "launches_per_replay": {n: c for n, c in e.launches.items() if c}}
                      for k, e in self._entries.items()]
            return {"graphs": graphs, "captures": self.captures,
                    "eager_calls": self.eager_calls,
                    "replays": sum(g["replays"] for g in graphs),
                    "bytes": sum(g["bytes"] for g in graphs)}
