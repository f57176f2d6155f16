"""ctypes bindings to the native runtime pieces, and the build of the C API.

PyTorch counterpart of ``flexflow_tpu/native_bridge.py``: the batcher
(:class:`NativeBatcher`, the ``fftpu_batcher_*`` signatures), the
simulator's entry points (:func:`sim_taskgraph`, the event replay of
``native/src/sim_engine.cc``; :func:`route_transfers`, the torus router of
``native/src/network_sim.cc``), the graph algorithms
(:func:`toposort`, :func:`dominators`, :func:`transitive_reduction`,
``native/src/graph_algos.cc``) and the threaded loader
(:class:`NativeLoader`, ``native/src/dataloader.cc``). The reference
builds the whole native library with ``native/Makefile`` into the JAX
package's tree; the port builds four libraries at first use from the same
unchanged sources: the batcher, the simulator, the runtime (graph
algorithms and loader) and the C model-building API (:func:`build_capi`,
from ``native/model_capi.cc`` beside this file, which embeds CPython and
drives :mod:`flexflow_tpu_torch.capi_host`). Each is built with ``g++
-O3 -fPIC -std=c++17 -pthread -shared`` into ``_native_build/`` beside
this file (listed in ``.gitignore``). A library's name carries a hash of
its sources, the header and the flags, and the build runs behind an
``flock``, so concurrent processes build it once and an unchanged tree
loads the library it built before.

There is no quiet fallback: a failed build or load raises with the
compiler's output. The pure-Python batcher, replay, router and loader
serve only when the caller chose them with ``FLEXFLOW_TPU_NATIVE=off``
(``serving/engine.py`` ``_make_batcher``, ``sim/simulator.py``,
``sim/network.py``, ``runtime/dataloader.py``); the task-graph export then
keeps every edge, as the reference does without its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
BATCHER_SRC = _REPO / "native" / "src" / "batcher.cc"
SIM_SRCS = (_REPO / "native" / "src" / "sim_engine.cc",
            _REPO / "native" / "src" / "network_sim.cc")
RUNTIME_SRCS = (_REPO / "native" / "src" / "graph_algos.cc",
                _REPO / "native" / "src" / "dataloader.cc")
CAPI_SRC = Path(__file__).with_name("native") / "model_capi.cc"
NATIVE_INCLUDE = _REPO / "native" / "include"
BUILD_DIR = Path(__file__).with_name("_native_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_sim_lib: Optional[ctypes.CDLL] = None
_runtime_lib: Optional[ctypes.CDLL] = None


def native_disabled() -> bool:
    """True when the caller chose the pure-Python batcher, replay and
    router (``FLEXFLOW_TPU_NATIVE=off``, the reference's switch)."""
    return os.environ.get("FLEXFLOW_TPU_NATIVE", "auto") == "off"


def _so_path(stem: str, srcs: Sequence[Path], link: Sequence[str] = ()) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(link)).encode())
    for src in srcs:
        h.update(src.read_bytes())
    h.update((NATIVE_INCLUDE / "flexflow_tpu_c.h").read_bytes())
    return BUILD_DIR / f"libfftpu_{stem}_{h.hexdigest()[:16]}.so"


def _build_so(stem: str, srcs: Sequence[Path], what: str, link: Sequence[str] = ()) -> Path:
    """``link``: flags after the sources (include dirs, libraries)."""
    for src in srcs:
        if not src.is_file():
            raise RuntimeError(f"native {what} source {src} is missing")
    out = _so_path(stem, srcs, link)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native {what} is built from "
                           f"{', '.join(map(str, srcs))} (FLEXFLOW_TPU_NATIVE=off "
                           "runs the Python one instead)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # xdist workers build it once
        try:
            if out.exists():  # a peer built it while this process waited
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, f"-I{NATIVE_INCLUDE}", f"-Wl,-soname,{out.name}",
                   "-o", str(tmp), *map(str, srcs), *link]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"native {what} build failed with code {proc.returncode}:\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def library_path() -> Path:
    return _so_path("batcher", (BATCHER_SRC,))


def build() -> Path:
    """Compile the batcher unless this tree's library exists already;
    raises with the compiler's output when the build fails."""
    return _build_so("batcher", (BATCHER_SRC,), "batcher")


def load_library() -> ctypes.CDLL:
    """The batcher's library, built at first use and loaded once per
    process, its six entry points typed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.fftpu_batcher_create.restype = ctypes.c_void_p
            lib.fftpu_batcher_create.argtypes = [ctypes.c_int32, ctypes.c_int64]
            lib.fftpu_batcher_destroy.restype = None
            lib.fftpu_batcher_destroy.argtypes = [ctypes.c_void_p]
            lib.fftpu_batcher_submit.restype = None
            lib.fftpu_batcher_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.fftpu_batcher_close.restype = None
            lib.fftpu_batcher_close.argtypes = [ctypes.c_void_p]
            lib.fftpu_batcher_pending.restype = ctypes.c_int64
            lib.fftpu_batcher_pending.argtypes = [ctypes.c_void_p]
            lib.fftpu_batcher_next.restype = ctypes.c_int64
            lib.fftpu_batcher_next.argtypes = [ctypes.c_void_p, i64p]
            _lib = lib
        return _lib


# ------------------------------------------------------------- the simulator
def sim_library_path() -> Path:
    return _so_path("sim", SIM_SRCS)


def build_sim() -> Path:
    """Compile the simulator's library (the event replay and the torus
    router) unless this tree's exists already; raises on a failed build."""
    return _build_so("sim", SIM_SRCS, "simulator")


def load_sim_library() -> ctypes.CDLL:
    global _sim_lib
    with _lock:
        if _sim_lib is None:
            lib = ctypes.CDLL(str(build_sim()))
            f64p = ctypes.POINTER(ctypes.c_double)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.fftpu_sim_taskgraph.restype = ctypes.c_double
            lib.fftpu_sim_taskgraph.argtypes = [
                ctypes.c_int32, f64p, i32p, ctypes.c_int32, i32p, i32p, f64p]
            lib.fftpu_route_transfers.restype = ctypes.c_double
            lib.fftpu_route_transfers.argtypes = [
                ctypes.c_int32, i32p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32, i32p, i32p, f64p,
                ctypes.c_double, ctypes.c_double, f64p, i32p]
            _sim_lib = lib
        return _sim_lib


# ---------------------------------------------- graph algorithms and loader
def runtime_library_path() -> Path:
    return _so_path("runtime", RUNTIME_SRCS)


def build_runtime() -> Path:
    """Compile the graph algorithms and the loader unless this tree's
    library exists already; raises on a failed build."""
    return _build_so("runtime", RUNTIME_SRCS, "runtime")


def load_runtime_library() -> ctypes.CDLL:
    global _runtime_lib
    with _lock:
        if _runtime_lib is None:
            lib = ctypes.CDLL(str(build_runtime()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.fftpu_toposort.restype = ctypes.c_int
            lib.fftpu_toposort.argtypes = [ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p]
            lib.fftpu_dominators.restype = ctypes.c_int
            lib.fftpu_dominators.argtypes = [ctypes.c_int32, ctypes.c_int32, i32p, i32p,
                                             ctypes.c_int32, i32p]
            lib.fftpu_transitive_reduction.restype = ctypes.c_int32
            lib.fftpu_transitive_reduction.argtypes = [
                ctypes.c_int32, ctypes.c_int32, i32p, i32p, ctypes.POINTER(ctypes.c_uint8)]
            lib.fftpu_loader_create.restype = ctypes.c_void_p
            lib.fftpu_loader_create.argtypes = [
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32]
            lib.fftpu_loader_destroy.restype = None
            lib.fftpu_loader_destroy.argtypes = [ctypes.c_void_p]
            lib.fftpu_loader_num_batches.restype = ctypes.c_int64
            lib.fftpu_loader_num_batches.argtypes = [ctypes.c_void_p]
            lib.fftpu_loader_reset.restype = None
            lib.fftpu_loader_reset.argtypes = [ctypes.c_void_p, ctypes.c_int32]
            lib.fftpu_loader_reset_with_perm.restype = None
            lib.fftpu_loader_reset_with_perm.argtypes = [ctypes.c_void_p,
                                                         ctypes.POINTER(ctypes.c_int64)]
            lib.fftpu_loader_next.restype = ctypes.c_int64
            lib.fftpu_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
            _runtime_lib = lib
        return _runtime_lib


def _edge_arrays(edges: Sequence[Tuple[int, int]]):
    return _i32([e[0] for e in edges]), _i32([e[1] for e in edges])


def toposort(n: int, edges: Sequence[Tuple[int, int]]) -> List[int]:
    """A topological order of ``n`` nodes (``fftpu_toposort``)."""
    lib = load_runtime_library()
    es, ed = _edge_arrays(edges)
    out = np.zeros(n, np.int32)
    if lib.fftpu_toposort(n, len(edges), _i32p(es), _i32p(ed), _i32p(out)) != 0:
        raise ValueError("graph has a cycle")
    return out.tolist()


def dominators(n: int, edges: Sequence[Tuple[int, int]], root: int) -> List[int]:
    """Immediate dominator per node (the root maps to itself, an
    unreachable node to -1)."""
    lib = load_runtime_library()
    es, ed = _edge_arrays(edges)
    out = np.zeros(n, np.int32)
    if lib.fftpu_dominators(n, len(edges), _i32p(es), _i32p(ed), root, _i32p(out)) != 0:
        raise ValueError("invalid dominator input")
    return out.tolist()


def transitive_reduction(n: int, edges: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The edges no longer path implies, in their given order."""
    lib = load_runtime_library()
    es, ed = _edge_arrays(edges)
    kept = np.zeros(len(edges), np.uint8)
    if lib.fftpu_transitive_reduction(n, len(edges), _i32p(es), _i32p(ed),
                                      kept.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))) < 0:
        raise ValueError("graph has a cycle")
    return [e for e, k in zip(edges, kept) if k]


class NativeLoader:
    """Threaded gather and prefetch over host numpy datasets in C++
    (reference: SingleDataLoader, src/dataloader/dataloader.cc): the
    library assembles batch b+1 on its own thread while batch b is used.

    Each shuffle's permutation is drawn in Python from
    ``np.random.default_rng(seed)`` and pushed to the library
    (``fftpu_loader_reset_with_perm``), so its batches are bit for bit
    the Python loader's. One consumer at a time: ``runtime/dataloader.py``'s
    Prefetcher drives ``next_batch`` from its worker thread, which joins
    before the loader is reset or closed."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 shuffle: bool = False, seed: int = 0):
        # C-contiguous copies the library reads for the loader's lifetime
        self._arrays = [np.ascontiguousarray(a) for a in arrays]
        n = self._arrays[0].shape[0]
        if any(a.shape[0] != n for a in self._arrays):
            raise ValueError("all arrays must have the same sample count")
        if n < batch_size:
            raise ValueError(f"{n} samples hold no whole batch of {batch_size}")
        self._lib = load_runtime_library()
        self.batch_size = int(batch_size)
        self.num_samples = n
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._row_bytes = [a.nbytes // n for a in self._arrays]
        datas = (ctypes.c_void_p * len(self._arrays))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self._arrays])
        rb = (ctypes.c_int64 * len(self._arrays))(*self._row_bytes)
        # no shuffle in the library: the first reshuffling reset pushes one
        self._h = self._lib.fftpu_loader_create(n, self.batch_size, len(self._arrays),
                                                datas, rb, 0, seed, 1)
        if not self._h:
            raise RuntimeError("fftpu_loader_create failed")

    @property
    def num_batches(self) -> int:
        return int(self._lib.fftpu_loader_num_batches(self._h))

    @property
    def batch_nbytes(self) -> int:
        """Host bytes one batch gathers across all arrays."""
        return sum(self._row_bytes) * self.batch_size

    def reset(self, reshuffle: bool = True) -> None:
        if self.shuffle and reshuffle:
            perm = np.ascontiguousarray(self._rng.permutation(self.num_samples), dtype=np.int64)
            self._lib.fftpu_loader_reset_with_perm(
                self._h, perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        else:
            self._lib.fftpu_loader_reset(self._h, 0)

    def next_batch(self) -> Optional[List[np.ndarray]]:
        """The next batch, one fresh array per input (the library copies
        into them), or None at the epoch's end."""
        outs = [np.empty((self.batch_size,) + a.shape[1:], a.dtype) for a in self._arrays]
        ptrs = (ctypes.c_void_p * len(outs))(
            *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
        if self._lib.fftpu_loader_next(self._h, ptrs) < 0:
            return None
        return outs

    def close(self) -> None:
        h, self._h = getattr(self, "_h", None), None  # concurrency: race-ok (one consumer, joined before close)
        if h:
            self._lib.fftpu_loader_destroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ------------------------------------------------------------ the C API
def _python_link() -> Tuple[str, ...]:
    """Compile and link flags for a library that embeds this interpreter."""
    libdir = sysconfig.get_config_var("LIBDIR")
    return (f"-I{sysconfig.get_paths()['include']}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{sysconfig.get_config_var('LDVERSION')}")


def capi_library_path() -> Path:
    return _so_path("capi", (CAPI_SRC,), _python_link())


def build_capi() -> Path:
    """Compile the C model-building API (``native/model_capi.cc``, the
    ABI of ``native/include/flexflow_tpu_c.h``) against this interpreter's
    ``Python.h`` and ``libpython`` unless this tree's library exists
    already; raises on a failed build. Link a C program to the returned
    path (its directory as the rpath)."""
    return _build_so("capi", (CAPI_SRC,), "C API", _python_link())


# every native simulator call, by entry point: the tests and the card run
# read it to show which engine priced a plan
SIM_CALLS: Dict[str, int] = {"sim_taskgraph": 0, "route_transfers": 0}


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def sim_taskgraph(durations: Sequence[float], lanes: Sequence[int],
                  edges: Sequence[Tuple[int, int]], want_starts: bool = False):
    """The event replay of a task graph (``fftpu_sim_taskgraph``): a task
    starts when its deps finished and its lane is free. Returns the
    makespan, and each task's start time when ``want_starts``."""
    lib = load_sim_library()
    dur = np.ascontiguousarray(durations, dtype=np.float64)
    lane = _i32(lanes)
    es = _i32([e[0] for e in edges])
    ed = _i32([e[1] for e in edges])
    starts = np.zeros(len(dur), np.float64) if want_starts else None
    res = lib.fftpu_sim_taskgraph(len(dur), _f64p(dur), _i32p(lane), len(edges),
                                  _i32p(es), _i32p(ed),
                                  _f64p(starts) if starts is not None else None)
    SIM_CALLS["sim_taskgraph"] += 1
    if res < 0:
        raise ValueError("task graph has a cycle or invalid edges")
    return (float(res), starts) if want_starts else float(res)


def route_transfers(dims: Sequence[int], wrap: Sequence[bool],
                    src: Sequence[int], dst: Sequence[int],
                    bytes_: Sequence[float], link_bandwidth: float,
                    hop_latency: float) -> Tuple[float, float, int]:
    """Dimension-ordered routing of a transfer set over a torus
    (``fftpu_route_transfers``). Returns (completion seconds, busiest
    link's bytes, longest route's hops)."""
    if not (len(src) == len(dst) == len(bytes_)):
        raise ValueError(
            f"src/dst/bytes length mismatch: {len(src)}/{len(dst)}/{len(bytes_)}")
    if len(dims) != len(wrap):
        raise ValueError("dims/wrap length mismatch")
    lib = load_sim_library()
    d = _i32(dims)
    w = np.ascontiguousarray([1 if x else 0 for x in wrap], dtype=np.uint8)
    s, t = _i32(src), _i32(dst)
    b = np.ascontiguousarray(bytes_, dtype=np.float64)
    max_link = ctypes.c_double(0.0)
    max_hops = ctypes.c_int32(0)
    res = lib.fftpu_route_transfers(
        len(d), _i32p(d), w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(s), _i32p(s), _i32p(t), _f64p(b), float(link_bandwidth),
        float(hop_latency), ctypes.byref(max_link), ctypes.byref(max_hops))
    SIM_CALLS["route_transfers"] += 1
    if res < 0:
        raise ValueError("invalid torus routing input")
    return float(res), float(max_link.value), int(max_hops.value)


class NativeBatcher:
    """Dynamic micro-batch queue in C++ (``native/src/batcher.cc``).
    Requests are int64 ids; ``next_batch`` blocks until ``max_batch`` ids
    are pending or the oldest has waited ``timeout_s``."""

    def __init__(self, max_batch: int, timeout_s: float):
        self._lib = load_library()
        self.max_batch = int(max_batch)
        # guards _h and _closed for the entry points that do not block, for
        # _PyBatcher's lifecycle: submit fails fast once closed (an id
        # accepted under this lock is pushed before close() flips the flag,
        # so the native drain covers it), pending() and destroy() never
        # pass a freed handle, and a second destroy() does nothing.
        # next_batch blocks in native code (the C batcher has its own
        # mutex) and stays outside it: the engine destroys a batcher only
        # after its consumers joined.
        self._hmu = threading.Lock()
        self._closed = False
        self._h = self._lib.fftpu_batcher_create(self.max_batch, int(timeout_s * 1e6))
        if not self._h:
            raise RuntimeError("fftpu_batcher_create failed")

    def submit(self, request_id: int) -> None:
        with self._hmu:
            if self._closed or not self._h:
                # an id queued after close() would never be drained: fail
                # fast so the engine resubmits to the re-armed batcher
                raise RuntimeError("batcher is closed")
            self._lib.fftpu_batcher_submit(self._h, int(request_id))

    def pending(self) -> int:
        with self._hmu:
            if not self._h:
                return 0
            return int(self._lib.fftpu_batcher_pending(self._h))

    def next_batch(self) -> Optional[List[int]]:
        """Block; the ids of the next batch, or None once closed and
        drained. Each call fills its own buffer: the instances of a group
        drain one batcher from one thread each."""
        h = self._h
        if not h:
            return None
        ids = (ctypes.c_int64 * self.max_batch)()
        n = self._lib.fftpu_batcher_next(h, ids)
        if n < 0:
            return None
        return list(ids[:n])

    def close(self) -> None:
        with self._hmu:
            self._closed = True
            if self._h:
                self._lib.fftpu_batcher_close(self._h)

    def destroy(self) -> None:
        # check and clear under the lock: two stop() calls must not free
        # the handle twice
        with self._hmu:
            h, self._h = self._h, None
            self._closed = True
            if h:
                self._lib.fftpu_batcher_destroy(h)

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass


__all__ = ["NativeBatcher", "NativeLoader", "SIM_CALLS", "build", "build_capi",
           "build_runtime", "build_sim", "capi_library_path", "dominators", "library_path",
           "load_library", "load_runtime_library", "load_sim_library", "native_disabled",
           "route_transfers", "runtime_library_path", "sim_library_path", "sim_taskgraph",
           "toposort", "transitive_reduction"]
