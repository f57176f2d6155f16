"""ctypes bindings to the native batcher and the native simulator.

PyTorch counterpart of ``flexflow_tpu/native_bridge.py``'s batcher
(:class:`NativeBatcher`, the ``fftpu_batcher_*`` signatures) and its
simulator entry points (:func:`sim_taskgraph`, the event replay of
``native/src/sim_engine.cc``; :func:`route_transfers`, the torus router
of ``native/src/network_sim.cc``). The reference builds the whole native
library with ``native/Makefile`` into the JAX package's tree; the port
builds two libraries at first use, the batcher from ``batcher.cc`` and
the simulator from ``sim_engine.cc`` and ``network_sim.cc``, each with
``g++ -O3 -fPIC -std=c++17 -pthread -shared`` into ``_native_build/``
beside this file (listed in ``.gitignore``). A library's name carries a
hash of its sources, the header and the flags, and the build runs behind
an ``flock``, so concurrent processes build it once and an unchanged tree
loads the library it built before.

There is no quiet fallback: a failed build raises with the compiler's
output. The pure-Python batcher, replay and router serve only when the
caller chose them with ``FLEXFLOW_TPU_NATIVE=off`` (``serving/engine.py``
``_make_batcher``, ``sim/simulator.py``, ``sim/network.py``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
BATCHER_SRC = _REPO / "native" / "src" / "batcher.cc"
SIM_SRCS = (_REPO / "native" / "src" / "sim_engine.cc",
            _REPO / "native" / "src" / "network_sim.cc")
NATIVE_INCLUDE = _REPO / "native" / "include"
BUILD_DIR = Path(__file__).with_name("_native_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_sim_lib: Optional[ctypes.CDLL] = None


def native_disabled() -> bool:
    """True when the caller chose the pure-Python batcher, replay and
    router (``FLEXFLOW_TPU_NATIVE=off``, the reference's switch)."""
    return os.environ.get("FLEXFLOW_TPU_NATIVE", "auto") == "off"


def _so_path(stem: str, srcs: Sequence[Path]) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in srcs:
        h.update(src.read_bytes())
    h.update((NATIVE_INCLUDE / "flexflow_tpu_c.h").read_bytes())
    return BUILD_DIR / f"libfftpu_{stem}_{h.hexdigest()[:16]}.so"


def _build_so(stem: str, srcs: Sequence[Path], what: str) -> Path:
    for src in srcs:
        if not src.is_file():
            raise RuntimeError(f"native {what} source {src} is missing")
    out = _so_path(stem, srcs)
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
            cmd = [cxx, *CXX_FLAGS, f"-I{NATIVE_INCLUDE}", "-o", str(tmp),
                   *map(str, srcs)]
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


__all__ = ["NativeBatcher", "SIM_CALLS", "build", "build_sim", "library_path", "load_library",
           "load_sim_library", "native_disabled", "route_transfers", "sim_library_path",
           "sim_taskgraph"]
