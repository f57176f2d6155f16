"""ctypes binding to the native dynamic batcher.

PyTorch counterpart of the batcher part of ``flexflow_tpu/native_bridge.py``
(:class:`NativeBatcher` and the ``fftpu_batcher_*`` signatures). The
reference builds the whole native library with ``native/Makefile`` into
the JAX package's tree; the port builds ``native/src/batcher.cc`` alone,
at first use, with ``g++ -O3 -fPIC -std=c++17 -pthread -shared`` into
``_native_build/`` beside this file (listed in ``.gitignore``). The
library's name carries a hash of the source, the header and the flags,
and the build runs behind an ``flock``, so concurrent processes build it
once and an unchanged tree loads the library it built before.

There is no quiet fallback: a failed build raises with the compiler's
output. The pure-Python batcher serves only when the caller chose it with
``FLEXFLOW_TPU_NATIVE=off`` (``serving/engine.py`` ``_make_batcher``).
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
from typing import List, Optional

_REPO = Path(__file__).resolve().parents[1]
BATCHER_SRC = _REPO / "native" / "src" / "batcher.cc"
NATIVE_INCLUDE = _REPO / "native" / "include"
BUILD_DIR = Path(__file__).with_name("_native_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def native_disabled() -> bool:
    """True when the caller chose the pure-Python batcher
    (``FLEXFLOW_TPU_NATIVE=off``, the reference's switch)."""
    return os.environ.get("FLEXFLOW_TPU_NATIVE", "auto") == "off"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(BATCHER_SRC.read_bytes())
    h.update((NATIVE_INCLUDE / "flexflow_tpu_c.h").read_bytes())
    return BUILD_DIR / f"libfftpu_batcher_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the batcher unless this tree's library exists already;
    raises with the compiler's output when the build fails."""
    if not BATCHER_SRC.is_file():
        raise RuntimeError(f"native batcher source {BATCHER_SRC} is missing")
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native batcher is built from "
                           f"{BATCHER_SRC} (FLEXFLOW_TPU_NATIVE=off serves "
                           "with the Python batcher instead)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # xdist workers build it once
        try:
            if out.exists():  # a peer built it while this process waited
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, f"-I{NATIVE_INCLUDE}", "-o", str(tmp),
                   str(BATCHER_SRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"native batcher build failed with code {proc.returncode}:\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


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


__all__ = ["NativeBatcher", "build", "library_path", "load_library", "native_disabled"]
