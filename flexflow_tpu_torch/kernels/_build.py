"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, on the machine with the card, into ``_build/`` beside this
file (listed in ``.gitignore``); the library's name carries a hash of the
sources, headers and flags, so an unchanged tree loads the library it
built before. There is no fallback: without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

CSRC_DIR = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# argtypes/restype of every exported C function: each pointer and the
# stream is a c_void_p, or ctypes would pass it as a 32-bit int
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, bh, sq, skv, d, scale, causal, dtype, stream
    "ff_flash_attention_fwd": ([_P] * 5 + [_I] * 4 + [_F, _I, _I, _P], _I),
    # q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal, dtype, stream
    "ff_flash_attention_bwd_dq": ([_P] * 8 + [_I] * 4 + [_F, _I, _I, _P], _I),
    # q, k, v, o, g, lse, delta, dk, dv, bh, sq, skv, d, scale, causal, dtype, stream
    "ff_flash_attention_bwd_dkv": ([_P] * 9 + [_I] * 4 + [_F, _I, _I, _P], _I),
    # the same three for head dims above 256 (flash_attention_fwd_wide.cu,
    # flash_attention_bwd_wide.cu)
    "ff_flash_attention_fwd_wide": ([_P] * 5 + [_I] * 4 + [_F, _I, _I, _P], _I),
    "ff_flash_attention_bwd_dq_wide": ([_P] * 8 + [_I] * 4 + [_F, _I, _I, _P], _I),
    "ff_flash_attention_bwd_dkv_wide": ([_P] * 9 + [_I] * 4 + [_F, _I, _I, _P], _I),
    # x, idx, scale, out, r_in, r_out, d, dtype, stream (moe_kernels.cu)
    "ff_row_gather": ([_P] * 4 + [_I] * 4 + [_P], _I),
    # x, idx, w, out, r_in, b, k, d, dtype, stream (moe_kernels.cu)
    "ff_row_gather_sum": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "ff_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional["_Library"] = None


class _Library:
    """The loaded library's entries, each checked for its argument count:
    ctypes passes arguments past ``argtypes`` as C ints, which would cut a
    pointer or a stream handle."""

    def __init__(self, lib: ctypes.CDLL):
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
            setattr(self, name, _checked(name, fn, len(argtypes)))


def _checked(name: str, fn, nargs: int):
    def call(*args):
        if len(args) != nargs:
            raise TypeError(f"{name} takes {nargs} arguments, got {len(args)}")
        return fn(*args)
    return call


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's standard prefix; raises when none exists."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from flexflow_tpu_torch/kernels/csrc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libflexflow_tpu_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands concurrently; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{out}")


def build() -> Tuple[Path, float]:
    """Compile the kernels unless this tree's library exists already.
    Returns (library path, build seconds); seconds is 0 when nothing was
    built."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)  # atomic: a concurrent build loads one or the other
    return out, seconds


def load_library() -> _Library:
    """The kernels' library, built at first use and loaded once per
    process."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            _lib = _Library(ctypes.CDLL(str(path)))
        return _lib


def check_launch(err: int, kernel: str) -> None:
    """Raise when a kernel's C entry returned a CUDA error."""
    if err:
        msg = load_library().ff_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
