#!/usr/bin/env python3
"""Time variants of the port's flash-attention forward above head dim 256.

    python3 tools/torch_fwd_wide_variants.py [--dims 264,512] [--iters 20]
                                             [--parent DIR]

``flash_fwd_kernel_wide_mma`` (bf16) and ``flash_fwd_kernel_wide_tf32x3``
(f32, split TF32) in flexflow_tpu_torch/kernels/csrc/
flash_attention_fwd_wide.cu are templates over the group width W, the key
tile BK, the columns of a staged chunk KC, the ring slots a group NST and
whether each group's slice of Q stays resident in shared memory (QRES) or
streams with K. The library the port loads holds one choice of BK, KC and
NST per dtype, with Q resident up to D 512. This script builds the same
source again with one extra C entry for each variant below (one ``nvcc``
per variant, started together; W picked as the library picks it) and runs
each at B*H 128, S 512 and each D of ``--dims`` (at most 512), causal and
not: its registers and stack frame (cuobjdump), its error against the
plain version (f32 1e-4 absolute, bf16 2^-7 of the largest |out|; lse
1e-4), two runs held bitwise equal, and its time by CUDA events around
``--iters`` launches (the variants in turns, forward then backward through
the list, each row's two times printed). ``--parent DIR`` adds the
forward of another checkout's ``csrc`` (its ``ff_flash_attention_fwd_wide``
entry) to the same turns. Prints the card's name and power limit first and
one JSON object last. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from flexflow_tpu_torch.kernels import _build  # noqa: E402
from flexflow_tpu_torch.kernels import flash_attention as fa  # noqa: E402

# (dtype, key tile, chunk columns, ring slots, Q resident); the first of
# each dtype is the port's choice
VARIANTS = [
    ("bfloat16", 64, 64, 3, True), ("bfloat16", 64, 64, 3, False),
    ("bfloat16", 64, 64, 2, True), ("bfloat16", 64, 32, 3, True),
    ("float32", 32, 64, 3, True), ("float32", 32, 64, 3, False),
    ("float32", 32, 64, 2, True), ("float32", 32, 32, 3, True),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CTYPE = {"float32": "float", "bfloat16": "bf16"}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}  # bf16: of the largest |out|
BH, SEQ = 128, 512
OUT_DIR = _build.BUILD_DIR / "wide_variants"
ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                     ctypes.c_void_p]


def entry(dtype: str, bk: int, kc: int, nst: int, qres: bool) -> str:
    return f"probe_{dtype}_{bk}_{kc}_{nst}_{int(qres)}"


def probe_source(variant) -> str:
    """A C entry that launches the variant at the group width the library's
    dispatch would pick for d (one column chunk: d <= 512)."""
    dtype, bk, kc, nst, qres = variant
    launch = (f"launch<{CTYPE[dtype]}, {{w}}, {bk}, {kc}, {nst}, {str(qres).lower()}>"
              "(q, k, v, o, lse, bh, sq, skv, d, scale, causal, "
              "static_cast<cudaStream_t>(stream))")
    return ('#include "flash_attention_fwd_wide.cu"\nextern "C" {\n'
            f"int {entry(*variant)}(const void* q, const void* k, const void* v, void* o, "
            "void* lse, int bh, int sq, int skv, int d, float scale, int causal, "
            "void* stream) {\n"
            "  if (d > 2 * kMaxGroupCols) return (int)cudaErrorInvalidValue;\n"
            "  const int cols = (d + 1) / 2;\n"
            f"  if (cols <= 144) return (int){launch.format(w=144)};\n"
            f"  if (cols <= 192) return (int){launch.format(w=192)};\n"
            f"  return (int){launch.format(w=256)};\n}}\n}}\n")


def _nvcc(src: Path, lib: Path, include: Path) -> list:
    return [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(include), "-o",
            str(lib), str(src)]


def build(parent: Path = None) -> dict:
    """One shared library per variant (and one of the parent's wide
    source); {variant or "parent": path}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for variant in VARIANTS:
        name = entry(*variant)
        src = OUT_DIR / f"{name}.cu"
        src.write_text(probe_source(variant))
        lib = OUT_DIR / f"{name}.so"
        jobs[variant] = (lib, _nvcc(src, lib, _build.CSRC_DIR))
    if parent is not None:
        csrc = parent / "flexflow_tpu_torch" / "kernels" / "csrc"
        lib = OUT_DIR / "parent_wide.so"
        jobs["parent"] = (lib, _nvcc(csrc / "flash_attention_fwd_wide.cu", lib, csrc))
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = {key: pool.submit(subprocess.run, cmd, capture_output=True, text=True,
                                 timeout=900) for key, (_, cmd) in jobs.items()}
        for key, fut in done.items():
            r = fut.result()
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed for {key}:\n{r.stderr[-4000:]}")
    return {key: lib for key, (lib, _) in jobs.items()}


def resources(lib: Path, prefix: str = "flash_fwd") -> dict:
    """{kernel instance whose name starts with ``prefix``: (registers, stack
    bytes)} by cuobjdump."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(lib)],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    usage, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            m = re.search("(" + prefix + r"\w*?kernel\w*?)I((?:L[ib]\d+E)*)", name)
            if m:
                u = dict(re.findall(r"(\w+):(\d+)", line))
                label = m.group(1) + "<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) + ">"
                usage[label] = (int(u["REG"]), int(u["STACK"]))
            name = None
    return usage


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", default="264,512")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(args.parent)
    usage = {}
    for key, lib in libs.items():
        usage[key] = resources(lib)
        print(f"resources {key}: {usage[key]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for dtype_name, dtype in DTYPES.items():
        keys = [key for key in libs if key == "parent" or key[0] == dtype_name]
        fns = {}
        for key in keys:
            lib = ctypes.CDLL(str(libs[key]))
            fn = getattr(lib, "ff_flash_attention_fwd_wide" if key == "parent"
                         else entry(*key))
            fn.argtypes = (ARGS[:-1] + [ctypes.c_int, ctypes.c_void_p] if key == "parent"
                           else ARGS)
            fn.restype = ctypes.c_int
            fns[key] = fn
        for d in (int(x) for x in args.dims.split(",")):
            q, k, v = (torch.randn((BH, SEQ, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            scale = d ** -0.5
            for causal in (False, True):
                ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
                tol = TOL[dtype] * (ref_out.float().abs().max().item()
                                    if dtype == torch.bfloat16 else 1.0)
                calls, found = [], []
                for key, fn in fns.items():
                    out, lse = torch.empty_like(q), torch.empty_like(ref_lse)
                    ptrs = [t.data_ptr() for t in (q, k, v, out, lse)]
                    extra = (1 if dtype == torch.bfloat16 else 0,) if key == "parent" else ()

                    def call(fn=fn, ptrs=ptrs, extra=extra):
                        err = fn(*ptrs, BH, SEQ, SEQ, d, scale, int(causal), *extra, stream)
                        if err:
                            raise RuntimeError(f"launch failed: error {err}")

                    call()
                    torch.cuda.synchronize()
                    first = (out.clone(), lse.clone())
                    call()
                    torch.cuda.synchronize()
                    bitwise = torch.equal(first[0], out) and torch.equal(first[1], lse)
                    err_out = (out.float() - ref_out.float()).abs().max().item()
                    err_lse = (lse - ref_lse).abs().max().item()
                    if not (bitwise and err_out <= tol and err_lse <= 1e-4):
                        raise RuntimeError(f"{key} D={d} causal={causal}: err {err_out} "
                                           f"(tol {tol}) / {err_lse}, bitwise {bitwise}")
                    calls.append(call)
                    found.append(dict(variant="parent" if key == "parent" else
                                      dict(block_k=key[1], chunk=key[2], stages=key[3],
                                           q_resident=key[4]),
                                      dtype=dtype_name, d=d, causal=causal,
                                      max_abs_err=err_out, lse_max_abs_err=err_lse,
                                      bitwise_equal_runs=bitwise, ms=[]))
                order = list(range(len(calls)))
                for i in order + order[::-1]:
                    found[i]["ms"].append(time_ms(calls[i], args.iters))
                for row in found:
                    print(f"variant {dtype_name} D={d} causal={causal} {row['variant']}: err "
                          f"{row['max_abs_err']:.3g} / lse {row['lse_max_abs_err']:.3g}; ms "
                          f"{row['ms'][0]:.4f}, {row['ms'][1]:.4f} [{card}]", flush=True)
                rows += found
            del q, k, v
    print(json.dumps({"card": card, "shape": [BH, SEQ], "resources":
                      {str(k): u for k, u in usage.items()}, "variants": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
