#!/usr/bin/env python3
"""Time variants of the port's f32 flash-attention forward on one card.

    python3 tools/torch_fwd_tf32_variants.py [--widths 64,128] [--iters 20]

``flash_fwd_kernel_tf32x3`` (flexflow_tpu_torch/kernels/csrc/
flash_attention_fwd.cu) is a template over the padded head width, the key
tile and the m16 tiles of query rows a warp owns. The library the port
loads holds one choice per width.
This script builds the same source again with one extra C entry for each
variant below, one ``nvcc`` per width started together, and runs each at
B*H 128, S 512 and D = the width, causal and not: its registers and stack
frame (cuobjdump), its error against the plain version, two runs held
bitwise equal, and its time by CUDA events around ``--iters`` launches
(the variants in turns, forward then backward through the list, each
row's two times printed). Prints the card's name and power limit first
and one JSON object last. Needs a CUDA card and nvcc.
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

# (width, key tile, m16 tiles a warp); the first of each width is the
# port's choice
VARIANTS = {
    32: [(32, 64, 2), (32, 64, 1), (32, 32, 2)],
    64: [(64, 32, 2), (64, 32, 1), (64, 64, 1), (64, 16, 2), (64, 64, 2)],
    128: [(128, 16, 1), (128, 32, 1), (128, 16, 2)],
    256: [(256, 16, 1), (256, 8, 1)],
}
BH, SEQ = 128, 512
OUT_DIR = _build.BUILD_DIR / "variants"


def entry(width: int, bk: int, mt: int) -> str:
    return f"probe_{width}_{bk}_{mt}"


def build(widths) -> dict:
    """One shared library per width; {width: path}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for width in widths:
        lines = ['#include "flash_attention_fwd.cu"', 'extern "C" {']
        for w, bk, mt in VARIANTS[width]:
            lines.append(
                f"int {entry(w, bk, mt)}(const void* q, const void* k, const void* v, "
                "void* o, void* lse, int bh, int sq, int skv, int d, float scale, int causal, "
                "void* stream) {\n  return (int)tf32::launch<"
                f"{w}, {bk}, {mt}>(q, k, v, o, lse, bh, sq, skv, "
                "d, scale, causal, static_cast<cudaStream_t>(stream));\n}")
        lines.append("}")
        src = OUT_DIR / f"fwd_tf32_variants_{width}.cu"
        src.write_text("\n".join(lines) + "\n")
        lib = OUT_DIR / f"fwd_tf32_variants_{width}.so"
        jobs[width] = (lib, [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR),
                             "-o", str(lib), str(src)])
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = {w: pool.submit(subprocess.run, cmd, capture_output=True, text=True, timeout=600)
                for w, (_, cmd) in jobs.items()}
        for w, fut in done.items():
            r = fut.result()
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed for width {w}:\n{r.stderr[-4000:]}")
    return {w: lib for w, (lib, _) in jobs.items()}


def resources(lib: Path) -> dict:
    """{(width, key tile, m16 tiles a warp): (registers, stack bytes)} by
    cuobjdump."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(lib)],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    usage, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            m = re.search(r"flash_fwd_kernel_tf32x3ILi(\d+)ELi(\d+)ELi(\d+)E", name)
            if m:
                u = dict(re.findall(r"(\w+):(\d+)", line))
                usage[tuple(int(g) for g in m.groups())] = (int(u["REG"]), int(u["STACK"]))
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
    ap.add_argument("--widths", default="32,64,128,256")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    widths = [int(w) for w in args.widths.split(",")]
    libs = build(widths)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for width in widths:
        lib = ctypes.CDLL(str(libs[width]))
        usage = resources(libs[width])
        q, k, v = (torch.randn((BH, SEQ, width), generator=gen, device="cuda") for _ in range(3))
        scale = width ** -0.5
        stream = torch.cuda.current_stream().cuda_stream
        for causal in (False, True):
            ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
            calls, found = [], []
            for variant in VARIANTS[width]:
                fn = getattr(lib, entry(*variant))
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                out, lse = torch.empty_like(q), torch.empty_like(ref_lse)
                ptrs = [t.data_ptr() for t in (q, k, v, out, lse)]

                def call(fn=fn, ptrs=ptrs):
                    err = fn(*ptrs, BH, SEQ, SEQ, width, scale, int(causal), stream)
                    if err:
                        raise RuntimeError(f"launch failed: error {err}")

                call()
                torch.cuda.synchronize()
                first = (out.clone(), lse.clone())
                call()
                torch.cuda.synchronize()
                bitwise = torch.equal(first[0], out) and torch.equal(first[1], lse)
                err_out = (out - ref_out).abs().max().item()
                err_lse = (lse - ref_lse).abs().max().item()
                if not (bitwise and err_out <= 1e-4 and err_lse <= 1e-4):
                    raise RuntimeError(f"{variant} causal={causal}: err {err_out} / {err_lse}, "
                                       f"bitwise {bitwise}")
                calls.append(call)
                found.append(dict(width=width, block_k=variant[1],
                                  warp_tiles=variant[2], causal=causal, registers=usage[variant][0],
                                  stack=usage[variant][1], max_abs_err=err_out,
                                  lse_max_abs_err=err_lse, bitwise_equal_runs=bitwise, ms=[]))
            order = list(range(len(calls)))
            for i in order + order[::-1]:
                found[i]["ms"].append(time_ms(calls[i], args.iters))
            for row in found:
                print(f"variant width {width} key tile {row['block_k']} "
                      f"m16 tiles a warp {row['warp_tiles']} causal={causal}: {row['registers']} registers, stack {row['stack']}; "
                      f"err {row['max_abs_err']:.3g} / lse {row['lse_max_abs_err']:.3g}; "
                      f"ms {row['ms'][0]:.4f}, {row['ms'][1]:.4f} [{card}]", flush=True)
            rows += found
    print(json.dumps({"card": card, "shape": [BH, SEQ], "variants": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
