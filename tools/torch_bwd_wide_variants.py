#!/usr/bin/env python3
"""Time variants of the port's flash-attention backward above head dim 256.

    python3 tools/torch_bwd_wide_variants.py [--dims 264,512] [--iters 20]
                                             [--parent DIR]

The dq and dkv kernels of flexflow_tpu_torch/kernels/csrc/
flash_attention_bwd_wide.cu are templates over their groups of warps, the
strips (16-row warps) a group, the streamed tile (keys in dq, queries in
dkv), the columns of a staged chunk KC, the ring slots a group NST and
whether the block's own rows' tensors (Q and dO in dq, K and V in dkv)
stay resident in shared memory or stream with the chunks. The library the
port loads holds one choice per dtype. This script builds the same source
again with one extra C entry for each variant below (one ``nvcc`` per
variant, started together; the group width W picked as the library picks
it for D <= 512) and runs each at B*H 128, S 512 and each D of ``--dims``,
causal and not: its registers and stack frame (cuobjdump), its error
against the plain version (each gradient within 1e-4 (f32) or 2^-7 (bf16)
of its largest element), two runs held bitwise equal, and its time by
CUDA events around ``--iters`` launches (the variants in turns, forward
then backward through the list, each row's two times printed). The dkv
variants read delta = rowsum(dO * O) computed beside them. The port's
pair (its two C entries) is timed in the same turns, and ``--parent DIR``
adds another checkout's pair (its ``ff_flash_attention_bwd_{dq,dkv}_wide``
entries, built from its ``csrc``). Prints the card's name and power limit
first and one JSON object last. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from flexflow_tpu_torch.kernels import _build  # noqa: E402
from flexflow_tpu_torch.kernels import flash_attention as fa  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_fwd_wide_variants import _nvcc, resources, time_ms  # noqa: E402

# dq: (dtype, strips, key tile, chunk columns, ring slots, Q and dO
# resident); the port takes the first of each dtype, in f32 with the key
# tile 64 at W 144 and 192 (the second) and 32 at W 256
DQ_VARIANTS = [
    ("bfloat16", 4, 32, 64, 3, True), ("bfloat16", 4, 32, 64, 2, True),
    ("bfloat16", 4, 16, 64, 3, True), ("bfloat16", 4, 32, 64, 3, False),
    ("float32", 4, 32, 32, 2, False), ("float32", 4, 64, 32, 2, False),
    ("float32", 2, 32, 32, 3, True),
]
# dkv: (dtype, groups, strips, query tile, chunk columns, ring slots, K and
# V resident, reuse: a query tile's chunks of Q and dO loaded once for both
# products, W / KC + 1 slots); groups 4 of 2 strips is design (a) (W 80 or
# 128), 2 of 4 strips design (b) (W 144: up to 288 columns); the first of
# each design and dtype is the port's choice
DKV_VARIANTS = [
    ("bfloat16", 2, 4, 32, 64, 4, True, True), ("bfloat16", 2, 4, 32, 64, 3, True, False),
    ("bfloat16", 2, 4, 16, 64, 4, True, True), ("bfloat16", 2, 4, 32, 32, 6, True, True),
    ("bfloat16", 4, 2, 32, 64, 3, True, True), ("bfloat16", 4, 2, 32, 64, 2, True, False),
    ("bfloat16", 4, 2, 16, 64, 3, True, True), ("bfloat16", 4, 2, 32, 32, 5, True, True),
    ("float32", 2, 4, 16, 48, 4, True, True), ("float32", 2, 4, 16, 32, 6, True, True),
    ("float32", 2, 4, 32, 32, 2, True, False), ("float32", 2, 4, 16, 32, 3, True, False),
    ("float32", 4, 2, 32, 32, 2, False, False), ("float32", 4, 2, 16, 32, 3, True, False),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CTYPE = {"float32": "float", "bfloat16": "bf16"}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}  # of each gradient's largest
BH, SEQ = 128, 512
OUT_DIR = _build.BUILD_DIR / "bwd_wide_variants"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# pointers, then bh, sq, skv, d, scale, causal, [dtype,] stream
DQ_ARGS = [_P] * 8 + [_I] * 4 + [_F, _I, _P]
DKV_ARGS = [_P] * 9 + [_I] * 4 + [_F, _I, _P]
PROTO = ("int {name}(const void* q, const void* k, const void* v, const void* {a}, "
         "const void* g, const void* lse, {dl} delta, void* {o1}, {o2}int bh, int sq, "
         "int skv, int d, float scale, int causal, void* stream) {{\n"
         "  const cudaStream_t s = static_cast<cudaStream_t>(stream);\n")


def entry(kind: str, variant) -> str:
    return f"probe_{kind}_" + "_".join(str(int(x)) if isinstance(x, bool) else str(x)
                                       for x in variant)


def probe_source(kind: str, variant) -> str:
    """A C entry that launches the variant at the group width the library
    would pick for d <= 512 (dq: the least of 144, 192, 256 that covers
    half of d; dkv (a): 80 or 128 a quarter; dkv (b): 144, up to 288
    columns only: past them the entry returns an error and the variant is
    left out at that d)."""
    if kind == "dq":
        dtype, strips, bk, kc, nst, res = variant
        call = (f"launch_dq<{CTYPE[dtype]}, {strips}, {{w}}, {bk}, {kc}, {nst}, "
                f"{str(res).lower()}>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, "
                "causal, s)")
        body = (PROTO.format(name=entry(kind, variant), a="o", dl="void*", o1="dq", o2="")
                + "  const int cols = (d + 1) / 2;\n"
                f"  if (cols <= 144) return (int){call.format(w=144)};\n"
                f"  if (cols <= 192) return (int){call.format(w=192)};\n"
                f"  return (int){call.format(w=256)};\n}}\n")
    else:
        dtype, groups, strips, bq, kc, nst, res, reuse = variant
        call = (f"launch_dkv<{CTYPE[dtype]}, {groups}, {strips}, {{w}}, {bq}, {kc}, {{nst}}, "
                "{res}, {reuse}>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale, "
                "causal, s)")
        # with reuse the ring holds a tile's chunks and one more: W / KC + 1
        slots = {w: -(-w // kc) + 1 if reuse else nst for w in (80, 128, 144)}
        fmt = dict(res=str(res).lower(), reuse=str(reuse).lower())
        body = PROTO.format(name=entry(kind, variant), a="o", dl="const void*", o1="dk",
                            o2="void* dv, ")
        if groups == 4:
            body += ("  if ((d + 3) / 4 <= 80) return (int)"
                     + call.format(w=80, nst=slots[80], **fmt) + ";\n"
                     "  return (int)" + call.format(w=128, nst=slots[128], **fmt) + ";\n}\n")
        else:  # design (b) in one chunk only
            body += ("  if ((d + 1) / 2 > 144) return (int)cudaErrorInvalidValue;\n"
                     "  return (int)" + call.format(w=144, nst=slots[144], **fmt) + ";\n}\n")
    return '#include "flash_attention_bwd_wide.cu"\nextern "C" {\n' + body + "}\n"


def parent_source(parent: Path) -> Path:
    """The parent's backward above head dim 256: flash_attention_bwd_wide.cu,
    whose entries take the delta buffer, or before it flash_attention_wide.cu,
    whose entries do not."""
    csrc = parent / "flexflow_tpu_torch" / "kernels" / "csrc"
    return next(p for p in (csrc / "flash_attention_bwd_wide.cu",
                            csrc / "flash_attention_wide.cu") if p.is_file())


def build(parent: Path = None) -> dict:
    """One shared library per variant (and one of the parent's backward
    above head dim 256); {(kind, variant) or "parent": path}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kind, variants in (("dq", DQ_VARIANTS), ("dkv", DKV_VARIANTS)):
        for variant in variants:
            name = entry(kind, variant)
            src = OUT_DIR / f"{name}.cu"
            src.write_text(probe_source(kind, variant))
            lib = OUT_DIR / f"{name}.so"
            jobs[(kind, variant)] = (lib, _nvcc(src, lib, _build.CSRC_DIR))
    if parent is not None:
        csrc = parent / "flexflow_tpu_torch" / "kernels" / "csrc"
        lib = OUT_DIR / "parent_bwd_wide.so"
        jobs["parent"] = (lib, _nvcc(parent_source(parent), lib, csrc))
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = {key: pool.submit(subprocess.run, cmd, capture_output=True, text=True,
                                 timeout=900) for key, (_, cmd) in jobs.items()}
        for key, fut in done.items():
            r = fut.result()
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed for {key}:\n{r.stderr[-4000:]}")
    return {key: lib for key, (lib, _) in jobs.items()}


def _fn(lib: Path, name: str, argtypes: list):
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _launcher(fn, ptrs: list, tail: tuple):
    def call():
        err = fn(*ptrs, *tail)
        if err:
            raise RuntimeError(f"launch failed: error {err}")
    return call


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
        usage[str(key)] = resources(lib, "flash_bwd")
        print(f"resources {key}: {usage[str(key)]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    port_lib = libs[("dq", DQ_VARIANTS[0])]
    for dtype_name, dtype in DTYPES.items():
        code = 1 if dtype == torch.bfloat16 else 0
        for d in (int(x) for x in args.dims.split(",")):
            q, k, v, g = (torch.randn((BH, SEQ, d), generator=gen, device="cuda").to(dtype)
                          for _ in range(4))
            scale = d ** -0.5
            for causal in (False, True):
                o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
                want = fa.flash_attention_bwd_reference(q, k, v, o, g, lse, causal, scale)
                delta = (g.float() * o.float()).sum(-1).contiguous()
                tail = (BH, SEQ, SEQ, d, scale, int(causal))
                cases = []  # (label, [calls], outputs, gradient names)
                for kind, variants in (("dq", DQ_VARIANTS), ("dkv", DKV_VARIANTS)):
                    for variant in variants:
                        if variant[0] != dtype_name:
                            continue
                        outs = ([torch.empty_like(q)] if kind == "dq"
                                else [torch.empty_like(k), torch.empty_like(v)])
                        fn = _fn(libs[(kind, variant)], entry(kind, variant),
                                 DQ_ARGS if kind == "dq" else DKV_ARGS)
                        ptrs = [t.data_ptr() for t in (q, k, v, o, g, lse, delta, *outs)]
                        cases.append(((kind, variant), [_launcher(fn, ptrs, tail + (stream,))],
                                      outs, ("dq",) if kind == "dq" else ("dk", "dv")))
                pairs = [("port", port_lib, "ff_flash_attention_bwd_{}_wide", True)]
                if "parent" in libs:
                    pairs.append(("parent", libs["parent"], "ff_flash_attention_bwd_{}_wide",
                                  parent_source(args.parent).name != "flash_attention_wide.cu"))
                for label, lib, name, with_delta in pairs:
                    outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
                    scratch = torch.empty_like(delta)
                    base = [t.data_ptr() for t in (q, k, v, o, g, lse)]
                    base += [scratch.data_ptr()] if with_delta else []
                    ints = [_I] * 4 + [_F, _I, _I, _P]
                    dq_fn = _fn(lib, name.format("dq"), [_P] * (len(base) + 1) + ints)
                    dkv_fn = _fn(lib, name.format("dkv"), [_P] * (len(base) + 2) + ints)
                    full = tail + (code, stream)
                    cases.append((label, [_launcher(dq_fn, base + [outs[0].data_ptr()], full),
                                          _launcher(dkv_fn, base + [outs[1].data_ptr(),
                                                                    outs[2].data_ptr()], full)],
                                  outs, ("dq", "dk", "dv")))
                found = []
                for label, calls, outs, names in cases:
                    def run(calls=calls):
                        for c in calls:
                            c()
                    try:
                        run()
                    except RuntimeError as e:  # a design that does not take this d
                        print(f"variant {dtype_name} D={d} {label}: left out ({e})")
                        continue
                    torch.cuda.synchronize()
                    first = [t.clone() for t in outs]
                    run()
                    torch.cuda.synchronize()
                    bitwise = all(torch.equal(a, b) for a, b in zip(first, outs))
                    errs = {}
                    for nm, got in zip(names, outs):
                        ref = want[("dq", "dk", "dv").index(nm)].float()
                        errs[nm] = (got.float() - ref).abs().max().item() / ref.abs().max().item()
                    if not (bitwise and max(errs.values()) <= TOL[dtype]):
                        raise RuntimeError(f"{label} D={d} causal={causal}: errors {errs} "
                                           f"(tol {TOL[dtype]}), bitwise {bitwise}")
                    found.append(dict(variant=label if isinstance(label, str) else
                                      dict(kernel=label[0], config=label[1]),
                                      dtype=dtype_name, d=d, causal=causal, errors=errs,
                                      bitwise_equal_runs=bitwise, ms=[], run=run))
                order = list(range(len(found)))
                for i in order + order[::-1]:
                    found[i]["ms"].append(time_ms(found[i]["run"], args.iters))
                for row in found:
                    row.pop("run")
                    print(f"variant {dtype_name} D={d} causal={causal} {row['variant']}: err "
                          + ", ".join(f"{n} {e:.3g}" for n, e in row["errors"].items())
                          + f"; ms {row['ms'][0]:.4f}, {row['ms'][1]:.4f} [{card}]", flush=True)
                rows += found
            del q, k, v, g
    print(json.dumps({"card": card, "shape": [BH, SEQ], "resources": usage,
                      "variants": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
