"""Flash attention: the Hopper kernels' wrappers and their plain versions.

PyTorch counterpart of ``flexflow_tpu/kernels/flash_attention.py``. The
TPU's ``_fwd_kernel`` becomes ``csrc/flash_attention_fwd.cu`` and its
``_dq_kernel``/``_dkv_kernel`` become ``csrc/flash_attention_bwd.cu``, all
on the tensor cores up to head dim 256 (f32 with split TF32 products, never
single-pass TF32). Above 256 they run on the tensor cores too, in
``csrc/flash_attention_fwd_wide.cu`` and ``csrc/flash_attention_bwd_wide.cu``
(the head dim cut across warp groups that swap their partial products; the
source notes give the designs and the bounds on an H100). Like the JAX
kernel, every function here takes any head dim. This module holds:

* :func:`flash_attention` — the public entry on (B, S, H, D) tensors, with
  the JAX package's layout glue and its length contract (``_pick_block``),
  differentiable through :class:`_FlashAttention`, the counterpart of the
  ``_flash`` custom VJP; :func:`attend`, the same without the length
  contract, which the attention op calls at any sequence length;
* :func:`sharded_flash_attention` — the JAX package's ``shard_map`` of the
  kernel over a mesh's batch and heads axes: each rank holds its
  (B/dp, S, H/tp, D) block already and runs :func:`attend` on it, the
  same kernels (it takes any length and head dim, so the JAX module's
  ``sharded_supported`` has nothing to check);
* :func:`flash_attention_fwd` / :func:`flash_attention_bwd` — the wrappers
  on (B*H, S, D) tensors: the kernels for CUDA tensors, the plain versions
  for CPU tensors;
* :func:`flash_attention_fwd_reference` /
  :func:`flash_attention_bwd_reference` — the plain versions, in f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import count_launch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp()/max() NaN-free
# the one-pass kernels are built for padded head dims up to this one (any
# D <= it); above it the wrappers launch the ``_wide`` kernels
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _pick_block(s: int, pref: int) -> Optional[int]:
    for b in (pref, 256, 128, 64, 32, 16, 8):
        if b <= s and s % b == 0:
            return b
    return None


def _check_head_dim(d: int) -> None:
    if d < 1:
        raise ValueError(f"flash_attention: head dim {d} (must be at least 1)")


def _entry(lib, name: str, d: int):
    """The C entry of a kernel for head dim ``d``: the one-pass kernels up to
    :data:`MAX_HEAD_DIM`, the ``..._wide`` ones above it."""
    return getattr(lib, name if d <= MAX_HEAD_DIM else f"{name}_wide")


def _causal_keep(sq: int, skv: int, device) -> torch.Tensor:
    """(Sq, Skv) bool, True where qpos >= kpos (``_causal_mask``)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    return qpos >= kpos


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool,
                                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: q (BH, Sq, D), k/v
    (BH, Skv, D) -> out (BH, Sq, D) in q's dtype and lse (BH, 1, Sq) in
    f32. The math of ``_fwd_kernel``, in f32, with the same -1e30 mask."""
    qf = q.float() * scale
    s = torch.matmul(qf, k.float().transpose(-1, -2))  # (BH, Sq, Skv)
    if causal:
        s = s.masked_fill(~_causal_keep(s.shape[-2], s.shape[-1], s.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l)).transpose(-1, -2)  # (BH, 1, Sq)
    return out.to(q.dtype), lse


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  g: torch.Tensor, lse: torch.Tensor,
                                  causal: bool, scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: the forward's inputs,
    its output ``o`` and log-sum-exp ``lse`` (BH, 1, Sq), and the output's
    cotangent ``g`` -> (dq, dk, dv) in the inputs' dtype. The math of
    ``_dq_kernel`` and ``_dkv_kernel`` line by line, in f32: P comes from
    the saved lse, not from a fresh softmax."""
    qf = q.float() * scale
    kf, vf, gf, of = k.float(), v.float(), g.float(), o.float()
    s = torch.matmul(qf, kf.transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_causal_keep(s.shape[-2], s.shape[-1], s.device), NEG_INF)
    p = torch.exp(s - lse.transpose(-1, -2))            # softmax probabilities
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = torch.sum(gf * of, dim=-1, keepdim=True)   # rowsum(dO * O)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)        # qf already carries scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_args(name: str, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, *rest: torch.Tensor) -> bool:
    """Shape, device and dtype checks shared by the wrappers; ``rest`` are
    further (B*H, Sq, D) tensors of q's dtype. Returns True for CUDA
    tensors that the kernels take, False for CPU tensors; raises on what
    neither path takes."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name} takes (B*H, S, D) tensors")
    bh, _, d = q.shape
    skv = k.shape[1]
    if (k.shape != (bh, skv, d) or v.shape != k.shape
            or any(t.shape != q.shape for t in rest)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, {[tuple(t.shape) for t in rest]} do not match")
    tensors = (q, k, v) + rest
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors of different dtypes")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} (kernel takes float32, bfloat16)")
    _check_head_dim(d)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's wrapper: q (BH, Sq, D), k/v (BH, Skv, D) ->
    (out, lse) as :func:`flash_attention_fwd_reference` returns them. A
    CUDA tensor launches ``csrc/flash_attention_fwd.cu``
    (``flash_attention_fwd_wide.cu`` for D > 256) on the current stream, a
    tensor-core kernel in both dtypes at every D: in
    bf16 bf16 products, with P rounded to bf16 before P V as FlashAttention
    does; in f32 split TF32 products (three TF32 products for each f32 one,
    f32-accurate). A CPU tensor runs the plain version."""
    if not _check_kernel_args("flash_attention_fwd", q, k, v):
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    from ._build import check_launch, load_library

    lib = load_library()
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, 1, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _entry(lib, "ff_flash_attention_fwd", d)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, sq, k.shape[1], d, float(scale),
            int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    check_launch(err, "flash_attention_fwd")
    count_launch("flash_attention_fwd")
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, g: torch.Tensor, lse: torch.Tensor,
                        causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' wrapper, with the signature of
    :func:`flash_attention_bwd_reference`. A CUDA tensor launches the dq
    kernel and then the dkv kernel of ``csrc/flash_attention_bwd.cu``
    (``flash_attention_bwd_wide.cu`` for D > 256) on the current stream:
    the tensor-core kernels, bf16 products in bf16 and split TF32 products
    (three TF32 products for each f32 one, f32-accurate) in f32, which pass
    delta = rowsum(dO * O) from the first to the second through a (B*H, Sq)
    f32 buffer. A CPU tensor runs the plain version."""
    on_card = _check_kernel_args("flash_attention_bwd", q, k, v, o, g)
    bh, sq, d = q.shape
    if lse.shape != (bh, 1, sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(
            f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype} on "
            f"{lse.device}, want ({bh}, 1, {sq}) float32 on {q.device}")
    if not on_card:
        return flash_attention_bwd_reference(q, k, v, o, g, lse, causal, scale)
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous")
    from ._build import check_launch, load_library

    lib = load_library()
    skv = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    args = (bh, sq, skv, d, float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    ptrs = [t.data_ptr() for t in (q, k, v, o, g, lse, delta)]
    with torch.cuda.device(q.device):
        err = _entry(lib, "ff_flash_attention_bwd_dq", d)(*ptrs, dq.data_ptr(), *args)
        check_launch(err, "flash_attention_bwd_dq")
        count_launch("flash_attention_bwd_dq")
        err = _entry(lib, "ff_flash_attention_bwd_dkv", d)(*ptrs, dk.data_ptr(),
                                                          dv.data_ptr(), *args)
        check_launch(err, "flash_attention_bwd_dkv")
        count_launch("flash_attention_bwd_dkv")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Differentiable attention on (B*H, S, D) tensors: the counterpart of
    ``_flash.defvjp(_flash_fwd, _flash_bwd)``. ``plain`` picks the plain
    versions instead of the wrappers; the rest of the path is the same."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, plain: bool):
        fwd = flash_attention_fwd_reference if plain else flash_attention_fwd
        out, lse = fwd(q, k, v, causal, scale)
        if any(ctx.needs_input_grad[:3]):  # nothing is kept for inference
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.plain = causal, scale, plain
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_reference if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, g.contiguous(), lse, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def _to_bh(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           scale: Optional[float], plain: bool) -> torch.Tensor:
    """Differentiable attention on (B, S, H, D) tensors at any Sq, Skv >= 1
    and any head dim: layout glue around :class:`_FlashAttention`, the
    plain versions when ``plain``. The entry of the attention op, which
    the reference's op serves at every length (its kernel where a block
    fits, ``single_device_attention`` elsewhere; the same top-left causal
    mask either way): the kernels zero-fill ragged tiles, so they need no
    block contract."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if sq < 1 or skv < 1:
        raise ValueError(f"attend: seq lengths ({sq}, {skv}) (must be at least 1)")
    _check_head_dim(d)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = _FlashAttention.apply(_to_bh(q), _to_bh(k), _to_bh(v), causal, scale, plain)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def sharded_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                            batch_axis: Optional[str], heads_axis: Optional[str],
                            causal: bool = False, scale: Optional[float] = None,
                            plain: bool = False) -> torch.Tensor:
    """Flash attention over a mesh: q/k/v are this rank's (B/dp, S, H/tp, D)
    blocks, sharded on batch over ``batch_axis`` and on heads over
    ``heads_axis`` (None: not sharded). Attention is independent across
    both, so each rank runs the kernels on its block (no collective);
    sequence-sharded attention goes through ``parallel/ring_attention.py``."""
    for name, ax in (("batch", batch_axis), ("heads", heads_axis)):
        if ax is not None and mesh.degree(ax) == 1:
            raise ValueError(f"sharded_flash_attention: {name} axis {ax!r} is not a "
                             f"mesh axis of degree above 1 ({mesh.shape})")
    return attend(q, k, v, causal, scale, plain)


def _check_lengths(sq: int, skv: int) -> None:
    """The JAX function's block contract (``_pick_block``)."""
    if _pick_block(sq, 128) is None or _pick_block(skv, 128) is None:
        raise ValueError(
            f"flash_attention: seq lengths ({sq}, {skv}) have no valid "
            f"block size (must be divisible by 8)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused, differentiable attention. q/k/v: (B, S, H, D), the
    framework's layout; any head dim. Raises ``ValueError`` on sequence
    lengths not divisible by 8 (the JAX package's contract); :func:`attend`
    takes any length."""
    _check_lengths(q.shape[1], k.shape[1])
    return attend(q, k, v, causal, scale, plain=False)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` through the plain versions on any device:
    the path the card's kernels are held against."""
    _check_lengths(q.shape[1], k.shape[1])
    return attend(q, k, v, causal, scale, plain=True)
