"""Flash-attention forward: the Hopper kernel's wrapper and its plain version.

PyTorch counterpart of ``flexflow_tpu/kernels/flash_attention.py``. The
TPU's ``_fwd_kernel`` becomes ``csrc/flash_attention_fwd.cu`` (the source
note there gives its design and its bound on an H100). This module holds:

* :func:`flash_attention` — the public entry on (B, S, H, D) tensors, with
  the JAX package's layout glue and its length contract (``_pick_block``);
* :func:`flash_attention_fwd` — the wrapper on (B*H, S, D) tensors: the
  kernel for CUDA tensors, the plain version for CPU tensors;
* :func:`flash_attention_fwd_reference` — the plain version, in f32.

The backward kernels (``_dq_kernel``, ``_dkv_kernel``) come with the
training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import count_launch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp()/max() NaN-free
HEAD_DIMS = (32, 64, 128)  # the head dims the CUDA kernel is built for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _pick_block(s: int, pref: int) -> Optional[int]:
    for b in (pref, 256, 128, 64, 32, 16, 8):
        if b <= s and s % b == 0:
            return b
    return None


def _check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {d} is not one the kernel takes "
            f"{HEAD_DIMS}")


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool,
                                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: q (BH, Sq, D), k/v (BH, Skv, D)
    -> out (BH, Sq, D) in q's dtype and lse (BH, 1, Sq) in f32. The math
    of the TPU kernel, in f32, with the same -1e30 causal mask."""
    qf = q.float() * scale
    s = torch.matmul(qf, k.float().transpose(-1, -2))  # (BH, Sq, Skv)
    if causal:
        qpos = torch.arange(s.shape[-2], device=s.device)[:, None]
        kpos = torch.arange(s.shape[-1], device=s.device)[None, :]
        s = s.masked_fill(qpos < kpos, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l)).transpose(-1, -2)  # (BH, 1, Sq)
    return out.to(q.dtype), lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: q (BH, Sq, D), k/v (BH, Skv, D) -> (out, lse)
    as :func:`flash_attention_fwd_reference` returns them. A CUDA tensor
    launches ``csrc/flash_attention_fwd.cu`` on the current stream; a CPU
    tensor runs the plain version."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention_fwd takes (B*H, S, D) tensors")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if k.shape != (bh, skv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention_fwd: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention_fwd: q, k, v of different dtypes")
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash_attention_fwd: dtype {q.dtype} (kernel takes float32, "
            f"bfloat16)")
    _check_head_dim(d)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")
    if bh > 65535:
        raise ValueError(f"flash_attention_fwd: B*H = {bh} > 65535")
    from ._build import check_launch, load_library

    lib = load_library()
    out = torch.empty_like(q)
    lse = torch.empty((bh, 1, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.ff_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, sq, skv, d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], stream)
    check_launch(err, "flash_attention_fwd")
    count_launch("flash_attention_fwd")
    return out, lse


def _to_bh(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _attend(fwd, q, k, v, causal, scale) -> torch.Tensor:
    """(B, S, H, D) layout glue around a (B*H, S, D) forward."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if _pick_block(sq, 128) is None or _pick_block(skv, 128) is None:
        raise ValueError(
            f"flash_attention: seq lengths ({sq}, {skv}) have no valid "
            f"block size (must be divisible by 8)")
    _check_head_dim(d)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out, _ = fwd(_to_bh(q), _to_bh(k), _to_bh(v), causal, scale)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention. q/k/v: (B, S, H, D), the framework's layout.
    Raises ``ValueError`` on sequence lengths not divisible by 8 (the JAX
    package's contract) and on head dims the kernel does not take."""
    return _attend(flash_attention_fwd, q, k, v, causal, scale)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` through the plain version on any device:
    the path the card's kernel is held against."""
    return _attend(flash_attention_fwd_reference, q, k, v, causal, scale)
