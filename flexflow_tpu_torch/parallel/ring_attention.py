"""Sequence-parallel attention: ring and all-to-all (Ulysses).

PyTorch counterpart of ``flexflow_tpu/parallel/ring_attention.py``, in
torch ops as the JAX module's are ``jnp`` einsums (XLA, not a Pallas
kernel). Each rank holds a (B, S/n, H, D) block of q, k and v, sharded on
the sequence over a mesh axis of degree n.

* :func:`ring_attention` keeps its query block and passes its k/v block
  round the ring (``collectives.ring_shift``, n-1 times), accumulating
  with the online-softmax recurrence (:func:`_block_attn`), so the
  softmax over the whole sequence is exact; causal blocks are masked, not
  skipped, as in the JAX module.
* :func:`ulysses_attention` re-shards q/k/v from sequence to heads with
  one all-to-all each, attends over the whole sequence locally
  (:func:`single_device_attention`) and re-shards the output back.

The accumulation runs in float32 whatever the input dtype (the JAX module
accumulates in the input dtype) and the output is cast back. With dropout
the caller passes ``u``, the uniform draws of the whole (B, H, S, S)
probability matrix as the one-rank op draws them, already cut to this
rank's batch and heads: each block keeps the probabilities whose draw is
below 1 - rate, so the mask is the one-rank run's. The JAX module drops
the unnormalised weights while the normaliser accumulates undropped ones,
which is the same mask applied to the normalised probabilities.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import collectives as C


def _keep(p: torch.Tensor, rate: float, u: Optional[torch.Tensor]) -> torch.Tensor:
    if rate <= 0.0 or u is None:
        return p
    keep = 1.0 - rate
    return torch.where(u < keep, p / keep, torch.zeros_like(p))


def _block_attn(q, k, v, m_prev, l_prev, o_prev, mask, rate=0.0, u=None):
    """One online-softmax step. q: (B, Sq, H, D), k/v: (B, Sk, H, D); m/l:
    (B, H, Sq) running max and normaliser, o: (B, H, Sq, D); ``mask``
    (Sq, Sk) additive (0 or -inf) or None."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        s = s + mask
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    # a row masked so far (m = -inf) must not give exp(-inf - -inf) = nan
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
    corr = torch.exp(torch.where(torch.isneginf(m_prev), torch.full_like(m_prev, -torch.inf),
                                 m_prev - m_safe))
    corr = torch.where(torch.isneginf(m_prev), torch.zeros_like(corr), corr)
    l_new = corr * l_prev + p.sum(dim=-1)
    o_new = corr[..., None] * o_prev + torch.einsum("bhqk,bkhd->bhqd", _keep(p, rate, u), v)
    return m_new, l_new, o_new


def single_device_attention(q, k, v, causal: bool, scale: float, rate: float = 0.0,
                            u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention on (B, S, H, D) blocks (top-left causal mask to
    -inf, softmax, the ``u`` mask, PV), in float32."""
    dt = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = _keep(torch.softmax(s, dim=-1), rate, u)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(dt)


def _check(q, k, v, name: str) -> None:
    if q.shape[1] != k.shape[1] or k.shape[1] != v.shape[1]:
        raise ValueError(f"{name} needs equal q/k/v seq lengths, got "
                         f"{q.shape[1]}/{k.shape[1]}/{v.shape[1]}")


def ring_attention(q, k, v, mesh, axis: str, causal: bool = False,
                   scale: Optional[float] = None, dropout_rate: float = 0.0,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention of q/k/v blocks (B, S/n, H, D) sequence-sharded over
    ``axis``; returns this rank's (B, S/n, H, D) block of the output."""
    _check(q, k, v, "ring attention")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if mesh is None or mesh.degree(axis) == 1:
        return single_device_attention(q, k, v, causal, scale, dropout_rate, u)
    group = mesh.group([axis])
    n, ridx = group.size, group.index
    dt = q.dtype
    ql = q.float() * scale
    b, sq, h, d = ql.shape
    m = torch.full((b, h, sq), -torch.inf, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    o = torch.zeros((b, h, sq, d), device=q.device)
    kv = torch.stack([k.float(), v.float()])
    pos = torch.arange(sq, device=q.device)
    for s in range(n):
        src = (ridx - s) % n  # the block held at step s came from rank src
        mask = None
        if causal:
            qpos = ridx * sq + pos[:, None]
            kpos = src * sq + pos[None, :]
            mask = torch.where(qpos >= kpos, 0.0, -torch.inf)
        ub = None
        if u is not None and dropout_rate > 0.0:
            ub = u[:, :, ridx * sq:(ridx + 1) * sq, src * sq:(src + 1) * sq]
        m, l, o = _block_attn(ql, kv[0], kv[1], m, l, o, mask, dropout_rate, ub)
        if s < n - 1:
            kv = C.ring_shift(kv, group)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l[..., None]).permute(0, 2, 1, 3).to(dt)


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """(B, S/n, H, D) sequence-sharded -> (B, S, H/n, D) head-sharded."""
    n = group.size
    b, sl, h, d = x.shape
    send = x.reshape(b, sl, n, h // n, d).permute(2, 0, 1, 3, 4)  # chunk j: heads of rank j
    got = C.all_to_all(send, group)  # slot j: sequence block j
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * sl, h // n, d)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """(B, S, H/n, D) head-sharded -> (B, S/n, H, D) sequence-sharded."""
    n = group.size
    b, s, hl, d = x.shape
    send = x.reshape(b, n, s // n, hl, d).permute(1, 0, 2, 3, 4)  # chunk j: seq block j
    got = C.all_to_all(send, group)  # slot j: heads of rank j
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hl, d)


def ulysses_attention(q, k, v, mesh, axis: str, causal: bool = False,
                      scale: Optional[float] = None, dropout_rate: float = 0.0,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-to-all sequence parallelism: heads must divide by the axis
    degree. Same blocks in and out as :func:`ring_attention`."""
    _check(q, k, v, "ulysses attention")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if mesh is None or mesh.degree(axis) == 1:
        return single_device_attention(q, k, v, causal, scale, dropout_rate, u)
    group = mesh.group([axis])
    n = group.size
    if q.shape[2] % n:
        raise ValueError(f"ulysses attention needs heads % degree == 0, got "
                         f"{q.shape[2]} % {n}")
    hl = q.shape[2] // n
    ub = None
    if u is not None and dropout_rate > 0.0:
        ub = u[:, group.index * hl:(group.index + 1) * hl]
    o = single_device_attention(_seq_to_heads(q, group), _seq_to_heads(k, group),
                                _seq_to_heads(v, group), causal, scale, dropout_rate, ub)
    return _heads_to_seq(o, group)
