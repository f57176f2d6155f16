"""MoE dispatch/combine row movement: the Hopper kernels' wrappers, their
plain versions, the routing and the differentiable dispatch and combine.

PyTorch counterpart of ``flexflow_tpu/kernels/moe_kernels.py``. The TPU's
``_row_gather_kernel`` and ``_row_gather_sum_kernel`` become
``csrc/moe_kernels.cu`` (the source note gives the design and the bounds on
an H100). This module holds:

* :func:`row_gather` / :func:`row_gather_sum` — the wrappers: a CUDA tensor
  launches the kernel on the current stream (or raises), a CPU tensor runs
  the plain version;
* :func:`row_gather_reference` / :func:`row_gather_sum_reference` — the
  plain versions, ``index_select`` and f32 arithmetic in the kernels' order;
* :func:`compute_routing` and :func:`_slot_to_pick` — the capacity routing,
  O(T·n) integer work in plain PyTorch, as the JAX package keeps it in jnp;
* :class:`_Dispatch` / :class:`_Combine` — ``torch.autograd.Function`` classes,
  the counterparts of the ``_dispatch``/``_combine`` custom VJPs, whose
  backward passes run the same two kernels;
* :func:`moe_dispatch` / :func:`moe_combine` — the entry points of
  ``ops/moe_ops.py``.

Nothing here waits for the device: the routing's scatters and the kernels'
launches are all enqueued on the current stream.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import count_launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def row_gather_reference(x: torch.Tensor, idx: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_gather`: ``out[i] = scale[i] * x[idx[i]]``,
    the product in f32, the output in x's dtype. Raises on an index outside
    ``[0, x.shape[0])``."""
    rows = x.index_select(0, idx.long()).float()
    return (scale.float()[:, None] * rows).to(x.dtype)


def row_gather_sum_reference(x: torch.Tensor, idx: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_gather_sum`: ``out[b] = sum_j w[b, j] *
    x[idx[b, j]]``, each product rounded to f32 and added to an f32 sum in
    the order j = 0..k-1, the output in x's dtype. Raises on an index
    outside ``[0, x.shape[0])``."""
    bsz, k = idx.shape
    acc = torch.zeros((bsz, x.shape[1]), dtype=torch.float32, device=x.device)
    wf = w.float()
    for j in range(k):
        acc = acc + wf[:, j, None] * x.index_select(0, idx[:, j].long()).float()
    return acc.to(x.dtype)


def _check_kernel_args(name: str, x: torch.Tensor, idx: torch.Tensor,
                       weights: torch.Tensor, idx_dims: int) -> bool:
    """Shape and device checks shared by the wrappers. Returns True for CUDA
    tensors that the kernels take, False for CPU tensors; raises on what
    neither path takes."""
    if x.dim() != 2 or idx.dim() != idx_dims or weights.shape != idx.shape:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} must be 2-D and idx {tuple(idx.shape)} "
            f"{idx_dims}-D, with weights {tuple(weights.shape)} of idx's shape")
    if idx.is_floating_point() or idx.is_complex():
        raise ValueError(f"{name}: idx of dtype {idx.dtype} (integer expected)")
    if len({x.device, idx.device, weights.device}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} (kernel takes float32, bfloat16)")
    if max(x.numel(), idx.numel()) >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 elements")
    return True


def _launch(name: str, fn, *args) -> None:
    from ._build import check_launch

    check_launch(fn(*args), name)
    count_launch(name)


def row_gather(x: torch.Tensor, idx: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``out[i, :] = scale[i] * x[idx[i], :]`` (idx int32, scale f32, the
    JAX wrapper's casts). x (R_in, d) -> (R_out, d) in x's dtype. A CUDA
    tensor launches ``ff_row_gather`` of ``csrc/moe_kernels.cu`` on the
    current stream; a CPU tensor runs :func:`row_gather_reference`."""
    if not _check_kernel_args("row_gather", x, idx, scale, 1):
        return row_gather_reference(x, idx, scale)
    from ._build import load_library

    x = x.contiguous()
    idx = idx.to(torch.int32).contiguous()
    scale = scale.to(torch.float32).contiguous()
    out = torch.empty((idx.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        _launch("row_gather", load_library().ff_row_gather, x.data_ptr(), idx.data_ptr(),
                scale.data_ptr(), out.data_ptr(), x.shape[0], idx.shape[0], x.shape[1],
                _DTYPE_CODES[x.dtype], stream)
    return out


def row_gather_sum(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[b, :] = sum_j w[b, j] * x[idx[b, j], :]`` (idx (B, k) int32, w
    (B, k) f32). x (R_in, d) -> (B, d) in x's dtype. A CUDA tensor launches
    ``ff_row_gather_sum`` of ``csrc/moe_kernels.cu`` on the current stream;
    a CPU tensor runs :func:`row_gather_sum_reference`."""
    if not _check_kernel_args("row_gather_sum", x, idx, w, 2):
        return row_gather_sum_reference(x, idx, w)
    from ._build import load_library

    x = x.contiguous()
    idx = idx.to(torch.int32).contiguous()
    w = w.to(torch.float32).contiguous()
    bsz, k = idx.shape
    out = torch.empty((bsz, x.shape[1]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        _launch("row_gather_sum", load_library().ff_row_gather_sum, x.data_ptr(),
                idx.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], bsz, k,
                x.shape[1], _DTYPE_CODES[x.dtype], stream)
    return out


def _scatter_drop(size: int, target: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``zeros(size).at[target].set(values, mode="drop")``: targets outside
    ``[0, size)`` are dropped (written to a spare slot that is cut off)."""
    target = torch.where((target >= 0) & (target < size), target, size).long()
    out = torch.zeros(size + 1, dtype=values.dtype, device=values.device)
    return out.scatter_(0, target, values)[:size]


def pick_ranks(assign: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat, pos) of the T = B*k flattened picks: each pick's expert id
    (int64) and its rank among the earlier picks of the same expert."""
    flat = assign.reshape(-1).long()
    onehot = (flat[:, None] == torch.arange(n, device=assign.device)).long()  # (T, n)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=1)
    return flat, pos


def compute_routing(assign: torch.Tensor, n: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity routing shared by dispatch and combine, as the JAX package
    computes it. ``assign``: (B, k) int expert ids. Returns
      slot   (B, k) int32 — flat slot ``e*capacity + pos`` per token pick
                            (clamped to 0 when dropped),
      keep   (B, k) f32   — 1 iff the pick ranked under capacity,
      src    (n·capacity,) int32 — source *batch row* feeding each slot
                            (0 for empty slots),
      valid  (n·capacity,) f32 — 1 iff the slot is fed.
    """
    bsz, k = assign.shape
    dev = assign.device
    flat, pos = pick_ranks(assign, n)
    keep = pos < capacity
    slot = torch.where(keep, flat * capacity + pos, 0)
    n_slots = n * capacity
    target = torch.where(keep, slot, n_slots)
    tokens = torch.arange(bsz * k, device=dev)
    src = _scatter_drop(n_slots, target, (tokens // k).to(torch.int32))
    valid = _scatter_drop(n_slots, target, torch.ones(bsz * k, device=dev))
    return (slot.reshape(bsz, k).to(torch.int32), keep.reshape(bsz, k).float(),
            src, valid)


def _slot_to_pick(slot: torch.Tensor, keep: torch.Tensor, n_slots: int,
                  valid: torch.Tensor) -> torch.Tensor:
    """Invert slot: for each slot s, the flat pick index (b·k+j) feeding it;
    empty slots get 0 (the caller multiplies by ``valid``). Dropped picks
    carry a clamped slot of 0, so they are scattered out of range, where
    they cannot clobber slot 0's true pick."""
    picks = torch.arange(slot.numel(), dtype=torch.int32, device=slot.device)
    target = torch.where(keep.reshape(-1) > 0, slot.reshape(-1).long(), n_slots)
    inv = _scatter_drop(n_slots, target, picks)
    return torch.where(valid > 0, inv, 0)


class _Dispatch(torch.autograd.Function):
    """``rows = row_gather(x2d, src, valid)``, differentiable in ``x2d``:
    the counterpart of ``_dispatch.defvjp(_dispatch_fwd, _dispatch_bwd)``.
    ``plain`` picks the plain versions instead of the wrappers."""

    @staticmethod
    def forward(ctx, x2d, slot, keep, src, valid, plain: bool):
        gather = row_gather_reference if plain else row_gather
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(slot, keep)
        ctx.plain = plain
        return gather(x2d, src, valid)

    @staticmethod
    def backward(ctx, g):
        slot, keep = ctx.saved_tensors
        gather_sum = row_gather_sum_reference if ctx.plain else row_gather_sum
        # dx[b] = sum_j keep[b, j] * g_rows[slot[b, j]]
        dx = gather_sum(g.contiguous(), slot, keep)
        return dx, None, None, None, None, None


class _Combine(torch.autograd.Function):
    """``out = row_gather_sum(rows2d, slot, w * keep)``, differentiable in
    ``rows2d`` and ``w``: the counterpart of ``_combine.defvjp(_combine_fwd,
    _combine_bwd)``. ``plain`` as in :class:`_Dispatch`."""

    @staticmethod
    def forward(ctx, rows2d, w, slot, keep, src, valid, plain: bool):
        gather_sum = row_gather_sum_reference if plain else row_gather_sum
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(rows2d, w, slot, keep, src, valid)
        ctx.plain = plain
        return gather_sum(rows2d, slot, w * keep)

    @staticmethod
    def backward(ctx, g):
        rows2d, w, slot, keep, src, valid = ctx.saved_tensors
        gather = row_gather_reference if ctx.plain else row_gather
        g = g.contiguous()
        drows = dw = None
        if ctx.needs_input_grad[0]:
            # drows[s] = valid[s] * w_at[s] * g[src[s]]
            pick = _slot_to_pick(slot, keep, src.shape[0], valid)
            w_at_slot = (w * keep).reshape(-1)[pick.long()]
            drows = gather(g, src, valid * w_at_slot)
        if ctx.needs_input_grad[1]:
            # dw[b, j] = keep[b, j] * <g[b], rows[slot[b, j]]>
            bsz, k = slot.shape
            picked = gather(rows2d, slot.reshape(-1), keep.reshape(-1))
            dw = torch.einsum("bkd,bd->bk", picked.reshape(bsz, k, -1), g)
        return drows, dw, None, None, None, None, None


def moe_dispatch(x: torch.Tensor, assign: torch.Tensor, n: int, capacity: int,
                 plain: bool = False) -> torch.Tensor:
    """Scatter batch rows into (n, capacity, feat...) expert tensors
    (GroupBy). Differentiable in ``x``; dropped picks get zero rows, as the
    reference's zero-initialised fixed-capacity expert tensors do."""
    bsz = x.shape[0]
    slot, keep, src, valid = compute_routing(assign, n, capacity)
    rows = _Dispatch.apply(x.reshape(bsz, -1), slot, keep, src, valid, plain)
    return rows.reshape((n, capacity) + tuple(x.shape[1:]))


def moe_combine(expert_rows: torch.Tensor, assign: torch.Tensor,
                gate_w: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Gate-weighted combine of (n, capacity, d) expert outputs (Aggregate).
    Differentiable in ``expert_rows`` and ``gate_w`` (shape (B, k))."""
    n, capacity = expert_rows.shape[0], expert_rows.shape[1]
    slot, keep, src, valid = compute_routing(assign, n, capacity)
    return _Combine.apply(expert_rows.reshape(n * capacity, -1), gate_w, slot, keep,
                          src, valid, plain)
