"""Collectives over the mesh's process groups, and their autograd pairs.

PyTorch counterpart of ``flexflow_tpu/parallel/collectives.py``. This is
the only module of the port that calls a ``torch.distributed``
collective. Each function takes a rank's local block; a ``Group``
(``core/machine.py``) names the ranks it runs among.

On a ``gloo`` group a CUDA tensor goes through a pinned host buffer:
copied to the host, reduced or moved there, copied back. The bytes copied each way
are counted (:func:`stats`), so a run can say what its ranks moved
through the host. An all-reduce is staged by gloo's own CUDA work: a
non-blocking copy into pinned host memory on a side stream that waits on
the caller's stream, the host reduction on gloo's worker thread, and a
non-blocking copy back that the caller's stream is ordered after. The
coalesced form (:func:`all_reduce_coalesced_async`, the mesh step's
gradient buckets) returns at once with a handle, so the calling thread
never waits for the card until the handle's ``wait``. A collective
observer (:func:`set_observer`) sees each
collective first, with its kind, its group's ranks, its partner table
for a shift or a point-to-point exchange and its staged bytes, and says
whether it counts in :func:`stats`: the program audit installs one that
records collectives for AUD005 and keeps a side recording's off.

The pairs that keep gradients exact under SPMD, each a
``torch.autograd.Function``:

==========================================  ==========  ==========
transition                                  forward     backward
==========================================  ==========  ==========
replicated -> sharded (:func:`scatter_to`)  slice       all_gather
partial sum -> replicated (:func:`reduce_from`)  all_reduce  identity
replicated input of a sharded compute
(:func:`copy_to`)                           identity    all_reduce
sharded -> replicated (:func:`gather_from`)  all_gather  slice
==========================================  ==========  ==========

:func:`ring_shift` (send to the next rank, receive from the previous;
backward the other way) and :func:`all_to_all` (its own transpose) carry
sequence-parallel attention. :func:`ring_all_reduce`,
:func:`psum_all_reduce`, :func:`expert_all_to_all` and
:func:`experts_to_tokens` are the JAX module's four functions; the last
two carry expert parallelism and are differentiable, each one's backward
the other. :func:`send_recv` is the pipeline's stage-boundary exchange:
point-to-point messages over the pipe group, each tagged by direction.
:func:`halo_rows` carries a spatially sharded convolution or pooling:
each rank receives the rows of its window that its neighbours hold, and
the backward sends their gradients back.

A batch gathered for an op that reads the whole batch (the MoE routing
ops) goes through :func:`gather_from`, whose backward keeps this rank's
rows: the op's output is cut back to this rank's rows by
:func:`scatter_to`, whose backward all-gathers the rows' gradients, so
every rank holds the whole gradient of the gathered tensor and a
reduce-scatter there would count it once per rank.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.machine import Group, Mesh

_stats_lock = threading.Lock()
_stats = {"calls": 0, "staged_bytes": 0}


def stats() -> Dict[str, int]:
    """Collective calls and bytes staged through the host (each way) since
    the last :func:`reset_stats`."""
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        _stats["calls"] = _stats["staged_bytes"] = 0


# called with (kind, ranks, table, staged); False keeps the call off stats()
_observer: Optional[Callable[..., bool]] = None


def set_observer(fn: Optional[Callable[..., bool]]) -> None:
    """Install the observer every collective calls first (None: none)."""
    global _observer
    _observer = fn


def _count(staged: int, kind: str, group: Group, table=None) -> None:
    observer = _observer
    if observer is not None and not observer(kind, group.ranks, table, staged):
        return
    with _stats_lock:
        _stats["calls"] += 1
        _stats["staged_bytes"] += staged


def _staged(group: Group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group.pg) == "gloo"


def _host(group: Group, t: torch.Tensor) -> torch.Tensor:
    """The buffer a collective runs on: a copy in pinned host memory on a
    gloo group (the copies to and from the card then run at the link's
    rate, as gloo's own CUDA staging of an all-reduce does), else ``t``
    made contiguous."""
    if _staged(group, t):
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t.detach())  # audit: callback-ok (a gloo group stages a CUDA tensor through the host by design, counted in stats(); NCCL groups do not)
        return buf
    return t.detach().contiguous()


def _like(buf: torch.Tensor) -> torch.Tensor:
    """An empty buffer like ``buf``, pinned where ``buf`` is."""
    return torch.empty(buf.shape, dtype=buf.dtype, device=buf.device,
                       pin_memory=buf.is_pinned())


def _back(t: torch.Tensor, buf: torch.Tensor, staged_in: int, kind: str,
          group: Group, table=None) -> torch.Tensor:
    if buf.device != t.device:
        out = buf.to(t.device)  # audit: const-ok (the staged result of a gloo collective, copied back to the card)
        _count(staged_in + buf.numel() * buf.element_size(), kind, group, table)
        return out
    _count(0, kind, group, table)
    return buf


# ------------------------------------------------------------ primitives
def _all_reduce(t: torch.Tensor, group: Group, op) -> torch.Tensor:
    # in place on a copy; on gloo a CUDA buffer goes through gloo's own CUDA
    # staging, as all_reduce_coalesced_async's (module docstring)
    buf = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=op, group=group.pg)
    _count(2 * buf.numel() * buf.element_size() if _staged(group, buf) else 0,
           "all_reduce", group)
    return buf


def all_reduce_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks (a new tensor)."""
    return _all_reduce(t, group, dist.ReduceOp.SUM)


def all_reduce_max(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise max of ``t`` over the group's ranks (no gradient:
    a class-parallel log-softmax's row max, an argmax's best value)."""
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def all_reduce_min(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise min of ``t`` over the group's ranks (no gradient:
    a class-parallel argmax's lowest index among the tied ranks)."""
    return _all_reduce(t, group, dist.ReduceOp.MIN)


def all_gather(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``t`` concatenated along ``dim`` in rank order."""
    buf = _host(group, t)
    n_in = buf.numel() * buf.element_size() if buf.device != t.device else 0
    parts = [_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.pg)
    return _back(t, torch.cat(parts, dim=dim), n_in, "all_gather", group)


def all_gather_coalesced(tensors: Sequence[torch.Tensor], group: Group,
                         dims: Sequence[int]) -> List[torch.Tensor]:
    """Each tensor's blocks concatenated along its ``dims`` entry in rank
    order, in one collective: the ranks' tensors (of one dtype and the
    same shapes on every rank) travel as one flat buffer."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = _host(group, flat)
    n_in = buf.numel() * buf.element_size() if buf.device != flat.device else 0
    parts = [_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.pg)
    sizes = [t.numel() for t in tensors]
    pieces = [p.split(sizes) for p in _back(flat, torch.cat(parts), n_in, "all_gather",
                                            group).split(flat.numel())]
    return [torch.cat([pieces[r][i].view(t.shape) for r in range(group.size)], dim=d)
            for i, (t, d) in enumerate(zip(tensors, dims))]


def _all_to_all_dim0(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Chunk ``j`` of ``t``'s dim 0 goes to rank ``j``; chunk ``j`` of the
    result came from rank ``j``."""
    buf = _host(group, t)
    n_in = buf.numel() * buf.element_size() if buf.device != t.device else 0
    out = _like(buf)
    dist.all_to_all_single(out, buf, group=group.pg)
    return _back(t, out, n_in, "all_to_all", group)


def _shift(t: torch.Tensor, group: Group, step: int) -> torch.Tensor:
    """Send ``t`` to the rank ``step`` places on in the group, receive
    from the rank ``step`` places back."""
    buf = _host(group, t)
    n_in = buf.numel() * buf.element_size() if buf.device != t.device else 0
    out = _like(buf)
    n = group.size
    to = group.ranks[(group.index + step) % n]
    frm = group.ranks[(group.index - step) % n]
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, to, group.pg),
                                   dist.P2POp(dist.irecv, out, frm, group.pg)])
    for r in reqs:
        r.wait()
    return _back(t, out, n_in, "shift", group, [(i, (i + step) % n) for i in range(n)])


class PendingAllReduce:
    """A coalesced all-reduce in flight (:func:`all_reduce_coalesced_async`):
    :meth:`wait` gives the sums."""

    def __init__(self, tensors: Sequence[torch.Tensor], group: Group, what: str,
                 parts: List[tuple]):
        self.shapes = [t.shape for t in tensors]
        self.group, self.what = group, what
        self._parts = parts  # (indices, flat buffer, work) a dtype

    def wait(self) -> List[torch.Tensor]:
        """The sums, in the tensors' order, on their device. On the card the
        caller's stream waits for the copy back (a gloo group's), or for
        NCCL's stream; the host waits for the reduction itself."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.shapes)
        for idx, flat, work in self._parts:
            try:
                work.wait()
            except RuntimeError as e:
                raise RuntimeError(f"{self.what}: the all-reduce over axes {self.group.axes} "
                                   f"(ranks {self.group.ranks}) failed: {e}") from e
            for i, part in zip(idx, flat.split([math.prod(self.shapes[i]) for i in idx])):
                out[i] = part.view(self.shapes[i])
        return out


def all_reduce_coalesced_async(tensors: Sequence[torch.Tensor], group: Group,
                               what: str = "all_reduce_coalesced") -> PendingAllReduce:
    """Start the sums of several tensors over the group, one flat buffer (and
    one collective) a dtype, and return at once. On a gloo group a CUDA
    buffer is staged by gloo's own CUDA work (module docstring): the copy
    to pinned host memory waits on the caller's stream through an event,
    not a drain, the host all-reduce starts on gloo's worker thread once
    that copy has landed, and :meth:`PendingAllReduce.wait` orders the
    caller's stream after the copy back; its bytes each way count in
    :func:`stats`. On NCCL the device buffer goes as it is. Collectives on
    one group are matched across ranks by the order they are issued in,
    so every rank must issue in the same order. A failure to issue or to
    finish raises, naming ``what`` and the group."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    parts = []
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        staged = 2 * flat.numel() * flat.element_size() if _staged(group, flat) else 0
        try:
            work = dist.all_reduce(flat, group=group.pg, async_op=True)
        except RuntimeError as e:
            raise RuntimeError(f"{what}: the all-reduce over axes {group.axes} "
                               f"(ranks {group.ranks}) failed to issue: {e}") from e
        _count(staged, "all_reduce", group)
        parts.append((idx, flat, work))
    return PendingAllReduce(tensors, group, what, parts)


def all_reduce_coalesced(tensors: Sequence[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """The sums of several tensors over the group, one flat buffer (and one
    collective) a dtype, waited for: :func:`all_reduce_coalesced_async`."""
    return all_reduce_coalesced_async(tensors, group).wait()


def all_gather_objects(obj) -> list:
    """Every rank's picklable ``obj`` over the default group, in rank
    order (a rank group's bookkeeping, off the data path)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _chunk(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % group.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into "
                         f"{group.size} blocks")
    step = size // group.size
    return t.narrow(dim, group.index * step, step).contiguous()


def send_recv(group: Group, sends: Sequence[tuple], recvs: Sequence[tuple]
              ) -> List[torch.Tensor]:
    """Point-to-point messages over ``group``: ``sends`` holds (peer index
    in the group, tag, tensor), ``recvs`` (peer index, tag, numel, dtype,
    device); returns the received tensors, 1-D, in ``recvs``' order. All
    are posted together and waited for. On a gloo group a CUDA tensor goes
    through the host both ways (counted by :func:`stats`)."""
    ops, bufs, staged = [], [], 0
    for peer, tag, t in sends:
        buf = _host(group, t).reshape(-1)
        if buf.device != t.device:
            staged += buf.numel() * buf.element_size()
        ops.append(dist.P2POp(dist.isend, buf, group.ranks[peer], group.pg, tag))
        bufs.append(buf)  # kept alive until the wait
    outs = []
    for peer, tag, numel, dtype, device in recvs:
        on_host = device.type == "cuda" and dist.get_backend(group.pg) == "gloo"
        buf = (torch.empty(numel, dtype=dtype, pin_memory=True) if on_host
               else torch.empty(numel, dtype=dtype, device=device))
        ops.append(dist.P2POp(dist.irecv, buf, group.ranks[peer], group.pg, tag))
        outs.append((buf, device))
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    got = []
    for buf, device in outs:
        if buf.device != device:
            staged += buf.numel() * buf.element_size()
            buf = buf.to(device)  # audit: const-ok (a message received on the host over gloo, copied to the card)
        got.append(buf)
    _count(staged, "send_recv", group, [(peer, tag) for peer, tag, _t in sends])
    return got


# ------------------------------------------------------ autograd pairs
class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x.contiguous(), group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all_dim0(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        # chunk j of the output came from rank j's chunk [index]: the
        # exchange is its own transpose
        return _all_to_all_dim0(g.contiguous(), ctx.group), None


def _overlap(a: tuple, b: tuple) -> tuple:
    return max(a[0], b[0]), min(a[1], b[1])


class _Halo(torch.autograd.Function):
    """The rows of a window along ``dim`` from the ranks that own them."""

    @staticmethod
    def forward(ctx, x, group, dim, windows):
        ctx.group, ctx.dim, ctx.windows, ctx.length = group, dim, windows, x.shape[dim]
        return _halo_forward(x, group, dim, windows)

    @staticmethod
    def backward(ctx, g):
        return _halo_backward(g.contiguous(), ctx.group, ctx.dim, ctx.windows,
                              ctx.length), None, None, None


def _clamped(windows: Sequence[tuple], total: int) -> List[tuple]:
    return [(max(0, lo), min(total, hi)) for lo, hi in windows]


def _halo_forward(x: torch.Tensor, group: Group, dim: int,
                  windows: Sequence[tuple]) -> torch.Tensor:
    me, n, length = group.index, group.size, x.shape[dim]
    wins = _clamped(windows, n * length)
    own = (me * length, (me + 1) * length)
    sends, recvs, pieces = [], [], {}
    for r in range(n):
        if r == me:
            continue
        lo, hi = _overlap(wins[r], own)
        if hi > lo:  # rows of mine in rank r's window
            sends.append((r, 0, x.narrow(dim, lo - own[0], hi - lo).contiguous()))
        lo, hi = _overlap(wins[me], (r * length, (r + 1) * length))
        if hi > lo:  # rows of rank r's in my window
            shape = list(x.shape)
            shape[dim] = hi - lo
            recvs.append((r, 0, math.prod(shape), x.dtype, x.device))
            pieces[r] = (lo, shape)
    got = send_recv(group, sends, recvs)
    for (r, (lo, shape)), t in zip(sorted(pieces.items()), got):
        pieces[r] = (lo, t.view(shape))
    lo, hi = _overlap(wins[me], own)
    if hi > lo:
        pieces[me] = (lo, x.narrow(dim, lo - own[0], hi - lo))
    return torch.cat([t for _, t in sorted(pieces.values(), key=lambda p: p[0])], dim=dim)


def _halo_backward(g: torch.Tensor, group: Group, dim: int, windows: Sequence[tuple],
                   length: int) -> torch.Tensor:
    me, n = group.index, group.size
    wins = _clamped(windows, n * length)
    own = (me * length, (me + 1) * length)
    shape = list(g.shape)
    shape[dim] = length
    grad = torch.zeros(shape, dtype=g.dtype, device=g.device)
    sends, recvs, where = [], [], []
    for r in range(n):
        if r == me:
            continue
        lo, hi = _overlap(wins[me], (r * length, (r + 1) * length))
        if hi > lo:  # the gradient of rank r's rows back to it
            sends.append((r, 1, g.narrow(dim, lo - wins[me][0], hi - lo).contiguous()))
        lo, hi = _overlap(wins[r], own)
        if hi > lo:  # the gradient of my rows from rank r's window
            part = list(shape)
            part[dim] = hi - lo
            recvs.append((r, 1, math.prod(part), g.dtype, g.device))
            where.append((lo - own[0], part))
    for t, (at, part) in zip(send_recv(group, sends, recvs), where):
        grad.narrow(dim, at, part[dim]).add_(t.view(part))
    lo, hi = _overlap(wins[me], own)
    if hi > lo:
        grad.narrow(dim, lo - own[0], hi - lo).add_(g.narrow(dim, lo - wins[me][0], hi - lo))
    return grad


def halo_rows(x: torch.Tensor, group: Group, dim: int, windows: Sequence[tuple]) -> torch.Tensor:
    """The rows ``[lo, hi)`` of ``dim`` that this rank's window
    ``windows[group.index]`` names, clamped to the whole tensor, when rank
    ``q`` of the group holds rows ``[q L, (q+1) L)`` (``L`` this block's
    length): its own rows and its neighbours' halo, sent point to point
    by their owners. Every rank passes every rank's window. The backward
    sends each row's gradient back to its owner, which sums the gradients
    of its rows from every window that read them."""
    return _Halo.apply(x, group, dim, tuple(tuple(w) for w in windows))


def scatter_to(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Replicated -> sharded on ``dim``: this rank's block; backward
    all-gathers the gradient."""
    return _ScatterTo.apply(x, group, dim)


def gather_from(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Sharded on ``dim`` -> replicated: the blocks concatenated; backward
    keeps this rank's block of the gradient."""
    return _GatherFrom.apply(x, group, dim)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Partial sums -> replicated: all-reduce; backward identity."""
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """A replicated input entering a computation sharded over the group:
    identity; backward all-reduces the partial gradients."""
    return _CopyTo.apply(x, group)


def ring_shift(x: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's ``x`` to the next rank of the group's ring, the previous
    rank's to this one; backward sends the gradient the other way."""
    return _RingShift.apply(x, group)


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Chunk ``j`` of dim 0 to rank ``j``; differentiable."""
    return _AllToAll.apply(x, group)


# --------------------------------------- the JAX module's four functions
def ring_all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' ``x``, scheduled as the NCCL ring:
    n-1 reduce-scatter steps of a chunk of dim 0 to the next rank, then
    n-1 all-gather steps. Dim 0 must split into the axis degree."""
    group = mesh.group([axis])
    n, me = group.size, group.index
    acc = list(x.chunk(n, dim=0))
    if len(acc) != n or x.shape[0] % n:
        raise ValueError(f"ring_all_reduce: dim 0 of {tuple(x.shape)} does not split "
                         f"into {n} chunks")
    acc = [a.clone() for a in acc]
    for s in range(n - 1):
        send_i, recv_i = (me - s) % n, (me - s - 1) % n
        acc[recv_i] = acc[recv_i] + _shift(acc[send_i], group, 1)
    # this rank owns the fully reduced chunk (me + 1) % n; pass it round
    own = (me + 1) % n
    for s in range(n - 1):
        i = (own - s) % n
        acc[(i - 1) % n] = _shift(acc[i], group, 1)
    return torch.cat(acc, dim=0)


def psum_all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' ``x``: one all-reduce."""
    return all_reduce_sum(x, mesh.group([axis]))


def _to_experts(x: torch.Tensor, group: Group) -> torch.Tensor:
    n = group.size
    e, c, d = x.shape
    if e % n:
        raise ValueError(f"expert_all_to_all: {e} experts over {n} ranks")
    # chunk j (rank j's experts) to rank j; rank r's tokens arrive in slot r
    got = _all_to_all_dim0(x.contiguous().reshape(n, e // n, c, d), group)
    return got.permute(1, 0, 2, 3).reshape(e // n, n * c, d)


def _to_tokens(x: torch.Tensor, group: Group) -> torch.Tensor:
    n = group.size
    el, c, d = x.shape
    if c % n:
        raise ValueError(f"experts_to_tokens: capacity {c} over {n} ranks")
    send = x.reshape(el, n, c // n, d).permute(1, 0, 2, 3).contiguous()
    return _all_to_all_dim0(send, group).reshape(n * el, c // n, d)


class _ExpertAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_experts(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_tokens(g.contiguous(), ctx.group), None


class _ExpertsToTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_tokens(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_experts(g.contiguous(), ctx.group), None


def expert_all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(experts, capacity/n, d) sharded on tokens -> (experts/n, capacity,
    d) sharded on experts: each rank receives its experts' tokens.
    Differentiable: the backward is :func:`experts_to_tokens`."""
    return _ExpertAllToAll.apply(x, mesh.group([axis]))


def experts_to_tokens(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Inverse of :func:`expert_all_to_all`: (experts/n, capacity, d) ->
    (experts, capacity/n, d). Differentiable: the backward is
    :func:`expert_all_to_all`."""
    return _ExpertsToTokens.apply(x, mesh.group([axis]))
