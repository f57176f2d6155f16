"""The single-call pipeline engine: one ``train_step`` call replays the
whole schedule over flat packed buffers.

PyTorch counterpart of ``flexflow_tpu/parallel/pipeline_compiled.py``,
whose engine lowers the schedule into one jitted program (``lax.scan``
over the ticks, a collective permute over the pipe ring a tick). Here the
one call is the rank's own loop over the tick table:

* the stage's params and optimizer state live in one flat float32 buffer
  each (the stage's weights are views into it), the gradients accumulate
  into a third, and the boundary values travel packed into fixed-width
  float32 buffers (:func:`_pack`: bfloat16 upcast, int32 bit-cast, both
  exact);
* every tick ends in one ring exchange over the pipe group, whether the
  stage worked or not: the packed forward output to the next stage and
  the packed cotangents to the previous one (zeros when idle), the ring's
  wrap edge carrying the interleaved chunks back to stage 0;
* the edge and saved-input slots are allocated statically by an interval
  pass over the tick table (:func:`_build_tables`), so values in flight
  never collide;
* each backward recomputes its chunk's forward from the saved packed
  input (remat by construction: only boundary values are kept);
* the update runs in the same call, on the packed buffers' views.

Apart from the tick's exchange there is no host round trip per action.
Gradients accumulate in microbatch order, the same additions the host
engine makes, so both engines give the same numbers bit for bit on the
CPU.

Envelope (:func:`compiled_engine_unsupported`, the JAX package's):

* the ``pipe`` and ``pipe`` x ``data`` mesh families;
* schedules ``gpipe``, ``1f1b`` and ``interleaved``;
* under a data submesh, only batch-linear graphs: ops whose statistics
  couple the examples of a batch (BatchNorm, the MoE routing family,
  Dropout) stay on the host engine (:func:`dp_unsupported_reason`);
* float32 params and optimizer state (the stage's weights are views of
  one float32 buffer); boundary values of float32, bfloat16 or int32.

Outside it ``make_pipelined_model(engine="auto")`` records the reason and
builds the host engine; ``engine="compiled"`` raises.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.machine import DATA_AXIS
from ..ffconst import OpType
from . import collectives as C
from .pipeline import _BWD_TAG, _FWD_TAG, PipelineConfig, PipelinedModel, _float_meta
from .schedule import SCHEDULES

_PACK_DTYPES = (torch.float32, torch.bfloat16, torch.int32)

# ops whose math couples the examples of a batch: on a data submesh each
# shard would compute its own statistics, routing or masks, where the host
# engine reads the microbatch whole
_DP_BATCH_COUPLED_OPS = frozenset({
    OpType.BATCHNORM, OpType.DROPOUT, OpType.GROUP_BY, OpType.AGGREGATE,
    OpType.AGGREGATE_SPEC, OpType.GROUP_BY_STACKED, OpType.EXPERT_LINEAR,
    OpType.AGGREGATE_STACKED, OpType.CACHE,
})


def dp_unsupported_reason(ops, dp: int) -> Optional[str]:
    """None when the op graph is batch-linear; else the one-line reason.
    A data degree of 1 is always fine."""
    if dp <= 1 or ops is None:
        return None
    bad = sorted({op.op_type.value for op in ops if op.op_type in _DP_BATCH_COUPLED_OPS})
    if bad:
        return (f"batch-coupled op(s) {bad} under a data submesh (per-shard statistics "
                f"would diverge from the host engine's full-batch lowering)")
    return None


def compiled_engine_unsupported(mesh, cfg: PipelineConfig, ops=None,
                                batch_size: Optional[int] = None) -> Optional[str]:
    """None when the single-call engine can run on (mesh, cfg); else the
    one-line reason (the fallback's record and the forced engine's
    error)."""
    if cfg.schedule not in SCHEDULES:
        return (f"schedule {cfg.schedule!r} is host-driven "
                f"(compiled supports {'|'.join(SCHEDULES)})")
    sizes = dict(mesh.shape) if mesh is not None else {}
    extra = {a: s for a, s in sizes.items() if a not in (cfg.axis, DATA_AXIS) and s > 1}
    if extra:
        return (f"mesh has non-trivial axes {extra} besides '{cfg.axis}'/'{DATA_AXIS}' — "
                f"compiled covers the pipe and pipe×data families only")
    if sizes.get(cfg.axis, 1) < 2:
        return f"mesh {cfg.axis} axis has degree < 2"
    dp = sizes.get(DATA_AXIS, 1)
    if dp > 1:
        reason = dp_unsupported_reason(ops, dp)
        if reason:
            return reason
        if batch_size is not None:
            M = max(1, int(cfg.num_microbatches))
            if batch_size % M or (batch_size // M) % dp:
                return f"batch {batch_size} does not split into {M} microbatches × {dp} data shards"
    return None


# ------------------------------------------------------------- packing
def _leaf_segments(leaves) -> Tuple[List[Tuple], int]:
    """(segments, total length) of float32 elements for ``leaves`` ((name,
    shape, dtype) entries): each segment (offset, length, shape, dtype).
    Raises NotImplementedError on a dtype the buffers do not take (the
    engine choice's fallback point)."""
    segs, off = [], 0
    for _, shape, dtype in leaves:
        if dtype not in _PACK_DTYPES:
            raise NotImplementedError(f"cannot pack dtype {dtype} into the single-call "
                                      f"engine's float32 buffers")
        n = int(np.prod(shape)) if len(shape) else 1
        segs.append((off, n, tuple(shape), dtype))
        off += n
    return segs, off


def _pack(tensors, segs, total: int, device) -> torch.Tensor:
    """``tensors`` flattened into one (total,) float32 buffer: bfloat16
    upcast, int32 bit-cast (both exact), the tail zero."""
    buf = torch.zeros(total, dtype=torch.float32, device=device)
    for t, (off, n, _, dtype) in zip(tensors, segs):
        v = t.detach().reshape(-1)
        buf[off:off + n] = v.view(torch.float32) if dtype == torch.int32 else v.float()
    return buf


def _unpack(buf: torch.Tensor, segs) -> List[torch.Tensor]:
    """Inverse of :func:`_pack`."""
    out = []
    for off, n, shape, dtype in segs:
        v = buf[off:off + n]
        if dtype == torch.int32:
            v = v.view(torch.int32)
        elif dtype != torch.float32:
            v = v.to(dtype)
        out.append(v.reshape(shape))
    return out


# -------------------------------------------------------------- tables
_IDLE, _F, _B, _FB = 0, 1, 2, 3


def _interval_slots(T: int, S: int, produces: Dict, consumes: Dict
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Static slot assignment by interval allocation: ``produces`` maps
    ``(chunk, mb) -> (tick, stage)`` where a value lands in a stage's
    buffer, ``consumes`` the tick and stage that read it. A slot is taken
    from the stage's free pool at the producing tick and returned after
    the consuming tick. Returns (write table, read table, ring size);
    write entries with no event point at the scratch slot ``ring size``."""
    w = np.full((T, S), -1, np.int64)
    r = np.zeros((T, S), np.int64)
    arr_by_tick: Dict[int, List] = {}
    con_by_tick: Dict[int, List] = {}
    for key, (t, s) in produces.items():
        arr_by_tick.setdefault(t, []).append((s, key))
    for key, (t, s) in consumes.items():
        con_by_tick.setdefault(t, []).append((s, key))
    free: List[List[int]] = [[] for _ in range(S)]
    hi = [0] * S
    slot_of: Dict = {}
    R = 0
    for t in range(T):
        for s, key in sorted(arr_by_tick.get(t, ())):
            if key not in consumes:
                continue
            if free[s]:
                slot = heapq.heappop(free[s])
            else:
                slot = hi[s]
                hi[s] += 1
                R = max(R, hi[s])
            slot_of[key] = slot
            w[t, s] = slot
        ends = []
        for s, key in sorted(con_by_tick.get(t, ())):
            slot = slot_of.pop(key)
            r[t, s] = slot
            ends.append((s, slot))
        for s, slot in ends:
            heapq.heappush(free[s], slot)
    R = max(R, 1)
    w = np.where(w >= 0, w, R)
    return w.astype(np.int32), r.astype(np.int32), R


def _build_tables(sched) -> Dict[str, Any]:
    """The per-(tick, stage) control tables of the replay: action kind,
    microbatch and chunk, the edge buffers' write and read slots and the
    saved inputs' save and read slots. A value sent at tick t arrives at
    the start of tick t+1 on stage ``(chunk ± 1) % S``."""
    S, T = sched.num_stages, sched.num_ticks
    C_ = S * sched.interleave
    kinds = np.zeros((T, S), np.int32)
    mbs = np.zeros((T, S), np.int32)
    chs = np.zeros((T, S), np.int32)
    karr = {"F": _F, "B": _B, "FB": _FB}
    prod_f: Dict = {}
    cons_f: Dict = {}
    prod_b: Dict = {}
    cons_b: Dict = {}
    prod_s: Dict = {}
    cons_s: Dict = {}
    for t, row in enumerate(sched.ticks):
        for s, a in enumerate(row):
            if a is None:
                continue
            kinds[t, s] = karr[a.kind]
            mbs[t, s] = a.mb
            chs[t, s] = a.chunk
            if a.kind == "F" and a.chunk < C_ - 1:
                prod_f[(a.chunk + 1, a.mb)] = (t + 1, (a.chunk + 1) % S)
            if a.kind in ("F", "FB") and a.chunk > 0:
                cons_f[(a.chunk, a.mb)] = (t, s)
            if a.kind in ("B", "FB") and a.chunk > 0:
                prod_b[(a.chunk - 1, a.mb)] = (t + 1, (a.chunk - 1) % S)
            if a.kind == "B" and a.chunk < C_ - 1:
                cons_b[(a.chunk, a.mb)] = (t, s)
            # saved inputs for the remat backward: chunk-0 forwards replay
            # from the model inputs and save nothing
            if a.kind == "F" and a.chunk > 0:
                prod_s[(a.chunk, a.mb)] = (t, s)
            if a.kind == "B" and a.chunk > 0:
                cons_s[(a.chunk, a.mb)] = (t, s)
    wf, rf, R_f = _interval_slots(T, S, prod_f, cons_f)
    wb, rb, R_b = _interval_slots(T, S, prod_b, cons_b)
    sv, rs, K = _interval_slots(T, S, prod_s, cons_s)
    return dict(kinds=kinds, mbs=mbs, chunks=chs, wf=wf, rf=rf, wb=wb, rb=rb, sv=sv, rs=rs,
                R_f=R_f, R_b=R_b, K=K)


def _tensor_leaves(tree, path=()):
    """(path, tensor) over the tensor leaves of a nested dict, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tensor_leaves(v, path + (k,))
        elif torch.is_tensor(v):
            yield path + (k,), v


def _set_leaf(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


class CompiledPipelinedModel(PipelinedModel):
    """The single-call engine: ``train_step`` replays the whole tick table
    in one call over the stage's packed buffers. Stage splitting, the
    chunk functions, ``forward_only``, ``eval_step`` and the sync surface
    are the host engine's; the stage's weights and optimizer state are
    views into the packed buffers, so everything that reads them sees the
    trained values."""

    engine_name = "compiled"

    def __init__(self, cm, cfg: PipelineConfig):
        reason = compiled_engine_unsupported(cm.mesh, cfg, ops=cm.ops,
                                             batch_size=cm.input_tensors[0].dims[0])
        if reason is not None:
            raise NotImplementedError(reason)
        super().__init__(cm, cfg)
        dev = cm.device
        # the stage's weights become views of one float32 buffer, in the
        # compiled model's params too (so loading weights reaches them)
        p_leaves = [((op, w), t) for op, ws in self.stage_params.items() for w, t in ws.items()]
        o_leaves = list(_tensor_leaves(self.stage_opt_state))
        for _, t in p_leaves + o_leaves:
            if t.dtype != torch.float32:
                raise NotImplementedError(f"cannot pack dtype {t.dtype} into the single-call "
                                          f"engine's float32 buffers")
        self._p_segs, self._Lp = _leaf_segments([(k, tuple(t.shape), t.dtype)
                                                 for k, t in p_leaves])
        self._o_segs, self._Lo = _leaf_segments([(k, tuple(t.shape), t.dtype)
                                                 for k, t in o_leaves])
        self._p_keys = [k for k, _ in p_leaves]
        self.theta = _pack([t for _, t in p_leaves], self._p_segs, self._Lp, dev)
        self.opt_buf = _pack([t for _, t in o_leaves], self._o_segs, self._Lo, dev)
        for ((op, w), _), (off, n, shape, _) in zip(p_leaves, self._p_segs):
            view = self.theta[off:off + n].view(shape)
            self.stage_params[op][w] = view
            cm.params[op][w] = view
        for (path, _), (off, n, shape, _) in zip(o_leaves, self._o_segs):
            _set_leaf(self.stage_opt_state, path, self.opt_buf[off:off + n].view(shape))
        self._tables = _build_tables(self.schedule)
        self._width: Dict[int, int] = {}  # rows -> boundary buffer width

    def _ring_width(self, meta, rows: int) -> int:
        """The boundary buffers' float32 width at this microbatch size: the
        largest boundary, summed over the pipe group from each boundary's
        sender (every rank must send and receive the same width)."""
        if rows not in self._width:
            sizes = torch.zeros(len(meta), dtype=torch.float64)
            for c, m in enumerate(meta):
                if m is not None and self._mine(c):
                    sizes[c] = _leaf_segments(m)[1]
            sizes = C.all_reduce_sum(sizes.to(self.cm.device), self.pipe)
            self._width[rows] = max(1, int(sizes.max().item()))
        return self._width[rows]

    def train_step(self, rng, xs, y):
        """The schedule as one call, recorded as one annotated span; with
        ``exec_telemetry`` on, the first step is measured as the
        ``pipeline.<schedule>`` program."""
        from ..obs.exec_telemetry import collect_one, telemetry_mode
        from ..obs.trace import span

        cfg = self.cm.config
        with span("pipe.step.compiled", cat="pipeline", schedule=self.cfg.schedule,
                  interleave=self.cfg.interleave, stages=len(self.stages),
                  microbatches=self.cfg.num_microbatches, dispatches=1):
            if self.exec_telemetry is None and telemetry_mode(cfg) == "on":
                box: list = []
                self.exec_telemetry = collect_one(
                    f"pipeline.{self.cfg.schedule}",
                    lambda: box.append(self._train_step(rng, xs, y)), self.cm.device,
                    config=cfg, static_peak=self._static_bytes(xs),
                    allow=getattr(cfg, "exec_mem_allow", None))
                # a failed measured step raises its error here
                out = box[0] if box else self._train_step(rng, xs, y)
            else:
                out = self._train_step(rng, xs, y)
        self._feed_step_metrics()
        return out

    def _static_bytes(self, xs) -> int:
        """The stage's resident bytes: packed params and optimizer state,
        and the schedule's peak activations at this microbatch size."""
        rows = int(xs[0].shape[0]) // self.cfg.num_microbatches
        peak = self.peak_activation_bytes(rows)["per_stage"][self.stage]
        return (self.theta.numel() + self.opt_buf.numel()) * 4 + int(peak)

    def _train_step(self, rng, xs, y):
        M = self.cfg.num_microbatches
        dev = self.cm.device
        mbs = self._microbatches(xs, y)
        meta = self.boundary_meta(mbs[0][0])
        A = self._ring_width(meta, next(iter(mbs[0][0].values())).shape[0])
        segs = {c: _leaf_segments(m)[0] for c, m in enumerate(meta) if m is not None}
        cot_segs = {c: _leaf_segments(_float_meta(m))[0] for c, m in enumerate(meta)
                    if m is not None}
        tb, s, S = self._tables, self.stage, len(self.stages)
        fsl = torch.zeros(tb["R_f"] + 1, A, device=dev)
        bsl = torch.zeros(tb["R_b"] + 1, A, device=dev)
        saved = torch.zeros(tb["K"] + 1, A, device=dev)
        in_f = in_b = zeros = torch.zeros(A, device=dev)
        gacc = torch.zeros(self._Lp, device=dev)
        seg_of = dict(zip(self._p_keys, self._p_segs))
        weight = torch.tensor(1.0 / M, dtype=torch.float32, device=dev)
        terms: Dict[Tuple[int, int], torch.Tensor] = {}
        metric_sums = None
        self.step_dispatches = 1
        self.step_transfers = self.step_sent_bytes = 0
        nxt, prv = (s + 1) % S, (s - 1) % S

        def acts_of(buf, c):
            return dict(zip([k for k, *_ in meta[c]], _unpack(buf, segs[c])))

        def add_grads(dp):
            for op, ws in dp.items():
                for w, g in ws.items():
                    off, n, _, _ = seg_of[(op, w)]
                    gacc[off:off + n].add_(g.reshape(-1))

        for t in range(len(self.schedule.ticks)):
            fsl[tb["wf"][t, s]] = in_f
            bsl[tb["wb"][t, s]] = in_b
            kind, m, c = int(tb["kinds"][t, s]), int(tb["mbs"][t, s]), int(tb["chunks"][t, s])
            send_f = send_b = zeros
            if kind != _IDLE:
                mrng = self._mb_rng(rng, m, c)
                if kind == _F:
                    inbuf = fsl[tb["rf"][t, s]]
                    acts = mbs[m][0] if c == 0 else acts_of(inbuf, c - 1)
                    with torch.no_grad():
                        out, aux = self._run_chunk(c, self._chunk_params(c), acts, True, mrng)
                    send_f = _pack([out[k] for k, *_ in meta[c]], segs[c], A, dev)
                    saved[tb["sv"][t, s]] = inbuf if c > 0 else zeros
                    terms[(m, c)] = aux
                else:
                    if kind == _FB:
                        acts = mbs[m][0] if c == 0 else acts_of(fsl[tb["rf"][t, s]], c - 1)
                        rec = self._forward_vjp(c, acts, mrng, mbs[m][1])
                        dp, da = self._backward(c, rec, {}, weight)
                        loss, logits = rec[4]
                        terms[(m, c)] = loss.detach() + rec[3].detach()
                        bm = self._metrics(logits, mbs[m][1])
                        metric_sums = bm if metric_sums is None else {
                            k: metric_sums[k] + v for k, v in bm.items()}
                    else:
                        acts = mbs[m][0] if c == 0 else acts_of(saved[tb["rs"][t, s]], c - 1)
                        d_out = dict(zip([k for k, *_ in _float_meta(meta[c])],
                                         _unpack(bsl[tb["rb"][t, s]], cot_segs[c])))
                        rec = self._forward_vjp(c, acts, mrng)
                        dp, da = self._backward(c, rec, d_out, weight)
                    del rec
                    add_grads(dp)
                    if c > 0:
                        send_b = _pack([da[k] for k, *_ in _float_meta(meta[c - 1])],
                                       cot_segs[c - 1], A, dev)
            # one ring exchange a tick, idle or not
            in_f, in_b = C.send_recv(self.pipe, [(nxt, _FWD_TAG, send_f), (prv, _BWD_TAG, send_b)],
                                     [(prv, _FWD_TAG, A, torch.float32, dev),
                                      (nxt, _BWD_TAG, A, torch.float32, dev)])
            self.step_transfers += 2
            self.step_sent_bytes += 2 * A * 4
        grads = {}
        for (op, w), (off, n, shape, _) in zip(self._p_keys, self._p_segs):
            grads.setdefault(op, {})[w] = gacc[off:off + n].view(shape)
        self._apply(grads)
        self.step_dispatches = 1
        return self._result(terms, metric_sums)
