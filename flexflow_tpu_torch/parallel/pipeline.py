"""Pipeline parallelism: the schedule-driven host engine (GPipe / 1F1B /
interleaved).

PyTorch counterpart of ``flexflow_tpu/parallel/pipeline.py``. Both
engines replay the same tick table (:mod:`.schedule`):

* :class:`PipelinedModel`, the host-driven engine (this module): each
  action is a call of its chunk's forward or backward; activations and
  cotangents cross stages as point-to-point messages over the pipe group
  (``collectives.send_recv``), only on the edges the tick table uses.
  Under 1F1B each microbatch's autograd residuals are freed by the
  backward that consumes them, so live activations are O(num_stages).
  Any mesh: the data and model axes keep working inside a stage;
* :class:`~.pipeline_compiled.CompiledPipelinedModel`, the single-call
  engine: one ``train_step`` call replays the whole table over flat
  packed buffers, with one ring exchange a tick.
  :func:`make_pipelined_model` picks it when its envelope holds and
  records the reason on ``fallback_reason`` when it does not.

The design, SPMD over ``torch.distributed`` (one process per rank):

* the compiled model's ops split into ``num_stages * interleave``
  contiguous chunks balanced by FLOPs (:func:`split_stages`); chunk ``c``
  runs on the ranks whose ``pipe`` coordinate is ``c % num_stages``, each
  rank only its own chunks' forwards and backwards;
* the global batch (every rank passes all of it) splits into
  ``num_microbatches`` microbatches, each sharded over the stage's data
  axis as the compiled model's layouts shard the batch;
* each microbatch's loss, and each chunk's auxiliary loss, is weighted by
  1/M; gradients accumulate over microbatches in microbatch order under
  every schedule, are all-reduced over the stage's data axes once a step,
  and each stage runs its own optimizer update;
* a step's loss and metric sums reach every rank with one all-reduce over
  the pipe and loss axes.

The boundary tensors' shapes at a microbatch size come from one probe
forward of the first microbatch through the chunks (the JAX package's
``eval_shape``), run once a microbatch size.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.machine import PIPE_AXIS
from ..core.parallel_tensor import ParallelDim, ParallelTensorShape
from ..ffconst import OpType
from ..obs.metrics import metrics_registry
from ..obs.trace import tracer
from ..runtime.compiler import CompiledModel, _forward_graph, _resolve_compute_dtype
from ..runtime.loss import compute_loss
from ..runtime.metrics import compute_batch_metrics
from . import collectives as C
from .schedule import PipelineSchedule, build_schedule, check_schedule, render_timeline, \
    schedule_summary

# message tags: activations travel to the next stage, cotangents back
_FWD_TAG, _BWD_TAG = 0, 1
# the probe's header: up to this many int64s describe a boundary
_HEADER = 1024
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int64, torch.bool,
           torch.float64, torch.uint8)


@dataclasses.dataclass
class PipelineConfig:
    """``compile(..., pipeline=PipelineConfig(...))``.

    ``schedule``: ``"gpipe"`` (all forwards, then all backwards),
    ``"1f1b"`` (one forward, one backward in the steady state: live
    activations O(num_stages)) or ``"interleaved"`` (1F1B over
    ``interleave`` chunks a stage). ``"auto"`` is resolved at compile by
    the simulator's ranking (``FFModel._resolve_pipeline``).

    ``remat=True`` recomputes each chunk's forward inside its backward
    (only stage-boundary activations are kept); by default the host
    engine keeps the autograd residuals until the consuming backward.

    ``engine``: ``"auto"`` picks the single-call engine when its envelope
    holds, else the host engine with the reason on ``fallback_reason``;
    ``"host"``/``"compiled"`` force one (``"compiled"`` outside its
    envelope raises)."""

    num_stages: int
    num_microbatches: int = 4
    axis: str = PIPE_AXIS
    remat: bool = False
    schedule: str = "gpipe"
    interleave: int = 1
    engine: str = "auto"
    # set once config.grad_accum_steps has been folded into
    # num_microbatches, so a config passed back never folds twice
    accum_folded: bool = False


def split_stages(ops: List, num_stages: int) -> List[List]:
    """Balanced contiguous split by FLOPs: stage boundaries at the FLOP
    prefix sum's quantiles, closing a stage early when exactly one op per
    remaining stage is left, so every stage is non-empty and the stages
    concatenate to the op order."""
    n = len(ops)
    if n < num_stages:
        raise ValueError(f"cannot split {n} ops into {num_stages} stages")
    costs = [max(op.flops(), 1.0) for op in ops]
    total = sum(costs)
    bounds: List[int] = []
    acc = 0.0
    for i, c in enumerate(costs):
        acc += c
        if len(bounds) == num_stages - 1:
            break
        rem_ops = n - (i + 1)
        rem_stages = num_stages - len(bounds) - 1
        if acc >= total * (len(bounds) + 1) / num_stages or rem_ops == rem_stages:
            bounds.append(i + 1)
    return [ops[a:b] for a, b in zip([0] + bounds, bounds + [n])]


def pipe_microbatches(batch_size: Optional[int]) -> int:
    """The microbatch count compile() gives a pipeline it enables on a
    pipe axis: the largest of 4, 2, 1 that divides the batch."""
    if batch_size is None:
        return 4
    return next((m for m in (4, 2, 1) if batch_size % m == 0), 1)


# ------------------------------------------------------------ messages
def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes in one flat uint8 buffer, each padded to 8."""
    parts = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        if b.numel() % 8:
            parts.append(torch.zeros(8 - b.numel() % 8, dtype=torch.uint8, device=b.device))
    if not parts:
        return torch.zeros(0, dtype=torch.uint8)
    return torch.cat(parts)


def _nbytes(meta) -> int:
    """The bytes :func:`_pack` gives tensors of ``meta`` ((tid, shape,
    dtype) entries)."""
    n = 0
    for _, shape, dtype in meta:
        b = torch.Size(shape).numel() * dtype.itemsize
        n += b + (-b) % 8
    return n


def _unpack(buf: torch.Tensor, meta) -> Dict[int, torch.Tensor]:
    out, off = {}, 0
    for tid, shape, dtype in meta:
        b = torch.Size(shape).numel() * dtype.itemsize
        out[tid] = buf[off:off + b].view(dtype).view(shape)
        off += b + (-b) % 8
    return out


def _float_meta(meta):
    """The entries that carry a cotangent."""
    return [m for m in meta if m[2].is_floating_point]


class PipelinedModel:
    """The host-driven engine behind ``FFModel.compile(pipeline=...)``.

    ``train_step(rng, xs, y) -> (loss, batch metric sums)`` replays the
    schedule's tick table on this rank's stage and updates the stage's
    params and optimizer state in place; ``xs`` and ``y`` are the global
    batch on every rank."""

    engine_name = "host"
    # set by make_pipelined_model when engine="auto" fell back to this
    # engine: the reason the single-call engine could not run
    fallback_reason: Optional[str] = None

    def __init__(self, cm: CompiledModel, cfg: PipelineConfig):
        mesh = cm.mesh
        if mesh is None or cfg.axis not in mesh.shape:
            raise ValueError(f"mesh has no '{cfg.axis}' axis for pipelining")
        S = mesh.shape[cfg.axis]
        if cfg.num_stages != S:
            raise ValueError(f"num_stages={cfg.num_stages} must equal mesh {cfg.axis} size {S}")
        check_schedule(cfg.schedule, S, cfg.num_microbatches, cfg.interleave)
        if any(op.op_type is OpType.BATCHNORM for op in cm.ops):
            warnings.warn("pipelined training does not update BatchNorm running statistics; "
                          "eval normalizes with the initial running stats", stacklevel=3)
        if cm.train_step is None:
            raise ValueError("a pipeline trains: compile with an optimizer and a loss")
        self.cm, self.cfg, self.mesh = cm, cfg, mesh
        self.optimizer = cm.optimizer
        self.cdt = _resolve_compute_dtype(cm.config.compute_dtype)
        self.input_ids = [t.tensor_id for t in cm.input_tensors]
        self.logits_id = cm.logits_tensor.tensor_id
        self.chunks: List[List] = split_stages(cm.ops, S * cfg.interleave)
        self.stages: List[List] = [[op for c in range(s, len(self.chunks), S)
                                    for op in self.chunks[c]] for s in range(S)]
        self.schedule: PipelineSchedule = build_schedule(
            cfg.schedule, S, cfg.num_microbatches, cfg.interleave)
        self.stage = mesh.coords[cfg.axis]
        self.pipe = mesh.group([cfg.axis])
        # the group a step's loss and metric sums are summed over: the pipe
        # axis and the axes the logits are sharded on
        axes = [cfg.axis] + list(cm.layouts[self.logits_id].partition_axes)
        self.result_group = mesh.group(axes)
        names = {op.name for op in self.stages[self.stage]}
        # this stage's params are the compiled model's tensors
        self.stage_params = {op: ws for op, ws in cm.params.items() if op in names}
        self.stage_wd = {op: cm.wd_mask[op] for op in self.stage_params}
        self.stage_opt_state = self.optimizer.init_state(self.stage_params) if cm.zero_dims \
            else _select(cm.opt_state, set(self.stage_params), set(cm.params))
        self._live = [self._live_after(c) for c in range(len(self.chunks))]
        self._meta: Dict[int, List] = {}  # rows -> boundary metas
        # the most recent train_step's counts (profile())
        self.step_dispatches = 0
        # the single-call engine's first step's telemetry (exec_telemetry)
        # and program audit (audit_programs)
        self.exec_telemetry = None
        self.audit_report = None
        self.step_transfers = 0
        self.step_sent_bytes = 0

    # ------------------------------------------------------------ layout
    def chunk_stage(self, c: int) -> int:
        return c % len(self.stages)

    def _mine(self, c: int) -> bool:
        return self.chunk_stage(c) == self.stage

    def _live_after(self, c: int) -> set:
        """Tensor ids that cross the c -> c+1 boundary: those a later
        chunk (or the loss) reads that exist by the end of chunk ``c``."""
        needed = {self.logits_id}
        for later in self.chunks[c + 1:]:
            for op in later:
                needed.update(t.tensor_id for t in op.layer.inputs)
        have = set(self.input_ids)
        for chunk in self.chunks[:c + 1]:
            for op in chunk:
                have.update(t.tensor_id for t in op.layer.outputs)
        return needed & have

    def _local_rows(self, t: torch.Tensor, dim0: ParallelDim) -> torch.Tensor:
        """This rank's rows of ``t`` when ``dim0`` shards the batch."""
        if not dim0.is_partitioned:
            return t
        step = t.shape[0] // dim0.degree
        if step * dim0.degree != t.shape[0]:
            raise ValueError(f"microbatch of {t.shape[0]} rows does not split over "
                             f"{dim0.axis!r} of degree {dim0.degree}")
        c = self.mesh.coords[dim0.axis]
        return t[c * step:(c + 1) * step]

    def _microbatches(self, xs: Sequence, y=None):
        """(per microbatch: this rank's input rows by tensor id, its label
        block), from the global batch."""
        M = self.cfg.num_microbatches
        dev = self.cm.device
        n = xs[0].shape[0]
        if n % M:
            raise ValueError(f"batch {n} not divisible by microbatches {M}")
        mb = n // M
        as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        out = []
        logits_dim0 = self.cm.layouts[self.logits_id].dims[0]
        for m in range(M):
            rows = slice(m * mb, (m + 1) * mb)
            ins = {tid: self._local_rows(as_t(x[rows]), self.cm.layouts[tid].dims[0])
                   for tid, x in zip(self.input_ids, xs)}
            lab = None
            if y is not None:
                lab = self.cm.label_block(self._local_rows(as_t(y[rows]), logits_dim0))
            out.append((ins, lab))
        return out

    # ------------------------------------------------------------ chunks
    def _chunk_params(self, c: int) -> Dict:
        return {op.name: self.stage_params[op.name] for op in self.chunks[c]
                if op.name in self.stage_params}

    def _run_chunk(self, c: int, params: Dict, acts: Dict[int, torch.Tensor], training: bool,
                   rng: Optional[int]) -> Tuple[Dict[int, torch.Tensor], torch.Tensor]:
        """(the boundary tensors chunk ``c`` hands on, its auxiliary losses
        summed in f32)."""
        out, aux = _forward_graph(self.chunks[c], self.cm.layouts, self.mesh, params, acts,
                                  self.cdt, training=training, rng=rng,
                                  seed=self.cm.config.seed, check_shapes=False)
        live = self._live[c]
        total = torch.zeros((), dtype=torch.float32, device=self.cm.device)
        for a in aux:
            total = total + a.float()
        return {k: v for k, v in out.items() if k in live}, total

    def _mb_rng(self, rng, m: int, c: int) -> Optional[int]:
        """The key of microbatch ``m`` in chunk ``c``: the remat backward
        derives the forward's, so it draws the same dropout masks."""
        return None if rng is None else int(rng) * 1_000_003 + m * 131 + c

    def _tail_loss(self, out, aux, y) -> Tuple[torch.Tensor, torch.Tensor]:
        """(this rank's share of the microbatch's loss, the f32 logits)."""
        cm = self.cm
        logits = out[self.logits_id].float()
        loss = cm.loss_share(compute_loss(cm.loss_type, logits, y, cm.from_logits), y)
        return loss, logits

    def _leaves(self, params: Dict) -> Dict:
        return {op: {w: t.detach().requires_grad_(True) for w, t in ws.items()}
                for op, ws in params.items()}

    def _vjp(self, outputs, grad_outputs, params: Dict, acts: Dict):
        """Gradients of ``outputs`` (weighted by ``grad_outputs``) with
        respect to the param leaves and the float inputs in ``acts``."""
        p_flat = [(op, w, t) for op, ws in params.items() for w, t in ws.items()]
        a_flat = [(k, t) for k, t in sorted(acts.items()) if t.requires_grad]
        pairs = [(o, g) for o, g in zip(outputs, grad_outputs) if o.requires_grad]
        inputs = [t for *_, t in p_flat] + [t for _, t in a_flat]
        gs = torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs],
                                 allow_unused=True) if pairs else [None] * len(inputs)
        dparams: Dict = {}
        for (op, w, t), g in zip(p_flat, gs):
            dparams.setdefault(op, {})[w] = torch.zeros_like(t) if g is None else g
        dacts = {k: (torch.zeros_like(t) if g is None else g)
                 for (k, t), g in zip(a_flat, gs[len(p_flat):])}
        return dparams, dacts

    def _grad_inputs(self, acts: Dict[int, torch.Tensor], c: int) -> Dict[int, torch.Tensor]:
        """A chunk's inputs as autograd leaves: the float boundary tensors
        of a chunk past the first take gradients."""
        if c == 0:
            return dict(acts)
        return {k: (v.detach().requires_grad_(True) if v.is_floating_point() else v)
                for k, v in acts.items()}

    def _forward_vjp(self, c: int, acts: Dict, rng, y=None):
        """Chunk ``c``'s training forward under autograd: (param leaves,
        input leaves, outputs, aux, the tail's (loss, logits) or None)."""
        params = self._leaves(self._chunk_params(c))
        acts = self._grad_inputs(acts, c)
        with torch.enable_grad():
            out, aux = self._run_chunk(c, params, acts, True, rng)
            tail = self._tail_loss(out, aux, y) if y is not None else None
        return params, acts, out, aux, tail

    def _backward(self, c: int, fwd, d_out: Dict[int, torch.Tensor], weight: torch.Tensor):
        """(param grads, input cotangents) of one chunk from its forward's
        record: the tail weights its loss and aux by ``weight``, a middle
        chunk takes ``d_out`` on its outputs and ``weight`` on its aux."""
        params, acts, out, aux, tail = fwd
        if tail is not None:
            outputs, grads = [tail[0] + aux], [weight]
        else:
            keys = sorted(k for k in d_out if k in out)
            outputs = [out[k] for k in keys] + [aux]
            grads = [d_out[k] for k in keys] + [weight]
        return self._vjp(outputs, grads, params, acts)

    # ------------------------------------------------------------- probe
    def boundary_meta(self, ins: Dict[int, torch.Tensor]) -> List:
        """The boundary tensors' (tid, local shape, dtype), sorted by tid,
        for each boundary this rank sends or receives (None elsewhere), at
        the microbatch size of ``ins`` (this rank's input rows): one
        forward of the chunks in order, each boundary's description sent
        with its tensors. Run once a microbatch size; collective over the
        pipe group."""
        rows = next(iter(ins.values())).shape[0] if ins else 0
        if rows in self._meta:
            return self._meta[rows]
        C_ = len(self.chunks)
        meta: List = [None] * (C_ - 1)
        acts = dict(ins)
        with torch.no_grad():
            for c in range(C_ - 1):
                src, dst = self.chunk_stage(c), self.chunk_stage(c + 1)
                if self._mine(c):
                    out, _ = self._run_chunk(c, self._chunk_params(c), acts, False, None)
                    m = [(k, tuple(out[k].shape), out[k].dtype) for k in sorted(out)]
                    meta[c] = m
                    if dst != self.stage:
                        head = torch.zeros(_HEADER, dtype=torch.int64)
                        flat = [len(m)] + [v for k, shape, dt in m
                                           for v in (k, _DTYPES.index(dt), len(shape), *shape)]
                        head[:len(flat)] = torch.tensor(flat)
                        C.send_recv(self.pipe, [(dst, _FWD_TAG, head.to(self.cm.device))], [])
                        C.send_recv(self.pipe, [(dst, _FWD_TAG, _pack([out[k] for k, *_ in m]))],
                                    [])
                    acts = out
                elif self._mine(c + 1):
                    (head,) = C.send_recv(self.pipe, [], [(src, _FWD_TAG, _HEADER, torch.int64,
                                                            self.cm.device)])
                    head, m, i = head.tolist(), [], 1  # audit: callback-ok (the boundary probe runs once a microbatch size: its metadata is cached after the first step)
                    for _ in range(head[0]):
                        k, dt, nd = head[i:i + 3]
                        m.append((k, tuple(head[i + 3:i + 3 + nd]), _DTYPES[dt]))
                        i += 3 + nd
                    meta[c] = m
                    (buf,) = C.send_recv(self.pipe, [], [(src, _FWD_TAG, _nbytes(m), torch.uint8,
                                                           self.cm.device)])
                    acts = _unpack(buf, m)
        self._meta[rows] = meta
        return meta

    # ------------------------------------------------------------ a step
    def _exchange(self, row, sends: List[tuple], meta) -> Dict[str, Dict]:
        """The tick's point-to-point messages: ``sends`` ((stage, tag,
        packed buffer): this rank's forward output to the next chunk's
        stage, its cotangents to the previous one) and what the tick's
        other actions send here. Returns {"f": activations by tid, "b":
        cotangents by tid} for what arrived."""
        C_ = len(self.chunks)
        recvs = []
        for s, a in enumerate(row):
            if a is None or s == self.stage:
                continue
            if a.kind == "F" and a.chunk < C_ - 1 and self._mine(a.chunk + 1):
                recvs.append(("f", s, _FWD_TAG, meta[a.chunk], (a.chunk + 1, a.mb)))
            if a.kind in ("B", "FB") and a.chunk > 0 and self._mine(a.chunk - 1):
                recvs.append(("b", s, _BWD_TAG, _float_meta(meta[a.chunk - 1]),
                              (a.chunk - 1, a.mb)))
        got = C.send_recv(self.pipe, sends,
                          [(s, tag, _nbytes(m), torch.uint8, self.cm.device)
                           for _, s, tag, m, _ in recvs])
        self.step_transfers += len(sends)
        self.step_sent_bytes += sum(b.numel() for *_, b in sends)
        return [(kind, key, _unpack(buf, m)) for (kind, _, _, m, key), buf in zip(recvs, got)]

    def train_step(self, rng, xs: Sequence, y):
        """One pipelined training step over the global batch ``xs``/``y``;
        returns (the step's loss, its batch metric sums), the same on every
        rank."""
        M = self.cfg.num_microbatches
        C_ = len(self.chunks)
        mbs = self._microbatches(xs, y)
        meta = self.boundary_meta(mbs[0][0])
        self.step_dispatches = self.step_transfers = self.step_sent_bytes = 0
        weight = torch.tensor(1.0 / M, dtype=torch.float32, device=self.cm.device)
        grad_acc = {op: {w: torch.zeros_like(t) for w, t in ws.items()}
                    for op, ws in self.stage_params.items()}
        fwd_in: Dict[Tuple[int, int], Dict] = {}    # arrived chunk inputs
        records: Dict[Tuple[int, int], tuple] = {}  # forward records (residuals)
        saved: Dict[Tuple[int, int], Dict] = {}     # remat: saved inputs
        d_in: Dict[Tuple[int, int], Dict] = {}      # arrived cotangents
        terms: Dict[Tuple[int, int], torch.Tensor] = {}  # (mb, chunk) -> loss/aux term
        metric_sums = None
        tr = tracer()
        for ti, row in enumerate(self.schedule.ticks):
            t_tick = tr.now() if tr.enabled else 0.0
            a = row[self.stage]
            sends: List[tuple] = []
            if a is not None:
                c, m = a.chunk, a.mb
                mrng = self._mb_rng(rng, m, c)
                self.step_dispatches += 1
                if a.kind == "F":
                    acts = mbs[m][0] if c == 0 else fwd_in.pop((c, m))
                    if self.cfg.remat:
                        saved[(c, m)] = acts
                        with torch.no_grad():
                            out, aux = self._run_chunk(c, self._chunk_params(c), acts, True,
                                                       mrng)
                    else:
                        rec = self._forward_vjp(c, acts, mrng)
                        records[(c, m)] = rec
                        out, aux = rec[2], rec[3]
                    terms[(m, c)] = aux.detach()
                    sends.append((self.chunk_stage(c + 1), _FWD_TAG,
                                  _pack([out[k] for k, *_ in meta[c]])))
                else:
                    if a.kind == "FB":
                        acts = mbs[m][0] if c == 0 else fwd_in.pop((c, m))
                        rec = self._forward_vjp(c, acts, mrng, mbs[m][1])
                        dp, da = self._backward(c, rec, {}, weight)
                        loss, logits = rec[4]
                        terms[(m, c)] = loss.detach() + rec[3].detach()
                        bm = self._metrics(logits, mbs[m][1])
                        metric_sums = bm if metric_sums is None else {
                            k: metric_sums[k] + v for k, v in bm.items()}
                    else:
                        rec = self._forward_vjp(c, saved.pop((c, m)), mrng) if self.cfg.remat \
                            else records.pop((c, m))
                        dp, da = self._backward(c, rec, d_in.pop((c, m)), weight)
                    del rec
                    for op, ws in dp.items():
                        for w, g in ws.items():
                            grad_acc[op][w] = grad_acc[op][w] + g
                    if c > 0:
                        sends.append((self.chunk_stage(c - 1), _BWD_TAG,
                                      _pack([da[k] for k, *_ in _float_meta(meta[c - 1])])))
            for kind, key, got in self._exchange(row, sends, meta):
                (fwd_in if kind == "f" else d_in)[key] = got
            if tr.enabled:
                # one span a schedule row, with this stage's action
                tr.complete("pipe.tick", t_tick, tr.now() - t_tick, cat="pipeline",
                            args={"tick": ti, "stage": self.stage,
                                  "actions": [] if a is None
                                  else [f"s{self.stage}:{a.kind}{a.mb}"]})
        out = self._finish(grad_acc, terms, metric_sums)
        self._feed_step_metrics()
        return out

    def _feed_step_metrics(self) -> None:
        """Mirror the step's dispatch and transfer counts into the metrics
        registry: the pipeline's series beside fit's and serving's."""
        reg = metrics_registry()
        reg.counter("pipeline.steps").inc()
        reg.counter("pipeline.dispatches").inc(self.step_dispatches)
        reg.counter("pipeline.transfers").inc(self.step_transfers)
        reg.gauge("pipeline.dispatches_per_step").set(self.step_dispatches)

    def _metrics(self, logits: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        cm = self.cm
        return compute_batch_metrics(cm.metrics, cm.loss_type, logits.detach(), y,
                                     cm.from_logits)

    def _apply(self, grad_acc: Dict) -> None:
        """The stage's gradients all-reduced over its data axes, then its
        optimizer update, in place."""
        grads = self.cm.sync_grads(grad_acc)
        self.optimizer.update(self.stage_params, grads, self.stage_opt_state, self.stage_wd,
                              self.optimizer.hyperparams())
        self.step_dispatches += 1

    def _finish(self, grad_acc, terms, metric_sums):
        self._apply(grad_acc)
        return self._result(terms, metric_sums)

    def _result(self, terms: Dict, metric_sums: Optional[Dict]):
        """(loss, metric sums) on every rank: this rank's terms in
        (microbatch, chunk) order and its metric sums, all-reduced over the
        pipe and loss axes in one buffer."""
        M = self.cfg.num_microbatches
        dev = self.cm.device
        local = torch.zeros((), dtype=torch.float64, device=dev)
        for key in sorted(terms):
            local = local + terms[key].double()
        keys = self._metric_keys()
        vals = [metric_sums[k].double() if metric_sums is not None
                else torch.zeros((), dtype=torch.float64, device=dev) for k in keys]
        total = C.all_reduce_sum(torch.stack([local] + vals), self.result_group)
        dtypes = self._metric_dtypes
        bm = {k: total[i + 1].to(dtypes[k]) for i, k in enumerate(keys)}
        return (total[0] / M).float(), bm

    def _metric_keys(self) -> List[str]:
        if not hasattr(self, "_metric_dtypes"):
            cm = self.cm
            lab = cm.label_tensor
            logits = torch.zeros((1,) + tuple(cm.logits_tensor.dims[1:]))
            y = torch.zeros((1,) + tuple(lab.dims[1:]), dtype=lab.dtype.to_torch())
            bm = compute_batch_metrics(cm.metrics, cm.loss_type, logits, y, cm.from_logits)
            self._metric_dtypes = {k: v.dtype for k, v in bm.items()}
        return sorted(self._metric_dtypes)

    # ---------------------------------------------------------- forward
    def forward_only(self, xs: Sequence) -> torch.Tensor:
        """The whole logits of the global batch ``xs`` on every rank: the
        chunks in order (the batch one microbatch), each boundary sent
        point to point, the last stage's logits gathered over its data
        axes and shared over the pipe group."""
        from ..ops.parallel_ops import reshard

        dev = self.cm.device
        ins = {tid: self._local_rows(torch.as_tensor(x, device=dev),
                                     self.cm.layouts[tid].dims[0])
               for tid, x in zip(self.input_ids, xs)}
        meta = self.boundary_meta(ins)
        C_ = len(self.chunks)
        acts, logits = ins, None
        with torch.inference_mode():
            for c in range(C_):
                # consecutive chunks always sit on different stages
                if c > 0 and self._mine(c):
                    (buf,) = C.send_recv(self.pipe, [], [(self.chunk_stage(c - 1), _FWD_TAG,
                                                          _nbytes(meta[c - 1]), torch.uint8,
                                                          dev)])
                    acts = _unpack(buf, meta[c - 1])
                if not self._mine(c):
                    continue
                acts, _ = self._run_chunk(c, self._chunk_params(c), acts, False, None)
                if c == C_ - 1:
                    logits = acts[self.logits_id].float()
                else:
                    C.send_recv(self.pipe, [(self.chunk_stage(c + 1), _FWD_TAG,
                                             _pack([acts[k] for k, *_ in meta[c]]))], [])
            lay = self.cm.layouts[self.logits_id]
            whole = ParallelTensorShape.unpartitioned(lay.sizes)
            if logits is not None:
                logits = reshard(logits, lay, whole, self.mesh)
            else:
                rows = xs[0].shape[0] * lay.sizes[0] // self.cm.input_tensors[0].dims[0]
                logits = torch.zeros((rows,) + tuple(lay.sizes[1:]), dtype=torch.float32,
                                     device=dev)
            return C.all_reduce_sum(logits, self.pipe)

    def eval_step(self, xs: Sequence, y):
        """(loss, whole logits, metric sums) of the global batch, on every
        rank, without updates."""
        logits = self.forward_only(xs)
        cm = self.cm
        lab = torch.as_tensor(y, device=cm.device)
        loss = compute_loss(cm.loss_type, logits, lab, cm.from_logits)
        bm = compute_batch_metrics(cm.metrics, cm.loss_type, logits, lab, cm.from_logits)
        return loss, logits, bm

    # ----------------------------------------------------- observability
    def _boundary_mb_bytes(self, mb_size: int) -> List[int]:
        """Each chunk's input bytes for one microbatch (chunk 0: the model
        inputs; chunk c > 0: the c-1 -> c boundary), at the whole
        (unsharded) sizes."""
        dims, item = {}, {}
        for chunk in self.chunks:
            for op in chunk:
                for t in list(op.layer.inputs) + list(op.layer.outputs):
                    dims[t.tensor_id] = tuple(t.dims)
                    item[t.tensor_id] = t.dtype.itemsize()

        def nbytes(tid: int) -> int:
            d = dims.get(tid)
            if not d:
                return 0
            n = mb_size
            for s in d[1:]:
                n *= s
            return n * item.get(tid, 4)

        out = [sum(nbytes(t) for t in self.input_ids)]
        for c in range(len(self.chunks) - 1):
            out.append(sum(nbytes(t) for t in self._live[c]))
        return out

    def peak_activation_bytes(self, mb_size: Optional[int] = None) -> Dict:
        """The schedule's peak live stage-boundary activation bytes: each
        forward's chunk-input bytes held until its backward consumes them.
        {"per_stage": [...], "max": int, "total": int}."""
        bbytes = self._boundary_mb_bytes(mb_size or 1)
        S = len(self.stages)
        live, peak = [0] * S, [0] * S
        for row in self.schedule.ticks:
            for s, a in enumerate(row):
                if a is None:
                    continue
                b = bbytes[a.chunk]
                if a.kind == "F":
                    live[s] += b
                elif a.kind == "B":
                    peak[s] = max(peak[s], live[s])
                    live[s] -= b
                else:
                    peak[s] = max(peak[s], live[s] + b)
            for s in range(S):
                peak[s] = max(peak[s], live[s])
        return {"per_stage": peak, "max": max(peak), "total": sum(peak)}

    def boundary_bytes_per_step(self, mb_size: int) -> int:
        """The bytes one step moves across stage boundaries, counted from
        the shapes at the whole microbatch size: each forward's output and
        each backward's float cotangents, as the tick table ships them."""
        dims, item, flt = {}, {}, {}
        for chunk in self.chunks:
            for op in chunk:
                for t in list(op.layer.inputs) + list(op.layer.outputs):
                    dims[t.tensor_id] = tuple(t.dims)
                    item[t.tensor_id] = t.dtype.itemsize()
                    flt[t.tensor_id] = t.dtype.to_torch().is_floating_point
        cdt = self.cdt.itemsize if self.cdt is not None else None

        def nbytes(tid: int, cot: bool) -> int:
            if cot and not flt[tid]:
                return 0
            n = mb_size
            for s in dims[tid][1:]:
                n *= s
            return n * (cdt if cdt and flt[tid] else item[tid])

        C_ = len(self.chunks)
        total = 0
        for row in self.schedule.ticks:
            for a in row:
                if a is None:
                    continue
                if a.kind == "F" and a.chunk < C_ - 1 and \
                        self.chunk_stage(a.chunk) != self.chunk_stage(a.chunk + 1):
                    total += sum(nbytes(t, False) for t in self._live[a.chunk])
                if a.kind in ("B", "FB") and a.chunk > 0 and \
                        self.chunk_stage(a.chunk) != self.chunk_stage(a.chunk - 1):
                    total += sum(nbytes(t, True) for t in self._live[a.chunk - 1])
        return total

    def profile(self, mb_size: Optional[int] = None) -> Dict:
        """The schedule's summary, the engine, this rank's counts from the
        most recent ``train_step`` and the schedule's peak activation
        bytes: ``fit_profile["pipeline"]``."""
        from .pipeline_compiled import compiled_engine_unsupported

        rec = schedule_summary(self.schedule)
        rec.update(engine=self.engine_name, requested_engine=self.cfg.engine,
                   fallback_reason=self.fallback_reason,
                   compiled_mesh_eligible=compiled_engine_unsupported(self.mesh, self.cfg)
                   is None,
                   remat=bool(self.cfg.remat), stage=self.stage,
                   dispatches_per_step=self.step_dispatches,
                   transfers_per_step=self.step_transfers,
                   sent_bytes_per_step=self.step_sent_bytes,
                   timeline=render_timeline(self.schedule))
        metrics_registry().gauge("pipeline.bubble_fraction").set(
            rec.get("bubble_fraction", 0.0))
        if mb_size:
            rec["peak_activation_bytes"] = self.peak_activation_bytes(mb_size)
            rec["boundary_bytes_per_step"] = self.boundary_bytes_per_step(mb_size)
        return rec

    # ------------------------------------------------------------- sync
    def sync_to(self, cm: CompiledModel) -> None:
        """Every stage's params into ``cm.params`` on every rank (one
        all-reduce over the pipe group, the other stages adding zeros),
        and this stage's optimizer state into ``cm.opt_state``. Collective
        over the pipe group."""
        mine = {op.name for op in self.stages[self.stage]}
        names = [(op, w) for op, ws in cm.params.items() for w in ws]
        with torch.no_grad():
            flat = [(self.stage_params[op][w] if op in mine else
                     torch.zeros_like(cm.params[op][w])) for op, w in names]
            summed = C.all_reduce_coalesced(flat, self.pipe)
            for (op, w), t in zip(names, summed):
                if cm.params[op][w] is not self.stage_params.get(op, {}).get(w):
                    cm.params[op][w].copy_(t)
            if not cm.zero_dims:
                _merge(cm.opt_state, self.stage_opt_state)

    def sync_from(self, cm: CompiledModel) -> None:
        """Re-seed this stage's params and optimizer state from ``cm``."""
        with torch.no_grad():
            for op, ws in self.stage_params.items():
                for w, t in ws.items():
                    if cm.params[op][w] is not t:
                        t.copy_(cm.params[op][w])
        if not cm.zero_dims:
            _merge(self.stage_opt_state, _select(cm.opt_state, set(self.stage_params),
                                                 set(cm.params)))

    def refresh_updates(self) -> None:
        """Called after a hyperparameter change; nothing to do: each
        update reads ``optimizer.hyperparams()`` afresh."""


def _select(tree, names: set, ops: set):
    """``tree`` (an optimizer state) with its op-keyed levels cut to
    ``names``."""
    if isinstance(tree, dict):
        if tree and all(k in ops for k in tree):
            return {k: v for k, v in tree.items() if k in names}
        return {k: _select(v, names, ops) for k, v in tree.items()}
    return tree


def _merge(dst: dict, src: dict) -> None:
    """Copy ``src``'s leaves into ``dst``'s (tensors in place, scalars
    rebound)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst.setdefault(k, {}), v)
        elif torch.is_tensor(v) and torch.is_tensor(dst.get(k)):
            if dst[k] is not v:
                dst[k].copy_(v)
        else:
            dst[k] = v


def make_pipelined_model(cm: CompiledModel, cfg: PipelineConfig) -> PipelinedModel:
    """Engine choice: the single-call engine when its envelope holds, else
    the host engine (``cfg.engine`` forces either; ``"compiled"`` outside
    its envelope raises with the reason)."""
    if cfg.engine not in ("auto", "host", "compiled"):
        raise ValueError(f"pipeline engine {cfg.engine!r}: expected auto|host|compiled")
    if cfg.engine == "host":
        return PipelinedModel(cm, cfg)
    from .pipeline_compiled import CompiledPipelinedModel, compiled_engine_unsupported

    reason = compiled_engine_unsupported(cm.mesh, cfg, ops=cm.ops,
                                         batch_size=cm.input_tensors[0].dims[0])
    if reason is None:
        try:
            return CompiledPipelinedModel(cm, cfg)
        except NotImplementedError as e:
            if cfg.engine == "compiled":
                raise
            reason = str(e)
    if cfg.engine == "compiled":
        raise ValueError(f"pipeline engine 'compiled' unsupported here: {reason}")
    pm = PipelinedModel(cm, cfg)
    pm.fallback_reason = reason
    return pm
