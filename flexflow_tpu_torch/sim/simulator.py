"""Full-step execution simulation over the op graph.

PyTorch counterpart of ``flexflow_tpu/sim/simulator.py`` (the reference's
``Simulator::simulate_runtime``): a task graph of forward, backward,
collective and update tasks with real data-dependency edges, replayed
event by event over one compute lane and one network lane. Every rank
runs the same program on its blocks, so one rank's timeline is the step.
Collectives come from the sharding algebra:

* the parallel ops (Repartition/Combine/Replicate/Reduction) cost their
  defining collective;
* a compute op contracting over a dim sharded on both the input and the
  weight leaves partial sums: an all-reduce (a reduce-scatter when the
  output stays sharded on that axis); sharded on the input alone, the
  input is all-gathered first (the gather the port's ``propagate`` names
  in ``op.input_layouts``);
* a sequence-parallel attention adds its ring permutes or all-to-alls,
  a spatially sharded conv/pool its halo exchange;
* the gradient sync of replicated weights is charged at update time,
  overlapped with the backward when ``overlap_grad_sync``.

The replay runs in the native engine (``native/src/sim_engine.cc``, built
by ``native_bridge.py``); the Python replay, with the same schedule, only
under ``FLEXFLOW_TPU_NATIVE=off``. Also here: memory accounting
(``MemoryUsage``) and the pipeline schedule model that
``pipeline_schedule="auto"`` ranks with.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from ..ffconst import OpType
from ..core.op import Op
from .cost_model import OpCostModel, _pshape_local_bytes
from .machine_model import MachineModel


@dataclasses.dataclass
class SimTask:
    """One node of the simulated task graph (reference: SimTask,
    simulator.h:585-…). kind ∈ {fwd, bwd, comm, update}."""

    name: str
    kind: str
    run_time: float
    deps: Tuple[int, ...] = ()
    ready_time: float = 0.0
    start_time: float = 0.0


@dataclasses.dataclass
class MemoryUsage:
    """Per-device bytes (reference: MemoryUsage, memory_optimization.h)."""

    weights: int = 0
    optimizer_state: int = 0
    activations: int = 0

    @property
    def total(self) -> int:
        return self.weights + self.optimizer_state + self.activations


def serving_kv_pool_bytes(specs, num_blocks: int, block_size: int,
                          kv_dtype: str = "float32",
                          dtype_bytes: int = 4) -> int:
    """Dtype-aware paged-KV pool arena bytes — the sim-side mirror of
    ``PagedKVPool.memory_bytes`` (a parity test pins the two byte-for-
    byte, so capacity planning and the advisor's admission math can
    never drift from the real allocation).

    ``specs``: ``{attention op name: (num_heads, head_dim)}``. Per
    token per op: k+v at the storage width, plus — for ``"int8"`` —
    the f32 scale/zero-point sidecar pair per head for each of k and v.
    ``dtype_bytes`` is the ``"float32"`` mode's item size (that mode
    stores in the pool's compute dtype, which may itself be bf16)."""
    if kv_dtype == "int8":
        per_tok = sum(2 * h * d + 2 * 2 * h * 4
                      for h, d in dict(specs).values())
        return int(num_blocks) * int(block_size) * per_tok
    item = 2 if kv_dtype == "bfloat16" else int(dtype_bytes)
    per_tok = sum(2 * h * d for h, d in dict(specs).values())
    return int(num_blocks) * int(block_size) * per_tok * item


def _collective_axes(op: Op) -> Tuple[List[Tuple[str, int, str]], int]:
    """Infer the collectives a compute op implies: axes that shard an
    input/weight dim but do not shard any output dim are contraction axes →
    the partial sums must be all-reduced. Returns (axis, degree, kind)."""
    out_axes = set()
    for ps in op.output_shapes:
        for d in ps.dims:
            if d.is_partitioned:
                out_axes.add(d.axis)
    found: Dict[str, int] = {}
    for ps in list(op.input_shapes) + list(op.weight_shapes.values()):
        for d in ps.dims:
            if d.is_partitioned and d.axis not in out_axes:
                found[d.axis] = max(found.get(d.axis, 1), d.degree)
    out_bytes = sum(_pshape_local_bytes(p) for p in op.output_shapes)
    return [("%s" % a, deg, "allreduce") for a, deg in found.items()], out_bytes


# process-wide simulate_runtime counter (companion to
# cost_model.MEASURE_CALLS): the strategy-cache tests assert a warm
# recompile runs ZERO full-step simulations. Reset by assigning 0.
SIM_RUNS = 0


class Simulator:
    """Estimates one training-step time for an op graph + strategy.

    reference: Simulator (simulator.h:691-778). ``measure_operator_cost``
    is delegated to the cost model (memoized); ``simulate_runtime`` is the
    critical-path pass below.
    """

    def __init__(
        self,
        machine: MachineModel,
        cost_model: Optional[OpCostModel] = None,
        overlap_grad_sync: bool = True,
        optimizer_state_mult: float = 2.0,  # Adam: m+v per weight
    ):
        self.machine = machine
        self.cost_model = cost_model or OpCostModel(machine)
        self.overlap_grad_sync = overlap_grad_sync
        self.optimizer_state_mult = optimizer_state_mult

    # ------------------------------------------------------------------ comm
    def _comm_time(self, op: Op, backward: bool) -> float:
        m = self.machine
        in0 = op.input_shapes[0] if op.input_shapes else None
        out0 = op.output_shapes[0] if op.output_shapes else None
        t = op.op_type

        if t is OpType.COMBINE and in0 is not None:
            dim = op.attrs["dim"] % len(in0.dims)
            d = in0.dims[dim]
            local = _pshape_local_bytes(in0)
            # fwd all-gather; bwd is its transpose (slice) — free
            return m.allgather_time(local, d.degree, d.axis) if not backward else 0.0
        if t is OpType.REPARTITION and out0 is not None:
            dim = op.attrs["dim"] % len(out0.dims)
            d = out0.dims[dim]
            local = _pshape_local_bytes(out0)
            # fwd slice (free); bwd all-gather of grads
            return m.allgather_time(local, d.degree, d.axis) if backward else 0.0
        if t is OpType.REPLICATE and in0 is not None:
            axis = op.attrs["axis"]
            deg = _axis_degree(op, axis)
            local = _pshape_local_bytes(in0)
            # fwd broadcast ≈ all-gather pattern; bwd all-reduce of grads
            return (
                m.allreduce_time(local, deg, axis)
                if backward
                else m.allgather_time(local / max(deg, 1), deg, axis)
            )
        if t in (OpType.REDUCTION, OpType.ALLREDUCE) and in0 is not None:
            axis = op.attrs.get("axis")
            deg = _axis_degree(op, axis) if axis else 1
            local = _pshape_local_bytes(in0)
            return m.allreduce_time(local, deg, axis or "") if not backward else 0.0

        # sequence-parallel attention: the seq axis shards both inputs and
        # outputs, so the generic contraction rules see no collective —
        # price the schedule's real communication explicitly and ADD it to
        # the generic charges (a combined heads-TP x SP strategy still owes
        # the TP allreduce). Ring: n-1 collective-permutes of the local
        # k AND v blocks; Ulysses: 3 input all-to-alls + 1 output
        # all-to-all of activation blocks (parallel/ring_attention.py).
        # Sized from the OUTPUT pshape: propagate seq-shards it even for
        # the first layer, whose input arrives unsharded.
        sp_time = 0.0
        if (t is OpType.MULTIHEAD_ATTENTION
                and getattr(op, "seq_axis", None) and out0 is not None):
            axis = op.seq_axis
            deg = _axis_degree(op, axis)
            if deg > 1:
                block = _pshape_local_bytes(out0)  # one local seq block
                if getattr(op, "seq_mode", "ring") == "a2a":
                    sp_time = 4.0 * m.alltoall_time(block, deg, axis)
                else:
                    sp_time = 2.0 * (deg - 1) * m.permute_time(block, deg, axis)

        # spatial (H) partitioning of conv/pool: each shard needs kh//2
        # input rows from BOTH neighbors per traversal direction — the
        # halo exchange the reference hand-schedules in its spatial
        # partition xfers (substitution.cc:87-95); the port exchanges the
        # rows with collectives.halo_rows, priced here as permutes
        if (t in (OpType.CONV2D, OpType.POOL2D) and out0 is not None
                and in0 is not None and len(out0.dims) == 4):
            hd = out0.dims[2]
            kh = op.attrs.get("kernel", (1, 1))[0]
            sh = op.attrs.get("stride", (1, 1))[0]
            # rows read across an aligned shard boundary: windows overlap
            # neighbours only when the kernel outruns the stride (a 2x2/s2
            # pool exchanges NOTHING)
            halo = max(0, (kh - sh + 1) // 2)
            if hd.is_partitioned and halo > 0:
                n_l = in0.dims[0].size // in0.dims[0].degree
                c_l = in0.dims[1].size // in0.dims[1].degree
                w = in0.dims[3].size // in0.dims[3].degree
                row = n_l * c_l * w * in0.dtype.itemsize()
                sp_time += 2.0 * m.permute_time(halo * row, hd.degree,
                                                hd.axis)

        # compute op: explicit contraction structure first (Linear/Conv/…)
        out_bytes = sum(_pshape_local_bytes(p) for p in op.output_shapes)
        out_axes = {
            d.axis for ps in op.output_shapes for d in ps.dims if d.is_partitioned
        }
        time = 0.0
        handled = set()
        for ii, dim, wname, wdim in op.input_contraction_dims():
            ips = op.input_shapes[ii]
            d = ips.dims[dim % len(ips.dims)]
            if not d.is_partitioned:
                continue
            handled.add(d.axis)
            w = op.weight_shapes.get(wname) if wname else None
            if w is not None and w.dims[wdim].axis == d.axis:
                # sharded contraction → partial sums. Reduce-scatter if the
                # output stays sharded on this axis, else full all-reduce
                # (the partition-linear-combine Reduction, substitution.cc:77)
                if d.axis in out_axes:
                    time += m.reducescatter_time(out_bytes * d.degree, d.degree, d.axis)
                else:
                    time += m.allreduce_time(out_bytes, d.degree, d.axis)
            else:
                # contraction dim sharded but weight not sharded to match:
                # the activation is all-gathered before the GEMM
                time += m.allgather_time(_pshape_local_bytes(ips), d.degree, d.axis)
        # generic fallback for axes the explicit structure didn't cover
        # (e.g. embedding vocab partition): any axis sharding an input or
        # weight dim but absent from the outputs leaves partial/partitioned
        # state that must be reduced
        colls, _ = _collective_axes(op)
        for axis, deg, kind in colls:
            if axis not in handled:
                time += m.allreduce_time(out_bytes, deg, axis)
        # same magnitude both directions (transpose collective); SP
        # schedule comm adds on top
        return time + sp_time

    # ------------------------------------------------------------ task graph
    def build_task_graph(self, ops: List[Op]) -> List[SimTask]:
        """Materialize fwd/bwd/comm/update tasks with REAL data-dependency
        edges — exported for inspection/tests (reference: the SimTask DAG
        simulate_runtime builds, simulator.cc:850-905, where backward tasks
        depend on their consumers' backward tasks, not on a global chain).

        Comm rides its own task on the network lane in BOTH directions, so
        one branch's collective overlaps another branch's compute — the
        chain-backward model serialized parallel branches (inception / MoE
        / multi-tower DLRM) and biased the search against them.

        Backward edges: ``bwd(op)`` consumes the output-gradient produced
        by every consumer's ``bwd``; an op with no consumers is a loss
        frontier — its gradient is available right after its own forward
        (+ fwd collective)."""
        tasks: List[SimTask] = []
        ready_idx: Dict[int, int] = {}  # tensor_id -> task producing it
        fwd_out: Dict[int, int] = {}    # op position -> fwd-side ready task
        for oi, op in enumerate(ops):
            cm = self.cost_model.measure(op)
            deps = tuple(
                ready_idx[t.tensor_id] for t in op.layer.inputs
                if t.tensor_id in ready_idx
            )
            idx = len(tasks)
            tasks.append(SimTask(f"{op.name}:fwd", "fwd", cm.forward_time,
                                 deps))
            comm = self._comm_time(op, backward=False)
            out = idx
            if comm > 0.0:
                out = len(tasks)
                tasks.append(SimTask(f"{op.name}:fwd_comm", "comm", comm,
                                     (idx,)))
            fwd_out[oi] = out
            for t in op.layer.outputs:
                ready_idx[t.tensor_id] = out
        # consumer map over op positions (the reverse edges of the fwd DAG)
        produced_by: Dict[int, int] = {}
        for oi, op in enumerate(ops):
            for t in op.layer.outputs:
                produced_by[t.tensor_id] = oi
        consumers: Dict[int, List[int]] = {oi: [] for oi in range(len(ops))}
        for oi, op in enumerate(ops):
            for t in op.layer.inputs:
                pi = produced_by.get(t.tensor_id)
                if pi is not None:
                    consumers[pi].append(oi)
        bwd_out: Dict[int, int] = {}  # op position -> bwd-side ready task
        for oi in range(len(ops) - 1, -1, -1):
            op = ops[oi]
            cm = self.cost_model.measure(op)
            if consumers[oi]:
                deps = tuple(sorted({bwd_out[ci] for ci in consumers[oi]}))
            else:
                # loss frontier: cotangent exists once this op's forward
                # (and its collective) finished
                deps = (fwd_out[oi],)
            idx = len(tasks)
            tasks.append(SimTask(f"{op.name}:bwd", "bwd", cm.backward_time,
                                 deps))
            comm = self._comm_time(op, backward=True)
            out = idx
            if comm > 0.0:
                out = len(tasks)
                tasks.append(SimTask(f"{op.name}:bwd_comm", "comm", comm,
                                     (idx,)))
            bwd_out[oi] = out
        # gradient sync + update: sync needs every op's backward done
        sync = (sum(self.cost_model.measure(op).sync_time for op in ops)
                + self.cost_model.grad_sync_latency(ops))
        sync_deps = tuple(sorted(set(bwd_out.values())))
        tasks.append(SimTask("grad_sync", "comm", sync, sync_deps))
        tasks.append(SimTask("update", "update", 0.0, (len(tasks) - 1,)))
        return tasks

    # ------------------------------------------------------------- simulate
    def _effective_runtime(self, task: SimTask, bwd_total: float) -> float:
        return effective_task_runtime(task, bwd_total,
                                      self.overlap_grad_sync)

    def simulate_runtime(self, ops: List[Op]) -> float:
        """Estimated per-iteration seconds: replays the SimTask graph from
        :meth:`build_task_graph` in the native event engine
        (``native/src/sim_engine.cc``), compute and network on separate
        lanes, or in the Python replay under ``FLEXFLOW_TPU_NATIVE=off``;
        both give the same schedule."""
        global SIM_RUNS
        SIM_RUNS += 1
        tasks = self.build_task_graph(ops)
        self._last_tasks = tasks  # exposed for --taskgraph export
        bwd_total = sum(t.run_time for t in tasks if t.kind == "bwd")
        durations = [self._effective_runtime(t, bwd_total) for t in tasks]
        # one compute lane (every device runs the same SPMD program, so the
        # per-device timeline is shared) + one network lane that comm tasks
        # overlap compute on — identical semantics in both engines
        lanes = [1 if t.kind == "comm" else 0 for t in tasks]

        from .. import native_bridge

        if not native_bridge.native_disabled():
            edges = [(d, i) for i, t in enumerate(tasks) for d in t.deps]
            total, starts = native_bridge.sim_taskgraph(durations, lanes, edges,
                                                         want_starts=True)
            finish = [float(s) + durations[i] for i, s in enumerate(starts)]
            for i, t in enumerate(tasks):
                t.start_time = float(starts[i])
                t.ready_time = max((finish[d] for d in t.deps), default=0.0)
            return float(total) + self.machine.chip.step_overhead

        # the Python replay: the native engine's event order (pop by
        # (dep-ready time, task id), serialize per lane), so both give the
        # same schedule
        import heapq

        n = len(tasks)
        succ: List[List[int]] = [[] for _ in range(n)]
        indeg = [0] * n
        for i, t in enumerate(tasks):
            for d in t.deps:
                succ[d].append(i)
                indeg[i] += 1
        ready = [0.0] * n
        finish = [0.0] * n
        lane_free: Dict[int, float] = {}
        heap = [(0.0, i) for i in range(n) if indeg[i] == 0]
        heapq.heapify(heap)
        total = 0.0
        while heap:
            rdy, i = heapq.heappop(heap)
            start = max(rdy, lane_free.get(lanes[i], 0.0))
            tasks[i].ready_time = rdy
            tasks[i].start_time = start
            finish[i] = start + durations[i]
            lane_free[lanes[i]] = finish[i]
            total = max(total, finish[i])
            for s in succ[i]:
                ready[s] = max(ready[s], finish[i])
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(heap, (ready[s], s))
        return total + self.machine.chip.step_overhead

    def last_tasks(self) -> List[SimTask]:
        """The SimTask list from the most recent :meth:`simulate_runtime`
        (start/ready times filled by the replay) — the public accessor
        the task-graph export reads. Empty before any simulation."""
        return list(getattr(self, "_last_tasks", ()))

    def pipeline_schedule_cost(self, sched, submesh_step_time: float,
                               cut_bytes: float = 0.0,
                               data_degree: int = 1,
                               engine: str = "host",
                               bwd_ratio: float = 2.0) -> Dict:
        """Price one pipeline schedule from its tick table (see
        :func:`pipeline_schedule_cost`)."""
        return pipeline_schedule_cost(
            sched, submesh_step_time, self.machine, cut_bytes=cut_bytes,
            data_degree=data_degree, engine=engine, bwd_ratio=bwd_ratio)

    def memory_usage(self, ops: List[Op]) -> MemoryUsage:
        mu = MemoryUsage()
        for op in ops:
            cm = self.cost_model.measure(op)
            mu.weights += cm.weights_memory
            mu.activations += cm.outputs_memory  # saved for backward
        mu.optimizer_state = int(mu.weights * self.optimizer_state_mult)
        return mu

    def fits_memory(self, ops: List[Op]) -> bool:
        return self.memory_usage(ops).total <= self.machine.chip.hbm_capacity


# --------------------------------------------------- phase decomposition
def effective_task_runtime(task: SimTask, bwd_total: float,
                           overlap_grad_sync: bool = True) -> float:
    """One task's replay-priced runtime: grad sync pays only its
    un-hidden tail when the all-reduce overlaps the backward compute. The ONE copy of the overlap
    discount — the replay (:meth:`Simulator._effective_runtime`) and
    the attribution bucketing (:func:`task_phase_totals`) must price
    identically or the phase shares drift from what steered the
    search."""
    run = task.run_time
    if task.name == "grad_sync" and overlap_grad_sync:
        run = max(run - 0.5 * bwd_total, run * 0.1)
    return run


def task_phase_totals(tasks: List[SimTask],
                      overlap_grad_sync: bool = True) -> Dict[str, float]:
    """Bucket a SimTask list (:meth:`Simulator.last_tasks`) into the
    attribution engine's device phases — predicted seconds of forward/
    backward compute, collective/transfer time, and the optimizer
    update — via the same :func:`effective_task_runtime` pricing the
    replay uses, so the fractions match what the replay priced. The
    obs/attribution.py engine scales measured residual step time over
    these proportions."""
    bwd_total = sum(t.run_time for t in tasks if t.kind == "bwd")
    compute = collective = update = 0.0
    for t in tasks:
        run = effective_task_runtime(t, bwd_total, overlap_grad_sync)
        if t.kind in ("fwd", "bwd"):
            compute += run
        elif t.kind == "comm":
            collective += run
        elif t.kind == "update":
            update += run
    return {"device_compute": compute, "collective_transfer": collective,
            "optimizer_fold": update}


# ------------------------------------------------- pipeline schedule model
def pipeline_schedule_cost(sched, submesh_step_time: float,
                           machine: MachineModel, cut_bytes: float = 0.0,
                           data_degree: int = 1, engine: str = "host",
                           bwd_ratio: float = 2.0) -> Dict:
    """Analytical step-time/bubble/activation model for ONE pipeline
    schedule, priced from its tick table (parallel/schedule.py) — the
    cost model the ``pipeline_schedule="auto"`` knob ranks with, in the
    spirit of "A Learned Performance Model for TPUs" (PAPERS.md):
    predict, rank, then let the bench verify.

    * ``submesh_step_time``: one whole-model step on the per-stage
      submesh (the inner DP's estimate) — the work the schedule splits
      over stages and microbatches. Per-action costs are uniform
      (chunk = 1/(S·V) of the model, microbatch = 1/M of the batch), so
      the tick-synchronous replay reduces to the classic bubble for
      gpipe/1f1b: ``T·(M+S-1)/(M·S)``.
    * ``cut_bytes``: stage-boundary bytes per traversal direction (the
      search's ``_stage_cut_bytes`` over the schedule's chunk count);
      charged twice (activation + cotangent) over the intra-node link shared by
      ``data_degree`` per-shard streams.
    * ``engine``: the host engine pays per-action dispatch overhead
      (O(S·M) dispatches); the single-dispatch compiled engine pays ONE.

    Returns a JSON-able record with ``est_step_time`` plus the memory
    side of the trade-off (``peak_live_microbatches``), which breaks
    est-time ties in favor of the smaller activation footprint —
    that is how ``auto`` prefers 1F1B over GPipe at equal bubble.
    """
    S, M, V = sched.num_stages, sched.num_microbatches, sched.interleave
    tfb = submesh_step_time / (S * V * M)  # one chunk, one microbatch
    t_f = tfb / (1.0 + bwd_ratio)
    t_b = tfb - t_f
    if machine.effective_parallelism(S) > 1.0:
        compute = sched.step_ticks_cost(t_f, t_b)
    else:
        # shared-host virtual mesh: every "stage" time-slices one
        # socket — no pipeline speedup exists (same honesty as
        # machine_model.effective_parallelism for sharding)
        compute = submesh_step_time
    comm = 2.0 * (cut_bytes / max(1, data_degree)) \
        / machine.chip.ici_link_bandwidth
    dispatches = 1 if engine == "compiled" else sched.host_dispatches()
    overhead = machine.chip.step_overhead * dispatches
    return {
        "schedule": sched.kind,
        "interleave": V,
        "engine": engine,
        "est_step_time": compute + comm + overhead,
        "compute_time": compute,
        "comm_time": comm,
        "dispatch_overhead": overhead,
        "dispatches": dispatches,
        "bubble_fraction": round(sched.bubble_fraction(bwd_ratio), 4),
        "peak_live_microbatches": sched.peak_live_total(),
    }


def pipeline_schedule_candidates(requested: str, interleave: int,
                                 num_stages: int, n_ops: int
                                 ) -> List[Tuple[str, int]]:
    """The (schedule, interleave) candidate set for one ranking — the
    SINGLE construction shared by search-time pricing
    (unity._pipe_adjusted) and per-compile resolution
    (FFModel._resolve_pipeline), so the two can never drift. A pinned
    schedule yields itself; ``auto`` yields gpipe/1f1b plus interleaved
    when the graph has enough ops for the chunk count."""
    ilv = max(2, int(interleave))
    if requested == "auto":
        cands = [("gpipe", 1), ("1f1b", 1)]
        if n_ops >= 2 * num_stages * ilv:
            cands.append(("interleaved", ilv))
        return cands
    if requested == "interleaved":
        return [("interleaved", ilv)]
    return [(requested, 1)]


def schedule_bubble_candidates(cur_schedule: Optional[str],
                               cur_interleave: int, num_stages: int,
                               num_microbatches: int, n_ops: int,
                               bwd_ratio: float = 2.0) -> List[Dict]:
    """Candidate schedule/microbatch moves and their predicted bubble
    fractions — the perf advisor's ``pipeline_bubble`` pricing. Reuses
    the schedule ranker's candidate construction
    (:func:`pipeline_schedule_candidates`) and the tick-table bubble
    model, plus one microbatch-doubling move on the CURRENT schedule
    (``grad_accum_steps`` folds into the microbatch count, so the move
    is a knob, not a semantic change). Rows sort by bubble ascending
    then (schedule, interleave) — deterministic for suggestion ranking."""
    from ..parallel.schedule import ScheduleError, build_schedule

    rows: List[Dict] = []
    cands = pipeline_schedule_candidates(
        "auto", max(2, int(cur_interleave or 1)), num_stages, n_ops)
    for kind, V in cands:
        if kind == cur_schedule and V == max(1, int(cur_interleave or 1)):
            continue
        try:
            sched = build_schedule(kind, num_stages, num_microbatches, V)
        except ScheduleError:
            continue
        rows.append({"schedule": kind, "interleave": V,
                     "num_microbatches": num_microbatches,
                     "bubble_fraction": round(
                         sched.bubble_fraction(bwd_ratio), 6)})
    if cur_schedule:
        try:
            sched = build_schedule(cur_schedule, num_stages,
                                   2 * num_microbatches,
                                   max(1, int(cur_interleave or 1)))
            rows.append({"schedule": cur_schedule,
                         "interleave": max(1, int(cur_interleave or 1)),
                         "num_microbatches": 2 * num_microbatches,
                         "bubble_fraction": round(
                             sched.bubble_fraction(bwd_ratio), 6)})
        except ScheduleError:
            pass
    rows.sort(key=lambda r: (r["bubble_fraction"], r["schedule"],
                             r["interleave"], r["num_microbatches"]))
    return rows


def ring_allreduce_factor(degree: int) -> float:
    """The ring all-reduce's bytes-on-the-wire factor over a degree-d
    axis: each shard moves ``2 (d-1)/d`` of the payload across its link
    link (reduce-scatter + all-gather). 0 for a trivial axis."""
    d = int(degree)
    return 0.0 if d <= 1 else 2.0 * (d - 1) / d


def mesh_reshape_candidates(axes: Dict[str, int]) -> List[Dict]:
    """Same-device-count mesh reshapes that shrink the data-axis
    gradient all-reduce, ranked by the ring-factor ratio vs the current
    mesh — the perf advisor's ``collective_transfer`` pricing. Moves
    factors of the data degree onto a pipe or model axis; the NEW axis's
    own traffic (stage boundaries, activation collectives) is not priced
    here — the advisor says so and the A/B bench is the verdict. Keeps
    at least data degree 2 (eliminating data parallelism entirely trades
    compute shape, not just comm, and is out of a knob-advisor's
    scope)."""
    axes = {a: int(s) for a, s in (axes or {}).items() if int(s) > 1}
    d = int(axes.get("data", 1))
    if d < 4:  # nothing to split while keeping data >= 2
        return []
    cur = ring_allreduce_factor(d)
    rows: List[Dict] = []
    f = 2
    while d % f == 0 and d // f >= 2:
        for family in ("pipe", "model"):
            new = dict(axes)
            new["data"] = d // f
            new[family] = int(axes.get(family, 1)) * f
            rows.append({
                "mesh": new,
                "family": family,
                "data_degree": d // f,
                "allreduce_factor_ratio": round(
                    ring_allreduce_factor(d // f) / cur, 6),
            })
        f *= 2
    rows.sort(key=lambda r: (r["allreduce_factor_ratio"],
                             json.dumps(sorted(r["mesh"].items()))))
    return rows


def compiled_envelope_ok(axis_sizes: Dict[str, int],
                         pipe_axis: str = "pipe") -> bool:
    """The single-dispatch engine's MESH envelope: the pipe-only and
    pipe×data families (every axis besides pipe and data trivial).
    Schedule legality and the batch-coupled-op check are separate
    (parallel/pipeline_compiled.compiled_engine_unsupported owns the
    full verdict); this is the mesh-shape half the search and the
    schedule ranker price with."""
    return all(s == 1 for a, s in axis_sizes.items()
               if a not in (pipe_axis, "data"))


def rank_pipeline_schedules(
    candidates: List[Tuple[str, int]],
    num_stages: int,
    num_microbatches: int,
    submesh_step_time: float,
    machine: MachineModel,
    cut_bytes_fn=None,
    data_degree: int = 1,
    compiled_ok: bool = False,
    bwd_ratio: float = 2.0,
) -> Tuple[str, int, List[Dict]]:
    """Rank (schedule, interleave) candidates by the analytical model.

    ``cut_bytes_fn(chunk_count) -> bytes`` supplies boundary traffic per
    chunk granularity (interleaved pays ~V× more cuts); ``compiled_ok``
    says whether the single-dispatch engine's envelope holds for the
    target mesh AND graph (pipe/pipe×data family, batch-linear under a
    data submesh — the caller owns that verdict), pricing EVERY
    candidate schedule at one dispatch instead of O(S·M). Ties on
    est_step_time resolve toward the smaller activation footprint, then
    lexicographic schedule name — fully deterministic. Returns
    (best_schedule, best_interleave, all_records)."""
    from ..parallel.schedule import ScheduleError, build_schedule

    records: List[Dict] = []
    for kind, V in candidates:
        try:
            sched = build_schedule(kind, num_stages, num_microbatches, V)
        except ScheduleError:
            continue
        # the compiled engine covers every schedule the IR accepts
        # (gpipe/1f1b/interleaved) on an eligible mesh; ``compiled_ok``
        # is the caller's envelope verdict for the target mesh/graph
        engine = "compiled" if compiled_ok else "host"
        cut = cut_bytes_fn(num_stages * V) if cut_bytes_fn else 0.0
        records.append(pipeline_schedule_cost(
            sched, submesh_step_time, machine, cut_bytes=cut,
            data_degree=data_degree, engine=engine, bwd_ratio=bwd_ratio))
    if not records:
        return "gpipe", 1, []
    best = min(records, key=lambda r: (r["est_step_time"],
                                       r["peak_live_microbatches"],
                                       r["schedule"]))
    return best["schedule"], best["interleave"], records


def _axis_degree(op: Op, axis: Optional[str]) -> int:
    if not axis:
        return 1
    from .cost_model import _axis_sizes_from

    sizes = _axis_sizes_from(op)
    if axis in sizes:
        return int(sizes[axis])
    for ps in list(op.input_shapes) + list(op.output_shapes):
        for d in ps.dims:
            if d.axis == axis:
                return d.degree
    return 1
