"""Per-operator cost: the analytic roofline and the measured forward.

PyTorch counterpart of ``flexflow_tpu/sim/cost_model.py``. Both backends
are memoized by (op type, attrs, full sharding signature):

* :class:`OpCostModel`, the **analytic roofline** the search prices with:
  per-device time = max(flops / effective peak, bytes / effective memory
  bandwidth), a per-family backward factor, and the gradient sync of
  weights replicated over mesh axes;
* :class:`ProfilingCostModel`, the **measured** forward: the op's
  ``forward`` on the card at its per-device shape, timed with CUDA events
  (warmup, then repeats), the rest analytic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..ffconst import DataType, OpType
from ..core.op import Op
from ..core.parallel_tensor import ParallelTensorShape
from .machine_model import MachineModel


@dataclasses.dataclass
class CostMetrics:
    """reference: CostMetrics (simulator.h:54-88)."""

    forward_time: float = 0.0
    backward_time: float = 0.0
    sync_time: float = 0.0          # gradient sync (allreduce) time
    inputs_memory: int = 0          # per-device bytes
    outputs_memory: int = 0
    weights_memory: int = 0

    @property
    def total_time(self) -> float:
        return self.forward_time + self.backward_time + self.sync_time

    @property
    def total_memory(self) -> int:
        return self.inputs_memory + self.outputs_memory + self.weights_memory


def _pshape_local_bytes(ps: ParallelTensorShape) -> int:
    """Per-device bytes of a sharded tensor."""
    n = 1
    for d in ps.dims:
        n *= d.size // d.degree
    return n * ps.dtype.itemsize()


def _op_strategy_key(op: Op) -> Tuple:
    """Memoization key: op type, attrs, and the full sharding signature
    (reference: ProfilingRecordKey = (params-hash, machine-view))."""
    def ps_key(ps: ParallelTensorShape):
        return (
            tuple((d.size, d.degree, d.axis) for d in ps.dims)
            + (ps.dtype,)
            + tuple(sorted(ps.replica_axes))
        )

    attrs = tuple(
        (k, v if isinstance(v, (int, float, str, bool, tuple, type(None))) else str(v))
        for k, v in sorted(op.attrs.items(), key=lambda kv: kv[0])
        if not k.startswith("_")
    )
    return (
        op.op_type,
        attrs,
        tuple(sorted(_axis_sizes_from(op).items())),
        tuple(ps_key(p) for p in op.input_shapes),
        tuple(ps_key(p) for p in op.output_shapes),
        tuple(sorted((n, ps_key(p)) for n, p in op.weight_shapes.items())),
    )


# Per-op-family backward/forward time ratios (reference: each op measures
# its backward separately in measure_operator_cost — e.g.
# src/ops/linear.cc:792; a uniform 2x misranks strategies whose ops have
# different fwd/bwd asymmetry):
#   * matmul family — dgrad + wgrad GEMMs, each the size of the fwd GEMM
#   * attention — per projection 2 GEMM grads, plus the softmax/logits
#     chain recomputed against both dQK directions (~2.5x in practice)
#   * norms — backward fuses two reduction sweeps with the scale/bias
#     grads over the same bytes (~1.5x)
#   * recurrent — the scan replays gate GEMMs for dgrad+wgrad (2x)
#   * weightless elementwise/structural/reduction ops — one pass over the
#     same bytes (1x)
# EMBEDDING is special-cased in _measure_uncached: its backward is a
# bytes-bound scatter-add sized by the touched rows, not a factor of the
# gather.
BWD_FACTORS: Dict[OpType, float] = {
    OpType.LINEAR: 2.0,
    OpType.CONV2D: 2.0,
    OpType.BATCHMATMUL: 2.0,
    OpType.EXPERT_LINEAR: 2.0,
    OpType.MULTIHEAD_ATTENTION: 2.5,
    OpType.LAYERNORM: 1.5,
    OpType.BATCHNORM: 1.5,
    OpType.LSTM: 2.0,
    OpType.GRU: 2.0,
    OpType.RNN: 2.0,
}


# process-wide measure() counter: a warm recompile from the strategy cache
# runs ZERO cost-model queries (what "the search was skipped" means).
# Reset by assigning 0.
MEASURE_CALLS = 0

# cost-model fingerprint folded into the strategy-cache key
# (search/cache.py): bump it whenever the pricing here or in
# sim/simulator.py changes, so plans selected under the old model
# re-search. 3 is the JAX package's version the port's pricing equals.
COST_MODEL_VERSION = 3


class OpCostModel:
    """Analytic roofline cost, memoized.

    Backward time is forward time scaled by a per-op-family factor
    (``BWD_FACTORS``); unlisted ops default to 2x when they carry weights
    (dgrad + wgrad) and 1x when weightless (one elementwise pass).

    The memo is exportable/mergeable (:meth:`export_memo` /
    :meth:`merge_memo`): parallel search workers each run their own
    OpCostModel and ship their memo *delta* back to the parent, which
    merges it so later search waves reuse earlier waves' per-op costs
    (reference: the single hash_to_operator_cost shared across the whole
    optimize, simulator.h:750 — here shared across processes by exchange
    instead of by pointer). Merging never changes results — entries are a
    pure function of their key — only how much work is recomputed.
    """

    BWD_FACTOR = 2.0  # legacy default for unlisted weighted ops

    def __init__(self, machine: MachineModel):
        self.machine = machine
        self._cache: Dict[Tuple, CostMetrics] = {}
        self.calls = 0  # measure() invocations on THIS instance

    def bwd_factor(self, op: Op) -> float:
        f = BWD_FACTORS.get(op.op_type)
        if f is not None:
            return f
        return self.BWD_FACTOR if op.weight_shapes else 1.0

    def measure(self, op: Op) -> CostMetrics:
        global MEASURE_CALLS
        MEASURE_CALLS += 1
        self.calls += 1
        key = _op_strategy_key(op)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        cm = self._measure_uncached(op)
        self._cache[key] = cm
        return cm

    # -- memo exchange (parallel search workers <-> parent) ------------------
    def export_memo(self) -> Dict[Tuple, CostMetrics]:
        """Snapshot of the memo (shallow copy; CostMetrics are treated as
        immutable by every consumer)."""
        return dict(self._cache)

    def memo_delta(self, baseline_keys) -> Dict[Tuple, CostMetrics]:
        """Entries added since ``baseline_keys`` (a set of memo keys) —
        what a search worker ships back to the parent."""
        return {k: v for k, v in self._cache.items() if k not in baseline_keys}

    def merge_memo(self, delta: Dict[Tuple, CostMetrics]) -> None:
        """Adopt entries computed elsewhere (keys are self-describing: op
        type + attrs + full sharding signature, so entries transfer between
        instances built over the SAME machine model)."""
        self._cache.update(delta)

    # -- hooks a subclass can override ---------------------------------------
    def _forward_time(self, op: Op, flops_per_dev: float, bytes_per_dev: float) -> float:
        chip = self.machine.chip
        compute = flops_per_dev / (chip.peak_bf16_flops * chip.mxu_efficiency)
        memory = bytes_per_dev / (chip.hbm_bandwidth * chip.hbm_efficiency)
        return max(compute, memory) + chip.kernel_overhead

    def _measure_uncached(self, op: Op) -> CostMetrics:
        in_bytes = sum(_pshape_local_bytes(p) for p in op.input_shapes)
        out_bytes = sum(_pshape_local_bytes(p) for p in op.output_shapes)
        w_bytes = sum(_pshape_local_bytes(p) for p in op.weight_shapes.values())

        # per-device flops: total flops divided by every distinct mesh axis
        # that genuinely partitions the computation:
        #   * axes sharding an output dim (each device produces its shard);
        #   * axes sharding a weight dim (the small activation is resharded
        #     to match the weight rather than gathering the weight);
        #   * a contraction axis ONLY when input and weight shardings match
        #     (sharded contraction → partial sums). A contraction dim
        #     sharded on the input but NOT on the weight is all-gathered
        #     (charged by the simulator's comm model) and every device then
        #     does the FULL computation — no credit (the port's propagate
        #     gathers it into op.input_layouts; op.input_shapes keeps the
        #     producer's layout, which is what is priced here).
        # Replication re-does work: replica axes give no credit.
        total_flops = float(op.flops())
        axis_deg: Dict[str, int] = {}
        mismatched: set = set()
        for ii, dim, wname, wdim in op.input_contraction_dims():
            ips = op.input_shapes[ii]
            d = ips.dims[dim % len(ips.dims)]
            if not d.is_partitioned:
                continue
            w = op.weight_shapes.get(wname) if wname else None
            if w is not None and w.dims[wdim].axis == d.axis:
                axis_deg[d.axis] = max(axis_deg.get(d.axis, 1), d.degree)
            else:
                mismatched.add((ii, dim % len(ips.dims)))
        for ps in op.output_shapes:
            for d in ps.dims:
                if d.is_partitioned:
                    axis_deg[d.axis] = max(axis_deg.get(d.axis, 1), d.degree)
        for ps in op.weight_shapes.values():
            for d in ps.dims:
                if d.is_partitioned:
                    axis_deg[d.axis] = max(axis_deg.get(d.axis, 1), d.degree)
        for ii, ips in enumerate(op.input_shapes):
            for di, d in enumerate(ips.dims):
                if d.is_partitioned and (ii, di) not in mismatched:
                    axis_deg.setdefault(d.axis, d.degree)
        parts = 1
        for deg in axis_deg.values():
            parts *= deg
        # per-device cost model: each device computes its shard
        # (total/parts) and streams its local bytes. On a REAL mesh that
        # per-device cost IS wall-clock (devices run in parallel). On a
        # shared-host virtual mesh every device-program time-slices ONE
        # socket, so wall-clock is the per-device cost times the DEVICE
        # COUNT — which also charges redundant compute honestly when an
        # op is replicated across an idle mesh axis (parts < n_devices):
        # those replicas each burn the socket for the same answer.
        ser = self.machine.serialization_factor()
        flops_eff = total_flops / max(parts, 1) * ser
        bytes_eff = (in_bytes + out_bytes + w_bytes) * ser

        fwd = self._forward_time(op, flops_eff, bytes_eff)
        if op.op_type is OpType.EMBEDDING:
            # backward is a scatter-add over ONLY the gathered rows:
            # read grad (out_bytes) + read-modify-write the touched table
            # rows (~2 * out_bytes) + indices — bytes-bound, independent
            # of the full table size the fwd roofline charges. Row
            # gathers/scatters run below streaming speed on hosts that
            # loop rows (machine_model.gather_inefficiency; 1.0 on chip)
            gi = self.machine.gather_inefficiency()
            fwd *= gi
            # same per-device-cost x serialization convention as fwd:
            # every shard's scatter-add bytes funnel through the socket
            # on a shared host
            bwd = gi * self._forward_time(
                op, 0.0, (in_bytes + 3 * out_bytes) * ser)
        else:
            bwd = self.bwd_factor(op) * fwd
        # shared-host reality: per-shard programs for model/seq/expert-
        # sharded ops run slower than the roofline says (fitted against
        # the AE playoff's measured step times; 1.0 on real chips), and
        # TINY sharded ops are overhead-dominated — a fixed per-direction
        # floor the roofline's microsecond estimate misses entirely
        non_data = {a for a in axis_deg if a != "data"}
        shard_pen = self.machine.sharded_compute_penalty(non_data)
        fwd *= shard_pen
        bwd *= shard_pen
        # (embeddings are exempt: they are gather-bound with ~zero FLOPs
        # by construction, priced by bytes above, and measured neutral
        # under vocab sharding — the floor is for overhead-dominated
        # tiny GEMM/elementwise shards like per-expert MoE branches)
        if (non_data and total_flops < 1e6
                and op.op_type is not OpType.EMBEDDING):
            tiny = self.machine.sharded_tiny_op_latency()
            fwd += tiny
            bwd += tiny

        # gradient sync: any weight replicated across an axis must be
        # all-reduced over that axis's degree (reference: nccl_update_task
        # allreduce per weight, optimizer_kernel.cu:88)
        sync = 0.0
        axis_sizes = _axis_sizes_from(op)
        out_axes = set(op.output_shapes[0].partition_axes) if op.output_shapes else set()
        for ps in op.weight_shapes.values():
            sharded_axes = {d.axis for d in ps.dims if d.is_partitioned}
            wb = _pshape_local_bytes(ps)
            if getattr(self.machine, "port_grad_sync", False):
                # the port's step (runtime/compiler.py sync_grads): over
                # the axes that partition the op's output and not the
                # weight (a replicated computation's gradients already
                # agree), every weight in one coalesced all-reduce
                deg = 1
                for a in out_axes - sharded_axes:
                    deg *= axis_sizes.get(a, 1)
                sync += self.machine.coalesced_allreduce_time(wb, deg)
            elif self.machine.combine_sync_axes():
                # shared host: ONE allreduce over the COMBINED replica
                # degree — a weight replicated across several mesh axes
                # has prod(deg) copies funneling through the same memory
                # system, so pricing each axis separately undercounts
                # (three 2-way reduces are NOT cheaper than one 8-way
                # reduce; the per-axis sum let idle-axis meshes arbitrage
                # their grad-sync cost)
                deg, axis = 1, ""
                for a, d in axis_sizes.items():
                    if d > 1 and a not in sharded_axes:
                        deg *= d
                        axis = a
                if deg > 1:
                    sync += self.machine.allreduce_time(wb, deg, axis)
            else:
                # real machines: per-axis pricing — each axis rides its
                # own fabric (a DCN axis must be charged at DCN rates)
                for a, d in axis_sizes.items():
                    if d > 1 and a not in sharded_axes:
                        sync += self.machine.allreduce_time(wb, d, a)
        return CostMetrics(fwd, bwd, sync, in_bytes, out_bytes, w_bytes)


def _axis_sizes_from(op: Op) -> Dict[str, int]:
    # ``build_ops`` stamps ``op.axis_sizes`` on every op (the one canonical
    # channel); ops built outside the compiler fall back to scanning dims +
    # replica axes, which misses axes the op doesn't touch at all.
    sizes = getattr(op, "axis_sizes", None)
    if sizes:
        return dict(sizes)
    out: Dict[str, int] = {}
    for ps in list(op.input_shapes) + list(op.output_shapes) + list(op.weight_shapes.values()):
        for d in ps.dims:
            if d.is_partitioned and d.axis:
                out[d.axis] = max(out.get(d.axis, 1), d.degree)
        for a in ps.replica_axes:
            out.setdefault(a, 1)
    return out


class ProfilingCostModel(OpCostModel):
    """Times the op's forward at its per-device shape on the card with
    CUDA events (warmup, then repeats; the reference's
    inner_measure_operator_cost protocol), memoized. Backward is the
    family factor of the measured forward (embedding keeps its analytic
    scatter); sync and memory stay analytic, since they depend on the
    mesh. An op whose forward cannot run alone at its local shape keeps
    the analytic price and is counted on ``fallbacks``."""

    def __init__(self, machine: MachineModel, warmup: int = 2, repeats: int = 5,
                 device: str = "cuda", compute_dtype: Optional[str] = None):
        super().__init__(machine)
        self.warmup = warmup
        self.repeats = repeats
        self.device = device
        self.compute_dtype = compute_dtype
        self.fallbacks: Dict[str, str] = {}  # op name -> why

    def _measure_uncached(self, op: Op) -> CostMetrics:
        analytic = super()._measure_uncached(op)
        try:
            measured = self._profile_forward(op)
        except Exception as e:
            self.fallbacks[op.name] = f"{type(e).__name__}: {e}"
            return analytic
        if op.op_type is OpType.EMBEDDING:
            bwd = analytic.backward_time
        else:
            bwd = self.bwd_factor(op) * measured
        return CostMetrics(measured, bwd, analytic.sync_time, analytic.inputs_memory,
                           analytic.outputs_memory, analytic.weights_memory)

    def _profile_forward(self, op: Op) -> float:
        import torch

        from ..core.op import LowerCtx

        dev = torch.device(self.device)
        if dev.type != "cuda":
            raise ValueError("ProfilingCostModel times ops on a CUDA device")
        cdt = torch.bfloat16 if self.compute_dtype in ("bfloat16", "bf16") else None
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        def local_shape(ps: ParallelTensorShape):
            return tuple(d.size // d.degree for d in ps.dims)

        def sample(ps: ParallelTensorShape):
            shp = local_shape(ps)
            if ps.dtype in (DataType.INT32, DataType.INT64):
                return torch.randint(0, 2, shp, generator=gen, device=dev,
                                     dtype=ps.dtype.to_torch())
            x = torch.randn(shp, generator=gen, device=dev, dtype=torch.float32)
            return x.to(cdt) if cdt is not None else x.to(ps.dtype.to_torch())

        ins = [sample(p) for p in op.input_shapes]
        weights = {n: sample(p) for n, p in op.weight_shapes.items()}
        op.materialize(dev)
        ctx = LowerCtx(mesh=None, training=False)
        with torch.no_grad():
            for _ in range(1 + self.warmup):
                op.forward(ctx, ins, weights)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.repeats):
                op.forward(ctx, ins, weights)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3 / self.repeats
