"""Profiling and graph exports.

PyTorch counterpart of ``flexflow_tpu/runtime/profiling.py``:

* per-op profiling (the reference's ``--profiling`` cudaEvent brackets,
  linear_kernels.cu:95-111) → :func:`profile_ops`: each compiled op's
  forward (and, with ``backward=True``, its backward) timed standalone
  under its real sharding, with CUDA events on the card;
* Legion Prof (``-lg:prof``) → :func:`trace`: a context manager around
  ``torch.profiler`` writing a TensorBoard-loadable trace;
* ``--compgraph`` → :func:`export_computation_graph`: dot of the op graph
  with its layouts, optionally cost-annotated;
* ``--taskgraph`` → :func:`export_task_graph`: dot or JSON of the
  simulator's task graph;
* :func:`search_report`, :func:`fit_report`, :func:`pipeline_report`: the
  last search's counters, the last fit's step-loop record
  (:class:`EpochThroughput` epochs) and the pipeline's record.

It is also the façade over the observability package (:mod:`..obs`):
tracer, metrics, divergence, ledger, telemetry, watchdog, attribution,
advisor, cost corpus and server are re-exported here.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# --- observability façade (obs/) -------------------------------------------
from ..obs.divergence import (  # noqa: F401
    divergence_report,
    maybe_record_divergence,
    predicted_step_time,
    record_divergence,
)
from ..obs.metrics import (  # noqa: F401
    Counter,
    EpochThroughput,
    Gauge,
    Histogram,
    MetricsRegistry,
    metrics_registry,
)
from ..obs.trace import (  # noqa: F401
    Tracer,
    configure_tracer,
    span,
    trace_enabled,
    tracer,
    validate_chrome_trace,
)
from ..obs.ledger import (  # noqa: F401
    cohort_key,
    last_record,
    ledger_dir,
    load_runs,
    merge_runs,
    record_run,
    scan_ledger,
)
from ..obs.exec_telemetry import (  # noqa: F401
    collect_traced,
    reconcile_peak_memory,
)
from ..obs.watchdog import (  # noqa: F401
    Watchdog,
    configure_watchdog,
    watchdog,
)
from ..obs.attribution import (  # noqa: F401
    attribute_fit,
    attribution_report,
    format_phase_table,
    serving_attribution,
)
from ..obs.advisor import (  # noqa: F401
    advise_record,
    top_suggestion,
)
from ..obs.costcorpus import (  # noqa: F401
    corpus_dir,
    load_rows,
    scan_corpus,
)
from ..obs.server import (  # noqa: F401
    ObsServer,
    configure_obs_server,
    latest_advice,
    latest_attribution,
    obs_server,
)
from ..utils.dot import DotFile


def synth_array(t, rng, int_high: int = 2) -> np.ndarray:
    """Random host array matching a frontend Tensor's declared shape and
    dtype, shared by per-op profiling and the telemetry step.
    ``int_high``: exclusive bound of integer inputs (pass the real vocab:
    ids drawn from {0, 1} gather two cache-hot rows)."""
    dt = torch.empty(0, dtype=t.dtype.to_torch()).numpy().dtype
    if np.issubdtype(dt, np.integer):
        return rng.integers(0, max(2, int_high), size=t.dims).astype(dt)
    if dt == np.bool_:
        return rng.integers(0, 2, size=t.dims).astype(bool)
    return rng.normal(size=t.dims).astype(dt)


def _min_vocab_bound(ffmodel_or_ops) -> int:
    """Smallest embedding vocab among the model's ops (a safe id bound)."""
    ops = getattr(ffmodel_or_ops, "compiled", None)
    ops = ops.ops if ops is not None else ffmodel_or_ops
    vocabs = [op.attrs["num_entries"] for op in ops
              if op.attrs.get("num_entries")]
    return min(vocabs) if vocabs else 2


# ----------------------------------------------------------- torch.profiler
@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region into a TensorBoard trace under ``logdir``
    (reference analog: Legion Prof via -lg:prof); the card's activity is
    traced when there is one."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


# ----------------------------------------------------------- per-op profiling
class _Timer:
    """Milliseconds a call of ``fn`` over ``iters`` calls: CUDA events on
    the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn, iters: int, warmup: int) -> float:
        for _ in range(warmup):
            fn()
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3


def _op_backward_ms(op, ctx, ins, weights, forward_ms: float, timer: _Timer,
                    iters: int, warmup: int) -> Optional[float]:
    """Time one op's backward standalone: forward and ``autograd.grad`` of
    a scalar sum over its float outputs with respect to its float inputs
    and weights, less the measured forward. None for an op with nothing
    to differentiate."""
    diff_ins = [a.detach().requires_grad_(True) if a.is_floating_point() else a
                for a in ins]
    diff_w = {k: v.detach().requires_grad_(True) if v.is_floating_point() else v
              for k, v in weights.items()}
    leaves = [a for a in diff_ins if a.requires_grad] + \
        [v for v in diff_w.values() if v.requires_grad]
    if not leaves:
        return None

    def fwd_bwd():
        outs = op.forward(ctx, diff_ins, diff_w)
        tot = None
        for o in outs:
            if o.is_floating_point() and o.requires_grad:
                s = o.float().sum()
                tot = s if tot is None else tot + s
        if tot is None:
            raise TypeError("no float output to differentiate")
        return torch.autograd.grad(tot, leaves, allow_unused=True)

    try:
        fwd_bwd()
    except Exception:  # a non-differentiable op: None, not a crash
        return None
    full_ms = timer(fwd_bwd, iters, warmup)
    # the timed call runs forward and backward; the backward's share is
    # what is left after the standalone forward (clamped: timer noise can
    # put the pair under the forward for trivial ops)
    return max(0.0, full_ms - forward_ms)


def profile_ops(ffmodel, iters: int = 10, warmup: int = 2,
                backward: bool = False) -> List[Dict]:
    """Time each compiled op's forward standalone on this rank's blocks
    (reference: per-op cudaEvent profiling under --profiling). Returns one
    record per op: name, type, ``forward_ms``, flops and GFLOP/s. Inputs
    are synthetic (:func:`synth_array`), resharded between ops as the
    compiled graph does, cast to the compute dtype.

    ``backward=True`` also times each op's backward (``backward_ms``,
    None for a non-differentiable op). Under a mesh every rank must call
    it together: an op's collectives run inside its forward."""
    from ..core.op import LowerCtx
    from ..ops.parallel_ops import reshard
    from .compiler import _resolve_compute_dtype, cast_op_params, make_caster

    cm = ffmodel.compiled
    assert cm is not None, "compile() first"
    rng = np.random.default_rng(0)
    bound = _min_vocab_bound(cm.ops)
    cdt = _resolve_compute_dtype(cm.config.compute_dtype)
    cast = make_caster(cdt)
    acts: Dict[int, torch.Tensor] = {}
    for i, t in enumerate(cm.input_tensors):
        a = synth_array(t, rng, int_high=bound)
        if cm.mesh is not None:
            a = a[cm.mesh.local_slices(cm.layouts[t.tensor_id])]
        acts[t.tensor_id] = cast(torch.as_tensor(np.ascontiguousarray(a), device=cm.device))
    timer = _Timer(cm.device)
    ctx = LowerCtx(mesh=cm.mesh, training=False)
    records: List[Dict] = []
    for op in cm.ops:
        ins = []
        for t, want in zip(op.layer.inputs, op.input_layouts):
            x = acts[t.tensor_id]
            src = cm.layouts.get(t.tensor_id)
            if cm.mesh is not None and src is not None and want.layout() != src.layout():
                x = reshard(x, src, want, cm.mesh)
            ins.append(x)
        weights = cast_op_params(cast, op, cm.params.get(op.name, {}), cdt)
        weights = {k: v.detach() for k, v in weights.items()}

        def fwd(_op=op, _ins=ins, _w=weights):
            with torch.no_grad():
                return _op.forward(ctx, _ins, _w)

        outs = fwd()
        ms = timer(fwd, iters, warmup)
        for t, o in zip(op.layer.outputs, outs):
            acts[t.tensor_id] = cast(o)
        fl = op.flops()
        rec = {
            "name": op.name,
            "type": op.op_type.value,
            "forward_ms": ms,
            "flops": fl,
            "gflops_per_s": (fl / (ms * 1e-3)) / 1e9 if ms > 0 else 0.0,
        }
        if backward:
            rec["backward_ms"] = _op_backward_ms(op, ctx, ins, weights, ms, timer,
                                                 iters, warmup)
        records.append(rec)
    return records


# ----------------------------------------------------- step-loop observability
def fit_report(ffmodel) -> Optional[Dict]:
    """The last ``fit``'s step-loop record, or None before one: ``{"epochs":
    [per-epoch EpochThroughput records], "steps_per_s", "prefetch_depth",
    "max_inflight_steps", "steps_per_dispatch"}``, plus ``pipeline``,
    ``divergence``, ``attribution`` and ``advice`` blocks as configured.
    Each epoch record carries ``steps``, ``wall_s``, ``steps_per_s``,
    ``input_wait_s``, ``input_mb_per_s``, ``queue_depth_hist`` and
    ``dispatch_ahead_occupancy``."""
    return getattr(ffmodel, "fit_profile", None)


def pipeline_report(ffmodel) -> Optional[Dict]:
    """The pipeline engine's record from the last fit, or from the live
    engine when no fit ran yet; None when the model is not pipelined."""
    fp = getattr(ffmodel, "fit_profile", None) or {}
    if "pipeline" in fp:
        return fp["pipeline"]
    pm = getattr(ffmodel, "pipelined", None)
    return pm.profile() if pm is not None else None


def search_report(ffmodel) -> Optional[Dict]:
    """The last search's counters, or None when no search ran this
    compile: ``search_time_s``, ``cache``, ``candidates``, ``pruned``,
    ``states_explored``, ``workers``, ``mesh_shape``, ``est_step_time``."""
    return getattr(ffmodel, "search_profile", None)


# ----------------------------------------------------------------- dot export
def export_computation_graph(ffmodel, path: str,
                             include_costs: bool = False) -> None:
    """reference: --compgraph → Graph::export_strategy_computation_graph
    (graph.h:339-344); ``include_costs`` adds each op's simulated times."""
    cm = ffmodel.compiled
    assert cm is not None, "compile() first"
    dot = DotFile("computation_graph")
    cost_by_op = {}
    if include_costs:
        from ..obs.divergence import _machine
        from ..sim import OpCostModel

        cost_model = OpCostModel(_machine(ffmodel))
        for op in cm.ops:
            cost_by_op[op.name] = cost_model.measure(op)
    for op in cm.ops:
        shard = ", ".join(str(ps.partition_spec()) for ps in op.output_shapes)
        label = f"{{{op.name}|{op.op_type.value}|{shard}"
        if op.name in cost_by_op:
            c = cost_by_op[op.name]
            label += f"|fwd {c.forward_time*1e3:.3f} ms, bwd {c.backward_time*1e3:.3f} ms"
        label += "}"
        dot.add_node(op.name, label)
    producer = {t.tensor_id: op for op in cm.ops for t in op.layer.outputs}
    for op in cm.ops:
        for t in op.layer.inputs:
            src = producer.get(t.tensor_id)
            if src is not None:
                dot.add_edge(src.name, op.name, label="x".join(map(str, t.dims)))
    dot.write(path)


def export_task_graph(ffmodel, path: str, fmt: str = "dot") -> None:
    """reference: --taskgraph → export_strategy_task_graph_file
    (model.cc:3666): the simulator's task graph with simulated start
    times, as dot or (``fmt="json"``) JSON with the search's counters."""
    from ..obs.divergence import _machine
    from ..sim import OpCostModel, Simulator

    cm = ffmodel.compiled
    assert cm is not None, "compile() first"
    machine = _machine(ffmodel)
    sim = Simulator(machine, OpCostModel(machine))
    total = sim.simulate_runtime(cm.ops)
    tasks = sim.last_tasks()
    edges = [(d, i) for i, t in enumerate(tasks) for d in t.deps]
    if fmt == "json":
        payload = {
            "total_time_s": total,
            "tasks": [
                {"id": i, "name": t.name, "kind": t.kind,
                 "run_time_s": t.run_time, "start_time_s": t.start_time}
                for i, t in enumerate(tasks)
            ],
            "edges": [list(e) for e in edges],
        }
        search = search_report(ffmodel)
        if search is not None:
            payload["search"] = search
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        return
    dot = DotFile("task_graph")
    for i, t in enumerate(tasks):
        dot.add_node(
            str(i),
            f"{{{t.name}|{t.kind}|{t.run_time*1e6:.1f} us @ {t.start_time*1e6:.1f} us}}",
        )
    for s, d in edges:
        dot.add_edge(str(s), str(d))
    dot.write(path)


__all__ = [
    "export_computation_graph", "export_task_graph", "fit_report",
    "pipeline_report", "profile_ops", "search_report", "synth_array", "trace",
]
