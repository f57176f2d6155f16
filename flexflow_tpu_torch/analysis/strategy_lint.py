"""Strategy linter: non-fatal findings on legal-but-suspect strategies.

PyTorch counterpart of ``flexflow_tpu/analysis/strategy_lint.py``.

Where :mod:`.pcg_check` rejects plans that cannot run as stored, this
pass flags plans that run fine but leave performance on the table —
the classes the Unity search itself can produce when its cost model is
indifferent (OSDI'22 §6: near-tie candidates), and that hand-written
``compile(strategies=...)`` overrides produce routinely:

* **LINT001** — a large weight left fully replicated while a non-data
  mesh axis with free capacity divides one of its dims: sharding it is
  free at the strategy level (the compiled graph inserts the matching
  collectives) and saves ``(1 - 1/axis)`` of its device memory per rank.
* **LINT002** — degree-1 parallelism: a strategy entry naming an absent
  or size-1 mesh axis, or an explicit parallel op
  (Repartition/Combine/Replicate/Reduction) whose axis is trivial —
  dead weight in the PCG that usually means a plan was copied from a
  larger mesh.
* **LINT003** — float→float Cast layers in the step graph: a
  mixed-precision boundary cast that runs every step. With
  ``config.compute_dtype`` set the compiler already casts at op
  boundaries, so an explicit graph-level cast is either redundant or
  fights the policy.

All findings are warnings/info — ``tools/torch_pcg_lint.py`` exports them as a
one-line JSON report and ``utils/dot.py`` can annotate them onto the
strategy graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..ffconst import DataType, OpType
from .findings import ValidationReport
from .pcg_check import _strategy_axes, propagate_strategies

# weights below this replicated size are not worth a finding (the
# all-gather latency floor dominates tiny tensors)
DEFAULT_MIN_WEIGHT_BYTES = 1 << 20

_PARALLEL_OPS = {OpType.REPARTITION, OpType.REPLICATE, OpType.COMBINE,
                 OpType.REDUCTION, OpType.ALLREDUCE}

_FLOAT_DTYPES = {DataType.FLOAT, DataType.HALF, DataType.BFLOAT16,
                 DataType.DOUBLE}


def lint_strategy(
    layers: Sequence,
    input_tensors: Sequence,
    strategies: Optional[Dict[str, Dict[str, str]]],
    axis_sizes: Dict[str, int],
    config=None,
    min_weight_bytes: int = DEFAULT_MIN_WEIGHT_BYTES,
    records=None,
) -> ValidationReport:
    """Lint one (graph, strategy, mesh) triple; returns only
    warning/info findings (the validator owns errors). ``records``:
    a precomputed propagation-walk record list — pass
    ``validate_pcg(...).records`` when the validator already walked the
    same triple (tools/torch_pcg_lint.py does) to skip a second walk."""
    report = ValidationReport(source="lint")
    strategies = dict(strategies or {})
    axis_sizes = {str(a): int(s) for a, s in (axis_sizes or {}).items()}
    # free axes a replicated weight could use: every non-data axis with
    # real capacity ("data" is the batch/gradient axis; sharding weights
    # over it is ZeRO-3 territory, not a lint suggestion)
    free_axes = {a: s for a, s in axis_sizes.items()
                 if a != "data" and s > 1}
    if records is None:
        # the walk itself is fault-tolerant; propagation errors land in
        # a scratch report the linter drops (the validator reports them)
        scratch = ValidationReport(source="lint-walk")
        records, _pshapes = propagate_strategies(
            layers, input_tensors, strategies, axis_sizes, scratch,
            sample_parallel=(config is None
                             or getattr(config, "enable_sample_parallel",
                                        True)))
    for rec in records:
        layer, op = rec["layer"], rec["op"]
        strategy = _strategy_axes(strategies.get(layer.name, {}))
        # --- LINT002: degree-1 strategy entries / trivial parallel ops
        for key, axis in strategy.items():
            if axis_sizes.get(axis, 1) <= 1:
                report.add(
                    "LINT002",
                    f"strategy entry {{{key!r}: {axis!r}}} maps to a "
                    f"mesh axis of size {axis_sizes.get(axis, 1)} — a "
                    f"no-op entry (plan copied from a larger mesh?)",
                    severity="warning", layer=layer)
        if layer.op_type in _PARALLEL_OPS:
            axis = layer.attrs.get("axis")
            deg = axis_sizes.get(axis, 1) if axis else \
                max(axis_sizes.values(), default=1)
            if deg <= 1:
                report.add(
                    "LINT002",
                    f"parallel op over "
                    f"{'axis ' + repr(axis) if axis else 'the mesh'} has "
                    f"degree {deg} — dead weight in the PCG",
                    severity="warning", layer=layer)
        # --- LINT003: float->float cast in the step graph
        if layer.op_type is OpType.CAST and layer.inputs:
            src = layer.inputs[0].dtype
            dst = layer.attrs.get("dtype")
            if src in _FLOAT_DTYPES and dst in _FLOAT_DTYPES:
                note = (" (config.compute_dtype="
                        f"{config.compute_dtype} already casts at op "
                        "boundaries)"
                        if config is not None
                        and getattr(config, "compute_dtype", None)
                        else "")
                report.add(
                    "LINT003",
                    f"float-to-float cast {src.value}->{dst.value} runs "
                    f"every step{note}",
                    severity="warning", layer=layer)
        # --- LINT001: replicated large weight with a free axis
        if op is None or not free_axes:
            continue
        for wn, ps in rec["weight_pshapes"].items():
            if any(d.is_partitioned for d in ps.dims):
                continue  # already sharded
            n = 1
            for s in ps.sizes:
                n *= s
            try:
                nbytes = n * ps.dtype.itemsize()
            except ValueError:
                nbytes = n * 4
            if nbytes < min_weight_bytes:
                continue
            fits = sorted(a for a, s in free_axes.items()
                          if any(d % s == 0 for d in ps.sizes))
            if fits:
                report.add(
                    "LINT001",
                    f"weight '{wn}' ({nbytes / 2**20:.1f}MiB) is fully "
                    f"replicated while mesh axis"
                    f"{'es' if len(fits) > 1 else ''} "
                    f"{', '.join(repr(a) for a in fits)} could shard it "
                    f"for free", severity="warning", layer=layer)
    return report
