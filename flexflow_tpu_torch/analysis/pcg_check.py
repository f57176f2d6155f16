"""PCG validator: static legality checks on (layers, strategy, machine).

PyTorch counterpart of ``flexflow_tpu/analysis/pcg_check.py``, built on
the port's ``core/op.create_op``, ``core/parallel_tensor`` and each op's
``propagate(input_shapes, strategy)``. Runs without executing a single
training step. The compiler's own
propagation (runtime/compiler.py ``build_ops``) raises on the FIRST
violation it happens to hit; this pass instead walks the whole graph
fault-tolerantly and returns every violation with layer provenance and a
machine-readable ``PCG0xx`` code (catalog: :data:`..findings.CODE_CATALOG`).

Two check families:

* **Graph well-formedness** (:func:`check_graph`) — no cycles/order
  violations, no dangling tensor refs, no double producers, dead-layer
  detection, and shape/dtype flow consistency across every op in
  ``ops/`` (declared builder dims vs the propagated
  ``ParallelTensorShape``).
* **Sharding legality** (:func:`check_sharding`, folded into the same
  walk) — every partitioned dim divisible by its mesh axis and carrying
  that axis's exact degree, no mesh axis sharding two dims of one tensor,
  replica/partition degrees consistent across producer→consumer edges,
  strategy entries actually realizable (ops silently DROP indivisible
  shardings — e.g. ops/linear.py's ``out_dim % deg == 0`` guard — so a
  corrupted cached strategy would otherwise execute a silently different
  plan), ZeRO-aware per-device memory accounting against the configured
  budget, and schedule compatibility for the pipe axis
  (parallel/pipeline.py needs one op per stage).

The validator is the trust boundary for everything that re-enters the
compile pipeline from outside the current process: rehydrated strategy-cache
payloads, ``graph_xfer`` rewrite variants, and imported strategy files all
pass through :meth:`~flexflow_tpu_torch.runtime.model.FFModel.compile`'s
``config.validate_pcg`` gate, which calls :func:`validate_pcg`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core.op import create_op
from ..core.parallel_tensor import ParallelDim, ParallelTensorShape
from .findings import ValidationReport

# strategy keys whose VALUE is not a mesh-axis name: threaded metadata
# ("_"-prefixed) and mode selectors (attention's ring-vs-a2a sequence
# schedule, ops/attention.py) — excluded from the realizability
# check, which reasons about axis requests only
_META_KEYS = ("_axis_sizes", "seq_mode")


def _input_pshapes(input_tensors, axis_sizes: Dict[str, int],
                   sample_parallel: bool) -> Dict[int, ParallelTensorShape]:
    """The compiler's input-sharding policy (batch dim over "data" when
    divisible), mirrored so the validator sees the same shapes compile()
    will build (runtime/compiler.py compile_model and search/unity.py
    data_parallel_input_pshapes share this convention)."""
    data_deg = axis_sizes.get("data", 1) if sample_parallel else 1
    out: Dict[int, ParallelTensorShape] = {}
    for t in input_tensors:
        dims = [
            ParallelDim(s, data_deg, "data")
            if i == 0 and data_deg > 1 and s % data_deg == 0
            else ParallelDim(s)
            for i, s in enumerate(t.dims)
        ]
        out[t.tensor_id] = ParallelTensorShape(tuple(dims), t.dtype)
    return out


def check_graph(layers: Sequence, input_tensors: Sequence,
                protected: frozenset, report: ValidationReport) -> bool:
    """Well-formedness: producer order (PCG001), dangling refs (PCG002),
    dead layers (PCG003, warning), non-positive dims (PCG016). Returns
    False when the graph is too broken for the propagation walk to be
    meaningful."""
    # non-positive declared dims (PCG016): the size formulas are plain
    # integer arithmetic ((H + 2p - k)//s + 1 goes NEGATIVE when the
    # window exceeds the input), and two negative spatial dims multiply
    # back into a plausible flat size — the program then dies deep in
    # lowering with a shape error nowhere near the bad layer. Caught
    # here with provenance instead.
    for layer in layers:
        for t in layer.outputs:
            if any(int(d) < 1 for d in t.dims):
                report.add(
                    "PCG016",
                    f"output tensor '{t.name}' has non-positive dim(s) "
                    f"{tuple(t.dims)} — a window/stride larger than its "
                    f"input upstream; the program cannot execute",
                    layer=layer)
    for t in input_tensors:
        if any(int(d) < 1 for d in t.dims):
            report.add(
                "PCG016",
                f"input tensor '{t.name}' has non-positive dim(s) "
                f"{tuple(t.dims)}")
    available = {t.tensor_id for t in input_tensors}
    produced_by: Dict[int, object] = {}
    later_producers: Dict[int, object] = {}
    for layer in layers:
        for t in layer.outputs:
            later_producers.setdefault(t.tensor_id, layer)
    hard_break = False
    consumed = set()
    for layer in layers:
        for t in layer.inputs:
            consumed.add(t.tensor_id)
            if t.tensor_id in available:
                continue
            if t.tensor_id in later_producers:
                report.add(
                    "PCG001",
                    f"consumes tensor '{t.name}' produced by the later "
                    f"layer '{later_producers[t.tensor_id].name}' — the "
                    f"graph has a cycle or is not topologically ordered",
                    layer=layer)
            else:
                report.add(
                    "PCG002",
                    f"consumes tensor '{t.name}' (id {t.tensor_id}) that "
                    f"no layer produces and that is not a model input",
                    layer=layer)
            hard_break = True
        for t in layer.outputs:
            if t.tensor_id in produced_by:
                report.add(
                    "PCG001",
                    f"re-produces tensor '{t.name}' already produced by "
                    f"layer '{produced_by[t.tensor_id].name}'",
                    layer=layer)
                hard_break = True
            produced_by[t.tensor_id] = layer
            available.add(t.tensor_id)
    # dead layers: flag only when EVERY output is unread and none is a
    # protected graph output — multi-output ops (top_k, split, LSTM
    # state) legitimately leave individual outputs unused, and the final
    # leaf is the graph's result by convention
    leaf_ids = {t.tensor_id for l in layers for t in l.outputs} - consumed
    final_leaf = None
    for layer in layers:
        for t in layer.outputs:
            if t.tensor_id in leaf_ids:
                final_leaf = t.tensor_id
    for layer in layers:
        outs = [t.tensor_id for t in layer.outputs]
        if outs and all(o not in consumed and o not in protected
                        and o != final_leaf for o in outs):
            report.add(
                "PCG003",
                "no output is consumed by any layer or protected as a "
                "graph output — dead compute in every step",
                severity="warning", layer=layer)
    return not hard_break


def _strategy_axes(strategy: Dict[str, str]) -> Dict[str, str]:
    """The strategy entries that request a mesh axis (key -> axis)."""
    return {k: v for k, v in strategy.items()
            if k not in _META_KEYS and not k.startswith("_")
            and not k.endswith("_mode") and isinstance(v, str)}


def _check_pshape(ps: ParallelTensorShape, layer, what: str,
                  axis_sizes: Dict[str, int],
                  report: ValidationReport) -> None:
    """Per-tensor sharding legality (PCG006/007/008)."""
    seen_axes = set()
    for i, d in enumerate(ps.dims):
        if not d.is_partitioned:
            continue
        if d.size % d.degree != 0:
            report.add(
                "PCG006",
                f"{what} dim {i} (size {d.size}) is not divisible by its "
                f"partition degree {d.degree} over axis '{d.axis}'",
                layer=layer)
        if d.axis not in axis_sizes:
            report.add(
                "PCG007",
                f"{what} dim {i} is partitioned over mesh axis "
                f"'{d.axis}' which does not exist in the mesh "
                f"{dict(axis_sizes)}", layer=layer)
        elif d.degree != axis_sizes[d.axis]:
            report.add(
                "PCG007",
                f"{what} dim {i} has partition degree {d.degree} but "
                f"mesh axis '{d.axis}' has size {axis_sizes[d.axis]}",
                layer=layer)
        if d.axis in seen_axes:
            report.add(
                "PCG008",
                f"{what}: mesh axis '{d.axis}' shards two dims of one "
                f"tensor — impossible block layout", layer=layer)
        seen_axes.add(d.axis)
    for a in ps.replica_axes:
        if a not in axis_sizes:
            report.add(
                "PCG007",
                f"{what} is replicated over mesh axis '{a}' which does "
                f"not exist in the mesh", layer=layer)


def propagate_strategies(
    layers: Sequence,
    input_tensors: Sequence,
    strategies: Dict[str, Dict[str, str]],
    axis_sizes: Dict[str, int],
    report: ValidationReport,
    sample_parallel: bool = True,
) -> Tuple[List[dict], Dict[int, ParallelTensorShape]]:
    """Fault-tolerant mirror of the compiler's ``build_ops`` walk.

    Where build_ops raises on the first problem, this records a coded
    finding and continues with an unpartitioned fallback shape so every
    downstream layer still gets checked. Returns the per-layer records
    (``{"layer", "op", "out_pshapes", "weight_pshapes"}``; ``op`` is None
    when the op could not be built) for the strategy linter to reuse,
    plus the final tensor-id → pshape map."""
    pshapes = _input_pshapes(input_tensors, axis_sizes, sample_parallel)
    records: List[dict] = []
    for layer in layers:
        rec = {"layer": layer, "op": None, "out_pshapes": [],
               "weight_pshapes": {}}
        records.append(rec)
        in_shapes = []
        for t in layer.inputs:
            ps = pshapes.get(t.tensor_id)
            if ps is None:  # dangling/misordered — already PCG001/002
                ps = ParallelTensorShape.unpartitioned(t.dims, t.dtype)
            in_shapes.append(ps)

        def _fallback():
            for t in layer.outputs:
                pshapes[t.tensor_id] = \
                    ParallelTensorShape.unpartitioned(t.dims, t.dtype)

        try:
            op = create_op(layer, in_shapes)
        except NotImplementedError:
            report.add(
                "PCG012",
                f"no op registered for op type '{layer.op_type.value}'",
                layer=layer)
            _fallback()
            continue
        except Exception as e:
            report.add("PCG014", f"op construction failed: {e}",
                       layer=layer)
            _fallback()
            continue
        rec["op"] = op
        strategy = dict(strategies.get(layer.name, {}))
        requested = _strategy_axes(strategy)
        strategy["_axis_sizes"] = dict(axis_sizes)
        op.axis_sizes = dict(axis_sizes)
        try:
            out_shapes, weight_shapes = op.propagate(in_shapes, strategy)
        except (AssertionError, ValueError, KeyError, IndexError) as e:
            report.add(
                "PCG014",
                f"sharding propagation rejected strategy "
                f"{requested or '{}'}: {type(e).__name__}: {e}",
                layer=layer)
            _fallback()
            continue
        rec["out_pshapes"] = out_shapes
        rec["weight_pshapes"] = weight_shapes
        # entries the op honored WITHOUT a shape delta (schedule-only
        # selections like attention's seq ring/a2a choice, or shardings
        # already realized on the requested dim by inheritance) — the
        # ablation below must not misread these as dropped. Captured NOW:
        # the ablation's own propagate calls reset the op's record.
        honored = set(getattr(op, "honored_strategy_keys", ()) or ())
        # --- per-tensor legality (PCG006/007/008) --------------------
        for i, ps in enumerate(out_shapes):
            _check_pshape(ps, layer, f"output {i}", axis_sizes, report)
        for wn, ps in weight_shapes.items():
            _check_pshape(ps, layer, f"weight '{wn}'", axis_sizes, report)
        # --- declared vs propagated shape/dtype flow (PCG004/005) ----
        for i, (t, ps) in enumerate(zip(layer.outputs, out_shapes)):
            if tuple(t.dims) != tuple(ps.sizes):
                report.add(
                    "PCG004",
                    f"output {i}: declared dims {tuple(t.dims)} but "
                    f"propagation produced {tuple(ps.sizes)}",
                    layer=layer)
            if t.dtype is not ps.dtype:
                report.add(
                    "PCG005",
                    f"output {i}: declared dtype {t.dtype.value} but "
                    f"propagation produced {ps.dtype.value}",
                    severity="warning", layer=layer)
            pshapes[t.tensor_id] = ps
        # --- unrealizable strategy entries (PCG006) ------------------
        # ops/*.py guard every sharding with a divisibility check and
        # silently fall back to replicated when it fails; a stored plan
        # whose entry was dropped would execute a DIFFERENT strategy
        # than the one the search priced — the exact corruption class
        # cached payloads and hand-edited strategy files introduce.
        # Detection is by ABLATION, not by scanning realized axes: an
        # axis can be realized on the op anyway (the inherited batch
        # sharding), so the proof an entry took effect is that removing
        # it changes the propagated shapes.
        for key, axis in requested.items():
            if key in honored:
                continue  # schedule-only / already-realized: not dropped
            size = axis_sizes.get(axis, 1)
            if size <= 1:
                # absent/trivial axis: the entry is a silent no-op —
                # suspicious (LINT002) but not a corruption proof, the
                # same plan may legally run on a smaller mesh
                report.add(
                    "PCG007",
                    f"strategy entry {{{key!r}: {axis!r}}} names a mesh "
                    f"axis with size {size}; the entry is ignored",
                    severity="warning", layer=layer)
                continue
            ablated = {k: v for k, v in strategy.items() if k != key}
            try:
                abl_out, abl_w = op.propagate(in_shapes, ablated)
            except Exception:
                continue  # full propagate succeeded; treat as effective
            if list(abl_out) == list(out_shapes) and abl_w == weight_shapes:
                report.add(
                    "PCG006",
                    f"strategy entry {{{key!r}: {axis!r}}} (axis size "
                    f"{size}) was dropped by the op's propagation — an "
                    f"indivisible dim or conflicting axis; the executed "
                    f"plan would silently differ from the stored one",
                    layer=layer)
    return records, pshapes


def _check_edges(records: List[dict], pshapes: Dict,
                 report: ValidationReport) -> None:
    """Producer→consumer consistency (PCG009): a single forward
    propagation is self-consistent by construction, so the remaining
    edge-level hazard is a multi-input op whose same-size batch dims
    arrive with DIFFERENT partition degrees/axes — the compiled graph
    reshards at that edge (ops/parallel_ops.py reshard), which means the PCG's
    replica/partition accounting disagrees with what actually runs
    (warning: legal, but the plan's cost was priced without it)."""
    for rec in records:
        layer = rec["layer"]
        if len(layer.inputs) < 2:
            continue
        first = None
        shardings = {}
        for t in layer.inputs:
            ps = pshapes.get(t.tensor_id)
            if ps is None or not ps.dims:
                continue
            if first is None:
                first = ps.dims[0].size
            if ps.dims[0].size != first:
                continue  # not the same logical (batch) dim
            d = ps.dims[0]
            shardings[t.name] = (d.degree, d.axis)
        if len(set(shardings.values())) > 1:
            report.add(
                "PCG009",
                f"inputs carry inconsistent batch-dim shardings "
                f"{shardings} — a resharding collective lands on this "
                f"edge", severity="warning", layer=layer)


def _check_memory(records: List[dict], axis_sizes: Dict[str, int],
                  config, report: ValidationReport) -> None:
    """ZeRO-aware per-device memory accounting (PCG010). Static
    approximation: weights + optimizer state only (activations depend on
    the step schedule and are the simulator's job — sim/simulator.py).
    Optimizer state is charged at 2x the weights (Adam's two moments,
    the same ``optimizer_state_mult`` convention the search uses,
    search/unity.py _evaluate_candidate), divided by the data degree
    under ZeRO-1 (config.zero_optimizer shards it over "data"). A pipe
    axis scales the budget by the stage count — each stage holds ~1/P of
    the model, the same whole-model-vs-budget*pipe convention
    memory_aware_search uses. WARNING severity, not error: the
    memory-aware search deliberately returns an over-budget result with
    a reported trade-off when nothing fits (unity.py, strict_budget=
    False; reference graph.cc:2134-2157) and the gate must not turn
    that documented behavior into a hard compile failure."""
    budget_mb = getattr(config, "memory_threshold_mb", None)
    if not budget_mb:
        return  # no budget configured: nothing to check statically
    budget = budget_mb * (1 << 20) * axis_sizes.get("pipe", 1)
    dp = axis_sizes.get("data", 1)
    state_mult = (2.0 / dp) if getattr(config, "zero_optimizer", False) \
        else 2.0
    weight_bytes = 0.0
    for rec in records:
        for ps in rec["weight_pshapes"].values():
            n = 1
            for s in ps.sizes:
                n *= s
            try:
                item = ps.dtype.itemsize()
            except ValueError:
                item = 4
            weight_bytes += n * item / max(1, ps.num_parts)
    total = weight_bytes * (1.0 + state_mult)
    if total > budget:
        pipe = axis_sizes.get("pipe", 1)
        report.add(
            "PCG010",
            f"whole-model weights + optimizer state "
            f"{total / 2**20:.1f}MiB exceed the configured "
            f"memory_threshold_mb={budget_mb}"
            f"{f' x pipe {pipe}' if pipe > 1 else ''} "
            f"(weights {weight_bytes / 2**20:.1f}MiB, state x"
            f"{state_mult:.2f}; ZeRO "
            f"{'on' if getattr(config, 'zero_optimizer', False) else 'off'}"
            f", data degree {dp})",
            severity="warning", layer=None)


def _check_schedules(layers: Sequence, axis_sizes: Dict[str, int],
                     report: ValidationReport, config=None) -> None:
    """Collective/schedule compatibility for parallel/ (PCG011/PCG015):
    the pipeline engines (parallel/pipeline.py) need at least one op per
    stage; compile() silently falls back to an un-piped graph below
    that, which leaves the pipe axis idle — flagged so the idle hardware
    is never a surprise. The configured pipeline SCHEDULE is legality-
    checked against the same source of truth the engines use
    (parallel/schedule.py check_schedule): an unknown schedule name or a
    bad interleave degree is PCG015 (error — the typo-guard philosophy:
    a misspelled knob must not silently change what executes), and an
    interleaved chunk count exceeding the op count is PCG015 too (the
    engine's stage splitter would refuse it at compile time)."""
    pipe = axis_sizes.get("pipe", 1)
    if pipe > 1 and len(layers) < pipe:
        report.add(
            "PCG011",
            f"mesh pipe axis has degree {pipe} but the graph has only "
            f"{len(layers)} ops; compile() will fall back to an un-piped "
            f"graph and the pipe axis stays idle",
            severity="warning", layer=None)
    if pipe <= 1 or config is None:
        return
    from ..parallel.pipeline import pipe_microbatches
    from ..parallel.schedule import ScheduleError, check_schedule

    kind = getattr(config, "pipeline_schedule", "auto") or "auto"
    if kind == "auto":
        return  # resolution only ranks legal candidates
    ilv = int(getattr(config, "pipeline_interleave", 2)) \
        if kind == "interleaved" else 1
    try:
        check_schedule(kind, pipe,
                       pipe_microbatches(getattr(config, "batch_size",
                                                 None)), ilv)
    except ScheduleError as e:
        report.add("PCG015", str(e), layer=None)
        return
    if kind == "interleaved" and pipe * ilv > len(layers):
        report.add(
            "PCG015",
            f"schedule 'interleaved' needs {pipe} stages x {ilv} "
            f"virtual chunks = {pipe * ilv} graph ops but the graph "
            f"has {len(layers)}; lower pipeline_interleave or use "
            f"'1f1b'", layer=None)


def validate_pcg(
    layers: Sequence,
    input_tensors: Sequence,
    strategies: Optional[Dict[str, Dict[str, str]]],
    axis_sizes: Dict[str, int],
    protected: Optional[frozenset] = None,
    config=None,
    source: str = "builder",
) -> ValidationReport:
    """Validate one (graph, strategy, mesh) triple; never raises — the
    caller applies the ``config.validate_pcg`` policy via
    :meth:`~.findings.ValidationReport.handle`.

    ``axis_sizes``: mesh axis name → size (a Mesh need not exist yet).
    ``protected``: tensor ids that must survive as graph outputs (the
    logits). ``source`` labels where the strategy came from ("builder",
    "cache", "rewrite", an import path) for error attribution.
    """
    report = ValidationReport(source=source)
    strategies = dict(strategies or {})
    protected = frozenset(protected or ())
    axis_sizes = {str(a): int(s) for a, s in (axis_sizes or {}).items()}
    # stale-plan detection first: entries naming no layer (PCG013)
    names = {l.name for l in layers}
    for sname in strategies:
        if sname not in names:
            report.add(
                "PCG013",
                f"strategy entry '{sname}' names no layer in the graph "
                f"({len(names)} layers) — stale or corrupt plan",
                severity="warning", layer=sname)
    if check_graph(layers, input_tensors, protected, report):
        records, pshapes = propagate_strategies(
            layers, input_tensors, strategies, axis_sizes, report,
            sample_parallel=(config is None
                             or getattr(config, "enable_sample_parallel",
                                        True)))
        _check_edges(records, pshapes, report)
        _check_memory(records, axis_sizes, config, report)
        # stash the walk's records (non-field attribute, never
        # serialized) so the strategy linter can reuse them instead of
        # re-propagating the whole graph
        report.records = records
    _check_schedules(layers, axis_sizes, report, config=config)
    return report
