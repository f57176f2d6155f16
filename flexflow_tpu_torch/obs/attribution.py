"""Step-time attribution: why a step takes as long as it does.

PyTorch counterpart of ``flexflow_tpu/obs/attribution.py``, the same
phases, report schema and reconciliation. The measured steady-state step
is split into phases by joining

* the **measured host-side components**: each step's input wait from
  :class:`~.metrics.EpochThroughput`'s epoch record, and host dispatch
  from the tracer ring's ``fit.step`` spans (the machine model's
  ``step_overhead`` a dispatch when tracing is off);
* the **pipeline profile**: the resolved schedule's bubble fraction when
  the fit ran on the pipeline engine;
* the **simulator's predicted task timeline**, bucketed by
  :func:`~..sim.simulator.task_phase_totals` into device compute,
  collective/transfer and optimizer fold, over which the residual
  (device-side) measured time is spread.

The report's phases sum to the measured step within ``tolerance``; it
also ranks the top-k ops by measured against predicted time, with layer
provenance. It lands in ``fit_profile["attribution"]``, the run ledger
and the obs server's ``/attribution``; ``--profiling`` prints the phase
table after each fit. ``config.attribution`` is ``"on"`` (default) or
``"off"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .metrics import metrics_registry
from .trace import tracer

ATTRIBUTION_SCHEMA = 1
# |phase_sum/measured - 1| tolerated by the reconciliation check. The
# table is built to telescope back to the measured step time, so the
# tolerance only absorbs float rounding — a bigger error means a bug.
DEFAULT_TOLERANCE = 0.02
DEFAULT_TOP_K = 8

# canonical phase order (render + reconciliation walk this)
PHASES = ("input_wait", "host_dispatch", "pipeline_bubble",
          "device_compute", "collective_transfer", "optimizer_fold")


def attribution_mode(config) -> str:
    """The validated ``config.attribution`` mode (typo fails at fit
    entry — the mode-knob convention every obs gate follows)."""
    mode = getattr(config, "attribution", "on") or "on"
    if mode not in ("on", "off"):
        raise ValueError(
            f"attribution={mode!r}: expected 'on' or 'off'")
    return mode


def _steady_state_epoch(fp: Dict) -> Optional[Dict]:
    """The last epoch with real steps — the steady-state window (the
    first epoch's wall time carries the kernels' first launch), the same
    convention obs/divergence.py measures against."""
    epochs = [e for e in (fp.get("epochs") or [])
              if e.get("steps") and e.get("wall_s", 0) > 0]
    return epochs[-1] if epochs else None


def _host_dispatch_s(measured_step_s: float, n_dispatches: int,
                     machine, steps: int) -> tuple:
    """Per-step host dispatch time: from the tracer ring's ``fit.step``
    spans (host-side dispatch + window control — measured) when tracing
    was on, else the machine model's per-dispatch overhead times the
    dispatch count (modeled). One span covers ``args.k`` steps under
    multi-step dispatch, so the estimate is sum(dur)/sum(k), and the
    window walks back only until it has covered the steady-state
    epoch's ``steps`` — the ring is process-global and an earlier
    model's (or the compile-laden first epoch's) spans must not leak
    into this fit's attribution.

    The departure from the JAX package: a span's ``args.wait_s``, the
    time the host spent blocked on the dispatch-ahead window (waiting for
    the card to finish an older step), is not host dispatch and is left
    out; the span itself still covers the whole step (the cohort's skew
    reads it)."""
    spans = [ev for ev in tracer().events()
             if ev.get("name") == "fit.step" and ev.get("ph") == "X"]
    dur_us = 0.0
    covered = 0
    for ev in reversed(spans):
        args = ev.get("args") or {}
        k = args.get("k") or 1
        dur_us += max(0.0, ev.get("dur", 0.0) - 1e6 * float(args.get("wait_s") or 0.0))
        covered += max(1, int(k))
        if covered >= max(1, steps):
            break
    if covered:
        per_step_s = dur_us / covered / 1e6
        return min(per_step_s, measured_step_s), "measured"
    return (min(machine.chip.step_overhead * max(1, n_dispatches),
                measured_step_s), "modeled")


def _predicted_phases(ffmodel) -> tuple:
    """(device-phase proportions dict, machine, per-op CostMetrics map).
    One analytic simulator replay over the compiled ops."""
    from ..sim import OpCostModel, Simulator
    from ..sim.simulator import task_phase_totals
    from .divergence import _machine

    cm = ffmodel.compiled
    machine = _machine(ffmodel)
    cost = OpCostModel(machine)
    sim = Simulator(machine, cost)
    sim.simulate_runtime(cm.ops)
    phases = task_phase_totals(sim.last_tasks(),
                               overlap_grad_sync=sim.overlap_grad_sync)
    # the sim prices the optimizer update at zero (it is memory-bound
    # bookkeeping, invisible to the critical-path replay); the
    # attribution table wants the fold's real share, so price it as the
    # optimizer's weight-state traffic (read grads + read/write master
    # weights ≈ 3x weight bytes) over the effective memory bandwidth
    wbytes = sim.memory_usage(cm.ops).weights
    chip = machine.chip
    phases["optimizer_fold"] += 3.0 * wbytes / (
        chip.hbm_bandwidth * chip.hbm_efficiency)
    per_op = {op.name: cost.measure(op) for op in cm.ops}
    return phases, machine, per_op


def _top_ops(ffmodel, per_op_cost, k: int) -> List[Dict]:
    """Per-op rows ranked by measured time (fwd+bwd, from the
    divergence record's profile_ops pass when it ran) with the analytic
    prediction alongside; predicted-only ranking when no measured rows
    exist. Rows carry layer provenance so a hot op names its layer."""
    from ..analysis.findings import layer_provenance

    measured: Dict[str, Dict] = {}
    fp = getattr(ffmodel, "fit_profile", None) or {}
    for r in (fp.get("divergence") or {}).get("per_op") or []:
        measured[r["name"]] = r
    pred_total = sum(c.forward_time + c.backward_time
                     for c in per_op_cost.values()) or 1.0
    rows: List[Dict] = []
    for op in ffmodel.compiled.ops:
        c = per_op_cost.get(op.name)
        if c is None:
            continue
        pred_ms = (c.forward_time + c.backward_time) * 1e3
        m = measured.get(op.name)
        meas_ms = None
        if m is not None:
            meas_ms = m.get("measured_ms") or 0.0
            if m.get("measured_bwd_ms") is not None:
                meas_ms += m["measured_bwd_ms"]
        rows.append({
            "name": op.name,
            "type": op.op_type.value,
            "provenance": layer_provenance(op.layer),
            "predicted_ms": round(pred_ms, 6),
            "predicted_share": round(
                (c.forward_time + c.backward_time) / pred_total, 4),
            "measured_ms": (round(meas_ms, 6)
                            if meas_ms is not None else None),
            "ratio": (round(meas_ms / pred_ms, 4)
                      if meas_ms is not None and pred_ms > 0 else None),
        })
    # deterministic ranking: measured time when the profile ran, else
    # the prediction; name breaks ties so reruns rank identically
    rows.sort(key=lambda r: (-(r["measured_ms"]
                               if r["measured_ms"] is not None
                               else r["predicted_ms"]), r["name"]))
    return rows[:k]


def _divergence_outliers(top_rows: List[Dict], k: int) -> List[Dict]:
    """The largest |measured - predicted| contributors among rows that
    have both sides — where the cost model's error concentrates."""
    both = [r for r in top_rows if r["measured_ms"] is not None]
    both = sorted(both,
                  key=lambda r: (-abs(r["measured_ms"] - r["predicted_ms"]),
                                 r["name"]))
    return [{"name": r["name"], "type": r["type"],
             "provenance": r["provenance"],
             "predicted_ms": r["predicted_ms"],
             "measured_ms": r["measured_ms"],
             "abs_error_ms": round(
                 abs(r["measured_ms"] - r["predicted_ms"]), 6),
             "ratio": r["ratio"]} for r in both[:k]]


def attribute_fit(ffmodel, tolerance: float = DEFAULT_TOLERANCE,
                  top_k: Optional[int] = None) -> Optional[Dict]:
    """Build one AttributionReport for the most recent fit; None when
    there is nothing to attribute (no fit profile, no compiled ops, or
    a ~zero measured step)."""
    fp = getattr(ffmodel, "fit_profile", None)
    cm = getattr(ffmodel, "compiled", None)
    if not fp or cm is None or not cm.ops:
        return None
    epoch = _steady_state_epoch(fp)
    if epoch is None:
        return None
    measured = epoch["wall_s"] / epoch["steps"]
    if measured <= 0:
        return None
    k = top_k if top_k is not None else max(
        1, int(getattr(ffmodel.config, "attribution_top_k",
                       DEFAULT_TOP_K) or DEFAULT_TOP_K))

    # --- measured host-side components ------------------------------
    input_wait = min(epoch.get("input_wait_s", 0.0) / epoch["steps"],
                     measured)
    pipe = fp.get("pipeline") or {}
    n_disp = int(pipe.get("dispatches_per_step") or 1)
    phases_pred, machine, per_op_cost = _predicted_phases(ffmodel)
    host_dispatch, dispatch_basis = _host_dispatch_s(
        measured, n_disp, machine, int(epoch["steps"]))
    if dispatch_basis == "measured":
        # tracer-measured dispatch time comes off the top next to the
        # input wait; scale both down if their sum exceeds the step
        # (tiny steps on a loaded host) so the table still telescopes
        host_sum = input_wait + host_dispatch
        if host_sum > measured:
            scale = measured / host_sum
            input_wait *= scale
            host_dispatch *= scale
        weights = dict(phases_pred)
    else:
        # no tracer evidence: the analytic dispatch overhead is just
        # another modeled estimate — it competes proportionally with
        # the device phases instead of swallowing the step whole
        weights = dict(phases_pred)
        weights["host_dispatch"] = host_dispatch
        host_dispatch = 0.0

    # --- residual, split by schedule + predicted proportions ---------
    residual = max(0.0, measured - input_wait - host_dispatch)
    bubble_frac = float(pipe.get("bubble_fraction") or 0.0)
    bubble = residual * min(max(bubble_frac, 0.0), 1.0) \
        if ffmodel.pipelined is not None else 0.0
    device = residual - bubble
    wsum = sum(weights.values())
    if wsum <= 0:
        weights, wsum = {"device_compute": 1.0}, 1.0
    shares = {name: weights.get(name, 0.0) / wsum
              for name in ("host_dispatch", "device_compute",
                           "collective_transfer", "optimizer_fold")}

    table: Dict[str, Dict] = {
        "input_wait": {"seconds": input_wait, "basis": "measured"},
        "host_dispatch": {
            "seconds": (host_dispatch if dispatch_basis == "measured"
                        else device * shares["host_dispatch"]),
            "basis": dispatch_basis},
        "pipeline_bubble": {"seconds": bubble, "basis": "modeled"},
        "device_compute": {
            "seconds": device * shares["device_compute"],
            "basis": "modeled"},
        "collective_transfer": {
            "seconds": device * shares["collective_transfer"],
            "basis": "modeled"},
        "optimizer_fold": {
            "seconds": device * shares["optimizer_fold"],
            "basis": "modeled"},
    }
    for name in PHASES:
        row = table[name]
        row["seconds"] = round(row["seconds"], 9)
        row["fraction"] = round(row["seconds"] / measured, 4)
    phase_sum = sum(table[name]["seconds"] for name in PHASES)
    err = abs(phase_sum / measured - 1.0)
    dominant = max(PHASES, key=lambda n: table[n]["seconds"])

    top_rows = _top_ops(ffmodel, per_op_cost, k)
    rec: Dict = {
        "schema": ATTRIBUTION_SCHEMA,
        "measured_step_s": round(measured, 9),
        "predicted_step_s": {name: round(v, 9)
                             for name, v in phases_pred.items()},
        "phases": table,
        "phase_order": list(PHASES),
        "reconciliation": {
            "phase_sum_s": round(phase_sum, 9),
            "measured_step_s": round(measured, 9),
            "error": round(err, 6),
            "tolerance": tolerance,
            "reconciles": err <= tolerance,
        },
        "dominant_phase": dominant,
        "top_k": k,
        "top_ops": top_rows,
        "divergence_outliers": _divergence_outliers(top_rows, k),
        "pipelined": ffmodel.pipelined is not None,
    }
    reg = metrics_registry()
    reg.counter("attribution.reports").inc()
    reg.gauge("attribution.reconciliation_error").set(err)
    for name in PHASES:
        reg.gauge(f"attribution.{name}_s").set(table[name]["seconds"])
    return rec


def maybe_attribute(ffmodel) -> None:
    """fit()'s hook: apply ``config.attribution`` and attach the report
    to ``fit_profile["attribution"]`` (and the obs server's
    ``/attribution`` endpoint). Runs AFTER the divergence hook so the
    per-op measured rows are joinable."""
    if attribution_mode(ffmodel.config) == "off":
        return
    rec = attribute_fit(ffmodel)
    if rec is None or ffmodel.fit_profile is None:
        return
    ffmodel.fit_profile["attribution"] = rec
    from .server import publish_attribution

    publish_attribution(rec)


SERVING_PHASES = ("queue_wait", "prefill", "decode")


def serving_attribution(stats: Dict) -> Optional[Dict]:
    """The serving analog of the fit phase table: a uniform
    queue_wait/prefill/decode record built from a continuous-batching
    scheduler's :meth:`stats` snapshot, so serving-only processes have
    the same ``/attribution`` surface (and the perf advisor a uniform
    input) fit processes do. Phase rows keep the session percentile
    blocks (count/mean/p50/p99); ``dominant_phase`` is the largest
    mean. None when the session has not measured any phase yet."""
    phases: Dict[str, Dict] = {}
    for name in SERVING_PHASES:
        block = (stats.get("phases") or {}).get(name)
        if isinstance(block, dict) and isinstance(
                block.get("mean"), (int, float)):
            phases[name] = dict(block)
    if not phases:
        return None
    means = {n: float(p["mean"]) for n, p in phases.items()}
    rec = {
        "schema": ATTRIBUTION_SCHEMA,
        "kind": "serving",
        "engine": stats.get("serving_engine"),
        "model": stats.get("model"),
        "phases": phases,
        "phase_order": [n for n in SERVING_PHASES if n in phases],
        "dominant_phase": max(means, key=lambda n: means[n]),
        "tokens_per_s": stats.get("tokens_per_s"),
        "completed": stats.get("completed"),
        "knobs": stats.get("knobs"),
        "kv": stats.get("kv"),
    }
    metrics_registry().counter("attribution.serving_reports").inc()
    return rec


def attribution_report(ffmodel) -> Optional[Dict]:
    """The last fit's attribution record, or None."""
    fp = getattr(ffmodel, "fit_profile", None) or {}
    return fp.get("attribution")


def format_phase_table(rec: Dict) -> str:
    """One aligned text table, the ``--profiling`` print."""
    rcn = rec.get("reconciliation") or {}
    lines = [
        "[attribution] step %.3fms steady-state, dominant phase %s "
        "(phase sum %.3fms, %s)" % (
            rec["measured_step_s"] * 1e3, rec["dominant_phase"],
            (rcn.get("phase_sum_s") or 0.0) * 1e3,
            "reconciles" if rcn.get("reconciles")
            else "DOES NOT RECONCILE"),
        "  %-20s %10s %7s  %s" % ("phase", "ms", "share", "basis"),
    ]
    for name in rec.get("phase_order") or PHASES:
        row = rec["phases"][name]
        lines.append("  %-20s %10.3f %6.1f%%  %s" % (
            name, row["seconds"] * 1e3, row["fraction"] * 100.0,
            row["basis"]))
    return "\n".join(lines)


__all__ = [
    "ATTRIBUTION_SCHEMA", "DEFAULT_TOLERANCE", "PHASES",
    "SERVING_PHASES", "attribute_fit", "attribution_mode",
    "attribution_report", "format_phase_table", "maybe_attribute",
    "serving_attribution",
]
