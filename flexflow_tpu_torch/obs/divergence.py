"""Sim-vs-measured divergence: close the predict→measure loop.

PyTorch counterpart of ``flexflow_tpu/obs/divergence.py``. After a fit
it compares:

* **end to end**: the prediction that steered this compile (the search's
  ``est_step_time`` when a search ran, else the pipeline schedule model's
  record for the resolved schedule, else a fresh
  :class:`~..sim.simulator.Simulator` replay over the model's machine
  model) against the measured seconds a step from ``fit_profile``;
* **per op**: the analytic cost model's forward and backward times per
  compiled op against :func:`~..runtime.profiling.profile_ops`'s
  measured ones (CUDA events on the card).

The record lands as ``fit_profile["divergence"]``, each sample feeds the
``divergence.*`` metrics, and an end-to-end error past
``config.divergence_threshold`` raises the coded finding **OBS001**
(warn). ``config.divergence`` is ``"off"`` (default), ``"e2e"`` or
``"on"`` (adds the per-op comparison, one standalone run of every op).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .metrics import metrics_registry
from .trace import span

# error tolerated before OBS001 fires when config carries no threshold
DEFAULT_THRESHOLD = 1.0  # |ratio-1| <= 1.0 → within 2x either way


def _machine(ffmodel):
    """The machine model this compile priced with: the config's
    machine-model file, else the detected one over the mesh's ranks."""
    cm = ffmodel.compiled
    n = 1
    for s in (cm.mesh.shape.values() if cm.mesh is not None else ()):
        n *= int(s)
    return ffmodel._machine_model(n)


def predicted_step_time(ffmodel) -> Optional[Tuple[float, str]]:
    """The step-time prediction that steered (or would have steered)
    this compile: ``(seconds, source)`` with source one of ``"search"``,
    ``"schedule_model"``, ``"simulator"``; None when the model has no
    compiled ops to price."""
    sp = getattr(ffmodel, "search_profile", None)
    if sp and sp.get("est_step_time"):
        return float(sp["est_step_time"]), "search"
    pm = getattr(ffmodel, "pipelined", None)
    if pm is not None:
        # the per-candidate pricing _resolve_pipeline recorded; pick the
        # schedule the engine actually runs
        for rec in getattr(ffmodel, "_pipe_schedule_records", None) or []:
            if rec.get("schedule") == pm.cfg.schedule:
                return float(rec["est_step_time"]), "schedule_model"
    cm = getattr(ffmodel, "compiled", None)
    if cm is None or not cm.ops:
        return None
    from ..sim import OpCostModel, Simulator

    machine = _machine(ffmodel)
    sim = Simulator(machine, OpCostModel(machine))
    est = sim.simulate_runtime(cm.ops)
    if pm is not None:
        # price the resolved schedule over the whole-graph estimate so a
        # pipelined fit is compared against a pipelined prediction
        try:
            est = sim.pipeline_schedule_cost(
                pm.schedule, est, engine=pm.engine_name,
                bwd_ratio=OpCostModel.BWD_FACTOR)["est_step_time"]
        except Exception:
            pass
    return float(est), "simulator"


def op_predictions(ffmodel) -> Dict[str, Tuple[float, float]]:
    """Per-op analytic (forward, backward) times in seconds for every
    compiled op — both halves, so the per-op comparison covers the same
    fwd+bwd envelope the measured pass times."""
    from ..sim import OpCostModel

    cm = ffmodel.compiled
    cost = OpCostModel(_machine(ffmodel))
    return {op.name: (cost.measure(op).forward_time,
                      cost.measure(op).backward_time) for op in cm.ops}


def _ratio(measured: float, predicted: float) -> Optional[float]:
    if predicted and predicted > 0 and measured >= 0:
        return round(measured / predicted, 4)
    return None


def record_divergence(ffmodel, per_op: bool = True,
                      iters: int = 3) -> Optional[Dict]:
    """Build one divergence record for the most recent fit. Returns None
    when there is nothing to compare (no fit profile or no prediction).

    The record: ``predicted_step_s``/``measured_step_s``/``e2e_ratio``
    (measured/predicted) + ``source``, per-epoch measured ratios, and —
    with ``per_op`` — one ``{name, type, predicted_ms, measured_ms,
    ratio}`` row per compiled op. OBS001 (warn) is added to
    ``ffmodel.obs_report`` when ``|e2e_ratio - 1|`` exceeds the
    configured threshold."""
    # drop any previous fit's finding first — BEFORE the early returns: a
    # fit with nothing to compare must not leave a stale OBS001 attached
    ffmodel.obs_report = None
    fp = getattr(ffmodel, "fit_profile", None)
    pred = predicted_step_time(ffmodel)
    if not fp or not fp.get("epochs") or pred is None:
        return None
    predicted, source = pred
    epochs = [e for e in fp["epochs"] if e["steps"] and e["wall_s"] > 0]
    if not epochs:
        return None
    # headline measured = the last epoch (steady state): the first
    # epoch's wall time carries the kernels' first launch, which is not a
    # cost-model miss. All epochs stay visible in epoch_ratios.
    measured = epochs[-1]["wall_s"] / epochs[-1]["steps"]
    rec: Dict = {
        "source": source,
        "predicted_step_s": round(predicted, 6),
        "measured_step_s": round(measured, 6),
        "e2e_ratio": _ratio(measured, predicted),
        "epoch_ratios": [
            _ratio(e["wall_s"] / e["steps"], predicted)
            for e in epochs if e["steps"]
        ],
    }
    reg = metrics_registry()
    reg.gauge("divergence.e2e_ratio").set(rec["e2e_ratio"] or 0.0)
    reg.histogram("divergence.measured_step_s").observe(measured)
    if per_op:
        rows: List[Dict] = []
        with span("divergence.profile_ops", cat="obs"):
            from ..runtime.profiling import profile_ops

            predicted_ops = op_predictions(ffmodel)
            try:
                # fwd AND bwd: a cost model can nail the forward and
                # still mis-rank every search if its backward factors
                # drift (the backward is 2/3 of a training step)
                measured_ops = profile_ops(ffmodel, iters=iters,
                                           warmup=1, backward=True)
            except Exception as e:  # never kill a fit over a profile
                measured_ops = []
                rec["per_op_error"] = f"{type(e).__name__}: {e}"
        for r in measured_ops:
            p_fwd, p_bwd = predicted_ops.get(r["name"]) or (0.0, 0.0)
            m_s = r["forward_ms"] / 1e3
            m_bwd = r.get("backward_ms")
            row = {
                "name": r["name"],
                "type": r["type"],
                "predicted_ms": round(p_fwd * 1e3, 6),
                "measured_ms": round(r["forward_ms"], 6),
                "ratio": _ratio(m_s, p_fwd),
                "predicted_bwd_ms": round(p_bwd * 1e3, 6),
                "measured_bwd_ms": (round(m_bwd, 6)
                                    if m_bwd is not None else None),
                "bwd_ratio": (_ratio(m_bwd / 1e3, p_bwd)
                              if m_bwd is not None else None),
            }
            rows.append(row)
            if row["ratio"]:
                reg.histogram("divergence.op_ratio").observe(row["ratio"])
            if row["bwd_ratio"]:
                reg.histogram("divergence.op_bwd_ratio").observe(
                    row["bwd_ratio"])
        rec["per_op"] = rows
    # --- OBS001: the coded, warn-level finding past the threshold -------
    thr = getattr(ffmodel.config, "divergence_threshold", None)
    thr = DEFAULT_THRESHOLD if thr is None else float(thr)
    rec["threshold"] = thr
    findings = []
    r = rec["e2e_ratio"]
    if r is not None and abs(r - 1.0) > thr:
        from ..analysis.findings import ValidationReport

        report = ValidationReport(source="divergence")
        f = report.add(
            "OBS001",
            f"end-to-end step time diverged from the {source} "
            f"prediction: measured {measured*1e3:.3f}ms vs predicted "
            f"{predicted*1e3:.3f}ms (ratio {r}, threshold "
            f"|ratio-1|<={thr}) — the cost model steering the search "
            f"no longer matches this machine",
            severity="warning")
        ffmodel.obs_report = report
        print(f"[obs] {f.format()}", flush=True)
        findings.append(f.to_dict())
        metrics_registry().counter("divergence.obs001_findings").inc()
    rec["findings"] = findings
    return rec


def divergence_mode(config) -> str:
    """The validated ``config.divergence`` mode. fit() calls this at
    entry, so a typo fails before training, not after."""
    mode = getattr(config, "divergence", "off") or "off"
    if mode not in ("off", "e2e", "on"):
        raise ValueError(
            f"divergence={mode!r}: expected 'off', 'e2e' or 'on'")
    return mode


def maybe_record_divergence(ffmodel) -> None:
    """fit()'s hook: apply the ``config.divergence`` mode and attach the
    record to ``fit_profile["divergence"]``."""
    mode = divergence_mode(ffmodel.config)
    ffmodel.obs_report = None  # this fit's verdict, even when unchecked
    if mode == "off":
        return
    rec = record_divergence(ffmodel, per_op=(mode == "on"))
    if rec is not None and ffmodel.fit_profile is not None:
        ffmodel.fit_profile["divergence"] = rec


def divergence_report(ffmodel) -> Optional[Dict]:
    """The last fit's divergence record, or None."""
    fp = getattr(ffmodel, "fit_profile", None) or {}
    return fp.get("divergence")
