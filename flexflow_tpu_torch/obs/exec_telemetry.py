"""Executable telemetry: what one step of a compiled program costs.

PyTorch counterpart of ``flexflow_tpu/obs/exec_telemetry.py``. XLA's
``cost_analysis()``/``memory_analysis()`` have no twin here, so the port
measures one step of each program instead:

* **flops** from :class:`torch.utils.flop_counter.FlopCounterMode` over
  one traced step (the aten ops it runs; a hand-written kernel called
  through its own binding is not an aten op, so on the card the
  attention kernels' products are not in the count);
* **peak bytes** from ``torch.cuda.max_memory_allocated`` around that
  step on the card (``null`` on the CPU, with the reason);
* the peak reconciled against a static estimate: where the program
  audit ran (``config.audit_programs``, on by default), the audit records
  the same measured call and its liveness walk's ``static_peak_bytes``
  is the estimate, as the JAX package reconciles against its audit's;
  where it did not, the simulator's static ``memory_usage`` (weights,
  saved activations, optimizer state). Past ``config.exec_mem_threshold``
  the coded finding **OBS002** (warn).

The block lands on ``FFModel.exec_telemetry``, the compile ledger record
and the ``exec.*`` metrics. ``config.exec_telemetry="on"`` opts in (one
extra step a program, a profiling-run cost). OBS002 is waived only by an
``exec_mem_allow`` entry with a non-empty reason.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from .metrics import metrics_registry
from .trace import span

# symmetric divergence (max(r, 1/r) - 1 for r = measured/static) tolerated
# before OBS002 when config carries no threshold (3.0 = within 4x either
# way: the static model prices every saved activation at full size, the
# allocator reuses and frees)
DEFAULT_MEM_THRESHOLD = 3.0


def telemetry_mode(config) -> str:
    """The validated ``config.exec_telemetry`` mode (a typo fails at
    compile entry)."""
    mode = getattr(config, "exec_telemetry", "off") or "off"
    if mode not in ("on", "off"):
        raise ValueError(
            f"exec_telemetry={mode!r}: expected 'on' or 'off'")
    return mode


def collect_traced(name: str, step: Callable[[], object], device) -> Dict:
    """Run ``step()`` once under the flop counter and, on the card,
    between a reset of the allocator's peak and its read. Every failure
    lands as an explicit ``unavailable`` reason, never an exception into
    the caller."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    try:
        with span("obs.exec_step", cat="obs", program=name):
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            counter = FlopCounterMode(display=False)
            with counter:
                step()
            if cuda:
                torch.cuda.synchronize(dev)
    except Exception as e:  # noqa: BLE001 — telemetry never masks compile
        return {"unavailable": f"step failed: {type(e).__name__}: {e}"}
    out: Dict = {"step_s": round(time.perf_counter() - t0, 6),
                 "flops": float(counter.get_total_flops())}
    if cuda:
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    else:
        out["peak_bytes"] = None
        out["memory"] = {"unavailable": "peak bytes are read on the card only"}
    return out


def _feed_metrics(name: str, tel: Dict) -> None:
    reg = metrics_registry()
    if "unavailable" in tel:
        reg.counter("exec.unavailable").inc()
        return
    reg.counter("exec.programs").inc()
    for key in ("flops", "peak_bytes"):
        if tel.get(key) is not None:
            reg.gauge(f"exec.{name}.{key}").set(float(tel[key]))


# --------------------------------------------------- OBS002 reconciliation
def reconcile_peak_memory(name: str, static_bytes, xla_bytes, *,
                          config=None,
                          allow: Optional[Dict[str, str]] = None,
                          printer=print) -> Dict:
    """Compare the static peak estimate (the program audit's liveness
    walk, else the simulator's) against the measured peak of one
    program (``xla_bytes`` keeps the JAX package's name: here it is the
    card's ``max_memory_allocated``). Returns the reconciliation row;
    past ``config.exec_mem_threshold`` it carries the OBS002 finding
    (warn: printed, counted on ``exec.obs002_findings``).

    ``allow``: program name -> reason. Only a non-empty reason
    suppresses; a suppressed row records the reason instead."""
    row: Dict = {"program": name}
    if not static_bytes or not xla_bytes or static_bytes <= 0 \
            or xla_bytes <= 0:
        row["unavailable"] = "no static estimate or no measured peak to compare"
        return row
    ratio = float(xla_bytes) / float(static_bytes)
    divergence = max(ratio, 1.0 / ratio) - 1.0  # symmetric in direction
    thr = getattr(config, "exec_mem_threshold", None)
    thr = DEFAULT_MEM_THRESHOLD if thr is None else float(thr)
    row.update({"static_peak_bytes": int(static_bytes),
                "xla_peak_bytes": int(xla_bytes),
                "ratio": round(ratio, 4),
                "divergence": round(divergence, 4), "threshold": thr})
    if divergence <= thr:
        return row
    reason = (allow or {}).get(name)
    if reason:  # a reason is required to suppress; "" does not
        row["suppressed"] = reason
        return row
    from ..analysis.findings import ValidationReport

    report = ValidationReport(source="exec_telemetry", tag="obs")
    f = report.add(
        "OBS002",
        f"program '{name}': measured peak memory "
        f"{int(xla_bytes)}B diverges from the static estimate "
        f"{int(static_bytes)}B (ratio {ratio:.3f}, divergence "
        f"{divergence:.3f} > threshold {thr}) — the memory model "
        f"steering memory-aware decisions no longer matches the "
        f"allocator",
        severity="warning")
    printer(f"[obs] {f.format()}", flush=True)
    metrics_registry().counter("exec.obs002_findings").inc()
    row["finding"] = f.to_dict()
    return row


# ------------------------------------------------------------ entry points
def collect_one(name: str, step: Callable[[], object], device, *,
                config=None, static_peak=None,
                allow: Optional[Dict[str, str]] = None) -> Dict:
    """One program's block ``{"programs": {name: tel}}``, with its
    ``reconciliation`` row when a peak was measured."""
    tel = collect_traced(name, step, device)
    _feed_metrics(name, tel)
    out: Dict = {"programs": {name: tel}}
    if tel.get("peak_bytes"):
        out["reconciliation"] = [reconcile_peak_memory(
            name, static_peak, tel["peak_bytes"], config=config,
            allow=allow)]
    return out


def static_peak_bytes(ffmodel) -> Optional[int]:
    """The simulator's static memory estimate of the compiled ops on this
    rank: weights, saved activations and optimizer state."""
    from ..sim import OpCostModel, Simulator
    from .divergence import _machine

    cm = ffmodel.compiled
    if cm is None or not cm.ops:
        return None
    machine = _machine(ffmodel)
    mult = 2.0 if cm.opt_state is not None else 0.0
    sim = Simulator(machine, OpCostModel(machine), optimizer_state_mult=mult)
    return int(sim.memory_usage(cm.ops).total)


def collect_compiled_model(ffmodel, *, config=None,
                           allow: Optional[Dict[str, str]] = None,
                           audit_report=None) -> Dict:
    """Telemetry for the compiled model's step: ``grad_step`` (forward
    and backward on a synthetic batch; the params and optimizer state
    stay as they are) when it trains, else ``forward``, each its eager
    function (``cm.eager``: a replayed graph shows the counters no op).
    With
    ``audit_report`` (the compile's program audit) the measured call is
    also the audit's recording of that program: one call serves both
    gates, and its static peak is the OBS002 estimate."""
    import numpy as np
    import torch

    from ..runtime.profiling import _min_vocab_bound, synth_array

    cm = ffmodel.compiled
    rng = np.random.default_rng(0)
    bound = _min_vocab_bound(cm.ops)
    xs = []
    for i, t in enumerate(cm.input_tensors):
        a = synth_array(t, rng, int_high=bound)[cm.batch_rows(i)]
        xs.append(torch.as_tensor(a, device=cm.device))
    if cm.grad_step is not None and cm.label_tensor is not None:
        lab = cm.label_tensor
        y = synth_array(lab, rng, int_high=int(cm.logits_tensor.dims[-1]))
        y = torch.as_tensor(y[cm.batch_rows(len(cm.input_tensors))], device=cm.device)
        name = "grad_step"

        def step():
            return cm.eager["grad_step"](cm.params, 0, *xs, y)
    else:
        name = "forward"

        def step():
            with torch.no_grad():
                return cm.eager["forward_fn"](cm.params, *xs)
    if audit_report is None:
        return collect_one(name, step, cm.device, config=config,
                           static_peak=static_peak_bytes(ffmodel), allow=allow)
    from ..analysis.program_audit import audit_call

    # the params and the batch are the recorded call's arguments
    _, tel, _ = audit_call(name, lambda _params, _xs: step(), (cm.params, xs), config=config,
                           device=cm.device, source="exec_telemetry", report=audit_report,
                           count=False)
    return tel


__all__ = [
    "DEFAULT_MEM_THRESHOLD", "collect_compiled_model", "collect_one",
    "collect_traced", "reconcile_peak_memory", "static_peak_bytes",
    "telemetry_mode",
]
