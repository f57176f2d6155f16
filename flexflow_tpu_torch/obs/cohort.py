"""Cohort observability: cross-rank trace unification, straggler
attribution and the fleet-level roll-up.

PyTorch counterpart of ``flexflow_tpu/obs/cohort.py``, the same
artifacts, report and finding:

* :func:`merge_traces` re-bases N per-rank Chrome traces onto one
  timeline by their ``wall_clock_anchor_unix_s`` metadata, one process
  lane a source trace;
* :func:`step_skew` aligns ``fit.step`` spans by step ordinal across
  ranks, takes each step's skew as slowest minus median rank, and raises
  **OBS003** when the steady-state skew fraction exceeds
  ``config.cohort_skew_threshold``, naming the straggler;
* :func:`cohort_attribution` extends the median rank's attribution table
  with a ``rank_skew`` phase, still summing to the cohort's step;
* :func:`merge_metric_snapshots` folds per-rank registry snapshots.

``config.cohort_obs="on"`` makes every fit arm the tracer and export its
rank's ``trace-rank<r>.json``, ``metrics-rank<r>.json`` and
``cohort-rank<r>.json`` into the cohort directory (knob >
``FLEXFLOW_TPU_COHORT_DIR`` > ``.ffcache/obs/cohort``);
:func:`build_cohort_report` folds them into one report, published on the
obs server's ``/cohort``. The supervisor (``parallel/launch.py
--cohort-obs``) drives it end to end. A rank is a process of the
``torch.distributed`` group (rank 0 of 1 without one).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Sequence

from .metrics import MetricsRegistry, metrics_registry
from .trace import tracer, validate_chrome_trace

COHORT_SCHEMA = 1
# steady-state skew fraction tolerated before OBS003 (0.25 = the
# slowest rank runs a quarter slower than the cohort median)
DEFAULT_SKEW_THRESHOLD = 0.25
# the phase name cohort_attribution() appends to the attribution table
COHORT_PHASE = "rank_skew"
DEFAULT_DIR = ".ffcache/obs/cohort"
ENV_DIR = "FLEXFLOW_TPU_COHORT_DIR"

_MANIFEST_RE = re.compile(r"cohort-rank(\d+)\.json$")


def cohort_obs_mode(config) -> str:
    """The validated ``config.cohort_obs`` mode (a typo fails at fit
    entry — the mode-knob convention every obs gate follows)."""
    mode = getattr(config, "cohort_obs", "off") or "off"
    if mode not in ("on", "off"):
        raise ValueError(f"cohort_obs={mode!r}: expected 'on' or 'off'")
    return mode


def cohort_dir(config=None) -> str:
    """Artifact directory resolution: explicit knob >
    ``FLEXFLOW_TPU_COHORT_DIR`` env > default — the ledger_dir
    convention, so N ranks of one cohort and a config-less reader agree
    on the directory."""
    explicit = getattr(config, "cohort_obs_dir", None) \
        if config is not None else None
    return explicit or os.environ.get(ENV_DIR) or DEFAULT_DIR


def _median(xs: Sequence[float]) -> float:
    ys = sorted(xs)
    n = len(ys)
    return ys[n // 2] if n % 2 else 0.5 * (ys[n // 2 - 1] + ys[n // 2])


def _atomic_json(path: str, doc: Dict) -> None:
    """Torn-write safety: rank artifacts are read by a supervisor that
    may race the writer's exit — a reader sees the old file or the new
    one, never half of each."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# -------------------------------------------------------- trace unification
def merge_traces(paths: Sequence[str], out: Optional[str] = None) -> Dict:
    """Merge per-rank Chrome traces onto one timeline.

    Every input must carry the ``wall_clock_anchor_unix_s``
    metadata (each trace's ``ts`` values are microseconds since its own
    process epoch, meaningless across processes without it). The
    earliest anchor becomes the merged epoch; every event of trace *i*
    shifts by ``(anchor_i - anchor_min) * 1e6`` µs and moves to process
    lane ``pid = i`` (one lane per source trace — tids within a lane
    keep their identity, so per-track span nesting survives the uniform
    shift and the merged payload passes ``validate_chrome_trace``).
    ``metadata.ranks`` records each lane's source file, label, anchor,
    and drift; pass ``out`` to also write the merged JSON atomically.
    """
    if not paths:
        raise ValueError("merge_traces: no trace paths given")
    loaded = []
    for path in paths:
        with open(path) as f:
            payload = json.load(f)
        md = payload.get("metadata") or {}
        anchor = md.get("wall_clock_anchor_unix_s")
        if not isinstance(anchor, (int, float)) or anchor <= 0:
            raise ValueError(
                f"{path}: metadata.wall_clock_anchor_unix_s missing or "
                f"not a positive number — this trace cannot be re-based "
                f"onto the cohort timeline")
        loaded.append((path, payload, md, float(anchor)))
    base = min(anchor for *_, anchor in loaded)
    events: List[Dict] = []
    ranks_md: Dict[str, Dict] = {}
    for lane, (path, payload, md, anchor) in enumerate(loaded):
        delta_us = (anchor - base) * 1e6
        label = md.get("label") or md.get("process") or f"rank{lane}"
        src_pids = set()
        for ev in payload.get("traceEvents") or []:
            ev = dict(ev)
            if ev.get("pid") is not None:
                src_pids.add(ev["pid"])
            ev["pid"] = lane
            ev["ts"] = round(float(ev.get("ts", 0.0)) + delta_us, 3)
            events.append(ev)
        # Perfetto/chrome://tracing lane naming (ph "M" carries no dur,
        # so the nesting validator ignores it)
        events.append({"name": "process_name", "ph": "M", "ts": 0,
                       "pid": lane, "tid": 0, "args": {"name": str(label)}})
        ranks_md[str(lane)] = {
            "source": os.path.basename(path),
            "label": str(label),
            "process": md.get("process"),
            "anchor_unix_s": round(anchor, 6),
            "drift_s": round(anchor - base, 6),
            "pid": lane,
            "source_pids": sorted(src_pids),
        }
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    merged = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            # the merged anchor: ts == 0 of the merged timeline is the
            # EARLIEST rank's epoch, so the payload re-validates as a
            # mergeable trace in its own right
            "wall_clock_anchor_unix_s": round(base, 6),
            "process": f"cohort:{len(loaded)}ranks",
            "clock": "us_since_cohort_epoch",
            "ranks": ranks_md,
        },
    }
    if out:
        _atomic_json(out, merged)
    return merged


# ----------------------------------------------------- skew attribution
def rank_step_times(payload) -> List[float]:
    """One rank's per-step durations (seconds), in step order, from its
    trace's ``fit.step`` spans. A span recorded under multi-step
    dispatch covers ``args.k`` steps and expands to k equal per-step
    entries (the k-normalization attribution's ``_host_dispatch_s``
    uses), so ranks running different ``steps_per_dispatch`` still
    align by step ordinal. Accepts a trace payload dict or a raw event
    list."""
    evs = payload.get("traceEvents") if isinstance(payload, dict) \
        else payload
    spans = [ev for ev in (evs or [])
             if ev.get("name") == "fit.step" and ev.get("ph") == "X"]
    spans.sort(key=lambda e: e.get("ts", 0.0))
    out: List[float] = []
    for ev in spans:
        k = max(1, int((ev.get("args") or {}).get("k") or 1))
        out.extend([float(ev.get("dur", 0.0)) / k / 1e6] * k)
    return out


def step_skew(step_times_by_rank: Dict, threshold: Optional[float] = None,
              ) -> Optional[Dict]:
    """Cross-rank skew table from per-rank step-time series.

    Steps align by ordinal across ranks (common prefix — a rank that
    recorded fewer spans truncates the window, never misaligns it).
    Per step: the cohort median, the slowest rank (ties break to the
    lowest rank id — deterministic reruns), and the skew = slowest
    minus median (the median makes the baseline robust to one outlier
    rank at any cohort size >= 3; at 2 ranks it degrades to the mean).
    The steady-state skew fraction is the median over post-first steps
    (the first step carries the kernels' first launch); when
    it exceeds ``threshold`` the coded OBS003 finding fires naming the
    straggler: the rank slowest most often (ties: larger summed excess,
    then lower rank id). Every per-step skew fraction lands in the
    ``cohort.step_skew_frac`` histogram. None when fewer than 2 ranks
    or zero aligned steps — there is no cohort to skew."""
    thr = DEFAULT_SKEW_THRESHOLD if threshold is None else float(threshold)
    ranks = sorted(step_times_by_rank)
    series = {r: list(step_times_by_rank[r]) for r in ranks}
    common = min((len(v) for v in series.values()), default=0)
    if len(ranks) < 2 or common < 1:
        return None
    per_step: List[Dict] = []
    for s in range(common):
        vals = {r: float(series[r][s]) for r in ranks}
        med = _median(list(vals.values()))
        slowest = max(ranks, key=lambda r: vals[r])  # first max = low rank
        skew_s = vals[slowest] - med
        frac = skew_s / med if med > 0 else 0.0
        per_step.append({"step": s,
                         "median_s": round(med, 9),
                         "max_s": round(vals[slowest], 9),
                         "slowest_rank": slowest,
                         "skew_s": round(skew_s, 9),
                         "skew_frac": round(frac, 6)})
    hist = metrics_registry().histogram("cohort.step_skew_frac")
    for row in per_step:
        hist.observe(row["skew_frac"])
    steady = per_step[1:] if common > 1 else per_step
    steady_frac = _median([row["skew_frac"] for row in steady])
    counts = {r: 0 for r in ranks}
    excess = {r: 0.0 for r in ranks}
    for row in steady:
        counts[row["slowest_rank"]] += 1
        excess[row["slowest_rank"]] += row["skew_s"]
    straggler = sorted(ranks,
                       key=lambda r: (-counts[r], -excess[r]))[0]
    per_rank = {
        str(r): {
            "steps": common,
            "total_s": round(sum(series[r][:common]), 9),
            "mean_step_s": round(sum(series[r][:common]) / common, 9),
            "slowest_count": counts[r],
        } for r in ranks
    }
    findings: List[Dict] = []
    if steady_frac > thr:
        from ..analysis.findings import Finding

        findings.append(Finding(
            code="OBS003", severity="warning",
            message=(f"steady-state cross-rank step skew "
                     f"{steady_frac:.4f} exceeds cohort_skew_threshold "
                     f"{thr:g}: rank {straggler} is pacing the cohort "
                     f"(slowest in {counts[straggler]}/{len(steady)} "
                     f"steady steps)")).to_dict())
    rec = {
        "schema": COHORT_SCHEMA,
        "ranks": list(ranks),
        "steps": common,
        "steady_steps": len(steady),
        "per_step": per_step,
        "per_rank": per_rank,
        "steady_skew_frac": round(steady_frac, 6),
        "straggler_rank": straggler,
        "threshold": thr,
        "findings": findings,
    }
    metrics_registry().gauge("cohort.steady_skew_frac").set(steady_frac)
    return rec


# ------------------------------------------------------- cohort attribution
def cohort_attribution(per_rank_attr: Dict,
                       tolerance: Optional[float] = None,
                       ) -> Optional[Dict]:
    """The fleet-level phase table: extend the per-rank
    attribution with a ``rank_skew`` phase while still telescoping.

    The cohort's effective step time is the SLOWEST rank's (a
    barrier-synchronized cohort paces at its straggler). The base table
    is the median rank's (deterministically: measured step closest to
    the cohort median, ties to the lowest rank id), and ``rank_skew`` =
    cohort step minus that rank's step — measured, the barrier tax.
    Because the base table telescopes to ITS measured step within the
    attribution tolerance and the skew row is exact by construction,
    the extended table telescopes to the cohort step at least as
    tightly. None when no rank carries a usable attribution record."""
    from .attribution import ATTRIBUTION_SCHEMA, DEFAULT_TOLERANCE, PHASES

    tol = DEFAULT_TOLERANCE if tolerance is None else float(tolerance)
    usable = {}
    for r, a in (per_rank_attr or {}).items():
        if (isinstance(a, dict) and a.get("phases")
                and isinstance(a.get("measured_step_s"), (int, float))
                and a["measured_step_s"] > 0):
            usable[r] = a
    if not usable:
        return None
    ranks = sorted(usable)
    steps = {r: float(usable[r]["measured_step_s"]) for r in ranks}
    cohort_measured = max(steps.values())
    med = _median(list(steps.values()))
    base_rank = min(ranks, key=lambda r: abs(steps[r] - med))
    base = usable[base_rank]
    order = [n for n in (base.get("phase_order") or list(PHASES))
             if n in base["phases"]]
    table: Dict[str, Dict] = {}
    for name in order:
        row = base["phases"][name]
        table[name] = {"seconds": float(row.get("seconds", 0.0)),
                       "basis": row.get("basis", "modeled")}
    table[COHORT_PHASE] = {
        "seconds": max(0.0, cohort_measured - steps[base_rank]),
        "basis": "measured",
    }
    order = order + [COHORT_PHASE]
    for name in order:
        table[name]["seconds"] = round(table[name]["seconds"], 9)
        table[name]["fraction"] = round(
            table[name]["seconds"] / cohort_measured, 4)
    phase_sum = sum(table[name]["seconds"] for name in order)
    err = abs(phase_sum / cohort_measured - 1.0)
    rec = {
        "schema": ATTRIBUTION_SCHEMA,
        "kind": "cohort",
        "ranks": list(ranks),
        "base_rank": base_rank,
        "measured_step_s": round(cohort_measured, 9),
        "median_step_s": round(med, 9),
        "per_rank_step_s": {str(r): round(steps[r], 9) for r in ranks},
        "phases": table,
        "phase_order": order,
        "reconciliation": {
            "phase_sum_s": round(phase_sum, 9),
            "measured_step_s": round(cohort_measured, 9),
            "error": round(err, 6),
            "tolerance": tol,
            "reconciles": err <= tol,
        },
        "dominant_phase": max(order, key=lambda n: table[n]["seconds"]),
    }
    return rec


# --------------------------------------------------------- metrics roll-up
def merge_metric_snapshots(docs: Sequence[Dict]) -> Dict:
    """Fold per-rank ``MetricsRegistry.to_json`` snapshots into one
    cohort snapshot via the existing merge semantics (counters add,
    gauges last-writer-wins in doc order, histograms pool their
    count/sum/min/max — the reservoir, hence percentiles, does not
    serialize)."""
    reg = MetricsRegistry()
    for doc in docs:
        if isinstance(doc, dict):
            reg.merge(MetricsRegistry.from_json(doc))
    return reg.to_json()


# ------------------------------------------------------- per-rank export
def export_rank_artifacts(ffmodel, out_dir: Optional[str] = None) -> Dict:
    """Write THIS rank's cohort artifacts: the labeled trace export,
    the metrics snapshot, and the ``cohort-rank<r>.json`` manifest
    (rank, process count, the fit's attribution record, the skew
    threshold the worker was configured with). File names carry the
    rank, so N ranks sharing one cohort directory never collide."""
    import torch.distributed as dist

    cfg = ffmodel.config
    d = out_dir or cohort_dir(cfg)
    os.makedirs(d, exist_ok=True)
    if dist.is_available() and dist.is_initialized():
        rank, pc = int(dist.get_rank()), int(dist.get_world_size())
    else:
        rank, pc = 0, 1
    trace_name = f"trace-rank{rank}.json"
    n_events = tracer().export(os.path.join(d, trace_name),
                               label=f"rank{rank}")
    metrics_name = f"metrics-rank{rank}.json"
    _atomic_json(os.path.join(d, metrics_name),
                 metrics_registry().to_json())
    fp = getattr(ffmodel, "fit_profile", None) or {}
    manifest = {
        "schema": COHORT_SCHEMA,
        "rank": rank,
        "process_count": pc,
        "ts_unix_s": time.time(),
        "trace": trace_name,
        "trace_events": n_events,
        "metrics": metrics_name,
        "attribution": fp.get("attribution"),
        "skew_threshold": float(
            getattr(cfg, "cohort_skew_threshold", DEFAULT_SKEW_THRESHOLD)
            or DEFAULT_SKEW_THRESHOLD),
    }
    _atomic_json(os.path.join(d, f"cohort-rank{rank}.json"), manifest)
    metrics_registry().counter("cohort.exports").inc()
    return manifest


def maybe_export_cohort(ffmodel) -> None:
    """fit()'s tail hook: under ``cohort_obs=on`` export this rank's
    artifacts and note the export on the fit profile. Off = one mode
    check, nothing else."""
    if cohort_obs_mode(ffmodel.config) == "off":
        return
    manifest = export_rank_artifacts(ffmodel)
    fp = getattr(ffmodel, "fit_profile", None)
    if fp is not None:
        fp["cohort_export"] = {
            "dir": cohort_dir(ffmodel.config),
            "rank": manifest["rank"],
            "trace": manifest["trace"],
            "metrics": manifest["metrics"],
        }


# ----------------------------------------------------- ledger annotation
def skew_summary(report: Dict) -> Optional[Dict]:
    """The compact per-record skew block stamped onto merged cohort fit
    records: straggler verdict, steady-state fraction, per-rank step
    spread, OBS003 findings. None when the report carries no skew (a
    single-rank cohort has nothing to skew)."""
    skew = report.get("skew")
    if not isinstance(skew, dict):
        return None
    return {
        "schema": COHORT_SCHEMA,
        "ranks": list(skew.get("ranks") or []),
        "straggler_rank": skew.get("straggler_rank"),
        "steady_skew_frac": skew.get("steady_skew_frac"),
        "threshold": skew.get("threshold"),
        "per_rank_mean_step_s": {
            r: row.get("mean_step_s")
            for r, row in (skew.get("per_rank") or {}).items()},
        "findings": list(skew.get("findings") or []),
    }


def annotate_ledger_with_skew(ledger_dirpath: str, report: Dict) -> int:
    """Stamp the cohort skew block onto every multi-rank ``fit`` record
    in a MERGED cohort ledger directory; returns the count annotated.

    The per-rank processes cannot know the cross-rank skew at record
    time (it only exists once the supervisor aligns all ranks' traces),
    so the supervisor back-fills it here — onto the cohort directory its
    own ``merge_runs`` built, a derived artifact with no live appender
    (the ledger's append-only constraint protects live per-process
    files, which stay untouched)."""
    summary = skew_summary(report)
    if summary is None or not os.path.isdir(ledger_dirpath):
        return 0
    annotated = 0
    for fn in sorted(os.listdir(ledger_dirpath)):
        if not fn.endswith(".jsonl"):
            continue
        path = os.path.join(ledger_dirpath, fn)
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        out_lines: List[str] = []
        changed = False
        for line in lines:
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                out_lines.append(line)  # corrupt lines pass through
                continue
            if (isinstance(doc, dict) and doc.get("kind") == "fit"
                    and "cohort" not in doc
                    and ((doc.get("knobs") or {}).get("process_count")
                         or 1) > 1):
                doc["cohort"] = dict(summary)
                annotated += 1
                changed = True
                out_lines.append(json.dumps(doc, sort_keys=True,
                                            default=str))
            else:
                out_lines.append(line)
        if changed:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write("\n".join(out_lines) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
    return annotated


# ------------------------------------------------------ fleet-level report
def build_cohort_report(dirpath: Optional[str] = None,
                        threshold: Optional[float] = None,
                        write_merged: bool = True) -> Dict:
    """Fold a directory of per-rank artifacts into ONE cohort report:
    merged trace (written back as ``trace-cohort.json``), validation
    verdict, skew table + straggler + OBS003 findings, cohort
    attribution, and the metrics roll-up. The report publishes to the
    obs server's ``/cohort`` slot. ``threshold`` falls back to the
    threshold rank 0's manifest was configured with."""
    d = dirpath or cohort_dir()
    manifests: List[Dict] = []
    corrupt = 0
    skipped_schema = 0
    for fn in (sorted(os.listdir(d)) if os.path.isdir(d) else []):
        if not _MANIFEST_RE.match(fn):
            continue
        doc = _read_json(os.path.join(d, fn))
        if doc is None:
            corrupt += 1
            continue
        if doc.get("schema") != COHORT_SCHEMA:
            # a future layout demotes to a counted skip, never a
            # silent misread (the serializer-version contract)
            skipped_schema += 1
            continue
        manifests.append(doc)
    report: Dict = {"schema": COHORT_SCHEMA, "dir": d,
                    "corrupt_manifests": corrupt,
                    "skipped_schema": skipped_schema}
    if not manifests:
        report.update({"ranks": [],
                       "error": f"no cohort-rank*.json manifests under "
                                f"{d} (run with cohort_obs=on)"})
        return report
    manifests.sort(key=lambda m: int(m.get("rank", 0)))
    ranks = [int(m["rank"]) for m in manifests]
    report["ranks"] = ranks
    thr = threshold if threshold is not None \
        else manifests[0].get("skew_threshold")

    # --- trace unification -----------------------------------------
    trace_paths = []
    payload_by_rank: Dict[int, Dict] = {}
    for m in manifests:
        p = os.path.join(d, m.get("trace") or "")
        doc = _read_json(p) if m.get("trace") else None
        if doc is not None:
            trace_paths.append(p)
            payload_by_rank[int(m["rank"])] = doc
    merged_path = None
    problems: List[str] = []
    if trace_paths:
        merged_path = os.path.join(d, "trace-cohort.json") \
            if write_merged else None
        merged = merge_traces(trace_paths, out=merged_path)
        problems = validate_chrome_trace(merged)
        report["lanes"] = sorted(
            {ev.get("pid") for ev in merged["traceEvents"]})
        report["anchor_drift_s"] = {
            lane: row["drift_s"]
            for lane, row in merged["metadata"]["ranks"].items()}
    report["merged_trace"] = merged_path
    report["merged_trace_valid"] = bool(trace_paths) and not problems
    report["merged_trace_problems"] = problems

    # --- skew attribution ------------------------------------------
    skew = step_skew(
        {r: rank_step_times(p) for r, p in payload_by_rank.items()},
        threshold=thr)
    report["skew"] = skew
    report["straggler_rank"] = (skew or {}).get("straggler_rank")
    report["steady_skew_frac"] = (skew or {}).get("steady_skew_frac")
    report["findings"] = list((skew or {}).get("findings") or [])

    # --- cohort attribution + metrics roll-up ----------------------
    report["attribution"] = cohort_attribution(
        {int(m["rank"]): m.get("attribution") for m in manifests})
    report["metrics"] = merge_metric_snapshots(
        [_read_json(os.path.join(d, m["metrics"])) or {}
         for m in manifests if m.get("metrics")])
    try:
        from .server import publish_cohort

        publish_cohort(report)
    except Exception:  # noqa: BLE001 — publishing never breaks the build
        pass
    return report


__all__ = [
    "COHORT_PHASE", "COHORT_SCHEMA", "DEFAULT_SKEW_THRESHOLD",
    "annotate_ledger_with_skew", "build_cohort_report",
    "cohort_attribution", "cohort_dir", "cohort_obs_mode",
    "export_rank_artifacts", "maybe_export_cohort",
    "merge_metric_snapshots", "merge_traces", "rank_step_times",
    "skew_summary", "step_skew",
]
