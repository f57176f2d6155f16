"""Run ledger: durable, append-only, per-run telemetry records.

PyTorch counterpart of ``flexflow_tpu/obs/ledger.py``, with its schema
(:data:`LEDGER_SCHEMA`), its directory (``.ffcache/obs/runs``, moved by
``config.ledger_dir`` or ``FLEXFLOW_TPU_LEDGER_DIR``) and its record
builders. Every ``compile()``, ``fit()``/``eval()``, serving session and
bench run appends one JSON line: machine fingerprint, config knobs,
search/cache outcome, epoch throughput, divergence, attribution, advice,
serving percentiles and the metrics snapshot.

* **append-only JSONL, one file per process**: no file is rewritten, and
  a line torn by a crash costs that line only (:func:`scan_ledger` skips
  and counts it);
* **never throws into the workload**: :func:`record_run` counts failures
  on ``ledger.errors``;
* **schema-versioned**: readers filter on ``schema``.

The departure from the JAX package: :func:`machine_fingerprint` reads
``torch.cuda`` (card name, count, capability), the power limit where
``nvidia-smi`` is present, the torch and CUDA versions and the world size
instead of ``jax.devices()``; ``backend`` is ``"cuda"`` or ``"cpu"``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional

from .metrics import metrics_registry

LEDGER_SCHEMA = 1
DEFAULT_DIR = os.path.join(".ffcache", "obs", "runs")

_mu = threading.Lock()  # guards _LAST_RECORD + _FINGERPRINT + appends
_LAST_RECORD: Optional[Dict] = None
_FINGERPRINT: Optional[Dict] = None


def ledger_mode(config) -> str:
    """The validated ``config.ledger`` mode — a typo raises at the call
    site (compile/fit entry), the mode-knob convention every obs gate
    follows."""
    mode = getattr(config, "ledger", "on") or "on"
    if mode not in ("on", "off"):
        raise ValueError(f"ledger={mode!r}: expected 'on' or 'off'")
    return mode


def ledger_dir(config=None) -> str:
    """Resolution order: explicit config knob > env override > default
    (cwd-relative ``.ffcache/obs/runs``, next to the strategy cache)."""
    d = getattr(config, "ledger_dir", None) if config is not None else None
    return d or os.environ.get("FLEXFLOW_TPU_LEDGER_DIR") or DEFAULT_DIR


def machine_fingerprint() -> Dict:
    """The coarse machine identity stamped on every record (the cohort
    discriminator across heterogeneous hosts; the search cache's
    ``machine_signature`` is the fine-grained cost-model view — this one
    must stay cheap and import-light)."""
    global _FINGERPRINT
    with _mu:
        if _FINGERPRINT is not None:
            return dict(_FINGERPRINT)
    import platform

    import torch

    fp = {
        "host": platform.node() or "unknown",
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "devices": torch.cuda.device_count() if torch.cuda.is_available() else 1,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "py": platform.python_version(),
        "world_size": _world_size(),
    }
    if torch.cuda.is_available():
        fp["device_name"] = torch.cuda.get_device_name(0)
        fp["capability"] = "%d.%d" % torch.cuda.get_device_capability(0)
        fp["power_limit"] = _power_limit()
    with _mu:
        _FINGERPRINT = fp
    return dict(fp)


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def _power_limit() -> Optional[str]:
    """The first card's power limit as ``nvidia-smi`` prints it, or None
    without the tool."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


# ------------------------------------------------------------- writing
def record_run(kind: str, record: Dict, config=None) -> Optional[Dict]:
    """Append one ``kind`` record to the ledger; returns the full
    (enveloped) record, or None when the ledger is off or the append
    failed. The envelope (schema/kind/run_id/timestamp/pid/machine)
    always wins over same-named payload keys."""
    try:
        if config is not None and ledger_mode(config) == "off":
            return None
        doc = dict(record)
        doc.update({
            "schema": LEDGER_SCHEMA,
            "kind": kind,
            "run_id": uuid.uuid4().hex,
            "ts_unix_s": round(time.time(), 3),
            "pid": os.getpid(),
            "machine": machine_fingerprint(),
        })
        dest = ledger_dir(config)
        test_id = os.environ.get("PYTEST_CURRENT_TEST")
        if test_id and dest == DEFAULT_DIR:
            # A unit test leaked a record into the SHARED corpus (no
            # ledger-dir override): stamp its provenance so the sentinel
            # can keep it out of perf baselines — a 2-step resume
            # segment's steps_per_s measures the test harness, not the
            # code. Tests that build corpora on purpose pass their own
            # ledger_dir and stay judgeable.
            doc["pytest"] = test_id.split(" ")[0]
        _append(dest, doc)
        metrics_registry().counter("ledger.records").inc()
        return doc
    except ValueError:
        raise  # a typo'd mode knob must fail loudly, not count as an error
    except Exception as e:  # noqa: BLE001 — telemetry never kills a run
        metrics_registry().counter("ledger.errors").inc()
        import sys

        print(f"[ledger] append failed: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return None


def _append(dirpath: str, doc: Dict, track_last: bool = True) -> None:
    path = os.path.join(dirpath, f"runs-{os.getpid()}.jsonl")
    line = json.dumps(doc, sort_keys=True, default=str)
    # transient append failures (full-ish disk clearing, NFS blips) back
    # off through the shared retry policy; the lock is taken INSIDE the
    # retried fn, so the backoff sleep never runs under it (CCY003). A
    # final failure re-raises into record_run's counted catch.
    from ..runtime.retry import RetryPolicy

    RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.1,
                retry_on=(OSError,), label="ledger").call(
        _locked_append, dirpath, path, line, doc, track_last)


def _locked_append(dirpath: str, path: str, line: str, doc: Dict,
                   track_last: bool) -> None:
    global _LAST_RECORD
    os.makedirs(dirpath, exist_ok=True)
    with _mu:
        with open(path, "a") as f:
            f.write(line + "\n")
        if track_last:
            _LAST_RECORD = doc


def last_record() -> Optional[Dict]:
    """The most recent record THIS process appended (the watchdog's
    black-box dump includes it — the last known-good telemetry before a
    stall)."""
    with _mu:
        return dict(_LAST_RECORD) if _LAST_RECORD is not None else None


# ------------------------------------------------------------- reading
def scan_ledger(dirpath: Optional[str] = None) -> Dict:
    """Read every ``*.jsonl`` under the ledger dir. Corrupt lines
    (crash-truncated appends, foreign garbage) are SKIPPED and counted —
    one bad line never poisons the corpus — and so are records whose
    ``schema`` VALUE is not this reader's ``LEDGER_SCHEMA``. Returns
    ``{"runs": [...], "files": n, "corrupt_lines": n,
    "foreign_schema": n}`` with runs in ascending ``ts_unix_s``
    order."""
    dirpath = dirpath or ledger_dir()
    runs: List[Dict] = []
    files = corrupt = foreign = 0
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        names = []
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        files += 1
        try:
            with open(os.path.join(dirpath, name), errors="replace") as f:
                lines = f.read().splitlines()
        except OSError:
            corrupt += 1
            continue
        for line in lines:
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
                if not isinstance(doc, dict) or "schema" not in doc:
                    raise ValueError("not a ledger record")
            except ValueError:
                corrupt += 1
                continue
            if doc["schema"] != LEDGER_SCHEMA:
                # a record from a FUTURE (or foreign) layout: counted
                # and skipped, never half-parsed into the corpus —
                # presence of the key alone proved nothing
                foreign += 1
                continue
            runs.append(doc)
    # stable sort on the (rounded) timestamp only: records appended
    # within the same millisecond keep their file/line order — which IS
    # append order within a process file — instead of shuffling on a
    # random run_id tie-break
    runs.sort(key=lambda r: r.get("ts_unix_s") or 0)
    return {"runs": runs, "files": files, "corrupt_lines": corrupt,
            "foreign_schema": foreign}


def load_runs(dirpath: Optional[str] = None, kind: Optional[str] = None,
              since_unix_s: Optional[float] = None, **match) -> List[Dict]:
    """The filtered corpus: records of one ``kind`` (optional), newer
    than ``since_unix_s`` (optional), with every ``match`` key equal
    (e.g. ``model_sig=...``)."""
    runs = scan_ledger(dirpath)["runs"]
    if kind is not None:
        runs = [r for r in runs if r.get("kind") == kind]
    if since_unix_s is not None:
        runs = [r for r in runs if (r.get("ts_unix_s") or 0) >= since_unix_s]
    return filter_runs(runs, **match)


def filter_runs(runs: List[Dict], **match) -> List[Dict]:
    return [r for r in runs
            if all(r.get(k) == v for k, v in match.items())]


def merge_runs(src_dir: str, dst_dir: str) -> int:
    """Fold another ledger directory's records into ``dst_dir`` (e.g.
    pulling worker-host ledgers onto the coordinator), de-duplicated by
    ``run_id``; returns the number of records appended."""
    have = {r.get("run_id") for r in scan_ledger(dst_dir)["runs"]}
    fresh = [r for r in scan_ledger(src_dir)["runs"]
             if r.get("run_id") not in have]
    for doc in fresh:
        # merged records are FOREIGN: they must not become this
        # process's last_record() (the watchdog's black box would then
        # report another machine's run as our final transmission)
        _append(dst_dir, doc, track_last=False)
    return len(fresh)


def cohort_key(rec: Dict) -> str:
    """The (model, mesh, knobs) cohort a record belongs to —
    a regression sentinel only ever compares runs within one cohort
    (cross-model or cross-mesh ratios would be meaningless)."""
    perf = rec.get("perf") or {}
    return json.dumps([
        rec.get("kind"),
        perf.get("metric"),
        rec.get("label") or rec.get("model_sig"),
        sorted((rec.get("mesh") or {}).items()),
        sorted((rec.get("knobs") or {}).items()),
        (rec.get("machine") or {}).get("backend"),
        # records stamped under a different knob-field coverage carry
        # knob blocks that describe different things — never comparable
        # (pre-coverage records group under None, also their own cohort)
        rec.get("knobs_cover"),
    ], sort_keys=True, default=str)


# ----------------------------------------------- FFModel record builders
_KNOB_FIELDS = ("batch_size", "compute_dtype", "prefetch_depth",
                "steps_per_dispatch", "max_inflight_steps",
                "grad_accum_steps", "zero_optimizer", "pipeline_schedule",
                "pipeline_interleave", "search_cache", "perform_fusion",
                # remat trades compute for memory in every pipelined
                # step; interval checkpointing inserts periodic save
                # pauses into the step-time distribution
                "pipeline_remat", "checkpoint_interval_steps")

# the serving-session cohort dimensions: the config-requested batching
# envelope. The scheduler's extra block additionally carries RESOLVED
# values (auto-sized num_blocks, derived max_length) which win on merge
# in record_serving — these are the fallback for engine-only sessions
_SERVING_KNOB_FIELDS = ("serving_decode_slots", "serving_block_size",
                        "serving_num_blocks", "serving_max_length",
                        "serving_prefill_buckets",
                        "serving_max_prefills_per_step",
                        "serving_prefill_token_budget",
                        "serving_draft_model", "serving_spec_k",
                        "serving_kv_dtype",
                        "serving_kv_divergence_budget")


def knob_coverage_version() -> str:
    """8-hex digest over the sorted union of every cohort knob-field
    tuple — stamped on records as ``knobs_cover`` and keyed by
    :func:`cohort_key`, so WIDENING the coverage (a new `_KNOB_FIELDS`
    entry) splits cohorts cleanly instead of comparing records whose
    knob blocks describe different things. The knob-flow auditor
    (the JAX package's ``knobflow_check.cohort_cover_hash``) derives
    the same value from the AST."""
    import hashlib as _h

    fields = sorted(set(_KNOB_FIELDS) | set(_SERVING_KNOB_FIELDS))
    return _h.sha256(",".join(fields).encode()).hexdigest()[:8]


def serving_knob_context(config) -> Dict:
    """Config-requested serving knobs for the serving cohort block."""
    return {k: getattr(config, k, None) for k in _SERVING_KNOB_FIELDS}


def model_context(ff) -> Dict:
    """The cohort-defining context of a compiled FFModel: a stable model
    signature (op types + shapes — invariant to the process-global layer
    name counters), mesh axes, and the perf-relevant config knobs."""
    import hashlib

    cm = ff.compiled
    ctx: Dict = {"knobs": {k: getattr(ff.config, k, None)
                           for k in _KNOB_FIELDS},
                 "knobs_cover": knob_coverage_version()}
    if _world_size() > 1:
        # multi-process cohorts are their own sentinel cohort
        ctx["knobs"]["process_count"] = _world_size()
    if cm is None:
        return ctx
    sig = [(op.op_type.value,
            tuple(tuple(t.dims) for t in op.layer.outputs))
           for op in cm.ops]
    ctx["model_sig"] = hashlib.sha256(
        json.dumps(sig, default=str).encode()).hexdigest()[:12]
    ctx["n_ops"] = len(cm.ops)
    from ..core.machine import mesh_axis_sizes

    if cm.mesh is not None:
        ctx["mesh"] = dict(mesh_axis_sizes(cm.mesh))
    if ff.pipelined is not None:
        # the RESOLVED pipeline envelope, not the requested knobs: an
        # "auto" schedule resolves here, and the engine family plus the
        # stage-submesh shape are cohort dimensions — a new-envelope run
        # (compiled interleaved, pipe×data submesh) must never be
        # sentinel-judged against an old-envelope baseline that executed
        # a different engine on the same mesh
        pm = ff.pipelined
        ctx["knobs"]["pipeline_schedule"] = pm.cfg.schedule
        ctx["knobs"]["pipeline_interleave"] = pm.cfg.interleave
        ctx["knobs"]["pipeline_engine"] = pm.engine_name
        ctx["knobs"]["pipeline_submesh"] = json.dumps(
            sorted((a, s) for a, s in mesh_axis_sizes(pm.mesh).items()
                   if a != pm.cfg.axis and s > 1))
    if getattr(ff.config, "seq_buckets", "off") not in (None, "off"):
        # the RESOLVED dynamic-shape envelope (the pipeline-envelope
        # pattern): a bucketed run dispatches per-(rows, rung)
        # executables over packed batches — a different throughput
        # regime — so the resolved ladder and token budget key its
        # cohort apart; static-shape records stay knob-free and their
        # baselines untouched
        ladder = getattr(ff, "_resolved_ladder", None)
        ctx["knobs"]["seq_bucket_ladder"] = json.dumps(
            list(ladder) if ladder
            else [getattr(ff.config, "seq_buckets", None)])
        ctx["knobs"]["token_budget"] = getattr(
            ff, "_resolved_token_budget",
            getattr(ff.config, "token_budget", 0))
        pad_max = getattr(ff.config, "seq_bucket_pad_max", "off")
        if pad_max != "off":
            ctx["knobs"]["seq_bucket_pad_max"] = pad_max
    return ctx


def _scalars(doc: Optional[Dict]) -> Dict:
    """JSON-scalar subset of a profile dict (drops bulky nested blocks
    a ledger line does not need twice)."""
    return {k: v for k, v in (doc or {}).items()
            if isinstance(v, (int, float, str, bool)) or v is None}


def record_compile(ff, wall_s: float) -> Optional[Dict]:
    """The per-compile record: search/cache outcome, audit summary, and
    the executable telemetry block (flops/bytes/peak memory per program,
    or its explicit ``unavailable`` reason)."""
    try:
        if ledger_mode(ff.config) == "off":
            return None
        rec = model_context(ff)
        rec["wall_s"] = round(wall_s, 6)
        sp = getattr(ff, "search_profile", None)
        if sp:
            rec["search"] = _scalars(sp)
        ap = getattr(ff, "audit_profile", None)
        if ap:
            rec["audit"] = {
                "programs": sorted((ap.get("programs") or {})),
                "walk_s": ap.get("walk_s"),
                "record_s": ap.get("record_s"),
                "errors": len(ff.audit_report.errors)
                if getattr(ff, "audit_report", None) else 0,
                "warnings": len(ff.audit_report.warnings)
                if getattr(ff, "audit_report", None) else 0,
            }
        rec["exec"] = (getattr(ff, "exec_telemetry", None)
                       or {"unavailable": "exec_telemetry=off"})
        return record_run("compile", rec, config=ff.config)
    except ValueError:
        raise
    except Exception:  # noqa: BLE001 — telemetry never kills a compile
        metrics_registry().counter("ledger.errors").inc()
        return None


def _watchdog_block() -> Dict:
    from .watchdog import watchdog

    return watchdog().stats()


def _faults_block() -> Optional[Dict]:
    """The armed fault plan's evaluation/fire counts, or None on a clean
    run. Its PRESENCE on a record marks the run chaotic —
    a regression sentinel cohort-excludes such records so injected
    faults never pollute perf baselines."""
    try:
        from ..runtime.faults import faults_block

        return faults_block()
    except Exception:  # noqa: BLE001 — telemetry never kills a run
        return None


def _divergence_for_ledger(div: Dict, config) -> Dict:
    """The divergence block as the ledger stores it: per-op rows capped
    at the top-``config.ledger_per_op_topk`` by measured time, with the
    truncation COUNTED on the record (``per_op_total`` /
    ``per_op_truncated``) and on the ``ledger.per_op_truncated``
    counter — a capped record must never read as full coverage."""
    rows = div.get("per_op")
    if not rows:
        return div
    out = dict(div)
    raw = getattr(config, "ledger_per_op_topk", 16)
    k = 16 if raw is None else int(raw)
    out["per_op_total"] = len(rows)
    if k <= 0:
        # explicit 0: keep NO per-op rows on the record (record-size
        # control on huge graphs) — still counted, never silent
        out.pop("per_op", None)
        out["per_op_truncated"] = len(rows)
        metrics_registry().counter("ledger.per_op_truncated").inc(
            len(rows))
        return out
    if len(rows) <= k:
        out["per_op_truncated"] = 0
        return out
    ranked = sorted(rows, key=lambda r: (-(r.get("measured_ms") or 0.0),
                                         r.get("name") or ""))
    out["per_op"] = ranked[:k]
    out["per_op_truncated"] = len(rows) - k
    metrics_registry().counter("ledger.per_op_truncated").inc(
        len(rows) - k)
    return out


def record_fit(ff, kind: str = "fit") -> Optional[Dict]:
    """The per-fit (or per-eval) record: epoch throughput, divergence
    block (per-op rows top-k capped, truncation counted), attribution
    report, watchdog state, and the full metrics snapshot — the
    divergence flywheel's training rows."""
    try:
        if ledger_mode(ff.config) == "off":
            return None
        rec = model_context(ff)
        prof = getattr(ff, "fit_profile" if kind == "fit"
                       else "eval_profile", None) or {}
        rec["throughput"] = {
            **_scalars(prof),
            "epochs": [dict(e) for e in prof.get("epochs") or []],
        }
        if prof.get("buckets"):
            # dynamic-shape envelope: _scalars drops nested dicts, so
            # the bucket block (ladder, padded-token fraction, counted
            # recompile misses) is copied onto the record explicitly —
            # the advisor's token-bucketing rule reads it from here
            rec["buckets"] = dict(prof["buckets"])
        if prof.get("divergence"):
            rec["divergence"] = _divergence_for_ledger(
                prof["divergence"], ff.config)
        if prof.get("attribution"):
            rec["attribution"] = prof["attribution"]
        if prof.get("advice"):
            # the advisor's ranked knob deltas ride the record so
            # explain_run/sentinel can narrate WHAT to change, not just
            # how much slower the run got
            rec["advice"] = prof["advice"]
        if prof.get("cost_corpus"):
            rec["cost_corpus"] = prof["cost_corpus"]
        if prof.get("pipeline"):
            rec["pipeline"] = _scalars(prof["pipeline"])
        if prof.get("steps_per_s"):
            rec["perf"] = {"metric": f"{kind}.steps_per_s",
                           "value": prof["steps_per_s"],
                           "higher_is_better": True}
        if prof.get("guard"):
            # TrainingGuard recovery narrative (restores, backoffs,
            # snapshot cadence) — explain_run narrates it
            rec["guard"] = prof["guard"]
        if ff.compiled is not None:
            rec["resume"] = ff.compiled.resume_state()
        fb = _faults_block()
        if fb:
            rec["faults"] = fb
        rec["watchdog"] = _watchdog_block()
        rec["metrics"] = metrics_registry().to_json()
        return record_run(kind, rec, config=ff.config)
    except ValueError:
        raise
    except Exception:  # noqa: BLE001 — telemetry never kills a fit
        metrics_registry().counter("ledger.errors").inc()
        return None


def record_serving(extra: Optional[Dict] = None,
                   config=None) -> Optional[Dict]:
    """One record per serving session (engine ``stop()``). The counter
    and percentile values are snapshots of the PROCESS-CUMULATIVE
    ``serving.*`` registry series (the registry is process-wide, not
    per-engine) — ``scope`` says so explicitly; per-session deltas are
    the difference between consecutive records of one pid."""
    try:
        reg = metrics_registry()
        rec: Dict = {"counters": {}, "scope": "process_cumulative"}
        for name in ("serving.requests", "serving.batches",
                     "serving.errors"):
            m = reg.get(name)
            if m is not None:
                rec["counters"][name] = m.to_json()
        for name in ("serving.queue_wait_s", "serving.e2e_s",
                     "serving.infer_s", "serving.batch_size",
                     # continuous-batching generation series (process-
                     # cumulative like the rest; the per-SESSION phase
                     # percentiles ride in the scheduler's extra block)
                     "serving.gen_queue_wait_s", "serving.prefill_s",
                     "serving.decode_step_s", "serving.ttft_s",
                     "serving.per_token_s", "serving.gen_e2e_s",
                     # speculative-decoding acceptance series (empty
                     # when speculation is off — reg.get returns None)
                     "serving.spec_accept_rate",
                     "serving.spec_tokens_per_dispatch"):
            m = reg.get(name)
            if m is not None:
                rec[name] = m.to_json()
        if extra:
            rec.update(extra)
        if config is not None:
            # serving cohort knobs: the config-requested ``serving_*``
            # values, unioned with any block the scheduler's extra
            # already carries (its RESOLVED short-name values — auto-
            # sized num_blocks, derived max_length — ride alongside)
            knobs = serving_knob_context(config)
            knobs.update(rec.get("knobs") or {})
            rec["knobs"] = knobs
            rec.setdefault("knobs_cover", knob_coverage_version())
        fb = _faults_block()
        if fb:
            rec["faults"] = fb
        rec["watchdog"] = _watchdog_block()
        if not rec["counters"]:
            return None  # nothing served — no record
        return record_run("serving", rec, config=config)
    except Exception:  # noqa: BLE001 — telemetry never kills shutdown
        metrics_registry().counter("ledger.errors").inc()
        return None


def record_bench(tool: str, result: Dict, perf: Optional[Dict] = None,
                 label: Optional[str] = None, knobs: Optional[Dict] = None,
                 config=None) -> Optional[Dict]:
    """One record per bench-tool run, so BENCH_*.json trend lines
    survive in-repo; ``perf`` is the sentinel's comparison handle
    (``{"metric", "value", "higher_is_better"}``)."""
    try:
        rec: Dict = {"tool": tool, "result": result}
        if label:
            rec["label"] = label
        if knobs:
            rec["knobs"] = dict(knobs)
        if perf:
            rec["perf"] = dict(perf)
        return record_run("bench", rec, config=config)
    except Exception:  # noqa: BLE001
        metrics_registry().counter("ledger.errors").inc()
        return None


__all__ = [
    "LEDGER_SCHEMA", "cohort_key", "filter_runs", "knob_coverage_version",
    "last_record", "ledger_dir", "ledger_mode", "load_runs",
    "machine_fingerprint", "merge_runs", "model_context", "record_bench",
    "record_compile", "record_fit", "record_run", "record_serving",
    "scan_ledger", "serving_knob_context",
]
