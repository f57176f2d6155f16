"""Perf advisor: dominant-phase verdicts mapped to concrete knob deltas.

PyTorch counterpart of ``flexflow_tpu/obs/advisor.py``, the same rule
table, record schema and ranking. It reads a run's attribution (or a
serving session's phase record) and maps the dominant phase to ranked
knob changes:

=====================  ==================================================
dominant phase         suggestion family (knob deltas)
=====================  ==================================================
``input_wait``         ``prefetch`` (``prefetch_depth``)
``host_dispatch``      ``multi_step_dispatch`` (``steps_per_dispatch``)
                       or ``compiled_pipeline`` (single-call engine)
``pipeline_bubble``    ``schedule`` or ``microbatches``
``collective_transfer`` ``mesh_reshape`` (the simulator's ring factor)
``optimizer_fold``     ``optimizer_sharding`` (``zero_optimizer``)
``device_compute``     ``precision`` / ``fusion`` / ``token_bucketing``
``rank_skew``          ``elastic_shrink`` / ``multi_step_dispatch``
``queue_wait``         serving: ``decode_slots`` / ``kv_pool``
``prefill``            serving: ``prefill_interleave``
``decode``             serving: ``block_size`` / ``speculation``
=====================  ==================================================

Every suggestion carries an ``expected`` block (the phase's predicted
delta in seconds and as a share of the step, with its pricing source), so
:func:`judge_experiment` can accept or reject it from measured pairs.
``config.advisor`` is ``"on"`` (default) or ``"off"``; the fit tail
attaches the report to ``fit_profile["advice"]`` and publishes it on the
obs server's ``/advice``.

In the port ``train_k_steps`` is a loop of eager steps, so the
``multi_step_dispatch`` delta is the rule's prediction, not a measured
property of the port: the card judges it.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .attribution import SERVING_PHASES
from .metrics import metrics_registry

ADVISOR_SCHEMA = 1
DEFAULT_MAX_SUGGESTIONS = 5

# phase -> suggestion families the rule table may emit (the golden
# tests pin this contract; README renders it)
RULE_FAMILIES: Dict[str, tuple] = {
    "input_wait": ("prefetch",),
    "host_dispatch": ("compiled_pipeline", "multi_step_dispatch"),
    "pipeline_bubble": ("schedule", "microbatches"),
    "collective_transfer": ("mesh_reshape",),
    "optimizer_fold": ("optimizer_sharding",),
    "device_compute": ("precision", "fusion", "token_bucketing"),
    # cohort phase (obs/cohort.py): the barrier tax a straggler rank
    # charges the whole cohort
    "rank_skew": ("elastic_shrink", "multi_step_dispatch"),
    # serving phases (continuous-batching session records)
    "queue_wait": ("decode_slots", "kv_pool"),
    "prefill": ("prefill_interleave",),
    "decode": ("block_size", "speculation"),
}

REQUIRED_SUGGESTION_KEYS = (
    "id", "phase", "family", "knob", "current", "proposed", "knobs",
    "expected", "rationale", "applicable")


def advisor_mode(config) -> str:
    """The validated ``config.advisor`` mode (typo fails loudly at the
    fit tail — the mode-knob convention every obs gate follows)."""
    mode = getattr(config, "advisor", "on") or "on"
    if mode not in ("on", "off"):
        raise ValueError(f"advisor={mode!r}: expected 'on' or 'off'")
    return mode


# ------------------------------------------------------------ suggestions
def _sug(phase: str, family: str, knob: str, current, proposed,
         knobs: Dict, delta_s: float, total_s: float, basis: str,
         priced_by: str, rationale: str, applicable: bool = True) -> Dict:
    delta_s = max(0.0, float(delta_s))
    frac = (delta_s / total_s) if total_s and total_s > 0 else 0.0
    return {
        "id": f"{knob}={json.dumps(proposed, sort_keys=True, default=str)}",
        "phase": phase,
        "family": family,
        "knob": knob,
        "current": current,
        "proposed": proposed,
        "knobs": dict(knobs),
        "expected": {
            "phase": phase,
            "phase_delta_s": round(delta_s, 9),
            "step_delta_frac": round(frac, 4),
            "basis": basis,
            "priced_by": priced_by,
        },
        "rationale": rationale,
        # True = the delta is expressible as config/scheduler knobs in
        # principle; an experiment harness re-validates it before applying it
        "applicable": bool(applicable),
    }


def _phase_seconds(attr: Dict) -> Dict[str, float]:
    out = {}
    for name, row in (attr.get("phases") or {}).items():
        sec = (row or {}).get("seconds")
        if isinstance(sec, (int, float)):
            out[name] = float(sec)
    return out


# ------------------------------------------------------------- fit rules
def _rule_input_wait(s: float, total: float, knobs: Dict) -> List[Dict]:
    depth = int(knobs.get("prefetch_depth") or 0)
    if depth <= 0:
        return [_sug(
            "input_wait", "prefetch", "prefetch_depth", depth, 2,
            {"prefetch_depth": 2}, s, total, "measured",
            "epoch_throughput.input_wait_s",
            "the step loop measurably waits on host batch assembly; a "
            "depth-2 Prefetcher overlaps assembly with device compute "
            "(bit-identical batch order)")]
    if depth < 8:
        return [_sug(
            "input_wait", "prefetch", "prefetch_depth", depth, depth * 2,
            {"prefetch_depth": depth * 2}, 0.5 * s, total, "modeled",
            "epoch_throughput.input_wait_s",
            f"input wait persists at depth {depth}; deepening the queue "
            f"absorbs burstier assembly times")]
    return []


def _rule_host_dispatch(s: float, total: float, knobs: Dict,
                        pipe: Dict) -> List[Dict]:
    out: List[Dict] = []
    if pipe:
        disp = int(pipe.get("dispatches_per_step") or 1)
        if (pipe.get("engine") == "host"
                and pipe.get("compiled_mesh_eligible")
                and not pipe.get("fallback_reason") and disp > 1):
            out.append(_sug(
                "host_dispatch", "compiled_pipeline", "pipeline_engine",
                "host", "compiled", {"pipeline_engine": "compiled"},
                s * (1.0 - 1.0 / disp), total, "modeled",
                "sim.pipeline_schedule_cost(engine='compiled')",
                f"the host engine pays {disp} dispatches/step on a mesh "
                f"the single-dispatch compiled engine covers; compiling "
                f"the whole schedule collapses that to 1"))
        return out
    k = int(knobs.get("steps_per_dispatch") or 1)
    k2 = max(2, 2 * k)
    out.append(_sug(
        "host_dispatch", "multi_step_dispatch", "steps_per_dispatch",
        k, k2, {"steps_per_dispatch": k2}, s * (1.0 - k / k2), total,
        "modeled", "machine.chip.step_overhead x dispatches",
        f"per-dispatch host overhead dominates; the train_k_steps "
        f"multi-step executable amortizes it over {k2} steps per "
        f"dispatch (bit-identical trajectories)"))
    return out


def _rule_pipeline_bubble(s: float, total: float, knobs: Dict,
                          pipe: Dict, n_ops: Optional[int]) -> List[Dict]:
    if not pipe:
        return []
    from ..sim.simulator import schedule_bubble_candidates

    S = int(pipe.get("num_stages") or 0)
    M = int(pipe.get("num_microbatches") or 0)
    V = int(pipe.get("interleave") or 1)
    cur_kind = pipe.get("schedule")
    cur_bubble = float(pipe.get("bubble_fraction") or 0.0)
    if S < 2 or M < 1 or cur_bubble <= 0.0:
        return []
    out: List[Dict] = []
    for cand in schedule_bubble_candidates(
            cur_kind, V, S, M, n_ops=n_ops or 2 * S * max(2, V)):
        b = cand["bubble_fraction"]
        if b >= cur_bubble:
            continue
        gain = s * (1.0 - b / cur_bubble)
        if cand.get("num_microbatches", M) != M:
            ga = int(knobs.get("grad_accum_steps") or 1)
            mult = cand["num_microbatches"] // max(1, M)
            out.append(_sug(
                "pipeline_bubble", "microbatches", "grad_accum_steps",
                ga, ga * mult, {"grad_accum_steps": ga * mult}, gain,
                total, "modeled", "sim.schedule_bubble_candidates",
                f"more microbatches shrink the {cur_kind} bubble "
                f"{cur_bubble:.3f} -> {b:.3f}; grad_accum_steps folds "
                f"into the schedule's microbatch count at the same "
                f"averaging"))
        else:
            out.append(_sug(
                "pipeline_bubble", "schedule", "pipeline_schedule",
                cur_kind, cand["schedule"],
                {"pipeline_schedule": cand["schedule"],
                 "pipeline_interleave": cand["interleave"]},
                gain, total, "modeled", "sim.schedule_bubble_candidates",
                f"the {cand['schedule']}"
                f"{'' if cand['interleave'] <= 1 else ' x' + str(cand['interleave'])}"
                f" schedule's predicted bubble {b:.3f} beats the "
                f"current {cur_kind}'s {cur_bubble:.3f}"))
    return out


def _rule_collective(s: float, total: float, mesh: Dict) -> List[Dict]:
    from ..sim.simulator import mesh_reshape_candidates

    out: List[Dict] = []
    for cand in mesh_reshape_candidates(mesh or {})[:2]:
        ratio = cand["allreduce_factor_ratio"]
        out.append(_sug(
            "collective_transfer", "mesh_reshape", "mesh_shape",
            dict(mesh or {}), cand["mesh"], {"mesh_shape": cand["mesh"]},
            s * (1.0 - ratio), total, "modeled",
            "sim.mesh_reshape_candidates(ring all-reduce factor)",
            f"moving degree off the data axis cuts the gradient "
            f"all-reduce's ring factor to {ratio:.3f}x; boundary/"
            f"activation traffic of the new axis is NOT priced here — "
            f"the A/B bench is the verdict"))
    return out


def _rule_optimizer_fold(s: float, total: float, knobs: Dict,
                         mesh: Dict) -> List[Dict]:
    d = int((mesh or {}).get("data") or 1)
    if knobs.get("zero_optimizer") or d <= 1:
        return []
    return [_sug(
        "optimizer_fold", "optimizer_sharding", "zero_optimizer",
        False, True, {"zero_optimizer": True},
        s * (1.0 - 1.0 / d), total, "modeled",
        "attribution fold model (3x weight bytes / HBM bw) over the "
        "data axis",
        f"ZeRO-1 shards the optimizer-state update over the data axis "
        f"(degree {d}); the fold's weight-state traffic drops ~{d}x")]


def _rule_device_compute(s: float, total: float, knobs: Dict) -> List[Dict]:
    out: List[Dict] = []
    dtype = knobs.get("compute_dtype")
    if dtype in (None, "float32"):
        out.append(_sug(
            "device_compute", "precision", "compute_dtype", dtype,
            "bfloat16", {"compute_dtype": "bfloat16"}, 0.3 * s, total,
            "modeled", "tensor-core bf16 matmul throughput (cost model "
            "dtype factor)",
            "activations/matmuls in bf16 with f32 master weights; "
            "numerics change — verify convergence before adopting"))
    if not knobs.get("perform_fusion"):
        out.append(_sug(
            "device_compute", "fusion", "perform_fusion", False, True,
            {"perform_fusion": True}, 0.05 * s, total, "modeled",
            "graph fusion pass (fewer ops for the search/simulator)",
            "fuse chains of weightless unary ops into one op before "
            "search; the expected win is small"))
    return out


def _rule_token_bucketing(s: float, total: float, knobs: Dict,
                          buckets: Dict) -> List[Dict]:
    """Padded-token-heavy bucketed fit: the record's bucket block
    (ledger ``buckets``, from ``fit_profile``) carries the measured
    padded-token fraction, which prices the dead device FLOPs directly
    — every padded position runs the full forward/backward and
    contributes an exact zero."""
    frac = float(buckets.get("padded_token_fraction") or 0.0)
    if frac <= 0.2:
        return []
    ladder = buckets.get("ladder") or []
    top = int(ladder[-1]) if ladder else 0
    pct = round(frac * 100, 1)
    if buckets.get("pad_max"):
        return [_sug(
            "device_compute", "token_bucketing", "seq_bucket_pad_max",
            "on", "off", {"seq_bucket_pad_max": "off"}, s * frac, total,
            "modeled", "padded_flops_fraction",
            f"{pct}% of dispatched tokens are padding at the ladder "
            f"top; dispatching each group at its own rung removes the "
            f"width padding (bit-identical loss trajectory)")]
    if int(buckets.get("token_budget") or 0) <= 0 and top:
        return [_sug(
            "device_compute", "token_bucketing", "token_budget", 0,
            top * 4, {"token_budget": top * 4}, 0.5 * s * frac, total,
            "modeled", "padded_flops_fraction",
            f"{pct}% of dispatched tokens are padding with fixed-row "
            f"batches; packing rows under a {top * 4}-token budget "
            f"fills short-row groups (seed-deterministic plan)")]
    return []


def _rule_rank_skew(s: float, total: float, knobs: Dict,
                    cohort: Dict) -> List[Dict]:
    """Skew-dominant cohort record: the ``rank_skew`` phase (cohort
    attribution) or the record's OBS003-bearing ``cohort`` block names a
    straggler pacing the barrier-synchronized cohort. Both remedies are
    priced ``measured`` — the skew fraction IS a measurement of the
    barrier tax, not a model of it."""
    out: List[Dict] = []
    frac = (s / total) if total > 0 else 0.0
    straggler = cohort.get("straggler_rank")
    who = f"rank {straggler}" if straggler is not None else "one rank"
    n = int(knobs.get("process_count")
            or len(cohort.get("ranks") or []) or 0)
    if n > 1:
        out.append(_sug(
            "rank_skew", "elastic_shrink", "process_count", n, n - 1,
            {"process_count": n - 1}, s, total, "measured",
            "cohort steady_skew_frac (cross-rank fit.step skew)",
            f"{who} paces the cohort — {frac:.1%} of every step is the "
            f"barrier waiting on it; the elastic supervisor can shrink "
            f"the world to {n - 1} processes and resume (topology-keyed "
            f"re-search, checkpoint.elastic_resumes), leaving the "
            f"remaining ranks pacing at their own median"))
    k = int(knobs.get("steps_per_dispatch") or 1)
    k2 = max(2, 2 * k)
    out.append(_sug(
        "rank_skew", "multi_step_dispatch", "steps_per_dispatch", k, k2,
        {"steps_per_dispatch": k2}, 0.5 * s, total, "measured",
        "cohort steady_skew_frac (cross-rank fit.step skew)",
        f"when the straggler's excess is per-dispatch jitter (GC, host "
        f"noise) rather than persistent, dispatching {k2} steps per "
        f"host round-trip halves how often the cohort re-synchronizes "
        f"on {who}"))
    return out


# --------------------------------------------------------- serving rules
def _serving_phase_means(rec: Dict) -> Dict[str, float]:
    out = {}
    for name in SERVING_PHASES:
        block = (rec.get("phases") or {}).get(name) or {}
        mean = block.get("mean")
        if isinstance(mean, (int, float)):
            out[name] = float(mean)
    return out


def _prior_spec_accept_rate(priors) -> Optional[float]:
    """Newest measured acceptance rate from prior serving records that
    ran WITH speculation — the spec_k rule's measured-pricing source."""
    best_ts, best = -1.0, None
    for r in priors or []:
        spec = (r or {}).get("spec") or {}
        rate = spec.get("accept_rate")
        if not isinstance(rate, (int, float)):
            continue
        ts = float(r.get("ts_unix_s") or 0.0)
        if ts >= best_ts:
            best_ts, best = ts, float(rate)
    return best


def _serving_suggestions(rec: Dict, priors=None) -> List[Dict]:
    means = _serving_phase_means(rec)
    if not means:
        return []
    total = sum(means.values())
    knobs = rec.get("knobs") or {}
    slots = int(knobs.get("decode_slots") or 0)
    bsz = int(knobs.get("block_size") or 0)
    mpps = int(knobs.get("max_prefills_per_step") or 1)
    kv = rec.get("kv") or {}
    kv_dtype = str(kv.get("kv_dtype") or knobs.get("kv_dtype")
                   or "float32")
    out: List[Dict] = []
    s = means.get("queue_wait", 0.0)
    if s > 0 and slots:
        out.append(_sug(
            "queue_wait", "decode_slots", "decode_slots", slots,
            slots * 2, {"decode_slots": slots * 2}, 0.5 * s, total,
            "modeled", "serving phase percentiles (queue_wait mean)",
            f"requests wait for a free decode slot; doubling the "
            f"compiled width to {slots * 2} roughly halves the wait at "
            f"this arrival rate (one dispatch/step either way)"))
        hw = kv.get("high_water")
        cap = kv.get("capacity_blocks")
        if (isinstance(hw, (int, float)) and isinstance(cap, (int, float))
                and cap and hw >= cap):
            if kv_dtype == "float32":
                # dtype-aware: int8 arenas free ~half the pool bytes at
                # the SAME memory bill — suggest quantizing before
                # suggesting the pool grow (num_blocks*2 doubles bytes;
                # int8 doubles admission for free, divergence-gated)
                out.append(_sug(
                    "queue_wait", "kv_pool", "serving_kv_dtype",
                    "float32", "int8", {"serving_kv_dtype": "int8"},
                    0.25 * s, total, "modeled",
                    "PagedKVPool high-water vs capacity (dtype-aware)",
                    f"the paged pool hit its capacity ({hw}/{cap} "
                    f"blocks); int8 KV arenas halve pool bytes so the "
                    f"same memory admits ~2x the blocks "
                    f"(serving_kv_divergence_budget gates fidelity)"))
            else:
                nb = int(knobs.get("num_blocks") or cap)
                out.append(_sug(
                    "queue_wait", "kv_pool", "num_blocks", nb, nb * 2,
                    {"num_blocks": nb * 2}, 0.25 * s, total, "modeled",
                    "PagedKVPool high-water vs capacity",
                    f"the paged pool hit its capacity ({hw}/{cap} "
                    f"blocks) with kv_dtype={kv_dtype} already "
                    f"quantized; admission stalls on block "
                    f"reservations, not slots"))
    s = means.get("prefill", 0.0)
    proposed_mpps = min(max(2, mpps * 2), max(slots, 2))
    if s > 0 and slots and proposed_mpps > mpps:
        # (already at the slot-capped bound -> no no-op suggestion)
        out.append(_sug(
            "prefill", "prefill_interleave", "max_prefills_per_step",
            mpps, proposed_mpps,
            {"max_prefills_per_step": proposed_mpps},
            0.3 * s, total, "modeled",
            "serving phase percentiles (prefill mean)",
            f"prompt admission is throttled to {mpps} prefill(s) "
            f"between decode steps; raising the bound drains prompt "
            f"bursts faster (decode stall bound grows with it)"))
    s = means.get("decode", 0.0)
    if s > 0 and bsz:
        out.append(_sug(
            "decode", "block_size", "block_size", bsz, bsz * 2,
            {"block_size": bsz * 2}, 0.15 * s, total, "modeled",
            "paged gather width (blocks per request ~ 1/block_size)",
            f"decode gathers over per-request block tables; doubling "
            f"the block size to {bsz * 2} halves the table length per "
            f"request (coarser pool granularity is the trade)"))
    spec_on = bool(knobs.get("spec_k")) or bool(rec.get("spec"))
    dominant = max(means, key=lambda n: means[n]) if means else None
    if s > 0 and dominant == "decode" and not spec_on:
        # decode-dominant and speculation off: one verify dispatch
        # retires up to k+1 tokens, so decode wall time shrinks by
        # ~(1 - 1/(1 + alpha*k)) at acceptance rate alpha. Price with
        # the MEASURED acceptance when a prior spec record exists;
        # otherwise model a mid-range draft (alpha=0.6).
        k = 4
        alpha = _prior_spec_accept_rate(priors)
        if alpha is not None:
            basis, priced_by = "measured", (
                "prior serving record's spec.accept_rate")
        else:
            alpha, basis, priced_by = 0.6, "modeled", (
                "modeled draft acceptance (no prior spec record)")
        out.append(_sug(
            "decode", "speculation", "serving_spec_k", 0, k,
            {"serving_spec_k": k}, s * (1.0 - 1.0 / (1.0 + alpha * k)),
            total, basis, priced_by,
            f"decode dominates and speculation is off; a draft "
            f"proposing k={k} tokens per slot verified in ONE paged "
            f"dispatch retires ~{1 + alpha * k:.1f} tokens per step "
            f"at acceptance rate {alpha:.2f} (requires "
            f"serving_draft_model)"))
    return out


# -------------------------------------------------------------- reports
def _rank(sugs: List[Dict], k: int) -> List[Dict]:
    """Deterministic ranking: expected step fraction desc, then phase /
    knob / id — two runs over the same record rank identically."""
    sugs = sorted(sugs, key=lambda s: (
        -s["expected"]["step_delta_frac"], s["phase"], s["knob"], s["id"]))
    for i, s in enumerate(sugs):
        s["rank"] = i
    return sugs[:k]


def advise_record(rec: Dict,
                  max_suggestions: int = DEFAULT_MAX_SUGGESTIONS,
                  priors=None) -> Optional[Dict]:
    """Build one advisor report for a ledger record (or an equivalent
    in-process dict). Fit/eval records need an ``attribution`` block,
    serving records a ``phases`` percentile table; anything else (bench
    records, classic serving) returns None — there is no phase verdict
    to act on. ``priors`` (optional list of earlier ledger records)
    upgrades modeled pricing to measured where a prior run measured the
    quantity — e.g. the spec_k rule prices with a prior record's
    ``spec.accept_rate``."""
    kind = rec.get("kind")
    if kind == "serving" or rec.get("serving_engine") == "continuous":
        sugs = _serving_suggestions(rec, priors=priors)
        if not sugs:
            return None
        means = _serving_phase_means(rec)
        dominant = max(means, key=lambda n: means[n]) if means else None
        report = {
            "schema": ADVISOR_SCHEMA,
            "kind": "serving",
            "run_id": rec.get("run_id"),
            "label": rec.get("label") or rec.get("model_sig")
            or rec.get("model"),
            "dominant_phase": dominant,
            "phase_means_s": {n: round(v, 9) for n, v in means.items()},
            "tokens_per_s": rec.get("tokens_per_s"),
            "knobs": rec.get("knobs"),
            "suggestions": _rank(sugs, max_suggestions),
        }
    else:
        attr = rec.get("attribution") or {}
        # schema-gate the block before advising off it: a future
        # attribution layout must demote to "no advice", not be
        # half-read into wrong knob deltas (absent schema = same
        # producer process, pre-envelope publish path — accepted)
        from .attribution import ATTRIBUTION_SCHEMA

        if attr.get("schema", ATTRIBUTION_SCHEMA) != ATTRIBUTION_SCHEMA:
            return None
        secs = _phase_seconds(attr)
        measured = attr.get("measured_step_s")
        if not secs or not isinstance(measured, (int, float)) \
                or measured <= 0:
            return None
        knobs = rec.get("knobs") or {}
        pipe = rec.get("pipeline") or {}
        mesh = rec.get("mesh") or {}
        sugs: List[Dict] = []
        if secs.get("input_wait", 0) > 0:
            sugs += _rule_input_wait(secs["input_wait"], measured, knobs)
        if secs.get("host_dispatch", 0) > 0:
            sugs += _rule_host_dispatch(secs["host_dispatch"], measured,
                                        knobs, pipe)
        if secs.get("pipeline_bubble", 0) > 0:
            sugs += _rule_pipeline_bubble(secs["pipeline_bubble"],
                                          measured, knobs, pipe,
                                          rec.get("n_ops"))
        if secs.get("collective_transfer", 0) > 0:
            sugs += _rule_collective(secs["collective_transfer"],
                                     measured, mesh)
        if secs.get("optimizer_fold", 0) > 0:
            sugs += _rule_optimizer_fold(secs["optimizer_fold"], measured,
                                         knobs, mesh)
        if secs.get("device_compute", 0) > 0:
            sugs += _rule_device_compute(secs["device_compute"], measured,
                                         knobs)
            if rec.get("buckets"):
                sugs += _rule_token_bucketing(secs["device_compute"],
                                              measured, knobs,
                                              rec["buckets"])
        # cohort skew: triggered by the rank_skew phase (a cohort
        # attribution table) OR by an OBS003-bearing cohort block the
        # supervisor annotated onto a merged multi-rank fit record
        cohort_blk = rec.get("cohort") or {}
        obs003 = any((f or {}).get("code") == "OBS003"
                     for f in (cohort_blk.get("findings") or []))
        skew_s = secs.get("rank_skew", 0.0)
        if skew_s <= 0 and obs003:
            skew_s = float(cohort_blk.get("steady_skew_frac") or 0.0) \
                * float(measured)
        if skew_s > 0 and (obs003
                           or attr.get("dominant_phase") == "rank_skew"):
            sugs += _rule_rank_skew(skew_s, measured, knobs, cohort_blk)
        if not sugs:
            return None
        report = {
            "schema": ADVISOR_SCHEMA,
            "kind": "fit",
            "run_id": rec.get("run_id"),
            "label": rec.get("label") or rec.get("model_sig"),
            "dominant_phase": attr.get("dominant_phase"),
            "measured_step_s": measured,
            "knobs": knobs,
            "mesh": mesh,
            "suggestions": _rank(sugs, max_suggestions),
        }
    problems = validate_report(report)
    if problems:  # a malformed report is a bug in THIS module
        raise AssertionError(f"advisor built a malformed report: "
                             f"{problems}")
    metrics_registry().counter("advisor.reports").inc()
    metrics_registry().counter("advisor.suggestions").inc(
        len(report["suggestions"]))
    return report


def top_suggestion(rec: Dict) -> Optional[Dict]:
    """The single best suggestion for a record, or None — the perf
    sentinel attaches this to regression rows so a verdict names its
    remedy, not just its suspect."""
    report = advise_record(rec, max_suggestions=1)
    if not report or not report["suggestions"]:
        return None
    return report["suggestions"][0]


def validate_report(report: Dict) -> List[str]:
    """Schema problems in an advisor report ([] = valid) — the tool's
    one-JSON-line contract is gated on this."""
    problems: List[str] = []
    if not isinstance(report, dict):
        return ["report is not a dict"]
    if report.get("schema") != ADVISOR_SCHEMA:
        problems.append(f"schema != {ADVISOR_SCHEMA}")
    if report.get("kind") not in ("fit", "serving"):
        problems.append(f"kind {report.get('kind')!r} not fit|serving")
    sugs = report.get("suggestions")
    if not isinstance(sugs, list) or not sugs:
        problems.append("suggestions missing/empty")
        return problems
    for i, s in enumerate(sugs):
        for key in REQUIRED_SUGGESTION_KEYS:
            if key not in s:
                problems.append(f"suggestions[{i}] missing {key!r}")
        exp = s.get("expected") or {}
        if not isinstance(exp.get("phase_delta_s"), (int, float)):
            problems.append(f"suggestions[{i}].expected.phase_delta_s "
                            f"missing")
        if exp.get("basis") not in ("measured", "modeled"):
            problems.append(f"suggestions[{i}].expected.basis invalid")
        if not isinstance(s.get("knobs"), dict) or not s.get("knobs"):
            problems.append(f"suggestions[{i}].knobs empty")
        fam = RULE_FAMILIES.get(s.get("phase"))
        if fam and s.get("family") not in fam:
            problems.append(
                f"suggestions[{i}] family {s.get('family')!r} not in "
                f"the {s.get('phase')!r} rule table {fam}")
    return problems


# ---------------------------------------------------- experiment judging
def judge_experiment(suggestion: Dict, pairs: List[Dict]) -> Dict:
    """Accept/reject one suggestion from interleaved A/B pairs. Each
    pair is ``{"baseline": {...}, "candidate": {...}}`` with a child
    bench's ``{"phases": {name: seconds}, <metric>: value}`` on each
    side. The verdict is the fit_bench methodology applied to the
    TARGETED phase: median of per-pair (candidate/baseline) phase
    ratios < 1.0 accepts — adjacent-in-time pairs see the same host
    state, so shared-host drift cancels out of the ratio."""
    phase = suggestion["expected"]["phase"]
    metric = ("tokens_per_s"
              if phase in SERVING_PHASES else "steps_per_s")
    higher = True  # both metrics are higher-is-better
    phase_ratios: List[float] = []
    metric_ratios: List[float] = []
    for pair in pairs:
        base, cand = pair.get("baseline") or {}, pair.get("candidate") or {}
        bp = (base.get("phases") or {}).get(phase)
        cp = (cand.get("phases") or {}).get(phase)
        if isinstance(bp, (int, float)) and isinstance(cp, (int, float)) \
                and bp > 0:
            phase_ratios.append(cp / bp)
        bm, cm = base.get(metric), cand.get(metric)
        if isinstance(bm, (int, float)) and isinstance(cm, (int, float)) \
                and bm > 0:
            metric_ratios.append(cm / bm)
    def _median(xs):
        xs = sorted(xs)
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
    phase_ratio = _median(phase_ratios) if phase_ratios else None
    metric_ratio = _median(metric_ratios) if metric_ratios else None
    accepted = phase_ratio is not None and phase_ratio < 1.0
    predicted_frac = suggestion["expected"]["step_delta_frac"]
    return {
        "suggestion_id": suggestion["id"],
        "phase": phase,
        "metric": metric,
        "higher_is_better": higher,
        "pairs": len(pairs),
        "phase_ratio": (round(phase_ratio, 4)
                        if phase_ratio is not None else None),
        "metric_ratio": (round(metric_ratio, 4)
                         if metric_ratio is not None else None),
        "predicted": {
            "phase_delta_s": suggestion["expected"]["phase_delta_s"],
            "step_delta_frac": predicted_frac,
        },
        "measured": {
            "phase_delta_frac": (round(1.0 - phase_ratio, 4)
                                 if phase_ratio is not None else None),
        },
        "verdict": "accepted" if accepted else "rejected",
    }


# --------------------------------------------------------- fit-tail hook
def maybe_advise(ffmodel) -> None:
    """fit()'s hook (after attribution): build the advisor report from
    the fresh fit profile, attach it to ``fit_profile["advice"]``, and
    publish it on the obs server's ``/advice`` endpoint."""
    if advisor_mode(ffmodel.config) == "off":
        return
    fp = getattr(ffmodel, "fit_profile", None)
    if not fp or not fp.get("attribution"):
        return
    try:
        from .ledger import model_context

        rec = model_context(ffmodel)
        rec["kind"] = "fit"
        rec["attribution"] = fp["attribution"]
        if fp.get("pipeline"):
            rec["pipeline"] = {
                k: v for k, v in fp["pipeline"].items()
                if isinstance(v, (int, float, str, bool)) or v is None}
        k = int(getattr(ffmodel.config, "advisor_max_suggestions",
                        DEFAULT_MAX_SUGGESTIONS)
                or DEFAULT_MAX_SUGGESTIONS)
        report = advise_record(rec, max_suggestions=max(1, k))
    except ValueError:
        raise
    except Exception:  # noqa: BLE001 — advice never kills a fit
        metrics_registry().counter("advisor.errors").inc()
        return
    if report is None:
        return
    fp["advice"] = report
    from .server import publish_advice

    publish_advice(report)


__all__ = [
    "ADVISOR_SCHEMA", "DEFAULT_MAX_SUGGESTIONS", "RULE_FAMILIES",
    "REQUIRED_SUGGESTION_KEYS", "SERVING_PHASES", "advise_record",
    "advisor_mode", "judge_experiment", "maybe_advise", "top_suggestion",
    "validate_report",
]
