"""The port's perf advisor (``flexflow_tpu_torch/obs/advisor.py``) held to
the JAX package: the counterparts of ``tests/test_advisor.py``'s 40 tests.
Both advisors are fed the same record dicts (the JAX test's own record
factories) and must give the same report: suggestions, knob deltas,
prices and ranking. The departure, shown by a test: two rationale strings
that named the TPU (the ``precision`` rule's pricing source and the
``fusion`` rule's rationale) name the card's tensor cores and the port's
fusion pass instead. The fit tail attaches and publishes the report, a
continuous-batching session publishes its serving attribution and advice,
and JAX's sentinel and explain tools read the port's advice records."""

import json
import os
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import flexflow_tpu_torch as T
from flexflow_tpu.obs import advisor as jadv
from flexflow_tpu_torch.obs import advisor as tadv
from flexflow_tpu_torch.obs.advisor import (ADVISOR_SCHEMA, RULE_FAMILIES, advise_record,
                                           advisor_mode, judge_experiment, top_suggestion,
                                           validate_report)

from test_advisor import _fit_rec, _pair, _serving_rec, _tool, _write_ledger

# the two strings the port words for the card
_PORT_WORDING = {
    "tensor-core bf16 matmul throughput (cost model dtype factor)":
        "MXU bf16 matmul throughput (cost model dtype factor)",
    "fuse chains of weightless unary ops into one op before search; the expected "
    "win is small":
        "fuse adjacent ops before search; XLA fuses HLO either way, so the expected "
        "win is small",
}


def _as_jax(report):
    txt = json.dumps(report)
    for mine, theirs in _PORT_WORDING.items():
        txt = txt.replace(mine, theirs)
    return json.loads(txt)


def _both(rec, **kw):
    """(port report, JAX report) of one record; equal after the wording."""
    t = advise_record(json.loads(json.dumps(rec)), **kw)
    j = jadv.advise_record(json.loads(json.dumps(rec)), **kw)
    assert (_as_jax(t) if t is not None else None) == j
    return t


def _families(report):
    return [s["family"] for s in report["suggestions"]]


_PIPE_HOST = {"engine": "host", "schedule": "1f1b", "num_stages": 2, "num_microbatches": 4,
              "interleave": 1, "bubble_fraction": 0.2, "dispatches_per_step": 20,
              "compiled_mesh_eligible": True, "fallback_reason": None}
_PIPE_GPIPE = {"engine": "compiled", "schedule": "gpipe", "num_stages": 4,
               "num_microbatches": 8, "interleave": 1, "bubble_fraction": 0.4667,
               "dispatches_per_step": 1, "compiled_mesh_eligible": True,
               "fallback_reason": None}


# ------------------------------------------------- every rule against JAX's
@pytest.mark.parametrize("dominant,kw", [
    ("input_wait", {}), ("input_wait", {"knobs": {"prefetch_depth": 2}}),
    ("host_dispatch", {}), ("host_dispatch", {"knobs": {"steps_per_dispatch": 4}}),
    ("host_dispatch", {"mesh": {"pipe": 2, "data": 4}, "pipeline": _PIPE_HOST}),
    ("pipeline_bubble", {"mesh": {"pipe": 4, "data": 2}, "pipeline": _PIPE_GPIPE,
                         "n_ops": 32}),
    ("collective_transfer", {}), ("collective_transfer", {"mesh": {"data": 2}}),
    ("optimizer_fold", {}), ("optimizer_fold", {"knobs": {"zero_optimizer": True}}),
    ("device_compute", {}), ("device_compute", {"knobs": {"compute_dtype": "bfloat16"}}),
    ("device_compute", {"knobs": {"perform_fusion": True, "compute_dtype": "bfloat16"}}),
])
def test_fit_rules_equal_jax(dominant, kw):
    assert _both(_fit_rec(dominant, **kw))["suggestions"]


@pytest.mark.parametrize("buckets", [
    {"padded_token_fraction": 0.6, "pad_max": False, "token_budget": 0, "ladder": [8, 16, 32]},
    {"padded_token_fraction": 0.6, "pad_max": True, "token_budget": 128, "ladder": [8, 16, 32]},
    {"padded_token_fraction": 0.2, "pad_max": False, "token_budget": 128, "ladder": [8, 16]}])
def test_token_bucketing_rule_equals_jax(buckets):
    rec = _fit_rec("device_compute")
    rec["buckets"] = buckets
    _both(rec)


@pytest.mark.parametrize("variant", ["obs003", "clean", "dominant"])
def test_rank_skew_rule_equals_jax(variant):
    rec = _fit_rec("device_compute", knobs={"process_count": 4})
    cohort = {"schema": 1, "ranks": [0, 1, 2, 3], "straggler_rank": 2,
              "steady_skew_frac": 0.4, "threshold": 0.25,
              "per_rank_mean_step_s": {"0": 0.01, "1": 0.01, "2": 0.014, "3": 0.01},
              "findings": [{"code": "OBS003", "severity": "warning",
                            "message": "rank 2 is pacing the cohort"}]}
    if variant == "obs003":
        rec["cohort"] = cohort
    elif variant == "clean":
        rec["cohort"] = dict(cohort, findings=[], steady_skew_frac=0.05)
    else:
        attr = rec["attribution"]
        attr["phases"]["rank_skew"] = {"seconds": 0.08, "fraction": 0.5, "basis": "measured"}
        attr["measured_step_s"] += 0.08
        attr["dominant_phase"] = "rank_skew"
    rep = _both(rec)
    skew = [s for s in rep["suggestions"] if s["phase"] == "rank_skew"]
    assert bool(skew) == (variant != "clean")


@pytest.mark.parametrize("dominant,kw", [
    ("queue_wait", {}), ("prefill", {}), ("decode", {}),
    ("prefill", {"knobs": {"decode_slots": 4, "max_prefills_per_step": 4}}),
    ("queue_wait", {"kv": {"high_water": 24, "capacity_blocks": 24}}),
    ("queue_wait", {"kv": {"high_water": 24, "capacity_blocks": 24, "kv_dtype": "int8"}}),
    ("decode", {"knobs": {"spec_k": 4}})])
def test_serving_rules_equal_jax(dominant, kw):
    rep = _both(_serving_rec(dominant, **kw))
    assert rep is None or rep["kind"] == "serving"


def test_serving_spec_rule_priced_by_priors_equal_jax():
    prior = _serving_rec("decode", run_id="s0", ts=0.5)
    prior["spec"] = {"k": 4, "accept_rate": 0.8}
    rep = _both(_serving_rec("decode"), priors=[prior])
    assert rep["suggestions"][0]["expected"]["basis"] == "measured"


def test_port_wording_departure():
    """The two strings the port words for the card, and nothing else."""
    rep = advise_record(_fit_rec("device_compute"))
    fams = {s["family"]: s for s in rep["suggestions"]}
    assert fams["precision"]["expected"]["priced_by"].startswith("tensor-core bf16")
    assert "XLA" not in json.dumps(rep) and "MXU" not in json.dumps(rep)


# --------------------------------------------------- golden rules per phase
def test_rule_input_wait_maps_to_prefetch():
    top = advise_record(_fit_rec("input_wait"))["suggestions"][0]
    assert top["phase"] == "input_wait" and top["family"] == "prefetch"
    assert top["knobs"] == {"prefetch_depth": 2} and top["expected"]["basis"] == "measured"
    top2 = advise_record(_fit_rec("input_wait", knobs={"prefetch_depth": 2}))["suggestions"][0]
    assert top2["family"] == "prefetch" and top2["proposed"] == 4


def test_rule_host_dispatch_maps_to_multi_step_dispatch():
    top = advise_record(_fit_rec("host_dispatch"))["suggestions"][0]
    assert top["phase"] == "host_dispatch" and top["family"] == "multi_step_dispatch"
    assert top["knobs"] == {"steps_per_dispatch": 2}


def test_rule_host_dispatch_pipelined_maps_to_compiled_engine():
    rep = advise_record(_fit_rec("host_dispatch", mesh={"pipe": 2, "data": 4},
                                 pipeline=_PIPE_HOST))
    top = rep["suggestions"][0]
    assert top["family"] == "compiled_pipeline"
    assert top["knobs"] == {"pipeline_engine": "compiled"}
    assert top["expected"]["phase_delta_s"] == pytest.approx(0.06 * 0.95, rel=1e-6)


def test_rule_pipeline_bubble_maps_to_schedule_family():
    rep = advise_record(_fit_rec("pipeline_bubble", mesh={"pipe": 4, "data": 2},
                                 pipeline=_PIPE_GPIPE, n_ops=32))
    fams = {s["family"] for s in rep["suggestions"] if s["phase"] == "pipeline_bubble"}
    assert "schedule" in fams and fams <= set(RULE_FAMILIES["pipeline_bubble"])
    sched = next(s for s in rep["suggestions"] if s["family"] == "schedule")
    assert sched["knobs"]["pipeline_schedule"] == "interleaved"
    micro = [s for s in rep["suggestions"] if s["family"] == "microbatches"]
    assert micro and micro[0]["knobs"] == {"grad_accum_steps": 2}


def test_rule_collective_maps_to_mesh_reshape():
    top = advise_record(_fit_rec("collective_transfer"))["suggestions"][0]
    assert top["family"] == "mesh_reshape"
    cand = top["knobs"]["mesh_shape"]
    assert int(np.prod(list(cand.values()))) == 8 and 2 <= cand["data"] < 8


def test_rule_optimizer_fold_maps_to_zero():
    top = advise_record(_fit_rec("optimizer_fold"))["suggestions"][0]
    assert top["family"] == "optimizer_sharding" and top["knobs"] == {"zero_optimizer": True}
    rep2 = advise_record(_fit_rec("optimizer_fold", knobs={"zero_optimizer": True}))
    assert all(s["phase"] != "optimizer_fold" for s in rep2["suggestions"])


def test_rule_device_compute_maps_to_precision():
    top = advise_record(_fit_rec("device_compute"))["suggestions"][0]
    assert top["family"] in RULE_FAMILIES["device_compute"]
    assert top["knobs"] == {"compute_dtype": "bfloat16"}


def test_serving_rules_map_phases_to_knob_families():
    for dominant, family, knob in (("queue_wait", "decode_slots", "decode_slots"),
                                   ("prefill", "prefill_interleave", "max_prefills_per_step"),
                                   ("decode", "speculation", "serving_spec_k")):
        rep = advise_record(_serving_rec(dominant))
        assert rep["kind"] == "serving" and rep["dominant_phase"] == dominant
        top = rep["suggestions"][0]
        assert top["family"] == family and top["knob"] == knob


# --------------------------------------------------- ranking + validation
def test_rule_families_equal_jax():
    assert RULE_FAMILIES == jadv.RULE_FAMILIES
    assert tadv.REQUIRED_SUGGESTION_KEYS == jadv.REQUIRED_SUGGESTION_KEYS
    assert ADVISOR_SCHEMA == jadv.ADVISOR_SCHEMA


def test_ranking_stable_and_dominant_first():
    rec = _fit_rec("input_wait")
    a, b = advise_record(rec), advise_record(rec)
    assert a == b and a["suggestions"][0]["phase"] == "input_wait"
    assert [s["rank"] for s in a["suggestions"]] == list(range(len(a["suggestions"])))
    fracs = [s["expected"]["step_delta_frac"] for s in a["suggestions"]]
    assert fracs == sorted(fracs, reverse=True)
    # top_suggestion takes the record, not the report
    top = top_suggestion(rec)
    assert {k: v for k, v in top.items() if k != "rank"} == \
        {k: v for k, v in a["suggestions"][0].items() if k != "rank"}
    assert _as_jax(top) == jadv.top_suggestion(rec)


def test_unadvisable_records_return_none():
    for rec in ({"kind": "bench", "perf": {}}, {"kind": "fit", "attribution": {}},
                {"kind": "serving", "counters": {}}):
        assert advise_record(rec) is None and jadv.advise_record(rec) is None


def test_validate_report_catches_malformed():
    rep = advise_record(_fit_rec("input_wait"))
    assert validate_report(rep) == [] == jadv.validate_report(rep)
    bad = json.loads(json.dumps(rep))
    del bad["suggestions"][0]["expected"]
    assert validate_report(bad) == jadv.validate_report(bad)
    assert any("expected" in p for p in validate_report(bad))
    bad2 = json.loads(json.dumps(rep))
    bad2["suggestions"][0]["family"] = "nonsense"
    assert any("rule table" in p for p in validate_report(bad2))
    empty = {"schema": ADVISOR_SCHEMA, "kind": "fit", "suggestions": []}
    assert validate_report(empty) == jadv.validate_report(empty) != []


def test_advisor_mode_guard():
    assert advisor_mode(types.SimpleNamespace(advisor="on")) == "on"
    assert advisor_mode(types.SimpleNamespace(advisor="off")) == "off"
    with pytest.raises(ValueError, match="advisor="):
        advisor_mode(types.SimpleNamespace(advisor="typo"))


# -------------------------------------------------------- experiment judge
@pytest.mark.parametrize("pairs", [
    [(0.010, 0.004), (0.012, 0.005)], [(0.004, 0.010), (0.005, 0.012)],
    [(0.010, 0.004), (0.004, 0.010), (0.010, 0.005)]])
def test_judge_experiment_equals_jax(pairs):
    sug = advise_record(_fit_rec("input_wait"))["suggestions"][0]
    ps = [_pair(a, b) for a, b in pairs]
    assert judge_experiment(sug, ps) == jadv.judge_experiment(sug, ps)


def test_judge_experiment_accepts_and_rejects():
    sug = advise_record(_fit_rec("input_wait"))["suggestions"][0]
    good = judge_experiment(sug, [_pair(0.010, 0.004), _pair(0.012, 0.005)])
    assert good["verdict"] == "accepted" and good["phase_ratio"] < 1.0 and good["pairs"] == 2
    bad = judge_experiment(sug, [_pair(0.004, 0.010), _pair(0.005, 0.012)])
    assert bad["verdict"] == "rejected" and bad["phase_ratio"] > 1.0
    none = judge_experiment(sug, [{"baseline": {}, "candidate": {}}])
    assert none["verdict"] == "rejected" and none["phase_ratio"] is None


# ------------------------------------------- /advice + serving attribution
def test_advice_endpoint_404_then_report():
    from flexflow_tpu_torch.obs import server as srv_mod

    with srv_mod._attr_mu:
        saved = srv_mod._LATEST_ADVICE
        srv_mod._LATEST_ADVICE = None
    srv = srv_mod.ObsServer(port=0)
    port = srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/advice", timeout=10)
        assert ei.value.code == 404
        srv_mod.publish_advice(advise_record(_fit_rec("input_wait")))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/advice", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["schema"] == ADVISOR_SCHEMA and doc["suggestions"][0]["family"] == "prefetch"
    finally:
        srv.stop()
        with srv_mod._attr_mu:
            srv_mod._LATEST_ADVICE = saved


def test_serving_attribution_parity_and_kinds():
    import flexflow_tpu_torch.obs.server as obs_server_mod
    from flexflow_tpu_torch.obs.attribution import serving_attribution
    from flexflow_tpu_torch.obs.server import latest_attribution, publish_attribution

    stats = {"serving_engine": "continuous", "model": "gpt", "tokens_per_s": 50.0,
             "completed": 3, "knobs": {"decode_slots": 4, "block_size": 8},
             "kv": {"high_water": 3, "capacity_blocks": 20},
             "phases": {"queue_wait": {"count": 3, "mean": 0.2, "p50": 0.2, "p99": 0.3},
                        "prefill": {"count": 3, "mean": 0.01, "p50": 0.01, "p99": 0.01},
                        "decode": {"count": 3, "mean": 0.05, "p50": 0.05, "p99": 0.06}}}
    rec = serving_attribution(stats)
    assert rec["kind"] == "serving" and rec["dominant_phase"] == "queue_wait"
    with obs_server_mod._attr_mu:
        saved = dict(obs_server_mod._LATEST_ATTRIBUTION)
        obs_server_mod._LATEST_ATTRIBUTION.clear()
    try:
        assert latest_attribution() is None
        publish_attribution(rec, kind="serving")
        assert latest_attribution()["kind"] == "serving"
        publish_attribution({"dominant_phase": "device_compute", "phases": {}})
        assert latest_attribution()["dominant_phase"] == "device_compute"
        assert latest_attribution("serving")["kind"] == "serving"
    finally:
        with obs_server_mod._attr_mu:
            obs_server_mod._LATEST_ATTRIBUTION.clear()
            obs_server_mod._LATEST_ATTRIBUTION.update(saved)


def test_scheduler_session_publishes_attribution_and_advice(tmp_path):
    """A continuous-batching session on the CPU leaves both surfaces
    populated and one serving ledger record, once, however often it is
    stopped."""
    from flexflow_tpu_torch import CompMode
    from flexflow_tpu_torch.models import GPTConfig, build_gpt
    from flexflow_tpu_torch.obs import ledger
    from flexflow_tpu_torch.obs.server import latest_advice, latest_attribution
    from flexflow_tpu_torch.serving.scheduler import ContinuousBatchingScheduler

    cfg = GPTConfig(vocab_size=32, max_positions=32, hidden_size=16, num_heads=2, num_layers=1)
    ff = T.FFModel(T.FFConfig(batch_size=2, seed=0, device="cpu", ledger_dir=str(tmp_path),
                              computation_mode=CompMode.INFERENCE))
    build_gpt(ff, 2, 4, cfg)
    ff.compile()
    sched = ContinuousBatchingScheduler(ff, name="adv_par", max_length=16, decode_slots=2,
                                        block_size=4)
    futs = [sched.submit(p, 3) for p in (np.array([1, 2, 3], np.int32),
                                          np.array([4, 5], np.int32))]
    for f in futs:
        f.result(timeout=300)
    sched.stop()
    sched.stop()
    attr = latest_attribution("serving")
    assert attr is not None and attr["kind"] == "serving" and attr["model"] == "adv_par"
    adv = latest_advice()
    assert adv is not None and adv["kind"] == "serving" and adv["suggestions"]
    recs = ledger.load_runs(str(tmp_path), kind="serving")
    assert len(recs) == 1 and recs[0]["serving_engine"] == "continuous"
    assert recs[0]["model_sig"] and recs[0]["knobs"]["decode_slots"] == 2


# -------------------------------------------------- JAX's tools on the port's records
def test_sentinel_regression_row_carries_advice(tmp_path):
    """Fit records the port's advisor advised: JAX's sentinel names the
    same top suggestion on the regression row."""
    sent = _tool("perf_sentinel")
    recs = []
    for i, v in enumerate((10.0, 10.5, 9.9, 3.0)):
        r = _fit_rec("input_wait", run_id=f"r{i}", ts=i + 1, value=v)
        r["advice"] = advise_record(r)
        recs.append(r)
    _write_ledger(tmp_path, recs)
    out = sent.run_sentinel(ledger_dir=str(tmp_path), margin=0.2,
                            blackbox_dir=str(tmp_path / "bb"))
    (reg,) = out["regressions"]
    assert reg["advice"]["family"] == "prefetch" and reg["dominant_phase"] == "input_wait"


def test_mesh_reshape_candidates_pricing():
    from flexflow_tpu.sim import simulator as jsim
    from flexflow_tpu_torch.sim.simulator import mesh_reshape_candidates, ring_allreduce_factor

    assert ring_allreduce_factor(1) == 0.0
    assert ring_allreduce_factor(8) == pytest.approx(1.75)
    for mesh in ({"data": 8}, {"data": 2}, {"pipe": 8}, {"data": 8, "model": 2}):
        assert mesh_reshape_candidates(mesh) == jsim.mesh_reshape_candidates(mesh)
    cands = mesh_reshape_candidates({"data": 8})
    ratios = [c["allreduce_factor_ratio"] for c in cands]
    assert cands and ratios == sorted(ratios) and all(r < 1.0 for r in ratios)


def test_schedule_bubble_candidates_pricing():
    from flexflow_tpu.sim import simulator as jsim
    from flexflow_tpu_torch.sim.simulator import schedule_bubble_candidates

    for args in (("gpipe", 1, 2, 4), ("1f1b", 1, 4, 8), ("interleaved", 2, 2, 4)):
        assert schedule_bubble_candidates(*args, n_ops=16) == \
            jsim.schedule_bubble_candidates(*args, n_ops=16)
    rows = schedule_bubble_candidates("gpipe", 1, 2, 4, n_ops=16)
    kinds = {(r["schedule"], r["num_microbatches"]) for r in rows}
    assert ("gpipe", 8) in kinds and ("gpipe", 4) not in kinds


# ---------------------------------------------------------- fit-tail hook
def _hmlp(advisor="on", tmp_path=None):
    ff = T.FFModel(T.FFConfig(batch_size=16, seed=0, device="cpu", advisor=advisor,
                              ledger_dir=str(tmp_path) if tmp_path else None))
    x = ff.create_tensor((16, 16), T.DataType.FLOAT, name="adv_hx")
    t = ff.dense(x, 16, T.ActiMode.RELU, name="adv_hfc")
    ff.softmax(ff.dense(t, 4, name="adv_hhead"), name="adv_hsm")
    ff.compile(optimizer=T.SGDOptimizer(lr=0.05),
               loss_type=T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
    return ff


def _hdata():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(64, 16)).astype(np.float32),
            rng.integers(0, 4, size=(64, 1)).astype(np.int32))


def test_fit_attaches_and_publishes_advice(tmp_path):
    from flexflow_tpu_torch.obs.ledger import scan_ledger
    from flexflow_tpu_torch.obs.server import latest_advice

    ff = _hmlp(tmp_path=tmp_path)
    ff.fit(*_hdata(), epochs=2, verbose=False)
    adv = ff.fit_profile["advice"]
    assert adv["suggestions"] and validate_report(adv) == []
    assert latest_advice() == adv
    fits = [r for r in scan_ledger(str(tmp_path))["runs"] if r.get("kind") == "fit"]
    assert fits[-1]["advice"]["suggestions"] == adv["suggestions"]
    # the record the fit tail advised equals JAX's advice on it
    j = jadv.advise_record(json.loads(json.dumps({**fits[-1], "kind": "fit"})))
    assert _as_jax(advise_record({**fits[-1], "kind": "fit"})) == j


def test_fit_advisor_off_and_typo(tmp_path):
    ff = _hmlp("off", tmp_path)
    ff.fit(*_hdata(), epochs=1, verbose=False)
    assert "advice" not in ff.fit_profile
    ff2 = _hmlp("typo", tmp_path)
    with pytest.raises(ValueError, match="advisor="):
        ff2.fit(*_hdata(), epochs=1, verbose=False)


def test_explain_narrates_port_advice(tmp_path):
    exp = _tool("explain_run")
    rec = _fit_rec("input_wait", run_id="e1" * 16, ts=2.0)
    rec["advice"] = advise_record(rec)
    _write_ledger(tmp_path, [_fit_rec("input_wait", run_id="e0" * 16, ts=1.0), rec])
    doc = exp.explain(run_id="e1", ledger_dir=str(tmp_path))
    assert doc["exit"] == 0
    assert json.dumps(rec["advice"]["suggestions"][0]["knob"]) in json.dumps(doc)
