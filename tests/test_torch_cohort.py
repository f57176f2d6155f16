"""The port's cohort observability (``flexflow_tpu_torch/obs/cohort.py``)
held to the JAX package: the counterparts of ``tests/test_cohort.py``'s 18
tests. The pure functions (trace merge, per-rank step times, skew and
OBS003, cohort attribution, the metrics roll-up, the report over a seeded
directory, the ledger back-fill) take the JAX test's own seeded artifacts
and give JAX's output; a fit under ``cohort_obs="on"`` exports its rank's
trace, metrics and manifest; and a real two-rank gloo cohort under the
supervisor (``parallel/launch.py``) with a hung rank leaves the hung
worker's black-box dump, one merged ledger deduplicated by run id and
the cohort report (merged trace, skew table, straggler)."""

import json
import os
import shutil
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import flexflow_tpu_torch as T
from flexflow_tpu.obs import cohort as jcohort
from flexflow_tpu.obs import trace as jtrace
from flexflow_tpu_torch.obs import trace as ttrace
from flexflow_tpu_torch.obs.cohort import (COHORT_PHASE, COHORT_SCHEMA,
                                           annotate_ledger_with_skew, build_cohort_report,
                                           cohort_attribution, cohort_dir, cohort_obs_mode,
                                           merge_metric_snapshots, merge_traces,
                                           rank_step_times, skew_summary, step_skew)
from flexflow_tpu_torch.obs.metrics import MetricsRegistry
from flexflow_tpu_torch.obs.trace import validate_chrome_trace

from test_cohort import _attr, _rank_trace, _seed_cohort_dir


@pytest.fixture(autouse=True)
def _tracers():
    """A fit under cohort_obs arms the port's tracer: it is restored off
    (and JAX's with it) after every test."""
    yield
    ttrace.configure_tracer(enabled=False)
    ttrace.tracer().clear()
    jtrace.configure_tracer(enabled=False)


def _no_pids(doc):
    """A report without the fields that name this run's paths."""
    doc = json.loads(json.dumps(doc))
    for k in ("dir", "merged_trace"):
        doc.pop(k, None)
    return doc


# ------------------------------------------------------ trace unification
def test_merge_traces_rebases_onto_one_timeline(tmp_path):
    p0, p1 = tmp_path / "trace-rank0.json", tmp_path / "trace-rank1.json"
    _rank_trace(p0, anchor=100.0, durs_us=[10000, 10000], pid=111, label="rank0")
    _rank_trace(p1, anchor=100.5, durs_us=[10000, 10000], pid=111, label="rank1")
    out = tmp_path / "trace-cohort.json"
    merged = merge_traces([str(p0), str(p1)], out=str(out))
    assert merged == jcohort.merge_traces([str(p0), str(p1)])
    assert validate_chrome_trace(merged) == []
    with open(str(out)) as f:
        assert json.load(f) == json.loads(json.dumps(merged))
    spans = [ev for ev in merged["traceEvents"] if ev.get("ph") == "X"]
    assert sorted({ev["pid"] for ev in spans}) == [0, 1]
    r0 = min(ev["ts"] for ev in spans if ev["pid"] == 0)
    r1 = min(ev["ts"] for ev in spans if ev["pid"] == 1)
    assert r1 - r0 == pytest.approx(0.5e6, abs=1.0)
    md = merged["metadata"]
    assert md["process"] == "cohort:2ranks" and md["ranks"]["1"]["source_pids"] == [111]


def test_merge_traces_rejects_anchorless_trace(tmp_path):
    p = tmp_path / "t.json"
    with open(str(p), "w") as f:
        json.dump({"traceEvents": [], "metadata": {"process": "x"}}, f)
    with pytest.raises(ValueError, match="wall_clock_anchor_unix_s"):
        merge_traces([str(p)])
    with pytest.raises(ValueError, match="no trace paths"):
        merge_traces([])


def test_merge_traces_of_port_exports(tmp_path):
    """Two traces the port's tracer exported merge onto one timeline."""
    paths = []
    for r in range(2):
        tr = ttrace.Tracer(enabled=True)
        tr.complete("fit.step", tr.now(), 0.01, cat="fit", args={"k": 1})
        p = tmp_path / f"trace-rank{r}.json"
        tr.export(str(p), label=f"rank{r}")
        paths.append(str(p))
    merged = merge_traces(paths)
    assert validate_chrome_trace(merged) == []
    assert [row["label"] for row in merged["metadata"]["ranks"].values()] == ["rank0", "rank1"]


def test_rank_step_times_expands_multi_step_dispatch():
    evs = [{"name": "fit.step", "ph": "X", "ts": 5e6, "dur": 4e6, "pid": 1, "tid": 1,
            "args": {"k": 4}},
           {"name": "fit.step", "ph": "X", "ts": 0.0, "dur": 2e6, "pid": 1, "tid": 1,
            "args": {"k": 2}},
           {"name": "other", "ph": "X", "ts": 0.0, "dur": 9e6, "pid": 1, "tid": 2}]
    assert rank_step_times(evs) == jcohort.rank_step_times(evs) == [1.0] * 6
    assert rank_step_times({"traceEvents": []}) == []


# ----------------------------------------------------- skew attribution
@pytest.mark.parametrize("series,threshold", [
    ({0: [0.010] * 6, 1: [0.010] * 6, 2: [0.015] * 6}, None),
    ({0: [0.01, 0.01, 0.01], 1: [0.01, 0.01, 0.01]}, None),
    ({0: [0.010] * 4, 1: [0.012] * 4}, 0.5), ({0: [0.010] * 4, 1: [0.012] * 4}, 0.05),
    ({0: [0.01] * 5, 1: [0.01] * 3}, None), ({0: [0.01, 0.01]}, None), ({0: [], 1: [0.01]}, None),
    ({0: [0.02, 0.011, 0.012], 1: [0.021, 0.010, 0.013], 2: [0.03, 0.02, 0.011]}, 0.1)])
def test_step_skew_equals_jax(series, threshold):
    assert step_skew(series, threshold=threshold) == jcohort.step_skew(series, threshold=threshold)


def test_step_skew_names_straggler_and_fires_obs003():
    skew = step_skew({0: [0.010] * 6, 1: [0.010] * 6, 2: [0.015] * 6})
    assert skew["ranks"] == [0, 1, 2] and skew["steps"] == 6
    assert skew["per_step"][0]["median_s"] == pytest.approx(0.010)
    assert skew["steady_skew_frac"] == pytest.approx(0.5) and skew["straggler_rank"] == 2
    [f] = skew["findings"]
    assert f["code"] == "OBS003" and f["severity"] == "warning" and "rank 2" in f["message"]


def test_step_skew_degenerate_cohorts():
    assert step_skew({0: [0.01, 0.01]}) is None
    assert step_skew({0: [], 1: [0.01]}) is None
    assert step_skew({0: [0.01] * 5, 1: [0.01] * 3})["steps"] == 3


def test_cohort_attribution_telescopes_with_rank_skew():
    per_rank = {0: _attr(0.010), 1: _attr(0.016), 2: _attr(0.011)}
    rec = cohort_attribution(per_rank)
    assert rec == jcohort.cohort_attribution(per_rank)
    assert rec["kind"] == "cohort" and rec["measured_step_s"] == pytest.approx(0.016)
    assert rec["base_rank"] == 2 and rec["phase_order"][-1] == COHORT_PHASE
    assert rec["phases"][COHORT_PHASE]["seconds"] == pytest.approx(0.005)
    assert rec["reconciliation"]["reconciles"]
    assert cohort_attribution({}) is None and cohort_attribution({0: {"phases": {}}}) is None


# ------------------------------------------------------ metrics roll-up
def test_merge_metric_snapshots_matches_registry_merge():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("fit.steps").inc(4)
    b.counter("fit.steps").inc(8)
    a.gauge("mem").set(1.0)
    b.gauge("mem").set(2.0)
    for v in (0.1, 0.2):
        a.histogram("lat").observe(v)
    b.histogram("lat").observe(0.4)
    docs = [a.to_json(), b.to_json(), "not-a-doc", None]
    via_docs = merge_metric_snapshots(docs)
    manual = MetricsRegistry()
    manual.merge(MetricsRegistry.from_json(a.to_json()))
    manual.merge(MetricsRegistry.from_json(b.to_json()))
    assert via_docs == manual.to_json() == jcohort.merge_metric_snapshots(docs)
    assert via_docs["fit.steps"] == 12


# ----------------------------------------------------------- knob guards
def test_cohort_obs_mode_and_dir_resolution(monkeypatch):
    ns = types.SimpleNamespace
    assert cohort_obs_mode(ns(cohort_obs="on")) == "on"
    assert cohort_obs_mode(ns()) == "off"
    with pytest.raises(ValueError, match="cohort_obs"):
        cohort_obs_mode(ns(cohort_obs="onn"))
    monkeypatch.delenv("FLEXFLOW_TPU_COHORT_DIR", raising=False)
    assert cohort_dir() == ".ffcache/obs/cohort"
    monkeypatch.setenv("FLEXFLOW_TPU_COHORT_DIR", "/tmp/env-cohort")
    assert cohort_dir() == "/tmp/env-cohort" == jcohort.cohort_dir()
    assert cohort_dir(ns(cohort_obs_dir="/tmp/knob")) == "/tmp/knob"


def test_config_carries_cohort_knobs():
    cfg = T.FFConfig(batch_size=8, device="cpu", cohort_obs="on", cohort_skew_threshold=0.4,
                     cohort_obs_dir="/tmp/x")
    assert cohort_obs_mode(cfg) == "on" and cfg.cohort_skew_threshold == pytest.approx(0.4)
    assert cohort_dir(cfg) == "/tmp/x"
    assert cohort_obs_mode(T.FFConfig(batch_size=8, device="cpu")) == "off"


# -------------------------------------------------- fleet-level report
def test_build_cohort_report_equals_jax_on_a_seeded_directory(tmp_path):
    d = tmp_path / "cohort"
    _seed_cohort_dir(d, {0: [10000] * 4, 1: [30000] * 4})
    mine = build_cohort_report(str(d))
    shutil.copytree(d, tmp_path / "jax")
    theirs = jcohort.build_cohort_report(str(tmp_path / "jax"))
    assert _no_pids(mine) == _no_pids(theirs)
    assert mine["straggler_rank"] == 1 and mine["merged_trace_valid"]
    assert [f["code"] for f in mine["findings"]] == ["OBS003"]
    from flexflow_tpu_torch.obs.server import latest_cohort

    assert latest_cohort()["straggler_rank"] == 1


def test_build_cohort_report_clean_and_degenerate(tmp_path):
    d = tmp_path / "clean"
    _seed_cohort_dir(d, {0: [10000] * 4, 1: [10000] * 4})
    report = build_cohort_report(str(d), write_merged=False)
    assert report["findings"] == [] and report["merged_trace"] is None
    with open(os.path.join(str(d), "cohort-rank7.json"), "w") as f:
        f.write("{not json")
    with open(os.path.join(str(d), "cohort-rank8.json"), "w") as f:
        json.dump({"schema": 99, "rank": 8}, f)
    report = build_cohort_report(str(d), write_merged=False)
    assert report["ranks"] == [0, 1]
    assert report["corrupt_manifests"] == 1 and report["skipped_schema"] == 1
    empty = build_cohort_report(str(tmp_path / "nope"))
    assert empty["ranks"] == [] and "no cohort-rank" in empty["error"]


def test_annotate_ledger_with_skew_roundtrip(tmp_path):
    report = {"skew": {"ranks": [0, 1], "straggler_rank": 1, "steady_skew_frac": 0.5,
                       "threshold": 0.25,
                       "per_rank": {"0": {"mean_step_s": 0.01}, "1": {"mean_step_s": 0.03}},
                       "findings": [{"code": "OBS003", "severity": "warning",
                                     "message": "m"}]}}
    assert skew_summary(report) == jcohort.skew_summary(report)
    assert skew_summary({"skew": None}) is None
    recs = [{"schema": 1, "kind": "fit", "run_id": "multi", "knobs": {"process_count": 2}},
            {"schema": 1, "kind": "fit", "run_id": "solo", "knobs": {"process_count": 1}},
            {"schema": 1, "kind": "fit", "run_id": "already", "knobs": {"process_count": 2},
             "cohort": {"straggler_rank": 0}},
            {"schema": 1, "kind": "compile", "run_id": "c", "knobs": {"process_count": 2}}]
    texts = []
    for name, fn in (("port", annotate_ledger_with_skew),
                     ("jax", jcohort.annotate_ledger_with_skew)):
        d = tmp_path / name
        os.makedirs(str(d))
        with open(os.path.join(str(d), "runs-t.jsonl"), "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
            f.write("{corrupt line\n")
        assert fn(str(d), report) == 1
        assert fn(str(d), report) == 0
        texts.append(open(os.path.join(str(d), "runs-t.jsonl")).read())
    assert texts[0] == texts[1]
    assert annotate_ledger_with_skew(str(tmp_path / "nope"), report) == 0


def test_cohort_endpoint_404_then_report():
    import flexflow_tpu_torch.obs.server as server_mod
    from flexflow_tpu_torch.obs.server import ObsServer, publish_cohort

    with server_mod._attr_mu:
        server_mod._LATEST_COHORT = None
    srv = ObsServer(port=0)
    port = srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/cohort", timeout=10)
        assert ei.value.code == 404
        publish_cohort({"schema": COHORT_SCHEMA, "ranks": [0, 1], "straggler_rank": 1,
                        "findings": []})
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/cohort", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["straggler_rank"] == 1 and doc["ranks"] == [0, 1]
    finally:
        srv.stop()


def _coh_mlp(cfg):
    ff = T.FFModel(cfg)
    x = ff.create_tensor((16, 16), T.DataType.FLOAT, name="coh_x")
    t = ff.dense(x, 16, T.ActiMode.RELU, name="coh_fc")
    ff.softmax(ff.dense(t, 4, name="coh_head"), name="coh_sm")
    ff.compile(optimizer=T.SGDOptimizer(lr=0.05),
               loss_type=T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
    return ff


def test_fit_exports_rank_artifacts_under_cohort_obs(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_LEDGER_DIR", str(tmp_path / "ledger"))
    d = tmp_path / "cohort"
    ff = _coh_mlp(T.FFConfig(batch_size=16, seed=0, device="cpu", cohort_obs="on",
                             cohort_obs_dir=str(d), cohort_skew_threshold=0.3))
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(64, 16)).astype(np.float32)
    ys = rng.integers(0, 4, size=(64, 1)).astype(np.int32)
    ff.fit(xs, ys, epochs=2, verbose=False)
    for fn in ("trace-rank0.json", "metrics-rank0.json", "cohort-rank0.json"):
        assert os.path.exists(os.path.join(str(d), fn)), fn
    manifest = json.load(open(os.path.join(str(d), "cohort-rank0.json")))
    assert manifest["rank"] == 0 and manifest["schema"] == COHORT_SCHEMA
    assert manifest["skew_threshold"] == pytest.approx(0.3) and manifest["trace_events"] > 0
    assert manifest["attribution"]
    trace = json.load(open(os.path.join(str(d), "trace-rank0.json")))
    assert validate_chrome_trace(trace) == [] and trace["metadata"]["label"] == "rank0"
    assert any(ev.get("name") == "fit.step" for ev in trace["traceEvents"])
    assert ff.fit_profile["cohort_export"]["trace"] == "trace-rank0.json"
    report = build_cohort_report(str(d))
    assert report["ranks"] == [0] and "error" not in report
    assert report["merged_trace_valid"] and report["skew"] is None
    # the JAX package's report reads the port's artifacts as its own
    assert jcohort.build_cohort_report(str(d), write_merged=False)["ranks"] == [0]
    d2 = tmp_path / "off"
    ff2 = _coh_mlp(T.FFConfig(batch_size=16, seed=0, device="cpu", cohort_obs="off",
                              cohort_obs_dir=str(d2)))
    ff2.fit(xs, ys, epochs=1, verbose=False)
    assert not os.path.exists(str(d2))


# ------------------------------------------- a real cohort under the supervisor
def test_supervised_cohort_hung_rank_dump_merged_ledger_and_report(tmp_path):
    """Two gloo ranks under the supervisor with cohort_obs and the
    watchdog armed at 1 s; rank 1 stalls at step 3 past the 4 s hang
    threshold. The supervisor relaunches; the hung attempt's event carries
    rank 1's black-box dump (thread stacks, the tracer ring); the clean
    relaunch's ledgers merge into one cohort directory, every run id once
    (merging again adds nothing), and the cohort report merges both
    ranks' traces and tables their skew."""
    from flexflow_tpu_torch.obs import ledger
    from flexflow_tpu_torch.parallel import launch

    plan = {"schema": 1, "seed": 0,
            "sites": {"multihost.slow_peer": {"at_step": 3, "stall_s": 600.0}}}
    rep = launch.supervise(nproc=2, run_dir=str(tmp_path), fault_plan=plan, fault_rank=1,
                           hang_threshold_s=4.0, max_relaunches=1, device="cpu",
                           cohort_timeout_s=300.0, watchdog_threshold_s=1.0,
                           cohort_obs=True)
    assert rep["ok"], json.dumps(rep, default=str)[:3000]
    (ev,) = rep["events"]
    # the stalled rank, or its peer waiting on it in the step's collective
    assert ev["outcome"] == "hung" and set(ev["failed"]) <= {"0", "1"}
    assert any(n.startswith("blackbox-") for n in ev["blackbox_dumps"])
    dumps = [os.path.join(tmp_path, "blackbox-r1", n)
             for n in os.listdir(tmp_path / "blackbox-r1") if n.startswith("blackbox-")]
    doc = json.load(open(dumps[0]))
    assert doc["reason"] == "stall" and "fit.loop" in doc["stalled"]
    assert any("sleep" in ln for v in doc["threads"].values() for ln in v)
    assert any(e["name"] == "fit.step" for e in doc["trace_tail"])
    # one merged ledger: every rank's records, each run id once
    lrep = rep["ledger"]
    merged = ledger.scan_ledger(lrep["cohort_dir"])["runs"]
    ranks = [ledger.scan_ledger(str(tmp_path / "ledger" / f"rank-{r}"))["runs"]
             for r in range(2)]
    ids = [r["run_id"] for rr in ranks for r in rr]
    assert lrep["merged"] == len(ids) == len(set(ids)) == len(merged)
    assert lrep["remerged"] == 0
    fits = [r for r in merged if r["kind"] == "fit"]
    assert {r["knobs"]["process_count"] for r in fits} == {2}
    assert len({ledger.cohort_key(r) for r in fits}) == 1
    # the cohort report: both ranks' traces on one timeline, the skew table
    coh = rep["cohort"]
    assert coh["ranks"] == [0, 1] and coh["merged_trace_valid"], coh
    assert coh["lanes"] == [0, 1] and coh["skew"]["steps"] >= 1
    assert coh["attribution"]["kind"] == "cohort"
    # its skew stamped onto every merged fit record
    assert coh["ledger_annotated"] == len(fits)
    stamped = [r for r in ledger.scan_ledger(lrep["cohort_dir"])["runs"] if r["kind"] == "fit"]
    assert all(r["cohort"]["ranks"] == [0, 1] for r in stamped)
