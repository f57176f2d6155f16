"""The port's step-time attribution, cost corpus and obs server
(``flexflow_tpu_torch/obs/attribution.py``, ``costcorpus.py``,
``server.py``) held to the JAX package: the counterparts of
``tests/test_attribution.py``'s 27 tests. The pure functions take the same
record dicts and give JAX's output exactly; ``attribute_fit`` on the same
graph, machine model and fit profile gives JAX's report (1e-9), and
``_predicted_phases`` on the same graph and machine-model file gives
JAX's phases (1e-9). JAX's ``tools/explain_run.py`` reads the port's
ledger records as it reads its own."""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.obs import attribution as jattr
from flexflow_tpu.obs import trace as jtrace
from flexflow_tpu_torch.models.mlp import build_mlp
from flexflow_tpu_torch.obs import attribution as tattr
from flexflow_tpu_torch.obs import costcorpus, ledger
from flexflow_tpu_torch.obs import trace as ttrace
from flexflow_tpu_torch.obs.attribution import PHASES, attribute_fit, attribution_report
from flexflow_tpu_torch.obs.server import ObsServer, publish_attribution

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-9


@pytest.fixture(autouse=True)
def _tracers():
    """Both packages' tracers are restored off, whatever a test armed."""
    yield
    ttrace.configure_tracer(enabled=False)
    jtrace.configure_tracer(enabled=False)
    ttrace.tracer().clear()
    jtrace.tracer().clear()


def _mlp(tmp_path=None, hidden=(16,), **cfg):
    if tmp_path is not None:
        cfg.setdefault("ledger_dir", str(tmp_path))
    ff = T.FFModel(T.FFConfig(batch_size=16, seed=0, device="cpu", **cfg))
    build_mlp(ff, 16, in_dim=8, hidden_dims=hidden, num_classes=4)
    ff.compile(optimizer=T.SGDOptimizer(lr=0.05),
               loss_type=T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
    return ff


def _jmlp(tmp_path, hidden=(16,), **cfg):
    """JAX's MLP on a one-device mesh (the port's single process)."""
    import jax

    from flexflow_tpu.core.machine import make_mesh
    from flexflow_tpu.models.mlp import build_mlp as jbuild_mlp

    ff = J.FFModel(J.FFConfig(batch_size=16, seed=0, ledger_dir=str(tmp_path),
                              audit_programs="off", **cfg))
    jbuild_mlp(ff, 16, in_dim=8, hidden_dims=hidden, num_classes=4)
    ff.compile(optimizer=J.SGDOptimizer(lr=0.05),
               loss_type=J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[],
               mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    return ff


def _data(n=64):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(n, 1)).astype(np.int32)
    return x, y


def _assert_reconciles(rec):
    assert rec is not None
    rcn = rec["reconciliation"]
    assert rcn["reconciles"], rcn
    phase_sum = sum(rec["phases"][p]["seconds"] for p in PHASES)
    assert phase_sum == pytest.approx(rec["measured_step_s"], rel=rcn["tolerance"] + 1e-9)
    for p in PHASES:
        assert rec["phases"][p]["seconds"] >= 0.0
        assert rec["phases"][p]["basis"] in ("measured", "modeled")
    assert rec["dominant_phase"] in PHASES


def _close_tree(a, b, rel=REL):
    """Equal dicts/lists, floats within ``rel``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        for k in a:
            _close_tree(a[k], b[k], rel)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close_tree(x, y, rel)
    elif isinstance(a, float) and isinstance(b, float):
        assert np.isclose(a, b, rtol=rel, atol=1e-12), (a, b)
    else:
        assert a == b, (a, b)


def _as_jax_names(doc, tff, jff):
    """``doc`` with the port's auto-named ops renamed as JAX's ops in the
    same place (the layer-name counters are process-global)."""
    import re

    txt = json.dumps(doc)
    pairs = sorted(((t.name, j.name) for t, j in zip(tff.compiled.ops, jff.compiled.ops)),
                   key=lambda p: -len(p[0]))
    for i, (tn, _) in enumerate(pairs):
        txt = re.sub(rf"\b{re.escape(tn)}\b", f"@@{i}@@", txt)
    for i, (_, jn) in enumerate(pairs):
        txt = txt.replace(f"@@{i}@@", jn)
    return json.loads(txt)


PROFILE = {"epochs": [{"steps": 4, "wall_s": 0.4, "input_wait_s": 0.02},
                      {"steps": 4, "wall_s": 0.02, "input_wait_s": 0.001}]}


# ------------------------------------------------- phase reconciliation
def test_attribution_reconciles_on_plain_mlp(tmp_path):
    ff = _mlp(tmp_path)
    x, y = _data()
    ff.fit(x, y, epochs=2, verbose=False)
    rec = attribution_report(ff)
    _assert_reconciles(rec)
    assert rec["pipelined"] is False
    assert ff.fit_profile["attribution"] is rec


@pytest.mark.parametrize("traced", [False, True])
def test_attribute_fit_equals_jax_on_the_same_profile(tmp_path, traced):
    """The same MLP, machine model and fit profile (and, traced, the same
    fit.step spans): JAX's report, phase for phase and op for op."""
    tff, jff = _mlp(tmp_path / "t"), _jmlp(tmp_path / "j")
    for ff in (tff, jff):
        ff.fit_profile = json.loads(json.dumps(PROFILE))
    if traced:
        for tr in (ttrace, jtrace):
            t = tr.configure_tracer(enabled=True)
            t.clear()
            for _ in range(4):
                t.complete("fit.step", 0.0, 0.003, cat="fit", args={"k": 1})
    _close_tree(_as_jax_names(attribute_fit(tff), tff, jff), jattr.attribute_fit(jff))


def test_attribute_fit_equals_jax_when_pipelined(tmp_path):
    """The pipeline profile's bubble fraction splits the residual as
    JAX's does (the pipeline block of the same record)."""
    tff, jff = _mlp(tmp_path / "t"), _jmlp(tmp_path / "j")
    prof = dict(json.loads(json.dumps(PROFILE)),
                pipeline={"bubble_fraction": 0.25, "dispatches_per_step": 9})
    for ff in (tff, jff):
        ff.fit_profile = json.loads(json.dumps(prof))
        ff.pipelined = object()
    try:
        t, j = attribute_fit(tff), jattr.attribute_fit(jff)
    finally:
        tff.pipelined = jff.pipelined = None
    _assert_reconciles(t)
    assert t["pipelined"] is True and t["phases"]["pipeline_bubble"]["seconds"] > 0
    _close_tree(_as_jax_names(t, tff, jff), j)


def test_predicted_phases_equal_jax_on_a_machine_model_file(tmp_path, monkeypatch):
    """_predicted_phases on the same graph under the same machine-model
    file: JAX's device phases and per-op costs (1e-9)."""
    from flexflow_tpu import sim as jsim

    p = tmp_path / "machine.json"
    p.write_text(json.dumps({"version": "simple", "chip": "test", "num_devices": 1}))
    tff = _mlp(tmp_path / "t", machine_model_file=str(p))
    jff = _jmlp(tmp_path / "j")
    monkeypatch.setattr(jsim, "detect_machine_model",
                        lambda *a, **k: jsim.load_machine_model(str(p)))
    (tp, tm, tc), (jp, jm, jc) = tattr._predicted_phases(tff), jattr._predicted_phases(jff)
    assert tm.chip.name == jm.chip.name == "test"
    _close_tree(tp, jp)
    for top, jop in zip(tff.compiled.ops, jff.compiled.ops):
        a, b = tc[top.name], jc[jop.name]
        assert np.allclose([a.forward_time, a.backward_time],
                           [b.forward_time, b.backward_time], rtol=REL, atol=0)


def test_predicted_phases_equal_jax_on_the_detected_machine(tmp_path):
    (tp, _, _), (jp, _, _) = (tattr._predicted_phases(_mlp(tmp_path / "t", hidden=(16, 32))),
                              jattr._predicted_phases(_jmlp(tmp_path / "j", hidden=(16, 32))))
    _close_tree(tp, jp)


def test_attribution_lands_in_ledger_record(tmp_path):
    ff = _mlp(tmp_path)
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    fit_recs = ledger.load_runs(str(tmp_path), kind="fit")
    assert fit_recs and fit_recs[-1]["attribution"]["reconciliation"]["reconciles"]


def test_attribution_off_and_mode_guard(tmp_path):
    ff = _mlp(tmp_path, attribution="off")
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    assert "attribution" not in ff.fit_profile and "advice" not in ff.fit_profile
    with pytest.raises(ValueError, match="attribution="):
        _mlp(tmp_path, attribution="bogus")


def test_profiling_prints_phase_table_and_top_suggestion(tmp_path, capsys):
    ff = _mlp(tmp_path, profiling=True)
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    out = capsys.readouterr().out
    assert "[attribution]" in out and "[advise]" in out
    for phase in PHASES:
        assert phase in out


@pytest.mark.parametrize("reconciles", [False, True])
def test_format_phase_table_equals_jax(reconciles):
    rec = {
        "measured_step_s": 0.01, "dominant_phase": "device_compute",
        "reconciliation": {"phase_sum_s": 0.005 if not reconciles else 0.01,
                           "reconciles": reconciles},
        "phase_order": ["device_compute", "input_wait"],
        "phases": {"device_compute": {"seconds": 0.005, "fraction": 0.5, "basis": "modeled"},
                   "input_wait": {"seconds": 0.005, "fraction": 0.5, "basis": "measured"}},
    }
    txt = tattr.format_phase_table(rec)
    assert txt == jattr.format_phase_table(rec)
    assert ("DOES NOT RECONCILE" in txt) == (not reconciles)


# ------------------------------------------------- top-k op ranking
def test_top_ops_ranking_is_stable_and_bounded(tmp_path):
    ff = _mlp(tmp_path, hidden=(16, 16), attribution_top_k=3)
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    a, b = attribute_fit(ff), attribute_fit(ff)
    assert len(a["top_ops"]) == 3 == a["top_k"]
    assert [r["name"] for r in a["top_ops"]] == [r["name"] for r in b["top_ops"]]
    keys = [r["predicted_ms"] for r in a["top_ops"]]
    assert keys == sorted(keys, reverse=True)
    for r in a["top_ops"]:
        assert r["provenance"].startswith("layer '")


def test_top_ops_join_measured_divergence_rows(tmp_path):
    ff = _mlp(tmp_path, divergence="on")
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    rec = attribution_report(ff)
    assert [r for r in rec["top_ops"] if r["measured_ms"] is not None]
    assert rec["divergence_outliers"]
    for r in rec["divergence_outliers"]:
        assert r["abs_error_ms"] == pytest.approx(abs(r["measured_ms"] - r["predicted_ms"]),
                                                  abs=1e-5)
    rows = ff.fit_profile["divergence"]["per_op"]
    assert any(r.get("measured_bwd_ms") is not None for r in rows)
    assert all("predicted_bwd_ms" in r for r in rows)


def test_divergence_outliers_equal_jax():
    rows = [{"name": n, "type": "linear", "provenance": f"layer '{n}'",
             "predicted_ms": p, "measured_ms": m, "ratio": None}
            for n, p, m in (("a", 1.0, 3.0), ("b", 2.0, 2.5), ("c", 0.5, None),
                            ("d", 4.0, 1.0), ("e", 1.0, 3.0))]
    assert tattr._divergence_outliers(rows, 3) == jattr._divergence_outliers(rows, 3)


# ------------------------------------------------- ledger per-op top-k
def test_ledger_truncates_per_op_rows_and_counts(tmp_path):
    ff = _mlp(tmp_path, hidden=(16, 16), divergence="on", ledger_per_op_topk=2)
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    n_ops = len(ff.compiled.ops)
    div = ledger.load_runs(str(tmp_path), kind="fit")[-1]["divergence"]
    assert len(div["per_op"]) == 2
    assert div["per_op_total"] == n_ops and div["per_op_truncated"] == n_ops - 2
    ranked = sorted(ff.fit_profile["divergence"]["per_op"],
                    key=lambda r: -(r.get("measured_ms") or 0.0))
    assert {r["name"] for r in div["per_op"]} == {r["name"] for r in ranked[:2]}


def test_ledger_topk_zero_keeps_no_rows_but_counts(tmp_path):
    ff = _mlp(tmp_path, divergence="on", ledger_per_op_topk=0)
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    n_ops = len(ff.compiled.ops)
    div = ledger.load_runs(str(tmp_path), kind="fit")[-1]["divergence"]
    assert "per_op" not in div
    assert div["per_op_total"] == n_ops == div["per_op_truncated"]
    assert len(ff.fit_profile["divergence"]["per_op"]) == n_ops


def test_divergence_for_ledger_equals_jax():
    from flexflow_tpu.obs import ledger as jledger

    div = {"e2e_ratio": 1.5, "per_op": [{"name": f"op{i}", "measured_ms": float(i % 3)}
                                        for i in range(6)]}
    cfg = T.FFConfig(device="cpu", ledger_per_op_topk=4)
    assert ledger._divergence_for_ledger(div, cfg) == jledger._divergence_for_ledger(div, cfg)


def test_host_dispatch_normalizes_multi_step_spans():
    """One fit.step span covers args.k steps: the estimate is
    sum(dur)/sum(k), and the window stops at the epoch's steps. JAX's
    figure on the same spans."""
    out = []
    for mod, tr in ((tattr, ttrace), (jattr, jtrace)):
        t = tr.configure_tracer(enabled=True)
        t.clear()
        t.complete("fit.step", 0.0, 5.0, cat="fit", args={"k": 1})
        for _ in range(2):
            t.complete("fit.step", 0.0, 0.004, cat="fit", args={"k": 4})
        out.append(mod._host_dispatch_s(1.0, 1, None, steps=8))
    assert out[0][1] == "measured"
    assert out[0][0] == pytest.approx(0.004 / 4, rel=1e-6)
    assert out[0] == out[1]


@pytest.mark.parametrize("stats", [
    {"serving_engine": "continuous", "model": "lm", "tokens_per_s": 12.5, "completed": 4,
     "knobs": {"decode_slots": 4}, "kv": {"in_use": 2},
     "phases": {"queue_wait": {"count": 4, "mean": 0.01, "p50": 0.01, "p99": 0.02},
                "prefill": {"count": 4, "mean": 0.03, "p50": 0.03, "p99": 0.05},
                "decode": {"count": 4, "mean": 0.2, "p50": 0.2, "p99": 0.3}}},
    {"phases": {"prefill": {"count": 1, "mean": 0.5}}},
    {"phases": {}}])
def test_serving_attribution_equals_jax(stats):
    assert tattr.serving_attribution(stats) == jattr.serving_attribution(stats)


# ----------------------------------------------------------- cost corpus
def test_corpus_rows_round_trip_and_dedupe(tmp_path):
    ff = _mlp()
    d = str(tmp_path / "corpus")
    rows = costcorpus.build_rows(ff, iters=2)
    assert len(rows) == len(ff.compiled.ops)
    for r in rows:
        assert r["schema"] == costcorpus.CORPUS_SCHEMA
        assert r["key"] and r["op_type"] and r["mesh"] is not None
        assert r["measured"]["forward_ms"] >= 0 and "backward_ms" in r["measured"]
    # linear, relu and softmax are all differentiable: each has a backward
    assert all(r["measured"]["backward_ms"] is not None for r in rows)
    out1 = costcorpus.append_rows(rows, dirpath=d)
    assert out1["appended"] == len(rows) and out1["duplicates"] == 0
    os.rename(os.path.join(d, f"corpus-{os.getpid()}.jsonl"),
              os.path.join(d, "corpus-99999.jsonl"))
    out2 = costcorpus.append_rows(costcorpus.build_rows(ff, iters=2), dirpath=d)
    assert out2["appended"] == 0 and out2["duplicates"] == len(rows)
    assert len(costcorpus.scan_corpus(d)["rows"]) == len(rows)
    got = costcorpus.load_rows(d, op_type="linear")
    assert got and all(r["op_type"] == "linear" for r in got)


def test_corpus_features_equal_jax(tmp_path):
    """Every row's features (op type, shapes, dtypes, shardings, mesh,
    flops, local bytes) and analytic prediction equal JAX's for the same
    graph (the prediction to 1e-9)."""
    from flexflow_tpu.obs import costcorpus as jcorpus
    from flexflow_tpu.obs.divergence import op_predictions as jpred
    from flexflow_tpu_torch.obs.divergence import op_predictions as tpred

    tff, jff = _mlp(tmp_path / "t", hidden=(16, 32)), _jmlp(tmp_path / "j", hidden=(16, 32))
    for top, jop in zip(tff.compiled.ops, jff.compiled.ops):
        tf = costcorpus.op_features(top, {})
        jf = jcorpus.op_features(jop, {})
        assert tf == jf
    tp, jp = tpred(tff), jpred(jff)
    for top, jop in zip(tff.compiled.ops, jff.compiled.ops):
        assert np.allclose(tp[top.name], jp[jop.name], rtol=REL, atol=0)


def test_corpus_tolerates_corrupt_lines(tmp_path):
    ff = _mlp()
    d = str(tmp_path / "corpus")
    costcorpus.append_rows(costcorpus.build_rows(ff, iters=1), dirpath=d)
    n = len(costcorpus.scan_corpus(d)["rows"])
    with open(os.path.join(d, f"corpus-{os.getpid()}.jsonl"), "a") as f:
        f.write('{"schema": 1, "key": "trunc')
        f.write("\nnot json\n")
        f.write('{"no_key_field": true}\n')
        f.write('{"schema": 7, "key": "future"}\n')
    scan = costcorpus.scan_corpus(d)
    assert len(scan["rows"]) == n and scan["corrupt_lines"] == 3
    assert scan["foreign_schema"] == 1


def test_corpus_fit_hook_and_mode_guard(tmp_path):
    d = str(tmp_path / "corpus")
    ff = _mlp(tmp_path, cost_corpus="on", cost_corpus_dir=d)
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    assert ff.fit_profile["cost_corpus"]["appended"] == len(ff.compiled.ops)
    assert os.path.isdir(d)
    assert costcorpus.corpus_mode(_mlp(tmp_path).config) == "off"
    with pytest.raises(ValueError, match="cost_corpus="):
        _mlp(tmp_path, cost_corpus="bogus")


def test_corpus_key_separates_shapes_not_measurements():
    ff_a, ff_b = _mlp(hidden=(16,)), _mlp(hidden=(32,))
    rows_a = costcorpus.build_rows(ff_a, iters=1)
    rows_a2 = costcorpus.build_rows(ff_a, iters=1)
    rows_b = costcorpus.build_rows(ff_b, iters=1)
    assert {r["key"] for r in rows_a} == {r["key"] for r in rows_a2}
    assert {r["key"] for r in rows_a} != {r["key"] for r in rows_b}


def test_corpus_merge_folds_rank_dirs_idempotently(tmp_path):
    rows = costcorpus.build_rows(_mlp(), iters=1)
    src_a, src_b, dst = (str(tmp_path / n) for n in ("rank-0", "rank-1", "cohort"))
    costcorpus.append_rows(rows, dirpath=src_a)
    costcorpus.append_rows(rows, dirpath=src_b)
    assert costcorpus.merge_corpus(src_a, dst) == len(rows)
    assert costcorpus.merge_corpus(src_b, dst) == 0
    assert costcorpus.merge_corpus(src_a, dst) == 0
    assert {r["key"] for r in costcorpus.scan_corpus(dst)["rows"]} == {r["key"] for r in rows}
    assert costcorpus.merge_corpus(str(tmp_path / "rank-9"), dst) == 0


def test_profile_ops_backward_timing(tmp_path):
    from flexflow_tpu_torch.runtime.profiling import profile_ops

    ff = _mlp(tmp_path)
    recs = profile_ops(ff, iters=2, warmup=1, backward=True)
    assert len(recs) == len(ff.compiled.ops)
    by_type = {r["type"]: r for r in recs}
    assert by_type["linear"]["backward_ms"] is not None
    assert by_type["linear"]["backward_ms"] >= 0.0
    assert all("backward_ms" not in r for r in profile_ops(ff, iters=1, warmup=0))


# ------------------------------------------------------------ obs server
def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_obs_server_endpoints_on_ephemeral_port(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_LEDGER_DIR", str(tmp_path))

    class Cfg:
        ledger = "on"
        ledger_dir = str(tmp_path)

    ledger.record_run("bench", {"label": "srv"}, config=Cfg())
    publish_attribution({"dominant_phase": "device_compute", "phases": {},
                         "reconciliation": {}})
    srv = ObsServer(port=0)
    try:
        port = srv.start()
        assert port > 0 and srv.running() and srv.start() == port
        st, ct, body = _get(port, "/metrics")
        assert st == 200 and ct.startswith("text/plain") and b"flexflow_" in body
        doc = json.loads(_get(port, "/healthz")[2])
        assert doc["pid"] == os.getpid() and "watched_age_s" in doc["watchdog"]
        doc = json.loads(_get(port, "/runs?n=5")[2])
        assert doc["total_runs"] >= 1 and any(r.get("label") == "srv" for r in doc["runs"])
        doc = json.loads(_get(port, "/trace")[2])
        assert "traceEvents" in doc and "metadata" in doc
        assert json.loads(_get(port, "/attribution")[2])["dominant_phase"] == "device_compute"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/bogus")
        assert e.value.code == 404
        assert json.loads(e.value.read())["endpoints"] == [
            "/metrics", "/healthz", "/runs", "/trace", "/attribution", "/advice", "/cohort"]
    finally:
        srv.stop()
    assert not srv.running() and srv.port is None


def test_obs_server_knob_validation_and_off_default():
    from flexflow_tpu_torch.obs.server import server_port_knob

    assert server_port_knob(T.FFConfig(device="cpu")) is None
    assert server_port_knob(T.FFConfig(device="cpu", obs_server_port=0)) == 0
    for bad in (-1, "http", 70000):
        with pytest.raises(ValueError, match="obs_server_port"):
            server_port_knob(T.FFConfig(device="cpu", obs_server_port=bad))


def test_configure_obs_server_ratchets_on():
    from flexflow_tpu_torch.obs.server import configure_obs_server, obs_server, stop_obs_server

    stop_obs_server()
    try:
        srv = configure_obs_server(T.FFConfig(device="cpu", obs_server_port=0))
        assert srv is not None and srv.running()
        port = srv.port
        srv2 = configure_obs_server(T.FFConfig(device="cpu"))
        assert srv2 is srv and srv.running() and srv.port == port
        assert _get(port, "/healthz")[0] == 200
        assert obs_server() is srv
    finally:
        stop_obs_server()
    assert obs_server() is None


def test_obs_server_runs_endpoint_honors_config_ledger_dir(tmp_path):
    from flexflow_tpu_torch.obs.server import configure_obs_server, stop_obs_server

    class Cfg:
        ledger = "on"
        ledger_dir = str(tmp_path)
        obs_server_port = 0

    ledger.record_run("bench", {"label": "cfg-dir"}, config=Cfg())
    stop_obs_server()
    try:
        srv = configure_obs_server(Cfg())
        doc = json.loads(_get(srv.port, "/runs")[2])
        assert doc["dir"] == str(tmp_path)
        assert any(x.get("label") == "cfg-dir" for x in doc["runs"])
    finally:
        stop_obs_server()


def test_configure_obs_server_port_conflict_is_loud(capsys):
    from flexflow_tpu_torch.obs.server import configure_obs_server, stop_obs_server

    stop_obs_server()
    try:
        srv = configure_obs_server(port=0)
        bound = srv.port
        srv2 = configure_obs_server(port=bound + 1)
        assert srv2 is srv and srv.port == bound
        assert "already serving" in capsys.readouterr().err
    finally:
        stop_obs_server()


def test_fit_publishes_attribution_and_advice_on_the_server(tmp_path):
    """A fit with obs_server_port=0 serves its own report and advice."""
    from flexflow_tpu_torch.obs.server import obs_server, stop_obs_server

    stop_obs_server()
    try:
        ff = _mlp(tmp_path, obs_server_port=0)
        x, y = _data()
        ff.fit(x, y, epochs=1, verbose=False)
        port = obs_server().port
        att = json.loads(_get(port, "/attribution")[2])
        assert att["measured_step_s"] == ff.fit_profile["attribution"]["measured_step_s"]
        adv = json.loads(_get(port, "/advice")[2])
        assert adv["suggestions"] == ff.fit_profile["advice"]["suggestions"]
        doc = json.loads(_get(port, "/runs")[2])
        assert [r["kind"] for r in doc["runs"]][-2:] == ["compile", "fit"]
    finally:
        stop_obs_server()


# ------------------------------------------- JAX's explain_run on port records
def test_explain_run_reads_port_records(tmp_path):
    ff = _mlp(tmp_path, divergence="on")
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "explain_run.py"), "--latest", "--json",
         "--ledger-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=240, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert doc["kind"] == "fit" and doc["exit"] == 0
    assert doc["reconciliation"]["reconciles"] is True
    assert set(doc["phases"]) == set(PHASES)


def test_host_dispatch_leaves_out_the_window_wait():
    """The departure: a fit.step span's ``wait_s`` (the host blocked on
    the dispatch-ahead window while the card ran an older step) is not
    host dispatch in the port; JAX's formula, which has no such argument,
    charges the whole span."""
    out = []
    for mod, tr in ((tattr, ttrace), (jattr, jtrace)):
        t = tr.configure_tracer(enabled=True)
        t.clear()
        for _ in range(4):
            t.complete("fit.step", 0.0, 0.010, cat="fit", args={"k": 1, "wait_s": 0.008})
        out.append(mod._host_dispatch_s(1.0, 1, None, steps=4))
    assert out[0][0] == pytest.approx(0.002, rel=1e-6) and out[0][1] == "measured"
    assert out[1][0] == pytest.approx(0.010, rel=1e-6)
