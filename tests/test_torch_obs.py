"""The port's flight recorder around fit and compile held to the JAX
package: the counterparts of ``tests/test_obs.py`` (18) for the
divergence record, the registry series fit feeds, the spans fit and
compile emit and the obs modes, and of ``tests/test_profiling_exports.py``
(7) for the graph exports, ``profile_ops`` and the ``runtime/profiling.py``
façade; and the ``train.stall`` fault site tripping an armed watchdog.
Both packages' tracers are restored off after every test (a JAX tracer
left on turns the reference's ``test_obs.py`` tracer test red)."""

import json
import os

import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.obs import trace as jtrace
from flexflow_tpu_torch.models.mlp import build_mlp
from flexflow_tpu_torch.obs import trace as ttrace
from flexflow_tpu_torch.obs.metrics import metrics_registry
from flexflow_tpu_torch.obs.watchdog import watchdog

REL = 1e-9


@pytest.fixture(autouse=True)
def _restore(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_LEDGER_DIR", str(tmp_path / "ledger"))
    yield
    ttrace.configure_tracer(enabled=False)
    jtrace.configure_tracer(enabled=False)
    ttrace.tracer().clear()
    watchdog().disarm()
    from flexflow_tpu_torch.runtime.faults import configure_faults

    configure_faults(None)


def _mlp(n_hidden=(16,), **cfg):
    ff = T.FFModel(T.FFConfig(batch_size=16, seed=0, device="cpu", **cfg))
    build_mlp(ff, 16, in_dim=8, hidden_dims=n_hidden, num_classes=4)
    ff.compile(optimizer=T.SGDOptimizer(lr=0.05),
               loss_type=T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
    return ff


def _data(n=64):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 8)).astype(np.float32),
            rng.integers(0, 4, size=(n, 1)).astype(np.int32))


# ------------------------------------------------------ spans and series
def test_fit_and_compile_emit_spans():
    tr = ttrace.configure_tracer(enabled=True)
    tr.clear()
    ff = _mlp()
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    ff.eval(x, y, verbose=False)
    names = {e["name"] for e in tr.events()}
    assert {"compile", "fit.step", "fit.host_sync", "fit.input_wait", "eval.step",
            "eval.host_sync", "eval.input_wait"} <= names
    assert ttrace.validate_chrome_trace({"traceEvents": tr.events()}) == []
    steps = [e for e in tr.events() if e["name"] == "fit.step"]
    assert len(steps) == 4 and all(e["args"] == {"k": 1} for e in steps)


def test_fit_step_spans_carry_k_under_multi_step_dispatch():
    tr = ttrace.configure_tracer(enabled=True)
    tr.clear()
    ff = _mlp(steps_per_dispatch=2)
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    ks = [e["args"]["k"] for e in tr.events() if e["name"] == "fit.step"]
    assert sum(ks) == 4 and ks == [2, 2]


def test_fit_feeds_registry_counters():
    reg = metrics_registry()
    before = reg.counter("fit.steps").value
    ff = _mlp()
    x, y = _data()
    ff.fit(x, y, epochs=2, verbose=False)
    assert reg.counter("fit.steps").value - before == 8
    for name in ("fit.input_wait_s", "fit.queue_depth", "fit.inflight_steps"):
        assert reg.get(name) is not None
    assert reg.gauge("fit.steps_per_s").value > 0


def test_epoch_records_equal_jax_shape():
    """fit_profile's epoch records carry JAX's EpochThroughput fields, with
    the same step counts, depth histogram and window occupancy."""
    import jax

    from flexflow_tpu.core.machine import make_mesh
    from flexflow_tpu.models.mlp import build_mlp as jbuild

    jff = J.FFModel(J.FFConfig(batch_size=16, seed=0, audit_programs="off", prefetch_depth=2))
    jbuild(jff, 16, in_dim=8, hidden_dims=(16,), num_classes=4)
    jff.compile(optimizer=J.SGDOptimizer(lr=0.05),
                loss_type=J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    tff = _mlp(prefetch_depth=2)
    x, y = _data()
    for ff in (jff, tff):
        ff.fit(x, y, epochs=2, verbose=False)
    for je, te in zip(jff.fit_profile["epochs"], tff.fit_profile["epochs"]):
        assert je.keys() == te.keys()
        assert (te["steps"], te["dispatch_ahead_occupancy"]) == \
            (je["steps"], je["dispatch_ahead_occupancy"])
        assert sum(te["queue_depth_hist"].values()) == sum(je["queue_depth_hist"].values())
    assert {k for k in tff.fit_profile if k != "epochs"} >= \
        {"steps_per_s", "prefetch_depth", "max_inflight_steps", "steps_per_dispatch"}


# -------------------------------------------------------------- divergence
def test_divergence_record_on_two_op_mlp_fit():
    from flexflow_tpu_torch.runtime.profiling import divergence_report

    ff = _mlp(n_hidden=(), divergence="on")
    assert len(ff.compiled.ops) == 2
    x, y = _data()
    ff.fit(x, y, epochs=2, verbose=False)
    d = divergence_report(ff)
    assert d["source"] == "simulator"
    assert d["predicted_step_s"] > 0 and d["measured_step_s"] > 0
    assert d["e2e_ratio"] == pytest.approx(d["measured_step_s"] / d["predicted_step_s"],
                                           rel=1e-3)
    assert len(d["epoch_ratios"]) == 2
    assert {r["name"] for r in d["per_op"]} == {op.name for op in ff.compiled.ops}
    for r in d["per_op"]:
        assert r["measured_ms"] >= 0 and r["ratio"] is not None
        assert r["measured_bwd_ms"] is not None and r["predicted_bwd_ms"] > 0


def test_predicted_step_time_equals_jax():
    """The simulator's replay over the same two-op MLP: JAX's prediction
    (1e-9); a search's estimate when one ran."""
    import jax

    from flexflow_tpu.core.machine import make_mesh
    from flexflow_tpu.models.mlp import build_mlp as jbuild
    from flexflow_tpu.obs.divergence import predicted_step_time as jpred
    from flexflow_tpu_torch.obs.divergence import predicted_step_time as tpred

    jff = J.FFModel(J.FFConfig(batch_size=16, seed=0, audit_programs="off"))
    jbuild(jff, 16, in_dim=8, hidden_dims=(16, 32), num_classes=4)
    jff.compile(optimizer=J.SGDOptimizer(lr=0.05),
                loss_type=J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    (t, ts), (j, js) = tpred(_mlp(n_hidden=(16, 32))), jpred(jff)
    assert ts == js == "simulator" and np.isclose(t, j, rtol=REL, atol=0)
    ff = _mlp(search_budget=1)
    assert tpred(ff) == (ff.search_profile["est_step_time"], "search")


def test_divergence_obs001_fires_past_threshold(capsys):
    ff = _mlp(n_hidden=(), divergence="e2e", divergence_threshold=0.0)
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    d = ff.fit_profile["divergence"]
    assert d["threshold"] == 0.0
    assert d["findings"] and d["findings"][0]["code"] == "OBS001"
    assert d["findings"][0]["severity"] == "warning"
    assert ff.obs_report is not None and not ff.obs_report.errors
    assert "OBS001" in capsys.readouterr().out
    assert "per_op" not in d


def test_stale_obs001_cleared_by_next_fit(capsys):
    ff = _mlp(n_hidden=(), divergence="e2e", divergence_threshold=0.0)
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    assert ff.obs_report is not None
    ff.config.divergence = "off"
    ff.fit(x, y, epochs=1, verbose=False)
    assert ff.obs_report is None
    capsys.readouterr()


def test_divergence_off_by_default_and_mode_guard():
    ff = _mlp()
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    assert "divergence" not in ff.fit_profile
    ff2 = _mlp(divergence="bogus")
    with pytest.raises(ValueError, match="divergence="):
        ff2.fit(x, y, epochs=1, verbose=False)


def test_obs_codes_in_catalog_equal_jax():
    from flexflow_tpu.analysis import CODE_CATALOG as JCAT
    from flexflow_tpu_torch.analysis import CODE_CATALOG

    # the whole catalog since the port's static analysis (every code the
    # JAX package has, the AUD/HOT002/OBS002 texts reworded for the port)
    assert set(CODE_CATALOG) == set(JCAT)
    assert {"OBS001", "OBS002", "OBS003"} <= set(CODE_CATALOG)
    assert CODE_CATALOG["OBS001"] == JCAT["OBS001"]
    assert CODE_CATALOG["OBS003"] == JCAT["OBS003"]


def test_layer_provenance_equals_jax():
    from flexflow_tpu.analysis.findings import layer_provenance as jprov
    from flexflow_tpu_torch.analysis.findings import layer_provenance

    from flexflow_tpu.core.layer import Layer as JLayer
    from flexflow_tpu.ffconst import OpType as JOpType
    from flexflow_tpu_torch.core.layer import Layer

    for layer in (Layer(T.OpType.LINEAR, name="d"),
                  Layer(T.OpType.LINEAR, name="m", attrs={"_origin_rewrite": "json:fuse"})):
        jl = JLayer(JOpType.LINEAR, name=layer.name, attrs=dict(layer.attrs))
        assert layer_provenance(layer) == jprov(jl)


def test_parse_args_obs_flags_equal_jax():
    argv = ["--divergence", "on", "--divergence-threshold", "0.5", "--ledger", "off",
            "--ledger-dir", "/tmp/l", "--exec-telemetry", "--exec-mem-threshold", "2.0",
            "--attribution", "off", "--attribution-top-k", "3", "--advisor", "off",
            "--advisor-max-suggestions", "2", "--cost-corpus", "--cost-corpus-dir", "/tmp/c",
            "--obs-server-port", "0", "--ledger-per-op-topk", "4", "--cohort-obs",
            "--cohort-skew-threshold", "0.3", "--cohort-obs-dir", "/tmp/o", "--watchdog",
            "--watchdog-threshold", "5", "--watchdog-dir", "/tmp/b", "--compgraph", "/tmp/g",
            "--taskgraph", "/tmp/t", "--include-costs-dot-graph"]
    t, j = T.FFConfig.parse_args(argv), J.FFConfig.parse_args(argv)
    for k in ("divergence", "divergence_threshold", "ledger", "ledger_dir", "exec_telemetry",
              "exec_mem_threshold", "attribution", "attribution_top_k", "advisor",
              "advisor_max_suggestions", "cost_corpus", "cost_corpus_dir", "obs_server_port",
              "ledger_per_op_topk", "cohort_obs", "cohort_skew_threshold", "cohort_obs_dir",
              "watchdog", "watchdog_threshold_s", "watchdog_dir",
              "export_strategy_computation_graph_file", "export_strategy_task_graph_file",
              "include_costs_dot_graph"):
        assert getattr(t, k) == getattr(j, k), k
        assert getattr(T.FFConfig(), k) == getattr(J.FFConfig(), k), k


# ---------------------------------------------------------------- watchdog
def test_train_stall_trips_the_armed_watchdog(tmp_path):
    """The train.stall site sleeps inside the step loop: past the armed
    watchdog's threshold a black-box dump names fit.loop, with every
    thread's stack (the sleeping step among them) and the tracer's tail."""
    bb = tmp_path / "bb"
    ttrace.configure_tracer(enabled=True)
    ff = _mlp(watchdog="on", watchdog_threshold_s=0.3, watchdog_dir=str(bb),
              fault_plan={"schema": 1, "sites": {"train.stall": {"at_step": 2,
                                                               "stall_s": 1.5}}})
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    dumps = sorted(os.listdir(bb))
    boxes = [n for n in dumps if n.startswith("blackbox-")]
    assert len(boxes) == 1, dumps
    doc = json.load(open(bb / boxes[0]))
    assert doc["reason"] == "stall" and "fit.loop" in doc["stalled"]
    assert doc["stalled"]["fit.loop"] >= 0.3
    main = [v for k, v in doc["threads"].items() if k.startswith("MainThread")]
    assert main and any("sleep" in ln for ln in main[0])
    assert any(e["name"] == "fit.step" for e in doc["trace_tail"])
    assert ff.fit_profile["epochs"][0]["steps"] == 4


def test_prefetch_worker_is_watched(tmp_path):
    ff = _mlp(watchdog="on", watchdog_threshold_s=60.0, watchdog_dir=str(tmp_path),
              prefetch_depth=2)
    x, y = _data()
    before = watchdog().stats()["dumps"]
    ff.fit(x, y, epochs=1, verbose=False)
    st = watchdog().stats()
    assert {"fit.loop", "prefetch.worker"} <= set(st["sources_seen"])
    assert st["dumps"] == before
    ff.eval(x, y, verbose=False)
    assert "eval.loop" in watchdog().stats()["sources_seen"]


def test_serving_worker_is_watched(tmp_path):
    from flexflow_tpu_torch import CompMode
    from flexflow_tpu_torch.serving import InferenceEngine

    ff = T.FFModel(T.FFConfig(batch_size=4, device="cpu", watchdog="on",
                              watchdog_threshold_s=60.0, watchdog_dir=str(tmp_path),
                              computation_mode=CompMode.INFERENCE))
    build_mlp(ff, 4, in_dim=8, hidden_dims=(16,), num_classes=4)
    ff.compile()
    eng = InferenceEngine()
    eng.register_ffmodel(ff, "m")
    for _ in range(3):
        futs = [eng.infer_async("m", [np.zeros(8, np.float32)]) for _ in range(4)]
        [f.result(60) for f in futs]
    eng.stop()
    assert "serving.m.0" in watchdog().stats()["sources_seen"]


# ------------------------------------------------------ profiling exports
def test_compgraph_export(tmp_path):
    ff = _mlp()
    p = str(tmp_path / "graph.dot")
    ff.export_computation_graph(p, include_costs=True)
    s = open(p).read()
    assert s.startswith("digraph") and "mlp_dense0" in s and "->" in s and "ms" in s


def test_taskgraph_export_dot_and_json(tmp_path):
    ff = _mlp()
    pd, pj = str(tmp_path / "tg.dot"), str(tmp_path / "tg.json")
    ff.export_task_graph(pd, fmt="dot")
    ff.export_task_graph(pj, fmt="json")
    assert open(pd).read().startswith("digraph")
    payload = json.load(open(pj))
    assert payload["total_time_s"] > 0
    names = [t["name"] for t in payload["tasks"]]
    assert any(n.endswith(":fwd") for n in names) and any(n.endswith(":bwd") for n in names)
    assert "grad_sync" in names


def test_exports_via_config_flags(tmp_path):
    cg, tg = str(tmp_path / "cg.dot"), str(tmp_path / "tg.dot")
    cfg = T.FFConfig.parse_args(["--compgraph", cg, "--taskgraph", tg])
    cfg.device, cfg.batch_size = "cpu", 16
    ff = T.FFModel(cfg)
    build_mlp(ff, 16, in_dim=8, hidden_dims=(16,), num_classes=4)
    ff.compile(optimizer=T.SGDOptimizer(lr=0.01),
               loss_type=T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
    assert os.path.exists(cg) and os.path.exists(tg)


def test_profile_ops_records():
    ff = _mlp()
    recs = ff.profile_ops(iters=2)
    assert len(recs) == len(ff.compiled.ops)
    assert all(r["forward_ms"] >= 0.0 for r in recs)
    dense = [r for r in recs if r["type"] == "linear"]
    assert dense and all(r["flops"] > 0 for r in dense)


def test_profiling_facade_reexports_flight_recorder():
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.runtime import profiling

    assert profiling.Tracer is obs.Tracer and profiling.tracer() is obs.tracer()
    assert profiling.span is obs.span
    assert profiling.configure_tracer is obs.configure_tracer
    assert profiling.validate_chrome_trace is obs.validate_chrome_trace
    assert profiling.MetricsRegistry is obs.MetricsRegistry
    assert profiling.metrics_registry() is obs.metrics_registry()
    assert profiling.EpochThroughput is obs.EpochThroughput
    assert profiling.divergence_report is obs.divergence_report
    assert profiling.record_divergence is obs.record_divergence
    assert profiling.predicted_step_time is obs.predicted_step_time
    assert profiling.attribute_fit is obs.attribute_fit
    assert profiling.ObsServer is obs.ObsServer and profiling.Watchdog is obs.Watchdog


def test_obs_exports_match_jax():
    """Everything the JAX package's ``obs`` exports, the port's does."""
    import flexflow_tpu.obs as jobs
    import flexflow_tpu_torch.obs as tobs

    jnames = {n for n in dir(jobs) if not n.startswith("_") and
              getattr(getattr(jobs, n), "__module__", "").startswith("flexflow_tpu.obs")}
    assert jnames <= set(dir(tobs)), sorted(jnames - set(dir(tobs)))


def test_simulator_last_tasks_public_accessor():
    from flexflow_tpu_torch.sim import OpCostModel, Simulator, detect_machine_model

    ff = _mlp()
    machine = detect_machine_model(1, device="cpu")
    sim = Simulator(machine, OpCostModel(machine))
    assert sim.last_tasks() == []
    sim.simulate_runtime(ff.compiled.ops)
    tasks = sim.last_tasks()
    assert tasks and any(t.name == "grad_sync" for t in tasks)
    tasks.clear()
    assert sim.last_tasks()


def test_profiler_trace_writes_a_trace(tmp_path):
    ff = _mlp()
    x, y = _data(16)
    with ff.profiler_trace(str(tmp_path / "tb")):
        ff.fit(x, y, epochs=1, verbose=False)
    files = [f for _, _, fs in os.walk(tmp_path / "tb") for f in fs]
    assert any(f.endswith(".json") or f.endswith(".json.gz") for f in files), files


# -------------------------------------------------- the repaired defaults
def test_detect_machine_model_and_pool_take_the_card_by_default():
    """Given no device they take FFConfig's default, the card, and raise
    on a box without one, as FFConfig.torch_device does; device='cpu'
    still builds them."""
    import torch

    from flexflow_tpu_torch.serving.kv_cache import PagedKVPool
    from flexflow_tpu_torch.sim import detect_machine_model

    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default builds on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_machine_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVPool({"a": (2, 4)}, num_blocks=3, block_size=4, max_blocks_per_request=2)
    assert detect_machine_model(device="cpu").chip.name == "cpu-host"
    pool = PagedKVPool({"a": (2, 4)}, num_blocks=3, block_size=4, max_blocks_per_request=2,
                       device="cpu")
    assert pool.kv["a"][0].device.type == "cpu"
