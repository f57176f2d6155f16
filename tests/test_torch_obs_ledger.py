"""The port's durable observability (``flexflow_tpu_torch/obs/ledger.py``,
``exec_telemetry.py``, ``watchdog.py``) held to the JAX package: the
counterparts of ``tests/test_obs_ledger.py``'s 24 tests. The ledger's
append, load, corrupt-line tolerance and run-id merge equal JAX's on the
same records; a small Transformer's compile and fit records equal JAX's on
the same graph in every field but the measured times and the fingerprint
(schema, knobs, model context, ``cohort_key`` less the machine, search
outcome); JAX's regression sentinel (``tools/perf_sentinel.py``) judges
the port's records as it judges its own. The departures, each shown here:
the fingerprint reads ``torch.cuda``; on one device the port's compiled
model has no mesh, so its records carry no ``mesh`` block (JAX's say
``{"data": 1}``); executable telemetry is one measured step
(``FlopCounterMode`` flops, the card's peak bytes, ``null`` on the CPU)
instead of XLA's analyses; the compile record's ``audit`` block (the
port's program audit, on by default) adds the recorded calls'
``record_s``."""

import functools
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.obs import ledger as jledger
from flexflow_tpu_torch.models.mlp import build_mlp
from flexflow_tpu_torch.obs import ledger
from flexflow_tpu_torch.obs.exec_telemetry import reconcile_peak_memory
from flexflow_tpu_torch.obs.metrics import metrics_registry
from flexflow_tpu_torch.obs.watchdog import Watchdog, watchdog

REL = 1e-9  # the simulator's predictions, relative
SHAPE = dict(hidden_size=16, embedding_size=16, num_heads=2, num_layers=1,
             sequence_length=8)
BATCH = 8


def _mlp(tmp_path=None, hidden=(16,), **cfg):
    if tmp_path is not None:
        cfg.setdefault("ledger_dir", str(tmp_path))
    ff = T.FFModel(T.FFConfig(batch_size=16, seed=0, device="cpu", **cfg))
    build_mlp(ff, 16, in_dim=8, hidden_dims=hidden, num_classes=4)
    ff.compile(optimizer=T.SGDOptimizer(lr=0.05),
               loss_type=T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
    return ff


def _data(n=64):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(n, 1)).astype(np.int32)
    return x, y


class _Cfg:
    ledger = "on"

    def __init__(self, d):
        self.ledger_dir = str(d)


# ------------------------------------------------------------------ ledger
def test_ledger_record_load_round_trip(tmp_path):
    doc = ledger.record_run("bench", {"label": "t", "perf": {"metric": "m", "value": 2.0}},
                            config=_Cfg(tmp_path))
    assert doc["schema"] == ledger.LEDGER_SCHEMA == jledger.LEDGER_SCHEMA
    assert doc["kind"] == "bench" and doc["run_id"] and doc["pid"]
    assert doc["machine"]["devices"] >= 1 and doc["machine"]["backend"] == "cpu"
    ledger.record_run("fit", {"label": "u"}, config=_Cfg(tmp_path))
    runs = ledger.load_runs(str(tmp_path))
    assert [r["kind"] for r in runs] == ["bench", "fit"]
    assert ledger.load_runs(str(tmp_path), kind="bench")[0]["label"] == "t"
    assert ledger.filter_runs(runs, label="u")[0]["kind"] == "fit"
    doc2 = ledger.record_run("bench", {"schema": 999}, config=_Cfg(tmp_path))
    assert doc2["schema"] == ledger.LEDGER_SCHEMA
    assert ledger.last_record()["run_id"] == doc2["run_id"]
    # the JAX reader loads the port's records as its own
    assert [r["run_id"] for r in jledger.load_runs(str(tmp_path))] == \
        [r["run_id"] for r in ledger.load_runs(str(tmp_path))]


def test_ledger_tolerates_corrupt_lines(tmp_path):
    for i in range(3):
        ledger.record_run("bench", {"i": i}, config=_Cfg(tmp_path))
    path = os.path.join(str(tmp_path), f"runs-{os.getpid()}.jsonl")
    with open(path, "a") as f:
        f.write('{"schema": 1, "kind": "ben')
        f.write("\nnot json at all\n")
        f.write("[1, 2, 3]\n")
        f.write('{"no_schema_field": true}\n')
        f.write('{"schema": 2, "kind": "future"}\n')
    scan, jscan = ledger.scan_ledger(str(tmp_path)), jledger.scan_ledger(str(tmp_path))
    assert len(scan["runs"]) == 3 and scan["corrupt_lines"] == 4
    assert scan["foreign_schema"] == 1
    assert {k: v for k, v in scan.items() if k != "runs"} == \
        {k: v for k, v in jscan.items() if k != "runs"}
    assert sorted(r["i"] for r in scan["runs"]) == [0, 1, 2]


def test_ledger_merge_dedupes_by_run_id(tmp_path):
    """merge_runs equals JAX's: the new records only, idempotent."""
    out = {}
    for name, mod in (("port", ledger), ("jax", jledger)):
        src, dst = tmp_path / name / "src", tmp_path / name / "dst"
        a = ledger.record_run("bench", {"x": 1}, config=_Cfg(src))
        ledger.record_run("bench", {"x": 2}, config=_Cfg(src))
        ledger.record_run("bench", {"x": 3}, config=_Cfg(dst))
        with open(os.path.join(str(dst), "runs-dup.jsonl"), "w") as f:
            f.write(json.dumps(a) + "\n")
        first = mod.merge_runs(str(src), str(dst))
        runs = mod.scan_ledger(str(dst))["runs"]
        out[name] = (first, sorted(r["x"] for r in runs), len({r["run_id"] for r in runs}),
                     mod.merge_runs(str(src), str(dst)))
    assert out["port"] == out["jax"] == (1, [1, 2, 3], 3, 0)


def test_merged_records_do_not_become_last_record(tmp_path):
    mine = ledger.record_run("bench", {"x": 0}, config=_Cfg(tmp_path / "me"))
    ledger.record_run("bench", {"x": 1}, config=_Cfg(tmp_path / "other"))
    ledger.record_run("bench", {"x": 2}, config=_Cfg(tmp_path / "me"))
    assert ledger.merge_runs(str(tmp_path / "other"), str(tmp_path / "me")) == 1
    assert ledger.last_record()["x"] == 2 and mine["x"] == 0


def test_fit_appends_compile_and_fit_records(tmp_path):
    ff = _mlp(tmp_path, divergence="e2e")
    x, y = _data()
    dumps = watchdog().stats()["dumps"]  # process-wide: earlier tests' stalls
    ff.fit(x, y, epochs=2, verbose=False)
    ff.eval(x, y, verbose=False)
    runs = ledger.load_runs(str(tmp_path))
    assert [r["kind"] for r in runs] == ["compile", "fit", "eval"]
    comp, fit, ev = runs
    assert comp["model_sig"] and comp["n_ops"] == len(ff.compiled.ops)
    assert comp["exec"] == {"unavailable": "exec_telemetry=off"}
    assert comp["knobs"]["batch_size"] == 16
    assert fit["model_sig"] == comp["model_sig"]
    assert fit["throughput"]["epochs"] and fit["throughput"]["steps_per_s"]
    assert fit["divergence"]["e2e_ratio"]
    assert fit["perf"]["metric"] == "fit.steps_per_s" and fit["perf"]["value"] > 0
    assert "fit.steps" in fit["metrics"]
    assert fit["watchdog"]["dumps"] == dumps
    assert fit["attribution"]["reconciliation"]["reconciles"]
    assert fit["advice"]["suggestions"]
    assert fit["resume"] == {"iteration": 8}
    assert ev["perf"]["metric"] == "eval.steps_per_s"


def test_ledger_off_and_mode_guard(tmp_path):
    ff = _mlp(tmp_path, ledger="off")
    x, y = _data()
    ff.fit(x, y, epochs=1, verbose=False)
    assert ledger.scan_ledger(str(tmp_path))["runs"] == []
    with pytest.raises(ValueError, match="ledger="):
        _mlp(tmp_path, ledger="bogus")


@pytest.mark.parametrize("knob,bad", [("divergence", "sometimes"), ("attribution", "yes"),
                                      ("cost_corpus", "maybe"), ("cohort_obs", "1")])
def test_fit_mode_typos_raise_before_training(tmp_path, knob, bad):
    """A mistyped mode fails at fit's entry, before a step runs (the
    compile-time ones at compile)."""
    ff = _mlp(tmp_path)
    setattr(ff.config, knob, bad)
    x, y = _data()
    with pytest.raises(ValueError, match=f"{knob}="):
        ff.fit(x, y, epochs=1, verbose=False)
    assert ff.compiled.iteration == 0


# --------------------------------------------- records against JAX's records
@functools.lru_cache(maxsize=None)
def _cached_pair(search_budget: int):
    """One (JAX, port) pair a search budget for the file, compiled once
    (JAX's compile is the slow part) into ledgers of its own."""
    d = pathlib.Path(tempfile.mkdtemp(prefix="ff_ledger_pair_"))
    return d, _pair(d, search_budget=search_budget)


def _pair(tmp_path, **kw):
    """(JAX model, port model), the same small Transformer compiled on one
    device with the same search, each writing its own ledger."""
    import jax

    from flexflow_tpu.core.machine import make_mesh
    from flexflow_tpu.models.transformer import TransformerConfig as JTC
    from flexflow_tpu.models.transformer import build_transformer as jbuild
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer

    jff = J.FFModel(J.FFConfig(batch_size=BATCH, ledger_dir=str(tmp_path / "jax"),
                               audit_programs="off", **kw))
    jbuild(jff, BATCH, JTC(**SHAPE))
    jff.compile(optimizer=J.SGDOptimizer(lr=0.01),
                loss_type=J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    tff = T.FFModel(T.FFConfig(batch_size=BATCH, device="cpu",
                               ledger_dir=str(tmp_path / "port"), **kw))
    build_transformer(tff, BATCH, TransformerConfig(**SHAPE))
    tff.compile(optimizer=T.SGDOptimizer(lr=0.01),
                loss_type=T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    return jff, tff


def _tdata(n=16):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, SHAPE["sequence_length"], SHAPE["hidden_size"]))
    y = rng.normal(size=(n, SHAPE["sequence_length"], 1))
    return x.astype(np.float32), y.astype(np.float32)


_ENVELOPE = ("run_id", "ts_unix_s", "pid", "machine", "wall_s", "pytest")


def _strip(rec, *more):
    return {k: v for k, v in rec.items() if k not in _ENVELOPE + more}


def _cohort_less_machine(rec):
    key = json.loads(ledger.cohort_key(rec))
    return key[:5] + key[6:]


def test_compile_record_equals_jax():
    d, _ = _cached_pair(0)
    j = jledger.load_runs(str(d / "jax"), kind="compile")[0]
    t = ledger.load_runs(str(d / "port"), kind="compile")[0]
    assert j["mesh"] == {"data": 1} and "mesh" not in t  # one device: no mesh
    # the port's compile runs the program audit by default (the JAX side
    # compiles with it off here, for speed): its block names the programs
    assert "audit" not in j
    assert t["audit"]["programs"] == ["eval_step", "train_step"]
    assert t["audit"]["errors"] == 0 and t["audit"]["record_s"] > 0
    assert _strip(t, "audit") == _strip(j, "mesh", "audit")
    assert _cohort_less_machine(t) == _cohort_less_machine(j)[:3] + [[]] + \
        _cohort_less_machine(j)[4:]


def test_compile_record_with_search_equals_jax():
    """The search outcome block: every counter and the estimate equal
    JAX's (the estimate to 1e-9); only the search's wall time differs."""
    d, _ = _cached_pair(1)
    j = jledger.load_runs(str(d / "jax"), kind="compile")[0]
    t = ledger.load_runs(str(d / "port"), kind="compile")[0]
    js, ts = dict(j["search"]), dict(t["search"])
    # the port's search profile also names the pipeline schedule it chose
    # (None off a pipe axis)
    assert ts.pop("pipe_schedule") is None
    assert set(js) == set(ts)
    assert np.isclose(ts.pop("est_step_time"), js.pop("est_step_time"), rtol=REL, atol=0)
    for k in ("search_time_s", "est_memory"):
        js.pop(k, None), ts.pop(k, None)
    assert ts == js
    assert t["audit"]["programs"] == ["eval_step", "train_step"]
    assert _strip(t, "search", "audit") == _strip(j, "mesh", "audit", "search")


def test_fit_record_equals_jax():
    d, (jff, tff) = _cached_pair(0)
    x, y = _tdata()
    for ff in (jff, tff):
        ff.fit(x, y, epochs=2, verbose=False)
    j = jledger.load_runs(str(d / "jax"), kind="fit")[-1]
    t = ledger.load_runs(str(d / "port"), kind="fit")[-1]
    measured = ("wall_s", "steps_per_s", "input_wait_s", "input_mb_per_s")
    assert set(t) == set(j) - {"mesh"}
    for rec in (t, j):
        tp = rec["throughput"]
        for k in ("steps_per_s",):
            assert tp.pop(k) > 0
        for e in tp["epochs"]:
            for k in measured:
                assert e.pop(k) >= 0
    assert t["throughput"] == j["throughput"]
    assert t["perf"]["metric"] == j["perf"]["metric"] == "fit.steps_per_s"
    assert t["resume"] == j["resume"] and t["resume"]["iteration"] % 4 == 0
    assert t["watchdog"].keys() == j["watchdog"].keys()
    for k in ("knobs", "knobs_cover", "model_sig", "n_ops"):
        assert t[k] == j[k]
    assert _cohort_less_machine(t)[:3] == _cohort_less_machine(j)[:3]


def test_fit_record_attribution_blocks_equal_jax():
    """The record's predicted phases and its top ops' predictions equal
    JAX's on the same graph (1e-9); the measured split reconciles in
    both."""
    d, (jff, tff) = _cached_pair(0)
    x, y = _tdata()
    for ff in (jff, tff):
        ff.fit(x, y, epochs=2, verbose=False)
    j = jledger.load_runs(str(d / "jax"), kind="fit")[-1]["attribution"]
    t = ledger.load_runs(str(d / "port"), kind="fit")[-1]["attribution"]
    assert t["phase_order"] == j["phase_order"]
    assert t.keys() == j.keys()
    for k, v in j["predicted_step_s"].items():
        assert np.isclose(t["predicted_step_s"][k], v, rtol=REL, atol=0)
    assert [r["name"] for r in t["top_ops"]] == [r["name"] for r in j["top_ops"]]
    assert np.allclose([r["predicted_ms"] for r in t["top_ops"]],
                       [r["predicted_ms"] for r in j["top_ops"]], rtol=REL, atol=0)
    assert t["reconciliation"]["reconciles"] and j["reconciliation"]["reconciles"]


def test_per_op_rows_capped_and_counted(tmp_path):
    ff = _mlp(tmp_path, divergence="on", ledger_per_op_topk=1, hidden=(16, 16))
    x, y = _data()
    before = metrics_registry().counter("ledger.per_op_truncated").value
    ff.fit(x, y, epochs=1, verbose=False)
    fit = ledger.load_runs(str(tmp_path), kind="fit")[-1]
    div = fit["divergence"]
    assert len(div["per_op"]) == 1 and div["per_op_total"] == len(ff.compiled.ops)
    assert div["per_op_truncated"] == len(ff.compiled.ops) - 1
    assert metrics_registry().counter("ledger.per_op_truncated").value > before
    assert len(ff.fit_profile["divergence"]["per_op"]) == len(ff.compiled.ops)


def test_machine_fingerprint_reads_torch():
    fp = ledger.machine_fingerprint()
    import torch

    assert fp["torch"] == torch.__version__ and fp["cuda"] == torch.version.cuda
    assert fp["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert fp["world_size"] >= 1 and "jax" not in fp
    assert {"host", "devices", "py"} <= set(fp)


def test_record_run_stamps_pytest_only_in_shared_corpus(tmp_path, monkeypatch):
    monkeypatch.delenv("FLEXFLOW_TPU_LEDGER_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    doc = ledger.record_run("fit", {"model_sig": "cafe"})
    assert doc is not None
    assert doc["pytest"].startswith("tests/test_torch_obs_ledger.py")
    doc = ledger.record_run("fit", {"model_sig": "cafe"},
                            config=T.FFConfig(device="cpu", ledger_dir=str(tmp_path / "own")))
    assert doc is not None and "pytest" not in doc


def test_locked_append_under_threads(tmp_path):
    """Eight writers, one file a process: every line whole, none lost."""
    import threading

    def write(i):
        for k in range(25):
            ledger.record_run("bench", {"w": i, "k": k}, config=_Cfg(tmp_path))

    ts = [threading.Thread(target=write, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    scan = ledger.scan_ledger(str(tmp_path))
    assert len(scan["runs"]) == 200 and scan["corrupt_lines"] == 0


def test_record_bench_and_sentinel_judge_port_records(tmp_path):
    """The JAX package's regression sentinel judges bench records the port
    wrote: a 2.5x drop is a regression, a steady trend is not."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "perf_sentinel", os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                                      "perf_sentinel.py"))
    sent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sent)
    for i, v in enumerate((10.0, 10.5, 9.8, 4.0)):
        ledger.record_bench("torch_bench", {"v": v}, label="m1", knobs={"batch": 64},
                            perf={"metric": "steps_per_s", "value": v, "higher_is_better": True},
                            config=_Cfg(tmp_path))
        time.sleep(0.002)
    out = sent.run_sentinel(ledger_dir=str(tmp_path), margin=0.2,
                            blackbox_dir=str(tmp_path / "bb"))
    assert out["exit"] == 1 and out["verdict"] == "regression"
    (reg,) = out["regressions"]
    assert reg["newest"] == 4.0 and reg["baseline"] == 10.0
    ok = tmp_path / "ok"
    for v in (10.0, 10.5, 9.9):
        ledger.record_bench("torch_bench", {"v": v}, label="m1",
                            perf={"metric": "steps_per_s", "value": v, "higher_is_better": True},
                            config=_Cfg(ok))
        time.sleep(0.002)
    out = sent.run_sentinel(ledger_dir=str(ok), margin=0.2, blackbox_dir=str(tmp_path / "bb"))
    assert out["exit"] == 0 and out["verdict"] == "ok"


# --------------------------------------------------------- exec telemetry
def test_exec_telemetry_blocks_and_metrics(tmp_path):
    before = metrics_registry().counter("exec.programs").value
    ff = _mlp(tmp_path, exec_telemetry="on")
    tel = ff.exec_telemetry
    assert set(tel["programs"]) == {"grad_step"}
    block = tel["programs"]["grad_step"]
    # 2 layers of 16x8 and 4x16 products, forward and backward, counted
    # by FlopCounterMode over the aten ops
    assert block["flops"] == 2 * 16 * (8 * 16 + 16 * 4) * 3 - 2 * 16 * 8 * 16
    assert block["peak_bytes"] is None and "unavailable" in block["memory"]
    assert "reconciliation" not in tel  # nothing measured to reconcile on the CPU
    assert metrics_registry().counter("exec.programs").value > before
    comp = ledger.load_runs(str(tmp_path), kind="compile")[-1]
    assert comp["exec"]["programs"]["grad_step"]["flops"] == block["flops"]


def test_exec_telemetry_flops_equal_jax_cost_analysis(tmp_path):
    """On one device the port counts the products JAX's cost analysis
    counts for the same MLP (XLA adds its elementwise ops and the
    optimizer's update; the port's count holds the products of one
    forward and backward): the JAX count is at least the port's and
    within 2x of it."""
    ff = _mlp(tmp_path, exec_telemetry="on")
    jff = J.FFModel(J.FFConfig(batch_size=16, seed=0, exec_telemetry="on",
                               ledger_dir=str(tmp_path / "jax")))
    from flexflow_tpu.models.mlp import build_mlp as jbuild_mlp

    import jax

    from flexflow_tpu.core.machine import make_mesh

    jbuild_mlp(jff, 16, in_dim=8, hidden_dims=(16,), num_classes=4)
    jff.compile(optimizer=J.SGDOptimizer(lr=0.05),
                loss_type=J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    port = ff.exec_telemetry["programs"]["grad_step"]["flops"]
    jax_flops = jff.exec_telemetry["programs"]["train_step"]["flops"]
    assert port <= jax_flops <= 2 * port + 10_000


def test_exec_telemetry_off_by_default_and_mode_guard(tmp_path):
    ff = _mlp(tmp_path)
    assert ff.exec_telemetry is None
    with pytest.raises(ValueError, match="exec_telemetry="):
        _mlp(tmp_path, exec_telemetry="bogus")


def test_obs002_fires_on_seeded_divergence(capsys):
    """The reconciliation is JAX's, row for row."""
    from flexflow_tpu.obs.exec_telemetry import reconcile_peak_memory as jrec

    before = metrics_registry().counter("exec.obs002_findings").value
    row = reconcile_peak_memory("seeded", 1000, 100000)
    f = row["finding"]
    assert f["code"] == "OBS002" and f["severity"] == "warning"
    assert row["ratio"] == 100.0 and row["divergence"] == 99.0
    assert "OBS002" in capsys.readouterr().out
    assert metrics_registry().counter("exec.obs002_findings").value == before + 1
    for args in (("seeded2", 100000, 1000), ("close", 1000, 1500), ("none", None, 1000),
                 ("zero", 0, 1000)):
        mine, theirs = reconcile_peak_memory(*args), jrec(*args)
        assert mine.keys() == theirs.keys()
        assert {k: v for k, v in mine.items() if k not in ("finding", "unavailable")} == \
            {k: v for k, v in theirs.items() if k not in ("finding", "unavailable")}
        if "finding" in mine:
            assert mine["finding"]["code"] == theirs["finding"]["code"] == "OBS002"
    capsys.readouterr()


def test_obs002_suppressible_only_with_reasoned_allow(capsys):
    row = reconcile_peak_memory("p", 1000, 100000, allow={"p": ""})
    assert row["finding"]["code"] == "OBS002"
    row = reconcile_peak_memory("p", 1000, 100000, allow={"other": "x"})
    assert row["finding"]["code"] == "OBS002"
    row = reconcile_peak_memory("p", 1000, 100000,
                                allow={"p": "packed pipeline buffers are priced per stage"})
    assert "finding" not in row and row["suppressed"].startswith("packed pipeline")
    capsys.readouterr()


def test_exec_telemetry_degrades_to_unavailable_on_step_failure():
    from flexflow_tpu_torch.obs.exec_telemetry import collect_one

    def boom():
        raise RuntimeError("wedged step")

    out = collect_one("broken", boom, "cpu")
    block = out["programs"]["broken"]
    assert "unavailable" in block and "wedged step" in block["unavailable"]
    assert "reconciliation" not in out


def test_generator_decode_step_telemetry(tmp_path):
    from flexflow_tpu_torch.models import GPTConfig, build_gpt
    from flexflow_tpu_torch.serving import Generator

    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu", exec_telemetry="on",
                              ledger_dir=str(tmp_path)))
    build_gpt(ff, 2, 8, GPTConfig(vocab_size=32, max_positions=16, hidden_size=16,
                                  num_heads=2, num_layers=1))
    ff.compile(T.SGDOptimizer(lr=0.1), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    gen = Generator(ff, max_length=16)
    block = gen.exec_telemetry["programs"]["serving.decode_step"]
    assert block["flops"] > 0 and block["peak_bytes"] is None


# ---------------------------------------------------------------- watchdog
def test_watchdog_stall_dump_on_seeded_heartbeat(tmp_path):
    wd = Watchdog(threshold_s=0.15, poll_s=0.05, dump_dir=str(tmp_path))
    wd.arm()
    try:
        with wd.watch("seeded"):
            wd.beat("seeded")
            deadline = time.monotonic() + 5.0
            while wd.stats()["dumps"] == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
        assert wd.stats()["dumps"] == 1
    finally:
        wd.disarm()
    dumps = [n for n in os.listdir(str(tmp_path)) if n.startswith("blackbox-")]
    assert len(dumps) == 1
    doc = json.load(open(os.path.join(str(tmp_path), dumps[0])))
    assert doc["schema"] == 1 and doc["reason"] == "stall"
    assert doc["stalled"]["seeded"] >= 0.15
    stacks = doc["threads"]
    assert any("ff-watchdog" in k for k in stacks)
    assert any("MainThread" in k for k in stacks)
    assert all(isinstance(v, list) and v for v in stacks.values())
    assert isinstance(doc["metrics"], dict)
    assert "trace_tail" in doc and "last_ledger_record" in doc
    assert os.path.exists(os.path.join(str(tmp_path), f"fatal-{os.getpid()}.log"))


def test_watchdog_one_dump_per_stall_and_beat_rearms(tmp_path):
    wd = Watchdog(threshold_s=0.1, poll_s=0.03, dump_dir=str(tmp_path))
    wd.arm()
    try:
        with wd.watch("s"):
            time.sleep(0.5)
            assert wd.stats()["dumps"] == 1
            wd.beat("s")
            time.sleep(0.35)
            assert wd.stats()["dumps"] == 2
    finally:
        wd.disarm()


def test_watchdog_zero_dumps_on_healthy_fit(tmp_path):
    bb = tmp_path / "bb"
    ff = _mlp(tmp_path / "ledger", watchdog="on", watchdog_threshold_s=120.0,
              watchdog_dir=str(bb))
    try:
        x, y = _data()
        ff.fit(x, y, epochs=2, verbose=False)
        st = watchdog().stats()
        assert st["enabled"] and "fit.loop" in st["sources_seen"]
        assert st["watched"] == []
    finally:
        watchdog().disarm()
    dumps = [n for n in os.listdir(str(bb)) if n.startswith("blackbox-")] if bb.exists() else []
    assert dumps == []


def test_watchdog_mode_guard_and_disarmed_is_cheap(tmp_path):
    from flexflow_tpu_torch.obs.watchdog import beat, watch

    ff = _mlp(tmp_path, watchdog="bogus")
    x, y = _data()
    with pytest.raises(ValueError, match="watchdog="):
        ff.fit(x, y, epochs=1, verbose=False)
    assert not watchdog().enabled
    t0 = time.perf_counter()
    for _ in range(100_000):
        beat("x")
        with watch("y"):
            pass
    assert time.perf_counter() - t0 < 2.0


def test_watchdog_manual_dump_and_cap(tmp_path):
    wd = Watchdog(threshold_s=60, dump_dir=str(tmp_path), max_dumps=2)
    p1, p2 = wd.dump("manual"), wd.dump("manual")
    assert p1 and p2 and p1 != p2
    assert wd.dump("manual") is None
    doc = json.load(open(p1))
    assert doc["reason"] == "manual" and doc["threads"]


def test_watchdog_hands_faulthandler_back(tmp_path):
    """Arming points faulthandler at the dump directory; disarming puts a
    handler that was there before back (pytest's own, here)."""
    import faulthandler

    was = faulthandler.is_enabled()
    wd = Watchdog(threshold_s=60, dump_dir=str(tmp_path))
    wd.arm()
    assert faulthandler.is_enabled()
    wd.disarm()
    assert faulthandler.is_enabled() == was


def test_ledger_cohort_covers_resolved_pipeline_envelope():
    """The resolved pipeline envelope keys the cohort: the host and the
    single-call engine on the same {pipe: 2} mesh are two cohorts, as in
    JAX's test; checked without ranks on the knobs model_context stamps."""
    class _PM:
        def __init__(self, engine):
            self.cfg = type("C", (), {"schedule": "1f1b", "interleave": 1, "axis": "pipe"})()
            self.engine_name = engine
            self.mesh = type("M", (), {"shape": {"pipe": 2, "data": 2}})()

    ff = _mlp()
    keys = set()
    for engine in ("host", "compiled"):
        ff.pipelined = _PM(engine)
        ctx = ledger.model_context(ff)
        assert ctx["knobs"]["pipeline_engine"] == engine
        assert ctx["knobs"]["pipeline_submesh"] == json.dumps([["data", 2]])
        keys.add(ledger.cohort_key({"kind": "fit", **ctx}))
    ff.pipelined = None
    assert len(keys) == 2


def test_process_count_keys_multi_process_cohorts(monkeypatch):
    ff = _mlp()
    assert "process_count" not in ledger.model_context(ff)["knobs"]
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert ledger.model_context(ff)["knobs"]["process_count"] == 2


def test_ledger_env_override_in_a_child_process(tmp_path):
    """``FLEXFLOW_TPU_LEDGER_DIR`` moves a config-less process's records,
    as it moves JAX's."""
    code = ("from flexflow_tpu_torch.obs import ledger as L;"
            "print(L.ledger_dir()); L.record_run('bench', {'x': 1})")
    env = dict(os.environ, FLEXFLOW_TPU_LEDGER_DIR=str(tmp_path / "env"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path / "env")
    assert [r["x"] for r in ledger.load_runs(str(tmp_path / "env"))] == [1]
