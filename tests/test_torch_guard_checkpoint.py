"""The training guard, checkpoint/resume and recompile-on-condition: the
port against the JAX package and against itself.

* Under ``train.nan_loss`` the port's guard rolls back, backs off the lr
  and logs the same events as the JAX package's, and the params after
  the run agree within ``F32_TOL`` (SGD, the same MLP and data); past the
  budget ``DivergenceError``; a rollback bumps ``params_version`` and a
  ``Generator`` built before it serves the restored weights.
* A save/restore round trip returns every weight and optimizer slot
  (BatchNorm's running statistics included) bit for bit, with retention.
* A child process killed by ``train.kill`` (exit 41) and resumed with
  ``resume_from`` ends with params and Adam moments EQUAL to an
  uninterrupted run's, on the CPU.
* Both ``checkpoint.torn_write`` targets fall back to the previous step and
  count; a topology mismatch raises CKPT001 and ``restore_elastic`` passes
  and counts.
* ``recompile_on_condition`` fires, alters, recompiles and keeps the
  weights, as the JAX package's does (params within ``F32_TOL``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.ffconst import ActiMode as JActiMode
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.runtime.guard import TrainingGuard as JTrainingGuard
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.runtime.recompile import RecompileState as JRecompileState
from flexflow_tpu_torch import (ActiMode, AdamOptimizer, FFConfig, FFModel, LossType,
                                MetricsType, SGDOptimizer, load_numpy_params)
from flexflow_tpu_torch.obs.metrics import metrics_registry
from flexflow_tpu_torch.runtime import faults
from flexflow_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                   CheckpointTopologyError,
                                                   topology_signature)
from flexflow_tpu_torch.runtime.guard import DivergenceError, TrainingGuard
from flexflow_tpu_torch.runtime.recompile import RecompileState
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32, relative to the largest value compared: the same MLP in the same
# precision, sums in another order, over a dozen SGD steps
F32_TOL = 2e-5


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.configure_faults(FFConfig(device="cpu"))
    jfaults.configure_faults(type("C", (), {"fault_plan": None})())


def _data(n=4 * BATCH, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=(n, 1)).astype(np.int32)
    return x, y


def _mlp(opt=None, dropout=0.0, **cfg):
    """The port's MLP (dense-relu[-dropout]-dense), its params drawn from
    the seed."""
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu", seed=1, **cfg))
    x = ff.create_tensor((BATCH, 16), name="input")
    h = ff.dense(x, 32, ActiMode.RELU, name="body")
    if dropout:
        h = ff.dropout(h, dropout, name="drop")
    ff.dense(h, 4, name="head")
    ff.compile(opt or SGDOptimizer(lr=0.1), LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def _jmlp(**cfg):
    ff = JFFModel(JFFConfig(batch_size=BATCH, seed=1, ledger="off", audit_programs="off",
                            attribution="off", **cfg))
    x = ff.create_tensor((BATCH, 16), name="input")
    h = ff.dense(x, 32, JActiMode.RELU, name="body")
    ff.dense(h, 4, name="head")
    ff.compile(optimizer=JSGDOptimizer(lr=0.1),
               loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[],
               mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    return ff


def _same_params(jff, ff):
    """Give the port model the JAX model's params."""
    load_numpy_params(ff, {op: {w: np.asarray(v) for w, v in ws.items()}
                           for op, ws in jff.compiled.params.items()})


def _close(ff, jff, tol=F32_TOL):
    for op, ws in jff.compiled.params.items():
        for w, v in ws.items():
            want = np.asarray(v)
            got = ff.compiled.params[op][w].detach().numpy()
            assert np.abs(got - want).max() <= tol * np.abs(want).max(), (op, w)


def _snapshot(ff):
    return {op: {w: t.clone() for w, t in ws.items()} for op, ws in ff.compiled.params.items()}


def _assert_tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        assert a == b


# ---------------------------------------------------------------- the guard
def test_guard_rollback_matches_jax():
    plan = {"schema": 1, "sites": {"train.nan_loss": {"at_step": 6}}}
    x, y = _data()
    jff = _jmlp(fault_plan=plan)
    ff = _mlp(fault_plan=plan)
    _same_params(jff, ff)
    jguard, guard = JTrainingGuard(max_restores=2), TrainingGuard(max_restores=2)
    jff.fit(x, y, epochs=3, guard=jguard, verbose=False)
    hist = ff.fit(x, y, epochs=3, guard=guard, verbose=False)
    assert ff.optimizer.lr == pytest.approx(jff.optimizer.lr) == pytest.approx(0.05)
    assert guard.report() == jguard.report()
    assert [e["kind"] for e in guard.events] == ["snapshot", "snapshot", "restore",
                                                 "snapshot"]
    assert ff.fit_profile["guard"] == jff.fit_profile["guard"]
    assert np.isfinite(hist[-1].sparse_cce_loss)
    _close(ff, jff)


def test_divergence_error_once_the_budget_is_spent():
    x, y = _data()
    ff = _mlp(fault_plan={"schema": 1, "sites": {"train.nan_loss": {"p": 1.0}}})
    guard = TrainingGuard(max_restores=1)
    with pytest.raises(DivergenceError, match="epoch 1"):
        ff.fit(x, y, epochs=3, guard=guard, verbose=False)
    assert guard.report()["restores"] == 1


def test_rollback_bumps_params_version_and_generation_serves_restored_weights():
    from flexflow_tpu_torch.models import GPTConfig, build_gpt
    from flexflow_tpu_torch.serving import Generator

    V, S = 32, 16
    ff = FFModel(FFConfig(batch_size=2, device="cpu", compute_dtype="bfloat16", fault_plan={
        "schema": 1, "sites": {"train.nan_loss": {"at_step": 2}}}))
    build_gpt(ff, 2, S, GPTConfig(vocab_size=V, max_positions=S, hidden_size=32,
                                  num_heads=4, num_layers=2))
    ff.compile(SGDOptimizer(lr=1.0), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, V, size=(4, S + 1)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (4, S)).copy()
    gen = Generator(ff, max_length=S)
    prompt = tok[:2, :4]
    before = gen.generate(prompt, 6)
    cast_before = {k: v.clone() for k, v in gen._exec_params()["lm_head"].items()}
    init = _snapshot(ff)
    version = ff.compiled.params_version
    ff.fit([tok[:, :-1], pos], tok[:, 1:], epochs=1, guard=TrainingGuard(), verbose=False)
    assert ff.compiled.params_version == version + 1
    _assert_tree_equal(_snapshot(ff), init)  # the whole epoch rolled back
    assert np.array_equal(gen.generate(prompt, 6), before)
    assert np.array_equal(Generator(ff, max_length=S).generate(prompt, 6), before)
    _assert_tree_equal(gen._exec_params()["lm_head"], cast_before)


# ------------------------------------------------------------ checkpoints
def _cnn(**cfg):
    """Conv, batch norm, dense, with SGD momentum (one slot a weight)."""
    ff = FFModel(FFConfig(batch_size=4, device="cpu", **cfg))
    x = ff.create_tensor((4, 3, 8, 8), name="image")
    t = ff.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="conv")
    t = ff.batch_norm(t, name="bn")
    t = ff.flat(t, name="flat")
    ff.dense(t, 4, name="head")
    ff.compile(SGDOptimizer(lr=0.05, momentum=0.9), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _cnn_data(n=8):
    rng = np.random.default_rng(2)
    return (rng.normal(size=(n, 3, 8, 8)).astype(np.float32),
            rng.integers(0, 4, size=(n, 1)).astype(np.int32))


def test_save_restore_round_trip_with_retention(tmp_path):
    x, y = _cnn_data()
    ff = _cnn()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    saved = {}
    for step in range(1, 6):
        ff.fit(x, y, epochs=1, verbose=False)
        mgr.save(ff, step, extra={"step": step})
        saved[step] = (_snapshot(ff), {k: {w: t.clone() for w, t in ws.items()}
                                       for k, ws in ff.compiled.opt_state.items()},
                       ff.compiled.iteration)
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert sorted(p.name for p in tmp_path.glob("extra_*.json")) == [
        "extra_3.json", "extra_4.json", "extra_5.json"]
    running = saved[4][0]["bn"]
    assert set(running) >= {"running_mean", "running_var"}
    fresh = _cnn()
    assert mgr.restore(fresh, step=4) == 4
    _assert_tree_equal(_snapshot(fresh), saved[4][0])
    _assert_tree_equal(fresh.compiled.opt_state, saved[4][1])
    assert fresh.compiled.iteration == saved[4][2]
    assert mgr.restore_extra(4) == {"step": 4}
    assert fresh.compiled.params_version == 1
    # the one-shot verbs
    fresh.save_checkpoint(str(tmp_path / "one"), step=7)
    other = _cnn()
    assert other.load_checkpoint(str(tmp_path / "one")) == 7
    _assert_tree_equal(_snapshot(other), saved[4][0])


def test_guard_snapshot_round_trips_every_slot():
    x, y = _cnn_data()
    ff = _cnn()
    ff.fit(x, y, epochs=1, verbose=False)
    guard = TrainingGuard()
    guard.snapshot(ff)
    params, slots = _snapshot(ff), {k: {w: t.clone() for w, t in ws.items()}
                                    for k, ws in ff.compiled.opt_state.items()}
    ff.fit(x, y, epochs=2, verbose=False)
    assert guard.recover(ff, verbose=False)
    _assert_tree_equal(_snapshot(ff), params)
    _assert_tree_equal(ff.compiled.opt_state, slots)


_CHILD = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads({threads})
from test_torch_guard_checkpoint import _data, _kill_model
x, y = _data()
ff = _kill_model({ckpt!r}, {{"schema": 1, "sites": {{"train.kill": {{"at_step": {at}}}}}}})
ff.fit(x, y, epochs=3, verbose=False)
sys.exit(0)
"""


def _kill_model(ckpt, plan=None):
    return _mlp(AdamOptimizer(alpha=0.01), dropout=0.25, checkpoint_interval_steps=2,
                checkpoint_dir=ckpt, fault_plan=plan)


@pytest.mark.parametrize("at_step", [5, 10])
def test_kill_then_resume_equals_an_uninterrupted_run(tmp_path, at_step):
    ckpt = str(tmp_path / "ckpt")
    code = _CHILD.format(root=ROOT, tests=os.path.join(ROOT, "tests"),
                         threads=torch.get_num_threads(), ckpt=ckpt, at=at_step)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 41, proc.stderr[-2000:]
    last = at_step - at_step % 2
    assert CheckpointManager(ckpt).latest_step() == last
    x, y = _data()
    resumed = _kill_model(str(tmp_path / "unused"))
    resumed.fit(x, y, epochs=3, resume_from=ckpt, verbose=False)
    whole = _kill_model(str(tmp_path / "whole"))
    whole.fit(x, y, epochs=3, verbose=False)
    _assert_tree_equal(_snapshot(resumed), _snapshot(whole))
    _assert_tree_equal(resumed.compiled.opt_state, whole.compiled.opt_state)
    assert resumed.compiled.iteration == whole.compiled.iteration == 12
    assert resumed._rng_counter == whole._rng_counter


def test_resume_from_an_empty_directory_starts_fresh(tmp_path):
    x, y = _data()
    a, b = _mlp(), _mlp()
    a.fit(x, y, resume_from=str(tmp_path / "nothing"), verbose=False)
    b.fit(x, y, verbose=False)
    _assert_tree_equal(_snapshot(a), _snapshot(b))


@pytest.mark.parametrize("target", ["payload", "sidecar"])
def test_torn_write_falls_back_and_counts(tmp_path, target):
    x, y = _data()
    ff = _mlp(checkpoint_interval_steps=2, checkpoint_dir=str(tmp_path), fault_plan={
        "schema": 1, "sites": {"checkpoint.torn_write": {"at_step": 2, "target": target}}})
    reg = metrics_registry()
    torn0 = reg.counter("faults.torn_checkpoints").value
    fall0 = reg.counter("checkpoint.corrupt_fallbacks").value
    ff.fit(x, y, verbose=False)  # saves at steps 2 and 4; the second is torn
    assert reg.counter("faults.torn_checkpoints").value == torn0 + 1
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [2, 4]
    fresh = _mlp()
    assert mgr.restore(fresh, require_extra=True) == 2
    assert reg.counter("checkpoint.corrupt_fallbacks").value == fall0 + 1
    assert fresh.compiled.iteration == 2
    if target == "sidecar":
        side0 = reg.counter("checkpoint.corrupt_sidecars").value
        assert mgr.restore_extra(4) is None
        assert reg.counter("checkpoint.corrupt_sidecars").value == side0 + 1


def test_topology_mismatch_raises_and_elastic_restore_counts(tmp_path):
    x, y = _data()
    ff = _mlp()
    ff.fit(x, y, verbose=False)
    mgr = CheckpointManager(str(tmp_path))
    other = dict(topology_signature(torch.device("cpu")), device_count=8)
    mgr.save(ff, 4, extra={"schema": 1, "epoch": 1, "step_in_epoch": 0, "topology": other})
    with pytest.raises(CheckpointTopologyError, match="CKPT001"):
        mgr.restore(_mlp(), require_extra=True)
    with pytest.raises(CheckpointTopologyError):
        _mlp().fit(x, y, resume_from=str(tmp_path), verbose=False)
    reg = metrics_registry()
    n0 = reg.counter("checkpoint.elastic_resumes").value
    fresh = _mlp()
    assert mgr.restore_elastic(fresh) == 4
    _assert_tree_equal(_snapshot(fresh), _snapshot(ff))
    elastic = _mlp(elastic_resume=True)
    elastic.fit(x, y, epochs=2, resume_from=str(tmp_path), verbose=False)
    assert reg.counter("checkpoint.elastic_resumes").value == n0 + 2


def test_multi_process_checkpoints_wait_for_a7(monkeypatch, tmp_path):
    """In a process group of two a single-process manager no longer
    raises: it is the multi-process manager, the one multi-process layout.
    Each rank commits its shard, rank 0 the manifest once both have
    acknowledged, and each rank restores its own shard through it."""
    from flexflow_tpu_torch.runtime import checkpoint

    monkeypatch.setattr(checkpoint, "_process_count", lambda: 2)
    ffs = [_mlp(), _mlp()]
    with torch.no_grad():  # the ranks hold different params
        for ws in ffs[1].compiled.params.values():
            for t in ws.values():
                t.add_(1.0)
    mgrs = []
    for rank in (1, 0):  # rank 1 first: rank 0's barrier then passes
        monkeypatch.setattr(checkpoint, "_process_index", lambda rank=rank: rank)
        mgr = CheckpointManager(str(tmp_path))
        assert isinstance(mgr, checkpoint.MultiHostCheckpointManager) and mgr.rank == rank
        mgr.save(ffs[rank], 7)
        mgrs.append(mgr)
    assert (tmp_path / "manifest_7.json").exists() and not (tmp_path / "rank-001").exists()
    for mgr in mgrs:
        fresh = _mlp()
        with torch.no_grad():
            for ws in fresh.compiled.params.values():
                for t in ws.values():
                    t.zero_()
        assert mgr.all_steps() == [7] and mgr.restore(fresh) == 7
        _assert_tree_equal(_snapshot(fresh), _snapshot(ffs[mgr.rank]))


# ---------------------------------------------------------------- recompile
def test_recompile_on_condition_matches_jax():
    x, y = _data()
    jff, ff = _jmlp(), _mlp()
    _same_params(jff, ff)
    fired = {"jax": [], "port": []}
    n0 = metrics_registry().counter("recompile.triggers").value
    for name, model, State in (("jax", jff, JRecompileState), ("port", ff, RecompileState)):
        rs = State(lambda s: s.iteration == 5, lambda s, n=name: fired[n].append(s.iteration),
                   model)
        model.fit(x, y, epochs=3, recompile_state=rs, verbose=False)
        assert rs.recompilations == 1
    assert fired == {"jax": [5], "port": [5]}
    assert metrics_registry().counter("recompile.triggers").value == n0 + 1
    assert ff.compiled.iteration == jff.compiled.iteration == 12
    _close(ff, jff)
