"""Multi-process runs: the bootstrap, the multi-process checkpoint manager,
the ``multihost.*`` fault sites and the supervisor, mirroring
``tests/test_multihost_launch.py`` and ``tests/test_multihost.py``.

The manager is driven in one process with explicit (process_id,
process_count) pairs, the port's and the JAX package's side by side on
the same scenario: the same files and manifest keys, the same steps
restored, the same counters moved, the restored params equal to the saved
ones bit for bit. A ZeRO-1 cohort's shares (two ranks compiled over a
{data: 2} mesh that runs no collective) come back whole on one process
and cut anew for a rank of two. The supervisor's scenarios run real
cohorts of worker processes over gloo (``parallel/launch.py``): a peer
killed at step 6 relaunches and resumes bit for bit equal to the
uninterrupted cohort, a hung peer is detected and relaunched, a shrunk
world resumes through the counted elastic restore; the two-process fit
equals the one-process fit and the JAX package's (1e-5 of the largest
|value| and 2^-4 of each tensor's largest update: gradients summed in
another order, as ``test_torch_parallel_training.py``)."""

import itertools
import json
import os

import numpy as np
import pytest
import torch

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.models.mlp import build_mlp as jbuild_mlp
from flexflow_tpu.obs.metrics import metrics_registry as jmetrics_registry
from flexflow_tpu.parallel import multihost as jmh
from flexflow_tpu.runtime import checkpoint as jckpt
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.runtime.optimizer import AdamOptimizer as JAdamOptimizer
from flexflow_tpu_torch import ActiMode, AdamOptimizer, FFConfig, FFModel, LossType
from flexflow_tpu_torch.core.machine import Group, Mesh
from flexflow_tpu_torch.models.mlp import build_mlp
from flexflow_tpu_torch.obs.metrics import metrics_registry
from flexflow_tpu_torch.parallel import launch
from flexflow_tpu_torch.parallel import multihost as mh
from flexflow_tpu_torch.runtime import faults
from flexflow_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                   CheckpointTopologyError,
                                                   MultiHostCheckpointManager,
                                                   is_multihost_dir, topology_matches,
                                                   topology_signature)
from flexflow_tpu_torch.runtime.compiler import compile_model
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL, UPDATE_TOL = 1e-5, 2 ** -4
EXTRA = {"schema": 1, "epoch": 0, "step_in_epoch": 0, "rng_counter": 0, "lr": None,
         "guard": None}


def _ctr(name):
    return int(metrics_registry().counter(name).value)


def _jctr(name):
    m = jmetrics_registry().get(name)
    return int(m.value) if m is not None else 0


def _model(seed=3, **cfg):
    ff = FFModel(FFConfig(batch_size=16, epochs=2, seed=seed, device="cpu", **cfg))
    build_mlp(ff, 16, in_dim=8, hidden_dims=(16,), num_classes=4)
    ff.compile(optimizer=AdamOptimizer(alpha=0.01),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=["sparse_categorical_crossentropy"])
    return ff


def _jmodel(seed=3, epochs=2, **cfg):
    ff = JFFModel(JFFConfig(batch_size=16, epochs=epochs, seed=seed, ledger="off",
                            audit_programs="off", attribution="off", **cfg))
    jbuild_mlp(ff, 16, in_dim=8, hidden_dims=(16,), num_classes=4)
    ff.compile(optimizer=JAdamOptimizer(alpha=0.01),
               loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=["sparse_categorical_crossentropy"])
    return ff


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32).reshape(-1, 1)


def _np(ff):
    return {op: {w: np.array(a) for w, a in ws.items()}
            for op, ws in ff.compiled.params.items()}


def _equal(a, b):
    assert set(a) == set(b)
    for op in a:
        for w in a[op]:
            np.testing.assert_array_equal(a[op][w], b[op][w], err_msg=f"{op}.{w}")


def _mh_save(path, step=1, world=2, models=None, jax_pkg=False):
    """A cohort of ``world`` in one process: the last rank commits first,
    so rank 0's barrier then passes and it writes the manifest."""
    make, mgr = (_jmodel, jckpt.MultiHostCheckpointManager) if jax_pkg else \
        (_model, MultiHostCheckpointManager)
    ffs = models or [make(seed=3) for _ in range(world)]
    mgrs = [mgr(str(path), process_id=r, process_count=world) for r in range(world)]
    for r in reversed(range(world)):
        ffs[r].compiled.iteration = step
        mgrs[r].save(ffs[r], step, extra=dict(EXTRA), wait=True)
    return ffs, mgrs


def _listing(root):
    """The files under a checkpoint directory, payload suffixes unified."""
    out = set()
    for d, _, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root)
            out.add(rel.replace(".npz", ".payload").replace(".pt", ".payload"))
    return out


# ------------------------------------------------------------- fault sites
def test_fault_plan_accepts_multihost_sites():
    spec = {"schema": 1, "seed": 0, "sites": {
        "multihost.init_timeout": {"at_step": 1},
        "multihost.peer_kill": {"at_step": 6, "exit_code": 43},
        "multihost.slow_peer": {"at_step": 2, "stall_s": 0.5}}}
    for site in spec["sites"]:
        assert site in faults.SITES and site in jfaults.SITES
    try:
        plan = faults.configure_faults(FFConfig(device="cpu", fault_plan=spec))
        jfaults.configure_faults(type("C", (), {"fault_plan": spec})())
        assert faults.active()  # armed: the port evaluates every site now
        for site in spec["sites"]:
            got = [faults.fire(site) for _ in range(8)]
            assert got == [jfaults.fire(site) for _ in range(8)]
        assert plan.snapshot() == jfaults.faults_block()
    finally:
        faults.configure_faults(FFConfig(device="cpu"))
        jfaults.configure_faults(type("C", (), {"fault_plan": None})())
    for pkg in (faults, jfaults):
        with pytest.raises(ValueError, match="unknown rule keys"):
            pkg.FaultPlan({"schema": 1, "sites": {
                "multihost.init_timeout": {"at_step": 1, "stall_s": 1.0}}})


@pytest.mark.parametrize("cause", ["injected", "real"])
def test_elastic_init_retries(cause):
    """The injected ``multihost.init_timeout`` fires before the bootstrap
    and a real bootstrap failure is retried too: two attempts, one retry
    counted, as the JAX package's ``elastic_init``."""
    results = []
    for pkg, reg, fx in ((mh, _ctr, faults), (jmh, _jctr, jfaults)):
        calls = []

        def init():
            calls.append(1)
            if cause == "real" and len(calls) == 1:
                raise RuntimeError("connect timed out")

        if cause == "injected":
            fx.configure_faults(type("P", (), {"fault_plan": {
                "schema": 1, "seed": 0, "sites": {"multihost.init_timeout": {"at_step": 1}}}}))
        try:
            before = reg("retry.mh_init.retries")
            info = pkg.elastic_init(_init_fn=init, base_delay_s=0.001, seed=0)
            results.append((len(calls), info["attempts"], reg("retry.mh_init.retries") - before))
        finally:
            fx.configure_faults(type("P", (), {"fault_plan": None}))
    assert results[0] == results[1] == ((1 if cause == "injected" else 2), 2, 1)


def test_single_process_probe_and_meshes_match_jax():
    assert mh.multiprocess_compute_support() == jmh.multiprocess_compute_support() == (True, None)
    for args in ((2, 4, 2), (4, 1, 1), (1, 8, 4)):
        spec, jspec = mh.two_level_mesh_spec(*args), jmh.two_level_mesh_spec(*args)
        # the machine model is JAX's with the port's chip in place of v5e
        assert spec == dict(jspec, machine_model=dict(jspec["machine_model"], chip="h100"))
    for pkg in (mh, jmh):
        with pytest.raises(ValueError, match="model_degree"):
            pkg.two_level_mesh_spec(2, 4, model_degree=3)
    # one process is one rank: no mesh, whatever the hybrid request
    assert mh.make_local_mesh() is None and mh.make_multihost_mesh({"data": 1}) is None
    assert mh.make_multihost_mesh({"model": 1}, dcn_mesh_shape={"data": 1}) is None
    with pytest.raises(ValueError, match="one rank"):
        mh.make_local_mesh({"data": 2})
    ff = _model()
    x = _data()[0][:16]
    np.testing.assert_array_equal(mh.process_local_batch(x, ff.compiled), x)


def test_distributed_init_reads_the_environment_in_order(monkeypatch):
    """Explicit arguments, then FLEXFLOW_*, OpenMPI, SLURM, torchrun."""
    from flexflow_tpu_torch.parallel import distributed

    seen = []
    monkeypatch.setattr(distributed, "init_process_group",
                        lambda rank, world, method, local, timeout_s: seen.append(
                            (rank, world, method, local)))
    layers = [("FLEXFLOW_NUM_PROCESSES", "FLEXFLOW_PROCESS_ID", 8, 5),
              ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", 6, 4),
              ("SLURM_NTASKS", "SLURM_PROCID", 4, 3),
              ("WORLD_SIZE", "RANK", 2, 1)]
    for k in [k for n, r, _, _ in layers for k in (n, r)] + [
            "FLEXFLOW_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE",
            "OMPI_COMM_WORLD_LOCAL_SIZE", "SLURM_NTASKS_PER_NODE"]:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    want = []
    for n_key, r_key, n, r in reversed(layers):
        monkeypatch.setenv(n_key, str(n))
        monkeypatch.setenv(r_key, str(r))
        mh.distributed_init()
        want.append((r, n, "tcp://10.0.0.1:1234", n))
    monkeypatch.setenv("FLEXFLOW_COORDINATOR", "host:9")
    mh.distributed_init(num_processes=3, process_id=2)
    want.append((2, 3, "tcp://host:9", 3))  # explicit beats every variable
    assert seen == want


def test_topology_signature_and_match():
    sig, jsig = topology_signature(process_count=1), jckpt.topology_signature()
    assert sig["process_count"] == jsig["process_count"] == 1
    assert "mesh_axes" not in sig and "mesh_axes" not in jsig
    mesh = Mesh({"data": 2}, 0, {})
    full = topology_signature("cpu", 2, mesh)
    assert full["process_count"] == 2 and full["mesh_axes"] == {"data": 2}
    for match in (topology_matches, jckpt.topology_matches):
        assert match(full, dict(full)) and match(None, full)
        assert not match(full, {**full, "process_count": 1})
        assert match({"process_count": 2}, {"process_count": 2, "mesh_axes": {"data": 2}})


# ------------------------------------------------ the manager (two ranks)
def test_mh_manager_roundtrip_and_manifest(tmp_path):
    ffs, mgrs = _mh_save(tmp_path / "port", step=4)
    jffs, jmgrs = _mh_save(tmp_path / "jax", step=4, jax_pkg=True)
    for path in ("port", "jax"):
        assert is_multihost_dir(str(tmp_path / path)) and jckpt.is_multihost_dir(
            str(tmp_path / path))
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    (step, man), (jstep, jman) = mgrs[0].latest_manifest(), jmgrs[0].latest_manifest()
    assert step == jstep == 4 and set(man) == set(jman)
    assert man["process_count"] == jman["process_count"] == 2
    saved = _np(ffs[0])
    fresh = _model(seed=99)
    assert mgrs[0].restore(fresh, require_extra=True) == 4
    _equal(_np(fresh), saved)
    assert fresh.compiled.iteration == 4
    extra = mgrs[0].restore_extra(4)
    assert extra["epoch"] == 0 and extra["topology"]["process_count"] == 2


def test_mh_manager_topology_mismatch_is_coded(tmp_path):
    for pkg, make, path in ((None, _model, "port"), (jckpt, _jmodel, "jax")):
        _mh_save(tmp_path / path, step=2, jax_pkg=pkg is not None)
        mgr = (pkg.MultiHostCheckpointManager if pkg else MultiHostCheckpointManager)(
            str(tmp_path / path), process_id=0, process_count=1)
        err = jckpt.CheckpointTopologyError if pkg else CheckpointTopologyError
        with pytest.raises(err) as ei:
            mgr.restore(make(seed=99), require_extra=True)
        assert ei.value.code == "CKPT001" and ei.value.found["process_count"] == 2


def test_mh_manager_elastic_restore_changed_world(tmp_path):
    counts = []
    for pkg, make, snap, path in ((MultiHostCheckpointManager, _model, _np, "port"),
                                  (jckpt.MultiHostCheckpointManager, _jmodel, _np, "jax")):
        ffs, _ = _mh_save(tmp_path / path, step=2, jax_pkg=path == "jax")
        saved = snap(ffs[0])
        reg = _ctr if path == "port" else _jctr
        before = reg("checkpoint.elastic_resumes")
        for rank, world in ((0, 1), (2, 3)):  # shrink 2 -> 1, grow 2 -> 3
            fresh = make(seed=98)
            assert pkg(str(tmp_path / path), process_id=rank,
                       process_count=world).restore_elastic(fresh) == 2
            _equal(snap(fresh), saved)
        counts.append(reg("checkpoint.elastic_resumes") - before)
    assert counts == [2, 2]


def test_mh_manager_torn_manifest_falls_back(tmp_path):
    x, y = _data()
    out = []
    for make, path in ((_model, "port"), (_jmodel, "jax")):
        ffs, mgrs = _mh_save(tmp_path / path, step=1, jax_pkg=path == "jax")
        step1 = _np(ffs[0])
        for r in reversed(range(2)):
            ffs[r].fit(x, y, epochs=1, verbose=False)
            ffs[r].compiled.iteration = 2
            mgrs[r].save(ffs[r], 2, extra={"schema": 1}, wait=True)
        with open(tmp_path / path / "manifest_2.json", "w") as f:
            f.write('{"schema": 1, "step"')
        reg = _ctr if path == "port" else _jctr
        before = reg("checkpoint.torn_manifests")
        fresh = make(seed=99)
        out.append((mgrs[0].restore(fresh), reg("checkpoint.torn_manifests") - before))
        _equal(_np(fresh), step1)
    assert out == [(1, 1), (1, 1)]


def test_mh_manager_prune_keeps_manifested_payloads(tmp_path):
    """Saves that never manifest (rank 1 gone) must not evict the payload
    the newest manifest points at."""
    kept = []
    for pkg, make, ext, path in ((MultiHostCheckpointManager, _model, "pt", "port"),
                                 (jckpt.MultiHostCheckpointManager, _jmodel, "npz", "jax")):
        ffs, mgrs = _mh_save(tmp_path / path, step=2, jax_pkg=path == "jax")
        saved = _np(ffs[0])
        lone = pkg(str(tmp_path / path), process_id=0, process_count=2, max_to_keep=2,
                   barrier_timeout_s=0.1)
        for step in (4, 6, 8):
            ffs[0].compiled.iteration = step
            lone.save(ffs[0], step, extra={"schema": 1}, wait=True)
        kept.append(sorted(n for n in os.listdir(tmp_path / path / "shard-000")
                           if n.startswith("step_")))
        fresh = make(seed=99)
        assert mgrs[0].restore(fresh) == 2
        _equal(_np(fresh), saved)
    assert [n.replace(".pt", "") for n in kept[0]] == [n.replace(".npz", "") for n in kept[1]]
    assert "step_2.pt" in kept[0] and "step_4.pt" not in kept[0]


def test_mh_manager_ack_barrier_timeout_skips_manifest(tmp_path):
    got = []
    for pkg, make, reg, path in ((MultiHostCheckpointManager, _model, _ctr, "port"),
                                 (jckpt.MultiHostCheckpointManager, _jmodel, _jctr, "jax")):
        mgr = pkg(str(tmp_path / path), process_id=0, process_count=2, barrier_timeout_s=0.2)
        before = reg("checkpoint.barrier_timeouts")
        mgr.save(make(seed=3), 5, extra={"schema": 1}, wait=True)  # rank 1 never acks
        got.append((reg("checkpoint.barrier_timeouts") - before, mgr.latest_step(),
                    os.path.exists(tmp_path / path / "manifest_5.json"),
                    any(n.startswith("step_5") for n in os.listdir(
                        tmp_path / path / "shard-000"))))
    assert got == [(1, None, False, True)] * 2


def test_mh_manager_stale_ack_incarnation_guard(tmp_path):
    """An ack left by a torn-down launch does not count toward this
    launch's barrier."""
    got = []
    for pkg, make, path in ((MultiHostCheckpointManager, _model, "port"),
                            (jckpt.MultiHostCheckpointManager, _jmodel, "jax")):
        root = str(tmp_path / path)
        ff0, ff1 = make(seed=3), make(seed=3)
        ff0.compiled.iteration = ff1.compiled.iteration = 5
        pkg(root, process_id=1, process_count=2, launch_id="old").save(
            ff1, 5, extra={"schema": 1}, wait=True)
        new0 = pkg(root, process_id=0, process_count=2, launch_id="new", barrier_timeout_s=0.2)
        new0.save(ff0, 5, extra={"schema": 1}, wait=True)
        first = os.path.exists(os.path.join(root, "manifest_5.json"))
        pkg(root, process_id=1, process_count=2, launch_id="new").save(
            ff1, 5, extra={"schema": 1}, wait=True)
        new0.save(ff0, 5, extra={"schema": 1}, wait=True)
        got.append((first, os.path.exists(os.path.join(root, "manifest_5.json"))))
    assert got == [(False, True)] * 2


def test_mh_manager_elastic_restore_rebuilds_each_zero_share(tmp_path):
    """A ZeRO-1 cohort of two saves each rank's half of Adam's m and v;
    one process gets them whole, and a rank of a new cohort of two its own
    half, from both shards (never from shard 0 alone)."""
    def zero_model(rank):
        ff = FFModel(FFConfig(batch_size=16, device="cpu", zero_optimizer=True))
        build_mlp(ff, 16, in_dim=8, hidden_dims=(16,), num_classes=4)
        mesh = Mesh({"data": 2}, rank, {("data",): Group(("data",), None, (0, 1), rank)})
        ff.compiled = compile_model(ff.config, ff.layers, ff.input_tensors, ff._final_output(),
                                    AdamOptimizer(alpha=0.01),
                                    LossType.SPARSE_CATEGORICAL_CROSSENTROPY, mesh=mesh)
        return ff

    ranks = [zero_model(r) for r in range(2)]
    rng = np.random.default_rng(0)
    whole = {}
    for key in ("m", "v"):
        for (op, w), d in ranks[0].compiled.zero_dims.items():
            shape = list(ranks[0].compiled.params[op][w].shape)
            full = rng.standard_normal(shape).astype(np.float32)
            whole[(key, op, w)] = full
            for r, ff in enumerate(ranks):
                ff.compiled.opt_state[key][op][w].copy_(
                    torch.from_numpy(np.split(full, 2, axis=d)[r]))
    assert ranks[0].compiled.zero_dims
    _mh_save(tmp_path, step=3, models=ranks)
    one = _model(seed=99)  # one process: no ZeRO, the whole state
    MultiHostCheckpointManager(str(tmp_path), process_id=0, process_count=1) \
        .restore_elastic(one)
    for (key, op, w), full in whole.items():
        np.testing.assert_array_equal(one.compiled.opt_state[key][op][w].numpy(), full)
    again = zero_model(1)  # rank 1 of a new cohort of two: its own half
    MultiHostCheckpointManager(str(tmp_path), process_id=1, process_count=2).restore(again)
    for (key, op, w), full in whole.items():
        d = again.compiled.zero_dims[(op, w)]
        np.testing.assert_array_equal(again.compiled.opt_state[key][op][w].numpy(),
                                      np.split(full, 2, axis=d)[1])


def _tp_model(shape, rank, zero=False):
    """An MLP whose hidden layer is cut over ``model`` (out, then in),
    compiled as ``rank`` of a ``shape`` mesh that runs no collective;
    ``shape`` None: one process, no mesh."""
    ff = FFModel(FFConfig(batch_size=16, device="cpu", zero_optimizer=zero))
    x = ff.create_tensor((16, 8), name="input")
    t = ff.dense(x, 16, ActiMode.RELU, name="up", strategy={"out": "model"})
    t = ff.softmax(ff.dense(t, 4, name="down", strategy={"in": "model"}))
    mesh = None
    if shape is not None:
        axes = [a for a in shape if shape[a] > 1]
        groups = {key: Group(key, None, (), 0) for n in range(1, len(axes) + 1)
                  for key in itertools.combinations(axes, n)}
        mesh = Mesh(shape, rank, groups)
    ff.compiled = compile_model(ff.config, ff.layers, ff.input_tensors, ff._final_output(),
                                AdamOptimizer(alpha=0.01),
                                LossType.SPARSE_CATEGORICAL_CROSSENTROPY, mesh=mesh,
                                strategies={l.name: l.attrs["strategy"] for l in ff.layers
                                            if l.attrs.get("strategy") and mesh is not None})
    return ff


def _blocks(ff, op, w):
    """(the weight's block, its ZeRO-1 share) of ``ff``'s rank, as slices
    of the whole array."""
    cm = ff.compiled
    if cm.mesh is None:
        return (slice(None),), (slice(None),)
    block = cm.mesh.local_slices(cm.weight_layout(op, w))
    share = list(block)
    d = cm.zero_dims.get((op, w))
    if d is not None:
        n = cm.params[op][w].shape[d] // cm.mesh.degree("data")
        lo = (block[d].start or 0) + cm.mesh.coords["data"] * n
        share[d] = slice(lo, lo + n)
    return block, tuple(share)


@pytest.mark.parametrize("saved,zero,live", [
    ({"model": 2}, False, {"data": 2, "model": 2}),
    ({"data": 2, "model": 2}, True, {"model": 2}),
    ({"data": 2, "model": 2}, True, None),
], ids=["model2-to-data2-model2", "zero-data2-model2-to-model2", "zero-data2-model2-to-one"])
def test_mh_manager_elastic_restore_cuts_every_sharded_axis(tmp_path, saved, zero, live):
    """A cohort whose weights are cut over ``model`` (a ZeRO-1 one also
    over ``data``) resumed on another mesh: each new rank's params and
    Adam moments are its own block of the whole arrays, along every axis,
    whichever saved rank held each part (a pick by the data coordinate
    alone gives rank 3 of {data: 2, model: 2} model 0's blocks)."""
    world = int(np.prod(list(saved.values())))
    ranks = [_tp_model(saved, r, zero) for r in range(world)]
    rng = np.random.default_rng(1)
    whole = {}
    for op, ws in ranks[0].compiled.params.items():
        for w in ws:
            shape = ranks[0].compiled.weight_layout(op, w).sizes
            for tree in ("params", "m", "v"):
                whole[(tree, op, w)] = full = rng.standard_normal(shape).astype(np.float32)
                for ff in ranks:
                    block, share = _blocks(ff, op, w)
                    dst = ff.compiled.params[op][w] if tree == "params" else \
                        ff.compiled.opt_state[tree][op][w]
                    dst.copy_(torch.from_numpy(full[block if tree == "params" else share]))
    assert ranks[0].compiled.params["up"]["kernel"].shape == (8, 8)
    assert (ranks[0].compiled.zero_dims != {}) == zero
    _mh_save(tmp_path, step=3, world=world, models=ranks)
    n = 1 if live is None else int(np.prod(list(live.values())))
    before = _ctr("checkpoint.elastic_resumes")
    for r in range(n):
        ff = _tp_model(live, r)
        assert MultiHostCheckpointManager(str(tmp_path), process_id=r, process_count=n) \
            .restore_elastic(ff) == 3
        for (tree, op, w), full in whole.items():
            block, share = _blocks(ff, op, w)
            got = ff.compiled.params[op][w] if tree == "params" else \
                ff.compiled.opt_state[tree][op][w]
            np.testing.assert_array_equal(got.numpy(), full[block if tree == "params" else share],
                                          err_msg=f"rank {r}: {tree} {op}.{w}")
    assert _ctr("checkpoint.elastic_resumes") == before + n


def test_fit_elastic_resume_on_changed_topology(tmp_path):
    """A shrunk relaunch resuming a cohort's directory: CKPT001 by
    default, the counted portable restore with ``elastic_resume``."""
    ffs, _ = _mh_save(tmp_path, step=4)
    x, y = _data()
    with pytest.raises(CheckpointTopologyError):
        _model(seed=99).fit(x, y, verbose=False, resume_from=str(tmp_path))
    before = _ctr("checkpoint.elastic_resumes")
    ff2 = _model(seed=99, elastic_resume=True)
    hist = ff2.fit(x, y, epochs=1, verbose=False, resume_from=str(tmp_path))
    assert len(hist) == 1 and np.isfinite(hist[-1].sparse_cce_loss)
    assert _ctr("checkpoint.elastic_resumes") == before + 1
    assert ff2.compiled.iteration > 4


# --------------------------------------------------- the real supervisor
@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the CPU-only default")
@pytest.mark.parametrize("entry", ["supervise", "main"])
def test_supervisor_defaults_to_the_card_and_raises_without_one(tmp_path, entry):
    """As ``FFConfig.device``: the workers' device defaults to ``cuda``,
    which raises before any worker starts where no card is visible; a CPU
    cohort asks for ``--device cpu``."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "supervise":
            launch.supervise(nproc=2, run_dir=str(tmp_path))
        else:
            launch.main(["--nproc", "2", "--run-dir", str(tmp_path)])
    assert not (tmp_path / "logs").exists()


@pytest.mark.parametrize("scenarios", [("kill_resume", "shrink_resize"), ("hang_relaunch",)],
                         ids=["kill-shrink", "hang"])
def test_supervised_cohorts_kill_hang_shrink_and_match_one_process_and_jax(tmp_path, scenarios):
    """Real cohorts of two worker processes over gloo, a ZeRO-1 Adam MLP,
    checkpoints every 2 steps: the uninterrupted baseline (in each case);
    a peer killed at step 6, relaunched and resumed bit for bit, then the
    killed cohort's directory resumed by one process through the elastic
    restore; or a peer hung at step 5, detected by its heartbeat and
    relaunched, equal bit for bit. The baseline's params equal the
    one-process fit's and the JAX package's fit from the same start."""
    out = launch.run_matrix(list(scenarios), base_dir=str(tmp_path), job_args={"zero": True},
                            hang_threshold_s=4.0, device="cpu", cohort_timeout_s=300.0)
    assert out["violations"] == [], json.dumps(out, default=str)[:4000]
    rows = out["scenarios"]
    if "kill_resume" in scenarios:
        assert rows["kill_resume"]["bit_identical"] and rows["kill_resume"]["events"] == ["dead"]
        assert rows["shrink_resize"]["elastic_resumes"] == 1
    else:
        assert rows["hang_relaunch"]["events"] == ["hung"]
    with np.load(tmp_path / "baseline" / "params.npz") as z:
        cohort = {}
        for k in z.files:
            op, w = k.split("/")
            cohort.setdefault(op, {})[w] = z[k]
    config = dict(epochs=launch.EPOCHS, device="cpu")
    ff, x, y = launch.mlp_job(config, 1)
    start = ff.numpy_params()
    ff.fit(x, y, verbose=False)
    one = ff.numpy_params()
    jff = _jmodel(seed=3, epochs=launch.EPOCHS)
    cm = jff.compiled
    cm.params = jax.tree_util.tree_map(lambda a, sh: jax.device_put(a, sh), start,
                                       cm.param_shardings)
    cm.opt_state = jff.optimizer.init_state(cm.params)
    jff.fit(x, y, verbose=False)
    for want in (one, _np(jff)):
        for op, ws in want.items():
            for w, a in ws.items():
                atol = TOL * float(np.abs(a).max()) + UPDATE_TOL * float(
                    np.abs(a - start[op][w]).max())
                np.testing.assert_allclose(cohort[op][w], a, rtol=TOL, atol=atol,
                                           err_msg=f"{op}.{w}")
