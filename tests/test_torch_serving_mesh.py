"""Serving over a mesh, the counterparts of ``tests/test_serving.py``'s
instance groups on disjoint submeshes and its repository file: an
instance over a mesh is a group of rank processes over gloo on the CPU
(``serving/group.py``), each rank's device a ``cpu:<k>`` label so the
placements stay disjoint. The answers are held to the JAX package
compiled over the same mesh on as many host devices, with the same
weights (1e-5 of the largest |value|: sums in another order). Generation
over {model: 2}: the dense ``Generator`` with every rank in step, and a
repository ``"generator": true`` entry served by a rank group, each held
to the JAX dense ``Generator`` (the prefill's logits within 2e-5 of the
largest |logit|, as ``test_torch_gpt.py``; greedy tokens equal). A dead
rank fails its batch at once, a stopped rank within the group's
deadline, the next batch starts a new group, and ``stop()`` reaps every
rank."""

import functools
import json
import os
import signal
import time

import numpy as np
import pytest

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh as jmake_mesh
from flexflow_tpu.ffconst import ActiMode as JActiMode
from flexflow_tpu.ffconst import CompMode as JCompMode
from flexflow_tpu.ffconst import DataType as JDataType
from flexflow_tpu.models.gpt import GPTConfig as JGPTConfig
from flexflow_tpu.models.gpt import build_gpt as jbuild_gpt
from flexflow_tpu.serving.generation import Generator as JGenerator
from flexflow_tpu.serving.placement import instance_meshes as jinstance_meshes
from flexflow_tpu_torch.obs.metrics import metrics_registry
from flexflow_tpu_torch.parallel.distributed import spawn
from flexflow_tpu_torch.serving import InferenceEngine
from flexflow_tpu_torch.serving.group import GroupFailure, GroupSpec, MeshInstance
from flexflow_tpu_torch.serving.placement import instance_meshes

import _torch_mesh_workers as workers
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL = 1e-5
GEN_TOL = 2e-5
CPUS = [f"cpu:{i}" for i in range(8)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


def _jax_classifier(mesh, weights, model_axis=None, strategies=None):
    """The JAX package's classifier over ``mesh`` with the port
    instance's weights (by op order)."""
    jff = JFFModel(JFFConfig(batch_size=4, computation_mode=JCompMode.INFERENCE,
                             ledger="off", audit_programs="off", attribution="off"))
    x = jff.create_tensor((4, 12), JDataType.FLOAT, name="x")
    t = jff.dense(x, 32, JActiMode.RELU, strategy={"out": model_axis} if model_axis else None)
    jff.softmax(jff.dense(t, 3))
    jff.compile(optimizer=None, loss_type=None, metrics=[], mesh=mesh, strategies=strategies)
    cm = jff.compiled
    names = [op.name for op in cm.ops if op.name in cm.params]
    tree = dict(zip(names, weights))
    cm.params = jax.tree_util.tree_map(lambda a, sh: jax.device_put(a, sh), tree,
                                       cm.param_shardings)
    return cm


def _jax_answers(cm, xs):
    out = []
    for i in range(0, len(xs), 4):
        chunk = xs[i:i + 4]
        pad = np.concatenate([chunk, np.zeros((4 - len(chunk), 12), np.float32)])
        out.append(np.asarray(cm.forward_fn(cm.params, pad))[:len(chunk)])
    return np.concatenate(out)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def test_multi_instance_disjoint_submeshes():
    """Two models, three instances, each a rank group on disjoint devices:
    model A two instances of {data: 2}, model B one of {data: 2, model:
    2} with its hidden features sharded; every instance serves instance
    0's weights; another A instance on devices A uses is refused before a
    rank starts; both models serve interleaved requests, each answer the
    JAX package's on the same mesh."""
    eng = InferenceEngine(batch_timeout_s=0.01)
    try:
        meshes_a = instance_meshes(2, {"data": 2}, CPUS)
        eng.register_built_instances(workers.serving_classifier, "a", meshes_a, batch_size=4)
        meshes_b = instance_meshes(1, {"data": 2, "model": 2}, CPUS, offset=4)
        eng.register_built_instances(functools.partial(workers.serving_classifier,
                                                       model_axis="model"),
                                     "b", meshes_b, batch_size=4)
        insts_a, (inst_b,) = eng.instances("a"), eng.instances("b")
        assert all(isinstance(i, MeshInstance) for i in insts_a + [inst_b])
        assert not (insts_a[0].devices & insts_a[1].devices)
        assert not ((insts_a[0].devices | insts_a[1].devices) & inst_b.devices)
        for w0, w1 in zip(insts_a[0].weights, insts_a[1].weights):
            for k in w0:
                np.testing.assert_array_equal(w0[k], w1[k])
        with pytest.raises(ValueError, match="overlap"):
            eng.register_built_instances(workers.serving_classifier, "a", meshes_a[:1],
                                         batch_size=4)
        rng = np.random.default_rng(0)
        xa = rng.normal(size=(6, 12)).astype(np.float32)
        xb = rng.normal(size=(6, 12)).astype(np.float32)
        futs = []
        for i in range(6):
            futs.append(("a", i, eng.infer_async("a", [xa[i]])))
            futs.append(("b", i, eng.infer_async("b", [xb[i]])))
        outs = {(m, i): f.result(120) for m, i, f in futs}
        pids = [p for i in insts_a + [inst_b] for p in i.group._procs]
    finally:
        eng.stop()
    assert pids and not any(p.is_alive() for p in pids)  # stop() reaped every rank
    devs = jax.devices()
    ja = _jax_answers(_jax_classifier(jinstance_meshes(1, {"data": 2}, devs)[0],
                                      insts_a[0].weights), xa)
    jb = _jax_answers(_jax_classifier(jinstance_meshes(1, {"data": 2, "model": 2}, devs,
                                                       offset=4)[0],
                                      inst_b.weights, model_axis="model"), xb)
    for i in range(6):
        _close(outs[("a", i)], ja[i])
        _close(outs[("b", i)], jb[i])


def test_repository_config_file_and_generation_over_a_model_axis(tmp_path):
    """A repository file places a classifier over {model: 2} (its entry's
    strategies shard the hidden layer) and a GPT generator over {model:
    2}; the classifier answers as the JAX package's over its mesh, the
    generator's greedy tokens equal the JAX dense Generator's, and so do
    the dense Generator's over the same mesh with every rank in step (the
    K/V cache holds each rank's two heads of four)."""
    cfgfile = tmp_path / "repo.json"
    cfgfile.write_text(json.dumps({"models": {
        "clf": {"instances": 1, "mesh_shape": {"model": 2}, "batch_size": 4,
                "strategies": {"dense_s": {"out": "model"}}},
        "lm": {"generator": True, "mesh_shape": {"model": 2}, "batch_size": 2,
               "decode_slots": 2, "block_size": 8, "max_length": 32,
               "prefill_buckets": [8, 32]}}}))
    builders = {"clf": functools.partial(workers.serving_classifier, model_axis="model"),
                "lm": workers.serving_gpt}
    eng = InferenceEngine(batch_timeout_s=0.01)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 12)).astype(np.float32)
    prompts = rng.integers(0, workers.SERVING_GPT["vocab_size"], (2, 8)).astype(np.int32)
    new = 6
    try:
        assert eng.load_repository(str(cfgfile), builders=builders, devices=CPUS) == \
            {"clf": 1, "lm": 1}
        (clf,) = eng.instances("clf")
        got = np.stack([eng.infer("clf", [row], timeout=120) for row in x])
        gen = eng.generator("lm")
        lm_weights = gen.decoder.group.weights
        served = [eng.generate("lm", p, new, timeout=120) for p in prompts]
        assert gen.stats()["decode_steps"] == gen.stats()["decode_dispatches"]
    finally:
        eng.stop()
    assert gen.decoder.group._procs == []
    want = _jax_answers(_jax_classifier(jinstance_meshes(1, {"model": 2}, jax.devices())[0],
                                        clf.weights, model_axis="model"), x)
    _close(got, want)
    # the dense Generator over {model: 2}, every rank in step
    ranks = spawn(workers.tp_generate, 2, lm_weights, prompts, new)
    jff = JFFModel(JFFConfig(batch_size=2, computation_mode=JCompMode.INFERENCE, ledger="off",
                             audit_programs="off", attribution="off"))
    jbuild_gpt(jff, 2, 8, JGPTConfig(**workers.SERVING_GPT))
    jff.compile(optimizer=None, loss_type=None, metrics=[],
                mesh=jmake_mesh({"data": 1}, jax.devices()[:1]))
    names = [op.name for op in jff.compiled.ops if op.name in jff.compiled.params]
    jff.compiled.params = jax.tree_util.tree_map(jax.numpy.asarray,
                                                 dict(zip(names, lm_weights)))
    jgen = JGenerator(jff, max_length=32)
    jtokens = jgen.generate(prompts, new)
    jlast = np.asarray(jgen.prefill(prompts)[0])
    for r in ranks:
        assert set(r["heads"].values()) == {workers.SERVING_GPT["num_heads"] // 2}
        _close(r["last"], jlast, GEN_TOL)
        np.testing.assert_array_equal(r["tokens"], jtokens)
    for p, out in zip(prompts, served):
        row = int(np.where((prompts == p).all(1))[0][0])
        np.testing.assert_array_equal(out, jtokens[row])


def test_a_dead_or_stopped_rank_fails_its_batch_and_the_group_restarts():
    """Killing a rank fails the batch at once; the next batch starts a new
    group (counted) and is served; a stopped rank fails its batch within
    the dispatch deadline and never hangs the engine; ``stop()`` reaps
    every rank."""
    spec = GroupSpec(workers.serving_classifier, {"data": 2}, ("cpu:0", "cpu:1"), 4)
    inst = MeshInstance(spec, name="m", dispatch_timeout_s=6.0, group_timeout_s=6.0)
    eng = InferenceEngine(batch_timeout_s=0.005)
    eng.register(inst)
    x = np.random.default_rng(1).normal(size=12).astype(np.float32)
    restarts = metrics_registry().counter("serving.group_restarts")
    try:
        ref = eng.infer("m", [x], timeout=120)
        for sig, deadline in ((signal.SIGKILL, 3.0), (signal.SIGSTOP, 15.0)):
            before = restarts.value
            os.kill(inst.group.pids[1], sig)
            t0 = time.monotonic()
            with pytest.raises(GroupFailure):
                eng.infer("m", [x], timeout=120)
            assert time.monotonic() - t0 < deadline
            assert not inst.group.alive
            np.testing.assert_array_equal(eng.infer("m", [x], timeout=120), ref)
            assert restarts.value == before + 1 and inst.restarts >= 1
        procs = list(inst.group._procs)
    finally:
        eng.stop()
    assert procs and not any(p.is_alive() for p in procs)
