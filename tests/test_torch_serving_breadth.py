"""Serving breadth: the port's classic engine against the JAX package's
(``flexflow_tpu/serving/engine.py``, ``placement.py``,
``native_bridge.py``'s batcher).

* Both batchers (the native one built from ``native/src/batcher.cc`` and
  the Python one that ``FLEXFLOW_TPU_NATIVE=off`` chooses) keep the
  reference's queue semantics.
* The reference's classifier, its params copied into the port by op
  order, gives the same answers through both engines (f32, 1e-5).
* The reference's degradation tests (``tests/test_faults.py``: respawn,
  abandonment, admission shed and deadlines, breaker) and its stop-race
  tests (``tests/test_serving.py``) pass on the port, every accepted
  future resolving.
* Instance groups refuse a spec mismatch first and then an overlap, with
  the reference's messages; one repository file loads into both engines
  with the same placement and answers.
* With the tracer on, each request's span tree has the reference's names
  and nesting; a small traffic registers the reference's ``serving.*`` and
  ``retry.*`` metric names.
* Continuous-batching generation under the ``serving.worker`` plan
  resolves every future, its greedy tokens those of the plan-less run
  except where a top-2 margin lies within the logits tolerance.
"""

import functools
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu import ActiMode as JActiMode
from flexflow_tpu import DataType as JDataType
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.ffconst import CompMode as JCompMode
from flexflow_tpu.models.gpt import GPTConfig as JGPTConfig
from flexflow_tpu.models.gpt import build_gpt as jbuild_gpt
from flexflow_tpu.obs import metrics as jmetrics
from flexflow_tpu.obs import trace as jtrace
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.serving.engine import InferenceEngine as JInferenceEngine
from flexflow_tpu.serving.engine import ModelInstance as JModelInstance
from flexflow_tpu_torch import (ActiMode, CompMode, DataType, FFConfig, FFModel, LossType,
                                SGDOptimizer, load_numpy_params)
from flexflow_tpu_torch import native_bridge
from flexflow_tpu_torch.models import GPTConfig, build_gpt, build_mlp
from flexflow_tpu_torch.obs import metrics as tmetrics
from flexflow_tpu_torch.obs import trace as ttrace
from flexflow_tpu_torch.runtime import faults as tfaults
from flexflow_tpu_torch.serving import Generator
from flexflow_tpu_torch.serving.engine import (DeadlineExceeded, InferenceEngine,
                                               InferenceRequest, ModelInstance, ShedError,
                                               _make_batcher, _PyBatcher)
from flexflow_tpu_torch.serving import engine as engine_mod
from flexflow_tpu_torch.serving.placement import instance_meshes

from test_serving import _build_classifier
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

CPU = torch.device("cpu")
# f32 answers of one graph in both packages, summed in another order
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# greedy chains may part only where the plan-less run's full-forward top-2
# margin is within this share of its largest |logit| (f32 rounding)
LOGIT_TOL = 1e-5
GPT_SHAPE = dict(vocab_size=50, max_positions=32, hidden_size=32, num_heads=4, num_layers=2)
# names the observability layer registers only on a failure: the
# attribution and advisor publishing's error counter and the serving
# ledger append's retries and give-ups (the appends themselves are counted
# on retry.ledger.attempts in both packages)
OBS_FAILURE_ONLY = {"serving.obs_errors", "retry.ledger.retries", "retry.ledger.giveups"}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    tfaults.configure_faults(None)
    jfaults.configure_faults(None)
    ttrace.configure_tracer(enabled=False)
    jtrace.configure_tracer(enabled=False)


def _ctr(name) -> float:
    m = tmetrics.metrics_registry().get(name)
    return m.value if m is not None else 0.0


def _copy_by_order(jff, tff) -> None:
    """The JAX model's params into the port's, ops paired by order (op
    names come from per-process counters and differ)."""
    jcm, tcm = jff.compiled, tff.compiled
    assert len(jcm.ops) == len(tcm.ops)
    with torch.no_grad():
        for jop, top in zip(jcm.ops, tcm.ops):
            for w, v in jcm.params.get(jop.name, {}).items():
                tcm.params[top.name][w].copy_(torch.from_numpy(np.array(v)))


def _port_classifier(batch=8, d=12, classes=3):
    """``tests/test_serving.py::_build_classifier`` in the port."""
    ff = FFModel(FFConfig(batch_size=batch, seed=0, device="cpu"))
    x = ff.create_tensor((batch, d), DataType.FLOAT, name="x")
    t = ff.dense(x, 32, ActiMode.RELU)
    t = ff.dense(t, classes)
    ff.softmax(t)
    ff.compile(optimizer=SGDOptimizer(lr=0.1),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
    return ff


def _serving_model(plan=None, hidden=16):
    """The reference's fault-test model, built with ``build_mlp``."""
    ff = FFModel(FFConfig(batch_size=8, seed=0, device="cpu", fault_plan=plan,
                          computation_mode=CompMode.INFERENCE))
    build_mlp(ff, 8, in_dim=8, hidden_dims=(hidden,), num_classes=4)
    ff.compile()
    return ff


def _direct(ff, x):
    """One padded forward of up to a batch of rows."""
    cm = ff.compiled
    b = cm.input_tensors[0].dims[0]
    pad = np.concatenate([x, np.zeros((b - len(x),) + x.shape[1:], x.dtype)])
    return cm.forward_fn(cm.params, torch.from_numpy(pad))[:len(x)].numpy()


# --------------------------------------------------------------- batchers
BATCHERS = [pytest.param("python", id="python"), pytest.param("native", id="native")]


def _batcher(kind, max_batch, timeout_s):
    if kind == "python":
        return _PyBatcher(max_batch, timeout_s)
    b = native_bridge.NativeBatcher(max_batch, timeout_s)
    assert isinstance(b, native_bridge.NativeBatcher)
    return b


@pytest.mark.parametrize("kind", BATCHERS)
def test_batcher_full_batch_then_remainder(kind):
    b = _batcher(kind, 2, 10.0)  # a long timeout: only a full batch leaves
    for i in range(3):
        b.submit(i)
    assert b.pending() == 3
    assert b.next_batch() == [0, 1]
    b.close()  # drains the remainder at once
    assert b.next_batch() == [2]
    assert b.next_batch() is None
    b.destroy()


@pytest.mark.parametrize("kind", BATCHERS)
def test_batcher_timeout_releases_partial(kind):
    b = _batcher(kind, 64, 0.05)
    t0 = time.monotonic()
    b.submit(7)
    got = b.next_batch()
    waited = time.monotonic() - t0
    assert got == [7]
    assert waited >= 0.04  # held for about the timeout, waiting for more
    b.close()
    assert b.next_batch() is None
    b.destroy()


@pytest.mark.parametrize("kind", BATCHERS)
def test_batcher_submit_after_close_raises_and_queued_ids_drain(kind):
    b = _batcher(kind, 4, 0.005)
    b.submit(1)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(2)
    assert b.next_batch() == [1]
    assert b.next_batch() is None
    b.destroy()
    b.destroy()  # idempotent
    assert b.pending() == 0
    with pytest.raises(RuntimeError):
        b.submit(3)


def test_make_batcher_is_native_unless_switched_off(monkeypatch):
    monkeypatch.delenv("FLEXFLOW_TPU_NATIVE", raising=False)
    b = _make_batcher(4, 0.01)
    assert isinstance(b, native_bridge.NativeBatcher)
    assert native_bridge.library_path().exists()
    assert "_native_build" in str(native_bridge.library_path())
    b.close()
    b.destroy()
    monkeypatch.setenv("FLEXFLOW_TPU_NATIVE", "off")
    assert isinstance(_make_batcher(4, 0.01), _PyBatcher)


def test_native_build_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "batcher.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.delenv("FLEXFLOW_TPU_NATIVE", raising=False)
    monkeypatch.setattr(native_bridge, "BATCHER_SRC", bad)
    monkeypatch.setattr(native_bridge, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_bridge, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)native batcher build failed.*error"):
        _make_batcher(4, 0.01)
    assert not list((tmp_path / "build").glob("*.so"))


# ------------------------------------------------------ classic parity
@pytest.mark.parametrize("native", ["on", "off"])
def test_classifier_served_by_both_engines_agrees(native, monkeypatch):
    if native == "off":
        monkeypatch.setenv("FLEXFLOW_TPU_NATIVE", "off")
    else:
        monkeypatch.delenv("FLEXFLOW_TPU_NATIVE", raising=False)
    jff = _build_classifier(batch=8)
    tff = _port_classifier(batch=8)
    _copy_by_order(jff, tff)
    xs = np.random.default_rng(1).normal(size=(20, 12)).astype(np.float32)
    outs = []
    for eng in (JInferenceEngine(batch_timeout_s=0.01), InferenceEngine(batch_timeout_s=0.01)):
        eng.register_ffmodel(jff if isinstance(eng, JInferenceEngine) else tff, name="clf")
        try:
            futs = [eng.infer_async("clf", [xs[i]]) for i in range(20)]
            outs.append(np.stack([f.result(timeout=60) for f in futs]))
        finally:
            eng.stop()
    want_batcher = _PyBatcher if native == "off" else native_bridge.NativeBatcher
    eng = InferenceEngine()
    eng.register_ffmodel(tff, name="clf")
    assert isinstance(eng._batchers["clf"], want_batcher)
    eng.stop()
    assert outs[1].shape == (20, 3)
    np.testing.assert_allclose(outs[1], outs[0], **F32_TOL)


# ------------------------------------- degradation (tests/test_faults.py)
def test_serving_worker_crash_respawns_and_futures_resolve():
    before = _ctr("serving.worker_respawns")
    plan = {"schema": 1, "sites": {"serving.worker": {"at_step": 2}}}
    ff = _serving_model(plan)
    eng = InferenceEngine(batch_timeout_s=0.002, worker_retry_budget=2)
    eng.register_ffmodel(ff, "m")
    xs = np.random.default_rng(2).normal(size=(8, 8)).astype(np.float32)
    futs = [eng.infer_async("m", [xs[0]])]
    futs[0].result(60)  # batch 1 served; batch 2 crashes the worker
    futs += [eng.infer_async("m", [xs[i]]) for i in range(1, 8)]
    got = np.stack([f.result(60) for f in futs])  # every future resolves
    eng.stop()
    assert _ctr("serving.worker_respawns") > before
    assert _ctr("faults.serving.worker") >= 1
    np.testing.assert_allclose(got, _direct(ff, xs), **F32_TOL)


def test_serving_abandoned_worker_fails_futures_and_sheds():
    """The budget runs out on the model's only worker: pending futures
    resolve with the abandonment error, and admission sheds."""
    abandoned, failed = _ctr("serving.worker_abandoned"), _ctr("serving.abandoned_failed")
    plan = {"schema": 1, "sites": {"serving.worker": {"p": 1.0}}}
    eng = InferenceEngine(batch_timeout_s=0.002, worker_retry_budget=1)
    eng.register_ffmodel(_serving_model(plan), "doomed")
    futs = [eng.infer_async("doomed", [np.zeros(8, np.float32)]) for _ in range(4)]
    for f in futs:
        with pytest.raises(RuntimeError, match="respawn budget"):
            f.result(60)
    with pytest.raises(ShedError):  # a dead model sheds at admission
        eng.infer_async("doomed", [np.zeros(8, np.float32)])
    eng.stop()
    assert _ctr("serving.worker_abandoned") - abandoned >= 1
    assert _ctr("serving.abandoned_failed") - failed >= 4


def test_serving_admission_shed_and_deadline_reject():
    eng = InferenceEngine(batch_timeout_s=0.05, admission_limit=4, default_deadline_s=0.0002)
    eng.register_ffmodel(_serving_model(), "m")
    shed_before, rej_before = _ctr("serving.shed"), _ctr("serving.deadline_rejects")
    accepted, shed = [], 0
    for _ in range(40):
        try:
            accepted.append(eng.infer_async("m", [np.zeros(8, np.float32)]))
        except ShedError:
            shed += 1
    assert 0 < shed < 40  # bounded: some shed, the queue never collapses
    assert _ctr("serving.shed") - shed_before >= shed
    resolved = deadline = 0
    for f in accepted:
        try:
            f.result(60)
            resolved += 1
        except DeadlineExceeded:
            deadline += 1
    assert resolved + deadline == len(accepted)  # every accepted one resolves
    assert _ctr("serving.deadline_rejects") - rej_before == deadline
    eng.stop()


def test_serving_breaker_opens_then_recovers():
    opens = _ctr("serving.breaker_opens")
    eng = InferenceEngine(batch_timeout_s=0.002, breaker_threshold=2, breaker_cooldown_s=0.3)
    inst = eng.register_ffmodel(_serving_model(), "m")
    real_infer = inst.infer
    inst.infer = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("dead backend"))
    for _ in range(2):
        with pytest.raises(RuntimeError):
            eng.infer_async("m", [np.zeros(8, np.float32)]).result(60)
    with pytest.raises(ShedError, match="breaker"):  # open: shed fast
        eng.infer_async("m", [np.zeros(8, np.float32)])
    assert _ctr("serving.breaker_opens") - opens >= 1
    inst.infer = real_infer
    time.sleep(0.35)  # the cooldown passes: the breaker closes
    assert eng.infer_async("m", [np.zeros(8, np.float32)]).result(60) is not None
    eng.stop()


def test_transient_dispatch_failures_retry_and_answer():
    plan = {"schema": 1, "seed": 2,
            "sites": {"device_put.transient": {"p": 0.5, "max_fires": 2}}}
    retries = _ctr("retry.serving_dispatch.retries")
    ff = _serving_model(plan)
    eng = InferenceEngine(batch_timeout_s=0.002)
    eng.register_ffmodel(ff, "m")
    xs = np.random.default_rng(3).normal(size=(6, 8)).astype(np.float32)
    got = np.stack([eng.infer("m", [x]) for x in xs])
    eng.stop()
    assert _ctr("retry.serving_dispatch.retries") - retries == 2
    np.testing.assert_allclose(got, _direct(ff, xs), **F32_TOL)


# --------------------------------------- stop races (tests/test_serving.py)
def test_engine_stop_concurrent_with_submissions():
    """stop() racing a burst of infer_async calls: no request hangs or hits
    a KeyError; each lands in the re-armed batcher and resolves once the
    engine serves again."""
    ff = _port_classifier(batch=4, d=6, classes=2)
    eng = InferenceEngine(batch_timeout_s=0.002)
    eng.register_ffmodel(ff, name="m")
    expected = eng.infer("m", [np.zeros(6, np.float32)], timeout=60)
    futures, errors = [], []

    def burst():
        for _ in range(12):
            try:
                futures.append(eng.infer_async("m", [np.zeros(6, np.float32)]))
            except RuntimeError as e:  # a clean shutdown refusal is fine
                errors.append(e)
            time.sleep(0.001)

    t = threading.Thread(target=burst)
    t.start()
    time.sleep(0.01)
    eng.stop()  # races the burst
    t.join(timeout=30)
    assert not t.is_alive()
    final = eng.infer("m", [np.zeros(6, np.float32)], timeout=60)
    np.testing.assert_allclose(final, expected)
    for f in futures:
        np.testing.assert_allclose(f.result(timeout=60), expected)
    assert len(futures) + len(errors) == 12
    eng.stop()


def test_engine_registry_accessors_after_stop():
    ff = _port_classifier(batch=4, d=6, classes=2)
    eng = InferenceEngine()
    eng.register_ffmodel(ff, name="m")
    eng.start()
    assert eng.models() == ["m"]
    eng.stop()
    assert eng.models() == ["m"]
    assert len(eng.instances("m")) == 1


def test_stop_fails_parked_requests_cleanly():
    """A request parked in a batcher that stop() closes after its workers
    left gets a clean RuntimeError instead of hanging."""
    ff = _port_classifier(batch=4, d=6, classes=2)
    eng = InferenceEngine()
    eng.register_ffmodel(ff, name="m")
    req = InferenceRequest(0, [np.zeros((1, 6), np.float32)])
    with eng._mu:
        eng._requests["m"][0] = req
    eng._batchers["m"].submit(0)
    eng.stop()
    with pytest.raises(RuntimeError, match="engine stopped"):
        req.future.result(timeout=5)


def test_stop_leaks_a_worker_that_does_not_join(monkeypatch):
    """A worker stuck past stop()'s join is left running and its batcher
    leaked, not raised on; the engine re-arms and serves again."""
    ff = _port_classifier(batch=4, d=6, classes=2)
    eng = InferenceEngine(batch_timeout_s=0.002)
    inst = eng.register_ffmodel(ff, name="m")
    gate = threading.Event()
    real = inst.infer

    def stuck(inputs):
        gate.wait(30)
        return real(inputs)

    inst.infer = stuck
    fut = eng.infer_async("m", [np.zeros(6, np.float32)])
    time.sleep(0.05)  # the worker holds the batch
    monkeypatch.setattr(engine_mod, "_STOP_JOIN_S", 0.05)
    old = eng._batchers["m"]
    eng.stop()  # does not raise
    assert eng._batchers["m"] is not old
    gate.set()
    assert fut.result(30) is not None  # the leaked worker still answers
    inst.infer = real
    assert eng.infer("m", [np.zeros(6, np.float32)], timeout=30) is not None
    eng.stop()


# ------------------------------------------------------- instance groups
def _group_messages(make_engine, other_spec, same_spec):
    eng = make_engine()
    msgs = []
    for inst in (other_spec, same_spec):
        with pytest.raises(ValueError) as e:
            eng.register(inst)
        msgs.append(str(e.value))
    return msgs


def _jax_serving_model(hidden=16):
    ff = JFFModel(JFFConfig(batch_size=8, seed=0, ledger="off"))
    xt = ff.create_tensor((8, 8), JDataType.FLOAT, name="sx")
    t = ff.dense(xt, hidden, JActiMode.RELU)
    t = ff.dense(t, 4)
    ff.softmax(t)
    ff.compile(optimizer=None, loss_type=None, metrics=[])
    return ff


def test_group_refuses_spec_mismatch_then_overlap():
    jeng = JInferenceEngine()
    jeng.register(JModelInstance(_jax_serving_model(), "m"))
    want = _group_messages(lambda: jeng, JModelInstance(_jax_serving_model(24), "m"),
                           JModelInstance(_jax_serving_model(), "m"))
    teng = InferenceEngine()
    teng.register(ModelInstance(_serving_model(), "m"))
    got = _group_messages(lambda: teng, ModelInstance(_serving_model(hidden=24), "m"),
                          ModelInstance(_serving_model(), "m"))
    assert got[0] == want[0]  # "... mixes model specs ..."
    assert got[1].split(":")[0] == want[1].split(":")[0]  # "... overlaps devices ..."
    assert got[1].endswith("['cpu']")
    assert len(teng.instances("m")) == 1
    # a mismatched spec is refused first even where the devices overlap too
    with pytest.raises(ValueError, match="mixes model specs"):
        teng.register(ModelInstance(_serving_model(hidden=24), "m"))
    teng.stop()
    jeng.stop()


def test_placement_carves_disjoint_devices_and_refuses_the_rest():
    devs = [torch.device("cuda", i) for i in range(3)]
    assert instance_meshes(2, {"data": 1}, devs) == devs[:2]
    assert instance_meshes(1, {"data": 1}, devs, offset=2) == devs[2:]
    with pytest.raises(ValueError, match="need 4 devices"):
        instance_meshes(2, {"data": 1}, devs, offset=2)
    # a mesh of two takes two consecutive devices, one a rank
    (place,) = instance_meshes(1, {"data": 2}, devs)
    assert place.mesh_shape == {"data": 2} and list(place.devices) == devs[:2]
    with pytest.raises(ValueError, match="need 4 devices"):
        instance_meshes(2, {"data": 2}, devs)


def _build_for_jax(ff, bs):
    x = ff.create_tensor((bs, 12), JDataType.FLOAT, name="x")
    t = ff.dense(x, 32, JActiMode.RELU)
    t = ff.dense(t, 3)
    return ff.softmax(t)


def _build_for_port(ff, bs):
    x = ff.create_tensor((bs, 12), DataType.FLOAT, name="x")
    t = ff.dense(x, 32, ActiMode.RELU)
    t = ff.dense(t, 3)
    return ff.softmax(t)


def test_repository_loads_into_both_engines_alike(tmp_path):
    cfgfile = tmp_path / "repo.json"
    cfgfile.write_text(json.dumps({"models": {"clf": {"instances": 1, "batch_size": 4}}}))
    jeng, teng = JInferenceEngine(batch_timeout_s=0.01), InferenceEngine(batch_timeout_s=0.01)
    jplaced = jeng.load_repository(str(cfgfile), builders={"clf": _build_for_jax})
    tplaced = teng.load_repository(str(cfgfile), builders={"clf": _build_for_port},
                                   devices=[CPU])
    assert tplaced == jplaced == {"clf": 1}
    (jinst,), (tinst,) = jeng.instances("clf"), teng.instances("clf")
    assert tinst.devices == frozenset({CPU}) and tinst.batch_size == 4
    assert tinst._ff.config.computation_mode is CompMode.INFERENCE
    _copy_by_order(jinst._ff, tinst._ff)
    xs = np.random.default_rng(5).normal(size=(6, 12)).astype(np.float32)
    outs = []
    for eng in (jeng, teng):
        futs = [eng.infer_async("clf", [x]) for x in xs]
        outs.append(np.stack([f.result(120) for f in futs]))
        eng.stop()
    np.testing.assert_allclose(outs[1], outs[0], **F32_TOL)


def test_repository_builder_sets_the_compute_dtype(tmp_path):
    """The repository file has the reference's schema, so a builder picks
    bf16 itself: compile reads the config after the build. Its answers part
    from the f32 instance's by bf16 rounding (within 2^-5 of the largest),
    and by something."""
    cfgfile = tmp_path / "repo.json"
    cfgfile.write_text(json.dumps({"models": {"clf": {"instances": 1, "batch_size": 4}}}))

    def build_bf16(ff, bs):
        ff.config.compute_dtype = "bfloat16"
        return _build_for_port(ff, bs)

    xs = np.random.default_rng(6).normal(size=(4, 12)).astype(np.float32)
    outs, insts = [], []
    for build in (_build_for_port, build_bf16):
        eng = InferenceEngine(batch_timeout_s=0.01)
        eng.load_repository(str(cfgfile), builders={"clf": build}, devices=[CPU])
        (inst,) = eng.instances("clf")
        if insts:
            _copy_by_order(insts[0]._ff, inst._ff)
        insts.append(inst)
        outs.append(np.stack([f.result(120) for f in
                              [eng.infer_async("clf", [x]) for x in xs]]))
        eng.stop()
    assert insts[1]._ff.config.compute_dtype == "bfloat16"
    diff = np.abs(outs[1] - outs[0]).max()
    assert 0 < diff <= 2 ** -5 * np.abs(outs[0]).max()


@pytest.mark.parametrize("entry,err,match", [
    ({"instances": 1, "mesh_shape": {"data": 2}}, ValueError, "need 2 devices"),
    ({"instances": 1, "onnx": "/nonexistent/model.onnx"}, NotImplementedError, "A12"),
    ({"instances": 3, "strategies": {"dense_1": {"out": "model"}}}, ValueError, "need 3 devices"),
    ({"instances": 2}, ValueError, "need 2 devices"),
    ({"instances": 2, "generator": True}, ValueError, "instances must be 1"),
])
def test_repository_refusals(tmp_path, entry, err, match):
    cfgfile = tmp_path / "repo.json"
    cfgfile.write_text(json.dumps({"models": {"clf": entry}}))
    eng = InferenceEngine()
    with pytest.raises(err, match=match):
        eng.load_repository(str(cfgfile), builders={"clf": _build_for_port}, devices=[CPU])
    eng.stop()


def _port_gpt_builder(ff, bs):
    build_gpt(ff, bs, 6, GPTConfig(**GPT_SHAPE))


def test_repository_generator_entry(tmp_path):
    cfgfile = tmp_path / "repo.json"
    cfgfile.write_text(json.dumps({"models": {"lm": {
        "generator": True, "batch_size": 2, "decode_slots": 2, "block_size": 8,
        "max_length": 32, "prefill_buckets": [8, 32]}}}))
    eng = InferenceEngine()
    assert eng.load_repository(str(cfgfile), builders={"lm": _port_gpt_builder},
                               devices=[CPU]) == {"lm": 1}
    assert eng.generators() == ["lm"] and eng.models() == []
    inst = eng.generator("lm")
    dec = inst.decoder
    assert (dec.decode_slots, dec.block_size, dec.max_length, dec.prefill_buckets) == \
        (2, 8, 32, [8, 32])
    prompts = [np.array([1, 5, 7], np.int32), np.array([4, 2, 9, 11], np.int32)]
    futs = [eng.generate_async("lm", p, 5) for p in prompts]
    outs = [f.result(120) for f in futs]
    eng.stop()
    gen = Generator(inst._ff, max_length=32, batch_size=1)
    for p, out in zip(prompts, outs):
        np.testing.assert_array_equal(out, gen.generate(p[None, :], 5)[0])


# --------------------------------------------- spans and metric names
@functools.lru_cache(maxsize=None)
def _gpt_pair():
    """(JAX GPT, port GPT) compiled for inference with the same params."""
    jff = JFFModel(JFFConfig(batch_size=4, seed=0, computation_mode=JCompMode.INFERENCE,
                             ledger="off", audit_programs="off", attribution="off"))
    jbuild_gpt(jff, 4, 6, JGPTConfig(**GPT_SHAPE))
    jff.compile(optimizer=None, loss_type=None, metrics=[],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    tff = FFModel(FFConfig(batch_size=4, seed=0, computation_mode=CompMode.INFERENCE,
                           device="cpu"))
    build_gpt(tff, 4, 6, GPTConfig(**GPT_SHAPE))
    tff.compile()
    rng = np.random.default_rng(0)
    tree = {op: {w: (rng.normal(size=np.shape(v)) * 0.3).astype(np.float32)
                 for w, v in ws.items()} for op, ws in jff.compiled.params.items()}
    jff.compiled.params = jax.tree_util.tree_map(jnp.asarray, tree)
    load_numpy_params(tff, tree)
    return jff, tff


def _traffic(pkg_engine, pkg_clf, pkg_gpt):
    """Five classic requests, then four generation requests."""
    eng = pkg_engine(batch_timeout_s=0.005)
    eng.register_ffmodel(pkg_clf, name="clf")
    futs = [eng.infer_async("clf", [np.full(12, i, np.float32)]) for i in range(5)]
    [f.result(60) for f in futs]
    eng.register_generator(pkg_gpt, name="lm", decode_slots=3, block_size=8, max_length=32)
    futs = [eng.generate_async("lm", np.array([1, 2, 3 + i], np.int32), 4) for i in range(4)]
    [f.result(120) for f in futs]
    eng.stop()


def _span_trees(events):
    """Per request track: its span names in start order, and whether every
    other span lies inside its ``serving.request`` span."""
    tracks = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "serving":
            tracks.setdefault(ev["tid"], []).append(ev)
    trees = []
    for evs in tracks.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        root = evs[0]
        inside = all(root["ts"] - 0.05 <= e["ts"] and
                     e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 0.05 for e in evs[1:])
        trees.append((root["name"], tuple(sorted(e["name"] for e in evs[1:])), inside))
    return sorted(trees)


def test_request_span_trees_match_the_reference():
    jff, tff = _gpt_pair()
    jclf, tclf = _build_classifier(batch=8), _port_classifier(batch=8)
    trees = []
    for eng, clf, gpt, tr, validate in (
            (JInferenceEngine, jclf, jff, jtrace, jtrace.validate_chrome_trace),
            (InferenceEngine, tclf, tff, ttrace, ttrace.validate_chrome_trace)):
        t = tr.configure_tracer(enabled=True)
        t.clear()
        try:
            _traffic(eng, clf, gpt)
        finally:
            tr.configure_tracer(enabled=False)
        events = [e for e in t.events() if e.get("cat") == "serving"]
        assert validate({"traceEvents": events}) == []
        trees.append(_span_trees(events))
    assert len(trees[1]) == 9  # one tree a request
    assert all(inside for _, _, inside in trees[1])
    assert trees[1] == trees[0]


def test_metric_names_match_the_reference(monkeypatch):
    jff, tff = _gpt_pair()
    jclf, tclf = _build_classifier(batch=8), _port_classifier(batch=8)
    names = []
    for mod, eng, clf, gpt in ((jmetrics, JInferenceEngine, jclf, jff),
                               (tmetrics, InferenceEngine, tclf, tff)):
        monkeypatch.setattr(mod, "_REGISTRY", mod.MetricsRegistry())
        _traffic(eng, clf, gpt)
        names.append({n for n in mod.metrics_registry().names()
                      if n.split(".")[0] in ("serving", "retry")})
    want, got = names[0] - OBS_FAILURE_ONLY, names[1] - OBS_FAILURE_ONLY
    assert got == want
    assert "retry.ledger.attempts" in got
    assert {"serving.kv_blocks_in_use", "retry.serving_dispatch.attempts",
            "retry.serving_decode.attempts", "serving.prefill_bucket_compiles"} <= got


# ------------------------------------ generation under the worker plan
def _margins(ff, prompt, out):
    """Top-2 margin of the full causal forward at each generated position,
    and its largest |logit|."""
    cm = ff.compiled
    seq = out.size
    toks = torch.from_numpy(out[None, :].astype(np.int32))
    pos = torch.arange(seq, dtype=torch.int32)[None, :]
    logits = cm.forward_fn(cm.params, toks, pos)[0, prompt.size - 1:seq - 1]
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).numpy(), float(logits.abs().max())


def test_generation_under_worker_plan_resolves_and_keeps_tokens():
    _, tff = _gpt_pair()
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, GPT_SHAPE["vocab_size"], (n,)).astype(np.int32), m)
            for n, m in [(3, 6), (6, 2), (2, 9), (5, 1), (4, 7), (2, 3), (3, 5), (6, 4)]]

    def run(plan):
        tff.config.fault_plan = plan
        try:
            eng = InferenceEngine()
            eng.register_generator(tff, name="lm", decode_slots=3, block_size=8,
                                   max_length=32)
            futs = [eng.generate_async("lm", p, m) for p, m in reqs]
            outs = [f.result(timeout=120) for f in futs]
            eng.stop()
        finally:
            tff.config.fault_plan = None
        return outs

    plain = run(None)
    respawns = _ctr("serving.worker_respawns")
    faulted = run({"schema": 1, "sites": {"serving.worker": {"at_step": 3}}})
    assert _ctr("serving.worker_respawns") - respawns == 1
    for (prompt, m), out, ref in zip(reqs, faulted, plain):
        assert out.shape == ref.shape == (prompt.size + m,)
        diff = np.nonzero(out != ref)[0]
        if diff.size:
            margin, scale = _margins(tff, prompt, ref)
            assert margin[int(diff[0]) - prompt.size] <= LOGIT_TOL * scale


def test_transient_decode_failures_retry_and_keep_tokens(monkeypatch):
    """A ``TransientFault`` from a prefill or decode dispatch is retried by
    ``_DECODE_RETRY`` (``retry.serving_decode.*``), and the tokens are the
    fault-free run's."""
    _, tff = _gpt_pair()
    prompts = [np.array([3, 1, 4], np.int32), np.array([1, 5, 9, 2], np.int32)]

    def run():
        eng = InferenceEngine()
        eng.register_generator(tff, name="lm", decode_slots=2, block_size=8, max_length=32)
        outs = [f.result(120) for f in [eng.generate_async("lm", p, 5) for p in prompts]]
        return eng, outs

    eng, want = run()
    eng.stop()
    retries = _ctr("retry.serving_decode.retries")
    from flexflow_tpu_torch.serving.generation import PagedDecoder

    for method in ("prefill_many", "decode"):
        real = getattr(PagedDecoder, method)
        calls = []

        def flaky(self, *a, real=real, calls=calls, **k):
            calls.append(1)
            if len(calls) == 1:
                raise tfaults.TransientFault("flaky dispatch")
            return real(self, *a, **k)

        monkeypatch.setattr(PagedDecoder, method, flaky)
        eng, got = run()
        eng.stop()
        monkeypatch.setattr(PagedDecoder, method, real)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert _ctr("retry.serving_decode.retries") - retries == 2


def test_kv_gauge_and_quant_fallback_counter():
    from flexflow_tpu_torch.serving import PagedDecoder

    _, tff = _gpt_pair()
    fallbacks = _ctr("serving.kv_dtype_fallbacks")
    dec = PagedDecoder(tff, 32, decode_slots=2, block_size=8, kv_dtype="int8",
                       kv_divergence_budget=1e-12)
    assert dec.kv_dtype == "float32"  # KVQ001: the tiny budget forces the fallback
    assert _ctr("serving.kv_dtype_fallbacks") - fallbacks == 1
    table = dec.pool.try_admit(20)
    gauge = tmetrics.metrics_registry().get("serving.kv_blocks_in_use")
    assert gauge.value == dec.pool.in_use() == 3
    dec.pool.free(table)
    assert gauge.value == 0
