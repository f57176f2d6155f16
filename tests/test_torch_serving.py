"""The slice as a whole: the reference Transformer served by both packages.

``build_transformer`` is built small in both packages. The JAX model is
compiled for inference on one device with the Pallas kernels in the
interpreter, so its attention really runs the flash kernel; its params
are copied into the port with ``load_numpy_params``. Then one padded batch
through each ``ModelInstance.infer``, and a burst of single-sample
requests through each ``InferenceEngine``, must agree request by request.
"""

import numpy as np
import pytest
import torch

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.ffconst import CompMode as JCompMode
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.serving.engine import InferenceEngine as JInferenceEngine
from flexflow_tpu.serving.engine import ModelInstance as JModelInstance
from flexflow_tpu_torch import CompMode, FFConfig, FFModel, load_numpy_params
from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer
from flexflow_tpu_torch.serving.engine import InferenceEngine, ModelInstance
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH = 2
SHAPE = dict(hidden_size=128, embedding_size=128, num_heads=4, num_layers=2,
             sequence_length=32)
# Tolerances: atol is a fraction of the largest output of the batch.
# f32: the same graph in the same precision, summed in another order
# (seen: 1e-6 of the output scale).
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: both packages cast each op's inputs, weights and outputs to bf16;
# where they round an intermediate differently the outputs move by bf16
# ulps (2^-8 relative each). Allow four at the output scale.
BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -6)


def _params(jff, seed=0):
    """Random params with a variance-preserving scale (std sqrt(gain /
    fan_in), gain 2 after a ReLU) and small random biases. The JAX init
    (Glorot, zero biases) shrinks every layer of this residual-free stack
    by orders of magnitude, and outputs that small are set by rounding
    and cancellation rather than by the model."""
    rng = np.random.default_rng(seed)
    tree = {}
    for op, ws in jff.compiled.params.items():
        tree[op] = {}
        for w, v in ws.items():
            shape = tuple(v.shape)
            if len(shape) == 1 or w.startswith("b"):
                std = 0.1
            else:
                fan_in = shape[0] if w in ("wq", "wk", "wv") else int(np.prod(shape[:-1]))
                std = np.sqrt((2.0 if op.endswith("ff2") else 1.0) / fan_in)
            tree[op][w] = (rng.normal(size=shape) * std).astype(np.float32)
    return tree


def _port_model(compute_dtype):
    tff = FFModel(FFConfig(batch_size=BATCH,
                           computation_mode=CompMode.INFERENCE,
                           compute_dtype=compute_dtype, device="cpu"))
    build_transformer(tff, BATCH, TransformerConfig(**SHAPE))
    tff.compile()
    return tff


@pytest.fixture(scope="module", params=[(None, F32_TOL), ("bfloat16", BF16_TOL)],
                ids=["float32", "bfloat16"])
def models(request):
    """(JAX model, port model, tolerance) with the same params. The Pallas
    interpreter must be on while the JAX model compiles: compile traces the
    forward, and that trace is the one its first dispatch replays."""
    compute_dtype, tol = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
        jff = JFFModel(JFFConfig(batch_size=BATCH,
                             computation_mode=JCompMode.INFERENCE,
                                 compute_dtype=compute_dtype, ledger="off",
                                 audit_programs="off"))
        jbuild_transformer(jff, BATCH, JTransformerConfig(**SHAPE))
        jff.compile(mesh=make_mesh({"data": 1}, jax.devices()[:1]))
        jff.compiled.params = jax.tree_util.tree_map(jax.numpy.asarray,
                                                     _params(jff))
        tff = _port_model(compute_dtype)
        load_numpy_params(tff, jax.tree_util.tree_map(np.asarray,
                                                      jff.compiled.params))
        yield jff, tff, tol


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, SHAPE["sequence_length"],
                            SHAPE["hidden_size"])).astype(np.float32)


def _scale_tol(tol, ref):
    return dict(rtol=tol["rtol"], atol=tol["atol"] * float(np.abs(ref).max()))


def test_model_instance_infer_matches_jax(models, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
    jff, tff, tol = models
    x = _requests(BATCH - 1)  # one row short: exercises the padding
    want = JModelInstance(jff).infer([x])[0]
    got = ModelInstance(tff).infer([x])[0]
    assert got.shape == want.shape == (BATCH - 1, SHAPE["sequence_length"], 1)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **_scale_tol(tol, want))


def test_engine_burst_matches_jax_request_by_request(models, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
    jff, tff, tol = models
    xs = _requests(5, seed=1)
    jeng, teng = JInferenceEngine(), InferenceEngine()
    jeng.register_ffmodel(jff, "t")
    inst = teng.register_ffmodel(tff, "t")
    try:
        jfuts = [jeng.infer_async("t", [x]) for x in xs]
        tfuts = [teng.infer_async("t", [x]) for x in xs]
        want = [f.result(120) for f in jfuts]
        got = [f.result(120) for f in tfuts]
    finally:
        jeng.stop()
        teng.stop()
    assert inst.dispatches >= 3  # five requests in batches of at most two
    tol = _scale_tol(tol, np.stack(want))
    for g, w in zip(got, want):
        assert g.shape == (SHAPE["sequence_length"], 1)
        np.testing.assert_allclose(g, w, **tol)


def test_engine_rejects_malformed_request_and_serves_after_stop():
    tff = _port_model(None)
    eng = InferenceEngine()
    eng.register_ffmodel(tff, "t")
    with pytest.raises(ValueError, match="per-request shape"):
        eng.infer_async("t", [np.zeros((3, 3), np.float32)])
    x = _requests(1)[0]
    first = eng.infer("t", [x])
    eng.stop()
    again = eng.infer("t", [x])  # a stopped engine re-arms on the next request
    eng.stop()
    np.testing.assert_array_equal(first, again)


def test_load_numpy_params_checks_names_shapes_and_dtypes():
    tff = _port_model(None)
    good = {op: {w: v.numpy().copy() for w, v in ws.items()}
            for op, ws in tff.compiled.params.items()}
    bad_shape = {op: dict(ws) for op, ws in good.items()}
    bad_shape["head"]["kernel"] = np.zeros((3, 1), np.float32)
    bad_dtype = {op: dict(ws) for op, ws in good.items()}
    bad_dtype["head"]["kernel"] = good["head"]["kernel"].astype(np.float64)
    missing = {op: ws for op, ws in good.items() if op != "head"}
    for tree in (bad_shape, bad_dtype, missing):
        with pytest.raises(ValueError):
            load_numpy_params(tff, tree)
    load_numpy_params(tff, good)
    assert torch.equal(tff.compiled.params["head"]["kernel"],
                       torch.from_numpy(good["head"]["kernel"]))

