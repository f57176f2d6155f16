"""The rest of the model zoo, held against the JAX package's models.

* Every ``zoo_smoke_builders()`` entry (the same twelve keys) builds the
  same layer list in both packages: op types, names (an unnamed layer's
  name is its op type and a build counter in both, so the counter is
  dropped), output dims and weight shapes.
* DLRM, XDL, CANDLE-Uno, AlexNet (64 px), ResNet-50 with batch norm (64
  px, batch 2) and NMT at the zoo's small sizes: well-scaled params drawn
  with numpy from a seed are copied into both (paired by layer order), then the
  forward and three SGD train steps' losses and params must agree.
  ResNeXt-50 (64 px): the forward. Inception-v3 at 299 px costs a JAX
  compile of the whole network more than this file's budget, so each of
  its module kinds A-E is held on its own (forward and gradients), and
  the whole model by its layer list above.

Tolerance, as a fraction of the largest |value| of the compared tensor:
1e-4 (the same graph summed in another order; the deepest nets carry the
differences through 50 layers and three updates). Every model runs in
float32 but ResNet-50, which runs in float64 in both packages: at batch 2
its float32 gradients hang on which side of 0 a few residual sums round
to (see the test).
"""

import re

import numpy as np
import pytest
import torch

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import models as jmodels
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.core.op import create_op as jcreate_op
from flexflow_tpu.core.parallel_tensor import ParallelTensorShape as JPShape
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.models import inception as jinception
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import (DataType, FFConfig, FFModel, LossType, SGDOptimizer,
                                load_numpy_params)
from flexflow_tpu_torch import models as tmodels
from flexflow_tpu_torch.core.op import create_op
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.models import inception as tinception
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL = 1e-4
LR = 0.05


def _draw(op, ws, rng):
    """Well-scaled params: He-normal conv and dense kernels, unit-scale
    embedding rows, LSTM kernels over their fan-in, batch-norm scales near
    1 and its running statistics at their init, small biases."""
    shape = tuple(ws.shape)
    kind = op.op_type.value
    if ws.name == "running_mean":
        return np.zeros(shape, np.float32)
    if ws.name == "running_var":
        return np.ones(shape, np.float32)
    if kind == "batch_norm" and ws.name == "scale":
        return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    if kind == "embedding":
        a = 0.5 * rng.normal(size=shape)
    elif len(shape) == 1:
        a = 0.1 * rng.normal(size=shape)
    elif kind == "conv2d":
        a = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[1:]))
    else:
        a = rng.normal(size=shape) * np.sqrt((2.0 if kind == "linear" else 1.0) / shape[0])
    return a.astype(np.float32)


@pytest.fixture(autouse=True)
def _jax_init(monkeypatch):
    """The JAX package draws each weight with its own jitted program, which
    compiles hundreds of programs for ResNet-50 on the CPU; here its
    compile draws well-scaled params from numpy instead (the port then
    gets them by ``load_numpy_params``)."""
    from flexflow_tpu.runtime import compiler as jcompiler

    def init_params(ops, mesh, seed, dtype_override=None):
        rng = np.random.default_rng(seed)
        params, shardings, wd_mask = {}, {}, {}
        for op in ops:
            for ws in op.weight_specs():
                params.setdefault(op.name, {})[ws.name] = jax.numpy.asarray(
                    _draw(op, ws, rng), dtype_override or ws.dtype.to_jnp())
                shardings.setdefault(op.name, {})[ws.name] = jcompiler._named_sharding(
                    mesh, op.weight_shapes[ws.name])
                wd_mask.setdefault(op.name, {})[ws.name] = ws.weight_decay
        return params, shardings, wd_mask

    monkeypatch.setattr(jcompiler, "init_params", init_params)


def _jff(batch):
    return JFFModel(JFFConfig(batch_size=batch, ledger="off", audit_programs="off",
                              attribution="off"))


def _tff(batch):
    return FFModel(FFConfig(batch_size=batch, device="cpu"))


def _plain_name(layer):
    return re.sub(rf"^{re.escape(layer.op_type.value)}_\d+$", layer.op_type.value,
                  layer.name)


def _layer_list(ff, make_op, pshape):
    out = []
    for layer in ff.layers:
        op = make_op(layer, [pshape.unpartitioned(t.dims, t.dtype) for t in layer.inputs])
        out.append((layer.op_type.value, _plain_name(layer),
                    [tuple(t.dims) for t in layer.outputs],
                    [(s.name, tuple(s.shape)) for s in op.weight_specs()]))
    return out


def test_zoo_smoke_builders_have_the_same_keys():
    assert list(tmodels.zoo_smoke_builders()) == list(jmodels.zoo_smoke_builders())


@pytest.mark.parametrize("name", list(jmodels.zoo_smoke_builders()))
def test_zoo_builds_the_same_layer_list(name):
    jff, tff = _jff(2), _tff(2)
    jmodels.zoo_smoke_builders()[name](jff, 2)
    tmodels.zoo_smoke_builders()[name](tff, 2)
    assert [(t.name, tuple(t.dims), t.dtype.value) for t in tff.input_tensors] == \
        [(t.name, tuple(t.dims), t.dtype.value) for t in jff.input_tensors]
    assert _layer_list(tff, create_op, ParallelTensorShape) == \
        _layer_list(jff, jcreate_op, JPShape)


def test_sharded_tables_raise_naming_a7():
    """DLRM's ``param_axis`` and XDL's ``embedding_strategy`` build since
    A7b: every table carries the vocab strategy, as the JAX package's
    builders give it, and shards its rows over {model: 2} (the values over
    ranks are ``test_torch_sharded_ops.py``'s)."""
    from flexflow_tpu.runtime.compiler import build_ops as jbuild_ops
    from flexflow_tpu_torch.runtime.compiler import build_ops

    cases = ((tmodels.build_dlrm, jmodels.build_dlrm, tmodels.DLRMConfig, jmodels.DLRMConfig,
              dict(param_axis="model")),
             (tmodels.build_xdl, jmodels.build_xdl, tmodels.XDLConfig, jmodels.XDLConfig,
              dict(embedding_strategy={"vocab": "model"})))
    for build, jbuild, cfg, jcfg, kw in cases:
        tff, jff = _tff(2), _jff(2)
        build(tff, 2, cfg(embedding_size=[10] * 4), **kw)
        jbuild(jff, 2, jcfg(embedding_size=[10] * 4), **kw)
        strat = {l.name: l.attrs.get("strategy") for l in tff.layers if l.attrs.get("strategy")}
        jstrat = {l.name: l.attrs.get("strategy") for l in jff.layers if l.attrs.get("strategy")}
        assert strat == jstrat and len(strat) == 4
        ops, _ = build_ops(tff.layers, {t.tensor_id: ParallelTensorShape.unpartitioned(
            t.dims, t.dtype) for t in tff.input_tensors}, {"model": 2}, strat)
        jops, _ = jbuild_ops(jff.layers, {t.tensor_id: JPShape.unpartitioned(t.dims, t.dtype)
                                          for t in jff.input_tensors}, {"model": 2}, jstrat)
        jby = {o.name: o for o in jops}
        for o in ops:
            if o.name in strat:
                assert o.weight_shapes["weight"].partition_spec() == ("model", None)
                assert o.weight_shapes["weight"].partition_spec() == \
                    tuple(jby[o.name].weight_shapes["weight"].partition_spec())


# ---- numerical parity --------------------------------------------------------


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _pair(build, batch, loss):
    """Both packages built by ``build(ff, pkg)``, compiled with SGD and
    ``loss`` (a LossType name, or None for inference only) on one device;
    the JAX init params copied into the port, paired by layer order.
    Returns (jff, tff, {jax op name: port op name})."""
    jff, tff = _jff(batch), _tff(batch)
    build(jff, jmodels)
    build(tff, tmodels)
    names = {jl.name: tl.name for jl, tl in zip(jff.layers, tff.layers)}
    jkw = dict(mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    if loss:
        jff.compile(optimizer=JSGDOptimizer(lr=LR), loss_type=getattr(JLossType, loss), **jkw)
        tff.compile(optimizer=SGDOptimizer(lr=LR), loss_type=getattr(LossType, loss))
    else:
        jff.compile(**jkw)
        tff.compile()
    tree = {names[op]: {w: np.asarray(v) for w, v in ws.items()}
            for op, ws in jff.compiled.params.items()}
    load_numpy_params(tff, tree)
    if loss:
        tff.compiled.opt_state = tff.optimizer.init_state(tff.compiled.params)
    return jff, tff, names


def _inputs(ff, rng, dtype=np.float32):
    xs = []
    for t in ff.compiled.input_tensors:
        if t.dtype is DataType.INT32:
            # ids in range; the tables' sizes are the embedding ops'
            vocab = min(op.attrs["num_entries"] for op in ff.compiled.ops
                        if op.op_type.value == "embedding"
                        and op.layer.inputs[0].tensor_id == t.tensor_id)
            xs.append(rng.integers(0, vocab, size=t.dims).astype(np.int32))
        else:
            xs.append(rng.normal(size=t.dims).astype(dtype))
    return xs


def _as_float64(jff, tff):
    """Both models' params (and fresh optimizer state) in float64."""
    jcm, tcm = jff.compiled, tff.compiled
    jcm.params = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a, np.float64),
                                        jcm.params)
    jcm.opt_state = jff.optimizer.init_state(jcm.params)
    tcm.params = {op: {w: v.double() for w, v in ws.items()} for op, ws in tcm.params.items()}
    tcm.opt_state = tff.optimizer.init_state(tcm.params)


def _labels(ff, loss, rng):
    dims = ff.compiled.logits_tensor.dims
    if loss == "SPARSE_CATEGORICAL_CROSSENTROPY":
        return rng.integers(0, dims[-1], size=dims[:-1]).astype(np.int32).reshape(dims[0], -1)
    return rng.uniform(size=dims).astype(np.float32)


def _forward_and_steps(jff, tff, names, loss, steps=3, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    jcm, tcm = jff.compiled, tff.compiled
    xs = _inputs(tff, rng, dtype)
    want = np.asarray(jcm.forward_fn(jcm.params, *xs))
    got = tcm.forward_fn(tcm.params, *(torch.from_numpy(a) for a in xs))
    assert np.isfinite(want).all()
    _close(got.numpy(), want, "forward")
    for i in range(steps):
        xs, y = _inputs(tff, rng, dtype), _labels(tff, loss, rng)
        jcm.params, jcm.opt_state, jloss, _ = jcm.train_step(
            jcm.params, jcm.opt_state, jax.random.key(i), *xs, y)
        tcm.params, tcm.opt_state, tloss, _ = tcm.train_step(
            tcm.params, tcm.opt_state, i, *(torch.from_numpy(a) for a in xs + [y]))
        _close(tloss.item(), float(jloss), f"loss at step {i}")
    for jop, ws in jcm.params.items():
        for w, v in ws.items():
            assert tcm.params[names[jop]][w].dtype == getattr(torch, str(v.dtype))
            _close(tcm.params[names[jop]][w].numpy(), v, f"{jop}.{w} after {steps} steps")


SMALL = {
    "dlrm": (lambda ff, m: m.build_dlrm(ff, 4, m.DLRMConfig(embedding_size=[1000] * 4)),
             4, "MEAN_SQUARED_ERROR_AVG_REDUCE"),
    "xdl": (lambda ff, m: m.build_xdl(ff, 4, m.XDLConfig(embedding_size=[1000] * 4)),
            4, "MEAN_SQUARED_ERROR_AVG_REDUCE"),
    "candle_uno": (lambda ff, m: m.build_candle_uno(ff, 4, m.CandleUnoConfig(
        dense_layers=[64] * 2, dense_feature_layers=[64] * 2)),
        4, "MEAN_SQUARED_ERROR_AVG_REDUCE"),
    "alexnet": (lambda ff, m: m.build_alexnet(ff, 2, image_size=64), 2,
                "SPARSE_CATEGORICAL_CROSSENTROPY"),
    # float64 (below)
    "resnet50_bn": (lambda ff, m: m.build_resnet50(ff, 2, image_size=64, use_bn=True), 2,
                    "SPARSE_CATEGORICAL_CROSSENTROPY"),
    "nmt": (lambda ff, m: m.build_nmt(ff, 4, m.NMTConfig(
        src_vocab_size=200, tgt_vocab_size=200, embed_dim=32, hidden_size=32,
        num_layers=2, src_length=8, tgt_length=8)), 4, "SPARSE_CATEGORICAL_CROSSENTROPY"),
}


@pytest.mark.parametrize("name", list(SMALL))
def test_forward_and_three_sgd_steps_match_jax(name):
    build, batch, loss = SMALL[name]
    if name != "resnet50_bn":
        _forward_and_steps(*_pair(build, batch, loss), loss)
        return
    # ResNet-50 at batch 2 and 64 px normalises its last stage over 8
    # values a channel, and in float32 a residual sum within ~1e-5 of 0
    # lands on either side of its ReLU in either package (or in a float64
    # run of either), moving that channel's gradients by 10-20 %. The
    # comparison runs in float64 in both packages, where no sum is that
    # close to 0 and the same math must agree; the loss alone is float32
    # in both (each casts the logits to f32 for it).
    with jax.enable_x64(True):
        jff, tff, names = _pair(build, batch, loss)
        _as_float64(jff, tff)
        _forward_and_steps(jff, tff, names, loss, dtype=np.float64)


def test_resnext50_forward_matches_jax():
    jff, tff, _ = _pair(lambda ff, m: m.build_resnext50(ff, 2, image_size=64), 2, None)
    x = np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(np.float32)
    want = np.asarray(jff.compiled.forward_fn(jff.compiled.params, x))
    got = tff.compiled.forward_fn(tff.compiled.params, torch.from_numpy(x))
    _close(got.numpy(), want, "forward")


# each Inception module kind on its own input (batch 2, 16 channels, 9x9)
MODULES = {
    "a": lambda ff, m, x: m._inception_a(ff, x, 32, "a1"),
    "b": lambda ff, m, x: m._inception_b(ff, x, "b1"),
    "c": lambda ff, m, x: m._inception_c(ff, x, 128, "c1"),
    "d": lambda ff, m, x: m._inception_d(ff, x, "d1"),
    "e": lambda ff, m, x: m._inception_e(ff, x, "e1"),
}


@pytest.mark.parametrize("kind", list(MODULES))
def test_inception_module_matches_jax(kind):
    def build(ff, pkg):
        mod = jinception if pkg is jmodels else tinception
        x = ff.create_tensor((2, 16, 9, 9), name="input")
        t = MODULES[kind](ff, mod, x)
        ff.dense(ff.flat(t), 10, name="logits")

    jff, tff, names = _pair(build, 2, "MEAN_SQUARED_ERROR_AVG_REDUCE")
    _forward_and_steps(jff, tff, names, "MEAN_SQUARED_ERROR_AVG_REDUCE", steps=1)


# ---- the port's entry points -------------------------------------------------

# the eight models of this slice at the zoo's small sizes, with the loss
# each trains with
ENTRY = {"alexnet": "SPARSE_CATEGORICAL_CROSSENTROPY",
         "resnet50": "SPARSE_CATEGORICAL_CROSSENTROPY",
         "resnext50": "SPARSE_CATEGORICAL_CROSSENTROPY",
         "inception_v3": "SPARSE_CATEGORICAL_CROSSENTROPY",
         "dlrm": "MEAN_SQUARED_ERROR_AVG_REDUCE",
         "xdl": "MEAN_SQUARED_ERROR_AVG_REDUCE",
         "candle_uno": "MEAN_SQUARED_ERROR_AVG_REDUCE",
         "nmt": "SPARSE_CATEGORICAL_CROSSENTROPY"}


@pytest.mark.parametrize("name", list(ENTRY))
def test_zoo_model_fits_evals_and_serves(name):
    """compile -> fit (one epoch of two steps) -> eval, then one burst
    through ``InferenceEngine.register_ffmodel``: finite losses, the
    weights moved, and every served answer equal to the compiled forward
    of the same rows."""
    from flexflow_tpu_torch.serving import InferenceEngine

    ff = _tff(2)
    tmodels.zoo_smoke_builders()[name](ff, 2)
    loss = ENTRY[name]
    ff.compile(SGDOptimizer(lr=0.01), getattr(LossType, loss), metrics=["mean_squared_error"]
               if loss.startswith("MEAN") else ["accuracy"])
    rng = np.random.default_rng(0)
    xs = [np.concatenate([a, b]) for a, b in zip(_inputs(ff, rng), _inputs(ff, rng))]
    y = np.concatenate([_labels(ff, loss, rng), _labels(ff, loss, rng)])
    before = {op: {w: v.clone() for w, v in ws.items()} for op, ws in ff.compiled.params.items()}
    ff.fit(xs, y, verbose=False)
    moved = [not torch.equal(v, before[op][w])
             for op, ws in ff.compiled.params.items() for w, v in ws.items()]
    assert sum(moved) > len(moved) // 2
    pm = ff.eval(xs, y, verbose=False)
    assert pm.train_all > 0
    eng = InferenceEngine()
    try:
        eng.register_ffmodel(ff, "m")
        futs = [eng.infer_async("m", [a[i] for a in xs]) for i in range(4)]
        served = np.stack([f.result(120) for f in futs])
    finally:
        eng.stop()
    want = ff.compiled.forward_fn(ff.compiled.params,
                                  *(torch.from_numpy(a) for a in xs)).numpy()
    np.testing.assert_allclose(served, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(want).all()
