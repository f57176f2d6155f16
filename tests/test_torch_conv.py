"""The port's Conv2D, Pool2D and BatchNorm against the JAX package's, and
BatchNorm's running statistics through the compiled steps.

Ops are built in both packages from the same attrs and input shapes;
inputs, weights and the output's cotangent are made with numpy from a
seed, and outputs and the gradients of the input and of every weight
(``jax.vjp`` against autograd) are compared. Tolerances:

* float32 convolutions, pools and batch norm: rtol and atol 1e-5 of values
  of order 1 (the same sums of at most a few hundred products in another
  order);
* max pooling's gradient, tied zeros included: exactly (it routes each
  cotangent to one element, and both pick the window's first maximum);
* batch norm in bfloat16 (f32 weights, as the compiler keeps them): 2^-7
  of the largest value, one bf16 rounding of the statistics apart.

The compiled-model tests hold the running statistics after SGD with
momentum and Adam steps to the JAX package's train step (1e-5), and show
that the optimizer alone, ``grad_step`` and the manual verbs leave them
unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.layer import Layer as JLayer
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.core.op import LowerCtx as JLowerCtx
from flexflow_tpu.core.op import create_op as jcreate_op
from flexflow_tpu.core.parallel_tensor import ParallelTensorShape as JPShape
from flexflow_tpu.ffconst import ActiMode as JActiMode
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.ffconst import OpType as JOpType
from flexflow_tpu.ffconst import PoolType as JPoolType
from flexflow_tpu.runtime.optimizer import AdamOptimizer as JAdamOptimizer
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import (ActiMode, AdamOptimizer, FFConfig, FFModel, LossType,
                                SGDOptimizer, load_numpy_params)
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.op import LowerCtx, create_op
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.ffconst import OpType, PoolType
from flexflow_tpu_torch.runtime.compiler import cast_op_params, make_caster
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = 2 ** -7
STATS = ("running_mean", "running_var")


def _ops(op_type, attrs, jattrs, shape):
    jop = jcreate_op(JLayer(JOpType(op_type.value), name="t", attrs=jattrs),
                     [JPShape.unpartitioned(shape)])
    op = create_op(Layer(op_type, name="t", attrs=attrs),
                   [ParallelTensorShape.unpartitioned(shape)])
    assert [(s.name, s.shape) for s in op.weight_specs()] == \
        [(s.name, tuple(s.shape)) for s in jop.weight_specs()]
    assert op.infer_output_shapes()[0][0] == tuple(jop.infer_output_shapes()[0][0])
    return jop, op


def _weights(op, rng):
    out = {}
    for s in op.weight_specs():
        if s.name in ("scale", "running_var"):
            a = 1.0 + 0.3 * rng.uniform(-1, 1, size=s.shape)
        else:
            a = 0.3 * rng.normal(size=s.shape)
        out[s.name] = a.astype(np.float32)
    return out


def _both(op_type, attrs, x, jattrs=None, seed=0, training=False):
    """Forward and vjp in both packages: (jax out, port out, [(name, jax
    grad, port grad)], jax state updates, port state updates)."""
    jop, op = _ops(op_type, attrs, attrs if jattrs is None else jattrs, x.shape)
    rng = np.random.default_rng(seed)
    weights = _weights(op, rng)
    g = rng.normal(size=op.infer_output_shapes()[0][0]).astype(np.float32)

    def jfwd(xv, ws):
        ctx = JLowerCtx(mesh=None, training=training, state_updates={})
        out = jop.forward(ctx, [xv], ws)[0]
        return out, {k[1]: v for k, v in ctx.state_updates.items()}

    jout, vjp, jupd = jax.vjp(jfwd, jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in weights.items()}, has_aux=True)
    jupd = {k: np.asarray(v) for k, v in jupd.items()}
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    tws = {k: torch.from_numpy(v).requires_grad_(True) for k, v in weights.items()}
    ctx = LowerCtx(training=training, state_updates={})
    tout = op.forward(ctx, [tx], tws)[0]
    tout.backward(torch.from_numpy(g))
    tupd = {k[1]: v.detach().numpy() for k, v in ctx.state_updates.items()}
    grads = [("x", np.asarray(jdx), tx.grad.numpy())]
    grads += [(k, np.asarray(jdw[k]),
               tws[k].grad.numpy() if tws[k].grad is not None else np.zeros_like(weights[k]))
              for k in weights]
    return np.asarray(jout), tout.detach().numpy(), grads, jupd, tupd


def _check(jout, tout, grads, tol=TOL):
    assert tout.shape == jout.shape and tout.dtype == jout.dtype
    np.testing.assert_allclose(tout, jout, **tol)
    for name, want, got in grads:
        np.testing.assert_allclose(got, want, **tol, err_msg=name)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (id, input shape, out channels, kernel, stride, padding, groups)
CONVS = [
    ("3x3_stride2", (2, 4, 9, 9), 6, (3, 3), (2, 2), (1, 1), 1),
    ("7x7_stride2_pad3", (2, 3, 12, 12), 8, (7, 7), (2, 2), (3, 3), 1),
    ("1x7_pad_0_3", (2, 5, 8, 9), 4, (1, 7), (1, 1), (0, 3), 1),
    ("7x1_pad_3_0", (2, 5, 9, 8), 4, (7, 1), (1, 1), (3, 0), 1),
    ("groups32", (2, 64, 6, 6), 64, (3, 3), (1, 1), (1, 1), 32),
    ("groups32_stride2", (2, 64, 7, 7), 128, (3, 3), (2, 2), (1, 1), 32),
    ("1x1_stride2", (2, 8, 7, 7), 16, (1, 1), (2, 2), (0, 0), 1),
]


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape,co,k,s,p,groups", [c[1:] for c in CONVS],
                         ids=[c[0] for c in CONVS])
def test_conv2d_matches_jax(shape, co, k, s, p, groups, use_bias):
    attrs = dict(out_channels=co, kernel=k, stride=s, padding=p, groups=groups,
                 use_bias=use_bias, activation=ActiMode.RELU)
    jattrs = dict(attrs, activation=JActiMode.RELU)
    _check(*_both(OpType.CONV2D, attrs, _x(shape), jattrs)[:3])


def test_conv2d_strategy_raises_naming_a7():
    """A convolution's strategy compiles since A7b: ``out_channels`` and
    ``spatial`` give the JAX package's layouts over {data: 2, model: 2}
    (the values over ranks are ``test_torch_sharded_ops.py``'s)."""
    from flexflow_tpu.core.parallel_tensor import ParallelDim as JParallelDim
    from flexflow_tpu.core.parallel_tensor import ParallelTensorShape as JPShape
    from flexflow_tpu.runtime.compiler import build_ops as jbuild_ops
    from flexflow_tpu_torch.core.parallel_tensor import ParallelDim, ParallelTensorShape
    from flexflow_tpu_torch.runtime.compiler import build_ops

    strategies = {"oc": {"out_channels": "model"}, "sp": {"spatial": "model"}}
    ff = FFModel(FFConfig(batch_size=2, device="cpu"))
    x = ff.create_tensor((2, 3, 8, 8), name="img")
    for name in ("oc", "sp"):
        ff.conv2d(x, 4, 3, 3, 1, 1, 1, 1, strategy=strategies[name], name=name)
    jff = JFFModel(JFFConfig(batch_size=2))
    jx = jff.create_tensor((2, 3, 8, 8), name="img")
    for name in ("oc", "sp"):
        jff.conv2d(jx, 4, 3, 3, 1, 1, 1, 1, name=name)
    sizes = {"data": 2, "model": 2}
    ops, _ = build_ops(ff.layers, {x.tensor_id: ParallelTensorShape(
        (ParallelDim(2, 2, "data"),) + tuple(ParallelDim(s) for s in (3, 8, 8)))}, sizes,
        strategies)
    jops, _ = jbuild_ops(jff.layers, {jx.tensor_id: JPShape(
        (JParallelDim(2, 2, "data"),) + tuple(JParallelDim(s) for s in (3, 8, 8)))}, sizes,
        strategies)
    for o, jo in zip(ops, jops):
        assert o.output_shapes[0].partition_spec() == tuple(jo.output_shapes[0].partition_spec())
        for w, ws in o.weight_shapes.items():
            assert ws.partition_spec() == tuple(jo.weight_shapes[w].partition_spec())
    assert ops[0].oc_axis == "model" and ops[1].sp_axis == "model"


# (id, input shape, kernel, stride, padding)
POOLS = [
    ("3x3_s2_p1", (2, 3, 9, 9), (3, 3), (2, 2), (1, 1)),
    ("3x3_s1_p1", (2, 3, 7, 8), (3, 3), (1, 1), (1, 1)),
    ("3x3_s2_p0", (2, 3, 9, 10), (3, 3), (2, 2), (0, 0)),
    ("8x8", (2, 4, 8, 8), (8, 8), (1, 1), (0, 0)),
    ("2x2_p2_past_half", (1, 2, 5, 5), (2, 2), (1, 1), (2, 2)),
]


@pytest.mark.parametrize("pool", ["MAX", "AVG"])
@pytest.mark.parametrize("shape,k,s,p", [c[1:] for c in POOLS], ids=[c[0] for c in POOLS])
def test_pool2d_matches_jax(shape, k, s, p, pool):
    attrs = dict(kernel=k, stride=s, padding=p, pool_type=PoolType[pool])
    jattrs = dict(attrs, pool_type=JPoolType[pool])
    _check(*_both(OpType.POOL2D, attrs, _x(shape), jattrs)[:3])


@pytest.mark.parametrize("p", [(0, 0), (1, 1)], ids=["nopad", "pad1"])
def test_max_pool_gradient_routes_ties_as_jax(p):
    """After a ReLU most windows hold exact zeros, and small integers tie
    too: every cotangent must land where ``select_and_scatter`` puts it."""
    rng = np.random.default_rng(3)
    x = np.maximum(rng.integers(-3, 3, size=(2, 3, 9, 9)), 0).astype(np.float32)
    x[0, 0] = 0.0  # a whole channel of ties
    attrs = dict(kernel=(3, 3), stride=(2, 2), padding=p, pool_type=PoolType.MAX)
    jattrs = dict(attrs, pool_type=JPoolType.MAX)
    jout, tout, grads, _, _ = _both(OpType.POOL2D, attrs, x, jattrs)
    _check(jout, tout, grads, dict(rtol=0, atol=0))


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax(training, relu):
    x = 1.5 + 2.0 * _x((4, 3, 5, 6))
    attrs = dict(relu=relu, eps=1e-5)
    jout, tout, grads, jupd, tupd = _both(OpType.BATCHNORM, attrs, x, training=training)
    _check(jout, tout, grads)
    assert set(tupd) == set(jupd) == (set(STATS) if training else set())
    for k in tupd:
        np.testing.assert_allclose(tupd[k], jupd[k], **TOL, err_msg=k)


def test_batch_norm_bf16_keeps_f32_weights_and_matches_jax():
    """Under compute_dtype bf16 the compiler hands BatchNorm its f32
    weights; the op promotes to f32 where the JAX op does, and its running
    statistics stay f32."""
    op = create_op(Layer(OpType.BATCHNORM, name="bn", attrs={}),
                   [ParallelTensorShape.unpartitioned((4, 3, 5, 6))])
    w = {n: torch.ones(3) for n in ("scale", "bias", "running_mean", "running_var")}
    cast = make_caster(torch.bfloat16)
    assert all(v.dtype == torch.float32
               for v in cast_op_params(cast, op, w, torch.bfloat16).values())

    x = 1.5 + 2.0 * _x((4, 3, 5, 6))
    jop, op = _ops(OpType.BATCHNORM, {}, {}, x.shape)
    weights = _weights(op, np.random.default_rng(0))
    for training in (True, False):
        jctx = JLowerCtx(mesh=None, training=training, state_updates={})
        jout = jop.forward(jctx, [jnp.asarray(x, jnp.bfloat16)],
                           {k: jnp.asarray(v) for k, v in weights.items()})[0]
        ctx = LowerCtx(training=training, state_updates={})
        tout = op.forward(ctx, [torch.from_numpy(x).bfloat16()],
                          {k: torch.from_numpy(v) for k, v in weights.items()})[0]
        assert str(tout.dtype).removeprefix("torch.") == str(jout.dtype)
        want = np.asarray(jout.astype(jnp.float32))
        np.testing.assert_allclose(tout.float().numpy(), want, rtol=0,
                                   atol=BF16_TOL * np.abs(want).max())
        for (_, name), v in ctx.state_updates.items():
            assert v.dtype == torch.float32
            jv = np.asarray(jctx.state_updates[("t", name)])
            np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=BF16_TOL * np.abs(jv).max())


# ---- running statistics through the compiled steps -------------------------

BATCH = 4


def _bn_model(pkg, optimizer):
    """conv -> batch_norm -> conv -> batch_norm(relu=False) -> pool -> flat
    -> dense, in either package, compiled for training with sparse CE."""
    if pkg == "jax":
        ff = JFFModel(JFFConfig(batch_size=BATCH, ledger="off", audit_programs="off",
                                attribution="off"))
    else:
        ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    x = ff.create_tensor((BATCH, 3, 8, 8), name="input")
    # no conv bias: a batch norm cancels it, so its gradient is rounding
    # noise, which Adam would blow up to full steps of either sign
    t = ff.conv2d(x, 6, 3, 3, 1, 1, 1, 1, use_bias=False, name="c1")
    t = ff.batch_norm(t, name="bn1")
    t = ff.conv2d(t, 8, 3, 3, 2, 2, 1, 1, use_bias=False, name="c2")
    t = ff.batch_norm(t, relu=False, name="bn2")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool")
    t = ff.dense(ff.flat(t, name="flat"), 5, name="out")
    if pkg == "jax":
        ff.compile(optimizer=optimizer, loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    else:
        ff.compile(optimizer=optimizer, loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _data(seed=2):
    rng = np.random.default_rng(seed)
    return (1.0 + 2.0 * rng.normal(size=(BATCH, 3, 8, 8))).astype(np.float32), \
        rng.integers(0, 5, size=(BATCH, 1)).astype(np.int32)


def _np_params(params):
    return {op: {w: np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                 for w, v in ws.items()} for op, ws in params.items()}


OPTS = {
    "sgd_momentum": (lambda: JSGDOptimizer(lr=0.1, momentum=0.9, weight_decay=1e-3),
                     lambda: SGDOptimizer(lr=0.1, momentum=0.9, weight_decay=1e-3)),
    "adam": (lambda: JAdamOptimizer(alpha=0.01, weight_decay=1e-3),
             lambda: AdamOptimizer(alpha=0.01, weight_decay=1e-3)),
}


@pytest.mark.parametrize("opt", list(OPTS))
def test_running_stats_through_train_step_match_jax(opt):
    """Three train steps in both packages: every param, the running
    statistics included, agrees; the optimizer alone leaves the statistics
    as they were (their gradient is zero and they take no weight decay)."""
    jff, tff = _bn_model("jax", OPTS[opt][0]()), _bn_model("torch", OPTS[opt][1]())
    tree = _np_params(jff.compiled.params)
    rng = np.random.default_rng(5)
    for op in ("bn1", "bn2"):  # start the statistics away from their init
        tree[op]["running_mean"] = (0.5 * rng.normal(size=tree[op]["running_mean"].shape)
                                    ).astype(np.float32)
        tree[op]["running_var"] = (1.0 + rng.uniform(size=tree[op]["running_var"].shape)
                                   ).astype(np.float32)
    jff.compiled.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jff.compiled.opt_state = jff.optimizer.init_state(jff.compiled.params)
    load_numpy_params(tff, tree)
    cm = tff.compiled
    for op in ("bn1", "bn2"):  # the statistics cross over unchanged
        for s in STATS:
            np.testing.assert_array_equal(cm.params[op][s].numpy(), tree[op][s])
    cm.opt_state = cm.optimizer.init_state(cm.params)
    x, y = _data()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for step in range(3):
        # the optimizer alone, on this step's gradients, moves no statistic
        before = _np_params(cm.params)
        grads = cm.grad_step(cm.params, None, tx, ty)
        for op in ("bn1", "bn2"):
            for s in STATS:
                assert not grads[op][s].any()
        probe_opt = OPTS[opt][1]()
        probe = {op: {w: v.clone() for w, v in ws.items()} for op, ws in cm.params.items()}
        state = probe_opt.init_state(probe)
        for _ in range(2):
            probe, state = probe_opt.update(probe, grads, state, cm.wd_mask)
        for op in ("bn1", "bn2"):
            for s in STATS:
                np.testing.assert_array_equal(probe[op][s].numpy(), before[op][s])
        # grad_step wrote nothing
        for op, ws in _np_params(cm.params).items():
            for w, v in ws.items():
                np.testing.assert_array_equal(v, before[op][w])
        jff.compiled.params, jff.compiled.opt_state, _, _ = jff.compiled.train_step(
            jff.compiled.params, jff.compiled.opt_state, jax.random.key(step), x, y)
        cm.train_step(cm.params, cm.opt_state, step + 1, tx, ty)
        want, got = _np_params(jff.compiled.params), _np_params(cm.params)
        for op in want:
            for w in want[op]:
                np.testing.assert_allclose(got[op][w], want[op][w], **TOL,
                                           err_msg=f"step {step} {op}.{w}")
        for op in ("bn1", "bn2"):
            for s in STATS:
                assert not np.array_equal(got[op][s], before[op][s]), (op, s)


def test_manual_verbs_and_eval_leave_running_stats():
    """backward()/update() and eval() move the trained weights and leave
    the running statistics where fit() put them."""
    tff = _bn_model("torch", SGDOptimizer(lr=0.1, momentum=0.9))
    x, y = _data()
    tff.fit(np.concatenate([x, x]), np.concatenate([y, y]), verbose=False)
    stats = {op: {s: tff.compiled.params[op][s].clone() for s in STATS}
             for op in ("bn1", "bn2")}
    kernel = tff.compiled.params["out"]["kernel"].clone()
    tff.set_batch([x], y)
    tff.forward()
    tff.backward()
    tff.update()
    tff.eval(x, y, verbose=False)
    assert not torch.equal(tff.compiled.params["out"]["kernel"], kernel)
    for op, ws in stats.items():
        for s, v in ws.items():
            assert torch.equal(tff.compiled.params[op][s], v), (op, s)


def test_batch_norm_eval_uses_running_stats_after_fit():
    """After fit, eval's logits are the JAX eval step's on the same params
    (running statistics included), not batch statistics."""
    jff = _bn_model("jax", JSGDOptimizer(lr=0.1))
    tff = _bn_model("torch", SGDOptimizer(lr=0.1))
    x, y = _data()
    tff.fit(x, y, verbose=False)
    tree = _np_params(tff.compiled.params)
    jff.compiled.params = jax.tree_util.tree_map(jnp.asarray, tree)
    _, jlogits, _ = jff.compiled.eval_step(jff.compiled.params, x, y)
    _, tlogits, _ = tff.compiled.eval_step(tff.compiled.params, torch.from_numpy(x),
                                           torch.from_numpy(y))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
