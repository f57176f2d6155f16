"""The port's ReLU at exact zeros, against the JAX package's.

The reference's ReLU is ``jnp.maximum(x, 0)``, whose gradient splits a tie:
0.5 at an exact 0. Exact zeros reach a ReLU where a zero input row meets a
zero bias (biases start at 0, a partial batch's padding rows are 0), and
after another ReLU. ``dense(..., RELU)`` and the ``relu`` op are built in
both packages, fed the same numpy inputs and weights with exact-zero
pre-activations, and their forwards and every gradient (input, kernel,
bias) compared. f32 on both sides, summed in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu.core.layer import Layer as JLayer
from flexflow_tpu.core.op import LowerCtx as JLowerCtx
from flexflow_tpu.core.op import create_op as jcreate_op
from flexflow_tpu.core.parallel_tensor import ParallelTensorShape as JPShape
from flexflow_tpu.ffconst import ActiMode as JActiMode
from flexflow_tpu.ffconst import OpType as JOpType
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.op import LowerCtx, create_op
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.ffconst import ActiMode, OpType
import flexflow_tpu_torch.ops  # noqa: F401  (registers the port's ops)
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL = dict(rtol=1e-6, atol=1e-6)


def _forward_and_grads(op_type, attrs, jattrs, x, weights, g):
    """(jax output, port output, [(name, jax grad, port grad)]) of one op's
    forward and its vjp with cotangent ``g``, for the input and every
    weight."""
    jop = jcreate_op(JLayer(JOpType(op_type.value), name="t", attrs=jattrs),
                     [JPShape.unpartitioned(x.shape)])
    op = create_op(Layer(op_type, name="t", attrs=attrs),
                   [ParallelTensorShape.unpartitioned(x.shape)])
    assert sorted(s.name for s in op.weight_specs()) == sorted(weights)

    def jfwd(jx, ws):
        return jop.forward(JLowerCtx(mesh=None, training=False), [jx], ws)[0]

    jout, vjp = jax.vjp(jfwd, jnp.asarray(x), {k: jnp.asarray(v) for k, v in weights.items()})
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    tws = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in weights.items()}
    tout = op.forward(LowerCtx(training=False), [tx], tws)[0]
    tout.backward(torch.from_numpy(g))
    grads = [("x", np.asarray(jdx), tx.grad.numpy())]
    grads += [(k, np.asarray(jdw[k]), tws[k].grad.numpy()) for k in weights]
    return np.asarray(jout), tout.detach().numpy(), grads


@pytest.mark.parametrize("use_bias", [True, False])
def test_dense_relu_at_exact_zero_preactivations_matches_jax(use_bias):
    """Rows 0 and 2 of the input are zero and the bias is zero, so every
    pre-activation of those rows is exactly 0: the gradient through them is
    half the cotangent, as in JAX."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    x[0] = 0.0
    x[2] = 0.0
    weights = {"kernel": rng.normal(size=(8, 6)).astype(np.float32)}
    if use_bias:
        weights["bias"] = np.zeros(6, np.float32)
    g = rng.normal(size=(4, 6)).astype(np.float32)
    attrs = dict(out_dim=6, activation=ActiMode.RELU, use_bias=use_bias)
    jattrs = dict(attrs, activation=JActiMode.RELU)
    jout, tout, grads = _forward_and_grads(OpType.LINEAR, attrs, jattrs, x, weights, g)
    np.testing.assert_array_equal(tout[[0, 2]], 0.0)
    np.testing.assert_allclose(tout, jout, **TOL)
    for name, want, got in grads:
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    if use_bias:
        # the zero rows' share of the bias gradient is half their cotangent
        positive = (x @ weights["kernel"]) > 0
        half = 0.5 * (g[0] + g[2]) + (g * positive)[[1, 3]].sum(0)
        np.testing.assert_allclose(dict((n, t) for n, _, t in grads)["bias"], half, **TOL)


def test_relu_op_at_exact_zeros_matches_jax():
    """The elementwise relu op on an input with exact zeros (and the
    values either side): forward and input gradient as in JAX, 0.5 at each
    zero."""
    rng = np.random.default_rng(1)
    x = rng.choice(np.array([-2.0, -1.0, 0.0, 0.0, 1.5, 3.0], np.float32), size=(3, 5, 7))
    g = rng.normal(size=x.shape).astype(np.float32)
    jout, tout, grads = _forward_and_grads(OpType.RELU, {}, {}, x, {}, g)
    np.testing.assert_allclose(tout, jout, **TOL)
    (_, want, got), = grads
    np.testing.assert_allclose(got, want, **TOL)
    zeros = x == 0.0
    assert zeros.any()
    np.testing.assert_allclose(got[zeros], 0.5 * g[zeros], **TOL)


def test_relu_after_relu_keeps_the_split():
    """A ReLU over a ReLU's output: the exact zeros the first one makes are
    ties for the second, so the gradient is 0.5 * 0.5 where the input was
    0, and 0.5 * 0 below it."""
    from flexflow_tpu_torch.ops.linear import relu

    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    relu(relu(x)).sum().backward()
    jgrad = jax.grad(lambda v: jnp.sum(jnp.maximum(jnp.maximum(v, 0), 0)))(
        jnp.asarray([-1.0, 0.0, 2.0]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 0.25, 1.0], **TOL)
