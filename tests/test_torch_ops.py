"""The port's ops against the JAX package's, op by op.

Each op is built in both packages from the same attrs and input shapes;
the weights and inputs are made with numpy from a seed and handed to both
(the pattern of tests/test_align_torch.py). The JAX attention runs its
Pallas kernel in the interpreter; the port's runs the kernel's plain
version on CPU tensors.
"""

import numpy as np
import pytest
import torch

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

# f32 on both sides; the products sum in a different order on each
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


def _run_both(op_type, attrs, jattrs, inputs, seed):
    """Build the op in both packages, draw its weights with numpy, run
    both forwards; returns (jax outputs, port outputs) as numpy."""
    jop = jcreate_op(JLayer(JOpType(op_type.value), name="t", attrs=jattrs),
                     [JPShape.unpartitioned(a.shape) for a in inputs])
    op = create_op(Layer(op_type, name="t", attrs=attrs),
                   [ParallelTensorShape.unpartitioned(a.shape) for a in inputs])
    specs = op.weight_specs()
    assert [(s.name, s.shape) for s in specs] == \
        [(s.name, s.shape) for s in jop.weight_specs()]
    rng = np.random.default_rng(seed)
    weights = {s.name: (rng.normal(size=s.shape) * 0.2).astype(np.float32)
               for s in specs}
    jout = jop.forward(JLowerCtx(mesh=None, training=False),
                       [jnp.asarray(a) for a in inputs],
                       {k: jnp.asarray(v) for k, v in weights.items()})
    tout = op.forward(LowerCtx(), [torch.from_numpy(a) for a in inputs],
                      {k: torch.from_numpy(v) for k, v in weights.items()})
    return ([np.asarray(o) for o in jout], [o.numpy() for o in tout])


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("acti", list(ActiMode), ids=lambda a: a.name)
def test_dense_matches_jax(acti, use_bias):
    x = np.random.default_rng(0).normal(size=(2, 8, 24)).astype(np.float32)
    attrs = dict(out_dim=16, activation=acti, use_bias=use_bias)
    jattrs = dict(attrs, activation=JActiMode(acti.value))
    jout, tout = _run_both(OpType.LINEAR, attrs, jattrs, [x], seed=1)
    assert tout[0].shape == (2, 8, 16)
    np.testing.assert_allclose(tout[0], jout[0], **TOL)


# (Sq, Skv): a length the JAX kernel takes, then lengths that are no
# multiple of 8, where the reference's op computes single_device_attention
# (self-attention, and 10 queries over 37 keys and 37 over 10)
SEQ_LENGTHS = [(32, 32), (1, 1), (10, 10), (37, 37), (10, 37), (37, 10)]


def _attention_inputs(rng, sq, skv):
    q = rng.normal(size=(2, sq, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, skv, 64)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("sq,skv", SEQ_LENGTHS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_multihead_attention_matches_jax(bias, causal, sq, skv):
    q, k, v = _attention_inputs(np.random.default_rng(2), sq, skv)
    attrs = dict(embed_dim=64, num_heads=2, kdim=64, vdim=64, dropout=0.0,
                 bias=bias, causal=causal)
    jout, tout = _run_both(OpType.MULTIHEAD_ATTENTION, attrs, attrs,
                           [q, k, v], seed=3)
    assert tout[0].shape == (2, sq, 64)
    np.testing.assert_allclose(tout[0], jout[0], **TOL)


def test_plain_kernels_ctx_gives_the_same_attention_on_cpu():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 16, 64)).astype(np.float32))
    attrs = dict(embed_dim=64, num_heads=2)
    op = create_op(Layer(OpType.MULTIHEAD_ATTENTION, name="t", attrs=attrs),
                   [ParallelTensorShape.unpartitioned(x.shape)] * 3)
    w = {s.name: torch.from_numpy(rng.normal(size=s.shape).astype(np.float32))
         for s in op.weight_specs()}
    a = op.forward(LowerCtx(), [x, x, x], w)[0]
    b = op.forward(LowerCtx(plain_kernels=True), [x, x, x], w)[0]
    assert torch.equal(a, b)


def _grads_both(op_type, attrs, jattrs, inputs, seed):
    """The op's vjp in both packages for one numpy cotangent: gradients of
    every input and weight, as numpy (JAX first)."""
    import jax

    jop = jcreate_op(JLayer(JOpType(op_type.value), name="t", attrs=jattrs),
                     [JPShape.unpartitioned(a.shape) for a in inputs])
    op = create_op(Layer(op_type, name="t", attrs=attrs),
                   [ParallelTensorShape.unpartitioned(a.shape) for a in inputs])
    rng = np.random.default_rng(seed)
    weights = {s.name: (rng.normal(size=s.shape) * 0.2).astype(np.float32)
               for s in op.weight_specs()}
    out_shape = op.infer_output_shapes()[0][0]
    g = rng.normal(size=out_shape).astype(np.float32)

    def jfwd(xs, ws):
        return jop.forward(JLowerCtx(mesh=None, training=True), xs, ws)[0]

    _, vjp = jax.vjp(jfwd, [jnp.asarray(a) for a in inputs],
                     {k: jnp.asarray(v) for k, v in weights.items()})
    jxs, jws = vjp(jnp.asarray(g))
    txs = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    tws = {k: torch.from_numpy(v).requires_grad_(True) for k, v in weights.items()}
    op.forward(LowerCtx(training=True), txs, tws)[0].backward(torch.from_numpy(g))
    want = [np.asarray(a) for a in jxs] + [np.asarray(jws[k]) for k in weights]
    got = [t.grad.numpy() for t in txs] + [tws[k].grad.numpy() for k in weights]
    return want, got, ["x%d" % i for i in range(len(inputs))] + list(weights)


@pytest.mark.parametrize("acti", [ActiMode.NONE, ActiMode.RELU, ActiMode.GELU],
                         ids=lambda a: a.name)
def test_dense_gradients_match_jax(acti):
    x = np.random.default_rng(5).normal(size=(2, 8, 24)).astype(np.float32)
    attrs = dict(out_dim=16, activation=acti, use_bias=True)
    want, got, names = _grads_both(OpType.LINEAR, attrs,
                                   dict(attrs, activation=JActiMode(acti.value)), [x], 6)
    for n, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, b, **TOL, err_msg=n)


@pytest.mark.parametrize("sq,skv", SEQ_LENGTHS)
@pytest.mark.parametrize("causal", [False, True])
def test_multihead_attention_gradients_match_jax(causal, sq, skv):
    """Through the flash-attention backward: the port's plain version on
    CPU tensors, the JAX package's Pallas kernels in the interpreter (or,
    at lengths no multiple of 8, jax.grad of single_device_attention)."""
    q, k, v = _attention_inputs(np.random.default_rng(7), sq, skv)
    attrs = dict(embed_dim=64, num_heads=2, kdim=64, vdim=64, dropout=0.0,
                 bias=True, causal=causal)
    want, got, names = _grads_both(OpType.MULTIHEAD_ATTENTION, attrs, attrs, [q, k, v], 8)
    for n, a, b in zip(names, got, want):
        # bk's exact gradient is 0 (the softmax cancels q.bk): rounding noise
        # on both sides, held against the scale of the other gradients
        np.testing.assert_allclose(a, b, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * max(1.0, np.abs(want[0]).max()),
                                   err_msg=n)
