"""The ops GPT and the BERT proxy need, held against the JAX package's, op
by op: every elementwise binary op (with numpy broadcasting), every unary
and scalar op, LayerNorm on trailing and non-trailing axes, Embedding
(NONE/SUM/AVG) and Gather with ids in range, past the table and negative,
and Dropout and attention dropout.

Each op is built in both packages from the same attrs and input shapes;
inputs, weights and the output's cotangent are made with numpy from a seed.
Forward outputs and the gradients of every input and weight must agree in
float32 (rtol and atol 1e-5: the same math, reductions summed in another
order). Dropout masks cannot match across frameworks bit for bit, so
dropout is held to the reference where it is the identity (rate 0, eval)
and otherwise checked for its statistics and its reproducibility.
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
from flexflow_tpu.ffconst import AggrMode as JAggrMode
from flexflow_tpu.ffconst import DataType as JDataType
from flexflow_tpu.ffconst import OpType as JOpType
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.op import LowerCtx, create_op
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.ffconst import AggrMode, DataType, OpType
from flexflow_tpu_torch.ops.attention import dropout_attention
from flexflow_tpu_torch.runtime.compiler import make_caster
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


def _ops(op_type, attrs, jattrs, shapes):
    shapes = [tuple(s) for s in shapes]
    jop = jcreate_op(JLayer(JOpType(op_type.value), name="t", attrs=jattrs),
                     [JPShape.unpartitioned(s) for s in shapes])
    op = create_op(Layer(op_type, name="t", attrs=attrs),
                   [ParallelTensorShape.unpartitioned(s) for s in shapes])
    assert [(s.name, s.shape) for s in op.weight_specs()] == \
        [(s.name, s.shape) for s in jop.weight_specs()]
    assert op.infer_output_shapes()[0][0] == tuple(jop.infer_output_shapes()[0][0])
    return jop, op


def _both(op_type, attrs, inputs, jattrs=None, seed=0, grad_inputs=None):
    """Forward and vjp of the op in both packages: returns (jax output,
    port output, [(name, jax grad, port grad)]). ``grad_inputs``: which
    inputs are differentiated (default: the float ones)."""
    jop, op = _ops(op_type, attrs, attrs if jattrs is None else jattrs,
                   [a.shape for a in inputs])
    rng = np.random.default_rng(seed)
    weights = {s.name: (1.0 + 0.3 * rng.normal(size=s.shape)).astype(np.float32)
               if s.name == "scale" else (0.3 * rng.normal(size=s.shape)).astype(np.float32)
               for s in op.weight_specs()}
    if grad_inputs is None:
        grad_inputs = [i for i, a in enumerate(inputs) if a.dtype.kind == "f"]
    out_shape = op.infer_output_shapes()[0][0]
    g = rng.normal(size=out_shape).astype(np.float32)

    def jfwd(diff_xs, ws):
        xs = [jnp.asarray(a) for a in inputs]
        for i, x in zip(grad_inputs, diff_xs):
            xs[i] = x
        return jop.forward(JLowerCtx(mesh=None, training=False), xs, ws)[0]

    jout, vjp = jax.vjp(jfwd, [jnp.asarray(inputs[i]) for i in grad_inputs],
                        {k: jnp.asarray(v) for k, v in weights.items()})
    jdx, jdw = vjp(jnp.asarray(g))
    txs = [torch.from_numpy(a.copy()) for a in inputs]
    for i in grad_inputs:
        txs[i].requires_grad_(True)
    tws = {k: torch.from_numpy(v).requires_grad_(True) for k, v in weights.items()}
    tout = op.forward(LowerCtx(training=False), txs, tws)[0]
    tout.backward(torch.from_numpy(g))
    grads = [(f"x{i}", np.asarray(j), txs[i].grad.numpy()) for i, j in zip(grad_inputs, jdx)]
    grads += [(k, np.asarray(jdw[k]), tws[k].grad.numpy()) for k in weights]
    return np.asarray(jout), tout.detach().numpy(), grads


def _check(jout, tout, grads):
    assert tout.shape == jout.shape and tout.dtype == jout.dtype
    np.testing.assert_allclose(tout, jout, **TOL)  # NaNs must sit in the same places
    for name, want, got in grads:
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


BINARY = [OpType.EW_ADD, OpType.EW_SUB, OpType.EW_MUL, OpType.EW_DIV, OpType.EW_MAX,
          OpType.EW_MIN]
# (a, b): equal shapes, b broadcast from the right, both broadcast
BROADCASTS = [((2, 3, 4), (2, 3, 4)), ((2, 3, 4), (3, 1)), ((2, 1, 4), (3, 1))]


@pytest.mark.parametrize("shapes", BROADCASTS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("op_type", BINARY, ids=lambda t: t.name)
def test_binary_ops_match_jax(op_type, shapes):
    rng = np.random.default_rng(1)
    a = rng.normal(size=shapes[0]).astype(np.float32)
    b = rng.normal(size=shapes[1]).astype(np.float32)
    if op_type is OpType.EW_DIV:  # keep the divisor away from 0
        b = (np.sign(b) * (0.5 + np.abs(b))).astype(np.float32)
    _check(*_both(op_type, {}, [a, b]))


UNARY = [OpType.EXP, OpType.RELU, OpType.IDENTITY, OpType.SIGMOID, OpType.TANH, OpType.ELU,
         OpType.GELU, OpType.RSQRT, OpType.SIN, OpType.COS]
SCALAR = [(OpType.SCALAR_MULTIPLY, -1.5), (OpType.SCALAR_ADD, 0.75),
          (OpType.SCALAR_SUB, 2.0), (OpType.SCALAR_TRUE_DIV, -4.0),
          (OpType.SCALAR_FLOOR_DIV, 0.3), (OpType.POW, 2.5), (OpType.POW, 3)]


@pytest.mark.parametrize("op_type", UNARY, ids=lambda t: t.name)
def test_unary_ops_match_jax(op_type):
    x = np.random.default_rng(2).normal(size=(3, 5, 7)).astype(np.float32)
    if op_type is OpType.RSQRT:
        x = 0.2 + np.abs(x)
    _check(*_both(op_type, {}, [x]))


@pytest.mark.parametrize("op_type,scalar", SCALAR, ids=lambda v: getattr(v, "name", str(v)))
def test_scalar_ops_match_jax(op_type, scalar):
    x = np.random.default_rng(3).normal(size=(4, 6)).astype(np.float32)
    if op_type is OpType.POW and not float(scalar).is_integer():
        x = 0.1 + np.abs(x)  # a fractional power of a negative number is NaN
    _check(*_both(op_type, dict(scalar=scalar), [x]))


# axes of a (2, 5, 6, 8) input: trailing (one dim, two), not trailing
# (a middle dim, the batch and a middle dim, two apart)
LN_AXES = [(-1,), (2, 3), (1,), (0, 2), (1, 3)]


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("axes", LN_AXES, ids=str)
def test_layer_norm_matches_jax(axes, affine):
    x = np.random.default_rng(4).normal(size=(2, 5, 6, 8)).astype(np.float32) * 3 + 1
    attrs = dict(axes=axes, elementwise_affine=affine, eps=1e-5)
    op = _ops(OpType.LAYERNORM, attrs, attrs, [x.shape])[1]
    assert op.trailing == (axes in [(-1,), (2, 3)])
    _check(*_both(OpType.LAYERNORM, attrs, [x]))


def test_layer_norm_uses_the_population_variance():
    x = torch.tensor([[1.0, 2.0, 3.0, 6.0]])
    for axes in ((-1,), (0, 1)):  # F.layer_norm and the generic path
        op = create_op(Layer(OpType.LAYERNORM, name="t",
                             attrs=dict(axes=axes, elementwise_affine=False, eps=0.0)),
                       [ParallelTensorShape.unpartitioned(tuple(x.shape))])
        y = op.forward(LowerCtx(), [x], {})[0]
        want = (x - 3.0) / np.sqrt(3.5)  # ddof 0: 14 / 4
        torch.testing.assert_close(y, want)


def _ids(rng, shape, n):
    """Ids in range, with some at n and above and some negative, both
    within the wrap range [-n, 0) and below it."""
    ids = rng.integers(0, n, shape)
    flat = ids.reshape(-1)
    flat[::5] = n + rng.integers(0, 3, flat[::5].shape)
    flat[1::7] = -rng.integers(1, n + 1, flat[1::7].shape)
    flat[3::11] = -n - 1 - rng.integers(0, 3, flat[3::11].shape)
    return ids.astype(np.int32)


@pytest.mark.parametrize("aggr", ["NONE", "SUM", "AVG"])
def test_embedding_matches_jax(aggr):
    n = 10
    ids = _ids(np.random.default_rng(5), (3, 4, 5), n)
    attrs = dict(num_entries=n, out_dim=6, aggr=AggrMode[aggr], dtype=DataType.FLOAT)
    jattrs = dict(attrs, aggr=JAggrMode[aggr], dtype=JDataType.FLOAT)
    jout, tout, grads = _both(OpType.EMBEDDING, attrs, [ids], jattrs=jattrs, seed=6)
    _check(jout, tout, grads)
    if aggr == "NONE":
        # jnp.take: a NaN row at and above n and below -n; the others
        # (wrapped from the end in [-n, 0)) are the table's rows
        flat_ids, rows = ids.reshape(-1), tout.reshape(-1, 6)
        bad = (flat_ids >= n) | (flat_ids < -n)
        assert bad.any() and ((flat_ids < 0) & ~bad).any()
        assert np.isnan(rows[bad]).all() and not np.isnan(rows[~bad]).any()
    # a NaN row's gradient reaches no valid row
    assert np.isfinite(grads[0][2]).all()


def test_embedding_weight_gradient_skips_invalid_ids():
    op = create_op(Layer(OpType.EMBEDDING, name="t",
                         attrs=dict(num_entries=4, out_dim=2)),
                   [ParallelTensorShape.unpartitioned((5,))])
    w = torch.arange(8.0).reshape(4, 2).requires_grad_(True)
    ids = torch.tensor([0, 4, -1, -5, 7], dtype=torch.int32)
    out = op.forward(LowerCtx(), [ids], {"weight": w})[0]
    torch.testing.assert_close(out[0], w[0].detach())
    torch.testing.assert_close(out[2], w[3].detach())  # -1 wraps to the last row
    assert torch.isnan(out[[1, 3, 4]]).all()
    out.nansum().backward()
    torch.testing.assert_close(w.grad, torch.tensor([[1.0, 1.0], [0, 0], [0, 0], [1, 1]]))


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_gather_matches_jax(dim):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 6, 5)).astype(np.float32)
    size = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = 3  # the other dims as x's (take_along_axis broadcasts them)
    idx = _ids(rng, tuple(shape), size)
    _check(*_both(OpType.GATHER, dict(dim=dim), [x, idx], seed=8))


# ---- dropout ---------------------------------------------------------------
def _dropout_op(shape, rate):
    return create_op(Layer(OpType.DROPOUT, name="drop", attrs=dict(rate=rate)),
                     [ParallelTensorShape.unpartitioned(shape)])


def test_dropout_is_the_reference_identity_at_rate_0_and_in_eval():
    x = np.random.default_rng(9).normal(size=(4, 16)).astype(np.float32)
    for rate, training in ((0.0, True), (0.3, False), (0.0, False)):
        jop = jcreate_op(JLayer(JOpType.DROPOUT, name="drop", attrs=dict(rate=rate)),
                         [JPShape.unpartitioned(x.shape)])
        want = jop.forward(JLowerCtx(mesh=None, training=training, rng=jax.random.key(0)),
                           [jnp.asarray(x)], {})[0]
        got = _dropout_op(x.shape, rate).forward(
            LowerCtx(training=training, rng=1), [torch.from_numpy(x)], {})[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_statistics_and_scaling(rate):
    n = 40000
    x = torch.from_numpy(np.random.default_rng(10).uniform(1, 2, size=(8, n // 8))
                         .astype(np.float32))
    y = _dropout_op(tuple(x.shape), rate).forward(LowerCtx(training=True, rng=3), [x], {})[0]
    kept = y != 0
    keep = 1.0 - rate
    # binomial(n, keep): within 5 sigma of its mean
    assert abs(kept.sum().item() - n * keep) <= 5 * np.sqrt(n * keep * rate)
    torch.testing.assert_close(y[kept], x[kept] / keep)


def test_dropout_mask_is_reproducible_under_one_seed():
    x = torch.ones(64, 64)
    op = _dropout_op((64, 64), 0.5)

    def mask(rng, seed=0, name="drop"):
        op.name = name
        return op.forward(LowerCtx(training=True, rng=rng, seed=seed), [x], {})[0] != 0

    assert torch.equal(mask(1), mask(1))
    for other in (mask(2), mask(1, seed=1), mask(1, name="drop2")):
        assert not torch.equal(mask(1), other)
    with pytest.raises(ValueError, match="rng"):
        op.forward(LowerCtx(training=True, rng=None), [x], {})


def test_attention_dropout_drops_the_probabilities():
    """With V the identity per head, the output rows are the dropped
    probabilities themselves: each kept one is the softmax's over keep."""
    rng = np.random.default_rng(11)
    b, s, h, d = 2, 16, 2, 16
    q = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
    v = torch.eye(s)[None, :, None, :].expand(b, s, h, d).contiguous()  # d == s
    rate, scale = 0.25, d ** -0.5
    for causal in (False, True):
        ctx = LowerCtx(training=True, rng=5)
        out = dropout_attention(q, k, v, causal, scale, rate, ctx, "attn")
        again = dropout_attention(q, k, v, causal, scale, rate, ctx, "attn")
        assert torch.equal(out, again)
        p = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
        if causal:
            p = p.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), float("-inf"))
        p = torch.softmax(p, dim=-1).permute(0, 2, 1, 3)  # (b, q, h, k) as out
        kept = out != 0
        torch.testing.assert_close(out[kept], p[kept] / (1 - rate))
        live = (p > 0).sum().item()  # causal: only the unmasked pairs
        keep = 1 - rate
        assert abs(kept.sum().item() - live * keep) <= 5 * np.sqrt(live * keep * rate)


def test_attention_op_with_dropout_matches_the_reference_where_it_is_off():
    """Rate > 0: in eval, and in training without a step key, the op is the
    reference's kernel path; in training with a key it drops."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    attrs = dict(embed_dim=32, num_heads=2, kdim=32, vdim=32, dropout=0.2, bias=True,
                 causal=True)
    jop, op = _ops(OpType.MULTIHEAD_ATTENTION, attrs, attrs, [x.shape] * 3)
    w = {s.name: (0.2 * rng.normal(size=s.shape)).astype(np.float32)
         for s in op.weight_specs()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    tx = [torch.from_numpy(x)] * 3
    want = np.asarray(jop.forward(JLowerCtx(mesh=None, training=False), [jnp.asarray(x)] * 3,
                                  {k: jnp.asarray(v) for k, v in w.items()})[0])
    for ctx in (LowerCtx(training=False, rng=1), LowerCtx(training=True, rng=None)):
        np.testing.assert_allclose(op.forward(ctx, tx, tw)[0].numpy(), want, **TOL)
    dropped = op.forward(LowerCtx(training=True, rng=1), tx, tw)[0]
    assert not np.allclose(dropped.numpy(), want, **TOL)
    assert torch.equal(dropped, op.forward(LowerCtx(training=True, rng=1), tx, tw)[0])


def test_caster_leaves_integer_inputs_alone():
    cast = make_caster(torch.bfloat16)
    ids = torch.arange(6, dtype=torch.int32)
    assert cast(ids) is ids and cast(ids).dtype == torch.int32
    assert cast(torch.ones(2)).dtype == torch.bfloat16
