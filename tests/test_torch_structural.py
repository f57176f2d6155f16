"""The port's structural, reduce and batch-matmul ops against the JAX
package's, op by op: Flat, Reshape (with -1), Transpose, Reverse, Concat
(axes -1 and 1), Split (by sizes and into equal parts), Cast, NoOp,
Constant and Slice (negative steps, negative and out-of-range int
indices), ReduceSum and Mean with and without keepdims, and BatchMatmul.

Each op is built in both packages from the same attrs and input shapes;
inputs and each output's cotangent are made with numpy from a seed. The
outputs and the gradient of every float input (``jax.vjp`` against
autograd) must agree: exactly for the data-movement ops (they copy), and
within rtol and atol 1e-5 in float32 for the reductions and the matmul
(the same sums in another order).
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
from flexflow_tpu.ffconst import DataType as JDataType
from flexflow_tpu.ffconst import OpType as JOpType
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.op import LowerCtx, create_op
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.ffconst import DataType, OpType
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

EXACT = dict(rtol=0, atol=0)
SUMS = dict(rtol=1e-5, atol=1e-5)


def _ops(op_type, attrs, jattrs, shapes):
    jop = jcreate_op(JLayer(JOpType(op_type.value), name="t", attrs=jattrs),
                     [JPShape.unpartitioned(s) for s in shapes])
    op = create_op(Layer(op_type, name="t", attrs=attrs),
                   [ParallelTensorShape.unpartitioned(s) for s in shapes])
    want = [(tuple(s), d.value) for s, d in jop.infer_output_shapes()]
    assert [(tuple(s), d.value) for s, d in op.infer_output_shapes()] == want
    return jop, op


def _both(op_type, attrs, inputs, jattrs=None, seed=0):
    """Forward and vjp of the op in both packages: returns ([(jax output,
    port output)], [(input index, jax grad, port grad)]). The float inputs
    are differentiated against a random cotangent of each float output."""
    jop, op = _ops(op_type, attrs, attrs if jattrs is None else jattrs,
                   [a.shape for a in inputs])
    op.materialize(torch.device("cpu"))
    rng = np.random.default_rng(seed)
    diff = [i for i, a in enumerate(inputs) if a.dtype.kind == "f"]
    specs = op.infer_output_shapes()
    gs = [rng.normal(size=s).astype(np.float32) if d.value.startswith("float") else None
          for s, d in specs]

    def jfwd(diff_xs):
        xs = [jnp.asarray(a) for a in inputs]
        for i, x in zip(diff, diff_xs):
            xs[i] = x
        return jop.forward(JLowerCtx(mesh=None, training=False), xs, {})

    jouts, vjp = jax.vjp(jfwd, [jnp.asarray(inputs[i]) for i in diff])
    # an integer or bool output takes a float0 cotangent
    (jdx,) = vjp([jnp.asarray(g) if g is not None else np.zeros(o.shape, jax.dtypes.float0)
                  for g, o in zip(gs, jouts)])
    txs = [torch.from_numpy(a.copy()) for a in inputs]
    for i in diff:
        txs[i].requires_grad_(True)
    touts = op.forward(LowerCtx(training=False), txs, {})
    pairs = [(g, t) for g, t in zip(gs, touts) if g is not None and t.requires_grad]
    if pairs:
        torch.autograd.backward([t for _, t in pairs], [torch.from_numpy(g) for g, _ in pairs])
    outs = [(np.asarray(j), t.detach().numpy()) for j, t in zip(jouts, touts)]
    grads = [(i, np.asarray(j), txs[i].grad.numpy()) for i, j in zip(diff, jdx)
             if txs[i].grad is not None or np.any(np.asarray(j))]
    return outs, grads


def _check(outs, grads, tol):
    for want, got in outs:
        assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
        np.testing.assert_allclose(got, want, **tol)
    for i, want, got in grads:
        np.testing.assert_allclose(got, want, **tol, err_msg=f"grad of input {i}")


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


MOVES = [
    ("flat", OpType.FLAT, {}, [(2, 3, 4, 5)]),
    ("reshape", OpType.RESHAPE, dict(shape=(6, -1, 2)), [(2, 3, 4, 5)]),
    ("reshape_flat", OpType.RESHAPE, dict(shape=(-1,)), [(2, 3, 4)]),
    ("transpose", OpType.TRANSPOSE, dict(perm=(0, 2, 3, 1)), [(2, 3, 4, 5)]),
    ("reverse0", OpType.REVERSE, dict(axis=0), [(3, 4, 2)]),
    ("reverse_neg", OpType.REVERSE, dict(axis=-1), [(3, 4, 2)]),
    ("concat_last", OpType.CONCAT, dict(axis=-1), [(2, 3, 4), (2, 3, 1), (2, 3, 6)]),
    ("concat_channels", OpType.CONCAT, dict(axis=1), [(2, 3, 4, 4), (2, 5, 4, 4)]),
    ("split_sizes", OpType.SPLIT, dict(axis=1, splits=[1, 4, 2]), [(3, 7, 2)]),
    ("split_last", OpType.SPLIT, dict(axis=-1, splits=[3, 3]), [(2, 2, 6)]),
    ("noop", OpType.NOOP, {}, [(3, 4), (2,)]),
]


@pytest.mark.parametrize("op_type,attrs,shapes", [m[1:] for m in MOVES],
                         ids=[m[0] for m in MOVES])
def test_data_movement_ops_match_jax(op_type, attrs, shapes):
    inputs = [_x(s, seed=i + 1) for i, s in enumerate(shapes)]
    _check(*_both(op_type, attrs, inputs), EXACT)


@pytest.mark.parametrize("src,dst", [("FLOAT", "INT32"), ("INT32", "FLOAT"),
                                     ("FLOAT", "BOOL")])
def test_cast_matches_jax(src, dst):
    x = 7.3 * _x((3, 5))
    x[0, :2] = 0.0
    x = x.astype(np.int32) if src == "INT32" else x
    _check(*_both(OpType.CAST, dict(dtype=DataType[dst]), [x],
                  jattrs=dict(dtype=JDataType[dst])), EXACT)


def test_cast_to_bf16_values():
    # numpy cannot hold bf16: compare the port's bf16 output through f32
    x = 3.1 * _x((4, 6))
    jop, op = _ops(OpType.CAST, dict(dtype=DataType.BFLOAT16),
                   dict(dtype=JDataType.BFLOAT16), [x.shape])
    want = np.asarray(jop.forward(JLowerCtx(mesh=None, training=False),
                                  [jnp.asarray(x)], {})[0].astype(jnp.float32))
    got = op.forward(LowerCtx(training=False), [torch.from_numpy(x)], {})[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("value", [np.arange(12, dtype=np.int64).reshape(3, 4),
                                   np.linspace(-1, 1, 10).reshape(2, 5),
                                   np.array([[True, False, True]])],
                         ids=["int", "float", "bool"])
def test_constant_matches_jax_and_lives_on_the_device_once(value):
    from flexflow_tpu import FFConfig as JFFConfig
    from flexflow_tpu import FFModel as JFFModel

    jff = JFFModel(JFFConfig(batch_size=1))
    jt = jff.constant(value, name="c")
    ff = FFModel(FFConfig(batch_size=1, device="cpu"))
    t = ff.constant(value, name="c")
    assert (t.dims, t.dtype.value) == (tuple(jt.dims), jt.dtype.value)
    jop, op = _ops(OpType.CONSTANT, ff.layers[0].attrs, jff.layers[0].attrs, [])
    op.materialize(torch.device("cpu"))
    first = op.forward(LowerCtx(training=False), [], {})[0]
    # the same tensor every step: no per-step host copy
    assert op.forward(LowerCtx(training=False), [], {})[0] is first
    np.testing.assert_array_equal(
        first.numpy(), np.asarray(jop.forward(JLowerCtx(mesh=None), [], {})[0]))


def _sl(start=None, stop=None, step=None):
    return {"kind": "slice", "start": start, "stop": stop, "step": step}


SLICES = [
    ("int_first", [_sl(), {"kind": "int", "i": 0}]),
    ("int_negative", [{"kind": "int", "i": -1}, _sl(1, 4)]),
    ("strided", [_sl(None, None, 2), _sl(1, None, 3), _sl(-3)]),
    ("reverse_all", [_sl(None, None, -1)]),
    ("negative_step", [_sl(4, 0, -2), _sl(None, 1, -1), _sl(-1, -6, -3)]),
    ("negative_step_empty", [_sl(0, 3, -1)]),
    ("negative_step_and_int", [_sl(3, None, -2), {"kind": "int", "i": 2}, _sl(None, None, -2)]),
    ("trailing_pass_through", [_sl(1, 3)]),
]


@pytest.mark.parametrize("items", [s[1] for s in SLICES], ids=[s[0] for s in SLICES])
def test_slice_matches_jax(items):
    _check(*_both(OpType.SLICE, dict(items=items), [_x((5, 6, 7))]), EXACT)


@pytest.mark.parametrize("i", [5, -6])
def test_slice_out_of_range_int_raises(i):
    items = [_sl(), {"kind": "int", "i": i}]
    for make, layer_cls in ((jcreate_op, JLayer), (create_op, Layer)):
        pshape = (JPShape if make is jcreate_op else ParallelTensorShape).unpartitioned((2, 5))
        op_type = JOpType.SLICE if make is jcreate_op else OpType.SLICE
        with pytest.raises(ValueError, match="out of range"):
            make(layer_cls(op_type, name="t", attrs=dict(items=items)),
                 [pshape]).infer_output_shapes()


REDUCE = [((1,), False), ((1,), True), ((0, 2), False), ((-1, 1), True),
          ((0, 1, 2), False), ((0, 1, 2), True), ((), False)]


@pytest.mark.parametrize("axes,keepdims", REDUCE, ids=lambda v: str(v))
@pytest.mark.parametrize("op_type", [OpType.REDUCE_SUM, OpType.MEAN], ids=lambda t: t.name)
def test_reductions_match_jax(op_type, axes, keepdims):
    _check(*_both(op_type, dict(axes=axes, keepdims=keepdims), [_x((3, 4, 5))]), SUMS)


def test_reduce_sum_of_int32_keeps_the_dtype():
    x = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    _check(*_both(OpType.REDUCE_SUM, dict(axes=(1,), keepdims=False), [x]), EXACT)


@pytest.mark.parametrize("a,b", [((4, 3, 5), (4, 5, 2)), ((2, 3, 4, 6), (2, 3, 6, 5))],
                         ids=["3d", "4d"])
def test_batch_matmul_matches_jax(a, b):
    attrs = dict(a_seq_length_dim=-1, b_seq_length_dim=-1)
    _check(*_both(OpType.BATCHMATMUL, attrs, [_x(a, 1), _x(b, 2)]), SUMS)


def test_split_verb_equal_parts_and_graph():
    """``split`` into equal parts, the parts re-joined by ``concat``, with
    ``reshape``/``transpose``/``reduce_sum``, compiled and run: the model
    gives the numpy answer."""
    ff = FFModel(FFConfig(batch_size=2, device="cpu"))
    x = ff.create_tensor((2, 6, 4), name="x")
    a, b, c = ff.split(x, 3, axis=1)
    t = ff.concat([c, a, b], axis=1)
    t = ff.transpose(ff.reshape(t, (2, -1, 2)), (0, 2, 1))
    t = ff.reduce_sum(t, axes=(1,), keepdims=True)
    ff.compile()
    xv = _x((2, 6, 4))
    got = ff.compiled.forward_fn(ff.compiled.params, torch.from_numpy(xv)).numpy()
    want = np.concatenate([xv[:, 4:], xv[:, :2], xv[:, 2:4]], axis=1)
    want = want.reshape(2, -1, 2).transpose(0, 2, 1).sum(axis=1, keepdims=True)
    np.testing.assert_allclose(got, want, **SUMS)
    with pytest.raises(ValueError, match="equal parts"):
        ff.split(x, 4, axis=1)
