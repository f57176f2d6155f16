"""The port's MoE kernels, routing and ops against the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX
``row_gather``/``row_gather_sum`` Pallas kernels in the interpreter (as
tests/test_kernels.py runs them on the CPU) and through the port's wrappers
on CPU tensors, which run the kernels' plain versions; the routing, the
differentiable dispatch/combine and every MoE op are held against their JAX
counterparts the same way. The CUDA kernels themselves are held against the
plain versions on the card by tests/test_torch_kernels_cuda.py.
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
from flexflow_tpu.kernels import moe_kernels as jmk
from flexflow_tpu.ops import moe_ops as jmoe
from flexflow_tpu_torch import kernels as tkernels
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.op import LowerCtx, create_op
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.ffconst import ActiMode, DataType, OpType
from flexflow_tpu_torch.kernels import moe_kernels as tmk
from flexflow_tpu_torch.ops import moe_ops as tmoe
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

# f32: a gather is exact and each output element is a product, or a sum of
# k products in the same order, rounded to f32 on both sides: 1e-6
# relative leaves room only for a contraction into an FMA on one side
F32_TOL = dict(rtol=1e-6, atol=1e-6)
# bf16 outputs: both sides round the same f32 value to bf16; one bf16 ulp
# (2^-8 relative) covers an f32 difference that straddles a rounding edge
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)
# through softmaxes and products of f32 values: sums in another order
OP_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


def _as(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


@DTYPES
def test_row_gather_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(10, 24)).astype(np.float32)
    idx = np.array([3, 0, 9, 3, 7, 0], np.int32)
    scale = np.array([1.0, 0.0, 2.5, -1.0, 0.3, 1.0], np.float32)  # a scale-0 row
    jx, tx = _as(x, dtype)
    want = jmk.row_gather(jx, jnp.asarray(idx), jnp.asarray(scale), interpret=True)
    tkernels.reset_launch_counts()
    got = tmk.row_gather(tx, torch.from_numpy(idx), torch.from_numpy(scale))
    assert got.dtype == tx.dtype and got.shape == (6, 24)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    assert tkernels.launch_counts()["row_gather"] == 0  # CPU tensors launch nothing


@DTYPES
@pytest.mark.parametrize("k", [1, 2, 3])
def test_row_gather_sum_plain_matches_jax_kernel(dtype, k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(12, 20)).astype(np.float32)
    idx = rng.integers(0, 12, size=(7, k)).astype(np.int32)
    w = rng.normal(size=(7, k)).astype(np.float32)
    w[2] = 0.0  # a row of zero weights
    jx, tx = _as(x, dtype)
    want = jmk.row_gather_sum(jx, jnp.asarray(idx), jnp.asarray(w), interpret=True)
    got = tmk.row_gather_sum(tx, torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == tx.dtype and got.shape == (7, 20)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    assert not got[2].any()


def test_plain_versions_raise_on_out_of_range_indices():
    x = torch.zeros((4, 8))
    with pytest.raises(IndexError):
        tmk.row_gather(x, torch.tensor([0, 4], dtype=torch.int32), torch.ones(2))
    with pytest.raises(IndexError):
        tmk.row_gather_sum(x, torch.tensor([[0, -5]], dtype=torch.int32), torch.ones(1, 2))


def _assign(seed, b, n, k):
    """Distinct expert ids per row, as a top-k gives them."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n)[:k] for _ in range(b)]).astype(np.int32)


@pytest.mark.parametrize("b,n,k,capacity", [
    (16, 4, 2, 8), (16, 4, 2, 3), (9, 3, 1, 2), (32, 5, 2, 26), (8, 4, 3, 1)])
def test_compute_routing_equals_jax(b, n, k, capacity):
    """slot, keep, src, valid and the inverse map, exactly; small
    capacities force drops (clamped to slot 0 with keep 0)."""
    assign = _assign(b * n + k, b, n, k)
    want = jmk.compute_routing(jnp.asarray(assign), n, capacity)
    got = tmk.compute_routing(torch.from_numpy(assign), n, capacity)
    for name, g, w, dt in zip(("slot", "keep", "src", "valid"), got, want,
                              (torch.int32, torch.float32, torch.int32, torch.float32)):
        assert g.dtype == dt, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if capacity * n < b * k:
        assert (got[1] == 0).any()  # some picks dropped
    slot, keep, src, valid = want
    inv = jmk._slot_to_pick(slot, keep, n * capacity, valid)
    np.testing.assert_array_equal(
        tmk._slot_to_pick(*got[:2], n * capacity, got[3]).numpy(), np.asarray(inv))


@DTYPES
def test_topk_breaks_ties_as_jax(dtype):
    """A ReLU gate's rows are often all 0, or hold several equal values:
    the indices must be JAX's (lowest index first), and sorted."""
    x = np.array([[0, 0, 0, 0, 0], [0, 1, 0, 1, 0], [2, 0, 2, 2, 0],
                  [0.5, 0.25, 0, 0.25, 0.5], [0, 0, 0, 0, 3]], np.float32)
    x = np.concatenate([x, np.zeros((1, 5), np.float32)])
    wide = np.zeros((2, 64), np.float32)
    wide[1, 40:] = 1.0
    for arr, k in ((x, 2), (x, 3), (wide, 2), (wide, 5)):
        jx, tx = _as(arr, dtype)
        jvals, jidx = jax.lax.top_k(jx, k)
        op = create_op(Layer(OpType.TOPK, name="t", attrs=dict(k=k, sorted=False)),
                       [ParallelTensorShape.unpartitioned(arr.shape)])
        vals, idx = op.forward(LowerCtx(), [tx], {})
        assert idx.dtype == torch.int32 and vals.dtype == tx.dtype
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(_np(vals), _np(jvals))


def test_dispatch_mask_matches_jax():
    assign = _assign(3, 12, 4, 2)
    for capacity in (2, 6):
        np.testing.assert_array_equal(
            tmoe.moe_dispatch_mask(torch.from_numpy(assign), 4, capacity).numpy(),
            np.asarray(jmoe.moe_dispatch_mask(jnp.asarray(assign), 4, capacity)))
    assert tmoe.expert_capacity(64, 2, 5, 2.0) == jmoe.expert_capacity(64, 2, 5, 2.0) == 52


@pytest.mark.parametrize("capacity", [6, 3])
def test_dispatch_combine_values_and_grads_match_jax(capacity):
    """moe_dispatch -> moe_combine and their gradients (dx through the
    dispatch's backward, drows and dgate through the combine's) against
    jax.grad through the JAX custom VJPs, with drops at capacity 3."""
    rng = np.random.default_rng(capacity)
    b, d, n, k = 16, 12, 4, 2
    x = rng.normal(size=(b, d)).astype(np.float32)
    gate = rng.uniform(0.1, 1.0, size=(b, k)).astype(np.float32)
    assign = _assign(capacity, b, n, k)
    cot = rng.normal(size=(b, d)).astype(np.float32)
    ja = jnp.asarray(assign)

    def jf(x, gate):
        rows = jmk.moe_dispatch(x, ja, n, capacity)
        return jnp.sum(jmk.moe_combine(jnp.tanh(rows), ja, gate) * cot)

    jrows = jmk.moe_dispatch(jnp.asarray(x), ja, n, capacity)
    jout = jmk.moe_combine(jrows, ja, jnp.asarray(gate))
    jdx, jdgate = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(gate))

    tx = torch.from_numpy(x).requires_grad_(True)
    tg = torch.from_numpy(gate).requires_grad_(True)
    ta = torch.from_numpy(assign)
    rows = tmk.moe_dispatch(tx, ta, n, capacity)
    assert rows.shape == (n, capacity, d)
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(jrows), **F32_TOL)
    out = tmk.moe_combine(rows, ta, tg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **F32_TOL)
    torch.sum(tmk.moe_combine(torch.tanh(rows), ta, tg) * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **OP_TOL, err_msg="dx")
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jdgate), **OP_TOL,
                               err_msg="dgate")


def test_plain_flag_gives_the_same_dispatch_and_combine_on_cpu():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
    a = torch.from_numpy(_assign(9, 8, 3, 2))
    for plain in (False, True):
        rows = tmk.moe_dispatch(x, a, 3, 4, plain=plain)
        out = tmk.moe_combine(rows, a, torch.ones(8, 2), plain=plain)
        if plain:
            assert torch.equal(rows, rows0) and torch.equal(out, out0)
        rows0, out0 = rows, out


# ---- the ops ------------------------------------------------------------


def _run_both(op_type, attrs, inputs, weights=None, jattrs=None, training=False):
    """Build the op in both packages and run both forwards on the same
    numpy inputs and weights; returns (JAX outputs, port outputs, JAX ctx,
    port ctx) with outputs as numpy."""
    shapes = [a.shape for a in inputs]
    dts = [DataType.INT32 if a.dtype == np.int32 else DataType.FLOAT for a in inputs]
    jop = jcreate_op(JLayer(JOpType(op_type.value), name="t", attrs=jattrs or attrs),
                     [JPShape.unpartitioned(s, jmoe.DataType(d.value))
                      for s, d in zip(shapes, dts)])
    op = create_op(Layer(op_type, name="t", attrs=attrs),
                   [ParallelTensorShape.unpartitioned(s, d) for s, d in zip(shapes, dts)])
    assert ([(s.name, s.shape) for s in op.weight_specs()]
            == [(s.name, s.shape) for s in jop.weight_specs()])
    weights = weights or {}
    jctx = JLowerCtx(mesh=None, training=training, aux_losses=[])
    tctx = LowerCtx(training=training, aux_losses=[])
    jout = jop.forward(jctx, [jnp.asarray(a) for a in inputs],
                       {k: jnp.asarray(v) for k, v in weights.items()})
    tout = op.forward(tctx, [torch.from_numpy(a) for a in inputs],
                      {k: torch.from_numpy(v) for k, v in weights.items()})
    assert len(jout) == len(tout)
    return [np.asarray(o) for o in jout], [_np(o) for o in tout], jctx, tctx


def test_softmax_matches_jax():
    x = np.random.default_rng(1).normal(size=(3, 4, 7)).astype(np.float32)
    for dim in (-1, 1):
        jout, tout, _, _ = _run_both(OpType.SOFTMAX, dict(dim=dim), [x])
        np.testing.assert_allclose(tout[0], jout[0], **OP_TOL)


def test_group_by_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 10)).astype(np.float32)
    assign = _assign(2, 16, 4, 2)
    jout, tout, _, _ = _run_both(OpType.GROUP_BY, dict(n=4, alpha=0.5), [x, assign])
    assert len(tout) == 4 and tout[0].shape == (4, 10)  # capacity ceil(0.5*2/4*16)
    for g, w in zip(tout, jout):
        np.testing.assert_array_equal(g, w)


def _agg_inputs(seed, b=12, n=3, k=2, cap=6, f=5):
    rng = np.random.default_rng(seed)
    gate = rng.uniform(0.1, 1.0, size=(b, k)).astype(np.float32)
    assign = _assign(seed, b, n, k)
    full = rng.normal(size=(b, n)).astype(np.float32)
    exps = [rng.normal(size=(cap, f)).astype(np.float32) for _ in range(n)]
    return gate, assign, full, exps


@pytest.mark.parametrize("op_type", [OpType.AGGREGATE, OpType.AGGREGATE_SPEC])
def test_aggregate_and_its_balance_term_match_jax(op_type):
    gate, assign, full, exps = _agg_inputs(3)
    jout, tout, jctx, tctx = _run_both(
        op_type, dict(n=3, lambda_bal=0.04), [gate, assign, assign, full] + exps,
        training=True)
    np.testing.assert_allclose(tout[0], jout[0], **OP_TOL)
    assert len(tctx.aux_losses) == len(jctx.aux_losses) == 1
    np.testing.assert_allclose(tctx.aux_losses[0].item(), float(jctx.aux_losses[0]),
                               **OP_TOL)
    # lambda_bal = 0 appends nothing
    _, _, _, tctx = _run_both(op_type, dict(n=3, lambda_bal=0.0),
                              [gate, assign, assign, full] + exps)
    assert tctx.aux_losses == []


def test_stacked_ops_match_jax():
    rng = np.random.default_rng(4)
    b, d, n, k, h = 12, 10, 3, 2, 6
    x = rng.normal(size=(b, d)).astype(np.float32)
    assign = _assign(4, b, n, k)
    jout, tout, _, _ = _run_both(OpType.GROUP_BY_STACKED, dict(n=n, alpha=1.0), [x, assign])
    np.testing.assert_array_equal(tout[0], jout[0])
    cap = tout[0].shape[1]
    w = {"kernel": (rng.normal(size=(n, d, h)) * 0.3).astype(np.float32),
         "bias": (rng.normal(size=(n, h)) * 0.1).astype(np.float32)}
    attrs = dict(out_dim=h, activation=ActiMode.RELU)
    jout, tout, _, _ = _run_both(OpType.EXPERT_LINEAR, attrs, [tout[0]], w,
                                 jattrs=dict(attrs, activation=JActiMode.RELU))
    np.testing.assert_allclose(tout[0], jout[0], **OP_TOL)
    gate, _, full, _ = _agg_inputs(4, b=b, n=n, k=k, cap=cap, f=h)
    jout, tout, jctx, tctx = _run_both(OpType.AGGREGATE_STACKED, dict(n=n, lambda_bal=0.04),
                                       [gate, assign, full, tout[0]], training=True)
    np.testing.assert_allclose(tout[0], jout[0], **OP_TOL)
    np.testing.assert_allclose(tctx.aux_losses[0].item(), float(jctx.aux_losses[0]),
                               **OP_TOL)


def test_aggregate_gradients_match_jax():
    """The op's vjp, balance term included: gradients of the gate weights,
    the full gate and every expert output against jax.vjp."""
    gate, assign, full, exps = _agg_inputs(5)
    n = len(exps)
    jop = jcreate_op(JLayer(JOpType.AGGREGATE, name="t", attrs=dict(n=n, lambda_bal=0.04)),
                     [JPShape.unpartitioned(a.shape) for a in [gate, assign, assign, full]
                      + exps])
    op = create_op(Layer(OpType.AGGREGATE, name="t", attrs=dict(n=n, lambda_bal=0.04)),
                   [ParallelTensorShape.unpartitioned(a.shape)
                    for a in [gate, assign, assign, full] + exps])
    cot = np.random.default_rng(6).normal(size=(12, 5)).astype(np.float32)

    def jloss(gate, full, exps):
        ctx = JLowerCtx(mesh=None, training=True, aux_losses=[])
        out = jop.forward(ctx, [gate, jnp.asarray(assign), jnp.asarray(assign), full]
                          + list(exps), {})[0]
        return jnp.sum(out * cot) + sum(ctx.aux_losses)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(gate), jnp.asarray(full),
                                              [jnp.asarray(e) for e in exps])
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [gate, full] + exps]
    ta = torch.from_numpy(assign)
    ctx = LowerCtx(training=True, aux_losses=[])
    out = op.forward(ctx, [leaves[0], ta, ta, leaves[1]] + leaves[2:], {})[0]
    (torch.sum(out * torch.from_numpy(cot)) + sum(ctx.aux_losses)).backward()
    for name, t, w in zip(["gate", "full_gate"] + [f"exp{i}" for i in range(n)], leaves,
                          [want[0], want[1]] + list(want[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **OP_TOL, err_msg=name)


def test_pinned_expert_axis_raises_until_a7():
    """A pinned expert axis builds and, on one rank, compiles to the
    unsharded model (the runs over a mesh are
    test_torch_expert_parallel.py); the n-branch formulation still takes
    no expert axis."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import MoeConfig, build_moe_mnist

    ff = FFModel(FFConfig(batch_size=8, device="cpu"))
    build_moe_mnist(ff, 8, MoeConfig(input_dim=16), stacked=True, expert_axis="data")
    ff.compile()
    assert not ff.compiled.ops[3].output_shapes[0].partition_axes
    out = ff.compiled.forward_fn(ff.compiled.params, torch.ones(8, 16))
    assert out.shape == (8, 10) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="stacked"):
        build_moe_mnist(FFModel(FFConfig(batch_size=8, device="cpu")), 8,
                        MoeConfig(input_dim=16), expert_axis="data")
