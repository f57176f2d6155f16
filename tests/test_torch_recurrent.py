"""The port's LSTM, GRU and RNN against the JAX package's.

Each op is built in both packages from the same attrs and input shapes
(batch 3, 6 steps, 5 features, hidden 4); inputs, the four weights and a
cotangent for every output are made with numpy from a seed. Every output
(the sequence or the last hidden state, then the final h and c with
``return_state``) and the gradients of x, of the initial state where one
is given and of each weight (``jax.vjp`` against autograd) must agree
within rtol and atol 1e-5 in float32: the same cell math, each step's
products summed in another order and carried through six steps. The
compiled tests hold ``lstm``'s verb outputs and ``load_numpy_params``'s
copy of the four weights.
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
from flexflow_tpu_torch import ActiMode, FFConfig, FFModel, load_numpy_params
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.op import LowerCtx, create_op
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.ffconst import OpType
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, D, H = 3, 6, 5, 4
CELLS = {OpType.LSTM: 2, OpType.GRU: 1, OpType.RNN: 1}  # state inputs


def _both(op_type, attrs, jattrs, n_states, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, D)] + [(B, H)] * n_states
    jop = jcreate_op(JLayer(JOpType(op_type.value), name="t", attrs=jattrs),
                     [JPShape.unpartitioned(s) for s in shapes])
    op = create_op(Layer(op_type, name="t", attrs=attrs),
                   [ParallelTensorShape.unpartitioned(s) for s in shapes])
    assert [(s.name, s.shape) for s in op.weight_specs()] == \
        [(s.name, tuple(s.shape)) for s in jop.weight_specs()]
    specs = op.infer_output_shapes()
    assert [s for s, _ in specs] == [tuple(s) for s, _ in jop.infer_output_shapes()]
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ws = {s.name: (0.5 * rng.normal(size=s.shape)).astype(np.float32)
          for s in op.weight_specs()}
    gs = [rng.normal(size=s).astype(np.float32) for s, _ in specs]

    jouts, vjp = jax.vjp(
        lambda xv, wv: jop.forward(JLowerCtx(mesh=None, training=True), xv, wv),
        [jnp.asarray(a) for a in xs], {k: jnp.asarray(v) for k, v in ws.items()})
    jdx, jdw = vjp([jnp.asarray(g) for g in gs])
    txs = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    tws = {k: torch.from_numpy(v).requires_grad_(True) for k, v in ws.items()}
    touts = op.forward(LowerCtx(training=True), txs, tws)
    assert len(touts) == len(jouts)
    torch.autograd.backward(list(touts), [torch.from_numpy(g) for g in gs])
    for i, (j, t) in enumerate(zip(jouts, touts)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL,
                                   err_msg=f"output {i}")
    for i, (j, t) in enumerate(zip(jdx, txs)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL,
                                   err_msg=f"grad of input {i}")
    for k, t in tws.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jdw[k]), **TOL,
                                   err_msg=f"grad of {k}")


@pytest.mark.parametrize("return_sequences,return_state",
                         [(True, False), (True, True), (False, False), (False, True)],
                         ids=["seq", "seq_state", "last", "last_state"])
@pytest.mark.parametrize("initial_state", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("op_type", list(CELLS), ids=lambda t: t.name)
def test_recurrent_ops_match_jax(op_type, initial_state, return_sequences, return_state):
    attrs = dict(hidden_size=H, return_sequences=return_sequences,
                 return_state=return_state)
    _both(op_type, attrs, attrs, CELLS[op_type] if initial_state else 0)


def test_lstm_with_only_h0_matches_jax():
    """An LSTM given h0 alone starts from c0 = 0."""
    attrs = dict(hidden_size=H, return_state=True)
    _both(OpType.LSTM, attrs, attrs, 1)


def test_relu_rnn_matches_jax():
    attrs = dict(hidden_size=H, activation=ActiMode.RELU, return_state=True)
    _both(OpType.RNN, attrs, dict(attrs, activation=JActiMode.RELU), 1)


def test_lstm_verb_outputs_and_params_cross_over():
    """``lstm(return_state=True)`` gives [seq, h, c] of the declared shapes;
    a params tree crosses over with ``load_numpy_params`` unchanged, and the
    compiled forward's last hidden state is the sequence's last step."""
    ff = FFModel(FFConfig(batch_size=B, device="cpu"))
    x = ff.create_tensor((B, S, D), name="x")
    seq, h, c = ff.lstm(x, H, return_state=True, name="enc")
    assert (seq.dims, h.dims, c.dims) == ((B, S, H), (B, H), (B, H))
    ff.gru(seq, H, initial_state=h, name="dec")
    ff.compile()
    rng = np.random.default_rng(4)
    tree = {op: {w: rng.normal(size=tuple(v.shape)).astype(np.float32)
                 for w, v in ws.items()} for op, ws in ff.compiled.params.items()}
    assert sorted(tree["enc"]) == ["bias", "kernel", "recurrent_bias", "recurrent_kernel"]
    load_numpy_params(ff, tree)
    for op, ws in tree.items():
        for w, v in ws.items():
            np.testing.assert_array_equal(ff.compiled.params[op][w].numpy(), v)
    out = ff.compiled.forward_fn(ff.compiled.params,
                                 torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32)))
    assert out.shape == (B, S, H) and torch.isfinite(out).all()
