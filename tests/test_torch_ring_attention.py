"""Sequence-parallel attention (``flexflow_tpu_torch/parallel/
ring_attention.py``) on 2 and 4 gloo ranks spawned on the CPU: ring and
Ulysses (all-to-all), causal and not, each rank's output block and the
gradients of sum(g * out) against the JAX package's ``ring_attention`` /
``ulysses_attention`` on as many host devices (and ``jax.grad``), and
against the port's one-process ``single_device_attention``. With dropout
the ranks keep the one-process mask's blocks, so the outputs agree with
the one-process run's at p > 0; and a model with attention dropout and a
Dropout op trains on {data: 2, seq: 2} as on one rank.

Tolerance: f32, the online softmax over blocks sums in another order than
one softmax: 1e-5 of the largest |value|."""

import numpy as np
import pytest
import torch

import jax

from flexflow_tpu.core.machine import make_mesh as jmake_mesh
from flexflow_tpu.parallel.ring_attention import ring_attention as jring
from flexflow_tpu.parallel.ring_attention import ulysses_attention as julysses
from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
from flexflow_tpu_torch.parallel.distributed import spawn
from flexflow_tpu_torch.parallel.ring_attention import single_device_attention

import _torch_mesh_workers as workers
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

B, S, H, D = 2, 16, 4, 8
SCALE, RATE = 0.3, 0.3
TOL = 1e-5


def _qkv():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4))
    u = rng.random((B, H, S, S)).astype(np.float32)
    return q, k, v, g, u


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


def _gathered(out, key, i):
    blocks = sorted((o["seq_index"], o[key][i] if isinstance(o[key], list) else o[key])
                    for o in out)
    return np.concatenate([b for _, b in blocks], axis=1)


# one process group a test: a module fixture would spawn again on every
# xdist worker that runs one of its tests
@pytest.mark.parametrize("n", [2, 4], ids=["seq2", "seq4"])
def test_ring_and_ulysses_match_jax_and_one_process(n):
    """Forward and gradients, causal and not, against the JAX functions
    and the one-process attention; with dropout, the one-process mask."""
    out = spawn(workers.attention, n, {"seq": n}, *_qkv(), RATE)
    for mode in ("ring", "a2a"):
        for causal in (False, True):
            _check_forward_and_gradients(n, out, mode, causal)
            _check_dropout(out, mode, causal)


def _check_forward_and_gradients(n, out, mode, causal):
    q, k, v, g, _ = _qkv()
    mesh = jmake_mesh({"seq": n}, jax.devices()[:n])
    fn = jring if mode == "ring" else julysses

    def loss(q, k, v):
        return (fn(q, k, v, mesh, "seq", causal=causal, scale=SCALE) * g).sum()

    jargs = [jax.numpy.asarray(a) for a in (q, k, v)]
    value, grads = jax.jit(jax.value_and_grad(
        lambda *a: (loss(*a), fn(*a, mesh, "seq", causal=causal, scale=SCALE)),
        argnums=(0, 1, 2), has_aux=True))(*jargs)
    want = [np.asarray(value[1])] + [np.asarray(t) for t in grads]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = single_device_attention(*ts, causal, SCALE)
    (o * torch.from_numpy(g)).sum().backward()
    one = [o.detach().numpy()] + [t.grad.numpy() for t in ts]
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = _gathered(out, (mode, causal), i)
        _close(got, want[i], f"{mode} causal={causal} {name} vs JAX")
        _close(got, one[i], f"{mode} causal={causal} {name} vs one process")


def _check_dropout(out, mode, causal):
    q, k, v, _, u = _qkv()
    got = _gathered(out, (mode, causal, "drop"), 0)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    want = single_device_attention(*args, causal, SCALE, RATE, torch.from_numpy(u)).numpy()
    plain = single_device_attention(*args, causal, SCALE).numpy()
    _close(got, want, f"{mode} causal={causal} with dropout")
    assert np.abs(want - plain).max() > 10 * TOL * np.abs(plain).max()  # it drops


SHAPE = dict(hidden_size=16, num_heads=4, sequence_length=8)


def test_attention_and_dropout_ops_train_on_a_mesh_as_on_one_rank():
    """Attention dropout through the ring and a Dropout op on a tensor
    sharded on batch and sequence draw the one-rank masks: two train
    steps' losses and params agree with the one-rank port's."""
    rng = np.random.default_rng(3)
    batch = 4
    ff = FFModel(FFConfig(batch_size=batch, device="cpu"))
    workers.build(ff, "dropout", batch, SHAPE)
    ff.compile(SGDOptimizer(lr=0.05), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    params = {op: {w: rng.standard_normal(t.shape).astype(np.float32) * 0.3
                   for w, t in ws.items()} for op, ws in ff.compiled.params.items()}
    batches = [(rng.standard_normal((batch, 8, 16)).astype(np.float32),
                rng.standard_normal((batch, 8, 1)).astype(np.float32)) for _ in range(2)]
    got = spawn(workers.train, 4, "dropout", {"data": 2, "seq": 2}, SHAPE, {"seq_axis": "seq"},
                params, batches, "MEAN_SQUARED_ERROR_AVG_REDUCE", None, 5)
    want = workers.train(0, 1, "dropout", None, SHAPE, {}, params, batches,
                         "MEAN_SQUARED_ERROR_AVG_REDUCE", None, 5)
    other = workers.train(0, 1, "dropout", None, SHAPE, {}, params, batches,
                          "MEAN_SQUARED_ERROR_AVG_REDUCE", None, 50)
    assert {r["backend"] for r in got} == {"gloo"}
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=TOL)
    # other keys draw other masks: the agreement is the masks'
    assert abs(other["losses"][0] - want["losses"][0]) > 1e-3 * abs(want["losses"][0])
    for op, ws in want["params"].items():
        for w, a in ws.items():
            _close(got[0]["params"][op][w], a, f"{op}.{w}")
