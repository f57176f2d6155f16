"""The BERT proxy (``build_bert_proxy``: attention, residual, LayerNorm, a
GELU MLP, residual, LayerNorm per layer) trained by both packages.

Built small in both (2 layers, seq 16, hidden 32, 4 heads, batch 2) and
compiled with SGD and the MSE-avg loss; the JAX model runs its Pallas
kernels in the interpreter and its params are copied into the port. The
forward and five ``train_step``s must agree, in float32 and with
``compute_dtype="bfloat16"``, to the tolerances of
tests/test_torch_training.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_bert_proxy as jbuild_bert_proxy
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer, load_numpy_params
from flexflow_tpu_torch.models import TransformerConfig, build_bert_proxy
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH = 2
SHAPE = dict(hidden_size=32, embedding_size=32, num_heads=4, num_layers=2,
             sequence_length=16)
F32_TOL = 2e-5
BF16_TOL = 2 ** -5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


@functools.lru_cache(maxsize=None)
def _compiled_pair(compute_dtype):
    jff = JFFModel(JFFConfig(batch_size=BATCH, compute_dtype=compute_dtype, ledger="off",
                             audit_programs="off", attribution="off"))
    jbuild_bert_proxy(jff, BATCH, JTransformerConfig(**SHAPE))
    jff.compile(optimizer=JSGDOptimizer(lr=0.1),
                loss_type=JLossType.MEAN_SQUARED_ERROR_AVG_REDUCE, metrics=[],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    tff = FFModel(FFConfig(batch_size=BATCH, compute_dtype=compute_dtype, device="cpu"))
    build_bert_proxy(tff, BATCH, TransformerConfig(**SHAPE))
    tff.compile(optimizer=SGDOptimizer(lr=0.1),
                loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    return jff, tff


def _models(compute_dtype):
    """The pair with the same random params: variance-preserving weights,
    LayerNorm scales near 1, small biases."""
    jff, tff = _compiled_pair(compute_dtype)
    rng = np.random.default_rng(0)
    tree = {}
    for op, ws in jff.compiled.params.items():
        tree[op] = {}
        for w, v in ws.items():
            shape = tuple(v.shape)
            if w == "scale":
                a = 1.0 + 0.1 * rng.normal(size=shape)
            elif len(shape) == 1 or w.startswith("b"):
                a = 0.1 * rng.normal(size=shape)
            else:
                fan_in = shape[0] if w in ("wq", "wk", "wv") else int(np.prod(shape[:-1]))
                a = rng.normal(size=shape) / np.sqrt(fan_in)
            tree[op][w] = a.astype(np.float32)
    jff.compiled.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    jff.compiled.opt_state = jff.optimizer.init_state(jff.compiled.params)
    load_numpy_params(tff, tree)
    tff.compiled.opt_state = tff.optimizer.init_state(tff.compiled.params)
    return jff, tff


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"], ids=["float32", "bfloat16"])
def test_bert_proxy_forward_and_five_steps_match_jax(compute_dtype):
    jff, tff = _models(compute_dtype)
    tol = BF16_TOL if compute_dtype else F32_TOL
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6 * BATCH, SHAPE["sequence_length"], SHAPE["hidden_size"]))
    y = rng.normal(size=x.shape)
    x, y = x.astype(np.float32), y.astype(np.float32)
    jcm, tcm = jff.compiled, tff.compiled
    _close(tcm.forward_fn(tcm.params, torch.from_numpy(x[:BATCH])).numpy(),
           jcm.forward_fn(jcm.params, x[:BATCH]), tol, "forward")
    for i in range(5):
        xb, yb = x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]
        jcm.params, jcm.opt_state, jloss, _ = jcm.train_step(
            jcm.params, jcm.opt_state, jax.random.key(0), xb, yb)
        tcm.params, tcm.opt_state, tloss, _ = tcm.train_step(
            tcm.params, tcm.opt_state, i, torch.from_numpy(xb), torch.from_numpy(yb))
        _close(tloss.item(), float(jloss), tol, f"loss at step {i}")
    for op, ws in tcm.params.items():
        for w, t in ws.items():
            _close(t.detach().numpy(), jcm.params[op][w], tol, f"{op}.{w}")
    # tp_axis names the same strategies as the JAX builder's (the mesh
    # runs are tests/test_torch_parallel_training.py)
    tff, jff = FFModel(FFConfig(device="cpu")), JFFModel(JFFConfig(batch_size=BATCH))
    build_bert_proxy(tff, BATCH, TransformerConfig(**SHAPE), tp_axis="model")
    jbuild_bert_proxy(jff, BATCH, JTransformerConfig(**SHAPE), tp_axis="model")
    # by position: unnamed layers take each package's own name counter
    assert [(l.op_type.value, l.attrs.get("strategy")) for l in tff.layers] == \
        [(l.op_type.value, l.attrs.get("strategy")) for l in jff.layers]
    assert any(l.attrs.get("strategy") for l in tff.layers)
