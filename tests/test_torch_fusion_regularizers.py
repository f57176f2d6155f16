"""The fusion pass, weight regularizers and the Cache op: the port against
the JAX package.

* ``apply_fusion`` turns the same layer graph into the same layer list in
  both packages (names, types, each fused chain's sub-layers), with a
  chain ending on the protected logits tensor and a two-consumer break;
  the fused model's forward and gradient EQUAL the unfused model's (the
  sub-ops run as they run unfused).
* ``L1``, ``L2`` and ``L1L2`` penalties equal the JAX package's within
  1e-6 relative, and three trained steps with each agree within
  ``F32_TOL``; ``eval`` and ``grad_step`` add no penalty in either package.
* The Cache op passes its input through, as the JAX op does.
"""

import functools

import numpy as np
import pytest
import torch

import jax

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
from flexflow_tpu.keras import regularizers as jreg
from flexflow_tpu.ops.fused import apply_fusion as japply_fusion
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel, LossType, OpType,
                                SGDOptimizer, load_numpy_params)
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.op import LowerCtx, create_op
from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
from flexflow_tpu_torch.keras import regularizers as treg
from flexflow_tpu_torch.ops.fused import apply_fusion

# f32, relative to the largest value compared: the same MLP in the same
# precision, sums in another order, over three updates
F32_TOL = 2e-5
BATCH = 8
_JKW = dict(ledger="off", audit_programs="off", attribution="off")


def _chain(ff, act_cls):
    """input -> dense -> relu -> scalar_multiply -> scalar_multiply -> exp
    -> tanh -> dense -> relu, whose output two layers read (exp and tanh:
    the chain breaks there) -> add -> dense -> sigmoid -> identity (the
    logits). Returns (sigmoid's output, the logits)."""
    x = ff.create_tensor((BATCH, 16), name="input")
    h = ff.dense(x, 32, name="body")
    h = ff.relu(h, name="r1")
    h = ff.scalar_multiply(h, 1.5, name="s1")
    h = ff.exp(ff.scalar_multiply(h, 0.1, name="s2"), name="e1")
    h = ff.tanh(h, name="t1")
    r = ff.relu(ff.dense(h, 16, name="mid"), name="r2")
    two = ff.add(ff.exp(r, name="e2"), ff.tanh(r, name="t2"), name="join")
    sg = ff.sigmoid(ff.dense(two, 4, name="head"), name="sg")
    return sg, ff.identity(sg, name="out")


def _describe(layers):
    return [(l.op_type.value, l.name, [s.name for s in l.attrs.get("sub_layers", [])])
            for l in layers]


def test_apply_fusion_gives_the_jax_layer_list():
    jff = JFFModel(JFFConfig(batch_size=BATCH, **_JKW))
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    (jsg, jout), (sg, out) = _chain(jff, JActiMode), _chain(ff, ActiMode)
    lists = {}
    for key, jprot, prot in (("none", set(), set()),
                             ("logits", {jout.tensor_id}, {out.tensor_id}),
                             ("sigmoid", {jsg.tensor_id}, {sg.tensor_id})):
        lists[key] = _describe(apply_fusion(ff.layers, prot))
        assert lists[key] == _describe(japply_fusion(jff.layers, jprot))
    fused = [d for d in lists["logits"] if d[0] == "fused"]
    assert fused[0][2] == ["r1", "s1", "s2", "e1", "t1"]
    assert ("relu", "r2", []) in lists["logits"]  # two consumers: no chain
    # the chain may end on the logits; a protected tensor inside a chain
    # breaks it
    assert fused[-1][2] == ["sg", "out"]
    assert ("sigmoid", "sg", []) in lists["sigmoid"]
    assert [l.name for l in ff.layers][:3] == ["body", "r1", "s1"]  # not mutated


def _fused_pair():
    models = []
    for fusion in (False, True):
        ff = FFModel(FFConfig(batch_size=BATCH, device="cpu", perform_fusion=fusion, seed=2))
        _chain(ff, ActiMode)
        ff.compile(SGDOptimizer(lr=0.1), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        models.append(ff)
    return models


def test_fused_forward_and_gradient_equal_the_unfused():
    plain, fused = _fused_pair()
    assert OpType.FUSED in [op.op_type for op in fused.compiled.ops]
    assert len(fused.compiled.ops) < len(plain.compiled.ops)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(BATCH, 16)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(BATCH, 4)).astype(np.float32))
    assert torch.equal(plain.compiled.forward_fn(plain.compiled.params, x),
                       fused.compiled.forward_fn(fused.compiled.params, x))
    ga = plain.compiled.grad_step(plain.compiled.params, 1, x, y)
    gb = fused.compiled.grad_step(fused.compiled.params, 1, x, y)
    for op in ga:
        for w in ga[op]:
            assert torch.equal(ga[op][w], gb[op][w]), (op, w)


def test_fused_dropout_draws_the_unfused_mask():
    outs = []
    for fusion in (False, True):
        ff = FFModel(FFConfig(batch_size=BATCH, device="cpu", perform_fusion=fusion))
        x = ff.create_tensor((BATCH, 16), name="input")
        h = ff.relu(ff.dense(x, 16, name="body"), name="r")
        h = ff.dropout(ff.dropout(h, 0.5, name="d1"), 0.5, name="d2")
        ff.dense(h, 4, name="head")
        ff.compile(SGDOptimizer(lr=0.1), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        g = ff.compiled.grad_step(ff.compiled.params, 7, torch.ones(BATCH, 16),
                                  torch.ones(BATCH, 4))
        outs.append(g["head"]["kernel"])
    assert torch.equal(outs[0], outs[1])


REGS = {"l1": (dict(l1=0.02),), "l2": (dict(l2=0.03),), "l1l2": (dict(l1=0.01, l2=0.02),)}


def _reg(pkg, name):
    cls = {"l1": pkg.L1, "l2": pkg.L2, "l1l2": pkg.L1L2}[name]
    return cls(**REGS[name][0])


@pytest.mark.parametrize("name", sorted(REGS))
def test_penalties_equal_jax(name):
    w = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)
    got = float(_reg(treg, name).penalty(torch.from_numpy(w)))
    want = float(_reg(jreg, name).penalty(jax.numpy.asarray(w)))
    assert got == pytest.approx(want, rel=1e-6)


@functools.lru_cache(maxsize=None)
def _reg_pair(name):
    jff = JFFModel(JFFConfig(batch_size=BATCH, **_JKW))
    x = jff.create_tensor((BATCH, 16), name="input")
    h = jff.dense(x, 32, JActiMode.RELU, kernel_regularizer=_reg(jreg, name), name="body")
    jff.dense(h, 4, name="head")
    jff.compile(optimizer=JSGDOptimizer(lr=0.1),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    pair = []
    for reg in (_reg(treg, name), None):
        ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
        t = ff.create_tensor((BATCH, 16), name="input")
        ff.dense(ff.dense(t, 32, ActiMode.RELU, kernel_regularizer=reg, name="body"), 4,
                 name="head")
        ff.compile(SGDOptimizer(lr=0.1), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
        pair.append(ff)
    return jff, pair[0], pair[1]


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(BATCH, 16)).astype(np.float32),
             rng.integers(0, 4, size=(BATCH, 1)).astype(np.int32)] for _ in range(3)]


def _load(jff, *ffs):
    tree = {op: {w: np.asarray(v) for w, v in ws.items()}
            for op, ws in jff.compiled.params.items()}
    for ff in ffs:
        load_numpy_params(ff, tree)
        ff.compiled.opt_state = ff.optimizer.init_state(ff.compiled.params)
    return tree


@pytest.mark.parametrize("name", sorted(REGS))
def test_trained_steps_with_a_regularizer_match_jax(name):
    jff, ff, bare = _reg_pair(name)
    tree = _load(jff, ff, bare)
    jcm, cm = jff.compiled, ff.compiled
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    jopt = jff.optimizer.init_state(jparams)
    for i, b in enumerate(_batches()):
        jparams, jopt, jloss, _ = jcm.train_step(jparams, jopt, jax.random.key(i),
                                                 *map(jax.numpy.asarray, b))
        cm.params, cm.opt_state, loss, _ = cm.train_step(cm.params, cm.opt_state, i + 1,
                                                         *map(torch.from_numpy, b))
        assert float(loss) == pytest.approx(float(jloss), rel=F32_TOL)
    for op, ws in jparams.items():
        for w, v in ws.items():
            want = np.asarray(v)
            got = cm.params[op][w].detach().numpy()
            assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max(), (op, w)
    # the training loss is the bare model's plus the penalty
    b = [torch.from_numpy(a) for a in _batches()[0]]
    _load(jff, ff, bare)
    losses = [float(m.compiled.train_step(m.compiled.params, m.compiled.opt_state, 1, *b)[2])
              for m in (ff, bare)]
    pen = float(_reg(treg, name).penalty(torch.from_numpy(tree["body"]["kernel"].copy())))
    assert pen > 0
    assert losses[0] == pytest.approx(losses[1] + pen, rel=1e-6)


@pytest.mark.parametrize("name", sorted(REGS))
def test_eval_and_grad_step_add_no_penalty(name):
    jff, ff, bare = _reg_pair(name)
    _load(jff, ff, bare)
    b = _batches(seed=1)[0]
    tb = [torch.from_numpy(a) for a in b]
    jb = [jax.numpy.asarray(a) for a in b]
    g_reg = ff.compiled.grad_step(ff.compiled.params, 1, *tb)
    g_bare = bare.compiled.grad_step(bare.compiled.params, 1, *tb)
    for op in g_bare:
        for w in g_bare[op]:
            assert torch.equal(g_reg[op][w], g_bare[op][w])
    jg = jff.compiled.grad_step(jff.compiled.params, jax.random.key(0), *jb)
    np.testing.assert_allclose(g_reg["body"]["kernel"].numpy(),
                               np.asarray(jg["body"]["kernel"]), rtol=0,
                               atol=F32_TOL * float(np.abs(np.asarray(jg["body"]["kernel"])).max()))
    loss_reg = float(ff.compiled.eval_step(ff.compiled.params, *tb)[0])
    loss_bare = float(bare.compiled.eval_step(bare.compiled.params, *tb)[0])
    assert loss_reg == loss_bare
    assert loss_reg == pytest.approx(float(jff.compiled.eval_step(jff.compiled.params,
                                                                  *jb)[0]), rel=F32_TOL)


def test_cache_op_passes_its_input_through():
    x = np.random.default_rng(2).normal(size=(3, 5)).astype(np.float32)
    jop = jcreate_op(JLayer(JOpType.CACHE, name="c"), [JPShape.unpartitioned((3, 5))])
    op = create_op(Layer(OpType.CACHE, name="c"), [ParallelTensorShape.unpartitioned((3, 5))])
    assert [(tuple(s), d.value) for s, d in op.infer_output_shapes()] == [
        (tuple(s), d.value) for s, d in jop.infer_output_shapes()]
    (got,) = op.forward(LowerCtx(), [torch.from_numpy(x)], {})
    (want,) = jop.forward(JLowerCtx(mesh=None), [jax.numpy.asarray(x)], {})
    assert torch.equal(got, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
