"""The torch.fx importer of the port against the JAX package's
(``flexflow_tpu_torch/torch_frontend/model.py`` vs
``flexflow_tpu/torch_frontend/model.py``): the same ``nn.Module``s as
``tests/test_torch_frontend.py`` (MLP, CNN, an attention block, the
size()-driven views, the LSTM/GRU idioms) traced by both importers give
equal IR record lists; each replays onto both packages' FFModel,
``copy_weights`` copies the module's parameters into both, and both
forwards are held to the module's own; an IR file written by either
package replays in the other; and the imported MLP and attention block
(the flash-attention op, its plain version on the CPU) train three SGD
steps in both packages to the same params.

Tolerances (f32): forwards 1e-4 relative and 1e-5 absolute (the
reference's own bound against torch; matmuls run in another order); the
trained params 1e-5 of their layer's largest |value| plus 2^-4 of their
largest update (``test_torch_training.py``'s)."""

import json

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax

from flexflow_tpu import DataType as JDataType
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import LossType as JLossType
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.torch_frontend import PyTorchModel as JPyTorchModel
from flexflow_tpu.torch_frontend import torch_to_flexflow as jtorch_to_flexflow
from flexflow_tpu.torch_frontend.model import copy_weights as jcopy_weights
from flexflow_tpu_torch import DataType, FFConfig, FFModel, LossType, SGDOptimizer
from flexflow_tpu_torch.torch_frontend import PyTorchModel, copy_weights, torch_to_flexflow

from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

RTOL, ATOL = 1e-4, 1e-5
TOL, UPDATE_TOL = 1e-5, 2 ** -4


class SmallMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(20, 32)
        self.act = nn.ReLU()
        self.fc2 = nn.Linear(32, 5)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)) + 0.5)


class SmallCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 4, 3, padding=1)
        self.bn = nn.BatchNorm2d(4)
        self.pool = nn.MaxPool2d(2, 2)
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(4 * 4 * 4, 3)

    def forward(self, x):
        return self.fc(self.flatten(self.pool(torch.relu(self.bn(self.conv1(x))))))


class AttentionBlock(nn.Module):
    """The chip script's Transformer layer at a tiny width."""

    def __init__(self, embed=16, heads=4):
        super().__init__()
        self.attn = nn.MultiheadAttention(embed, heads, batch_first=True)
        self.norm1 = nn.LayerNorm(embed)
        self.fc1 = nn.Linear(embed, 2 * embed)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(2 * embed, embed)
        self.norm2 = nn.LayerNorm(embed)

    def forward(self, x):
        a, _ = self.attn(x, x, x, need_weights=False)
        h = self.norm1(x + a)
        return self.norm2(h + self.fc2(self.act(self.fc1(h))))


class ViewNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(24, 24)

    def forward(self, x):
        h = self.fc(x.view(x.size(0), -1))
        h = h.view(x.size(0), 2, 12)
        return torch.tanh(h.reshape(x.size(0), 24))


class LSTMClassifier(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(6, 10, batch_first=True)
        self.fc = nn.Linear(10, 3)

    def forward(self, x):
        out, _ = self.lstm(x)
        return self.fc(out[:, -1])


class GRUSeq(nn.Module):
    def __init__(self):
        super().__init__()
        self.gru = nn.GRU(5, 8, batch_first=True)

    def forward(self, x):
        out, h = self.gru(x)
        return out


class LSTMFinalState(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(5, 9, batch_first=True)
        self.fc = nn.Linear(9, 2)

    def forward(self, x):
        out, (h, c) = self.lstm(x)
        return self.fc(h[-1])


# name: (module class, input shape, torch seed)
CASES = {
    "mlp": (SmallMLP, (8, 20), 0),
    "cnn": (SmallCNN, (4, 1, 8, 8), 1),
    "attention": (AttentionBlock, (2, 8, 16), 0),
    "views": (ViewNet, (4, 4, 6), 0),
    "lstm": (LSTMClassifier, (4, 7, 6), 0),
    "gru": (GRUSeq, (3, 6, 5), 1),
    "lstm_state": (LSTMFinalState, (4, 6, 5), 3),
}


def _module(name):
    cls, shape, seed = CASES[name]
    torch.manual_seed(seed)
    mod = cls().eval()
    if name == "cnn":  # non-trivial running stats, which copy_weights carries
        mod.bn.running_mean.uniform_(-0.5, 0.5)
        mod.bn.running_var.uniform_(0.5, 1.5)
    return mod, shape


def _replay(pm, pkg, shape, train=False):
    """(ff, output) of ``pm`` replayed onto a fresh FFModel of ``pkg``."""
    if pkg == "port":
        ff = FFModel(FFConfig(batch_size=shape[0], seed=0, device="cpu", audit_programs="off"))
        x = ff.create_tensor(shape, DataType.FLOAT, name="x")
    else:
        ff = JFFModel(JFFConfig(batch_size=shape[0], seed=0, ledger="off",
                                audit_programs="off", attribution="off"))
        x = ff.create_tensor(shape, JDataType.FLOAT, name="x")
    (out,) = pm.apply(ff, [x])
    opt = (SGDOptimizer if pkg == "port" else JSGDOptimizer)(lr=0.05)
    loss = (LossType if pkg == "port" else JLossType).MEAN_SQUARED_ERROR_AVG_REDUCE
    ff.compile(optimizer=opt, loss_type=loss if train else None, metrics=[],
               logits_tensor=out)
    return ff, out


def _forward(ff, pkg, x):
    cm = ff.compiled
    if pkg == "port":
        return cm.forward_fn(cm.params, torch.from_numpy(x)).numpy()
    return np.asarray(cm.forward_fn(cm.params, x))


@pytest.mark.parametrize("name", list(CASES))
def test_fx_import_ir_and_forward_match_jax(name):
    mod, shape = _module(name)
    pm, jpm = PyTorchModel(mod), JPyTorchModel(mod)
    assert pm.ir == jpm.ir
    x = np.random.default_rng(CASES[name][2]).normal(size=shape).astype(np.float32)
    with torch.no_grad():
        want = mod(torch.from_numpy(x)).numpy()
    ff, out = _replay(pm, "port", shape)
    jff, jout = _replay(jpm, "jax", shape)
    assert tuple(out.dims) == tuple(jout.dims) == want.shape
    assert pm.module_paths == jpm.module_paths
    copy_weights(ff, mod, pm.module_paths)
    jcopy_weights(jff, mod, jpm.module_paths)
    got, jgot = _forward(ff, "port", x), _forward(jff, "jax", x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    # the copy is the JAX package's, weight for weight
    jp = {op: {w: np.asarray(a) for w, a in ws.items()} for op, ws in jff.compiled.params.items()}
    for op, ws in ff.numpy_params().items():
        for w, a in ws.items():
            np.testing.assert_array_equal(a, jp[op][w], err_msg=f"{op}.{w}")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ir_file_replays_in_the_other_package(tmp_path, writer):
    mod, shape = _module("attention")
    path = str(tmp_path / "model.ff")
    (torch_to_flexflow if writer == "port" else jtorch_to_flexflow)(mod, path)
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    reader = JPyTorchModel(path) if writer == "port" else PyTorchModel(path)
    assert reader.ir == records == PyTorchModel(mod).ir
    ff, out = _replay(reader, "jax" if writer == "port" else "port", shape)
    assert tuple(out.dims) == shape
    assert any(l.name == "attn" for l in ff.layers)


def _train(pm, pkg, mod, shape, batches):
    ff, _ = _replay(pm, pkg, shape, train=True)
    (copy_weights if pkg == "port" else jcopy_weights)(ff, mod, pm.module_paths)
    cm = ff.compiled
    losses = []
    for x, y in batches:
        if pkg == "port":
            cm.params, cm.opt_state, l, _ = cm.train_step(
                cm.params, cm.opt_state, None, torch.from_numpy(x), torch.from_numpy(y))
        else:
            cm.params, cm.opt_state, l, _ = cm.train_step(
                cm.params, cm.opt_state, jax.random.key(0), x, y)
        losses.append(float(l))
    params = ff.numpy_params() if pkg == "port" else {
        op: {w: np.asarray(a) for w, a in ws.items()} for op, ws in cm.params.items()}
    return losses, params


@pytest.mark.parametrize("name", ["mlp", "attention"])
def test_imported_module_trains_like_jax(name):
    mod, shape = _module(name)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        out_shape = mod(torch.zeros(shape)).shape
    batches = [(rng.normal(size=shape).astype(np.float32),
                rng.normal(size=out_shape).astype(np.float32)) for _ in range(3)]
    start = {n: p.detach().numpy().copy() for n, p in mod.named_parameters()}
    losses, params = _train(PyTorchModel(mod), "port", mod, shape, batches)
    jlosses, jparams = _train(JPyTorchModel(mod), "jax", mod, shape, batches)
    assert all(np.array_equal(p.detach().numpy(), start[n]) for n, p in mod.named_parameters())
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    assert losses[-1] < losses[0]
    first = JPyTorchModel(mod)
    jff, _ = _replay(first, "jax", shape, train=True)
    jcopy_weights(jff, mod, first.module_paths)
    for op, ws in jparams.items():
        # a key bias has no gradient (softmax ignores it): its noise is
        # held to its layer's scale
        scale = max(float(np.abs(a).max()) for a in ws.values())
        for w, a in ws.items():
            a0 = np.asarray(jff.compiled.params[op][w])
            atol = TOL * scale + UPDATE_TOL * float(np.abs(a - a0).max())
            np.testing.assert_allclose(params[op][w], a, rtol=TOL, atol=atol, err_msg=f"{op}.{w}")


def test_batch_first_false_attention_is_refused():
    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = nn.MultiheadAttention(16, 4)

        def forward(self, x):
            return self.attn(x, x, x)[0]

    with pytest.raises(ValueError, match="batch_first"):
        PyTorchModel(M())
    with pytest.raises(ValueError, match="batch_first"):
        JPyTorchModel(M())
