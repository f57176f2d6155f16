"""torch.fx importer tests (reference analog: tests/align mt5/operator
alignment vs torch, SURVEY.md §4 — here the imported FF graph's forward is
compared against the torch module itself)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn as nn  # noqa: E402

from flexflow_tpu import FFConfig, FFModel, LossType, MetricsType, SGDOptimizer  # noqa: E402
from flexflow_tpu.torch_frontend import PyTorchModel, torch_to_flexflow  # noqa: E402
from flexflow_tpu.torch_frontend.model import copy_weights  # noqa: E402
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)


class SmallMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(20, 32)
        self.act = nn.ReLU()
        self.fc2 = nn.Linear(32, 5)

    def forward(self, x):
        h = self.act(self.fc1(x))
        h = h + 0.5
        return self.fc2(h)


class SmallCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 4, 3, padding=1)
        self.pool = nn.MaxPool2d(2, 2)
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(4 * 4 * 4, 3)

    def forward(self, x):
        h = torch.relu(self.conv1(x))
        h = self.pool(h)
        h = self.flatten(h)
        return self.fc(h)


def _import_and_forward(module, x_np, bs):
    ff = FFModel(FFConfig(batch_size=bs, seed=0))
    xin = ff.create_tensor(x_np.shape, name="input")
    m = PyTorchModel(module)
    (out,) = m.apply(ff, [xin])
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, metrics=[])
    copy_weights(ff, module)
    cm = ff.compiled
    y = cm.raw_forward(cm.params, x_np)
    return ff, np.asarray(y)


class TinyAttentionBlock(nn.Module):
    """Self-attention block: the functional-attention import path the
    round-1 importer rejected (VERDICT item 9)."""

    def __init__(self, embed=16, heads=4):
        super().__init__()
        self.attn = nn.MultiheadAttention(embed, heads, batch_first=True)
        self.norm = nn.LayerNorm(embed)
        self.fc = nn.Linear(embed, embed)

    def forward(self, x):
        a, _ = self.attn(x, x, x, need_weights=False)
        h = self.norm(x + a)
        return self.fc(h)


def test_multihead_attention_import_matches_torch():
    torch.manual_seed(0)
    mod = TinyAttentionBlock().eval()
    bs, S, E = 2, 8, 16
    x = np.random.default_rng(0).normal(size=(bs, S, E)).astype(np.float32)
    ff, got = _import_and_forward(mod, x, bs)
    with torch.no_grad():
        want = mod(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_multihead_attention_batch_first_false_rejected():
    mod = nn.MultiheadAttention(16, 4)  # batch_first=False

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = mod

        def forward(self, x):
            return self.attn(x, x, x)[0]

    with pytest.raises(ValueError, match="batch_first"):
        PyTorchModel(M())


def test_mlp_import_matches_torch():
    torch.manual_seed(0)
    mod = SmallMLP().eval()
    x = np.random.default_rng(0).normal(size=(8, 20)).astype(np.float32)
    ff, got = _import_and_forward(mod, x, 8)
    want = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cnn_import_matches_torch():
    torch.manual_seed(1)
    mod = SmallCNN().eval()
    x = np.random.default_rng(1).normal(size=(4, 1, 8, 8)).astype(np.float32)
    ff, got = _import_and_forward(mod, x, 4)
    want = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_ir_file_roundtrip(tmp_path):
    mod = SmallMLP()
    p = str(tmp_path / "model.ff")
    torch_to_flexflow(mod, p)
    m2 = PyTorchModel(p)  # replay from file, no torch module needed
    ff = FFModel(FFConfig(batch_size=8, seed=0))
    xin = ff.create_tensor((8, 20), name="input")
    (out,) = m2.apply(ff, [xin])
    assert out.dims == (8, 5)
    assert any(l.name == "fc1" for l in ff.layers)


def test_imported_model_trains():
    mod = SmallMLP()
    ff = FFModel(FFConfig(batch_size=16, epochs=10, seed=0))
    xin = ff.create_tensor((16, 20), name="input")
    (out,) = PyTorchModel(mod).apply(ff, [xin])
    ff.compile(optimizer=SGDOptimizer(lr=0.05),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 20)).astype(np.float32)
    w = rng.normal(size=(20, 5)).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32).reshape(-1, 1)
    hist = ff.fit(x, y, verbose=False)
    assert hist[-1].accuracy > hist[0].accuracy


class ViewNet(nn.Module):
    """Exercises x.size(0)-driven view/reshape idioms."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(24, 24)

    def forward(self, x):
        h = self.fc(x.view(x.size(0), -1))       # flatten via size()
        h = h.view(x.size(0), 2, 12)             # dynamic-batch reshape
        return h.reshape(x.size(0), 24)


def test_size_driven_views_import():
    torch.manual_seed(0)
    mod = ViewNet().eval()
    x = np.random.default_rng(3).normal(size=(4, 4, 6)).astype(np.float32)
    ff, got = _import_and_forward(mod, x, 4)
    want = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_import_lstm_classifier_matches_torch():
    """nn.LSTM/GRU modules import 1:1 (our recurrent ops share torch's
    gate order/layout, ops/recurrent.py) including tensor slicing of the
    sequence output."""
    import torch
    import torch.nn as nn

    from flexflow_tpu import DataType, FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu.torch_frontend import PyTorchModel, copy_weights

    class SeqClassifier(nn.Module):
        def __init__(self):
            super().__init__()
            self.lstm = nn.LSTM(6, 10, batch_first=True)
            self.fc = nn.Linear(10, 3)

        def forward(self, x):
            out, _ = self.lstm(x)
            return self.fc(out[:, -1])

    torch.manual_seed(0)
    mod = SeqClassifier().eval()
    pm = PyTorchModel(mod)
    ff = FFModel(FFConfig(batch_size=4))
    x = ff.create_tensor((4, 7, 6), DataType.FLOAT, name="x")
    (out,) = pm.apply(ff, [x])
    assert out.dims == (4, 3)
    ff.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=None, metrics=[])
    copy_weights(ff, mod, pm.module_paths)
    xs = np.random.default_rng(0).normal(size=(4, 7, 6)).astype(np.float32)
    got = np.asarray(ff.compiled.forward_fn(ff.compiled.params, xs))
    with torch.no_grad():
        ref = mod(torch.tensor(xs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_import_gru_state_output():
    """GRU returns (output, h); consuming the final state imports too."""
    import torch
    import torch.nn as nn

    from flexflow_tpu import DataType, FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu.torch_frontend import PyTorchModel, copy_weights

    class G(nn.Module):
        def __init__(self):
            super().__init__()
            self.gru = nn.GRU(5, 8, batch_first=True)

        def forward(self, x):
            out, h = self.gru(x)
            return out

    torch.manual_seed(1)
    mod = G().eval()
    pm = PyTorchModel(mod)
    ff = FFModel(FFConfig(batch_size=3))
    x = ff.create_tensor((3, 6, 5), DataType.FLOAT, name="x")
    (out,) = pm.apply(ff, [x])
    # the unused state output h is also a graph leaf; pin the output
    ff.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=None, metrics=[],
               logits_tensor=out)
    copy_weights(ff, mod, pm.module_paths)
    xs = np.random.default_rng(1).normal(size=(3, 6, 5)).astype(np.float32)
    got = np.asarray(ff.compiled.forward_fn(ff.compiled.params, xs))
    with torch.no_grad():
        ref = mod(torch.tensor(xs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_import_lstm_final_state_idiom():
    """`out, (h, c) = lstm(x); fc(h[-1])` — the most common torch LSTM
    classifier shape — imports (states emulate torch's num_layers dim)."""
    import torch
    import torch.nn as nn

    from flexflow_tpu import DataType, FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu.torch_frontend import PyTorchModel, copy_weights

    class C(nn.Module):
        def __init__(self):
            super().__init__()
            self.lstm = nn.LSTM(5, 9, batch_first=True)
            self.fc = nn.Linear(9, 2)

        def forward(self, x):
            out, (h, c) = self.lstm(x)
            return self.fc(h[-1])

    torch.manual_seed(3)
    mod = C().eval()
    pm = PyTorchModel(mod)
    ff = FFModel(FFConfig(batch_size=4))
    x = ff.create_tensor((4, 6, 5), DataType.FLOAT, name="x")
    (out,) = pm.apply(ff, [x])
    ff.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=None, metrics=[],
               logits_tensor=out)
    copy_weights(ff, mod, pm.module_paths)
    xs = np.random.default_rng(3).normal(size=(4, 6, 5)).astype(np.float32)
    got = np.asarray(ff.compiled.forward_fn(ff.compiled.params, xs))
    with torch.no_grad():
        ref = mod(torch.tensor(xs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
