"""The rest of the port's ``native_bridge``: the graph algorithms of
``native/src/graph_algos.cc`` held to the JAX package's bindings of the
same source on seeded random DAGs; the threaded C++ loader
(``NativeLoader``, ``native/src/dataloader.cc``) held to the Python
loader batch for batch (shuffled epochs, the wrap past an epoch, a
rank's rows, the resume's fast-forward) and to the JAX package's native
loader; ``fit`` through it equal to ``fit`` through the Python loader bit
for bit; no quiet fallback; and the task-graph export's transitive
reduction. Everything is exact: the loaders move bytes, the graph
algorithms are integer."""

import json

import numpy as np
import pytest
import torch

import flexflow_tpu.native_bridge as jnb
from flexflow_tpu.runtime.dataloader import DataLoaderGroup as JDataLoaderGroup
from flexflow_tpu.runtime.dataloader import SingleDataLoader as JSingleDataLoader
from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer, native_bridge
from flexflow_tpu_torch.models import build_mlp
from flexflow_tpu_torch.runtime.dataloader import DataLoaderGroup, SingleDataLoader

from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)


def _dag(seed, n=24, p=0.2):
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    return [(int(order[i]), int(order[j])) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


@pytest.mark.parametrize("seed", range(3))
def test_graph_algorithms_equal_the_jax_packages(seed):
    edges = _dag(seed)
    assert native_bridge.toposort(24, edges) == jnb.toposort(24, edges)
    assert native_bridge.transitive_reduction(24, edges) == jnb.transitive_reduction(24, edges)
    root = edges[0][0]
    assert native_bridge.dominators(24, edges, root) == jnb.dominators(24, edges, root)
    with pytest.raises(ValueError, match="cycle"):
        native_bridge.toposort(3, [(0, 1), (1, 2), (2, 0)])


def _arrays(n=35):
    rng = np.random.default_rng(1)
    return (rng.normal(size=(n, 3, 2)).astype(np.float32),
            np.arange(n, dtype=np.int32).reshape(n, 1))


def _group(native, monkeypatch, rows=slice(None), seed=5):
    if native:
        monkeypatch.delenv("FLEXFLOW_TPU_NATIVE", raising=False)
    else:
        monkeypatch.setenv("FLEXFLOW_TPU_NATIVE", "off")
    x, y = _arrays()
    g = DataLoaderGroup([SingleDataLoader(x, 8, torch.device("cpu"), rows),
                         SingleDataLoader(y, 8, torch.device("cpu"), rows)],
                        seed=seed, shuffle=True)
    assert g.native is native
    return g


def _drain(g, epochs=3, extra=2):
    out = []
    g.advance_epochs(1)  # a resumed fit's replay of one epoch's shuffle
    for _ in range(epochs):
        g.reset()
        g.skip_batches(1)
        for _ in range(g.num_batches - 1 + extra):  # past the epoch: it wraps
            out.append([b.copy() for b in g.next_batch_host()])
    return out


@pytest.mark.parametrize("rows", [slice(None), slice(4, 8)], ids=["whole", "rank1of2"])
def test_native_loader_batches_equal_the_python_loaders(monkeypatch, rows):
    native = _drain(_group(True, monkeypatch, rows))
    python = _drain(_group(False, monkeypatch, rows))
    assert len(native) == len(python) == 3 * (4 - 1 + 2)
    for a, b in zip(native, python):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


def test_native_loader_equals_the_jax_packages(monkeypatch):
    g = _group(True, monkeypatch)
    x, y = _arrays()
    jg = JDataLoaderGroup([JSingleDataLoader(x, 8), JSingleDataLoader(y, 8)], seed=5,
                          shuffle=True)
    assert jg._native is not None
    for _ in range(2):
        g.reset()
        jg.reset()
        for _ in range(g.num_batches):
            for u, v in zip(g.next_batch_host(), jg.next_batch_host()):
                np.testing.assert_array_equal(u, np.asarray(v))


def _fit(native, monkeypatch):
    if native:
        monkeypatch.delenv("FLEXFLOW_TPU_NATIVE", raising=False)
    else:
        monkeypatch.setenv("FLEXFLOW_TPU_NATIVE", "off")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(50, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(50, 1)).astype(np.int32)
    ff = FFModel(FFConfig(batch_size=8, seed=0, device="cpu", audit_programs="off"))
    build_mlp(ff, 8, in_dim=8, hidden_dims=(16,), num_classes=4)
    ff.compile(optimizer=SGDOptimizer(lr=0.05),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
    pms = ff.fit(x, y, epochs=2, shuffle=True, verbose=False)
    return ff.numpy_params(), [p.sparse_cce_loss for p in pms]


def test_fit_through_the_native_loader_equals_the_python_loader(monkeypatch):
    a, b = _fit(True, monkeypatch), _fit(False, monkeypatch)
    assert a[1] == b[1]
    for op, ws in a[0].items():
        for w, v in ws.items():
            np.testing.assert_array_equal(v, b[0][op][w])


def test_no_quiet_fallback(monkeypatch):
    def broken():
        raise RuntimeError("native runtime build failed")

    monkeypatch.delenv("FLEXFLOW_TPU_NATIVE", raising=False)
    monkeypatch.setattr(native_bridge, "load_runtime_library", broken)
    x, y = _arrays()
    with pytest.raises(RuntimeError, match="build failed"):
        DataLoaderGroup([SingleDataLoader(x, 8, torch.device("cpu")),
                         SingleDataLoader(y, 8, torch.device("cpu"))], seed=0)
    with pytest.raises(ValueError, match="whole batch"):
        native_bridge.NativeLoader([x[:3]], 8)


def test_task_graph_export_takes_the_transitive_reduction(tmp_path, monkeypatch):
    ff = FFModel(FFConfig(batch_size=16, seed=0, device="cpu", audit_programs="off"))
    build_mlp(ff, 16, in_dim=8, hidden_dims=(16, 16), num_classes=4)
    ff.compile(optimizer=SGDOptimizer(lr=0.05),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
    reduced, full = str(tmp_path / "r.json"), str(tmp_path / "f.json")
    ff.export_task_graph(reduced, fmt="json")
    monkeypatch.setenv("FLEXFLOW_TPU_NATIVE", "off")
    ff.export_task_graph(full, fmt="json")
    r, f = json.load(open(reduced)), json.load(open(full))
    assert r["tasks"] == f["tasks"]
    edges = [tuple(e) for e in f["edges"]]
    assert [tuple(e) for e in r["edges"]] == jnb.transitive_reduction(len(f["tasks"]), edges)
    assert len(r["edges"]) < len(edges)
