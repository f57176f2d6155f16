"""The ONNX walker of the port against the JAX package's
(``onnx_frontend/model.py``). The ``onnx`` package is on neither
machine, so the walker runs on duck-typed, attribute-less graphs (Gemm,
MatMul, Relu, Add, Reshape with a constant shape, an embedding Gather):
each ``ONNXModel`` is made with ``object.__new__`` and given ``model``,
``inits`` and ``weight_bindings``; both packages replay the graph, bind
its initializers after compile, and their outputs are held to each other
and to numpy. The import gate is the counterpart of
``tests/test_onnx_frontend.py::test_onnx_import_gate``; an ``"onnx"``
repository entry no longer raises ``NotImplementedError``, and with a
stand-in ``onnx`` module (``load`` returns the duck-typed graph) it
serves the file's graph with its initializers on two instances, and on
a rank group over ``{model: 2}``.

Tolerance (f32): 1e-5 relative and absolute (the same matmuls in
another order)."""

import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.ffconst import CompMode as JCompMode
from flexflow_tpu.ffconst import DataType as JDataType
from flexflow_tpu.onnx_frontend import ONNXModel as JONNXModel
from flexflow_tpu_torch import CompMode, DataType, FFConfig, FFModel
from flexflow_tpu_torch.onnx_frontend import ONNXModel
from flexflow_tpu_torch.serving import InferenceEngine

from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL = 1e-5


class _Node:
    def __init__(self, op_type, inputs, outputs, name):
        self.op_type, self.input, self.output, self.name = op_type, list(inputs), list(outputs), name
        self.attribute = []


class _Value:
    """A graph input or output: ``name`` and ``type.tensor_type.shape.dim``."""

    def __init__(self, name, dims=()):
        self.name = name
        dim = [types.SimpleNamespace(dim_value=d) for d in dims]
        self.type = types.SimpleNamespace(tensor_type=types.SimpleNamespace(
            shape=types.SimpleNamespace(dim=dim)))


def _graph(gather=True):
    """x (4, 10) -> Gemm(W1, b1) -> Relu -> MatMul(W2) -> Add(skip) ->
    Reshape(4, 8, 2) -> Reshape(4, -1) -> Gemm(W3), the skip a Gemm of x;
    ids (4, 5) -> Gather(E)."""
    rng = np.random.default_rng(0)
    inits = {"W1": rng.normal(size=(10, 16)).astype(np.float32) * 0.3,
             "b1": rng.normal(size=16).astype(np.float32) * 0.1,
             "W2": rng.normal(size=(16, 16)).astype(np.float32) * 0.3,
             "Ws": rng.normal(size=(10, 16)).astype(np.float32) * 0.3,
             "bs": rng.normal(size=(1, 16)).astype(np.float32) * 0.1,
             "shape1": np.array([4, 8, 2], np.int64),
             "shape2": np.array([4, -1], np.int64),
             "W3": rng.normal(size=(16, 3)).astype(np.float32) * 0.3,
             "b3": np.zeros(3, np.float32),
             "E": rng.normal(size=(12, 6)).astype(np.float32)}
    nodes = [_Node("Gemm", ["x", "W1", "b1"], ["h"], "g1"),
             _Node("Relu", ["h"], ["r"], "r1"),
             _Node("MatMul", ["r", "W2"], ["m"], "m1"),
             _Node("Gemm", ["x", "Ws", "bs"], ["s"], "skip"),
             _Node("Add", ["m", "s"], ["a"], "add"),
             _Node("Reshape", ["a", "shape1"], ["z"], "rs1"),
             _Node("Reshape", ["z", "shape2"], ["f"], "rs2"),
             _Node("Gemm", ["f", "W3", "b3"], ["y"], "g3")]
    inputs, outputs = [_Value("x", (0, 10))], [_Value("y")]
    if gather:
        nodes.append(_Node("Gather", ["E", "ids"], ["e"], "emb"))
        inputs.append(_Value("ids", (4, 5)))
        outputs.append(_Value("e"))
    graph = types.SimpleNamespace(
        node=nodes, input=inputs, output=outputs,
        initializer=[types.SimpleNamespace(name=k, array=v) for k, v in inits.items()])
    return types.SimpleNamespace(graph=graph), inits


def _reference(inits, x, ids):
    h = np.maximum(x @ inits["W1"] + inits["b1"], 0) @ inits["W2"]
    a = h + x @ inits["Ws"] + inits["bs"]
    return a.reshape(4, 16) @ inits["W3"] + inits["b3"], inits["E"][ids]


def _walker(cls):
    model, inits = _graph()
    om = object.__new__(cls)
    om.model, om.inits, om.weight_bindings = model, dict(inits), []
    return om, inits


def _run(pkg):
    cls = ONNXModel if pkg == "port" else JONNXModel
    om, inits = _walker(cls)
    if pkg == "port":
        ff = FFModel(FFConfig(batch_size=4, computation_mode=CompMode.INFERENCE, device="cpu"))
        xs = [ff.create_tensor((4, 10), name="x"), ff.create_tensor((4, 5), DataType.INT32,
                                                                    name="ids")]
    else:
        ff = JFFModel(JFFConfig(batch_size=4, computation_mode=JCompMode.INFERENCE, ledger="off",
                                audit_programs="off", attribution="off"))
        xs = [ff.create_tensor((4, 10), name="x"), ff.create_tensor((4, 5), JDataType.INT32,
                                                                    name="ids")]
    y, e = om.apply(ff, xs)
    assert tuple(y.dims) == (4, 3) and tuple(e.dims) == (4, 5, 6)
    ff.compile(optimizer=None, loss_type=None, metrics=[], logits_tensor=y)
    assert om.copy_weights(ff) == 8
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 10)).astype(np.float32)
    ids = rng.integers(0, 12, size=(4, 5)).astype(np.int32)
    cm = ff.compiled
    if pkg == "port":
        got = cm.forward_fn(cm.params, torch.from_numpy(x), torch.from_numpy(ids)).numpy()
        table = cm.params["emb"]["weight"].numpy()
    else:
        got = np.asarray(cm.forward_fn(cm.params, x, ids))
        table = np.asarray(cm.params["emb"]["weight"])
    return got, table, _reference(inits, x, ids)


def test_onnx_walker_matches_jax_and_numpy():
    got, table, (want, _) = _run("port")
    jgot, jtable, _ = _run("jax")
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jgot, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(table, jtable)  # the Gather bound its table


def test_onnx_reshape_copies_a_zero_dim_before_inferring():
    """ONNX's (0, -1): the port copies the 0 first (the JAX package
    infers -1 first and refuses the shape)."""
    om, _ = _walker(ONNXModel)
    om.inits["s"] = np.array([0, -1], np.int64)
    ff = FFModel(FFConfig(batch_size=4, device="cpu"))
    x = ff.create_tensor((4, 8, 2), name="x")
    out = om.handleReshape(ff, _Node("Reshape", ["x", "s"], ["y"], "r"), {"x": x})
    assert tuple(out.dims) == (4, 16)


def test_onnx_walker_refusals_match_jax():
    for cls in (ONNXModel, JONNXModel):
        om, _ = _walker(cls)
        om.inits["W3d"] = np.zeros((2, 3, 4), np.float32)
        ff = (FFModel(FFConfig(batch_size=4, device="cpu")) if cls is ONNXModel
              else JFFModel(JFFConfig(batch_size=4, ledger="off")))
        x = ff.create_tensor((4, 3), name="x")
        with pytest.raises(ValueError, match="rank"):
            om.handleMatMul(ff, _Node("MatMul", ["x", "W3d"], ["y"], "m"), {"x": x})
        with pytest.raises(ValueError, match="unsupported ONNX op"):
            om.model.graph.node = [_Node("Loop", ["x"], ["y"], "l")]
            om.model.graph.input = [_Value("x", (4, 3))]
            om.apply(ff, [x])


def test_onnx_import_gate():
    try:
        import onnx  # noqa: F401

        pytest.skip("onnx present; gate path not reachable")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="onnx"):
        ONNXModel("nonexistent.onnx")
    with pytest.raises(ImportError, match="onnx"):
        JONNXModel("nonexistent.onnx")


def _repository(tmp_path):
    path = tmp_path / "repo.json"
    path.write_text(json.dumps({"models": {"mlp": {"onnx": str(tmp_path / "m.onnx"),
                                                   "instances": 2, "batch_size": 4}}}))
    return str(path)


def test_onnx_repository_entry_is_no_longer_refused(tmp_path):
    eng = InferenceEngine()
    try:
        with pytest.raises(ImportError, match="onnx"):  # the gate, not NotImplementedError
            eng.load_repository(_repository(tmp_path), devices=["cpu", "cpu:1"])
    finally:
        eng.stop()


def test_onnx_repository_serves_the_files_graph(tmp_path, monkeypatch):
    """A stand-in ``onnx`` module whose ``load`` returns the duck-typed
    graph: two instances, each answering with the file's initializers."""
    model, inits = _graph(gather=False)
    fake = types.ModuleType("onnx")
    fake.load = lambda path: model
    helper = types.ModuleType("onnx.numpy_helper")
    helper.to_array = lambda init: init.array
    fake.numpy_helper = helper
    monkeypatch.setitem(sys.modules, "onnx", fake)
    monkeypatch.setitem(sys.modules, "onnx.numpy_helper", helper)
    eng = InferenceEngine()
    try:
        placed = eng.load_repository(_repository(tmp_path),
                                     devices=[torch.device("cpu"), torch.device("cpu", 1)])
        assert placed == {"mlp": 2}
        eng.start()
        rng = np.random.default_rng(2)
        x = rng.normal(size=(4, 10)).astype(np.float32)
        got = np.stack([eng.infer("mlp", [x[i]]) for i in range(4)])
        want, _ = _reference(inits, x, np.zeros((4, 5), np.int32))
        np.testing.assert_allclose(got.reshape(4, -1), want, rtol=TOL, atol=TOL)
    finally:
        eng.stop()


def _picklable(model):
    """The duck-typed graph rebuilt from SimpleNamespaces (a rank process
    unpickles it without this module)."""
    g = model.graph
    ns = types.SimpleNamespace
    val = lambda v: ns(name=v.name, type=v.type)  # noqa: E731
    return ns(graph=ns(
        node=[ns(op_type=n.op_type, input=n.input, output=n.output, name=n.name, attribute=[])
              for n in g.node],
        input=[val(v) for v in g.input], output=[val(v) for v in g.output],
        initializer=list(g.initializer)))


def test_onnx_repository_entry_serves_over_a_rank_group(tmp_path, monkeypatch):
    """An ``"onnx"`` entry with a ``mesh_shape``: the ranks of the group
    build the graph through ``ONNXBuilder`` (a stand-in ``onnx`` package
    on their path reads the pickled graph) and serve the file's
    initializers, handed to them in op order."""
    import pickle

    model, inits = _graph(gather=False)
    onnx_file = tmp_path / "m.onnx"
    onnx_file.write_bytes(pickle.dumps(_picklable(model)))
    pkg = tmp_path / "fake" / "onnx"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text(
        "import pickle\nfrom . import numpy_helper\n\n\n"
        "def load(path):\n    with open(path, 'rb') as f:\n        return pickle.load(f)\n")
    (pkg / "numpy_helper.py").write_text("def to_array(init):\n    return init.array\n")
    monkeypatch.syspath_prepend(str(pkg.parent))  # the spawned ranks get the parent's path
    fake = types.ModuleType("onnx")
    fake.load = lambda path: pickle.loads(pathlib.Path(path).read_bytes())
    helper = types.ModuleType("onnx.numpy_helper")
    helper.to_array = lambda init: init.array
    fake.numpy_helper = helper
    monkeypatch.setitem(sys.modules, "onnx", fake)
    monkeypatch.setitem(sys.modules, "onnx.numpy_helper", helper)
    repo = tmp_path / "repo.json"
    repo.write_text(json.dumps({"models": {"mlp": {
        "onnx": str(onnx_file), "instances": 1, "batch_size": 4, "mesh_shape": {"model": 2}}}}))
    eng = InferenceEngine(batch_timeout_s=0.01)
    try:
        assert eng.load_repository(str(repo), devices=["cpu:0", "cpu:1"]) == {"mlp": 1}
        x = np.random.default_rng(5).normal(size=(4, 10)).astype(np.float32)
        got = np.stack([eng.infer("mlp", [row], timeout=120) for row in x])
    finally:
        eng.stop()
    want, _ = _reference(inits, x, np.zeros((4, 5), np.int32))
    np.testing.assert_allclose(got.reshape(4, -1), want, rtol=TOL, atol=TOL)
