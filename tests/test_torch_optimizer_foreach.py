"""The port's multi-tensor optimizer updates (``runtime/optimizer.py``)
against the JAX package's optimizers, with the hyperparameters read from
0-d device tensors and Adam's step count kept in its state as a tensor
(and read back from a checkpoint that stored it as a Python int).

Tolerance: rtol 1e-6, atol 1e-7 after five steps. Both packages compute
the reference's formulas in f32 from the same inputs; XLA may fuse a
multiply into an add and round once where the port rounds twice, and
``b ** t`` and the square roots may differ by an ulp.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from flexflow_tpu.runtime import optimizer as joptim
from flexflow_tpu_torch.runtime import optimizer as toptim
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"d0": {"kernel": (6, 5), "bias": (5,)}, "d1": {"kernel": (5, 3), "bias": (3,)},
          "n": {"scale": (7,)}}
WD_MASK = {op: {w: w == "kernel" for w in ws} for op, ws in SHAPES.items()}

OPTS = {
    "sgd": lambda m: m.SGDOptimizer(lr=0.1),
    "momentum": lambda m: m.SGDOptimizer(lr=0.05, momentum=0.9),
    "nesterov_wd": lambda m: m.SGDOptimizer(lr=0.05, momentum=0.8, nesterov=True,
                                            weight_decay=0.01),
    "adam": lambda m: m.AdamOptimizer(alpha=0.01),
    "adam_wd": lambda m: m.AdamOptimizer(alpha=0.01, beta1=0.8, beta2=0.95,
                                         weight_decay=0.05),
}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {op: {w: rng.normal(size=s).astype(np.float32) for w, s in ws.items()}
            for op, ws in SHAPES.items()}


def _run(name, steps=5, lr_at=None):
    """Both packages' optimizers over ``steps`` steps from one tree; the
    port's reads its hyperparameters from its device tensors, filled
    before each step. ``lr_at``: (step, value) of a change between
    steps."""
    jopt, topt = OPTS[name](joptim), OPTS[name](toptim)
    start = _tree(0)
    jp = {op: {w: jnp.asarray(a) for w, a in ws.items()} for op, ws in start.items()}
    tp = {op: {w: torch.from_numpy(a.copy()) for w, a in ws.items()}
          for op, ws in start.items()}
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    hyper_ids = None
    for step in range(steps):
        if lr_at is not None and step == lr_at[0]:
            for o in (jopt, topt):
                setattr(o, "lr" if hasattr(o, "lr") else "alpha", lr_at[1])
        grads = _tree(10 + step)
        jp, js = jopt.update(jp, {op: {w: jnp.asarray(a) for w, a in ws.items()}
                                  for op, ws in grads.items()}, js, WD_MASK,
                             jopt.hyperparams())
        hyper = topt.load_hyper(torch.device("cpu"))
        ids = {k: id(v) for k, v in hyper.items()}
        assert hyper_ids is None or ids == hyper_ids  # one set of tensors, refilled
        hyper_ids = ids
        same = topt.update(tp, {op: {w: torch.from_numpy(a) for w, a in ws.items()}
                                for op, ws in grads.items()}, ts, WD_MASK, hyper)
        assert same[0] is tp
        tp, ts = same
    return jp, js, tp, ts


def _assert_close(tp, jp):
    for op, ws in tp.items():
        for w, t in ws.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[op][w]), **TOL,
                                       err_msg=f"{op}.{w}")


@pytest.mark.parametrize("name", list(OPTS))
def test_foreach_updates_match_jax_over_five_steps(name):
    jp, js, tp, ts = _run(name)
    _assert_close(tp, jp)
    if name.startswith("adam"):
        _assert_close(ts["m"], js["m"])
        _assert_close(ts["v"], js["v"])
    elif name != "sgd":
        _assert_close(ts, js)


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_a_learning_rate_changed_between_steps_takes_effect(name):
    """The change reaches the step through the device scalar the update
    reads (which a replayed graph reads too), and equals the JAX
    package's run with the same change; without the change the params
    differ."""
    jp, _, tp, _ = _run(name, lr_at=(2, 0.002))
    _assert_close(tp, jp)
    _, _, unchanged, _ = _run(name)
    assert not torch.equal(unchanged["d0"]["kernel"], tp["d0"]["kernel"])


def test_adam_step_count_is_a_device_tensor_advanced_in_place():
    _, js, _, ts = _run("adam", steps=3)
    t = ts["t"]
    assert isinstance(t, torch.Tensor) and t.dim() == 0 and t.dtype == torch.int32
    assert float(t) == float(js["t"]) == 3.0
    topt = toptim.AdamOptimizer()
    state = topt.init_state({"a": {"w": torch.zeros(3)}})
    before = state["t"]
    topt.update({"a": {"w": torch.zeros(3)}}, {"a": {"w": torch.ones(3)}}, state,
                {"a": {"w": False}})
    assert state["t"] is before and float(before) == 1.0


def test_a_checkpoint_with_a_host_step_count_restores_and_trains_on(tmp_path):
    """A checkpoint written while Adam's ``t`` was a Python int restores:
    the int is copied into the device tensor, and training goes on as
    from the same checkpoint with ``t`` stored as a tensor."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, LossType
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = rng.integers(0, 3, size=(8, 1)).astype(np.int32)

    def model():
        ff = FFModel(FFConfig(batch_size=4, device="cpu", seed=3))
        t = ff.dense(ff.create_tensor((4, 6), name="x"), 8, name="d0")
        ff.dense(t, 3, name="d1")
        ff.compile(AdamOptimizer(alpha=0.01), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
        return ff

    ff = model()
    ff.fit(x, y, epochs=1, verbose=False)
    CheckpointManager(str(tmp_path / "new")).save(ff, 1)
    CheckpointManager(str(tmp_path / "old")).save(ff, 1)
    payload = tmp_path / "old" / "1" / "state.pt"
    state = torch.load(payload, weights_only=True)
    state["opt_state"]["t"] = int(state["opt_state"]["t"])
    torch.save(state, payload)
    runs = []
    for d in ("new", "old"):
        fresh = model()
        assert CheckpointManager(str(tmp_path / d)).restore(fresh, step=1) == 1
        t = fresh.compiled.opt_state["t"]
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32 and int(t) == 2
        fresh.fit(x, y, epochs=1, verbose=False)
        runs.append(fresh.compiled.params)
    for op, ws in runs[0].items():
        for w, a in ws.items():
            assert torch.equal(a, runs[1][op][w]), f"{op}.{w}"


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["nesterov_wd", "adam_wd"])
def test_an_update_issues_the_same_ops_for_any_number_of_weights(name):
    """Multi-tensor ops: ten times the weights, the same op count (an
    eager per-weight loop issued a few ops a weight)."""
    counts = []
    for n in (4, 40):
        topt = OPTS[name](toptim)
        params = {f"op{i}": {"kernel": torch.ones(3, 2)} for i in range(n)}
        grads = {f"op{i}": {"kernel": torch.ones(3, 2)} for i in range(n)}
        mask = {f"op{i}": {"kernel": True} for i in range(n)}
        state = topt.init_state(params)
        hyper = topt.load_hyper(torch.device("cpu"))
        with _Ops() as ops:
            topt.update(params, grads, state, mask, hyper)
        counts.append(ops.n)
    assert counts[0] == counts[1] < 30, counts
