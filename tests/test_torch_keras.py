"""The Keras frontend of the port against the JAX package's
(``flexflow_tpu_torch/keras`` vs ``flexflow_tpu/keras``): Sequential and
functional models built by both, the JAX package's initial params copied
into the port (``load_numpy_params``), then trained through ``fit`` with
the same shuffles; the callbacks act alike (the History logs, the
learning-rate schedule's effect on the params, EarlyStopping's epoch
count, the accuracy gates); ``predict``'s padded tail, a batch-size
change that keeps the weights, and the datasets' seeded samples.

Tolerances (f32): losses and logs 1e-5 relative (sums in another order);
params 1e-5 of their layer's largest |value| plus 2^-4 of their largest
update (``test_torch_training.py``'s); predictions 1e-5; counts exactly."""

import numpy as np
import pytest

import flexflow_tpu.keras as jk
import flexflow_tpu_torch.keras as pk
from flexflow_tpu_torch import load_numpy_params

from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

TOL, UPDATE_TOL = 1e-5, 2 ** -4


def _toy(n=64, d=8, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, classes)).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32).reshape(-1, 1)


def _mlp(k):
    return k.Sequential([k.Dense(16, activation="relu", name="fc1"), k.Dense(4, name="fc2")])


def _functional(k):
    inp = k.Input((8,))
    a = k.Dense(8, activation="relu", name="a")(inp)
    b = k.Dense(8, activation="tanh", name="b")(inp)
    s = k.Add(name="sum")([a, b])
    c = k.Concatenate(axis=1, name="cat")([s, a])
    return k.Model(inp, k.Dense(4, name="out")(c))


def _cnn(k):
    return k.Sequential([k.Conv2D(4, 3, padding="same", activation="relu", name="conv"),
                         k.MaxPooling2D(2, name="pool"), k.Flatten(name="flat"),
                         k.Dense(3, name="fc")])


def _cnn_data():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(32, 1, 8, 8)).astype(np.float32),
            rng.integers(0, 3, size=(32, 1)).astype(np.int32))


MODELS = {"mlp": (_mlp, _toy), "functional": (_functional, _toy), "cnn": (_cnn, _cnn_data)}


def _pair(build, x, opt, batch=16, epochs=2, metrics=("accuracy",), loss="sparse_categorical_crossentropy"):
    """The same Keras model in both packages, compiled and built, the
    port's params set to the JAX package's."""
    out = {}
    for name, k in (("jax", jk), ("port", pk)):
        m = build(k)
        kw = {"device": "cpu"} if name == "port" else {}
        m.compile(optimizer=opt(k), loss=loss, metrics=list(metrics), **kw)
        m._build([x], batch, epochs)
        out[name] = m
    jp = {op: {w: np.asarray(a) for w, a in ws.items()}
          for op, ws in out["jax"].ffmodel.compiled.params.items()}
    load_numpy_params(out["port"].ffmodel, jp)
    return out, jp


def _close_params(got, want, start):
    for op, ws in want.items():
        scale = max(float(np.abs(a).max()) for a in ws.values())
        for w, a in ws.items():
            atol = TOL * scale + UPDATE_TOL * float(np.abs(a - start[op][w]).max())
            np.testing.assert_allclose(got[op][w], a, rtol=TOL, atol=atol, err_msg=f"{op}.{w}")


def _jparams(m):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in m.ffmodel.compiled.params.items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_keras_model_fits_like_jax(name):
    build, data = MODELS[name]
    x, y = data()
    models, start = _pair(build, x, lambda k: k.Adam(learning_rate=0.01))
    hist = {p: m.fit(x, y, epochs=2, batch_size=16) for p, m in models.items()}
    for a, b in zip(hist["port"], hist["jax"]):
        assert (a.train_all, a.train_correct) == (b.train_all, b.train_correct)
        np.testing.assert_allclose(a.sparse_cce_loss, b.sparse_cce_loss, rtol=TOL)
    _close_params(models["port"].ffmodel.numpy_params(), _jparams(models["jax"]), start)
    pred = {p: m.predict(x[:20]) for p, m in models.items()}  # a padded tail batch
    assert pred["port"].shape == (20,) + pred["jax"].shape[1:]
    np.testing.assert_allclose(pred["port"], pred["jax"], rtol=TOL, atol=TOL)
    ev = {p: m.evaluate(x, y, batch_size=16) for p, m in models.items()}
    assert ev["port"].train_correct == ev["jax"].train_correct


def test_callbacks_act_alike():
    """History's logs, the schedule's effect on the params (against the
    same fit without it) and EarlyStopping's stop, in both packages."""
    x, y = _toy()
    sched = lambda e: 0.1 * (0.5 ** e)  # noqa: E731
    models, start = _pair(_mlp, x, lambda k: k.SGD(learning_rate=0.1), epochs=4,
                          metrics=("accuracy", "sparse_categorical_crossentropy"))
    logs, stopped = {}, {}
    for p, m in models.items():
        k = pk if p == "port" else jk
        h = k.History()
        es = k.EarlyStopping(monitor="loss", patience=0, min_delta=10.0)
        m.fit(x, y, epochs=4, batch_size=16, callbacks=[k.LearningRateScheduler(sched), h, es])
        logs[p], stopped[p] = h, (h.epochs, m.stop_training)
    assert stopped["port"] == stopped["jax"] == ([0, 1], True)
    assert set(logs["port"].history) == set(logs["jax"].history)
    for key, vals in logs["jax"].history.items():
        np.testing.assert_allclose(logs["port"].history[key], vals, rtol=TOL, err_msg=key)
    assert models["port"].ffmodel.optimizer.lr == models["jax"].ffmodel.optimizer.lr == 0.05
    got = models["port"].ffmodel.numpy_params()
    _close_params(got, _jparams(models["jax"]), start)
    # the schedule moved the params: a fit at the first rate alone differs
    plain, _ = _pair(_mlp, x, lambda k: k.SGD(learning_rate=0.1), epochs=4)
    load_numpy_params(plain["port"].ffmodel, start)
    plain["port"].fit(x, y, epochs=2, batch_size=16, callbacks=[pk.History()])
    flat = plain["port"].ffmodel.numpy_params()
    assert not np.allclose(flat["fc1"]["kernel"], got["fc1"]["kernel"], rtol=1e-3)


def test_accuracy_gates_and_batch_size_change():
    x, y = _toy()
    models, _ = _pair(_mlp, x, lambda k: k.SGD(learning_rate=0.0))
    for p, m in models.items():
        k = pk if p == "port" else jk
        gate = k.EpochVerifyMetrics(k.ModelAccuracy.DIGITS_MLP)
        with pytest.raises(AssertionError, match="gate"):
            m.fit(x, y, epochs=1, batch_size=16,
                  callbacks=[gate, k.VerifyMetrics(k.ModelAccuracy.DIGITS_MLP)])
        assert not gate.reached
    before = models["port"].ffmodel.numpy_params()
    models["port"].fit(x, y, epochs=1, batch_size=32)  # rebuilt at 32, weights kept
    assert models["port"].ffmodel.config.batch_size == 32
    after = models["port"].ffmodel.numpy_params()
    assert all(np.array_equal(after[o][w], before[o][w]) for o in before for w in before[o])


@pytest.mark.parametrize("loader", ["mnist", "cifar10", "reuters"])
def test_datasets_equal_the_jax_packages(loader, monkeypatch, tmp_path):
    monkeypatch.setenv("FLEXFLOW_DATASETS_DIR", str(tmp_path))  # no cache: seeded samples
    got = getattr(pk.datasets, loader).load_data()
    want = getattr(jk.datasets, loader).load_data()
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if loader == "mnist":  # a cached npz is read instead
        np.savez(tmp_path / "mnist.npz", x_train=got[0][0][:5], y_train=got[0][1][:5],
                 x_test=got[1][0][:3], y_test=got[1][1][:3])
        (xt, yt), (xe, _) = pk.datasets.mnist.load_data()
        assert xt.shape == (5, 28, 28) and xe.shape == (3, 28, 28)
