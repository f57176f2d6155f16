"""Sequence buckets and masked padding: the port against the JAX package.

* Every function of ``runtime/buckets.py`` gives the JAX copy's answer, on
  seeded and on hypothesis inputs, error codes included (held exactly: the
  module is pure numpy in both).
* Under masking a padded position's loss term is an exact zero, so the
  embedding rows only padding reads get exactly zero gradients.
* A bucketed ``fit`` of a tiny GPT stays within ``F32_TOL`` of its
  pad-to-max run (the same plan, every width padded to the ladder top:
  only the sums' lengths differ, by exact zeros) and of the JAX package's
  bucketed ``fit`` (SGD, the Pallas kernels in the interpreter), with
  every step's loss and the epoch's metrics.
* Each misconfiguration raises its coded error at fit entry; an unseen
  bucket in ``eval`` is counted; BatchMatmul's truncation and
  ``forward(seq_length)`` equal the JAX package's; with buckets off the
  loss path is untouched (a label past the vocab still gives NaN, C8).
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.ffconst import MetricsType as JMetricsType
from flexflow_tpu.models.gpt import GPTConfig as JGPTConfig
from flexflow_tpu.models.gpt import build_gpt as jbuild_gpt
from flexflow_tpu.runtime import buckets as jb
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import (ActiMode, DataType, FFConfig, FFModel, LossType,
                                MetricsType, SGDOptimizer, load_numpy_params)
from flexflow_tpu_torch.models import GPTConfig, build_gpt
from flexflow_tpu_torch.obs.metrics import metrics_registry
from flexflow_tpu_torch.runtime import buckets as tb
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

V, S, BATCH = 64, 32, 4
SHAPE = dict(vocab_size=V, max_positions=S, hidden_size=32, num_heads=4, num_layers=2)
METRICS = ("ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY")
# f32, relative to the largest value compared: the same graph in the same
# precision with sums of another length or order; a few f32 ulps of the
# params' scale after the epoch's updates (tests/test_torch_gpt.py)
F32_TOL = 2e-5
LR = 0.5
BUDGET = 64


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


@pytest.fixture(autouse=True)
def _jax_init(monkeypatch):
    """The JAX package draws each weight with its own jitted program; its
    compile here takes zeros instead (every test overwrites the params)."""
    from flexflow_tpu.runtime import compiler as jcompiler

    def init_params(ops, mesh, seed, dtype_override=None):
        params, shardings, wd_mask = {}, {}, {}
        for op in ops:
            for ws in op.weight_specs():
                params.setdefault(op.name, {})[ws.name] = jax.numpy.zeros(
                    ws.shape, dtype_override or ws.dtype.to_jnp())
                shardings.setdefault(op.name, {})[ws.name] = jcompiler._named_sharding(
                    mesh, op.weight_shapes[ws.name])
                wd_mask.setdefault(op.name, {})[ws.name] = ws.weight_decay
        return params, shardings, wd_mask

    monkeypatch.setattr(jcompiler, "init_params", init_params)


# ------------------------------------------------------------ pure planning
def _same(fn, *args):
    """Both modules' answer, or both errors' codes."""
    out = []
    for mod in (jb, tb):
        try:
            r = getattr(mod, fn)(*args)
            out.append(("ok", r.tolist() if isinstance(r, np.ndarray) else r))
        except mod.DynamicShapeError as e:
            out.append(("err", e.code, str(e)))
    assert out[0] == out[1], (fn, args, out)
    return out[1]


@pytest.mark.parametrize("spec,lo,hi", [
    ("pow2", 8, 48), ("pow2", 8, 32), ("pow2", 1, 1), ("pow2", 5, 1024), ("16,4,64", 1, 48),
    ("32", 8, 16), ("banana", 8, 32), ("pow2", 8, 0), ("0,4", 1, 8), ("", 1, 8)])
def test_resolve_ladder_equals_jax(spec, lo, hi):
    _same("resolve_ladder", spec, lo, hi)


@pytest.mark.parametrize("length", [0, 1, 8, 9, 16, 17, 32, 33])
def test_bucket_for_equals_jax(length):
    _same("bucket_for", (8, 16, 32), length)


def _labels(rng, n, s):
    lab = rng.integers(0, V, size=(n, s)).astype(np.int32)
    for i, l in enumerate(rng.integers(0, s + 1, size=n)):
        lab[i, l:] = -1
    return lab


def test_row_lengths_equals_jax_and_flags_interior_padding():
    rng = np.random.default_rng(0)
    lab = _labels(rng, 16, 12)
    assert _same("row_lengths", lab)[0] == "ok"
    lab[3, 2] = -1
    lab[3, 5] = 7
    assert _same("row_lengths", lab)[1] == "DYN002"
    assert _same("row_lengths", np.zeros((2, 3, 4)))[1] == "DYN003"


def _plans(lengths, **spec):
    plans = [mod.build_epoch_plan(lengths, mod.PackingSpec(**spec)) for mod in (jb, tb)]
    as_tuples = [[(g.rows, g.pad_rows, g.width, g.valid_tokens, g.total_tokens) for g in p]
                 for p in plans]
    assert as_tuples[0] == as_tuples[1]
    assert jb.plan_token_stats(plans[0]) == tb.plan_token_stats(plans[1])
    return plans[1]


@pytest.mark.parametrize("budget,quantum,pad_max", [
    (0, 1, False), (64, 1, False), (64, 1, True), (128, 2, False), (1000, 4, True)])
def test_build_epoch_plan_equals_jax_seeded(budget, quantum, pad_max):
    rng = np.random.default_rng(budget + quantum)
    lengths = rng.integers(1, 33, size=50)
    plan = _plans(lengths, ladder=(8, 16, 32), token_budget=budget, batch_size=4,
                  quantum=quantum, pad_max=pad_max)
    assert sum(g.rows for g in plan) == (50 if budget else 48)


@settings(max_examples=60, deadline=None)
@given(lengths=st.lists(st.integers(1, 64), min_size=1, max_size=40),
       budget=st.sampled_from([0, 64, 96, 200, 512]),
       quantum=st.sampled_from([1, 2, 4]), pad_max=st.booleans(),
       lo=st.sampled_from([1, 4, 8]))
def test_planning_equals_jax_hypothesis(lengths, budget, quantum, pad_max, lo):
    ladder = _same("resolve_ladder", "pow2", lo, 64)[1]
    spec = dict(ladder=tuple(ladder), token_budget=budget, batch_size=3, quantum=quantum,
                pad_max=pad_max)
    for w in ladder:
        assert (jb.PackingSpec(**spec).row_cap(w) == tb.PackingSpec(**spec).row_cap(w))
        for rows in (1, 3, 7, 30):
            assert (jb.PackingSpec(**spec).quantize_rows(rows, w)
                    == tb.PackingSpec(**spec).quantize_rows(rows, w))
    outs = []
    for mod in (jb, tb):
        try:
            plan = mod.build_epoch_plan(np.asarray(lengths), mod.PackingSpec(**spec))
            outs.append([(g.rows, g.pad_rows, g.width, g.valid_tokens) for g in plan])
        except mod.DynamicShapeError as e:
            outs.append(e.code)
    assert outs[0] == outs[1]


# ------------------------------------------------------------ the GPT models
def _data(n, seed=0, lo=3):
    """Tokens in [1, V) up to each row's length, 0 past it; positions;
    next-token labels, -1 past the length."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, V, size=(n, S + 1)).astype(np.int32)
    x, y = tok[:, :-1].copy(), tok[:, 1:].copy()
    for i, l in enumerate(rng.integers(lo, S + 1, size=n)):
        x[i, l:] = 0
        y[i, l:] = -1
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (n, S)).copy()
    return x, pos, y


def _port(**cfg):
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu", **cfg))
    build_gpt(ff, BATCH, S, GPTConfig(**SHAPE))
    ff.compile(SGDOptimizer(lr=LR), LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [getattr(MetricsType, m) for m in METRICS])
    return ff


@functools.lru_cache(maxsize=None)
def _jax_bucketed():
    jff = JFFModel(JFFConfig(batch_size=BATCH, seq_buckets="pow2", token_budget=BUDGET,
                             ledger="off", audit_programs="off", attribution="off"))
    jbuild_gpt(jff, BATCH, S, JGPTConfig(**SHAPE))
    jff.compile(optimizer=JSGDOptimizer(lr=LR),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[getattr(JMetricsType, m) for m in METRICS],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    return jff


def _params(seed=0):
    """Unit-scale embeddings, LayerNorm scales near 1, the rest
    variance-preserving (tests/test_torch_gpt.py's draw)."""
    shapes = {op: {w: tuple(t.shape) for w, t in ws.items()}
              for op, ws in _port().compiled.params.items()}
    rng = np.random.default_rng(seed)
    tree = {}
    for op, ws in shapes.items():
        tree[op] = {}
        for w, shape in ws.items():
            if op in ("wte", "wpe"):
                a = rng.normal(size=shape)
            elif w == "scale":
                a = 1.0 + 0.1 * rng.normal(size=shape)
            elif len(shape) == 1 or w.startswith("b"):
                a = 0.1 * rng.normal(size=shape)
            else:
                fan_in = shape[0] if w in ("wq", "wk", "wv") else int(np.prod(shape[:-1]))
                a = rng.normal(size=shape) / np.sqrt(fan_in)
            tree[op][w] = a.astype(np.float32)
    return tree


def _numpy(ff):
    return {op: {w: t.detach().numpy().copy() for w, t in ws.items()}
            for op, ws in ff.compiled.params.items()}


def _close(got, want, tol):
    for op in want:
        for w in want[op]:
            a, b = np.asarray(got[op][w]), np.asarray(want[op][w])
            scale = max(float(np.abs(b).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= tol * scale, (op, w)


def _losses_per_step(ff, x, pos, y, epochs=1):
    """fit, recording each step's loss through the compiled train_step."""
    cm = ff.compiled
    losses = []
    step = cm.train_step

    def recording(*args, **kw):
        out = step(*args, **kw)
        losses.append(float(out[2]))
        return out

    cm.train_step = recording
    hist = ff.fit([x, pos], y, epochs=epochs, verbose=False)
    cm.train_step = step
    return losses, hist


def test_padded_positions_get_exactly_zero_gradients():
    x, pos, y = _data(BATCH, seed=5, lo=4)
    x[:, -4:] = 0  # every row ends before the last 4 positions
    y[:, -4:] = -1
    tree = _params()
    grads = {}
    for mode in ("pow2", "off"):
        ff = _port(seq_buckets=mode)
        load_numpy_params(ff, tree)
        grads[mode] = ff.compiled.grad_step(ff.compiled.params, 1, *(
            torch.from_numpy(a) for a in (x, pos, y)))
    masked = grads["pow2"]
    # token 0 and the last positions appear only at padded positions
    assert torch.count_nonzero(masked["wte"]["weight"][0]) == 0
    assert torch.count_nonzero(masked["wpe"]["weight"][S - 4:]) == 0
    assert torch.count_nonzero(masked["wte"]["weight"][1:]) > 0
    # unmasked, the -1 labels wrap to the last class and train the padding
    assert torch.count_nonzero(grads["off"]["wte"]["weight"][0]) > 0


@pytest.fixture(scope="module")
def bucketed_runs():
    x, pos, y = _data(12)
    tree = _params()
    runs = {}
    for pad_max in ("off", "on"):
        ff = _port(seq_buckets="pow2", token_budget=BUDGET, seq_bucket_pad_max=pad_max)
        load_numpy_params(ff, tree)
        runs[pad_max] = (ff, *_losses_per_step(ff, x, pos, y))
    return (x, pos, y), tree, runs


def test_bucketed_fit_within_bound_of_pad_max(bucketed_runs):
    _, _, runs = bucketed_runs
    b, p = runs["off"], runs["on"]
    np.testing.assert_allclose(b[1], p[1], rtol=F32_TOL, atol=0)
    _close(_numpy(b[0]), _numpy(p[0]), F32_TOL)
    assert (b[2][0].train_all, b[2][0].train_correct) == (p[2][0].train_all,
                                                          p[2][0].train_correct)
    assert b[2][0].train_all == int((bucketed_runs[0][2] >= 0).sum())
    bb, pb = b[0].fit_profile["buckets"], p[0].fit_profile["buckets"]
    assert bb["ladder"] == [8, 16, 32] and bb["token_budget"] == BUDGET
    assert bb["padded_token_fraction"] < pb["padded_token_fraction"]
    assert bb["new_compiles"] == bb["known_shapes"] > pb["new_compiles"] >= 1


def test_bucketed_fit_matches_jax(bucketed_runs):
    (x, pos, y), tree, runs = bucketed_runs
    jff = _jax_bucketed()
    jff.compiled.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    jff.compiled.opt_state = jff.optimizer.init_state(jff.compiled.params)
    (jhist,) = jff.fit([x, pos], y, epochs=1, verbose=False)
    ff, losses, (hist,) = runs["off"]
    jp = {op: {w: np.asarray(v) for w, v in ws.items()}
          for op, ws in jff.compiled.params.items()}
    _close(_numpy(ff), jp, F32_TOL)
    assert (hist.train_all, hist.train_correct) == (jhist.train_all, jhist.train_correct)
    assert hist.sparse_cce_loss == pytest.approx(jhist.sparse_cce_loss, rel=F32_TOL)
    assert ff.fit_profile["buckets"]["padded_token_fraction"] == pytest.approx(
        jff.fit_profile["buckets"]["padded_token_fraction"], abs=0)
    assert (ff.fit_profile["buckets"]["new_compiles"]
            == jff.fit_profile["buckets"]["new_compiles"])


def test_unseen_bucket_in_eval_is_counted(bucketed_runs):
    (x, pos, y), _, runs = bucketed_runs
    ff = runs["off"][0]
    before = metrics_registry().counter("eval.bucket_compiles").value
    ff.eval([x, pos], y, verbose=False)
    first = ff.eval_profile["buckets"]["new_compiles"]
    assert first >= 1
    ff.eval([x, pos], y, verbose=False)
    assert ff.eval_profile["buckets"]["new_compiles"] == 0
    short = y.copy()
    short[:, 5:] = -1  # every row fits the 8 bucket now
    ff.eval([x, pos], short, verbose=False)
    assert ff.eval_profile["buckets"]["new_compiles"] >= 1
    assert metrics_registry().counter("eval.bucket_compiles").value >= before + first + 1


@pytest.mark.parametrize("cfg,code", [
    (dict(seq_buckets="pow2", seq_bucket_pad_max="yes"), "DYN003"),
    (dict(token_budget=64), "DYN003"),
    (dict(seq_buckets="banana"), "DYN003"),
    (dict(seq_buckets="pow2", token_budget=16), "DYN004"),
    (dict(seq_buckets="pow2", interior=True), "DYN002"),
    (dict(seq_buckets="pow2", mse=True), "DYN003")])
def test_misconfiguration_raises_at_fit_entry(cfg, code):
    cfg = dict(cfg)
    interior, mse = cfg.pop("interior", False), cfg.pop("mse", False)
    if mse:
        ff = FFModel(FFConfig(batch_size=BATCH, device="cpu", **cfg))
        t = ff.create_tensor((BATCH, S), name="x")
        ff.dense(t, S, ActiMode.NONE, name="head")
        ff.compile(SGDOptimizer(lr=LR), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        args = (np.zeros((8, S), np.float32), np.zeros((8, S), np.float32))
    else:
        ff = _port(**cfg)
        x, pos, y = _data(8)
        if interior:
            y[2, 1] = -1
        args = ([x, pos], y)
    with pytest.raises(tb.DynamicShapeError) as e:
        ff.fit(*args, verbose=False)
    assert e.value.code == code
    assert ff.compiled.iteration == 0


def test_bucket_compiles_counter_counts_each_new_shape():
    x, pos, y = _data(16, seed=2)
    ff = _port(seq_buckets="pow2")
    before = metrics_registry().counter("fit.bucket_compiles").value
    ff.fit([x, pos], y, epochs=2, verbose=False)
    n = ff.fit_profile["buckets"]["new_compiles"]
    assert n == len({s for s in ff.compiled._seen_shapes if s[0] == "train"}) >= 1
    assert metrics_registry().counter("fit.bucket_compiles").value == before + n


# ------------------------------------------------------ truncation and C8
@pytest.mark.parametrize("sl", [-1, 3, 5])
def test_batch_matmul_truncation_and_forward_seq_length_match_jax(sl):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 6, 4)).astype(np.float32)
    b = rng.normal(size=(2, 4, 6)).astype(np.float32)
    outs = []
    for Model, Cfg, kw in ((JFFModel, JFFConfig, dict(ledger="off", audit_programs="off",
                                                      attribution="off")),
                           (FFModel, FFConfig, dict(device="cpu"))):
        ff = Model(Cfg(batch_size=2, **kw))
        ta = ff.create_tensor((2, 6, 4), name="a")
        tb_ = ff.create_tensor((2, 4, 6), name="b")
        ff.batch_matmul(ta, tb_, a_seq_length_dim=1, b_seq_length_dim=2, name="bmm")
        if Model is JFFModel:
            ff.compile(mesh=make_mesh({"data": 1}, jax.devices()[:1]))
        else:
            ff.compile()
        ff.set_batch([a, b])
        outs.append(np.asarray(ff.forward(seq_length=sl)))
        ff.iter_config.seq_length = sl
        outs.append(np.asarray(ff.forward()))
    want = a[:, :sl] @ b[:, :, :sl] if sl > 0 else a @ b
    for o in outs:
        np.testing.assert_allclose(o, want, rtol=1e-6, atol=1e-6)
        assert o.shape == want.shape


def test_buckets_off_keeps_the_unmasked_path():
    """With seq_buckets off a -1 label wraps to the last class and a label
    past the vocab gives NaN, in both packages (C8); on, -1 is masked."""
    from flexflow_tpu.runtime.loss import compute_loss as jcompute_loss
    from flexflow_tpu_torch.runtime.loss import compute_loss

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 5, V)).astype(np.float32)
    lab = rng.integers(0, V, size=(2, 5)).astype(np.int32)
    lab[0, 3:] = -1
    sparse = LossType.SPARSE_CATEGORICAL_CROSSENTROPY
    jsparse = JLossType.SPARSE_CATEGORICAL_CROSSENTROPY
    for mask in (False, True):
        got = float(compute_loss(sparse, torch.from_numpy(logits), torch.from_numpy(lab),
                                 True, mask))
        want = float(jcompute_loss(jsparse, logits, lab, True, mask))
        assert got == pytest.approx(want, rel=1e-6)
    off = float(compute_loss(sparse, torch.from_numpy(logits), torch.from_numpy(lab), True))
    on = float(compute_loss(sparse, torch.from_numpy(logits), torch.from_numpy(lab), True,
                            True))
    assert off != on
    lab[1, 0] = V + 3
    for mask in (False, True):
        assert np.isnan(float(compute_loss(sparse, torch.from_numpy(logits),
                                           torch.from_numpy(lab), True, mask)))
        assert np.isnan(float(jcompute_loss(jsparse, logits, lab, True, mask)))


@pytest.mark.parametrize("rows,width", [(1, 1), (3, 5), (4, 8), (2, 16), (7, 31), (16, 32)])
def test_gpt_runs_at_any_width_and_row_count(rows, width):
    """No op on GPT's path reads its built sizes: the forward and the
    gradient at (rows, width) equal the built (4, 32) graph's on the same
    rows padded (causal attention keeps the padding out of the valid
    positions), within F32_TOL of the largest value; a gradient against
    the largest of its layer (the key bias's exact gradient is 0, the
    softmax cancels it, so it is rounding noise in both runs)."""
    ff = _port(seq_buckets="pow2")
    load_numpy_params(ff, _params())
    cm = ff.compiled
    x, pos, y = _data(max(rows, BATCH), seed=9, lo=S)
    part = [torch.from_numpy(a[:rows, :width].copy()) for a in (x, pos, y)]
    full = [torch.from_numpy(a[:rows].copy()) for a in (x, pos, y)]
    full[2][:, width:] = -1
    got = cm.forward_fn(cm.params, *part[:2])
    want = cm.forward_fn(cm.params, *full[:2])[:, :width]
    assert got.shape == (rows, width, V)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL * want.abs().max().item())
    g_part = cm.grad_step(cm.params, 1, *part)
    g_full = cm.grad_step(cm.params, 1, *full)
    for op in g_full:
        scale = max(max(g.abs().max().item() for g in g_full[op].values()), 1e-30)
        for w in g_full[op]:
            assert (g_part[op][w] - g_full[op][w]).abs().max().item() <= F32_TOL * scale, (op, w)
