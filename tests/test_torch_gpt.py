"""The GPT slice as a whole: the causal LM trained and served by both
packages.

``build_gpt`` is built small in both packages (vocab 128, 64 positions,
hidden 32, 4 heads, 2 layers, seq 32, batch 2). The JAX model is compiled
on one device with the Pallas kernels in the interpreter, so its causal
attention really runs the flash forward and backward kernels; its params
are copied into the port with ``load_numpy_params``. Then five SGD
``train_step``s, one ``fit`` epoch, ``eval`` and the manual verbs must
agree, in float32 and with ``compute_dtype="bfloat16"``; and the port's
dense ``Generator`` must give the JAX ``Generator``'s logits at the prompt
and at every decode step, and its greedy tokens.
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
from flexflow_tpu.ffconst import MetricsType as JMetricsType
from flexflow_tpu.models.gpt import GPTConfig as JGPTConfig
from flexflow_tpu.models.gpt import build_gpt as jbuild_gpt
from flexflow_tpu.runtime.loss import compute_loss as jcompute_loss
from flexflow_tpu.runtime.metrics import compute_batch_metrics as jcompute_batch_metrics
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.serving.generation import Generator as JGenerator
from flexflow_tpu_torch import (DataType, FFConfig, FFModel, LossType, MetricsType,
                                SGDOptimizer, load_numpy_params)
from flexflow_tpu_torch.models import GPTConfig, build_gpt
from flexflow_tpu_torch.runtime.loss import compute_loss
from flexflow_tpu_torch.runtime.metrics import compute_batch_metrics
from flexflow_tpu_torch.serving import Generator
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

BATCH, SEQ = 2, 32
SHAPE = dict(vocab_size=128, max_positions=64, hidden_size=32, num_heads=4, num_layers=2)
METRICS = ("ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY")
# Tolerances, relative to the largest value of the compared tensor, as in
# tests/test_torch_training.py. f32: the same graph in the same precision,
# sums in another order. bf16: both packages round each op's inputs,
# weights and outputs to bf16 and intermediates at other places; a few
# bf16 ulps (2^-8 of a value each) pass through two layers and five
# updates.
F32_TOL = 2e-5
BF16_TOL = 2 ** -5
LR = 0.5  # large enough that five steps move every weight well past f32 noise


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


@functools.lru_cache(maxsize=None)
def _compiled_pair(compute_dtype):
    """(JAX model, port model) compiled for training, once per dtype."""
    jff = JFFModel(JFFConfig(batch_size=BATCH, compute_dtype=compute_dtype, ledger="off",
                             audit_programs="off", attribution="off"))
    jbuild_gpt(jff, BATCH, SEQ, JGPTConfig(**SHAPE))
    jff.compile(optimizer=JSGDOptimizer(lr=LR),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[getattr(JMetricsType, m) for m in METRICS],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    tff = FFModel(FFConfig(batch_size=BATCH, compute_dtype=compute_dtype, device="cpu"))
    build_gpt(tff, BATCH, SEQ, GPTConfig(**SHAPE))
    tff.compile(optimizer=SGDOptimizer(lr=LR),
                loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[getattr(MetricsType, m) for m in METRICS])
    return jff, tff


def _params(jff, seed=0):
    """Random params: unit-scale embeddings, LayerNorm scales near 1, the
    rest variance-preserving, so every layer sees unit-scale activations."""
    rng = np.random.default_rng(seed)
    tree = {}
    for op, ws in jff.compiled.params.items():
        tree[op] = {}
        for w, v in ws.items():
            shape = tuple(v.shape)
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


def _models(compute_dtype):
    """The pair with the same fresh params and optimizer state."""
    jff, tff = _compiled_pair(compute_dtype)
    tree = _params(jff)
    jff.compiled.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    jff.compiled.opt_state = jff.optimizer.init_state(jff.compiled.params)
    load_numpy_params(tff, tree)
    tff.compiled.opt_state = tff.optimizer.init_state(tff.compiled.params)
    return jff, tff


def _data(n, seed=1):
    """Tokens, positions and next-token labels (the tokens shifted by one)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, SHAPE["vocab_size"], (n, SEQ + 1)).astype(np.int32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (n, SEQ)).copy()
    return tok[:, :-1].copy(), pos, tok[:, 1:].copy()


def _tol(compute_dtype):
    return BF16_TOL if compute_dtype else F32_TOL


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _close_params(tff, jff, tol):
    for op, ws in tff.compiled.params.items():
        for w, t in ws.items():
            _close(t.detach().numpy(), jff.compiled.params[op][w], tol, f"{op}.{w}")


DTYPES = pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                                 ids=["float32", "bfloat16"])


def test_gpt_graph_and_weights_match_jax():
    jff, tff = _compiled_pair(None)
    jops = [(op.name, op.op_type.value) for op in jff.compiled.ops]
    assert [(op.name, op.op_type.value) for op in tff.compiled.ops] == jops
    for op, ws in jff.compiled.params.items():
        assert {w: tuple(v.shape) for w, v in ws.items()} == \
            {w: tuple(t.shape) for w, t in tff.compiled.params[op].items()}
    # tp_axis names the same strategies as the JAX builder's (the mesh
    # runs are tests/test_torch_parallel_training.py)
    tff, jff2 = FFModel(FFConfig(device="cpu")), JFFModel(JFFConfig(batch_size=BATCH))
    build_gpt(tff, BATCH, SEQ, GPTConfig(**SHAPE), tp_axis="model")
    jbuild_gpt(jff2, BATCH, SEQ, JGPTConfig(**SHAPE), tp_axis="model")
    # by position: unnamed layers take each package's own name counter
    assert [(l.op_type.value, l.attrs.get("strategy")) for l in tff.layers] == \
        [(l.op_type.value, l.attrs.get("strategy")) for l in jff2.layers]
    assert any(l.attrs.get("strategy") for l in tff.layers)


@DTYPES
def test_full_forward_matches_jax(compute_dtype):
    jff, tff = _models(compute_dtype)
    tok, pos, _ = _data(BATCH, seed=2)
    want = np.asarray(jff.compiled.forward_fn(jff.compiled.params, tok, pos))
    got = tff.compiled.forward_fn(tff.compiled.params, torch.from_numpy(tok),
                                  torch.from_numpy(pos))
    assert got.dtype == torch.float32 and got.shape == (BATCH, SEQ, SHAPE["vocab_size"])
    _close(got.numpy(), want, _tol(compute_dtype), "logits")


@DTYPES
def test_five_train_steps_match_jax(compute_dtype):
    jff, tff = _models(compute_dtype)
    tok, pos, lab = _data(5 * BATCH)
    jcm, tcm = jff.compiled, tff.compiled
    tol = _tol(compute_dtype)
    for i in range(5):
        b = slice(i * BATCH, (i + 1) * BATCH)
        jcm.params, jcm.opt_state, jloss, jbm = jcm.train_step(
            jcm.params, jcm.opt_state, jax.random.key(0), tok[b], pos[b], lab[b])
        tcm.params, tcm.opt_state, tloss, tbm = tcm.train_step(
            tcm.params, tcm.opt_state, i, *(torch.from_numpy(a[b]) for a in (tok, pos, lab)))
        _close(tloss.item(), float(jloss), tol, f"loss at step {i}")
        _close(tbm["sparse_cce_loss"].item(), float(jbm["sparse_cce_loss"]), tol,
               f"sparse CE at step {i}")
        assert int(tbm["count"]) == int(jbm["count"]) == BATCH * SEQ
    _close_params(tff, jff, tol)


@DTYPES
def test_fit_epoch_then_eval_match_jax(compute_dtype):
    jff, tff = _models(compute_dtype)
    tok, pos, lab = _data(4 * BATCH + 1, seed=3)
    want = jff.fit([tok, pos], lab, epochs=1, verbose=False)[0]
    got = tff.fit([tok, pos], lab, epochs=1, verbose=False)[0]
    tol = _tol(compute_dtype)
    assert got.train_all == want.train_all == 4 * BATCH * SEQ
    _close(got.sparse_cce_loss, want.sparse_cce_loss, tol, "fit sparse CE")
    _close_params(tff, jff, tol)
    et, ep, el = _data(2 * BATCH, seed=4)
    we, ge = jff.eval([et, ep], el, verbose=False), tff.eval([et, ep], el, verbose=False)
    _close(ge.sparse_cce_loss, we.sparse_cce_loss, tol, "eval sparse CE")
    if compute_dtype is None:  # bf16 may flip a near-tie of the argmax
        assert ge.train_correct == we.train_correct


@DTYPES
def test_manual_verbs_match_jax(compute_dtype):
    jff, tff = _models(compute_dtype)
    tok, pos, lab = _data(2 * BATCH, seed=5)
    tol = _tol(compute_dtype)
    for i in range(2):
        b = slice(i * BATCH, (i + 1) * BATCH)
        for ff in (jff, tff):
            ff.set_batch([tok[b], pos[b]], lab[b])
            ff.zero_gradients()
        assert all(t.dtype == torch.int32 for t in tff._cur_batch)
        _close(tff.forward().numpy(), jff.forward(), tol, f"forward {i}")
        jff.backward()
        tff.backward()
        jff.update()
        tff.update()
    _close_params(tff, jff, tol)


def test_token_level_loss_and_metrics_match_jax_at_gpt_shape():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(BATCH, SEQ, SHAPE["vocab_size"])).astype(np.float32)
    labels = rng.integers(0, SHAPE["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    ltype, jltype = LossType.SPARSE_CATEGORICAL_CROSSENTROPY, \
        JLossType.SPARSE_CATEGORICAL_CROSSENTROPY
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    _close(compute_loss(ltype, tl, tlab, True).item(),
           float(jcompute_loss(jltype, logits, labels, True)), 1e-6, "loss")
    got = compute_batch_metrics([getattr(MetricsType, m) for m in METRICS], ltype, tl, tlab,
                                True)
    want = jcompute_batch_metrics([getattr(JMetricsType, m) for m in METRICS], jltype,
                                  logits, labels, True)
    assert int(got["count"]) == int(want["count"]) == BATCH * SEQ
    assert int(got["correct"]) == int(want["correct"])
    _close(got["sparse_cce_loss"].item(), float(want["sparse_cce_loss"]), 1e-6, "CE sum")


def test_dropout_training_is_reproducible_by_step_key():
    """A GPT-like stack with dropout: the same step key gives the same loss
    and gradients, another key another mask; eval drops nothing."""
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    tokens = ff.create_tensor((BATCH, SEQ), DataType.INT32, name="tokens")
    h = ff.embedding(tokens, 16, 32, name="wte")
    h = ff.multihead_attention(h, h, h, 32, 4, dropout=0.3, causal=True, name="attn")
    h = ff.dense(ff.dropout(h, 0.3, name="drop"), 16, name="head")
    ff.compile(optimizer=SGDOptimizer(lr=0.1),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    cm = ff.compiled
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(rng.integers(0, 16, (BATCH, SEQ)).astype(np.int32))
    lab = torch.from_numpy(rng.integers(0, 16, (BATCH, SEQ)).astype(np.int32))
    g1, g2, g3 = (cm.grad_step(cm.params, key, tok, lab) for key in (1, 1, 2))
    assert all(torch.equal(g1[op][w], g2[op][w]) for op in g1 for w in g1[op])
    assert not torch.equal(g1["head"]["kernel"], g3["head"]["kernel"])
    e1, e2 = (cm.eval_step(cm.params, tok, lab)[0] for _ in range(2))
    assert torch.equal(e1, e2)
    losses = [h.sparse_cce_loss for h in ff.fit(
        [tok.numpy()], lab.numpy(), epochs=2, shuffle=False, verbose=False)]
    assert ff._rng_counter == 2 and all(np.isfinite(losses))


# ---- generation --------------------------------------------------------------
def _generators(compute_dtype, max_length=48, batch_size=None):
    jff, tff = _models(compute_dtype)
    return (JGenerator(jff, max_length=max_length, batch_size=batch_size),
            Generator(tff, max_length=max_length, batch_size=batch_size), jff, tff)


def test_generator_logits_match_jax_at_prefill_and_every_step():
    """Teacher-forced: the JAX generator's greedy tokens go through both
    generators; prefill logits and every decode step's logits agree within
    F32_TOL of the largest |logit|, and the port's own greedy tokens equal
    the JAX ones wherever the JAX step's top-2 margin exceeds that bound."""
    jgen, tgen, jff, tff = _generators(None)
    prompt = np.random.default_rng(8).integers(0, SHAPE["vocab_size"], (BATCH, 8)) \
        .astype(np.int32)
    new = 12
    jout = jgen.generate(prompt, new)
    jlast, jcache, pos = jgen.prefill(prompt)
    tlast, tcache, tpos = tgen.prefill(prompt)
    assert tpos == pos == 8 and tlast.dtype == torch.float32
    steps = [(np.asarray(jlast), tlast.numpy())]
    jparams, tparams = jff.compiled.params, tgen._exec_params()
    for i in range(new - 1):
        tok = jout[:, 8 + i:9 + i]
        jl, jcache = jgen._step(jparams, jax.numpy.asarray(tok), jcache, jax.numpy.int32(pos))
        tl = tgen._step(tparams, torch.from_numpy(tok), tcache, pos)
        steps.append((np.asarray(jl)[:, -1], tl[:, -1].numpy()))
        pos += 1
    for i, (want, got) in enumerate(steps):
        _close(got, want, F32_TOL, f"logits at step {i}")
    tout = tgen.generate(prompt, new)
    np.testing.assert_array_equal(tout[:, :8], prompt)
    for row in range(BATCH):
        for i, (want, _) in enumerate(steps):
            top2 = np.sort(want[row])[-2:]
            if top2[1] - top2[0] <= F32_TOL * np.abs(want).max():
                break  # a near-tie: the sequences may part from here
            assert tout[row, 8 + i] == jout[row, 8 + i], (row, i)


@DTYPES
def test_generator_logits_match_full_forward(compute_dtype):
    """Prefill then one-token steps give the compiled full causal forward's
    logits at every position (the reference's own invariant)."""
    _, tgen, _, tff = _generators(compute_dtype)
    tok, pos, _ = _data(BATCH, seed=9)
    full = tff.compiled.forward_fn(tff.compiled.params, torch.from_numpy(tok),
                                   torch.from_numpy(pos)).numpy()
    last, cache, p = tgen.prefill(tok[:, :10])
    got = [last.numpy()]
    for t in range(10, SEQ):
        got.append(tgen._step(tgen._exec_params(), torch.from_numpy(tok[:, t:t + 1]),
                              cache, t)[:, -1].numpy())
    _close(np.stack(got, 1), full[:, 9:], _tol(compute_dtype), "cached vs full logits")


def test_sampled_generation_with_per_row_seeds_matches_jax():
    jgen, tgen, _, _ = _generators(None, batch_size=4)
    prompts = np.random.default_rng(10).integers(0, SHAPE["vocab_size"], (2, 4)) \
        .astype(np.int32)
    a = tgen.generate(prompts, 6, temperature=0.8, seed=[11, 22])
    np.testing.assert_array_equal(a, jgen.generate(prompts, 6, temperature=0.8,
                                                   seed=[11, 22]))
    # each row its own stream: swapping rows swaps outputs
    b = tgen.generate(prompts[::-1].copy(), 6, temperature=0.8, seed=[22, 11])
    np.testing.assert_array_equal(a, b[::-1])
    np.testing.assert_array_equal(
        tgen.generate(prompts, 6, temperature=0.8, seed=5),
        jgen.generate(prompts, 6, temperature=0.8, seed=5))
    with pytest.raises(ValueError, match="per-row seeds"):
        tgen.generate(prompts, 6, seed=[1, 2, 3])


def test_partial_batch_and_eos():
    _, wide, _, tff = _generators(None, batch_size=4)
    narrow = Generator(tff, max_length=48, batch_size=2)
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, SHAPE["vocab_size"], (2, 4)).astype(np.int32)
    out = wide.generate(prompt, 5)
    assert out.shape == (2, 9)
    np.testing.assert_array_equal(out, narrow.generate(prompt, 5))
    with pytest.raises(ValueError, match="compiled batch width"):
        wide.generate(rng.integers(0, 8, (5, 4)).astype(np.int32), 2)
    one = prompt[:1]
    eos = int(wide.generate(one, 4)[0, 4])  # the first token drawn
    stopped = wide.generate(one, 4, eos_id=eos)
    assert stopped.shape == (1, 5) and stopped[0, -1] == eos


def test_generator_raises_as_the_reference_does():
    _, tgen, _, tff = _generators(None)
    prompt = np.zeros((BATCH, 4), np.int32)
    with pytest.raises(ValueError, match="needs the cache"):
        tgen.prefill(prompt, offset=4)
    _, cache, end = tgen.prefill(prompt)
    with pytest.raises(ValueError, match="offset=0 would overwrite"):
        tgen.prefill(prompt, cache=cache)
    tgen.prefill(prompt, cache=cache, offset=end)  # continuing is fine
    with pytest.raises(ValueError, match="exceeds max_length"):
        tgen.prefill(np.zeros((BATCH, 46), np.int32), cache=cache, offset=end)
    with pytest.raises(ValueError, match="max_length"):
        tgen.generate(prompt, 45)
    with pytest.raises(ValueError, match="position embedding capacity 64"):
        Generator(tff, max_length=65)
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    tokens = ff.create_tensor((BATCH, SEQ), DataType.INT32, name="tokens")
    positions = ff.create_tensor((BATCH, SEQ), DataType.INT32, name="positions")
    h = ff.add(ff.embedding(tokens, 16, 8), ff.embedding(positions, 64, 8))
    ff.dense(ff.multihead_attention(h, h, h, 8, 2, causal=False, name="attn"), 16)
    ff.compile()
    with pytest.raises(ValueError, match="causal SELF-attention"):
        Generator(ff, max_length=16)


def test_bf16_exec_params_cast_once_and_follow_updates():
    """The bf16 cast is made once per params version: reused while the
    params stand, re-derived after an optimizer step (in place), after
    load_numpy_params (in place) and after replacing a weight."""
    jgen, tgen, jff, tff = _generators("bfloat16")
    cast = tgen._exec_params()
    assert tgen._exec_params() is cast
    assert cast["lm_head"]["kernel"].dtype == torch.bfloat16
    prompt = np.random.default_rng(13).integers(0, SHAPE["vocab_size"], (BATCH, 6)) \
        .astype(np.int32)
    tlast = tgen.prefill(prompt)[0]
    _close(tlast.numpy(), np.asarray(jgen.prefill(prompt)[0]), BF16_TOL, "bf16 prefill")
    tok, pos, lab = _data(BATCH, seed=14)
    cm = tff.compiled
    cm.params, cm.opt_state, _, _ = cm.train_step(
        cm.params, cm.opt_state, 0, *(torch.from_numpy(a) for a in (tok, pos, lab)))
    after_step = tgen._exec_params()
    assert after_step is not cast
    torch.testing.assert_close(after_step["lm_head"]["kernel"],
                               cm.params["lm_head"]["kernel"].to(torch.bfloat16))
    load_numpy_params(tff, _params(jff, seed=1))
    assert tgen._exec_params() is not after_step
    reloaded = tgen._exec_params()
    cm.params["lm_head"]["kernel"] = -cm.params["lm_head"]["kernel"]
    assert tgen._exec_params() is not reloaded
    assert not torch.equal(tgen.prefill(prompt)[0], tlast)
