"""The captured step programs on a card (``runtime/graphs.py``): eager
against replayed training, eval, serving and decode steps, the launch
tally against the profiler's kernel rows and against every graph's own
kernel nodes, two models capturing and replaying at once from two
threads, dropout masks by key, the bf16
``Generator``'s cast cache after replayed updates, and a capture that
fails raising. Marked ``cuda``; every test skips without a card. The file
imports no JAX, so the card's machine runs it with ``--noconftest``."""

import threading

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer, AdamOptimizer
from flexflow_tpu_torch import kernels
from flexflow_tpu_torch.core.op import LowerCtx
from flexflow_tpu_torch.ffconst import CompMode
from flexflow_tpu_torch.models import GPTConfig, build_gpt, build_mlp
from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer
from flexflow_tpu_torch.ops.dropout import drop
from flexflow_tpu_torch.runtime.graphs import (GraphCaptureError, StepGraphs, graph_key,
                                              keep_graphs_for_print)
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

SEQ, HIDDEN, HEADS, LAYERS, BATCH = 64, 64, 4, 2, 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _transformer(dtype: str, opt=None):
    ff = FFModel(FFConfig(batch_size=BATCH, compute_dtype=dtype, seed=3))
    build_transformer(ff, BATCH, TransformerConfig(
        hidden_size=HIDDEN, embedding_size=HIDDEN, num_heads=HEADS, num_layers=LAYERS,
        sequence_length=SEQ))
    ff.compile(opt or SGDOptimizer(lr=0.01, momentum=0.9),
               LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    return ff


def _batch(device, n=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, SEQ, HIDDEN)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.normal(size=(n, SEQ, HIDDEN)).astype(np.float32)).to(device)
    return x, y


def _largest_update_share(after, start, ref):
    """The largest |after - ref| over the layers, each as a share of that
    layer's largest update from ``start`` to ``ref``."""
    worst = 0.0
    for op, ws in ref.items():
        for w, r in ws.items():
            upd = (r - start[op][w]).abs().max().item()
            err = (after[op][w] - r).abs().max().item()
            worst = max(worst, err / max(upd, 1e-30))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,opt", [("float32", "sgd"), ("bfloat16", "sgd"),
                                       ("float32", "adam")])
def test_captured_train_steps_follow_the_eager_steps(card, dtype, opt):
    """Five train steps through the capture cache (one eager, one capture,
    replays) against five eager steps of a twin: losses within 1e-4 in
    f32, params within 1e-3 of each layer's largest update, the same
    launches counted, and the cache's report."""
    make = (lambda: SGDOptimizer(lr=0.01, momentum=0.9)) if opt == "sgd" else \
        (lambda: AdamOptimizer(alpha=1e-3))
    eager, graphed = _transformer(dtype, make()), _transformer(dtype, make())
    ce, cg = eager.compiled, graphed.compiled
    assert cg.capture["captured"] and cg.graphs is not None
    start = {o: {w: t.clone() for w, t in ws.items()} for o, ws in ce.params.items()}
    kernels.reset_launch_counts()
    le = []
    for i in range(5):
        x, y = _batch(card, seed=i)
        ce.params, ce.opt_state, loss, _ = ce.eager["train_step"](
            ce.params, ce.opt_state, i + 1, x, y)
        le.append(loss.item())
    n_eager = kernels.launch_counts()
    kernels.reset_launch_counts()
    version = cg.params_version
    lg = []
    for i in range(5):
        x, y = _batch(card, seed=i)
        cg.params, cg.opt_state, loss, _ = cg.train_step(cg.params, cg.opt_state, i + 1, x, y)
        lg.append(loss.item())
    assert kernels.launch_counts() == n_eager
    assert n_eager["flash_attention_fwd"] == 5 * LAYERS
    stats = cg.graphs.stats()
    assert (stats["eager_calls"], stats["captures"], stats["replays"]) == (1, 1, 4)
    assert stats["graphs"][0]["launches_per_replay"]["flash_attention_bwd_dkv"] == LAYERS
    assert stats["bytes"] > 0
    assert cg.params_version == version + 4
    if dtype == "float32":
        np.testing.assert_allclose(lg, le, rtol=1e-4, atol=1e-6)
        assert _largest_update_share(cg.params, start, ce.params) <= 1e-3
    else:
        # the same bf16 kernels on the same inputs: the steps agree to the
        # bf16 path's own rounding
        np.testing.assert_allclose(lg, le, rtol=2e-2)
        assert _largest_update_share(cg.params, start, ce.params) <= 5e-2


def _replay_rows():
    """One replay of a captured train step under the profiler: the tally's
    flash launches and the profiler's kernel rows, by kernel (run in a
    process of its own by the test below)."""
    from torch.profiler import ProfilerActivity, profile

    ff = _transformer("float32")
    cm = ff.compiled
    x, y = _batch(torch.device("cuda"))
    for i in range(2):
        cm.params, cm.opt_state, _, _ = cm.train_step(cm.params, cm.opt_state, i, x, y)
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cm.params, cm.opt_state, _, _ = cm.train_step(cm.params, cm.opt_state, 9, x, y)
        torch.cuda.synchronize()
    after = kernels.launch_counts()
    stems = {"flash_attention_fwd": "flash_fwd", "flash_attention_bwd_dq": "flash_bwd_dq",
             "flash_attention_bwd_dkv": "flash_bwd_dkv"}
    return {name: (after[name] - before[name],
                   sum(e.count for e in prof.key_averages() if stem in e.key))
            for name, stem in stems.items()}


@pytest.mark.cuda
def test_replay_launch_tally_equals_the_profilers_kernel_rows(card):
    """One replay of a captured train step under the profiler: its flash
    kernel rows equal what the tally adds for the replay. In a process of
    its own: late in a long process (after this run's other card tests)
    the profiler has been seen to drop some of a replayed graph's kernel
    records, never to add any."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]))
    code = ("import json, test_torch_graphs_cuda as t; "
            "print(json.dumps(t._replay_rows()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=here, env=env, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    for name, (tally, seen) in rows.items():
        assert tally == seen == LAYERS, (name, tally, seen)


@pytest.mark.cuda
def test_two_models_capture_and_replay_at_once_from_two_threads(card):
    """Two compiled models (as an engine serves them, a worker thread
    each) reach their captures together and replay side by side: neither
    raises, and the tally holds each model's launches, eager and replayed
    (the backward's from the autograd engine's device thread), with each
    graph's record its own model's. A thread waits for its own stream
    only: synchronizing the whole device is invalid while any stream is
    being captured."""
    models = [_transformer("float32"), _transformer("bfloat16")]
    start = threading.Barrier(len(models))
    errors, steps = [], 6

    def train(ff, seed):
        try:
            cm = ff.compiled
            x, y = _batch(card, seed=seed)
            start.wait(120)
            for i in range(steps):
                cm.params, cm.opt_state, _, _ = cm.train_step(cm.params, cm.opt_state, i + 1,
                                                              x, y)
            torch.cuda.current_stream().synchronize()
        except Exception:  # noqa: BLE001 (reported below)
            import traceback

            errors.append(traceback.format_exc())

    kernels.reset_launch_counts()
    threads = [threading.Thread(target=train, args=(ff, i)) for i, ff in enumerate(models)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errors, errors
    per_step = {"flash_attention_fwd": LAYERS, "flash_attention_bwd_dq": LAYERS,
                "flash_attention_bwd_dkv": LAYERS}
    counts = kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {k: len(models) * steps * n
                                                      for k, n in per_step.items()}
    for ff in models:
        stats = ff.compiled.graphs.stats()
        assert (stats["eager_calls"], stats["captures"], stats["replays"]) == (1, 1, steps - 1)
        assert stats["graphs"][0]["launches_per_replay"] == per_step


def _hold_nodes(graphs):
    """Each graph's kernel nodes (its own DOT print) against the launches
    the tally adds at each of its replays; returns the graphs' kinds."""
    kinds = []
    for g in graphs.kernel_nodes():
        tally = {k: g["launches_per_replay"].get(k, 0) for k in kernels.KERNELS}
        assert {k: g["nodes"][k] for k in kernels.KERNELS} == tally, g
        assert g["nodes"]["nodes"] > 0, g
        kinds.append(g["kind"])
    return kinds


@pytest.mark.cuda
def test_every_graph_kind_holds_its_tally_in_kernel_nodes(card):
    """Read from each graph itself: the train, grad, eval and forward
    graphs of a Transformer, the MoE model's train graph, the dense
    Generator's prefill and decode graphs and the PagedDecoder's prefill,
    decode and verify graphs hold as many K1-K5 kernel nodes as the tally
    adds at each replay (a count that does not go through the wrappers)."""
    from flexflow_tpu_torch.models.moe import MoeConfig, build_moe_mnist
    from flexflow_tpu_torch.serving import Generator
    from flexflow_tpu_torch.serving.generation import PagedDecoder

    keep_graphs_for_print()
    ff = _transformer("float32")
    cm = ff.compiled
    x, y = _batch(card)
    for i in range(2):
        cm.params, cm.opt_state, _, _ = cm.train_step(cm.params, cm.opt_state, i, x, y)
        cm.grad_step(cm.params, i, x, y)
        cm.eval_step(cm.params, x, y)
        cm.forward_fn(cm.params, x)
    kinds = _hold_nodes(cm.graphs)
    assert sorted(kinds) == ["eval_step", "forward_fn", "grad_step", "train_step"]
    train = [g for g in cm.graphs.kernel_nodes() if g["kind"] == "train_step"][0]
    assert train["nodes"]["flash_attention_bwd_dkv"] == LAYERS

    moe = FFModel(FFConfig(batch_size=16, seed=2))
    build_moe_mnist(moe, 16, MoeConfig(input_dim=32, num_classes=4, num_exp=4,
                                       expert_hidden_size=16))
    moe.compile(AdamOptimizer(alpha=1e-3), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    mc = moe.compiled
    rng = np.random.default_rng(1)
    mx = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32)).to(card)
    my = torch.from_numpy(rng.integers(0, 4, size=(16, 1)).astype(np.int32)).to(card)
    for i in range(2):
        mc.params, mc.opt_state, _, _ = mc.train_step(mc.params, mc.opt_state, i, mx, my)
    assert _hold_nodes(mc.graphs) == ["train_step"]
    moe_train = mc.graphs.kernel_nodes()[0]["nodes"]
    assert moe_train["row_gather"] > 0 and moe_train["row_gather_sum"] > 0

    gpt = _gpt(mode=CompMode.INFERENCE, batch=2)
    gen = Generator(gpt, max_length=32)
    prompt = rng.integers(0, 64, size=(2, 5)).astype(np.int32)
    for _ in range(2):
        gen.generate(prompt, 4)
    assert len(_hold_nodes(gen._graphs)) >= 2
    dec = PagedDecoder(gpt, 32, decode_slots=2, block_size=8)
    tabs = np.stack([dec.pool.try_admit(20) for _ in range(2)]).astype(np.int64)
    for _ in range(2):
        dec.prefill_many([prompt[0], prompt[1]], list(tabs))
        dec.decode(np.array([1, 2]), tabs, np.array([5, 5]))
        dec.verify(np.array([[1, 2, 3], [4, 5, 6]]), tabs, np.array([6, 6]))
    assert {"paged.decode", "paged.verify"} <= set(_hold_nodes(dec._graphs))


@pytest.mark.cuda
def test_dropout_masks_are_equal_for_equal_keys_eager_and_replayed(card):
    """A dropout drawn eagerly and inside a replayed graph from the same
    key gives the same mask bit for bit; another key another mask."""
    x = torch.ones((64, 257), device=card)
    graphs = StepGraphs(card, "dropout")

    def fn(key):
        return drop(x, 0.3, LowerCtx(rng=key, seed=11), "drop")

    eager5 = drop(x, 0.3, LowerCtx(rng=5, seed=11), "drop")
    key = graph_key("drop", (5,))
    graphs.run(key, fn, (7,))  # eager
    got7 = graphs.run(key, fn, (7,))  # captured, replayed
    got5 = graphs.run(key, fn, (5,))  # replayed
    assert graphs.stats()["captures"] == 1
    assert torch.equal(got5, eager5)
    assert not torch.equal(got5, got7)
    assert abs((got5 > 0).float().mean().item() - 0.7) < 0.02


@pytest.mark.cuda
def test_eval_serving_and_manual_verbs_replay(card):
    """eval, the classic engine's dispatch, forward and backward replay
    graphs and give the eager functions' answers."""
    from flexflow_tpu_torch.serving import InferenceEngine

    ff = FFModel(FFConfig(batch_size=8, seed=1))
    build_mlp(ff, 8, in_dim=16, hidden_dims=(32,), num_classes=4)
    ff.compile(SGDOptimizer(lr=0.05), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    cm = ff.compiled
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=(32, 1)).astype(np.int32)
    ff.fit(x, y, epochs=2, verbose=False)
    assert ff.fit_profile["graphs"]["replays"] >= 6
    pm = ff.eval(x, y, verbose=False)
    assert pm.train_all == 32
    xt = torch.from_numpy(x[:8]).to(card)
    want = cm.eager["forward_fn"](cm.params, xt)
    for _ in range(3):
        got = cm.forward_fn(cm.params, xt)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ff.set_batch([x[:8]], y[:8])
    g0 = cm.eager["grad_step"](cm.params, 1, *ff._cur_batch)
    for _ in range(3):
        ff.backward()
    for op, ws in g0.items():
        for w, g in ws.items():
            torch.testing.assert_close(ff._cur_grads[op][w], g, rtol=0, atol=0)
    inf = FFModel(FFConfig(batch_size=8, seed=1, computation_mode=CompMode.INFERENCE))
    build_mlp(inf, 8, in_dim=16, hidden_dims=(32,), num_classes=4)
    inf.compile()
    eng = InferenceEngine(batch_timeout_s=0.002)
    eng.register_ffmodel(inf, "m")
    answers = np.stack([f.result(60) for f in [eng.infer_async("m", [r]) for r in x]])
    eng.stop()
    ic = inf.compiled
    ref = ic.eager["forward_fn"](ic.params, torch.from_numpy(x).to(card)).cpu().numpy()
    np.testing.assert_allclose(answers, ref, rtol=1e-6, atol=1e-6)
    assert ic.graphs.stats()["replays"] > 0


def _gpt(dtype="float32", mode=CompMode.TRAINING, batch=2):
    ff = FFModel(FFConfig(batch_size=batch, compute_dtype=dtype, seed=5,
                          computation_mode=mode))
    build_gpt(ff, batch, 16, GPTConfig(vocab_size=64, max_positions=48, hidden_size=32,
                                       num_heads=4, num_layers=2))
    if mode is CompMode.TRAINING:
        ff.compile(SGDOptimizer(lr=0.5), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    else:
        ff.compile()
    return ff


@pytest.mark.cuda
def test_bf16_generator_serves_the_weights_replayed_updates_wrote(card):
    """A bf16 Generator made before a captured fit casts the trained
    weights afterwards (the params version, bumped by every replayed
    update), and its replayed decode gives the eager decoder's tokens."""
    from flexflow_tpu_torch.serving import Generator

    ff = _gpt("bfloat16")
    cm = ff.compiled
    gen = Generator(ff, max_length=32)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 64, size=(2, 5)).astype(np.int32)
    gen.generate(prompt, 8)  # casts and captures before training
    tok = rng.integers(0, 64, size=(8, 17)).astype(np.int32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (8, 16)).copy()
    ff.fit([tok[:, :-1], pos], tok[:, 1:], epochs=2, verbose=False)
    assert ff.fit_profile["graphs"]["replays"] > 0
    cast = gen._exec_params()
    for op, ws in cm.params.items():
        for w, t in ws.items():
            if t.is_floating_point():
                assert torch.equal(cast[op][w], t.to(torch.bfloat16)), (op, w)
    got = gen.generate(prompt, 8)
    again = gen.generate(prompt, 8)
    eager = Generator(ff, max_length=32)
    eager._graphs = None
    want = eager.generate(prompt, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, want)
    assert gen.graph_stats()["replays"] > 0


@pytest.mark.cuda
def test_paged_decoder_replays_give_the_eager_logits(card):
    """Prefill and decode through the PagedDecoder's graphs against the
    same steps run eagerly on a twin decoder."""
    from flexflow_tpu_torch.serving.generation import PagedDecoder

    ff = _gpt(mode=CompMode.INFERENCE, batch=4)
    graphed = PagedDecoder(ff, 32, decode_slots=2, block_size=8)
    eager = PagedDecoder(ff, 32, decode_slots=2, block_size=8)
    eager._graphs = None
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 64, size=7).astype(np.int32)
    outs = []
    for dec in (graphed, eager):
        table = dec.pool.try_admit(20)
        rows = [dec.prefill(prompt, table)]
        tabs = np.zeros((2, dec.max_blocks_per_request), np.int64)
        tabs[0, :len(table)] = table
        tok = int(rows[0].argmax())
        for step in range(6):
            logits = dec.decode(np.array([tok, 0]), tabs, np.array([7 + step, 0]))
            rows.append(logits[0])
            tok = int(logits[0].argmax())
        outs.append(np.stack(rows))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    assert graphed.graph_stats()["replays"] >= 5


@pytest.mark.cuda
def test_a_failed_capture_raises_naming_the_step_and_key(card):
    """A step that reads a value on the host cannot be captured: the
    second call raises, naming the step and its key; nothing falls back.
    Last in the file: a failed capture may leave the process's allocator
    in a state later captures should not inherit."""
    graphs = StepGraphs(card, "probe")
    x = torch.ones(8, device=card)

    def fn(a):
        return a * float(a.sum().item())

    key = graph_key("host_read_step", (x,))
    graphs.run(key, fn, (x,))
    with pytest.raises(GraphCaptureError, match="host_read_step"):
        graphs.run(key, fn, (x,))
