"""Speculative decoding and quantized paged KV on the port.

The cases of ``tests/test_spec_decode.py`` that need no observability,
fault injection or simulator, on a small GPT (vocab 50, 32 positions,
hidden 32, 4 heads, 2 layers) whose random params are drawn as the other
port tests draw them:

* greedy speculative output equals plain output exactly, with a random
  draft (``"gpt:layers=1,..."``) and with a ``"self:1"`` draft, under
  ragged arrivals: the target's verify rows decide every token;
* the spec counts hang together (one verify dispatch a round, k proposals
  a slot-round, every token after the first from a round);
* rejection sampling at temperature replays across two sessions, and its
  tokens and spec counts equal the JAX engine's for the same requests,
  seeds and arrivals;
* a deadline mid-flight and a worker crash keep every future resolving;
* the int8 pool stays quantized within its budget, and the scheduler's
  stats carry its divergence; at equal pool bytes int8 admits at least
  twice the worst-case requests f32 does;
* a missing draft is a loud error, and a draft spec string resolves.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.ffconst import CompMode as JCompMode
from flexflow_tpu.models.gpt import GPTConfig as JGPTConfig
from flexflow_tpu.models.gpt import build_gpt as jbuild_gpt
from flexflow_tpu.serving import InferenceEngine as JInferenceEngine
from flexflow_tpu.serving.generation import build_draft_model as jbuild_draft_model
from flexflow_tpu_torch import CompMode, FFConfig, FFModel, load_numpy_params
from flexflow_tpu_torch.models import GPTConfig, build_gpt
from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler, DeadlineExceeded,
                                        GenerationInstance, InferenceEngine, PagedKVPool,
                                        build_draft_model)
from flexflow_tpu_torch.serving.scheduler import GenerationRequest
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

V = 50
SHAPE = dict(vocab_size=V, max_positions=32, hidden_size=32, num_heads=4, num_layers=2)


def _random_params(ff, seed=0):
    """Unit-scale embeddings, LayerNorm scales near 1, the rest
    variance-preserving, so the logits spread over a few units."""
    rng = np.random.default_rng(seed)
    tree = {}
    for op, ws in ff.compiled.params.items():
        tree[op] = {}
        for w, t in ws.items():
            shape = tuple(t.shape)
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


def _gpt(**cfg_kw):
    ff = FFModel(FFConfig(batch_size=4, seed=0, computation_mode=CompMode.INFERENCE,
                          device="cpu", **cfg_kw))
    build_gpt(ff, 4, 6, GPTConfig(**SHAPE))
    ff.compile()
    load_numpy_params(ff, _random_params(ff))
    return ff


@pytest.fixture(scope="module")
def gpt():
    return _gpt()


@pytest.fixture(scope="module")
def gpt_draft(gpt):
    return build_draft_model(gpt, "self:1")


def _serve(ff, reqs, *, sched_kw=None, temperature=0.0):
    """Submit in waves of 3, joining the wave's first request before the
    next wave, so the in-flight mix churns slots mid-decode."""
    eng = InferenceEngine()
    kw = {"decode_slots": 3, "block_size": 8, "max_length": 32}
    kw.update(sched_kw or {})
    eng.register_generator(ff, name="lm", **kw)
    futs = []
    outs = [None] * len(reqs)
    for i, (prompt, m) in enumerate(reqs):
        futs.append(eng.generate_async("lm", prompt, m, temperature=temperature,
                                       seed=1000 + i))
        if i % 3 == 2:
            outs[i - 2] = futs[i - 2].result(timeout=120)
    for i, f in enumerate(futs):
        if outs[i] is None:
            outs[i] = f.result(timeout=120)
    eng.stop()
    return outs


def test_self_draft_copies_the_targets_weights(gpt, gpt_draft):
    """``self:1``: the target's geometry cut to one block, every weight of a
    shared name equal to the target's; ``gpt:...`` a fresh model at the
    target's vocab and positions."""
    dp = gpt_draft.compiled.params
    assert sorted(dp) == sorted(n for n in gpt.compiled.params if not n.startswith("block1"))
    for name, ws in dp.items():
        for w, t in ws.items():
            assert torch.equal(t, gpt.compiled.params[name][w]), (name, w)
    other = build_draft_model(gpt, "gpt:layers=1,hidden=16,heads=2")
    assert other.compiled.params["wte"]["weight"].shape == (V, 16)
    assert other.compiled.params["wpe"]["weight"].shape == (32, 16)
    with pytest.raises(ValueError, match="1 <= N <= 2"):
        build_draft_model(gpt, "self:3")
    with pytest.raises(ValueError, match="expected 'self:N'"):
        build_draft_model(gpt, "llama:7b")


def test_spec_greedy_identical_with_a_random_draft(gpt):
    """A fresh one-layer random draft proposes badly; the output is the
    plain engine's all the same."""
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, V, (n,)).astype(np.int32), m)
            for n, m in [(3, 6), (5, 2), (2, 7), (4, 4), (2, 5), (6, 3)]]
    draft = build_draft_model(gpt, "gpt:layers=1,hidden=32,heads=4")
    base = _serve(gpt, reqs)
    spec = _serve(gpt, reqs, sched_kw={"draft_ff": draft, "spec_k": 3})
    for b, s in zip(base, spec):
        np.testing.assert_array_equal(b, s)


def test_spec_self_draft_greedy_identical_and_counts(gpt, gpt_draft):
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, V, (n,)).astype(np.int32), m)
            for n, m in [(3, 6), (6, 2), (2, 9), (5, 1), (4, 7)]]
    base = _serve(gpt, reqs)
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=3, block_size=8,
                                        draft_ff=gpt_draft, spec_k=3)
    futs = [sched.submit(p, m, seed=1000 + i) for i, (p, m) in enumerate(reqs)]
    outs = [f.result(timeout=120) for f in futs]
    stats = sched.stats()
    sched.stop()
    for b, s in zip(base, outs):
        np.testing.assert_array_equal(b, s)
    sp = stats["spec"]
    assert sp["k"] == 3 and sp["rounds"] > 0
    # one verify (= decode) dispatch a round
    assert stats["decode_steps"] == stats["decode_dispatches"] == sp["rounds"]
    assert sp["proposed"] == 3 * sp["slot_rounds"]
    # the first token of each request comes from its prefill
    assert sp["emitted"] == sum(m for _, m in reqs) - len(reqs)
    assert 0.0 <= sp["accept_rate"] <= 1.0
    assert 1.0 <= sp["tokens_per_dispatch"] <= 4.0
    assert sp["draft_dispatches"] == 4 * sp["rounds"]
    assert stats["knobs"]["spec_k"] == 3


def test_spec_requires_a_draft_loudly(gpt):
    with pytest.raises(ValueError, match="draft"):
        ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=2, block_size=8,
                                    spec_k=2)


def test_generation_instance_resolves_a_draft_spec_string(gpt):
    inst = GenerationInstance(gpt, decode_slots=2, block_size=8, max_length=32, spec_k=2,
                              draft_ff="self:1")
    try:
        out = np.asarray(inst.generate([7, 3, 11], max_new_tokens=4, temperature=0.0))
        assert out.shape == (7,)
        assert inst.stats()["spec"]["rounds"] > 0
    finally:
        inst.stop()
    # the config knob names the draft when spec_k is on and none is passed
    ff = _gpt(serving_spec_k=2, serving_draft_model="self:1")
    inst = GenerationInstance(ff, decode_slots=2, block_size=8, max_length=32)
    try:
        assert inst.scheduler.draft is not None and inst.scheduler.spec_k == 2
    finally:
        inst.stop()


def test_spec_rejection_sampling_seeded_replay(gpt, gpt_draft):
    """Same seeds and arrival order: the same tokens in two sessions; and
    the sampler really sampled (the greedy run differs somewhere)."""
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, V, (n,)).astype(np.int32), m)
            for n, m in [(3, 6), (4, 4), (2, 8), (5, 3)]]
    kw = {"draft_ff": gpt_draft, "spec_k": 2}
    a = _serve(gpt, reqs, sched_kw=kw, temperature=0.8)
    b = _serve(gpt, reqs, sched_kw=kw, temperature=0.8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    g = _serve(gpt, reqs, sched_kw=kw, temperature=0.0)
    assert any(not np.array_equal(x, y) for x, y in zip(a, g))


@pytest.fixture(scope="module")
def jax_pair(gpt):
    """The JAX GPT of the same shape with the port's params, and its
    ``self:1`` draft."""
    jff = JFFModel(JFFConfig(batch_size=4, seed=0, computation_mode=JCompMode.INFERENCE,
                             ledger="off", audit_programs="off", attribution="off"))
    jbuild_gpt(jff, 4, 6, JGPTConfig(**SHAPE))
    jff.compile(optimizer=None, loss_type=None, metrics=[],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    jff.compiled.params = jax.tree_util.tree_map(jnp.asarray, _random_params(gpt))
    return jff, jbuild_draft_model(jff, "self:1")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_tokens_and_counts_equal_the_jax_engine(gpt, gpt_draft, jax_pair,
                                                     temperature):
    """A ``self:1`` draft, k = 2, greedy and at temperature 0.8: the tokens
    and the spec counts equal the JAX engine's for the same requests, seeds
    and arrivals. At temperature both draw from each request's own stream
    in the same order (the k proposals, then the acceptance and correction
    draws), so a wrong acceptance ratio or residual shows as another token
    or count. The whole burst is queued before the worker looks, so both
    schedulers see the same arrivals."""
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, V, (n,)).astype(np.int32), m)
            for n, m in [(3, 6), (4, 4), (2, 8), (5, 3), (3, 7)]]

    def run(engine, ff, draft):
        inst = engine.register_generator(ff, name="lm", decode_slots=3, block_size=8,
                                         max_length=32, draft_ff=draft, spec_k=2)
        with inst.scheduler._mu:
            futs = [engine.generate_async("lm", p, m, temperature=temperature,
                                          seed=1000 + i)
                    for i, (p, m) in enumerate(reqs)]
        outs = [np.asarray(f.result(timeout=120)) for f in futs]
        spec = inst.stats()["spec"]
        engine.stop()
        return outs, spec

    outs, spec = run(InferenceEngine(), gpt, gpt_draft)
    jouts, jspec = run(JInferenceEngine(), *jax_pair)
    for out, ref in zip(outs, jouts):
        np.testing.assert_array_equal(out, ref)
    keys = ("rounds", "slot_rounds", "proposed", "matched", "emitted")
    assert {k: spec[k] for k in keys} == {k: jspec[k] for k in keys}
    # the draft was rejected somewhere (at temperature: the residual draw
    # was exercised) and accepted somewhere
    assert 0 < spec["matched"] < spec["proposed"]


def test_spec_deadline_mid_flight_rejected_before_next_round(gpt, gpt_draft):
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=2, block_size=8,
                                        draft_ff=gpt_draft, spec_k=2)
    doomed = GenerationRequest(0, np.zeros(3, np.int32), 8, 0.0, 0, None, deadline_s=0.01)
    doomed.table = sched.decoder.pool.try_admit(3 + 8)
    live = GenerationRequest(1, np.ones(3, np.int32), 4, 0.0, 0, None, deadline_s=None)
    live.table = sched.decoder.pool.try_admit(3 + 4)
    sched._prefill_group([(0, doomed), (1, live)])
    time.sleep(0.02)
    before = sched.decoder.pool.in_use()
    sched._decode_once()
    with pytest.raises(DeadlineExceeded, match="mid-decode"):
        doomed.future.result(timeout=5)
    assert sched.decoder.pool.in_use() < before
    with sched._mu:
        assert sched._slots[0] is None
        assert sched._slots[1] is live or live.future.done()
    assert len(live.tokens) > 1
    sched.stop()


def test_spec_crashed_worker_respawns_futures_resolve(gpt, gpt_draft):
    """The worker crashes between spec rounds (its admission step raises
    once, where the reference's fault site fires), respawns, and every
    future resolves to the plain tokens: each commit advanced ``seq_len``
    with its token, so nothing is half-accepted."""
    reqs = [(np.full(3, 7, np.int32), 8), (np.full(4, 9, np.int32), 6),
            (np.full(2, 4, np.int32), 7)]
    base = _serve(gpt, reqs)
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=3, block_size=8,
                                        draft_ff=gpt_draft, spec_k=2, worker_retry_budget=2)
    admit = sched._admit
    calls = [0]

    def crashing(closed):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("decode worker crashed")
        return admit(closed)

    sched._admit = crashing
    futs = [sched.submit(p, m, seed=1000 + i) for i, (p, m) in enumerate(reqs)]
    outs = [f.result(timeout=120) for f in futs]
    sched.stop()
    assert calls[0] > 3
    for out, ref in zip(outs, base):
        np.testing.assert_array_equal(out, ref)


def test_int8_pool_stays_quantized_and_stats_carry_its_divergence(gpt):
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=2, block_size=8,
                                        kv_dtype="int8")
    dec = sched.decoder
    assert dec.kv_dtype == "int8" and dec.kv_quant_report is None
    assert dec.kv_divergence <= dec.kv_divergence_budget == 0.05
    out = sched.submit(np.arange(3, dtype=np.int32), 4).result(timeout=120)
    stats = sched.stats()
    sched.stop()
    assert out.shape == (7,)
    assert stats["kv"]["kv_dtype"] == "int8"
    assert stats["kv"]["quant_fallback"] is False
    assert isinstance(stats["kv"]["divergence"], float)
    assert stats["knobs"]["kv_dtype"] == "int8"


def test_int8_admits_twice_the_requests_at_the_f32_pools_bytes():
    """The largest int8 pool within the f32 pool's bytes admits at least
    twice the worst-case requests."""
    specs = {"a": (4, 8), "b": (4, 8)}
    bs, max_len, n_f32 = 8, 32, 13

    def pool(dtype, nb):
        return PagedKVPool(specs, num_blocks=nb, block_size=bs,
                           max_blocks_per_request=max_len // bs, kv_dtype=dtype,
                           device="cpu")

    budget = pool("float32", n_f32).memory_bytes()
    n_q = n_f32
    while pool("int8", n_q + 1).memory_bytes() <= budget:
        n_q += 1

    def admissible(p):
        n = 0
        while p.try_admit(max_len) is not None:
            n += 1
        return n

    a32, a8 = admissible(pool("float32", n_f32)), admissible(pool("int8", n_q))
    assert a8 >= 2 * a32, (a8, a32, n_f32, n_q)
