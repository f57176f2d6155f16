"""Continuous batching over the paged KV pool, against the JAX engine.

The cases of ``tests/test_continuous_batching.py`` that need no
observability, fault injection or program audit, on the port: a small GPT
(vocab 50, 32 positions, hidden 32, 4 heads, 2 layers) built in both
packages with the same random params, served through
``InferenceEngine.register_generator`` and ``ContinuousBatchingScheduler``.

* Tokens: the engine's, under ragged arrivals that churn slots mid-decode,
  equal each request decoded alone by the port's dense ``Generator`` with
  its own seed, and the JAX engine's for the same requests and seeds,
  greedy and at temperature 0.8. Each request samples from its own
  seeded stream, so equal logits give equal tokens; the layouts' logits
  differ by ~1e-7, far inside every argmax margin and sampling interval
  these seeds meet.
* One decode dispatch a step, EOS retirement, token-budget prefill
  grouping, a burst shed with the pool as the binding constraint, deadlines
  in the queue and mid-flight, the failure breaker, and worker respawn and
  its budget. The reference
  triggers a worker crash through its ``serving.worker`` fault site; the
  port has no fault sites yet, so these tests patch the scheduler's
  admission step (which runs where that site fires) or the decoder.
"""

import functools
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh
from flexflow_tpu.ffconst import CompMode as JCompMode
from flexflow_tpu.models.gpt import GPTConfig as JGPTConfig
from flexflow_tpu.models.gpt import build_gpt as jbuild_gpt
from flexflow_tpu.runtime.retry import RetryPolicy as JRetryPolicy
from flexflow_tpu.serving import InferenceEngine as JInferenceEngine
from flexflow_tpu_torch import CompMode, FFConfig, FFModel, load_numpy_params
from flexflow_tpu_torch.models import GPTConfig, build_gpt
from flexflow_tpu_torch.runtime.retry import RetryPolicy
from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler, DeadlineExceeded,
                                        Generator, InferenceEngine, ShedError)
from flexflow_tpu_torch.serving.scheduler import GenerationRequest
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

V = 50
SHAPE = dict(vocab_size=V, max_positions=32, hidden_size=32, num_heads=4, num_layers=2)


def _params(jff, seed=0):
    """Random params: unit-scale embeddings, LayerNorm scales near 1, the
    rest variance-preserving, so the logits spread over a few units."""
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


def _gpt(**cfg_kw):
    ff = FFModel(FFConfig(batch_size=4, seed=0, computation_mode=CompMode.INFERENCE,
                          device="cpu", **cfg_kw))
    build_gpt(ff, 4, 6, GPTConfig(**SHAPE))
    ff.compile()
    return ff


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX GPT, port GPT) compiled for inference with the same params."""
    jff = JFFModel(JFFConfig(batch_size=4, seed=0, computation_mode=JCompMode.INFERENCE,
                             ledger="off", audit_programs="off", attribution="off"))
    jbuild_gpt(jff, 4, 6, JGPTConfig(**SHAPE))
    jff.compile(optimizer=None, loss_type=None, metrics=[],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    tree = _params(jff)
    jff.compiled.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tff = _gpt()
    load_numpy_params(tff, tree)
    return jff, tff


@pytest.fixture(scope="module")
def gpt():
    return _pair()[1]


def _reference_rows(ff, reqs, temperature):
    """Each request decoded alone through the dense Generator with its own
    seed."""
    gen = Generator(ff, max_length=32)
    return [gen.generate(p[None, :], m, temperature=temperature, seed=[1000 + i])[0]
            for i, (p, m) in enumerate(reqs)]


def _engine_run(engine, ff, reqs, temperature):
    engine.register_generator(ff, name="lm", decode_slots=3, block_size=8, max_length=32)
    futs = []
    for i, (prompt, m) in enumerate(reqs):
        futs.append(engine.generate_async("lm", prompt, m, temperature=temperature,
                                          seed=1000 + i))
        if i % 3 == 2:
            time.sleep(0.002)  # ragged arrival
    outs = [f.result(timeout=120) for f in futs]
    engine.stop()
    return outs


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_tokens_equal_sequential_dense_and_the_jax_engine(temperature):
    jff, tff = _pair()
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, V, (n,)).astype(np.int32), m)
            for n, m in [(3, 6), (6, 2), (2, 9), (5, 1), (4, 7), (2, 3), (3, 5), (6, 4)]]
    outs = _engine_run(InferenceEngine(), tff, reqs, temperature)
    for out, ref in zip(outs, _reference_rows(tff, reqs, temperature)):
        np.testing.assert_array_equal(out, ref)
    for out, ref in zip(outs, _engine_run(JInferenceEngine(), jff, reqs, temperature)):
        np.testing.assert_array_equal(out, np.asarray(ref))


def test_eos_retires_early(gpt):
    """An EOS sample retires the request as the dense generator's EOS stop
    does."""
    prompt = np.random.default_rng(3).integers(0, V, (4,)).astype(np.int32)
    ref = Generator(gpt, max_length=32).generate(prompt[None, :], 6)[0]
    eos = int(ref[prompt.size])
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=2, block_size=8)
    out = sched.generate(prompt, 6, eos_id=eos)
    sched.stop()
    assert out.tolist() == list(prompt) + [eos]


def test_one_dispatch_per_step_regardless_of_mix(gpt):
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=4, block_size=8,
                                        max_prefills_per_step=4)
    rng = np.random.default_rng(5)
    futs = [sched.submit(rng.integers(0, V, (n,)).astype(np.int32), m)
            for n, m in [(2, 8), (5, 2), (3, 6), (6, 3), (4, 4)]]
    for f in futs:
        f.result(timeout=120)
    stats = sched.stats()
    sched.stop()
    assert stats["decode_steps"] == stats["decode_dispatches"]
    assert stats["decode_steps"] >= 7  # the longest request decodes 7 steps
    # in-flight batching: fewer decode steps than one request at a time
    assert stats["decode_steps"] < sum(m - 1 for m in (8, 2, 6, 3, 4))
    assert stats["completed"] == 5 and stats["kv"]["in_use"] == 0
    assert stats["tokens"] == sum((8, 2, 6, 3, 4))
    assert stats["phases"]["decode_step"]["count"] == stats["decode_steps"]
    assert stats["phases"]["ttft"]["count"] == 5


def test_token_budget_scheduler_groups_prefills_same_tokens(gpt):
    """prefill_token_budget > 0 prefills more than one queued prompt a
    dispatch under the budget, with the tokens the one-prompt path gives
    and one decode dispatch a step in both."""
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, V, (n,)).astype(np.int32), m)
            for n, m in [(2, 4), (5, 3), (3, 4), (6, 2), (4, 3), (2, 3), (7, 2), (3, 3)]]

    def run(**kw):
        sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=8,
                                            block_size=8, max_prefills_per_step=8, **kw)
        # hold the worker until the whole burst is queued, so both runs
        # see the same queue
        with sched._mu:
            futs = [sched.submit(p, m, seed=100 + i) for i, (p, m) in enumerate(reqs)]
        outs = [f.result(timeout=120).tolist() for f in futs]
        stats = sched.stats()
        sched.stop()
        return outs, stats

    base_outs, base = run()
    tb_outs, tb = run(prefill_token_budget=16)
    assert tb_outs == base_outs
    assert base["decode_steps"] == base["decode_dispatches"]
    assert tb["decode_steps"] == tb["decode_dispatches"]
    assert base["prefill_dispatches"] == base["prefill_prompts"] == 8
    # 8 prompts of bucket 8 under a budget of 16: two a dispatch
    assert tb["prefill_prompts"] == 8 and tb["prefill_dispatches"] == 4
    assert "prefill_token_budget" not in base["knobs"]
    assert tb["knobs"]["prefill_token_budget"] == 16


def test_burst_sheds_with_the_kv_pool_as_binding_constraint(gpt):
    """A burst past admission_limit sheds; the pool (two worst-case
    requests) is what makes the queue back up."""
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=4, block_size=8,
                                        num_blocks=9, admission_limit=2)
    rng = np.random.default_rng(11)
    accepted, shed = [], 0
    for _ in range(10):
        try:
            accepted.append(sched.submit(rng.integers(0, V, (4,)).astype(np.int32), 20))
        except ShedError:
            shed += 1
    assert shed > 0
    assert all(f.result(timeout=120).shape == (24,) for f in accepted)
    stats = sched.stats()
    sched.stop()
    assert stats["shed"] == shed
    assert stats["kv"]["high_water"] <= stats["kv"]["capacity_blocks"] == 8
    # a request that can never fit sheds at once, even on an idle pool
    sched2 = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=2, block_size=8,
                                         num_blocks=3)
    with pytest.raises(ShedError, match="exceeds the whole pool"):
        sched2.submit(np.zeros(8, np.int32), 20)
    assert sched2.stats()["shed"] == 1
    sched2.stop()


def test_deadline_expired_rejected_before_pickup(gpt):
    """A long request holds the only slot's worth of pool, so a deadlined
    request expires in the queue and is rejected at pickup."""
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=1, block_size=8,
                                        num_blocks=5)
    rng = np.random.default_rng(13)
    long_f = sched.submit(rng.integers(0, V, (4,)).astype(np.int32), 24)
    dead_f = sched.submit(rng.integers(0, V, (4,)).astype(np.int32), 2, deadline_s=0.0005)
    with pytest.raises(DeadlineExceeded):
        dead_f.result(timeout=120)
    assert long_f.result(timeout=120).shape == (28,)
    stats = sched.stats()
    sched.stop()
    assert stats["deadline_rejects"] == 1 and stats["kv"]["in_use"] == 0


def test_deadline_expired_mid_flight_rejected_before_next_step(gpt):
    """An active request whose deadline passes is rejected before its next
    decode step and its blocks freed (the step is driven directly, so the
    expiry is deterministic)."""
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=2, block_size=8)
    req = GenerationRequest(0, np.zeros(3, np.int32), 8, 0.0, 0, None, deadline_s=0.01)
    req.table = sched.decoder.pool.try_admit(3 + 8)
    sched._prefill_group([(0, req)])
    time.sleep(0.02)
    sched._decode_once()
    with pytest.raises(DeadlineExceeded, match="mid-decode"):
        req.future.result(timeout=5)
    assert sched.decoder.pool.in_use() == 0
    with sched._mu:
        assert sched._slots[0] is None
    sched.stop()


def _crash_admission(sched, at_call, times):
    """Make the scheduler's admission step raise on its ``at_call``-th call
    and the ``times - 1`` calls after it: the point in the loop where the
    reference's ``serving.worker`` fault site fires."""
    admit = sched._admit
    calls = [0]

    def crashing(closed):
        calls[0] += 1
        if at_call <= calls[0] < at_call + times:
            raise RuntimeError("decode worker crashed")
        return admit(closed)

    sched._admit = crashing


def test_crashed_decode_worker_respawns_futures_resolve(gpt, capsys):
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=2, block_size=8,
                                        worker_retry_budget=2)
    _crash_admission(sched, at_call=3, times=1)
    rng = np.random.default_rng(17)
    reqs = [(rng.integers(0, V, (n,)).astype(np.int32), m) for n, m in [(3, 6), (4, 4), (2, 5)]]
    futs = [sched.submit(p, m, seed=1000 + i) for i, (p, m) in enumerate(reqs)]
    outs = [f.result(timeout=120) for f in futs]
    sched.stop()
    assert "respawning (1/2)" in capsys.readouterr().err
    for out, ref in zip(outs, _reference_rows(gpt, reqs, 0.0)):
        np.testing.assert_array_equal(out, ref)


def test_respawn_budget_exhausted_fails_loudly(gpt):
    """Past the budget every accepted future resolves with the abandon
    error and the breaker sheds new admissions."""
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=2, block_size=8,
                                        worker_retry_budget=1)
    _crash_admission(sched, at_call=1, times=10 ** 6)
    fut = sched.submit(np.zeros(3, np.int32), 4)
    with pytest.raises(RuntimeError, match="respawn budget"):
        fut.result(timeout=120)
    with pytest.raises(ShedError):
        sched.submit(np.zeros(3, np.int32), 4)
    assert sched.decoder.pool.in_use() == 0
    sched.stop()


def test_breaker_opens_on_consecutive_decode_failures(gpt, monkeypatch):
    sched = ContinuousBatchingScheduler(gpt, max_length=32, decode_slots=2, block_size=8,
                                        breaker_threshold=2, breaker_cooldown_s=30.0,
                                        worker_retry_budget=0)

    def wedged(*a, **k):
        raise RuntimeError("wedged device")

    monkeypatch.setattr(sched.decoder, "decode", wedged)
    futs = [sched.submit(np.zeros(3, np.int32), 4) for _ in range(2)]
    for f in futs:
        with pytest.raises(RuntimeError, match="wedged"):
            f.result(timeout=120)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            sched.submit(np.zeros(3, np.int32), 4)
        except ShedError:
            break
        time.sleep(0.02)
    else:
        pytest.fail("breaker never opened")
    sched.stop()


def test_retry_policy_backs_off_as_the_reference_does():
    kw = dict(max_attempts=4, base_delay_s=0.01, max_delay_s=0.03, jitter=0.5, seed=3)
    import random

    for attempt in range(4):
        got = RetryPolicy(**kw).delay_s(attempt, random.Random(3 + attempt))
        want = JRetryPolicy(**kw).delay_s(attempt, random.Random(3 + attempt))
        assert got == want
    calls = []

    def fails_twice():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flaky")
        return "ok"

    assert RetryPolicy(base_delay_s=0.0, retry_on=(OSError,)).call(fails_twice) == "ok"
    with pytest.raises(ValueError):  # not retried
        RetryPolicy(retry_on=(OSError,)).call(lambda: (_ for _ in ()).throw(ValueError()))


def test_engine_registration_and_restart(gpt):
    eng = InferenceEngine()
    eng.register_generator(gpt, name="lm", decode_slots=2, block_size=8, max_length=32)
    assert eng.generators() == ["lm"]
    with pytest.raises(ValueError, match="already registered"):
        eng.register_generator(gpt, name="lm")
    # the check runs both ways: a classic instance cannot take the name
    with pytest.raises(ValueError, match="generation instance"):
        eng.register_ffmodel(gpt, name="lm")
    eng.register_ffmodel(gpt, name="classic")
    with pytest.raises(ValueError, match="already registered"):
        eng.register_generator(gpt, name="classic")
    out = eng.generate("lm", np.zeros(3, np.int32), 3)
    assert out.shape == (6,)
    eng.stop()
    assert eng.generators() == []  # schedulers are one-shot: dropped at stop
    eng.register_generator(gpt, name="lm", decode_slots=2, block_size=8, max_length=32)
    np.testing.assert_array_equal(eng.generate("lm", np.zeros(3, np.int32), 3), out)
    eng.stop()


def test_config_knobs_flow_into_the_instance():
    ff = _gpt(serving_decode_slots=3, serving_block_size=4, serving_num_blocks=13,
              serving_max_length=24, serving_prefill_buckets="8,24",
              serving_max_prefills_per_step=2, serving_prefill_token_budget=16)
    eng = InferenceEngine()
    inst = eng.register_generator(ff, name="lm")
    dec = inst.scheduler.decoder
    assert (dec.decode_slots, dec.block_size, dec.pool.num_blocks, dec.max_length) == \
        (3, 4, 13, 24)
    assert dec.prefill_buckets == [8, 24]
    assert inst.scheduler.max_prefills_per_step == 2
    assert inst.scheduler.prefill_token_budget == 16
    # a keyword overrides the config
    inst2 = eng.register_generator(ff, name="lm2", decode_slots=2)
    assert inst2.decoder.decode_slots == 2 and inst2.decoder.block_size == 4
    eng.stop()
