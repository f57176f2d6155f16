"""The paged KV pool and the PagedDecoder, against the JAX package's.

``PagedKVPool``'s allocator and byte count are held to the reference
pool's; ``_quant_rows`` to the reference's int8 quantizer. Then a small GPT
(vocab 50, 32 positions, hidden 32, 4 heads, 2 layers) is built in both
packages with the same random params (``load_numpy_params``) and its
paged prefill, grouped prefill, decode and verify logits are held against
the JAX ``PagedDecoder`` and against the port's dense ``Generator`` (which
``tests/test_torch_gpt.py`` holds to the JAX dense ``Generator``).

Tolerances: f32 logits within 1e-5 of the largest |logit| (the same graph
in the same precision, summed in another order; seen ~1e-7). The int8
pool's calibration divergence within 1e-4 of the JAX decoder's (the same
quantizer over K/V that differ in the last f32 bits). bf16 compute over an
int8 pool is held to the JAX decoder within 2**-6 of the largest |logit|:
there the port departs from the reference on purpose (its graph stays in
bf16 after the f32 attention; the reference's promotes to f32). The reference's own
paged path is no longer bit-identical to its dense one under jax 0.9,
so nothing here is held to bit identity across layouts.
"""

import functools

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
from flexflow_tpu.serving.generation import PagedDecoder as JPagedDecoder
from flexflow_tpu.serving.generation import _quant_rows as jquant_rows
from flexflow_tpu.serving.kv_cache import PagedKVPool as JPagedKVPool
from flexflow_tpu_torch import CompMode, FFConfig, FFModel, load_numpy_params
from flexflow_tpu_torch.models import GPTConfig, build_gpt
from flexflow_tpu_torch.serving import (Generator, KVPoolExhausted, PagedDecoder,
                                        PagedKVPool)
from flexflow_tpu_torch.serving.generation import _quant_rows
from flexflow_tpu_torch.serving.kv_cache import NULL_BLOCK
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

V = 50
SHAPE = dict(vocab_size=V, max_positions=32, hidden_size=32, num_heads=4, num_layers=2)
MAX_LEN, BLOCK, SLOTS = 32, 8, 4
REL = 1e-5  # of the largest |logit|
PROMPT_LENS = (3, 6, 2, 5)


# ---- the pool -----------------------------------------------------------------
def test_pool_geometry_admission_free_and_high_water():
    pool = PagedKVPool({"a": (2, 4), "b": (2, 4)}, num_blocks=5, block_size=4,
                       max_blocks_per_request=3, device="cpu")
    assert pool.capacity_blocks == 4 and pool.kv["a"][0].shape == (5, 4, 2, 4)
    assert [pool.blocks_for(n) for n in (0, 1, 4, 5, 12)] == [1, 1, 1, 2, 3]
    t1 = pool.try_admit(9)  # 3 blocks, handed out LIFO from 1
    np.testing.assert_array_equal(t1, [1, 2, 3])
    assert pool.try_admit(5) is None  # 2 blocks wanted, 1 free: wait
    t2 = pool.try_admit(3)
    np.testing.assert_array_equal(t2, [4, NULL_BLOCK, NULL_BLOCK])
    assert pool.in_use() == 4 and pool.high_water == 4
    pool.free(t1)
    assert pool.in_use() == 1 and pool.high_water == 4
    # the blocks freed last come back first
    np.testing.assert_array_equal(pool.try_admit(4), [3, NULL_BLOCK, NULL_BLOCK])
    stats = pool.stats()
    assert (stats["in_use"], stats["high_water"], stats["capacity_blocks"],
            stats["kv_dtype"]) == (2, 4, 4, "float32")


def test_pool_sheds_the_impossible_and_raises_on_double_free():
    pool = PagedKVPool({"a": (2, 4)}, num_blocks=3, block_size=4, max_blocks_per_request=4,
                       device="cpu")
    with pytest.raises(KVPoolExhausted, match="exceeds the whole pool"):
        pool.try_admit(12)  # 3 blocks > 2 allocatable
    with pytest.raises(KVPoolExhausted, match="max_blocks_per_request"):
        pool.try_admit(17)
    t = pool.try_admit(8)
    pool.free(t)
    with pytest.raises(RuntimeError, match="double free"):
        pool.free(t)


@pytest.mark.parametrize("kw,match", [
    (dict(num_blocks=1), "null block"), (dict(block_size=0), "block_size"),
    (dict(max_blocks_per_request=0), "max_blocks_per_request"),
    (dict(kv_dtype="fp8"), "kv_dtype")])
def test_pool_validates_its_geometry(kw, match):
    args = dict(num_blocks=4, block_size=4, max_blocks_per_request=2)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        PagedKVPool({"a": (2, 4)}, device="cpu", **args)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_memory_bytes_equal_the_jax_pool(kv_dtype, compute):
    specs = {"l0": (4, 8), "l1": (2, 16)}
    pool = PagedKVPool(specs, num_blocks=9, block_size=8, max_blocks_per_request=4,
                       dtype=getattr(torch, compute), kv_dtype=kv_dtype, device="cpu")
    jpool = JPagedKVPool(specs, num_blocks=9, block_size=8, max_blocks_per_request=4,
                         dtype=getattr(jnp, compute), kv_dtype=kv_dtype)
    assert pool.memory_bytes() == jpool.memory_bytes()
    arena_bytes = sum(t.numel() * t.element_size() for e in pool.kv.values() for t in e)
    assert pool.memory_bytes() == arena_bytes


def test_quant_rows_match_jax():
    x = np.random.default_rng(0).normal(size=(37, 4, 16)).astype(np.float32) * 3
    x[5, 2] = 0.25  # a constant row: the scale's floor
    q, s, z = _quant_rows(torch.from_numpy(x))
    jq, js, jz = jquant_rows(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=1e-6)
    deq = q.float() * s[..., None] + z[..., None]
    assert float((deq - torch.from_numpy(x)).abs().max()) <= float(s.max()) / 2 + 1e-6


# ---- the decoder ----------------------------------------------------------------
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


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX GPT, port GPT) compiled for inference with the same params."""
    jff = JFFModel(JFFConfig(batch_size=SLOTS, seed=0, computation_mode=JCompMode.INFERENCE,
                             ledger="off", audit_programs="off", attribution="off"))
    jbuild_gpt(jff, SLOTS, 6, JGPTConfig(**SHAPE))
    jff.compile(optimizer=None, loss_type=None, metrics=[],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    tff = FFModel(FFConfig(batch_size=SLOTS, seed=0, computation_mode=CompMode.INFERENCE,
                           device="cpu"))
    build_gpt(tff, SLOTS, 6, GPTConfig(**SHAPE))
    tff.compile()
    tree = _params(jff)
    jff.compiled.params = jax.tree_util.tree_map(jnp.asarray, tree)
    load_numpy_params(tff, tree)
    return jff, tff


def _decoders(**kw):
    jff, tff = _pair()
    args = dict(max_length=MAX_LEN, decode_slots=SLOTS, block_size=BLOCK, **kw)
    return JPagedDecoder(jff, **args), PagedDecoder(tff, **args)


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * scale, err_msg=what)


def _prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, (n,)).astype(np.int32) for n in PROMPT_LENS]


def _serve_teacher_forced(dec, prompts, steps, forced=None):
    """Admit every prompt, prefill each alone, then ``steps`` decode steps
    with all slots live. Tokens: ``forced`` (prompts' continuations) or the
    greedy argmax of this decoder. Returns (prefill logits, [per-step
    (slots, V) logits], the tokens fed, the tables)."""
    tables = np.zeros((SLOTS, dec.max_blocks_per_request), np.int32)
    firsts = []
    for i, p in enumerate(prompts):
        tables[i] = dec.pool.try_admit(p.size + steps + 1)
        firsts.append(dec.prefill(p, tables[i]))
    fed = (np.stack([f.argmax(-1) for f in firsts]).astype(np.int32)[:, None]
           if forced is None else forced)
    seq_lens = np.array([p.size for p in prompts], np.int32)
    step_logits = []
    for step in range(steps):
        lg = dec.decode(fed[:, step], tables, seq_lens + step)
        step_logits.append(lg)
        if forced is None:
            fed = np.concatenate([fed, lg.argmax(-1).astype(np.int32)[:, None]], axis=1)
    for t in tables:
        dec.pool.free(t)
    return np.stack(firsts), step_logits, fed, tables


def test_prefill_and_decode_logits_match_the_jax_paged_decoder():
    jdec, dec = _decoders()
    prompts = _prompts()
    jfirst, jsteps, fed, jtables = _serve_teacher_forced(jdec, prompts, 4)
    first, steps, _, tables = _serve_teacher_forced(dec, prompts, 4, forced=fed)
    np.testing.assert_array_equal(tables, jtables)  # the same allocator
    _close(first, jfirst, "prefill")
    for i, (got, want) in enumerate(zip(steps, jsteps)):
        _close(got, want, f"decode step {i}")
    assert dec.decode_steps == dec.decode_dispatches == 4


def test_paged_logits_match_the_ports_dense_generator():
    """Each request alone through the dense Generator, on the tokens the
    paged decoder saw: its prefill and every decode step's logits."""
    _, tff = _pair()
    dec = PagedDecoder(tff, max_length=MAX_LEN, decode_slots=SLOTS, block_size=BLOCK)
    gen = Generator(tff, max_length=MAX_LEN, batch_size=1)
    prompts = _prompts(2)
    first, steps, fed, _ = _serve_teacher_forced(dec, prompts, 5)
    for i, p in enumerate(prompts):
        d_first, cache, pos = gen.prefill(p[None, :])
        _close(first[i], d_first[0].numpy(), f"prefill {i}")
        for step, lg in enumerate(steps):
            d = gen._step(gen._exec_params(), gen._tokens(fed[i:i + 1, step:step + 1]),
                          cache, pos + step)[0, -1].numpy()
            _close(lg[i], d, f"request {i} step {step}")


def test_prefill_many_matches_single_prefills_and_jax():
    """Five prompts in one grouped prefill (rows padded to 8) against five
    single prefills, the decode step after each, and the JAX grouped
    prefill."""
    jff, tff = _pair()
    args = dict(max_length=MAX_LEN, decode_slots=8, block_size=BLOCK)
    one, many, jmany = PagedDecoder(tff, **args), PagedDecoder(tff, **args), \
        JPagedDecoder(jff, **args)
    prompts = [p for p in _prompts(7)] + [np.arange(4, dtype=np.int32)]
    tabs = [one.pool.try_admit(p.size + 2) for p in prompts]
    singles = np.stack([one.prefill(p, t) for p, t in zip(prompts, tabs)])
    tabs_many = [many.pool.try_admit(p.size + 2) for p in prompts]
    batched = many.prefill_many(prompts, tabs_many)
    jtabs = [jmany.pool.try_admit(p.size + 2) for p in prompts]
    assert batched.shape == (len(prompts), V)
    _close(batched, singles, "grouped vs single prefill")
    _close(batched, jmany.prefill_many(prompts, jtabs), "grouped prefill vs JAX")
    # the grouped prefill wrote the same K/V: the next decode step agrees
    toks = np.zeros(8, np.int32)
    seq_lens = np.zeros(8, np.int32)
    t_one = np.zeros((8, one.max_blocks_per_request), np.int32)
    t_many = np.zeros_like(t_one)
    for i, p in enumerate(prompts):
        toks[i], seq_lens[i] = int(batched[i].argmax()), p.size
        t_one[i], t_many[i] = tabs[i], tabs_many[i]
    n = len(prompts)
    _close(many.decode(toks, t_many, seq_lens)[:n], one.decode(toks, t_one, seq_lens)[:n],
           "decode after grouped vs single prefill")
    assert many.prefill_buckets == [8, 16, 32] == jmany.prefill_buckets
    assert many.bucket_for(6) == 8 and many.bucket_for(9) == 16
    with pytest.raises(ValueError, match="exceeds the largest prefill bucket"):
        many.bucket_for(33)


def test_verify_rows_equal_sequential_decodes_and_jax():
    """A W = 4 verify window against four single-token decode steps on a
    twin decoder, and against the JAX verify."""
    jdec, dec = _decoders()
    _, twin = _decoders()
    prompts = _prompts(3)
    rng = np.random.default_rng(4)
    window = rng.integers(0, V, (SLOTS, 4)).astype(np.int32)
    seq_lens = np.array([p.size for p in prompts], np.int32)
    tables = np.zeros((SLOTS, dec.max_blocks_per_request), np.int32)
    for d in (jdec, dec, twin):
        for i, p in enumerate(prompts):
            tables[i] = d.pool.try_admit(p.size + 4)
            d.prefill(p, tables[i])
    rows = dec.verify(window, tables, seq_lens)
    assert rows.shape == (SLOTS, 4, V)
    assert dec.decode_steps == dec.decode_dispatches == 1
    for j in range(4):
        _close(rows[:, j], twin.decode(window[:, j], tables, seq_lens + j), f"row {j}")
    _close(rows, jdec.verify(window, tables, seq_lens), "verify vs JAX")


def test_int8_divergence_matches_jax_and_fallback_is_loud(capsys):
    jdec, dec = _decoders(kv_dtype="int8")
    assert dec.kv_dtype == jdec.kv_dtype == "int8"
    assert dec.kv_quant_report is None and dec.kv_divergence_budget == 0.05
    assert 0 < dec.kv_divergence <= 0.05
    assert abs(dec.kv_divergence - jdec.kv_divergence) <= 1e-4, \
        (dec.kv_divergence, jdec.kv_divergence)
    assert dec.pool.stats()["kv_dtype"] == "int8"
    assert dec.pool.kv["block0_attn"][0].dtype == torch.int8
    # an impossible budget: back to float32 arenas, loudly
    _, tff = _pair()
    # the slot count of the decoder it is held to: its calibration decodes
    # batches of the same shape, so CPU BLAS rounds them alike
    fb = PagedDecoder(tff, max_length=MAX_LEN, decode_slots=SLOTS, block_size=BLOCK,
                      kv_dtype="int8", kv_divergence_budget=1e-9)
    assert fb.kv_dtype == "float32" and fb.pool.stats()["kv_dtype"] == "float32"
    assert fb.kv_divergence == pytest.approx(dec.kv_divergence, abs=1e-7)
    assert fb.kv_quant_report.code == "KVQ001"
    assert "[serving] KVQ001" in capsys.readouterr().err
    # the fallback pool serves
    table = fb.pool.try_admit(3 + 2)
    tok = int(fb.prefill(np.ones(3, np.int32), table).argmax())
    idle = SLOTS - 1
    out = fb.decode(np.array([tok] + [0] * idle, np.int32),
                    np.stack([table] + [np.zeros_like(table)] * idle),
                    np.array([3] + [0] * idle, np.int32))
    assert np.isfinite(out).all()


def test_bf16_paged_decode_follows_the_dense_generator():
    """bf16 compute, the pool in bf16: the paged prefill and decode agree
    with the dense Generator run on the same bf16 ops within a few bf16
    ulps of the largest |logit| (both round K/V to bf16 identically; the
    scores sum over 32 slots in either layout)."""
    jff, _ = _pair()
    tff = FFModel(FFConfig(batch_size=SLOTS, seed=0, computation_mode=CompMode.INFERENCE,
                           compute_dtype="bfloat16", device="cpu"))
    build_gpt(tff, SLOTS, 6, GPTConfig(**SHAPE))
    tff.compile()
    load_numpy_params(tff, _params(jff))
    dec = PagedDecoder(tff, max_length=MAX_LEN, decode_slots=SLOTS, block_size=BLOCK)
    assert dec.pool.kv["block0_attn"][0].dtype == torch.bfloat16
    gen = Generator(tff, max_length=MAX_LEN, batch_size=1)
    prompts = _prompts(5)
    first, steps, fed, _ = _serve_teacher_forced(dec, prompts, 3)
    for i, p in enumerate(prompts):
        d_first, cache, pos = gen.prefill(p[None, :])
        want = [d_first[0].numpy()] + [
            gen._step(gen._exec_params(), gen._tokens(fed[i:i + 1, s:s + 1]), cache,
                      pos + s)[0, -1].numpy() for s in range(3)]
        got = [first[i]] + [lg[i] for lg in steps]
        for s, (g, w) in enumerate(zip(got, want)):
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=0, atol=2 ** -6 * scale,
                                       err_msg=f"request {i} step {s}")


def test_bf16_int8_pool_follows_the_jax_paged_decoder():
    """bf16 compute over an int8 pool. The port casts the f32 attention
    output back to bf16 and keeps its graph in bf16; the reference lets the
    f32 promote through the rest of its graph. So the two are held within
    2**-6 of the largest |logit| (two bf16 ulps at the top of the range;
    seen ~0.011 of it), the calibration divergences within 2**-6 of the
    calibration logits' scale, and both keep int8 under the default
    budget."""
    jff0, _ = _pair()
    tree = _params(jff0)
    jff = JFFModel(JFFConfig(batch_size=SLOTS, seed=0, computation_mode=JCompMode.INFERENCE,
                             compute_dtype="bfloat16", ledger="off", audit_programs="off",
                             attribution="off"))
    jbuild_gpt(jff, SLOTS, 6, JGPTConfig(**SHAPE))
    jff.compile(optimizer=None, loss_type=None, metrics=[],
                mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    jff.compiled.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tff = FFModel(FFConfig(batch_size=SLOTS, seed=0, computation_mode=CompMode.INFERENCE,
                           compute_dtype="bfloat16", device="cpu"))
    build_gpt(tff, SLOTS, 6, GPTConfig(**SHAPE))
    tff.compile()
    load_numpy_params(tff, tree)
    args = dict(max_length=MAX_LEN, decode_slots=SLOTS, block_size=BLOCK, kv_dtype="int8")
    jdec, dec = JPagedDecoder(jff, **args), PagedDecoder(tff, **args)
    assert dec.kv_dtype == jdec.kv_dtype == "int8"
    assert dec.pool.kv["block0_attn"][0].dtype == torch.int8
    prompts = _prompts(5)
    jfirst, jsteps, fed, _ = _serve_teacher_forced(jdec, prompts, 4)
    first, steps, _, _ = _serve_teacher_forced(dec, prompts, 4, forced=fed)
    scale = float(np.abs(jfirst).max())
    np.testing.assert_allclose(first, jfirst, rtol=0, atol=2 ** -6 * scale, err_msg="prefill")
    for i, (got, want) in enumerate(zip(steps, jsteps)):
        np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -6 * float(np.abs(want).max()),
                                   err_msg=f"decode step {i}")
    assert abs(dec.kv_divergence - jdec.kv_divergence) <= 2 ** -6 * scale, \
        (dec.kv_divergence, jdec.kv_divergence)
