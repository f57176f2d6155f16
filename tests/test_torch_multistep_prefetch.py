"""Multi-step dispatch and the Prefetcher against the serial loop.

``train_k_steps`` is a Python loop over ``train_step`` and the Prefetcher
keeps the serial pull order, so on the CPU both are held EXACTLY: the
params and the epoch's metric sums of ``fit`` with ``steps_per_dispatch``
in {1, 3} and ``prefetch_depth`` in {0, 2} equal the plain serial loop's
bit for bit. The Prefetcher's super-batch sizes equal the JAX package's
``_plan``, and a ``prefetch.worker`` fault raises on the consumer without
leaving the worker thread alive.
"""

import threading

import numpy as np
import pytest
import torch

from flexflow_tpu.runtime.dataloader import Prefetcher as JPrefetcher
from flexflow_tpu_torch import (ActiMode, AdamOptimizer, FFConfig, FFModel, LossType,
                                MetricsType)
from flexflow_tpu_torch.runtime import faults
from flexflow_tpu_torch.runtime.dataloader import (DataLoaderGroup, Prefetcher,
                                                   SingleDataLoader)
from flexflow_tpu_torch.runtime.faults import InjectedFault

BATCH = 8


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.configure_faults(FFConfig(device="cpu"))


def _data(n=8 * BATCH, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=(n, 1)).astype(np.int32)
    return x, y


def _mlp(**cfg):
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu", seed=3, **cfg))
    x = ff.create_tensor((BATCH, 16), name="input")
    h = ff.dense(x, 32, ActiMode.RELU, name="body")
    ff.dense(h, 4, name="head")
    ff.compile(AdamOptimizer(alpha=0.01), LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def _snapshot(ff):
    return {op: {w: t.clone() for w, t in ws.items()} for op, ws in ff.compiled.params.items()}


def _assert_bit_equal(a, b):
    for op in a:
        for w in a[op]:
            assert torch.equal(a[op][w], b[op][w]), (op, w)


def _metrics(pm):
    return (pm.train_all, pm.train_correct, pm.sparse_cce_loss)


@pytest.fixture(scope="module")
def serial_run():
    """The plain serial loop: one train_step a batch, folded by
    PerfMetrics.accumulate, over two epochs."""
    x, y = _data()
    ff = _mlp()
    hist = ff.fit(x, y, epochs=2, verbose=False)
    return _snapshot(ff), [_metrics(pm) for pm in hist]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("depth", [0, 2])
def test_fit_equals_the_serial_loop_bit_for_bit(serial_run, k, depth):
    x, y = _data()
    ff = _mlp(steps_per_dispatch=k, prefetch_depth=depth)
    hist = ff.fit(x, y, epochs=2, verbose=False)
    _assert_bit_equal(_snapshot(ff), serial_run[0])
    assert [_metrics(pm) for pm in hist] == serial_run[1]
    prof = ff.fit_profile
    assert (prof["steps_per_dispatch"], prof["prefetch_depth"]) == (k, depth)
    assert [r["steps"] for r in prof["epochs"]] == [8, 8]
    assert ff.compiled.iteration == 16


def test_train_k_steps_equals_k_train_steps():
    """Three steps in one call against three serial calls: the params, the
    Adam state, the stacked losses and the folded metrics, bit for bit."""
    x, y = _data(3 * BATCH, seed=4)
    xs = torch.from_numpy(x).reshape(3, BATCH, 16)
    ys = torch.from_numpy(y).reshape(3, BATCH, 1)
    a, b = _mlp(), _mlp()
    ca, cb = a.compiled, b.compiled
    losses, folded = [], None
    for i in range(3):
        ca.params, ca.opt_state, loss, bm = ca.train_step(ca.params, ca.opt_state, i + 1,
                                                          xs[i], ys[i])
        losses.append(loss)
        folded = dict(bm) if folded is None else {k: folded[k] + v for k, v in bm.items()}
    cb.params, cb.opt_state, k_losses, k_folded = cb.train_k_steps(
        cb.params, cb.opt_state, [1, 2, 3], xs, ys)
    _assert_bit_equal(cb.params, ca.params)
    _assert_bit_equal(cb.opt_state["m"], ca.opt_state["m"])
    _assert_bit_equal(cb.opt_state["v"], ca.opt_state["v"])
    assert cb.opt_state["t"] == ca.opt_state["t"] == 3
    assert torch.equal(k_losses, torch.stack(losses)) and k_losses.shape == (3,)
    assert set(k_folded) == set(folded)
    assert all(torch.equal(k_folded[k], folded[k]) for k in folded)


class _Group:
    """The only thing ``_plan`` reads of a group."""

    def __init__(self, nb):
        self.num_batches = nb


@pytest.mark.parametrize("nb", [1, 2, 5, 8, 11, 17])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("depth", [0, 2])
def test_prefetcher_ramp_equals_the_jax_plan(nb, k, depth):
    plan = Prefetcher(_Group(nb), depth, steps_per_item=k)._plan()
    assert plan == JPrefetcher(_Group(nb), depth, steps_per_item=k)._plan()
    assert sum(plan) == nb


def _group(n=40, bs=8, shuffle=True):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = np.arange(n, dtype=np.int32).reshape(n, 1)
    cpu = torch.device("cpu")
    return DataLoaderGroup([SingleDataLoader(x, bs, cpu), SingleDataLoader(y, bs, cpu)],
                           seed=7, shuffle=shuffle)


@pytest.mark.parametrize("depth,k", [(0, 1), (2, 1), (1, 2), (3, 4)])
def test_prefetcher_stream_equals_the_serial_loader(depth, k):
    serial = _group()
    want = []
    for _ in range(2):
        serial.reset(reshuffle=True)
        want += [serial.next_batch() for _ in range(serial.num_batches)]
    got = []
    pf = Prefetcher(_group(), depth, steps_per_item=k)
    for _ in range(2):
        for nk, batch in pf.epoch():
            got += [[t[i] for t in batch] for i in range(nk)] if nk > 1 else [batch]
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "ff-prefetch" and t.is_alive()]


@pytest.mark.parametrize("at_step", [1, 3])
def test_prefetch_worker_fault_raises_on_the_consumer(at_step):
    faults.configure_faults(FFConfig(device="cpu", fault_plan={
        "schema": 1, "sites": {"prefetch.worker": {"at_step": at_step}}}))
    before = len(_prefetch_threads())
    got = 0
    with pytest.raises(InjectedFault, match="prefetch.worker"):
        for _ in Prefetcher(_group(), 2).epoch():
            got += 1
    assert got == at_step - 1
    assert len(_prefetch_threads()) == before


def test_prefetch_worker_fault_stops_fit():
    x, y = _data()
    ff = _mlp(prefetch_depth=2, fault_plan={
        "schema": 1, "sites": {"prefetch.worker": {"at_step": 2}}})
    with pytest.raises(InjectedFault):
        ff.fit(x, y, verbose=False)
    assert not _prefetch_threads()
    assert ff.compiled.iteration == 1


def test_abandoned_epoch_joins_its_worker():
    pf = Prefetcher(_group(n=80), 1)
    it = pf.epoch()
    next(it)
    it.close()
    assert not _prefetch_threads()


def test_packed_super_batches_raise():
    from flexflow_tpu_torch.runtime.buckets import PackingSpec

    g = _group()
    g.packing = PackingSpec(ladder=(3,), token_budget=0, batch_size=8,
                            seq_axes=(True, False), pad_values=(0, -1))
    g._lengths = np.full(40, 3)
    g.reset()
    with pytest.raises(ValueError, match="super-batch"):
        g.assemble_host(2)


@pytest.mark.parametrize("argv", [
    ["--grad-accum-steps", "4", "--steps-per-dispatch", "3", "--prefetch-depth", "2",
     "--max-inflight-steps", "5"],
    ["--seq-buckets", "pow2", "--seq-bucket-min", "16", "--seq-bucket-max", "512",
     "--token-budget", "8192", "--seq-bucket-pad-max", "on"],
    ["--fusion", "--checkpoint-interval", "100", "--checkpoint-dir", "ck",
     "--checkpoint-keep", "2", "--elastic-resume", "-b", "16", "-e", "3", "--seed", "7"],
    ["--unknown-flag", "--seq-buckets", "32,64", "--compute-dtype", "bfloat16"]])
def test_parse_args_reads_the_jax_flags(argv):
    from flexflow_tpu import FFConfig as JFFConfig

    got, want = FFConfig.parse_args(argv), JFFConfig.parse_args(argv)
    for field in ("grad_accum_steps", "steps_per_dispatch", "prefetch_depth",
                  "max_inflight_steps", "seq_buckets", "seq_bucket_min", "seq_bucket_max",
                  "token_budget", "seq_bucket_pad_max", "perform_fusion",
                  "checkpoint_interval_steps", "checkpoint_dir", "checkpoint_max_to_keep",
                  "elastic_resume", "batch_size", "epochs", "seed", "compute_dtype"):
        assert getattr(got, field) == getattr(want, field), field


def test_new_config_fields_keep_the_jax_defaults():
    from flexflow_tpu import FFConfig as JFFConfig
    from flexflow_tpu.config import FFIterationConfig as JIter
    from flexflow_tpu_torch.config import FFIterationConfig

    got, want = FFConfig(), JFFConfig()
    for field in ("perform_fusion", "checkpoint_interval_steps", "checkpoint_dir",
                  "checkpoint_max_to_keep", "elastic_resume", "grad_accum_steps",
                  "prefetch_depth", "max_inflight_steps", "steps_per_dispatch",
                  "seq_buckets", "seq_bucket_min", "seq_bucket_max", "token_budget",
                  "seq_bucket_pad_max"):
        assert getattr(got, field) == getattr(want, field), field
    it = FFIterationConfig(seq_length=9)
    it.reset()
    assert it.seq_length == JIter().seq_length == -1
