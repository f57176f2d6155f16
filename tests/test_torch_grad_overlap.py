"""The mesh training step all-reduces its gradients bucket by bucket
while the backward runs (``parallel/grad_buckets.py`` cuts the buckets,
``runtime/compiler.py`` hooks the gradient leaves and issues them through
``collectives.all_reduce_coalesced_async``), as XLA
overlaps the psum inside the JAX package's jitted step. The port's ranks
are spawned over gloo on the CPU with the bucket size lowered to
``BUCKET`` bytes, so the small Transformer (2 layers, hidden 64, 4 heads,
seq 16) has several buckets.

On {data: 2} every sum has two addends, so ``train_step`` (SGD, with
``grad_accum_steps`` 2, and ZeRO-1 Adam) and ``grad_step`` give the
params of a second compile whose gradients are all-reduced after the
backward (``sync_grads`` over the step's unsynced gradients), bit for bit
after each of three steps; SGD and the accumulation (two microbatches of
an MSE mean make the whole batch's gradient, up to rounding) are also
held to the JAX package's {data: 2} run on its virtual CPU mesh, and
{data: 2, model: 2} with ``tp_axis="model"`` to the JAX package and to
the after-backward sync, within ``test_torch_parallel_training.py``'s
tolerances (1e-5 of the largest |value|, and 2^-4 of each tensor's
largest update for the params). A weight the loss does not read is
synced as zeros. Each step's ``CompiledModel.last_sync`` shows the
buckets issued in index order, all but the last before ``autograd.grad``
returned, in the same order on every rank. A bucket whose all-reduce
fails to issue or to finish raises, naming the bucket and its group."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.core.machine import Group
from flexflow_tpu_torch.parallel import collectives as C
from flexflow_tpu_torch.parallel.distributed import spawn
from flexflow_tpu_torch.parallel.grad_buckets import cut_buckets

import _torch_mesh_workers as workers
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)
from _torch_shared import run_once
from test_torch_parallel_training import (BATCH, MSE, SHAPE, TOL, _case, _close_params,
                                          _jax_run)

BUCKET = 40 << 10  # about two fifths of a layer's gradients
VARIANTS = ("sgd", "accum2", "zero_adam", "grad_step")


def _unused_case():
    rng = np.random.default_rng(29)
    h = SHAPE["hidden_size"]
    params = {"unused": {"kernel": rng.normal(size=(h, h)).astype(np.float32) * 0.1,
                         "bias": rng.normal(size=h).astype(np.float32) * 0.1},
              "up": {"kernel": rng.normal(size=(h, 2 * h)).astype(np.float32) * 0.1,
                     "bias": rng.normal(size=2 * h).astype(np.float32) * 0.1},
              "head": {"kernel": rng.normal(size=(2 * h, 1)).astype(np.float32) * 0.1,
                       "bias": rng.normal(size=1).astype(np.float32) * 0.1}}
    batches = [(rng.standard_normal((BATCH, h)).astype(np.float32),
                rng.standard_normal((BATCH, 1)).astype(np.float32)) for _ in range(3)]
    return params, batches


def _two_ranks(tmp_path_factory) -> dict:
    def go():
        params, batches = _case("transformer")
        todo = [("grad_overlap", ("transformer", {"data": 2}, SHAPE, {}, params, batches, MSE,
                                  v, BUCKET)) for v in VARIANTS]
        up, ub = _unused_case()
        todo.append(("grad_overlap", ("unused_mlp", {"data": 2}, SHAPE, {}, up, ub, MSE, "sgd",
                                      1 << 10)))
        got = spawn(workers.jobs, 2, todo)
        return {k: [r[i] for r in got] for i, k in enumerate(VARIANTS + ("unused",))}
    return run_once(tmp_path_factory, "grad_overlap_two_ranks", go)


def _check_records(ranks, min_buckets: int = 3):
    """Each step's record on every rank: the buckets in index order, the
    same on every rank, every one but the last issued before the backward
    returned; the exposed sync measured."""
    for step in range(len(ranks[0]["records"])):
        recs = [r["records"][step] for r in ranks]
        buckets = recs[0]["buckets"]
        assert len(buckets) >= min_buckets
        assert [b["index"] for b in buckets] == list(range(len(buckets)))
        for rec in recs:
            assert [(b["axes"], b["bytes"], b["index"]) for b in rec["buckets"]] == \
                [(b["axes"], b["bytes"], b["index"]) for b in buckets]
            assert all(b["before_return"] for b in rec["buckets"][:-1])
            assert sum(b["before_return"] for b in rec["buckets"]) >= 2
            assert rec["exposed_ms"] >= 0.0


def _bitwise(a: dict, b: dict):
    for op, ws in b.items():
        for w, t in ws.items():
            assert np.array_equal(a[op][w], t), f"{op}.{w}"


def test_plan_grad_buckets_cuts_each_key_in_backward_order():
    """Each key's gradients fill buckets of the given size in the order
    they come; the buckets are listed by their last gradient's place."""
    a, b = (("data",), "f32"), (("data", "model"), "f32")
    entries = [(a, "h.k", 30), (b, "h.b", 4), (a, "m.k", 30), (a, "m.b", 4), (b, "e.b", 4),
               (a, "e.k", 30)]
    got = cut_buckets(entries, 60)
    assert got == [(a, ["h.k", "m.k"], 60), (b, ["h.b", "e.b"], 8), (a, ["m.b", "e.k"], 34)]
    assert cut_buckets(entries, 1) == [(k, [n], s) for k, n, s in entries]
    assert cut_buckets([], 1) == []


def test_data_parallel_buckets_equal_the_after_backward_sync_and_jax(tmp_path_factory):
    """{data: 2}, SGD, three steps: bit for bit the params of the compile
    that syncs after the backward, after every step, the losses and params within the tolerances
    of the JAX package's {data: 2} run."""
    ranks = _two_ranks(tmp_path_factory)["sgd"]
    _check_records(ranks)
    r0 = ranks[0]
    for got, want in zip(r0["got"], r0["want"]):
        _bitwise(got, want)
    params = _case("transformer")[0]
    jlosses, jparams = _jax_run("transformer-data2")
    assert all(r["losses"] == r0["losses"] for r in ranks)
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=TOL)
    _close_params(r0["got"][-1], jparams, params)


@pytest.mark.parametrize("variant", ["accum2", "zero_adam", "grad_step"])
def test_accumulation_zero_and_grad_step_equal_the_after_backward_sync(variant,
                                                                       tmp_path_factory):
    """grad_accum_steps 2 (only the last microbatch's backward issues the
    buckets, each gradient joining the first's), ZeRO-1 Adam, and
    ``grad_step`` then the manual update: bit for bit the compile that
    syncs after the backward, after every step, the buckets issued during
    the backward. The accumulation is also held to the JAX package's
    whole-batch {data: 2} run: with SGD and an MSE mean, two microbatches'
    gradients over 2 equal the whole batch's up to rounding, so a fault of
    the microbatch forward over a mesh shows there."""
    ranks = _two_ranks(tmp_path_factory)[variant]
    _check_records(ranks)
    for got, want in zip(ranks[0]["got"], ranks[0]["want"]):
        _bitwise(got, want)
    if variant == "accum2":
        jlosses, jparams = _jax_run("transformer-data2")
        np.testing.assert_allclose(ranks[0]["losses"], jlosses, rtol=TOL)
        _close_params(ranks[0]["got"][-1], jparams, _case("transformer")[0])


def test_a_weight_the_loss_does_not_read_is_synced_as_zeros(tmp_path_factory):
    """The dense layer no loss reads gets zero gradients, synced in its
    buckets after the backward returns: SGD leaves it where it started,
    and every param equals the after-backward sync's bit for bit."""
    ranks = _two_ranks(tmp_path_factory)["unused"]
    r0 = ranks[0]
    start = _unused_case()[0]
    for got, want in zip(r0["got"], r0["want"]):
        _bitwise(got, want)
        _bitwise({"unused": got["unused"]}, {"unused": start["unused"]})
    for r in ranks:
        for rec in r["records"]:
            assert [b["index"] for b in rec["buckets"]] == list(range(len(rec["buckets"])))
            # the unused weights (created first, so reached last) wait for the return
            assert not rec["buckets"][-1]["before_return"]
            assert rec["buckets"][0]["before_return"]


def test_tensor_parallel_buckets_match_jax(tmp_path_factory):
    """{data: 2, model: 2} with tp_axis "model": the backward's own
    collectives on the model group run between the buckets on the data
    group; three SGD steps within the tolerances of the JAX package and
    of the compile that syncs after the backward."""
    params, batches = _case("transformer")

    def go():
        return spawn(workers.jobs, 4, [("grad_overlap", (
            "transformer", {"data": 2, "model": 2}, SHAPE, {"tp_axis": "model"}, params,
            batches, MSE, "sgd", BUCKET))])
    ranks = [r[0] for r in run_once(tmp_path_factory, "grad_overlap_four_ranks", go)]
    _check_records(ranks)
    r0 = ranks[0]
    assert {tuple(b["axes"]) for b in r0["records"][0]["buckets"]} >= {("data",)}
    jlosses, jparams = _jax_run("transformer-data2-model2")
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=TOL)
    _close_params(r0["got"][-1], jparams, params)
    for got, want in zip(r0["got"], r0["want"]):
        _close_params(got, want, params)


def test_a_bucket_that_fails_to_issue_or_to_finish_raises_naming_it(monkeypatch):
    """No fallback: an all-reduce that fails to issue, or whose wait fails,
    raises, naming the bucket and its group."""
    group = Group(("data",), None, (0, 1), 0)
    monkeypatch.setattr(C, "_staged", lambda g, t: False)

    def refuse(*a, **k):
        raise RuntimeError("connection closed")

    monkeypatch.setattr(C.dist, "all_reduce", refuse)
    with pytest.raises(RuntimeError, match=r"gradient bucket 2 of 4: the all-reduce over "
                                           r"axes \('data',\) \(ranks \(0, 1\)\) failed to "
                                           r"issue: connection closed"):
        C.all_reduce_coalesced_async([torch.ones(3)], group, "gradient bucket 2 of 4")

    class Lost:
        def wait(self):
            raise RuntimeError("timed out")

    monkeypatch.setattr(C.dist, "all_reduce", lambda *a, **k: Lost())
    pending = C.all_reduce_coalesced_async([torch.ones(3)], group, "gradient bucket 0 of 4")
    with pytest.raises(RuntimeError, match=r"gradient bucket 0 of 4: the all-reduce over "
                                           r"axes \('data',\) \(ranks \(0, 1\)\) failed: "
                                           r"timed out"):
        pending.wait()
