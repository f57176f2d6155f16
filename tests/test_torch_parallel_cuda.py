"""The mesh on the card. Two ranks sharing one card (gloo, collectives
staged through the host): ``sharded_flash_attention`` on each rank's
batch block and heads block launches the flash kernel and equals the
blocks of one ``attend`` over the whole tensors; under expert
parallelism on {data: 2} and {data: 4} the MoE kernels launch at each
rank's local shapes (its rows, the local capacity) and equal their plain
versions. On a machine with two cards each rank takes its own, over NCCL
(skipped with fewer). Marked
``cuda``; the file imports no JAX, so the card's machine runs it with
``--noconftest``."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.parallel.distributed import spawn

import _torch_mesh_workers as workers
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_flash_attention_on_two_ranks_sharing_the_card(card, causal, dtype):
    """Attention is independent across batch and heads: each rank's block
    through the kernels equals that block of the one-rank ``attend``
    (the same kernels on the same rows, so the same bits)."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards: the ranks would take NCCL, one card each")
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((4, 128, 8, 64)).astype(np.float32) for _ in range(3))
    tdt = getattr(torch, dtype)
    want = fa.attend(*(torch.from_numpy(a).cuda().to(tdt) for a in (q, k, v)), causal,
                     0.125, plain=False).float().cpu().numpy()
    got = spawn(workers.sharded_flash, 2, q, k, v, causal, dtype)
    for r, o in enumerate(got):
        assert o["backend"] == "gloo" and o["launches"] == 2
        np.testing.assert_array_equal(o["data"], want[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["model"], want[:, :, 4 * r:4 * r + 4])


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_kernels_at_each_expert_parallel_ranks_local_shape(card, world, dtype):
    """The MoE model's widths with 8 experts (batch 64, d 784, top-2, alpha
    2): each rank dispatches its 64/world rows at capacity 32/world with
    one row_gather launch, and combines them with one row_gather_sum
    launch, equal to the plain versions (both kernels are exact)."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards: the ranks would take NCCL, one card each")
    rng = np.random.default_rng(1)
    n, k, batch = 8, 2, 64
    x = rng.standard_normal((batch, 784)).astype(np.float32)
    assign = np.stack([rng.permutation(n)[:k] for _ in range(batch)]).astype(np.int32)
    gate = rng.random((batch, k)).astype(np.float32)
    capacity = int(np.ceil(2.0 * k / n * batch))
    got = spawn(workers.ep_kernels, world, x, assign, gate, n, capacity, dtype)
    for o in got:
        assert o["backend"] == "gloo" and o["local_rows"] == batch // world
        kern, plain = o["kernel"], o["plain"]
        assert kern["launches"]["row_gather"] == 1 and kern["launches"]["row_gather_sum"] == 1
        assert plain["launches"]["row_gather"] == plain["launches"]["row_gather_sum"] == 0
        assert kern["dispatch"].shape == (n, capacity // world, 784)
        assert kern["experts_shape"] == (n // world, capacity, 784)
        np.testing.assert_array_equal(kern["dispatch"], plain["dispatch"])
        np.testing.assert_array_equal(kern["combine"], plain["combine"])


@pytest.mark.cuda
def test_two_cards_take_nccl():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    got = spawn(workers.nccl_all_reduce, 2)
    assert [o["backend"] for o in got] == ["nccl", "nccl"]
    assert [o["sum"] for o in got] == [3.0, 3.0]
    assert [o["staged"] for o in got] == [0, 0]
