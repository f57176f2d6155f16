"""The mesh on the card. Two ranks sharing one card (gloo, collectives
staged through the host): ``sharded_flash_attention`` on each rank's
batch block and heads block launches the flash kernel and equals the
blocks of one ``attend`` over the whole tensors. On a machine with two
cards each rank takes its own, over NCCL (skipped with fewer). Marked
``cuda``; the file imports no JAX, so the card's machine runs it with
``--noconftest``."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.parallel.distributed import spawn

import _torch_mesh_workers as workers


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
def test_two_cards_take_nccl():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    got = spawn(workers.nccl_all_reduce, 2)
    assert [o["backend"] for o in got] == ["nccl", "nccl"]
    assert [o["sum"] for o in got] == [3.0, 3.0]
    assert [o["staged"] for o in got] == [0, 0]
