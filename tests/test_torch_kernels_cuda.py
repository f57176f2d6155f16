"""The port's Hopper kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import kernels as tkernels
from flexflow_tpu_torch.kernels import flash_attention as tfa

# f32: the same f32 math in another summation order
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 outputs: both sides round nearly equal f32 results to bf16 and may
# land one bf16 ulp apart (2^-8 relative)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
# gradients, as a fraction of the largest gradient of the tensor: f32 sums
# of up to Skv (dq) or Sq (dk, dv) products in another order; bf16 one ulp
# of the rounded output
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
# every padded width the kernels are built for, and widths between them
HEAD_DIMS = (32, 48, 64, 96, 128, 256)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, device, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal", [
    (128, 128, False), (128, 128, True), (72, 200, True), (200, 72, False),
    (200, 72, True)])
def test_flash_fwd_kernel_matches_plain(card, sq, skv, causal, dtype):
    """Ragged tiles (lengths not multiples of the kernel's 64-row tiles),
    every head dim, both dtypes, out and lse."""
    rng = np.random.default_rng(4)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for d in HEAD_DIMS:
        q, k, v = (_randn(rng, (6, s, d), card, dtype) for s in (sq, skv, skv))
        before = tkernels.launch_counts()["flash_attention_fwd"]
        out, lse = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        torch.cuda.synchronize()
        assert tkernels.launch_counts()["flash_attention_fwd"] == before + 1
        assert out.dtype == dtype and lse.shape == (6, 1, sq)
        want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, causal,
                                                               d ** -0.5)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want_out.float().cpu().numpy(), **tol,
                                   err_msg=f"head dim {d}")
        np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                                   **F32_TOL, err_msg=f"head dim {d}")


def _check_grads(got, want, dtype, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, (what, name)
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all(), (what, name)
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        assert err <= BWD_TOL[dtype] * max(scale, 1e-30), \
            f"{what} {name}: max err {err:.3g} of largest {scale:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal", [
    (128, 128, False), (128, 128, True), (200, 200, True), (72, 200, True),
    (200, 72, False), (200, 72, True)])
def test_flash_bwd_kernels_match_plain(card, sq, skv, causal, dtype):
    """dq and dkv against the plain backward: ragged tiles, Sq != Skv under
    causal, every head dim, both dtypes; one launch each."""
    rng = np.random.default_rng(5)
    for d in HEAD_DIMS:
        q, g = (_randn(rng, (6, sq, d), card, dtype) for _ in range(2))
        k, v = (_randn(rng, (6, skv, d), card, dtype) for _ in range(2))
        o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal, d ** -0.5)
        before = tkernels.launch_counts()
        got = tfa.flash_attention_bwd(q, k, v, o, g, lse, causal, d ** -0.5)
        torch.cuda.synchronize()
        after = tkernels.launch_counts()
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            assert after[name] == before[name] + 1
        want = tfa.flash_attention_bwd_reference(q, k, v, o, g, lse, causal, d ** -0.5)
        _check_grads(got, want, dtype, f"head dim {d}")
        if causal and skv > sq:  # keys no query sees get exactly 0
            assert not got[1][:, sq:].any() and not got[2][:, sq:].any()


@pytest.mark.cuda
def test_autograd_through_the_kernels_matches_plain_path(card):
    rng = np.random.default_rng(6)
    q, k, v, g = (_randn(rng, (2, 128, 4, 64), card, torch.float32) for _ in range(4))
    grads = []
    for fn in (tfa.flash_attention, tfa.flash_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves, causal=True).backward(g)
        grads.append([t.grad for t in leaves])
    _check_grads(*grads, torch.float32, "autograd")


@pytest.mark.cuda
def test_batch_heads_above_65535(card):
    """B*H folds into the grid's x dimension: no 65535 limit."""
    rng = np.random.default_rng(7)
    bh, s, d = 65536 + 8, 16, 32
    q, k, v, g = (_randn(rng, (bh, s, d), card, torch.float32) for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, True, d ** -0.5)
    want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, True, d ** -0.5)
    torch.testing.assert_close(out, want_out, **F32_TOL)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    got = tfa.flash_attention_bwd(q, k, v, out, g, lse, True, d ** -0.5)
    want = tfa.flash_attention_bwd_reference(q, k, v, out, g, lse, True, d ** -0.5)
    _check_grads(got, want, torch.float32, "B*H > 65535")


@pytest.mark.cuda
def test_flash_fwd_rejects_what_the_kernel_does_not_take(card):
    q = torch.zeros((2, 64, 64), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention_fwd(q, q, q, False, 0.125)
    q = torch.zeros((2, 64, 264), device=card)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(q, q, q, False, 0.125)
    q = torch.zeros((2, 64, 128), device=card)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q, q, q, False, 0.125)
    q = torch.zeros((2, 64, 64), device=card)
    lse = torch.zeros((2, 1, 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bwd(q, q, q, q, q.transpose(1, 2).contiguous()
                                .transpose(1, 2), lse, False, 0.125)
