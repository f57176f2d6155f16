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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
    for d in tfa.HEAD_DIMS:
        q, k, v = (torch.from_numpy(rng.normal(size=(6, s, d)).astype(np.float32))
                   .to(card, dtype) for s in (sq, skv, skv))
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


@pytest.mark.cuda
def test_flash_fwd_rejects_what_the_kernel_does_not_take(card):
    q = torch.zeros((2, 64, 64), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention_fwd(q, q, q, False, 0.125)
    q = torch.zeros((2, 64, 48), device=card)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(q, q, q, False, 0.125)
    q = torch.zeros((2, 64, 128), device=card)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q, q, q, False, 0.125)
