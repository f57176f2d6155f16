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
from flexflow_tpu_torch.kernels import moe_kernels as tmk
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

# f32: the same f32 math in another summation order
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 outputs: both sides round nearly equal f32 results to bf16 and may
# land one bf16 ulp apart (2^-8 relative); the tensor-core forward also
# rounds P to bf16 before P V, which stays within this too (the CPU rounding
# model in tests/test_torch_flash_attention.py)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
# gradients, as a fraction of the largest gradient of the tensor: f32 sums
# of up to Skv (dq) or Sq (dk, dv) products in another order; bf16 one ulp
# of the rounded output, the tensor-core kernels also rounding P and dS to
# bf16 before the second products
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
# every padded width the kernels are built for, widths between them, and
# rows whose stride is not a multiple of 8 elements (the bf16 kernels'
# element-wise load path)
HEAD_DIMS = (32, 48, 64, 96, 128, 256, 20, 100)


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
    (128, 128, False), (128, 128, True), (200, 200, True), (72, 200, True),
    (200, 72, False), (200, 72, True)])
def test_flash_fwd_kernel_matches_plain(card, sq, skv, causal, dtype):
    """Ragged tiles (lengths not multiples of the kernel's 64-row tiles),
    Sq != Skv under causal, every head dim, both dtypes (bf16 on the tensor
    cores), out and lse; one launch a call."""
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


def _check_grads(got, want, dtype, what, floor=1e-30):
    """Each gradient within BWD_TOL of its largest element, or of ``floor``
    where that is larger (a gradient whose exact value is 0)."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, (what, name)
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all(), (what, name)
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        assert err <= BWD_TOL[dtype] * max(scale, floor), \
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_bwd_kernels_are_deterministic(card, causal, dtype):
    """Each kernel owns its output tiles (no atomics): two launches on the
    same inputs agree bit for bit, ragged and unaligned widths included, in
    both dtypes (f32: the split-TF32 kernels)."""
    rng = np.random.default_rng(9)
    for sq, skv, d in ((512, 512, 64), (200, 72, 100), (72, 200, 256), (37, 10, 20)):
        q, g = (_randn(rng, (4, sq, d), card, dtype) for _ in range(2))
        k, v = (_randn(rng, (4, skv, d), card, dtype) for _ in range(2))
        o, lse = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        first = tfa.flash_attention_bwd(q, k, v, o, g, lse, causal, d ** -0.5)
        second = tfa.flash_attention_bwd(q, k, v, o, g, lse, causal, d ** -0.5)
        for name, a, b in zip(("dq", "dk", "dv"), first, second):
            assert torch.equal(a, b), (sq, skv, d, name)


@pytest.mark.cuda
def test_f32_bwd_kernels_carry_a_nan_as_the_plain_version(card):
    """A NaN in q reaches the same gradient entries as in the plain
    version (its row of dq, every row of dk and dv of its B*H), and the
    rest stay within tolerance: the split-TF32 kernels keep a NaN's bits
    when they split it. Not causal: there the plain version's masked
    entries of a NaN row are NaN too, where the kernels set masked p to 0."""
    rng = np.random.default_rng(14)
    q, k, v, g = (_randn(rng, (2, 72, 64), card, torch.float32) for _ in range(4))
    q[1, 9, 5] = float("nan")
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, False, 0.125)
    got = tfa.flash_attention_bwd(q, k, v, o, g, lse, False, 0.125)
    want = tfa.flash_attention_bwd_reference(q, k, v, o, g, lse, False, 0.125)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        nan = torch.isnan(w)
        assert nan.any() and torch.equal(torch.isnan(a), nan), name
        err = (a[~nan] - w[~nan]).abs().max().item()
        assert err <= BWD_TOL[torch.float32] * w[~nan].abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_fwd_kernel_is_deterministic(card, causal, dtype):
    """The tensor-core forward owns its output tiles: two launches on the
    same inputs agree bit for bit, ragged and unaligned widths included, in
    both dtypes (f32: the split-TF32 kernel)."""
    rng = np.random.default_rng(10)
    for sq, skv, d in ((512, 512, 64), (200, 72, 100), (72, 200, 256), (200, 200, 20),
                       (37, 10, 30)):
        q = _randn(rng, (4, sq, d), card, dtype)
        k, v = (_randn(rng, (4, skv, d), card, dtype) for _ in range(2))
        first = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        second = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        for name, a, b in zip(("out", "lse"), first, second):
            assert torch.equal(a, b), (sq, skv, d, name)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [32, 64, 128, 256])
@pytest.mark.parametrize("bh,sq,skv,causal", [
    (3, 1, 1, False), (3, 1, 1, True), (3, 10, 10, True), (3, 37, 37, False),
    (3, 37, 37, True), (3, 10, 37, True), (3, 37, 10, True), (3, 37, 10, False),
    (3, 512, 200, True), (3, 200, 512, False), (65536 + 8, 16, 16, True)])
def test_f32_fwd_kernel_at_every_width_matches_plain(card, width, bh, sq, skv, causal):
    """The split-TF32 forward at each padded width it is built for, and at
    D = width - 3 (columns past D zero; rows of a stride no multiple of 4,
    loaded element by element): out within 1e-4 of its largest element and
    lse within 1e-4 of the plain version's, at lengths
    no multiple of 8 or of the key tiles, Sq != Skv under the top-left
    causal mask, and B*H above 65535; one launch a call."""
    rng = np.random.default_rng(width + sq + skv + causal)
    for d in (width, width - 3):
        q = _randn(rng, (bh, sq, d), card, torch.float32)
        k, v = (_randn(rng, (bh, skv, d), card, torch.float32) for _ in range(2))
        before = tkernels.launch_counts()["flash_attention_fwd"]
        out, lse = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        torch.cuda.synchronize()
        assert tkernels.launch_counts()["flash_attention_fwd"] == before + 1
        want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, causal, d ** -0.5)
        err = (out - want_out).abs().max().item()
        assert err <= 1e-4 * want_out.abs().max().item(), (d, err)
        assert (lse - want_lse).abs().max().item() <= 1e-4, d


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_f32_fwd_kernel_carries_a_nan_as_the_plain_version(card, causal):
    """A NaN in q makes its row of the output and its lse NaN, as in the
    plain version, and leaves every other row within tolerance: the
    split-TF32 kernel's split of a NaN stays NaN."""
    rng = np.random.default_rng(15)
    q, k, v = (_randn(rng, (2, 72, 64), card, torch.float32) for _ in range(3))
    q[1, 9, 5] = float("nan")
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, 0.125)
    want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, causal, 0.125)
    torch.cuda.synchronize()
    for name, a, w in (("out", out, want_out), ("lse", lse, want_lse)):
        nan = torch.isnan(w)
        assert nan.any() and torch.equal(torch.isnan(a), nan), name
        assert (a[~nan] - w[~nan]).abs().max().item() <= 1e-4 * max(
            1.0, w[~nan].abs().max().item()), name


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_heads_above_65535(card, dtype):
    """B*H folds into the grid's x dimension: no 65535 limit."""
    rng = np.random.default_rng(7)
    bh, s, d = 65536 + 8, 16, 32
    q, k, v, g = (_randn(rng, (bh, s, d), card, dtype) for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, True, d ** -0.5)
    want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, True, d ** -0.5)
    torch.testing.assert_close(out, want_out,
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    got = tfa.flash_attention_bwd(q, k, v, out, g, lse, True, d ** -0.5)
    want = tfa.flash_attention_bwd_reference(q, k, v, out, g, lse, True, d ** -0.5)
    _check_grads(got, want, dtype, "B*H > 65535")


@pytest.mark.cuda
def test_flash_fwd_rejects_what_the_kernel_does_not_take(card):
    q = torch.zeros((2, 64, 64), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention_fwd(q, q, q, False, 0.125)
    q = torch.zeros((2, 64, 0), device=card)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal", [(128, 128, False), (72, 200, True),
                                           (200, 72, False), (200, 72, True)])
def test_flash_kernels_above_head_dim_256_match_plain(card, sq, skv, causal, dtype):
    """The tensor-core kernels above head dim 256 (csrc/flash_attention_fwd_wide.cu,
    csrc/flash_attention_bwd_wide.cu): forward and both backward kernels at
    D 263 and 300 (rows of a stride no multiple of 8 or 4, loaded element by
    element), 264 and 512 (one column chunk: the dq kernel's two groups of
    144 and 256 columns, the dkv kernel's four of 80 and 128), 520 and 1032
    (several column chunks, each computing S and dP again), ragged lengths,
    Sq != Skv under causal, both dtypes; one launch of each, and under
    causal with Skv > Sq the keys no query sees get exactly 0."""
    rng = np.random.default_rng(8)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for d in (263, 264, 300, 512, 520, 1032):
        q, g = (_randn(rng, (3, sq, d), card, dtype) for _ in range(2))
        k, v = (_randn(rng, (3, skv, d), card, dtype) for _ in range(2))
        before = tkernels.launch_counts()
        out, lse = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        got = tfa.flash_attention_bwd(q, k, v, out, g, lse, causal, d ** -0.5)
        torch.cuda.synchronize()
        after = tkernels.launch_counts()
        for name in tkernels.FLASH_KERNELS:
            assert after[name] == before[name] + 1, name
        want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, causal, d ** -0.5)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want_out.float().cpu().numpy(), **tol,
                                   err_msg=f"head dim {d}")
        np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                                   **F32_TOL, err_msg=f"head dim {d}")
        want = tfa.flash_attention_bwd_reference(q, k, v, out, g, lse, causal, d ** -0.5)
        _check_grads(got, want, dtype, f"head dim {d}")
        if causal and skv > sq:  # keys no query sees get exactly 0
            assert not got[1][:, sq:].any() and not got[2][:, sq:].any(), d


# the backward above head dim 256 (csrc/flash_attention_bwd_wide.cu) by
# dtype: bf16 products in bf16, split TF32 products in f32
WIDE_BWD_KERNELS = {torch.float32: ("flash_bwd_dq_kernel_wide_tf32x3",
                                    "flash_bwd_dkv_kernel_wide_tf32x3"),
                    torch.bfloat16: ("flash_bwd_dq_kernel_wide_mma",
                                     "flash_bwd_dkv_kernel_wide_mma")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_bwd_kernels_are_deterministic(card, causal, dtype):
    """Each block owns its output tile and the groups of a strip sum their
    partial S and dP in one fixed order: two launches agree bit for bit."""
    rng = np.random.default_rng(20)
    for sq, skv, d in ((512, 512, 264), (512, 512, 512), (37, 10, 264), (200, 72, 1032)):
        q, g = (_randn(rng, (4, sq, d), card, dtype) for _ in range(2))
        k, v = (_randn(rng, (4, skv, d), card, dtype) for _ in range(2))
        o, lse = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        first = tfa.flash_attention_bwd(q, k, v, o, g, lse, causal, d ** -0.5)
        second = tfa.flash_attention_bwd(q, k, v, o, g, lse, causal, d ** -0.5)
        for name, a, b in zip(("dq", "dk", "dv"), first, second):
            assert torch.equal(a, b), (sq, skv, d, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_bwd_kernels_carry_a_nan_as_the_plain_version(card, dtype):
    """A NaN in one row of q reaches the same gradient entries as in the
    plain version (its row of dq, every row of dk and dv of its B*H: one
    group's partial S carries it into the sum every group takes), and the
    rest stay within tolerance. Not causal: there the plain version's masked
    entries of a NaN row are NaN too, where the kernels set masked p to 0."""
    rng = np.random.default_rng(21)
    q, k, v, g = (_randn(rng, (2, 72, 264), card, dtype) for _ in range(4))
    q[1, 9, 200] = float("nan")
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, False, 264 ** -0.5)
    got = tfa.flash_attention_bwd(q, k, v, o, g, lse, False, 264 ** -0.5)
    want = tfa.flash_attention_bwd_reference(q, k, v, o, g, lse, False, 264 ** -0.5)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.float(), w.float()
        nan = torch.isnan(w)
        assert nan.any() and torch.equal(torch.isnan(a), nan), name
        err = (a[~nan] - w[~nan]).abs().max().item()
        assert err <= BWD_TOL[dtype] * w[~nan].abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_bwd_at_batch_heads_above_65535(card, dtype):
    """B*H folds into the grid's x dimension above head dim 256 too."""
    rng = np.random.default_rng(22)
    bh, s, d = 65536 + 8, 8, 264
    q, k, v, g = (_randn(rng, (bh, s, d), card, dtype) for _ in range(4))
    o, lse = tfa.flash_attention_fwd(q, k, v, True, d ** -0.5)
    got = tfa.flash_attention_bwd(q, k, v, o, g, lse, True, d ** -0.5)
    want = tfa.flash_attention_bwd_reference(q, k, v, o, g, lse, True, d ** -0.5)
    _check_grads(got, want, dtype, "B*H > 65535, D 264")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_bwd_runs_the_dtype_tensor_core_kernels(card, dtype):
    """The profiler's kernel names show that a backward at D 264 and at D
    1032 ran the dtype's tensor-core dq and dkv kernels above head dim 256
    and no other backward kernel."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(23)
    for d in (264, 1032):
        q, k, v, g = (_randn(rng, (2, 64, d), card, dtype) for _ in range(4))
        o, lse = tfa.flash_attention_fwd(q, k, v, True, d ** -0.5)
        tfa.flash_attention_bwd(q, k, v, o, g, lse, True, d ** -0.5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tfa.flash_attention_bwd(q, k, v, o, g, lse, True, d ** -0.5)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if "flash_bwd" in e.key}
        want = WIDE_BWD_KERNELS[dtype]
        assert all(any(w in n for n in names) for w in want), (d, names)
        assert all(any(w in n for w in want) for n in names), (d, names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_attend_above_head_dim_256_matches_plain_path(card, dtype):
    """Gradients of the attention op's entry at D 264 (Sq 40, Skv 72,
    causal) through the kernels against the plain versions' path."""
    rng = np.random.default_rng(24)
    q, g = (_randn(rng, (2, 40, 2, 264), card, dtype) for _ in range(2))
    k, v = (_randn(rng, (2, 72, 2, 264), card, dtype) for _ in range(2))
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        tfa.attend(*leaves, causal=True, scale=None, plain=plain).backward(g)
        grads.append([t.grad for t in leaves])
    _check_grads(*grads, dtype, "attend, D 264")


# the forward above head dim 256 (csrc/flash_attention_fwd_wide.cu) by
# dtype: bf16 products in bf16, split TF32 products in f32
WIDE_FWD_KERNEL = {torch.float32: "flash_fwd_kernel_wide_tf32x3",
                   torch.bfloat16: "flash_fwd_kernel_wide_mma"}


def _check_fwd(out, lse, want_out, want_lse, dtype, what):
    """out within chip_smoke.py's forward tolerance of the plain version (f32
    1e-4 absolute, bf16 2^-7 of the largest |out|) and lse within 1e-4."""
    assert out.dtype == dtype and out.shape == want_out.shape, what
    out, want_out = out.float(), want_out.float()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all(), what
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7 * want_out.abs().max().item()
    err = (out - want_out).abs().max().item()
    assert err <= tol, f"{what}: out err {err:.3g} (tol {tol:.3g})"
    err = (lse - want_lse).abs().max().item()
    assert err <= 1e-4, f"{what}: lse err {err:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal", [
    (128, 128, False), (72, 200, True), (200, 72, False), (200, 72, True), (37, 10, True)])
def test_wide_fwd_kernel_matches_plain(card, sq, skv, causal, dtype):
    """The tensor-core forward above head dim 256: D 263 and 300 (rows of
    a stride no multiple of 8 or 4, loaded element by element; 300 takes
    the 192-column groups), 264 and 512 (two groups of 144 and of 256
    columns) and 1032 (past one block's 512 columns: three column chunks,
    each computing S again), ragged Sq != Skv, causal and not; one launch a
    call."""
    rng = np.random.default_rng(16)
    for d in (263, 264, 300, 512, 1032):
        q = _randn(rng, (3, sq, d), card, dtype)
        k, v = (_randn(rng, (3, skv, d), card, dtype) for _ in range(2))
        before = tkernels.launch_counts()["flash_attention_fwd"]
        out, lse = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        torch.cuda.synchronize()
        assert tkernels.launch_counts()["flash_attention_fwd"] == before + 1
        want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, causal, d ** -0.5)
        _check_fwd(out, lse, want_out, want_lse, dtype, f"head dim {d}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_fwd_kernel_is_deterministic(card, causal, dtype):
    """Each block owns its output tile and its groups sum their partial S in
    one fixed order: two launches agree bit for bit, out and lse."""
    rng = np.random.default_rng(17)
    for sq, skv, d in ((512, 512, 264), (512, 512, 512), (37, 10, 264), (200, 72, 1032)):
        q = _randn(rng, (4, sq, d), card, dtype)
        k, v = (_randn(rng, (4, skv, d), card, dtype) for _ in range(2))
        first = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        second = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        for name, a, b in zip(("out", "lse"), first, second):
            assert torch.equal(a, b), (sq, skv, d, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_fwd_kernel_carries_a_nan_as_the_plain_version(card, causal, dtype):
    """A NaN in one row of q makes that row of the output and its lse NaN,
    as in the plain version (the partial S of one group carries it into the
    sum every group takes), and leaves every other row within tolerance."""
    rng = np.random.default_rng(18)
    q, k, v = (_randn(rng, (2, 72, 264), card, dtype) for _ in range(3))
    q[1, 9, 200] = float("nan")
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, 264 ** -0.5)
    want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, causal, 264 ** -0.5)
    torch.cuda.synchronize()
    for name, a, w in (("out", out, want_out), ("lse", lse, want_lse)):
        a, w = a.float(), w.float()
        nan = torch.isnan(w)
        assert nan.any() and torch.equal(torch.isnan(a), nan), name
    keep = ~torch.isnan(want_lse)[..., 0, :, None].expand_as(want_out)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7 * want_out[keep].float().abs().max()
    assert (out[keep].float() - want_out[keep].float()).abs().max() <= tol
    assert (lse - want_lse)[~torch.isnan(want_lse)].abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_fwd_runs_the_dtype_tensor_core_kernel(card, dtype):
    """The profiler's kernel names show that a forward at D 264 ran the
    dtype's tensor-core wide forward and no other forward kernel."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(19)
    q, k, v = (_randn(rng, (2, 64, 264), card, dtype) for _ in range(3))
    tfa.flash_attention_fwd(q, k, v, True, 264 ** -0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tfa.flash_attention_fwd(q, k, v, True, 264 ** -0.5)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if "flash_fwd" in e.key}
    assert names and all(WIDE_FWD_KERNEL[dtype] in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal", [
    (1, 1, False), (1, 1, True), (10, 10, False), (10, 10, True), (37, 37, True),
    (10, 37, False), (10, 37, True), (37, 10, False), (37, 10, True)])
def test_flash_kernels_at_any_length_match_plain(card, sq, skv, causal, dtype):
    """Lengths no multiple of 8, which the attention op takes: forward and
    both backward kernels against their plain versions, Sq != Skv under the
    top-left causal mask, widths 32 to 256 and one of the kernels chunked
    over D (264); one launch of each. A wrong relabelling of the split-TF32
    kernels' accumulator fragments shows here, where tiles are ragged."""
    rng = np.random.default_rng(12)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for d in (32, 64, 100, 128, 256, 264):
        q, g = (_randn(rng, (5, sq, d), card, dtype) for _ in range(2))
        k, v = (_randn(rng, (5, skv, d), card, dtype) for _ in range(2))
        before = tkernels.launch_counts()
        out, lse = tfa.flash_attention_fwd(q, k, v, causal, d ** -0.5)
        got = tfa.flash_attention_bwd(q, k, v, out, g, lse, causal, d ** -0.5)
        torch.cuda.synchronize()
        after = tkernels.launch_counts()
        for name in tkernels.FLASH_KERNELS:
            assert after[name] == before[name] + 1, name
        want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, causal, d ** -0.5)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want_out.float().cpu().numpy(), **tol,
                                   err_msg=f"head dim {d}")
        np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                                   **F32_TOL, err_msg=f"head dim {d}")
        want = tfa.flash_attention_bwd_reference(q, k, v, out, g, lse, causal, d ** -0.5)
        # one key: P = 1 and dP = delta, so dS, dq and dk are exactly 0 and
        # both sides give rounding noise, held against dv's scale
        floor = want[2].float().abs().max().item() if skv == 1 else 1e-30
        _check_grads(got, want, dtype, f"head dim {d}", floor)
        if causal and skv > sq:  # keys no query sees get exactly 0
            assert not got[1][:, sq:].any() and not got[2][:, sq:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_multihead_attention_op_at_length_10_matches_plain_path(card, causal):
    """The attention op at S = 10 (no multiple of 8) on the card, in f32:
    the kernels against the plain versions' path, forward (within 1e-4 of
    its largest element) and every gradient (within 1e-4 of the op's
    largest gradient): the kernels' f32 sums in another order; each kernel
    launched once a step."""
    from flexflow_tpu_torch.core.layer import Layer
    from flexflow_tpu_torch.core.op import LowerCtx, create_op
    from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
    from flexflow_tpu_torch.ffconst import OpType
    import flexflow_tpu_torch.ops  # noqa: F401  (registers the port's ops)

    rng = np.random.default_rng(13)
    x = _randn(rng, (2, 10, 64), card, torch.float32)
    op = create_op(Layer(OpType.MULTIHEAD_ATTENTION, name="t",
                         attrs=dict(embed_dim=64, num_heads=2, causal=causal)),
                   [ParallelTensorShape.unpartitioned(tuple(x.shape))] * 3)
    w = {s.name: _randn(rng, s.shape, card, torch.float32) * 0.2 for s in op.weight_specs()}
    cot = _randn(rng, (2, 10, 64), card, torch.float32)
    runs = []
    for plain in (False, True):
        xs = [x.clone().requires_grad_(True) for _ in range(3)]
        ws = {n: t.clone().requires_grad_(True) for n, t in w.items()}
        before = tkernels.launch_counts()
        out = op.forward(LowerCtx(training=True, plain_kernels=plain), xs, ws)[0]
        out.backward(cot)
        torch.cuda.synchronize()
        after = tkernels.launch_counts()
        for name in tkernels.FLASH_KERNELS:
            assert after[name] - before[name] == (0 if plain else 1), (plain, name)
        runs.append([out.detach()] + [t.grad for t in xs] + [ws[n].grad for n in w])
    names = ["out", "x0", "x1", "x2"] + list(w)
    # gradients against the largest gradient of the op: bk's exact
    # gradient is 0 (the softmax cancels q.bk), so both paths give rounding
    # noise that no scale of its own can measure
    grad_scale = max(t.abs().max().item() for t in runs[1][1:])
    for name, a, b in zip(names, *runs):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), name
        scale = b.abs().max().item() if name == "out" else grad_scale
        assert (a - b).abs().max().item() <= 1e-4 * scale, name


# ---- MoE row movement -------------------------------------------------------
# Both kernels round each product, and each sum of products in the order
# j = 0..k-1, as their plain versions do: they agree bit for bit.


def _moe_inputs(rng, card, dtype, r_in, d):
    x = _randn(rng, (r_in, d), card, dtype)
    x[1] = float("inf")  # a non-finite row: a 0 scale must still give NaN
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 13, 784, 4096])  # ragged, scalar and vector paths
def test_row_gather_kernel_matches_plain(card, d, dtype):
    rng = np.random.default_rng(d)
    x = _moe_inputs(rng, card, dtype, 37, d)
    idx = torch.from_numpy(rng.integers(0, 37, size=300).astype(np.int32)).to(card)
    scale = torch.from_numpy(rng.normal(size=300).astype(np.float32)).to(card)
    scale[::7] = 0.0  # scale-0 rows keep the multiply
    idx[:3] = 1
    before = tkernels.launch_counts()["row_gather"]
    got = tmk.row_gather(x, idx, scale)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["row_gather"] == before + 1
    want = tmk.row_gather_reference(x, idx, scale)
    assert got.dtype == dtype and got.shape == (300, d)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    # a strided source row view takes the scalar path
    xs = x[:, :d - 1] if d > 1 else x
    torch.testing.assert_close(tmk.row_gather(xs, idx, scale),
                               tmk.row_gather_reference(xs, idx, scale),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,k", [(13, 1), (784, 1), (784, 2), (4096, 2), (40, 5)])
def test_row_gather_sum_kernel_matches_plain(card, d, k, dtype):
    rng = np.random.default_rng(d + k)
    x = _moe_inputs(rng, card, dtype, 50, d)
    idx = torch.from_numpy(rng.integers(0, 50, size=(64, k)).astype(np.int32)).to(card)
    w = torch.from_numpy(rng.normal(size=(64, k)).astype(np.float32)).to(card)
    w[5] = 0.0
    before = tkernels.launch_counts()["row_gather_sum"]
    got = tmk.row_gather_sum(x, idx, w)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["row_gather_sum"] == before + 1
    assert got.dtype == dtype and got.shape == (64, d)
    torch.testing.assert_close(got, tmk.row_gather_sum_reference(x, idx, w),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,d,k", [(65, 784, 2), (1, 784, 2), (33, 1000, 3), (65, 13, 2),
                                    (129, 4096, 1), (7, 100, 9)])
def test_row_gather_sum_kernel_across_block_edges(card, nb, d, k, dtype):
    """One thread a (row, vector) pair: output rows and vectors that end
    inside a block (nb 65 at d 784 is 65 x 196 f32 vectors, 49.8 blocks of
    256), one row, k of 1 to 9 (unrolled for 1 and 2, in groups of four
    beyond) and the scalar path (d 13, and d 100 in bf16), bit for bit."""
    rng = np.random.default_rng(nb + d + k)
    x = _moe_inputs(rng, card, dtype, 70, d)
    idx = torch.from_numpy(rng.integers(0, 70, size=(nb, k)).astype(np.int32)).to(card)
    w = torch.from_numpy(rng.normal(size=(nb, k)).astype(np.float32)).to(card)
    w[0, 0] = 0.0
    idx[-1, -1] = 1  # the non-finite row, in the last output row
    before = tkernels.launch_counts()["row_gather_sum"]
    got = tmk.row_gather_sum(x, idx, w)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["row_gather_sum"] == before + 1
    assert got.dtype == dtype and got.shape == (nb, d)
    torch.testing.assert_close(got, tmk.row_gather_sum_reference(x, idx, w),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_moe_kernels_out_of_range_contract(card):
    """The plain versions raise on an index outside [0, R_in) (checked on
    CPU copies: on the card an index_select would assert on the device);
    the kernels read nothing there and give a zero row."""
    x = torch.ones((4, 32), device=card)
    bad = torch.tensor([0, 4, -1], dtype=torch.int32, device=card)
    with pytest.raises(IndexError):
        tmk.row_gather_reference(x.cpu(), bad.cpu(), torch.ones(3))
    with pytest.raises(IndexError):
        tmk.row_gather_sum_reference(x.cpu(), bad.cpu()[None], torch.ones(1, 3))
    got = tmk.row_gather(x, bad, torch.ones(3, device=card))
    torch.cuda.synchronize()
    assert got[0].eq(1).all() and not got[1:].any()
    got = tmk.row_gather_sum(x, bad[None], torch.ones(1, 3, device=card))
    assert got.eq(1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_and_combine_backward_through_the_kernels(card, dtype):
    """moe_dispatch -> moe_combine with x and the gate weights requiring
    gradients: the dispatch's backward (row_gather_sum) and the combine's
    (two row_gather) against the plain path, with drops."""
    rng = np.random.default_rng(11)
    b, d, n, k, cap = 64, 784, 5, 2, 20
    assign = torch.from_numpy(np.stack([rng.permutation(n)[:k] for _ in range(b)])
                              .astype(np.int32)).to(card)
    x0 = _randn(rng, (b, d), card, dtype)
    g0 = torch.from_numpy(rng.uniform(0.1, 1, size=(b, k)).astype(np.float32)).to(card)
    cot = _randn(rng, (b, d), card, dtype)
    grads = []
    for plain in (False, True):
        x, gw = x0.clone().requires_grad_(True), g0.clone().requires_grad_(True)
        rows = tmk.moe_dispatch(x, assign, n, cap, plain=plain)
        out = tmk.moe_combine(rows * 2, assign, gw, plain=plain)
        before = tkernels.launch_counts()
        out.backward(cot)
        torch.cuda.synchronize()
        after = tkernels.launch_counts()
        if not plain:
            assert after["row_gather_sum"] - before["row_gather_sum"] == 1
            assert after["row_gather"] - before["row_gather"] == 2
        grads.append((out.detach(), x.grad, gw.grad))
    for name, a, w in zip(("out", "dx", "dgate"), *grads):
        torch.testing.assert_close(a, w, rtol=0, atol=0, msg=name)
