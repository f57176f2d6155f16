"""The port's flash-attention forward against the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX
``flash_attention`` in the Pallas interpreter (as tests/test_kernels.py
runs it on the CPU) and through the port's ``flash_attention`` on CPU
tensors, which is the kernel's plain version. A plain computation that
rounds where the card's bf16 kernel rounds is held against the JAX kernel
too, within the card's bf16 tolerance, and one that computes the products
as the card's f32 kernel does (split TF32) within the card's f32
tolerance. The kernel itself is held against
the plain version on the card by tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.kernels import flash_attention as jfa
from flexflow_tpu.parallel.ring_attention import single_device_attention
from flexflow_tpu_torch import kernels as tkernels
from flexflow_tpu_torch.kernels import flash_attention as tfa
from test_torch_flash_attention_bwd import _scores, _tf32_matmul
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

# f32 on both sides, same algorithm, different summation order: a few
# f32 ulps on outputs of magnitude ~1
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 outputs: both sides round the same f32 result to bf16, so they may
# differ by one bf16 ulp (2^-8 relative) where the f32 values straddle a
# rounding boundary
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


def _qkv(b=2, sq=64, skv=64, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, h, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, h, d)).astype(np.float32)
    return q, k, v


def _port(q, k, v, causal, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    out = tfa.flash_attention(*t, causal=causal, scale=q.shape[-1] ** -0.5)
    return out.float().numpy()


@pytest.mark.parametrize("sq,skv,causal", [
    (64, 64, False), (64, 64, True), (32, 64, True), (64, 32, True),
    (32, 64, False)])
def test_flash_attention_matches_jax_kernel(sq, skv, causal):
    q, k, v = _qkv(sq=sq, skv=skv)
    scale = q.shape[-1] ** -0.5
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, scale=scale)
    np.testing.assert_allclose(_port(q, k, v, causal), np.asarray(want),
                               **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_single_device_attention(causal):
    q, k, v = _qkv(seed=1)
    want = single_device_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, q.shape[-1] ** -0.5)
    np.testing.assert_allclose(_port(q, k, v, causal), np.asarray(want),
                               **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_out_and_lse_match_jax_flash_fwd(causal):
    rng = np.random.default_rng(2)
    bh, sq, skv, d = 4, 64, 48, 64
    q = rng.normal(size=(bh, sq, d)).astype(np.float32)
    k = rng.normal(size=(bh, skv, d)).astype(np.float32)
    v = rng.normal(size=(bh, skv, d)).astype(np.float32)
    scale = d ** -0.5
    want_out, res = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, scale, 32, True)
    want_lse = res[4]
    out, lse = tkernels.flash_attention.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale)
    assert lse.shape == (bh, 1, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_matches_jax_kernel(causal):
    q, k, v = _qkv(seed=3)
    # round the inputs to bf16 once, so both sides see the same values
    q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in (q, k, v))
    want = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                               causal=causal, scale=q.shape[-1] ** -0.5)
    got = _port(q, k, v, causal, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def _fwd_as_the_bf16_kernel_rounds(q, k, v, causal, scale):
    """The forward rounded where the bf16 tensor-core kernels round it
    (csrc/flash_attention_fwd.cu, and flash_attention_fwd_wide.cu above
    head dim 256): S in f32 from the bf16 Q and K (above 256 as the sum of
    two partial S) with scale on S, masked p exactly 0, l summed over the
    f32 p, P rounded to bf16 before P V, O / l in f32 rounded to bf16; lse
    in f32."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = _scores(qf, kf, torch.matmul) * scale
    keep = (tfa._causal_keep(s.shape[-2], s.shape[-1], s.device) if causal
            else torch.ones(s.shape[-2:], dtype=torch.bool))
    m = s.masked_fill(~keep, float("-inf")).amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(torch.bfloat16).float(), vf) / l
    return out.to(torch.bfloat16), (m + torch.log(l)).transpose(-1, -2)


@pytest.mark.parametrize("d", [32, 64, 100, 264, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_kernel_rounding_is_within_the_card_tolerance(causal, d):
    """Rounding P to bf16 before P V, as the card's bf16 kernels do, keeps
    the output within chip_smoke.py's bf16 tolerance of the JAX kernel: 2^-7
    of the largest output element, one bf16 ulp at the largest magnitude
    (an absolute bound fails here: under causal the first rows are single
    values of V, |O| in [2, 4), where one ulp is 2^-6). lse within 1e-4.
    Skv 72 is not a multiple of the kernels' 64-key tiles; D 264 and 512
    sum S from two partials, as the forward above head dim 256 does."""
    bh, sq, skv = 2, 64, 72
    rng = np.random.default_rng(d + causal)
    q, k, v = (np.array(jnp.asarray(rng.normal(size=(bh, s, d)).astype(np.float32),
                                    jnp.bfloat16).astype(jnp.float32))
               for s in (sq, skv, skv))
    scale = d ** -0.5
    want, res = jfa._flash_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                               causal, scale, 32, True)
    want = np.asarray(want.astype(jnp.float32))
    got, lse = _fwd_as_the_bf16_kernel_rounds(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), causal, scale)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 ** -7 * np.abs(want).max(), f"{err:.3g} of {np.abs(want).max():.3g}"
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]), rtol=0, atol=1e-4)


def _fwd_as_the_f32_kernel_rounds(q, k, v, causal, scale, passes):
    """The forward as the f32 tensor-core kernels compute it
    (csrc/flash_attention_fwd.cu, and flash_attention_fwd_wide.cu above
    head dim 256; flash_attention_tf32.cuh): Q scaled in f32 before its products, as
    ``_fwd_kernel`` scales it; S = (scale Q) K^T (above 256 the sum of two
    partial S) and P V on TF32 operands, ``passes`` products for each f32
    one (three: split TF32); masked p exactly 0, l summed over the f32 p,
    the softmax in f32; lse = m + log l."""
    s = _scores(q * scale, k, lambda a, b: _tf32_matmul(a, b, passes))
    keep = (tfa._causal_keep(s.shape[-2], s.shape[-1], s.device) if causal
            else torch.ones(s.shape[-2:], dtype=torch.bool))
    m = s.masked_fill(~keep, float("-inf")).amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return _tf32_matmul(p, v, passes) / l, (m + torch.log(l)).transpose(-1, -2)


@pytest.mark.parametrize("sq,skv,d,causal", [
    (64, 72, 32, False), (64, 72, 32, True), (32, 72, 64, False), (32, 72, 64, True),
    (96, 40, 64, True), (64, 40, 64, False), (64, 64, 264, False), (64, 64, 264, True),
    (64, 72, 512, False), (96, 40, 512, True)])
def test_f32_split_tf32_forward_is_within_the_card_tolerance(sq, skv, d, causal):
    """Split TF32 products (three TF32 products for each f32 one, as the
    card's f32 forward does them) keep the output within 1e-4 of its
    largest element, and lse within 1e-4, of the JAX kernel; one TF32
    product each does not, so the tolerance catches a kernel that drops the
    correction products. Skv 72 and 40 are not multiples of the kernels'
    key tiles, and Sq != Skv under the top-left causal mask; D 264 and 512
    sum S from two partials, as the forward above head dim 256 does."""
    bh = 2
    rng = np.random.default_rng(d + skv + causal)
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32) for s in (sq, skv, skv))
    scale = d ** -0.5
    want, res = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)), causal, scale, 32, True)
    want, want_lse = np.asarray(want), np.asarray(res[4])
    errs = {}
    for passes in (3, 1):
        out, lse = _fwd_as_the_f32_kernel_rounds(
            *(torch.from_numpy(a) for a in (q, k, v)), causal, scale, passes)
        errs[passes] = (np.abs(out.numpy() - want).max() / np.abs(want).max(),
                        np.abs(lse.numpy() - want_lse).max())
    assert errs[3][0] <= 1e-4 and errs[3][1] <= 1e-4, errs[3]
    assert errs[1][0] > 1e-4, errs[1]


@pytest.mark.parametrize("sq,skv", [(36, 64), (64, 20), (4, 4)])
def test_lengths_jax_rejects_are_rejected(sq, skv):
    q, k, v = _qkv(sq=sq, skv=skv)
    with pytest.raises(ValueError):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with pytest.raises(ValueError):
        _port(q, k, v, False)


@pytest.mark.parametrize("d", [16, 48, 80, 96, 256])
def test_any_head_dim_up_to_256_matches_jax_kernel(d):
    """The kernels are built for padded head dims 32/64/128/256 and take
    any D up to 256, as the JAX kernel takes any D."""
    q, k, v = _qkv(b=1, sq=32, skv=32, d=d, seed=d)
    scale = d ** -0.5
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, scale=scale)
    np.testing.assert_allclose(_port(q, k, v, True), np.asarray(want), **F32_TOL)


def test_unsupported_head_dim_is_rejected():
    """Head dims above 256 were once refused; now, as the JAX kernel does,
    the port takes them (on the card through flash_attention_fwd_wide.cu
    and flash_attention_bwd_wide.cu):
    D = 264 against the JAX kernel, and only D < 1 is rejected."""
    q, k, v = _qkv(b=1, sq=8, skv=8, d=264)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale=264 ** -0.5)
    np.testing.assert_allclose(_port(q, k, v, False), np.asarray(want), **F32_TOL)
    empty = [torch.from_numpy(np.ascontiguousarray(a[..., :0])) for a in (q, k, v)]
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(*empty, scale=1.0)


@pytest.mark.parametrize("d", [264, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dims_above_256_match_jax_forward_and_grads(d, causal):
    """Forward and autograd gradients at head dims past the one-pass
    kernels' widths, against the JAX kernel and jax.vjp of it."""
    import jax

    q, k, v = _qkv(b=1, sq=16, skv=16, h=2, d=d, seed=d)
    g = np.random.default_rng(d + 1).normal(size=q.shape).astype(np.float32)
    scale = d ** -0.5
    want, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal,
                                                            scale=scale),
                        *(jnp.asarray(a) for a in (q, k, v)))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*t, causal=causal, scale=scale)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    out.backward(torch.from_numpy(g))
    # gradients: the same products summed in another order (as
    # tests/test_torch_flash_attention_bwd.py holds them)
    for name, got, w in zip(("dq", "dk", "dv"), t, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_cpu_tensors_run_the_plain_version_uncounted():
    tkernels.reset_launch_counts()
    q, k, v = _qkv()
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = tfa.flash_attention(*t)
    want = tfa.flash_attention_reference(*t)
    assert torch.equal(got, want)
    assert tkernels.launch_counts()["flash_attention_fwd"] == 0

