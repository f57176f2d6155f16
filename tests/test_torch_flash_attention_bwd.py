"""The port's flash-attention backward against the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX
``_flash_bwd`` (its two Pallas kernels in the interpreter, fed the
residuals of ``_flash_fwd``) and through the port's
``flash_attention_bwd`` on CPU tensors, which is the kernels' plain
version; and through autograd of both packages' ``flash_attention``. Plain
computations that round where the card's bf16 kernels round, and where its
f32 kernels' split TF32 products round, are held against the JAX kernels
too, within the card's bf16 and f32 tolerances. The kernels
themselves are held against the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu.kernels import flash_attention as jfa
from flexflow_tpu.parallel.ring_attention import single_device_attention
from flexflow_tpu_torch import kernels as tkernels
from flexflow_tpu_torch.kernels import flash_attention as tfa
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

# f32 on both sides, the same products summed in another order: gradients
# of magnitude ~1 agree to a few f32 ulps
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 gradients: both sides compute in f32 from the same bf16 inputs and
# round to bf16 at the end; nearly equal f32 results may round one bf16
# ulp apart (2^-8 relative)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _bf16_round(arrays):
    """Round to bf16 once, so both packages see the same values."""
    return [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,d,causal", [
    (64, 64, 32, False), (64, 64, 64, True), (32, 64, 48, True),
    (64, 32, 32, True), (32, 64, 64, False)])
def test_plain_bwd_matches_jax_flash_bwd(sq, skv, d, causal, dtype):
    bh = 3
    q, k, v, g = _arrays([(bh, sq, d), (bh, skv, d), (bh, skv, d), (bh, sq, d)],
                         seed=sq + skv + d)
    if dtype == "bfloat16":
        q, k, v, g = _bf16_round([q, k, v, g])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    scale = d ** -0.5
    block_q = 32
    out, res = jfa._flash_fwd(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              causal, scale, block_q, True)
    want = jfa._flash_bwd(causal, scale, block_q, True, res, jnp.asarray(g, jdt))
    # the port gets the JAX forward's residuals, so only the backward differs
    _, _, _, jo, jlse = res
    tdt = getattr(torch, dtype)
    to_t = lambda a: torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).to(tdt)  # noqa: E731
    got = tfa.flash_attention_bwd(to_t(q), to_t(k), to_t(v), to_t(jo), to_t(g),
                                  torch.from_numpy(np.array(jlse)), causal, scale)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == tdt
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **tol,
                                   err_msg=name)


# Above head dim 256 the kernels cut the reductions over D across groups of
# warps (csrc/flash_attention_fwd_wide.cu, flash_attention_bwd_wide.cu): the
# forward and the dq kernel in two groups over balanced slices of D
WIDE_GROUPS = 2


def _dkv_slices(d):
    """(groups, slice width) of the dkv kernel above head dim 256: each
    group sums over its own output columns, two groups of 144 up to 288
    columns (design b), four of 80 or 128 up to 512 (design a); past 512
    four balanced slices (width None)."""
    if d <= 288:
        return 2, 144
    return 4, (80 if d <= 320 else 128 if d <= 512 else None)


def _scores(a, b, mm, groups=WIDE_GROUPS, width=None):
    """a b^T as the card's kernels sum it: over all of D up to head dim 256;
    above it, one partial a group of warps over its slice of D (``width``
    columns, by default D / groups rounded up to 16, the last group taking
    what is left), the partials summed group 0 first."""
    d = a.shape[-1]
    if d <= tfa.MAX_HEAD_DIM:
        return mm(a, b.transpose(-1, -2))
    width = width or -(-d // (16 * groups)) * 16
    parts = [mm(a[..., g * width:(g + 1) * width], b[..., g * width:(g + 1) * width]
                .transpose(-1, -2)) for g in range(groups) if g * width < d]
    s = parts[0]
    for part in parts[1:]:
        s = s + part
    return s


def _p_ds(q, k, v, o, g, lse, causal, scale, mm, groups, width=None):
    """P and dS of one backward kernel: S = Q K^T and dP = dO V^T summed as
    that kernel sums them, scale on S in f32, masked p exactly 0, delta =
    rowsum(dO * O) in f32."""
    s = _scores(q, k, mm, groups, width) * scale
    p = torch.exp(s - lse.transpose(-1, -2))
    if causal:
        p = torch.where(tfa._causal_keep(s.shape[-2], s.shape[-1], s.device), p, 0.0)
    dp = _scores(g, v, mm, groups, width)
    return p, p * (dp - torch.sum(g * o, dim=-1, keepdim=True))


def _bwd_as_the_bf16_kernels_round(q, k, v, o, g, lse, causal, scale):
    """The backward rounded where the bf16 tensor-core kernels round it
    (csrc/flash_attention_bwd.cu, and flash_attention_bwd_wide.cu above head
    dim 256, where each kernel sums S and dP from its groups' partials):
    bf16 inputs, S and dP in f32 with scale on S, P and dS rounded to bf16
    before the products that consume them, scale on dQ and dK at the end,
    the gradients rounded to bf16."""
    bf16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, g))
    args = (qf, kf, vf, of, gf, lse, causal, scale, torch.matmul)
    _, ds = _p_ds(*args, WIDE_GROUPS)
    dq = torch.matmul(bf16(ds), kf) * scale
    p, ds = _p_ds(*args, *_dkv_slices(q.shape[-1]))
    dk = torch.matmul(bf16(ds).transpose(-1, -2), qf) * scale
    dv = torch.matmul(bf16(p).transpose(-1, -2), gf)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


@pytest.mark.parametrize("d", [32, 64, 100, 264, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_kernels_rounding_is_within_the_card_tolerance(causal, d):
    """Rounding P and dS to bf16 before the second products, as the card's
    bf16 kernels do, keeps every gradient within chip_smoke.py's bf16
    tolerance (2^-7 of the gradient's largest element) of the JAX kernels;
    Skv 72 is not a multiple of the kernels' 64-row tiles. D 264 and 512
    sum S and dP from the groups' partials, as the kernels above head dim
    256 do."""
    bh, sq, skv = 2, 64, 72
    q, k, v, g = _bf16_round(_arrays([(bh, sq, d), (bh, skv, d), (bh, skv, d), (bh, sq, d)],
                                     seed=d + causal))
    scale = d ** -0.5
    _, res = jfa._flash_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            causal, scale, 32, True)
    want = jfa._flash_bwd(causal, scale, 32, True, res, jnp.asarray(g, jnp.bfloat16))
    _, _, _, jo, jlse = res
    to_t = lambda a: torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).to(torch.bfloat16)  # noqa: E731
    got = _bwd_as_the_bf16_kernels_round(to_t(q), to_t(k), to_t(v), to_t(jo), to_t(g),
                                         torch.from_numpy(np.array(jlse)), causal, scale)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(gt.float().numpy() - w).max()
        assert err <= 2 ** -7 * np.abs(w).max(), f"{name}: {err:.3g} of {np.abs(w).max():.3g}"
    if causal:  # keys no query sees get exactly 0
        assert not got[1][:, sq:].any() and not got[2][:, sq:].any()


def _tf32(t, half_ulp=0x1000):
    """f32 to TF32 (10 mantissa bits): to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds; with ``half_ulp=0``, truncated, as the
    tensor core reads an f32 operand."""
    i = t.contiguous().view(torch.int32)
    return ((i + half_ulp) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b on TF32 operands with f32 sums: one product (single-pass
    TF32, rounded) or the split kernels' three, small(a) big(b) + big(a)
    small(b) + big(a) big(b), with big rounded and small = x - big, which
    the tensor core truncates (flash_attention_tf32.cuh)."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return _tf32(a - ab, 0) @ bb + ab @ _tf32(b - bb, 0) + ab @ bb


def _bwd_as_the_f32_kernels_round(q, k, v, o, g, lse, causal, scale, passes):
    """The backward as the f32 tensor-core kernels compute it
    (csrc/flash_attention_bwd.cu, and flash_attention_bwd_wide.cu above head
    dim 256, where each kernel sums S and dP from its groups' partials;
    flash_attention_tf32.cuh): every product on TF32 operands, ``passes``
    products for each f32 one (three: split TF32), scale on S and at the
    end on dQ and dK, delta and the softmax in f32."""
    def mm(a, b):
        return _tf32_matmul(a, b, passes)

    args = (q, k, v, o, g, lse, causal, scale, mm)
    _, ds = _p_ds(*args, WIDE_GROUPS)
    dq = mm(ds, k) * scale
    p, ds = _p_ds(*args, *_dkv_slices(q.shape[-1]))
    return dq, mm(ds.transpose(-1, -2), q) * scale, mm(p.transpose(-1, -2), g)


@pytest.mark.parametrize("sq,skv,d,causal", [
    (64, 72, 32, False), (64, 72, 64, True), (32, 72, 64, False), (64, 72, 100, True),
    (64, 72, 264, False), (64, 72, 264, True), (64, 72, 512, False), (64, 72, 512, True)])
def test_f32_split_tf32_rounding_is_within_the_card_tolerance(sq, skv, d, causal):
    """Split TF32 products (three TF32 products for each f32 one, as the
    card's f32 kernels do them) keep every gradient within chip_smoke.py's
    f32 tolerance (1e-4 of the gradient's largest element) of the JAX
    kernels; one TF32 product each does not, so the tolerance catches a
    kernel that drops the correction products. Skv 72 is not a multiple
    of the kernels' tiles; D 264 and 512 sum S and dP from the groups'
    partials, as the kernels above head dim 256 do."""
    bh = 2
    q, k, v, g = _arrays([(bh, sq, d), (bh, skv, d), (bh, skv, d), (bh, sq, d)],
                         seed=d + skv + causal)
    scale = d ** -0.5
    _, res = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)), causal, scale, 32, True)
    want = [np.asarray(w) for w in jfa._flash_bwd(causal, scale, 32, True, res,
                                                  jnp.asarray(g))]
    _, _, _, jo, jlse = res
    args = [torch.from_numpy(np.array(a)) for a in (q, k, v, jo, g, jlse)]
    errs = {}
    for passes in (3, 1):
        got = _bwd_as_the_f32_kernels_round(*args, causal, scale, passes)
        errs[passes] = [np.abs(gt.numpy() - w).max() / np.abs(w).max()
                        for gt, w in zip(got, want)]
    assert max(errs[3]) <= 1e-4, errs[3]
    assert max(errs[1]) > 1e-4, errs[1]


def _grads_port(q, k, v, g, causal):
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*t, causal=causal, scale=q.shape[-1] ** -0.5)
    out.backward(torch.from_numpy(g))
    return [x.grad.numpy() for x in t]


def _grads_jax(fn, q, k, v, g, causal):
    scale = q.shape[-1] ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, causal, scale),
                     *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad_of_flash_attention(causal):
    q, k, v, g = _arrays([(2, 64, 2, 32)] * 4, seed=7)
    want = _grads_jax(lambda a, b, c, cz, s: jfa.flash_attention(a, b, c, causal=cz, scale=s),
                      q, k, v, g, causal)
    for name, got, w in zip(("dq", "dk", "dv"), _grads_port(q, k, v, g, causal), want):
        np.testing.assert_allclose(got, w, **F32_TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad_of_single_device_attention(causal):
    q, k, v, g = _arrays([(2, 32, 2, 48)] * 4, seed=8)
    want = _grads_jax(single_device_attention, q, k, v, g, causal)
    for name, got, w in zip(("dq", "dk", "dv"), _grads_port(q, k, v, g, causal), want):
        np.testing.assert_allclose(got, w, **F32_TOL, err_msg=name)


def test_plain_path_and_cpu_tensors_launch_nothing():
    tkernels.reset_launch_counts()
    q, k, v, g = _arrays([(1, 32, 2, 32)] * 4, seed=9)
    a = _grads_port(q, k, v, g, True)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tfa.flash_attention_reference(*t, causal=True).backward(torch.from_numpy(g))
    for x, y in zip(a, t):
        np.testing.assert_array_equal(x, y.grad.numpy())
    assert set(tkernels.launch_counts().values()) == {0}


def test_inference_mode_keeps_no_residuals():
    q = torch.randn(1, 16, 2, 32, requires_grad=True)
    with torch.inference_mode():
        out = tfa.flash_attention(q, q, q)
    assert not out.requires_grad and out.grad_fn is None


def test_bwd_wrapper_checks_lse():
    q = torch.zeros(2, 16, 32)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(q, q, q, q, q, torch.zeros(2, 16), False, 1.0)
