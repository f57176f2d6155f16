"""The port's collectives (``flexflow_tpu_torch/parallel/collectives.py``)
on 2 and 4 gloo ranks spawned on the CPU, against the JAX package's
``shard_map`` versions on as many of the 8 host devices: the ring and
psum all-reduces, the expert all-to-all and its inverse. Then each
autograd pair's gradient of sum(w * f(x)) against its closed form
(float64, exact up to the order of a sum). Tolerance: f32 sums of n
blocks in another order, 1e-6 of the largest |value|."""

import numpy as np
import pytest

import jax

from flexflow_tpu.core.machine import make_mesh as jmake_mesh
from flexflow_tpu.parallel import collectives as jcol
from flexflow_tpu_torch.parallel.distributed import spawn

import _torch_mesh_workers as workers
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

C_ROWS, D = 8, 6  # a rank's block; chunks of dim 0 divide by 2 and 4
EXPERTS, CAP = 8, 8


def _inputs(n: int):
    rng = np.random.default_rng(n)
    blocks = rng.standard_normal((n, C_ROWS, D)).astype(np.float32)
    experts = rng.standard_normal((EXPERTS, CAP, D)).astype(np.float32)
    w = {"x": rng.standard_normal((n, C_ROWS, D)),
         "x_full": rng.standard_normal((n * C_ROWS, D)),
         "w": rng.standard_normal((n, n * C_ROWS, D))}
    return blocks, experts, w


def _close(got, want, tol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


# one process group a test: a module fixture would spawn again on every
# xdist worker that runs one of its tests
@pytest.mark.parametrize("n", [2, 4], ids=["2ranks", "4ranks"])
def test_collectives_match_jax_and_the_pairs_give_exact_gradients(n):
    blocks, experts, w = _inputs(n)
    out = spawn(workers.collectives, n, blocks, experts, w)
    _check_against_jax(n, blocks, experts, out)
    _check_pairs(n, w, out)
    assert all(o["modules"] == [] for o in out)  # the ranks loaded no JAX


def _check_against_jax(n, blocks, experts, out):
    mesh = jmake_mesh({"x": n}, jax.devices()[:n])
    ring = np.asarray(jcol.ring_all_reduce(jax.numpy.asarray(blocks.reshape(n * C_ROWS, D)),
                                           mesh, "x"))
    psum = np.asarray(jcol.psum_all_reduce(jax.numpy.asarray(blocks.reshape(n * C_ROWS, D)),
                                           mesh, "x"))
    to_e = np.asarray(jcol.expert_all_to_all(jax.numpy.asarray(experts), mesh, "x"))
    to_t = np.asarray(jcol.experts_to_tokens(jax.numpy.asarray(to_e), mesh, "x"))
    np.testing.assert_array_equal(to_t, experts)
    e, c = EXPERTS // n, CAP // n
    for r, o in enumerate(out):
        assert o["index"] == r
        _close(o["ring"], ring[r * C_ROWS:(r + 1) * C_ROWS])
        _close(o["psum"], psum)
        _close(o["ring"], blocks.sum(axis=0))
        np.testing.assert_array_equal(o["to_experts"], to_e[r * e:(r + 1) * e])
        np.testing.assert_array_equal(o["to_tokens"], experts[:, r * c:(r + 1) * c])


def _check_pairs(n, w, out):
    x, xf, ws = w["x"], w["x_full"], w["w"]
    c = C_ROWS
    chunk = c // n
    for r, o in enumerate(out):
        y, g = o["scatter_to"]
        _close(y, xf[r * c:(r + 1) * c], 1e-12)
        _close(g, np.concatenate([ws[j][:c] for j in range(n)]), 1e-12)
        y, g = o["gather_from"]
        _close(y, x.reshape(n * c, D), 1e-12)
        _close(g, ws[r][r * c:(r + 1) * c], 1e-12)
        y, g = o["reduce_from"]
        _close(y, x.sum(axis=0), 1e-12)
        _close(g, ws[r][:c], 1e-12)
        y, g = o["copy_to"]
        _close(y, x[r], 1e-12)
        _close(g, ws[:, :c].sum(axis=0), 1e-12)
        y, g = o["ring_shift"]
        _close(y, x[(r - 1) % n], 1e-12)
        _close(g, ws[(r + 1) % n][:c], 1e-12)
        y, g = o["all_to_all"]
        _close(y, np.concatenate([x[j][r * chunk:(r + 1) * chunk] for j in range(n)]), 1e-12)
        _close(g, np.concatenate([ws[j][:c][r * chunk:(r + 1) * chunk] for j in range(n)]),
               1e-12)
