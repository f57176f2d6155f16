"""Expert parallelism and the MoE routing ops over a sharded batch: the
port's ranks spawned over gloo on the CPU against the JAX package compiled
over the same mesh on as many host devices.

* the stacked MoE with ``expert_axis="data"`` on {data: 2} and {data: 4}
  at alpha 2.0 (tokens drop): routing is per shard at the local capacity
  in both packages, so the same tokens drop; losses and params after
  three SGD steps against the JAX EP run. At alpha 4.0 (no token drops)
  against the one-rank port, as ``tests/test_parallel.py`` holds the JAX
  package's EP run to one device. The expert weights are truly sharded
  and the all-to-alls engaged;
* the n-branch MoE at ``MoeConfig()``'s widths on {data: 2} (each rank
  gathers the batch and routes it whole): losses, params and the gate's
  and the experts' gradients after three steps against the JAX run;
* the balance term's gradient over the expert-parallel routing.

Tolerances (f32): 1e-5 of the largest |value|, and 2^-4 of each tensor's
largest update for the params (a ReLU input that rounds to the other
side of 0 moves a hidden unit's gradient by its share of the batch), as
``test_torch_parallel_training.py`` holds its runs; gradients 1e-4 of the
largest |gradient| of their tensor (sums over ranks in another order)."""

import functools

import numpy as np

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh as jmake_mesh
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.models.moe import MoeConfig as JMoeConfig
from flexflow_tpu.models.moe import build_moe_mnist as jbuild_moe_mnist
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.parallel.distributed import spawn

import _torch_mesh_workers as workers
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

STEPS = 3
SMALL = dict(input_dim=16, num_classes=4, num_exp=8, num_select=2, expert_hidden_size=32)
WIDE = {}  # MoeConfig()'s widths: 784 in, 5 experts, 64 hidden, 10 classes
TOL, UPDATE_TOL, GRAD_TOL = 1e-5, 2 ** -4, 1e-4


@functools.lru_cache(maxsize=None)
def _case(cfg_key, stacked: bool, batch: int, seed: int):
    """(params, batches, grad batch) from a seed, the shapes from the
    port's one-rank compile."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import MoeConfig, build_moe_mnist

    cfg = dict(cfg_key)
    ff = FFModel(FFConfig(batch_size=batch, device="cpu"))
    build_moe_mnist(ff, batch, MoeConfig(**cfg), stacked=stacked)
    ff.compile()
    rng = np.random.default_rng(seed)
    params = {op: {w: (rng.normal(size=tuple(t.shape))
                       * (0.1 if w == "bias" else np.sqrt(1.0 / t.shape[-2]))).astype(np.float32)
                   for w, t in ws.items()}
              for op, ws in ff.compiled.params.items()}
    d, classes = MoeConfig(**cfg).input_dim, MoeConfig(**cfg).num_classes

    def draw():
        return (rng.standard_normal((batch, d)).astype(np.float32),
                rng.integers(0, classes, size=(batch, 1)).astype(np.int32))
    return params, [draw() for _ in range(STEPS)], draw()


def _jax(mesh_shape, cfg, stacked, expert_axis, params, batches, grad_batch=None):
    """The JAX package over ``mesh_shape`` on as many host devices: three
    SGD steps from ``params``; (losses, params, grads of ``grad_batch``)."""
    batch = batches[0][1].shape[0]
    n = int(np.prod(list(mesh_shape.values())))
    jff = JFFModel(JFFConfig(batch_size=batch, ledger="off", audit_programs="off",
                             attribution="off"))
    jbuild_moe_mnist(jff, batch, JMoeConfig(**cfg), stacked=stacked, expert_axis=expert_axis)
    jff.compile(optimizer=JSGDOptimizer(lr=0.1),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                mesh=jmake_mesh(mesh_shape, jax.devices()[:n]))
    cm = jff.compiled
    cm.params = jax.tree_util.tree_map(lambda a, sh: jax.device_put(a, sh), params,
                                       cm.param_shardings)
    cm.opt_state = jff.optimizer.init_state(cm.params)
    losses = []
    for x, y in batches:
        cm.params, cm.opt_state, loss, _ = cm.train_step(cm.params, cm.opt_state,
                                                         jax.random.key(0), x, y)
        losses.append(float(loss))
    as_np = lambda t: {op: {w: np.asarray(a) for w, a in ws.items()} for op, ws in t.items()}  # noqa: E731
    grads = None
    if grad_batch is not None:
        grads = as_np(cm.grad_step(cm.params, jax.random.key(0), *grad_batch))
    return losses, as_np(cm.params), grads


def _close_params(got, want, start):
    for op, ws in want.items():
        for w, a in ws.items():
            atol = TOL * float(np.abs(a).max()) + UPDATE_TOL * float(np.abs(a - start[op][w]).max())
            np.testing.assert_allclose(got[op][w], a, rtol=TOL, atol=atol, err_msg=f"{op}.{w}")


def _close_grads(got, want):
    for op, ws in want.items():
        for w, a in ws.items():
            np.testing.assert_allclose(got[op][w], a, rtol=GRAD_TOL,
                                       atol=GRAD_TOL * float(np.abs(a).max()),
                                       err_msg=f"grad {op}.{w}")


def _ep_jobs(alpha: float, batch: int):
    cfg = dict(SMALL, alpha=alpha)
    params, batches, _ = _case(tuple(sorted(cfg.items())), True, batch, 3)
    return cfg, params, batches


def _check_ep(ranks, degree, cfg, params, batches, want_losses, want_params):
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    # the experts truly sharded, the all-to-alls engaged (one each way a
    # forward, and their backwards)
    assert all(r["expert_block"] == (cfg["num_exp"] // degree, cfg["input_dim"],
                                     cfg["expert_hidden_size"]) for r in ranks)
    assert all(r["calls"] == {"to_experts": STEPS, "to_tokens": STEPS} for r in ranks)
    np.testing.assert_allclose(ranks[0]["losses"], want_losses, rtol=TOL)
    _close_params(ranks[0]["params"], want_params, params)


def test_expert_parallel_matches_jax_with_drops_and_one_rank_without():
    """{data: 2} and {data: 4}, experts over ``data``: at alpha 2.0 against
    the JAX EP run (per-shard capacity, the same drops), at alpha 4.0
    against the one-rank stacked run."""
    batch = 32
    runs = {}
    todo = []
    for alpha in (2.0, 4.0):
        cfg, params, batches = _ep_jobs(alpha, batch)
        for deg in (2, 4):
            todo.append(("moe", ({"data": deg}, cfg, True, "data", params, batches)))
    # {data: 2} runs inside a world of 4 would not match the mesh: one
    # process group a world size
    for world in (2, 4):
        picked = [t for t in todo if t[1][0]["data"] == world]
        got = spawn(workers.jobs, world, picked)
        for i, t in enumerate(picked):
            runs[(t[1][1]["alpha"], world)] = [r[i] for r in got]
    for alpha in (2.0, 4.0):
        cfg, params, batches = _ep_jobs(alpha, batch)
        if alpha == 4.0:
            one = workers.moe(0, 1, None, cfg, True, None, params, batches)
        for deg in (2, 4):
            if alpha == 2.0:
                jl, jp, _ = _jax({"data": deg}, cfg, True, "data", params, batches)
                _check_ep(runs[(alpha, deg)], deg, cfg, params, batches, jl, jp)
            else:
                _check_ep(runs[(alpha, deg)], deg, cfg, params, batches, one["losses"],
                          one["params"])


def test_routing_over_a_gathered_batch_matches_jax_gradients():
    """The n-branch MoE at MoeConfig()'s widths on {data: 2}: each rank
    gathers the batch and routes it whole; the losses, params and the
    gate's and experts' gradients after three steps equal the JAX run's
    and the one-rank port's (a gathered batch whose backward summed the
    ranks' gradients would double them; one that kept only the rank's
    own rows' share would halve them)."""
    batch = 16
    params, batches, grad_batch = _case((), False, batch, 5)
    (ranks,) = zip(*spawn(workers.jobs, 2, [("moe", ({"data": 2}, WIDE, False, None, params,
                                                      batches, grad_batch))]))
    jl, jp, jg = _jax({"data": 2}, WIDE, False, None, params, batches, grad_batch)
    one = workers.moe(0, 1, None, WIDE, False, None, params, batches, grad_batch)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    for want_l, want_p, want_g in ((jl, jp, jg), (one["losses"], one["params"], one["grads"])):
        np.testing.assert_allclose(ranks[0]["losses"], want_l, rtol=TOL)
        _close_params(ranks[0]["params"], want_p, params)
        _close_grads(ranks[0]["grads"], want_g)
    assert ranks[0]["calls"] == {"to_experts": 0, "to_tokens": 0}


def test_balance_term_gradient_over_expert_parallel_routing():
    """lambda_bal alone (the model's loss zeroed by a zero head): the
    gate's gradient on {data: 2} with experts over ``data`` equals the
    one-rank gradient, the balance term read over the whole batch."""
    cfg = dict(SMALL, alpha=4.0, lambda_bal=0.5)
    params, batches, grad_batch = _case(tuple(sorted(cfg.items())), True, 32, 9)
    params = {op: {w: (np.zeros_like(a) if op == "moe_head" else a) for w, a in ws.items()}
              for op, ws in params.items()}
    (ranks,) = zip(*spawn(workers.jobs, 2, [("moe", ({"data": 2}, cfg, True, "data", params,
                                                      batches[:1], grad_batch))]))
    one = workers.moe(0, 1, None, cfg, True, None, params, batches[:1], grad_batch)
    jl, jp, jg = _jax({"data": 2}, cfg, True, "data", params, batches[:1], grad_batch)
    gate = ranks[0]["grads"]["moe_gate"]
    assert np.abs(gate["kernel"]).max() > 0
    for want in (one["grads"], jg):
        _close_grads({"moe_gate": gate}, {"moe_gate": want["moe_gate"]})
