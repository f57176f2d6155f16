"""ZeRO-1 (``FFConfig.zero_optimizer``), mirroring
``tests/test_zero_optimizer.py``: the port's ranks spawned over gloo on
the CPU. Each optimizer-state array is sharded over ``data`` on its
weight's first unsharded dim the data degree divides, so a rank holds
about 1/dp of the state; SGD with momentum and Adam give the replicated
run's params exactly (each rank updates its slice with the same
arithmetic, then the slices are all-gathered), through ``train_step`` and
the manual ``backward``/``update`` verbs; it composes with tensor
parallelism on {data: 2, model: 2}, where a kernel's state carries both
axes; and the ZeRO run matches the JAX package's ZeRO run on the same
mesh (1e-5 of the largest |value| and 2^-4 of each tensor's largest
update, as ``test_torch_parallel_training.py``)."""

import numpy as np

import jax

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.core.machine import make_mesh as jmake_mesh
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.parallel.distributed import spawn

import _torch_mesh_workers as workers
from test_torch_parallel_training import SHAPE, _case
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

MSE = "MEAN_SQUARED_ERROR_AVG_REDUCE"
TOL, UPDATE_TOL = 1e-5, 2 ** -4


def _jobs(mesh_shape, kw, optimizers):
    params, batches = _case("transformer")
    return [("zero", ("transformer", mesh_shape, SHAPE, kw, params, batches, MSE, opt, z))
            for opt in optimizers for z in (True, False)]


def _equal(a, b):
    assert a["losses"] == b["losses"]
    for op, ws in b["params"].items():
        for w, t in ws.items():
            assert np.array_equal(a["params"][op][w], t), f"{op}.{w}"


def _check_pairs(ranks, n_opts, dp):
    for i in range(n_opts):
        on, off = ranks[0][2 * i], ranks[0][2 * i + 1]
        _equal(on, off)
        for r in ranks:
            _equal(r[2 * i], on)
        # the state is sharded over data: 1/dp of each sharded array
        assert on["zero_dims"] and not off["zero_dims"]
        for key, d in on["zero_dims"].items():
            local, weight = on["state_shapes"][".".join(key)]
            assert local[d] * dp == weight[d]
        assert on["state_bytes"] < 0.6 * off["state_bytes"]


def test_zero_shards_the_state_and_matches_replicated_training():
    """{data: 2}, SGD with momentum and Adam: ZeRO on equals ZeRO off bit
    for bit (three train steps, then backward and update), each rank holds
    about half the state."""
    ranks = spawn(workers.jobs, 2, _jobs({"data": 2}, {}, ("sgd_momentum", "adam")))
    _check_pairs(ranks, 2, 2)


def test_zero_composes_with_tensor_parallelism_and_matches_jax():
    """{data: 2, model: 2} with tp_axis "model", Adam and SGD with
    momentum: a kernel sharded over ``model`` keeps that axis and shards
    its state over ``data`` on another dim; ZeRO equals replicated bit for
    bit, and the SGD run the JAX package's ZeRO run on the same mesh (Adam
    turns the rounding noise of a gradient that is 0 in exact arithmetic,
    the key bias's, into whole steps, so it is held to the replicated run
    alone)."""
    ranks = spawn(workers.jobs, 4, _jobs({"data": 2, "model": 2}, {"tp_axis": "model"},
                                         ("adam", "sgd_momentum")))
    _check_pairs(ranks, 2, 2)
    on = ranks[0][2]
    # a model-sharded kernel: its state is model-sharded and data-sharded
    both = [k for k, (local, weight) in on["state_shapes"].items()
            if tuple(k.split(".")) in on["zero_dims"] and local != weight
            and sum(a != b for a, b in zip(local, weight)) == 1 and k.endswith("ff1.kernel")]
    assert both
    params, batches = _case("transformer")
    jff = JFFModel(JFFConfig(batch_size=batches[0][0].shape[0], ledger="off",
                             audit_programs="off", attribution="off", zero_optimizer=True))
    jbuild_transformer(jff, batches[0][0].shape[0], JTransformerConfig(**SHAPE), tp_axis="model")
    jff.compile(optimizer=JSGDOptimizer(lr=0.01, momentum=0.9), loss_type=getattr(JLossType, MSE),
                mesh=jmake_mesh({"data": 2, "model": 2}, jax.devices()[:4]))
    cm = jff.compiled
    cm.params = jax.tree_util.tree_map(lambda a, sh: jax.device_put(a, sh), params,
                                       cm.param_shardings)
    losses = []
    for b in batches:
        cm.params, cm.opt_state, l, _ = cm.train_step(cm.params, cm.opt_state,
                                                      jax.random.key(0), *b)
        losses.append(float(l))
    assert any("data" in str(leaf.sharding.spec)
               for leaf in jax.tree_util.tree_leaves(cm.opt_state) if leaf.ndim >= 1)
    np.testing.assert_allclose(on["losses"], losses, rtol=TOL)
    for op, ws in cm.params.items():
        for w, a in ws.items():
            a = np.asarray(a)
            atol = TOL * float(np.abs(a).max()) + \
                UPDATE_TOL * float(np.abs(a - params[op][w]).max())
            np.testing.assert_allclose(on["after_steps"][op][w], a, rtol=TOL, atol=atol,
                                       err_msg=f"{op}.{w}")
