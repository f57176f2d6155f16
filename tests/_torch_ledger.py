"""An autouse fixture the port's test files import: the run ledger (on by
default, as in the JAX package) writes each test's records under its own
temporary directory, not into the working tree.

Where the test process has imported the JAX package, the same fixture
lets its compile reuse one jitted program a distinct weight initializer:
the JAX package's ``init_params`` jits a fresh closure for every weight,
so each compile of a model recompiles every initializer it draws with.
The cached version draws every weight from the same key with the same
initializer, shape, dtype and sharding, so the params are the reference's
bit for bit; only the compile is shared. A test that replaces
``init_params`` itself (numpy draws) keeps its own.

Under pytest-xdist each worker's PyTorch takes its share of the cores
for its intra-op threads (one when there are fewer cores than twice the
workers), and so do the rank processes it spawns: every worker starting
a thread a core made the CPU kernels of a few large tests (the zoo's
ResNets) several times slower than one worker alone."""

import os
import sys
import zlib

import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    _THREADS = max(1, (os.cpu_count() or 1)
                   // max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
    torch.set_num_threads(_THREADS)
    os.environ.setdefault("OMP_NUM_THREADS", str(_THREADS))

_INIT_PROGRAMS: dict = {}


def _initializer(fn, shape, dtype):
    def init(key):
        return fn(key, shape, dtype)
    return init


def _cached_init_params(ops, mesh, seed, dtype_override=None):
    """``flexflow_tpu.runtime.compiler.init_params`` with its per-weight
    programs kept by (initializer class and fields, shape, dtype,
    sharding)."""
    import jax

    from flexflow_tpu.runtime import compiler as jcompiler

    root = jax.random.key(seed)
    params, shardings, wd_mask = {}, {}, {}
    for op in ops:
        specs = op.weight_specs()
        if not specs:
            continue
        params[op.name], shardings[op.name], wd_mask[op.name] = {}, {}, {}
        op_key = jax.random.fold_in(root, zlib.crc32(op.name.encode()))
        for wi, ws in enumerate(specs):
            key = jax.random.fold_in(op_key, wi)
            sh = jcompiler._named_sharding(mesh, op.weight_shapes[ws.name])
            jdtype = dtype_override or ws.dtype.to_jnp()
            fn = ws.initializer
            ck = (type(fn), repr(sorted(vars(fn).items())), tuple(ws.shape), str(jdtype), sh)
            program = _INIT_PROGRAMS.get(ck)
            if program is None:
                program = _INIT_PROGRAMS[ck] = jax.jit(
                    _initializer(fn, tuple(ws.shape), jdtype), out_shardings=sh)
            params[op.name][ws.name] = program(key)
            shardings[op.name][ws.name] = sh
            wd_mask[op.name][ws.name] = ws.weight_decay
    return params, shardings, wd_mask


@pytest.fixture(autouse=True)
def _ledger_in_tmp(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_LEDGER_DIR", str(tmp_path_factory.mktemp("ledger")))
    jcompiler = sys.modules.get("flexflow_tpu.runtime.compiler")
    if jcompiler is not None and getattr(jcompiler.init_params, "__module__", "") == \
            "flexflow_tpu.runtime.compiler":
        monkeypatch.setattr(jcompiler, "init_params", _cached_init_params)
