"""Rank bodies for the port's mesh tests, run by
``flexflow_tpu_torch.parallel.distributed.spawn``.

A spawned rank imports this module by name, so it imports only torch,
numpy and the port: no JAX (``tests/test_torch_port_rules.py`` checks).
Each function takes ``(rank, world, ...)`` and returns numpy results; the
test files hold them against the JAX package in the test process.
"""

from __future__ import annotations

import sys

import numpy as np

import torch


def loaded_modules(rank: int, world: int) -> list:
    """The JAX modules a spawned rank has loaded (none)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flexflow_tpu"))


def collectives(rank: int, world: int, blocks, experts, w) -> dict:
    """The four JAX-module collectives on this rank's blocks over a 1-D
    mesh ``{"x": world}``, and the gradients each autograd pair gives for
    the loss sum(w * f(x)) (float64)."""
    from flexflow_tpu_torch.core.machine import make_mesh
    from flexflow_tpu_torch.parallel import collectives as C

    mesh = make_mesh({"x": world})
    g = mesh.group(["x"])
    out = {"index": g.index, "modules": loaded_modules(rank, world)}
    x = torch.from_numpy(blocks[rank])
    out["ring"] = C.ring_all_reduce(x, mesh, "x").numpy()
    out["psum"] = C.psum_all_reduce(x, mesh, "x").numpy()
    c = experts.shape[1] // world
    ex = torch.from_numpy(experts[:, rank * c:(rank + 1) * c])
    out["to_experts"] = C.expert_all_to_all(ex, mesh, "x").numpy()
    out["to_tokens"] = C.experts_to_tokens(torch.from_numpy(out["to_experts"]), mesh, "x").numpy()
    pairs = {
        "scatter_to": lambda t: C.scatter_to(t, g, 0),   # x replicated
        "gather_from": lambda t: C.gather_from(t, g, 0),  # x: this rank's block
        "reduce_from": lambda t: C.reduce_from(t, g),
        "copy_to": lambda t: C.copy_to(t, g),
        "ring_shift": lambda t: C.ring_shift(t, g),
        "all_to_all": lambda t: C.all_to_all(t, g),
    }
    for name, fn in pairs.items():
        src = w["x_full"] if name == "scatter_to" else w["x"][rank]
        xt = torch.from_numpy(src).requires_grad_(True)
        y = fn(xt)
        (y * torch.from_numpy(w["w"][rank][: y.shape[0]])).sum().backward()
        out[name] = (y.detach().numpy(), xt.grad.numpy())
    return out


def attention(rank: int, world: int, mesh_shape: dict, q, k, v, g, u, rate: float) -> dict:
    """Ring and Ulysses attention over the mesh's ``seq`` axis on this
    rank's sequence blocks, causal and not: each output block and the
    gradients of sum(g * out); with ``rate`` the blocks of ``u``."""
    from flexflow_tpu_torch.core.machine import make_mesh
    from flexflow_tpu_torch.parallel.ring_attention import ring_attention, ulysses_attention

    mesh = make_mesh(mesh_shape)
    n, r = mesh.degree("seq"), mesh.coords["seq"]
    sl = q.shape[1] // n
    blk = slice(r * sl, (r + 1) * sl)
    out = {"seq_index": r}
    for name, fn in (("ring", ring_attention), ("a2a", ulysses_attention)):
        for causal in (False, True):
            ts = [torch.from_numpy(a[:, blk]).requires_grad_(True) for a in (q, k, v)]
            o = fn(*ts, mesh, "seq", causal=causal, scale=0.3)
            (o * torch.from_numpy(g[:, blk])).sum().backward()
            out[(name, causal)] = [o.detach().numpy()] + [t.grad.numpy() for t in ts]
            with torch.no_grad():
                od = fn(*[torch.from_numpy(a[:, blk]) for a in (q, k, v)], mesh, "seq",
                        causal=causal, scale=0.3, dropout_rate=rate, u=torch.from_numpy(u))
            out[(name, causal, "drop")] = od.numpy()
    return out


def build(ff, model: str, batch: int, shape: dict, **kw):
    from flexflow_tpu_torch.ffconst import ActiMode
    from flexflow_tpu_torch.models import GPTConfig, TransformerConfig, build_gpt
    from flexflow_tpu_torch.models.transformer import build_transformer

    if model == "gpt":
        return build_gpt(ff, batch, shape["seq"], GPTConfig(**shape["cfg"]), **kw)
    if model == "transformer":
        return build_transformer(ff, batch, TransformerConfig(**shape), **kw)
    if model == "mlp_l1l2":
        # a tensor-parallel MLP whose kernels carry penalties: a sharded
        # kernel's penalty is the sum of its blocks'
        from flexflow_tpu_torch.keras.regularizers import L1L2

        tp = kw.get("tp_axis")
        x = ff.create_tensor((batch, shape["hidden_size"]), name="input")
        reg = L1L2(l1=1e-3, l2=1e-2)
        t = ff.dense(x, 4 * shape["hidden_size"], ActiMode.RELU, name="up",
                     kernel_regularizer=reg, strategy={"out": tp} if tp else None)
        t = ff.dense(t, shape["hidden_size"], name="down", kernel_regularizer=reg,
                     strategy={"in": tp} if tp else None)
        return x, ff.dense(t, 1, name="head", kernel_regularizer=reg)
    if model == "verbs":
        return verbs(ff, ActiMode.RELU, batch, shape["hidden_size"], kw.get("tp_axis", "model"))
    # "dropout": attention dropout over the sequence strategy, then a Dropout op
    x = ff.create_tensor((batch, shape["sequence_length"], shape["hidden_size"]), name="input")
    strategy = {"seq": kw["seq_axis"], "seq_mode": kw.get("seq_mode", "ring")} \
        if kw.get("seq_axis") else None
    t = ff.multihead_attention(x, x, x, shape["hidden_size"], shape["num_heads"], dropout=0.25,
                               name="attn", strategy=strategy)
    t = ff.dropout(ff.dense(t, shape["hidden_size"], ActiMode.RELU, name="ff"), 0.3, name="drop")
    return x, ff.dense(t, 1, name="head")


def verbs(ff, relu, batch: int, h: int, axis: str):
    """The parallel verbs between two dense layers, for either package:
    replicate then repartition the features over ``axis``, tanh on the
    blocks, combine and reduction back (``relu``: that package's
    ``ActiMode.RELU``)."""
    x = ff.create_tensor((batch, h), name="input")
    t = ff.dense(x, 2 * h, relu, name="up")
    t = ff.repartition(ff.replicate(t, axis, name="rep"), 1, axis, name="part")
    t = ff.reduction(ff.combine(ff.tanh(t, name="act"), 1, name="comb"), axis, name="red")
    return x, ff.dense(t, 1, name="head")


def train(rank: int, world: int, model: str, mesh_shape, shape: dict, kw: dict, params,
          batches, loss: str, compute_dtype=None, rng=None) -> dict:
    """The model over ``mesh_shape`` from ``params``: one ``train_step`` per
    global batch (this rank's rows through ``set_batch``); the losses and
    the whole params after (every rank gathers, rank 0 returns them)."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer, load_numpy_params
    from flexflow_tpu_torch.parallel import distributed

    batch = batches[0][-1].shape[0]
    ff = FFModel(FFConfig(batch_size=batch, device="cpu", mesh_shape=mesh_shape,
                          compute_dtype=compute_dtype))
    build(ff, model, batch, shape, **kw)
    ff.compile(SGDOptimizer(lr=0.01), getattr(LossType, loss))
    load_numpy_params(ff, params)
    cm = ff.compiled
    losses = []
    for i, b in enumerate(batches):
        ff.set_batch(list(b[:-1]), b[-1])
        cm.params, cm.opt_state, l, _ = cm.train_step(
            cm.params, cm.opt_state, None if rng is None else rng + i, *ff._cur_batch)
        losses.append(float(l))
    full = ff.numpy_params()
    return dict(losses=losses, params=full if rank == 0 else None,
                backend=distributed.backend(), rank=rank)


def fit(rank: int, world: int, mesh_shape, shape: dict, params, x, y, depth: int) -> dict:
    """``FFModel.fit`` of the Transformer over ``mesh_shape`` with the
    Prefetcher at ``depth``; the whole params after and the epoch's
    metrics."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
                                    load_numpy_params)
    from flexflow_tpu_torch.models.transformer import TransformerConfig, build_transformer

    ff = FFModel(FFConfig(batch_size=8, device="cpu", mesh_shape=mesh_shape,
                          prefetch_depth=depth))
    build_transformer(ff, 8, TransformerConfig(**shape))
    ff.compile(SGDOptimizer(lr=0.01), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               metrics=[MetricsType.MEAN_SQUARED_ERROR])
    load_numpy_params(ff, params)
    pm = ff.fit(x, y, epochs=1, shuffle=True, verbose=False)[0]
    ev = ff.eval(x, y, verbose=False)
    return dict(params=ff.numpy_params(), train_all=pm.train_all, mse=pm.mse_loss,
                eval_all=ev.train_all, eval_mse=ev.mse_loss,
                profile_depth=ff.fit_profile["prefetch_depth"])


def jobs(rank: int, world: int, todo: list) -> list:
    """Several of this module's rank bodies in one process group, in order:
    ``todo`` holds (function name, arguments) pairs."""
    return [globals()[name](rank, world, *args) for name, args in todo]


def sharded_flash(rank: int, world: int, q, k, v, causal: bool, dtype: str) -> dict:
    """``sharded_flash_attention`` on the card: this rank's batch block
    over a {"data": 2} mesh, then its heads block over {"model": 2};
    the output blocks and the flash launches."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.core.machine import make_mesh
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import distributed

    out = {"backend": distributed.backend()}
    kernels.reset_launch_counts()
    for axis, dim in (("data", 0), ("model", 2)):
        mesh = make_mesh({axis: 2})
        n = q.shape[dim] // 2
        blk = [slice(None)] * 4
        blk[dim] = slice(rank * n, (rank + 1) * n)
        ts = [torch.from_numpy(a[tuple(blk)]).cuda().to(getattr(torch, dtype))
              for a in (q, k, v)]
        o = fa.sharded_flash_attention(*ts, mesh, axis if dim == 0 else None,
                                       axis if dim == 2 else None, causal, 0.125)
        out[axis] = o.float().cpu().numpy()
    out["launches"] = kernels.launch_counts()["flash_attention_fwd"]
    return out


def ep_kernels(rank: int, world: int, x, assign, gate, n: int, capacity: int,
               dtype: str) -> dict:
    """The expert-parallel row movement on the card: this rank's block of
    the batch dispatched at the local capacity (``row_gather``), the rows
    through ``expert_all_to_all`` and back, and the rank's combine
    (``row_gather_sum``), each against its plain version on the same
    tensors; the launches counted around the kernel path alone."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.core.machine import make_mesh
    from flexflow_tpu_torch.kernels import moe_kernels as mk
    from flexflow_tpu_torch.parallel import collectives as C, distributed

    mesh = make_mesh({"data": world})
    b = x.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    tdt = getattr(torch, dtype)
    xl = torch.from_numpy(x[rows]).cuda().to(tdt)
    al = torch.from_numpy(assign[rows]).cuda()
    gl = torch.from_numpy(gate[rows]).cuda()
    c_loc = capacity // world
    out = {"backend": distributed.backend(), "local_rows": b, "local_capacity": c_loc}
    for plain in (True, False):
        kernels.reset_launch_counts()
        disp = mk.moe_dispatch(xl, al, n, c_loc, plain=plain)
        experts = C.expert_all_to_all(disp, mesh, "data")
        back = C.experts_to_tokens(experts * 2, mesh, "data")
        comb = mk.moe_combine(back, al, gl, plain=plain)
        torch.cuda.synchronize()
        out["plain" if plain else "kernel"] = dict(
            dispatch=disp.float().cpu().numpy(), combine=comb.float().cpu().numpy(),
            experts_shape=tuple(experts.shape), launches=kernels.launch_counts())
    return out


def nccl_all_reduce(rank: int, world: int) -> dict:
    from flexflow_tpu_torch.core.machine import make_mesh
    from flexflow_tpu_torch.parallel import collectives as C, distributed

    mesh = make_mesh({"data": world})
    x = torch.full((1024,), float(rank + 1), device="cuda")
    s = C.psum_all_reduce(x, mesh, "data")
    return {"backend": distributed.backend(), "sum": float(s[0]),
            "staged": C.stats()["staged_bytes"]}


def whole_tree(cm, tree: dict) -> dict:
    """A tree of this rank's blocks (params or gradients) as whole numpy
    arrays: each sharded block all-gathered by its weight's layout."""
    from flexflow_tpu_torch.core.parallel_tensor import ParallelTensorShape
    from flexflow_tpu_torch.ops.parallel_ops import reshard

    out = {}
    with torch.no_grad():
        for op, ws in tree.items():
            out[op] = {}
            for w, t in ws.items():
                if cm.mesh is not None:
                    lay = cm.weight_layout(op, w)
                    t = reshard(t, lay, ParallelTensorShape.unpartitioned(lay.sizes), cm.mesh)
                out[op][w] = t.float().numpy().copy()
    return out


def moe(rank: int, world: int, mesh_shape, cfg: dict, stacked: bool, expert_axis, params,
        batches, grad_batch=None) -> dict:
    """``build_moe_mnist`` over ``mesh_shape`` from ``params``: one SGD
    ``train_step`` per global batch (this rank's rows), then, with
    ``grad_batch``, one ``grad_step``. Returns the losses, the whole
    params and gradients, this rank's expert-weight block shape and the
    calls of the expert all-to-alls."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer, load_numpy_params
    from flexflow_tpu_torch.models import MoeConfig, build_moe_mnist
    from flexflow_tpu_torch.parallel import collectives as C

    batch = batches[0][-1].shape[0]
    ff = FFModel(FFConfig(batch_size=batch, device="cpu", mesh_shape=mesh_shape))
    build_moe_mnist(ff, batch, MoeConfig(**cfg), stacked=stacked, expert_axis=expert_axis)
    ff.compile(SGDOptimizer(lr=0.1), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    load_numpy_params(ff, params)
    cm = ff.compiled
    calls = {"to_experts": 0, "to_tokens": 0}
    real = C.expert_all_to_all, C.experts_to_tokens

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    C.expert_all_to_all = counted("to_experts", real[0])
    C.experts_to_tokens = counted("to_tokens", real[1])
    try:
        losses = []
        for b in batches:
            ff.set_batch([b[0]], b[1])
            cm.params, cm.opt_state, loss, _ = cm.train_step(cm.params, cm.opt_state, None,
                                                             *ff._cur_batch)
            losses.append(float(loss))
        grads = None
        if grad_batch is not None:
            ff.set_batch([grad_batch[0]], grad_batch[1])
            grads = whole_tree(cm, cm.grad_step(cm.params, None, *ff._cur_batch))
    finally:
        C.expert_all_to_all, C.experts_to_tokens = real
    experts = cm.params.get("moe_experts", {}).get("kernel")
    return dict(losses=losses, params=whole_tree(cm, cm.params), grads=grads, calls=calls,
                expert_block=None if experts is None else tuple(experts.shape))


def pipe(rank: int, world: int, mesh_shape: dict, model: str, shape: dict, params, batches,
         loss: str, pipeline: dict, kw: dict = None, config: dict = None,
         forward_x=None) -> dict:
    """``model`` compiled over ``mesh_shape`` with ``pipeline`` (the
    ``PipelineConfig`` fields), from ``params``: one ``train_step`` of the
    engine per global batch; the losses, the whole params after, the
    engine's record and, with ``forward_x``, ``forward_only``'s logits."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer, load_numpy_params
    from flexflow_tpu_torch.parallel.pipeline import PipelineConfig

    batch = batches[0][-1].shape[0]
    ff = FFModel(FFConfig(batch_size=batch, device="cpu", mesh_shape=mesh_shape,
                          **(config or {})))
    if model == "moe":
        from flexflow_tpu_torch.models import MoeConfig, build_moe_mnist

        build_moe_mnist(ff, batch, MoeConfig(**shape), **(kw or {}))
    else:
        build(ff, model, batch, shape, **(kw or {}))
    ff.compile(SGDOptimizer(lr=0.01), getattr(LossType, loss),
               pipeline=PipelineConfig(**pipeline) if pipeline is not None else None)
    load_numpy_params(ff, params)
    pm = ff.pipelined
    losses = [float(pm.train_step(None, list(b[:-1]), b[-1])[0]) for b in batches]
    logits = None if forward_x is None else pm.forward_only(list(forward_x)).numpy()
    rec = pm.profile(batch // pm.cfg.num_microbatches)
    return dict(losses=losses, params=ff.numpy_params(), engine=pm.engine_name,
                fallback_reason=pm.fallback_reason, stage=rec["stage"],
                microbatches=pm.cfg.num_microbatches, logits=logits,
                chunks=[[op.name for op in ch] for ch in pm.chunks])


def zero(rank: int, world: int, model: str, mesh_shape, shape: dict, kw: dict, params,
         batches, loss: str, optimizer: str, zero_optimizer: bool) -> dict:
    """``model`` over ``mesh_shape`` with ``optimizer`` ("sgd_momentum" or
    "adam") and ZeRO-1 on or off: one ``train_step`` per global batch,
    then the manual ``backward``/``update`` verbs on the first batch; the
    losses, the whole params after, this rank's optimizer-state bytes and
    each state array's local shape beside its weight's."""
    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel, LossType, SGDOptimizer,
                                    load_numpy_params)

    batch = batches[0][-1].shape[0]
    ff = FFModel(FFConfig(batch_size=batch, device="cpu", mesh_shape=mesh_shape,
                          zero_optimizer=zero_optimizer))
    build(ff, model, batch, shape, **kw)
    opt = (AdamOptimizer(alpha=0.01) if optimizer == "adam"
           else SGDOptimizer(lr=0.01, momentum=0.9))
    ff.compile(opt, getattr(LossType, loss))
    load_numpy_params(ff, params)
    cm = ff.compiled
    losses = []
    for b in batches:
        ff.set_batch(list(b[:-1]), b[-1])
        cm.params, cm.opt_state, l, _ = cm.train_step(cm.params, cm.opt_state, None,
                                                      *ff._cur_batch)
        losses.append(float(l))
    after_steps = ff.numpy_params()
    ff.set_batch(list(batches[0][:-1]), batches[0][-1])
    ff.backward()
    ff.update()
    state = cm.opt_state["m"] if optimizer == "adam" else cm.opt_state
    shapes = {f"{op}.{w}": (tuple(t.shape), tuple(cm.params[op][w].shape))
              for op, ws in state.items() for w, t in ws.items()}
    nbytes = sum(t.numel() * t.element_size() for ws in state.values() for t in ws.values())
    if optimizer == "adam":
        nbytes *= 2  # m and v
    return dict(losses=losses, params=ff.numpy_params(), after_steps=after_steps,
                state_bytes=nbytes,
                state_shapes=shapes, zero_dims=dict(cm.zero_dims))


# ------------------------------------------- sharded tables, convolution, BN
def sharded_graph(ff, kind: str, batch: int, ns):
    """A small graph of ``kind`` for either package (``ns``: that
    package's ``ffconst``), its layers named so strategies find them;
    returns its inputs. The strategies go to ``compile``."""
    A = ns.ActiMode
    if kind in ("emb", "emb_rows", "emb_bag"):
        ids = ff.create_tensor((batch, 3), ns.DataType.INT32, name="ids")
        if kind == "emb_rows":
            ff.embedding(ids, 16, 8, ns.AggrMode.NONE, name="emb_none")
            return [ids]
        if kind == "emb_bag":
            ff.concat([ff.embedding(ids, 16, 8, ns.AggrMode.SUM, name="emb_sum"),
                       ff.embedding(ids, 16, 8, ns.AggrMode.AVG, name="emb_avg")], axis=-1)
            return [ids]
        rows = ff.flat(ff.embedding(ids, 16, 8, ns.AggrMode.NONE, name="emb_none"))
        t = ff.concat([rows, ff.embedding(ids, 16, 8, ns.AggrMode.SUM, name="emb_sum"),
                       ff.embedding(ids, 16, 8, ns.AggrMode.AVG, name="emb_avg")], axis=-1)
        ff.dense(t, 1, name="head")
        return [ids]
    if kind == "reduce":
        x = ff.create_tensor((batch, 16), name="x")
        h = ff.dense(x, 16, A.RELU, name="d1")
        c = ff.subtract(h, ff.mean(h, dims=[0], keepdims=True, name="batch_mean"))
        s = ff.scalar_multiply(ff.reduce_sum(h, axes=[0], keepdims=True, name="batch_sum"),
                               0.01)
        ff.dense(ff.add(c, s), 1, name="head")
        return [x]
    if kind == "reduce_all":
        x = ff.create_tensor((batch, 16), name="x")
        h = ff.dense(x, 16, A.TANH, name="d1")
        total = ff.reduce_sum(h, axes=[0, 1], name="all_sum")
        ff.add(ff.dense(h, 1, name="head"), ff.scalar_multiply(total, 0.01))
        return [x]
    img_shape = {"conv_stack": (3, 16, 16), "conv_odd": (3, 16, 16), "conv_oc": (4, 8, 8),
                 "bn": (3, 8, 8), "stem": (3, 32, 32)}[kind]
    x = ff.create_tensor((batch,) + img_shape, ns.DataType.FLOAT, name="img")
    if kind == "conv_stack":  # tests/test_parallel.py's spatial stack
        t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, A.RELU, name="c1")
        t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="p1")
        t = ff.conv2d(t, 16, 3, 3, 1, 1, 1, 1, name="c2")
    elif kind == "conv_odd":  # an odd kernel at stride 2, padded top and bottom
        t = ff.conv2d(x, 6, 5, 5, 2, 2, 2, 2, A.RELU, name="c1")
        t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, ns.PoolType.AVG, name="p1")
        t = ff.conv2d(t, 4, 3, 3, 1, 1, 1, 1, name="c2")
    elif kind == "conv_oc":
        t = ff.conv2d(x, 16, 3, 3, 1, 1, 1, 1, name="c1")
        t = ff.batch_norm(t, name="bn1")
        t = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1, A.RELU, groups=2, name="c2")
    elif kind == "bn":
        t = ff.batch_norm(ff.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="c1"), name="bn1")
    else:  # the ResNet-50 stem: 7x7/2 conv, batch norm, 3x3/2 max pool
        t = ff.conv2d(x, 8, 7, 7, 2, 2, 3, 3, name="c1", use_bias=False)
        t = ff.batch_norm(t, name="bn1")
        t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="p1")
    t = ff.dense(ff.flat(t), 5, name="head")
    ff.softmax(t)
    return [x]


def _port_graph(ff, kind: str, batch: int):
    from flexflow_tpu_torch import ffconst
    from flexflow_tpu_torch.models import (DLRMConfig, XDLConfig, build_dlrm,
                                           build_xdl)

    if kind == "dlrm":
        return build_dlrm(ff, batch, DLRMConfig(embedding_size=[32, 64], sparse_feature_size=8,
                                                mlp_bot=[4, 8, 8], mlp_top=[8, 8, 2]),
                          param_axis="model")[0]
    if kind == "xdl":
        return build_xdl(ff, batch, XDLConfig(embedding_size=[32] * 2, sparse_feature_size=8,
                                              mlp_top=[16, 1]),
                         embedding_strategy={"vocab": "model"})[0]
    return sharded_graph(ff, kind, batch, ffconst)


def sharded_ops(rank: int, world: int, kind: str, mesh_shape, strategies, params, batches,
                loss: str, forward_x=None) -> dict:
    """``kind`` over ``mesh_shape`` under ``strategies`` from ``params``:
    with ``batches``, one SGD ``train_step`` each (this rank's rows), the
    losses and the whole params after; with ``forward_x``, the whole
    ``forward_fn`` output; the layouts of every op's outputs."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer, load_numpy_params

    batch = (batches[0][-1] if batches else forward_x[0]).shape[0]
    ff = FFModel(FFConfig(batch_size=batch, device="cpu", mesh_shape=mesh_shape))
    _port_graph(ff, kind, batch)
    ff.compile(SGDOptimizer(lr=0.05), getattr(LossType, loss) if loss else None,
               strategies=strategies)
    load_numpy_params(ff, params)
    cm = ff.compiled
    out = {"specs": {op.name: op.output_shapes[0].partition_spec() for op in cm.ops},
           "weight_specs": {op.name: {w: s.partition_spec() for w, s in op.weight_shapes.items()}
                            for op in cm.ops}}
    if forward_x is not None:
        xs = [torch.from_numpy(np.ascontiguousarray(a[cm.batch_rows(i)]))
              for i, a in enumerate(forward_x)]
        out["forward"] = cm.forward_fn(cm.params, *xs).numpy()
    losses = []
    for b in batches or ():
        ff.set_batch(list(b[:-1]), b[-1])
        cm.params, cm.opt_state, l, _ = cm.train_step(cm.params, cm.opt_state, None,
                                                      *ff._cur_batch)
        losses.append(float(l))
    out.update(losses=losses, params=ff.numpy_params())
    return out


def bucket_fit(rank: int, world: int, mesh_shape, cfg: dict, params, x, pos, y) -> dict:
    """A tiny GPT's bucketed ``fit`` (``seq_buckets="pow2"``, a token
    budget) over ``mesh_shape``: the whole params after, the dispatched
    (rows, width) shapes of this rank and the bucket profile."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer, load_numpy_params
    from flexflow_tpu_torch.models import GPTConfig, build_gpt

    ff = FFModel(FFConfig(batch_size=8, device="cpu", mesh_shape=mesh_shape, seed=3,
                          seq_buckets="pow2", seq_bucket_min=4, token_budget=64))
    build_gpt(ff, 8, x.shape[1], GPTConfig(**cfg))
    ff.compile(SGDOptimizer(lr=0.05), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    load_numpy_params(ff, params)
    shapes = []
    step = ff.compiled.train_step

    def recording(p, o, r, *batch, **kw):
        shapes.append(tuple(batch[-1].shape))
        return step(p, o, r, *batch, **kw)

    ff.compiled.train_step = recording
    ff.fit([x, pos], y, epochs=1, shuffle=False, verbose=False)
    return dict(params=ff.numpy_params(), shapes=shapes,
                buckets=ff.fit_profile["buckets"])


# ------------------------------------------------------- serving over a mesh
def serving_classifier(ff, bs, model_axis=None):
    """``tests/test_serving.py``'s classifier: dense 12 -> 32 (ReLU, its
    features over ``model_axis``), dense to 3, softmax."""
    from flexflow_tpu_torch.ffconst import ActiMode

    x = ff.create_tensor((bs, 12), name="x")
    t = ff.dense(x, 32, ActiMode.RELU, strategy={"out": model_axis} if model_axis else None)
    return ff.softmax(ff.dense(t, 3))


SERVING_GPT = dict(vocab_size=64, max_positions=32, hidden_size=32, num_heads=4, num_layers=2)


def serving_gpt(ff, bs):
    """A small GPT with its heads and MLP over ``model`` (a one-device
    compile ignores the axis)."""
    from flexflow_tpu_torch.models import GPTConfig, build_gpt

    build_gpt(ff, bs, 8, GPTConfig(**SERVING_GPT), tp_axis="model")


def tp_generate(rank: int, world: int, weights, prompt, new: int) -> dict:
    """The dense ``Generator`` over {model: world}, every rank in step:
    the prefill's last logits and the greedy tokens."""
    from flexflow_tpu_torch import CompMode, FFConfig, FFModel
    from flexflow_tpu_torch.serving import Generator
    from flexflow_tpu_torch.serving.group import load_weights_by_order

    ff = FFModel(FFConfig(batch_size=prompt.shape[0], device="cpu",
                          computation_mode=CompMode.INFERENCE, mesh_shape={"model": world}))
    serving_gpt(ff, prompt.shape[0])
    ff.compile()
    load_weights_by_order(ff, weights)
    gen = Generator(ff, max_length=32)
    heads = {op.name: gen.local_heads(op) for op in gen._attn_ops}
    last = gen.prefill(prompt)[0].numpy()
    return dict(last=last, tokens=gen.generate(prompt, new), heads=heads)
