"""The captured step programs' host side on the CPU (``runtime/graphs.py``):
the capture rule compile records, the cache's keys, the launch tally's
arithmetic over captures and replays, the params version a replayed
update and ``load_numpy_params`` bump, the dropout key as a device
tensor, and the decode caches the captured steps read. The captures
themselves run on the card (``test_torch_graphs_cuda.py``); here a stand-in
cache runs each step eagerly through the same wrappers. Parity with the
JAX package: dropout at rate 0, one train step, 1e-5 of the largest
|value| (the same graph summed in another order)."""

import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.ffconst import LossType as JLossType
from flexflow_tpu.runtime.optimizer import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch import (FFConfig, FFModel, LossType, SGDOptimizer, kernels,
                                load_numpy_params)
from flexflow_tpu_torch.core.op import LowerCtx
from flexflow_tpu_torch.models import GPTConfig, build_gpt
from flexflow_tpu_torch.ops.dropout import drop
from flexflow_tpu_torch.runtime import compiler
from flexflow_tpu_torch.runtime.graphs import (capture_rule, clone_tree, count_kernel_nodes,
                                              graph_key, tensor_leaves)
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)


class _FakeMesh:
    shape = {"data": 2}


def test_the_capture_rule_by_device_and_mesh():
    ok, why = capture_rule(torch.device("cuda", 0), None)
    assert ok and "one CUDA device" in why
    ok, why = capture_rule(torch.device("cuda", 0), _FakeMesh())
    assert not ok and "gloo" in why and "{'data': 2}" in why
    ok, why = capture_rule(torch.device("cpu"), None)
    assert not ok and "eagerly" in why


def _mlp(**cfg):
    ff = FFModel(FFConfig(batch_size=4, device="cpu", seed=2, **cfg))
    x = ff.create_tensor((4, 6), name="x")
    t = ff.dense(x, 8, name="d0")
    t = ff.dropout(t, 0.0, name="drop")
    ff.dense(t, 3, name="d1")
    ff.compile(SGDOptimizer(lr=0.1, momentum=0.9), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def test_compile_records_the_rule_and_keeps_the_eager_steps():
    ff = _mlp()
    cm = ff.compiled
    assert cm.capture == {"captured": False, "reason": capture_rule(cm.device)[1]}
    assert cm.graphs is None
    assert set(cm.eager) == {"forward_fn", "eval_step", "train_step", "train_k_steps",
                             "grad_step"}
    # uncaptured, the model's steps are the eager ones
    assert cm.train_step is cm.eager["train_step"] and cm.forward_fn is cm.eager["forward_fn"]
    # the program audit records the eager functions
    assert [s.fn for s in cm.audit_exec] == [cm.eager["train_step"], cm.eager["eval_step"]]


class _Cache:
    """A stand-in for StepGraphs on the CPU: records each call's key and
    bound tensors and runs the step eagerly, counting a 'replay' from a
    key's second call on, as the card's cache does."""

    def __init__(self):
        self.calls = []
        self.seen = set()

    def run(self, key, fn, args, bound=(), after_replay=None):
        bound = list(bound)
        self.calls.append((key, [t.data_ptr() for t in bound]))
        out = fn(*[torch.tensor(a) if isinstance(a, int) else a for a in args])
        if key in self.seen and after_replay is not None:
            after_replay()
        self.seen.add(key)
        return clone_tree(out)


def _graphed(ff):
    cm = ff.compiled
    cache = _Cache()
    bumps = []
    steps = compiler._graphed_steps(cache, cm.eager, ff.optimizer, cm.device, None,
                                    lambda: bumps.append(1))
    return cm, cache, steps, bumps


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 3, size=(n, 1)).astype(np.int32)))


def test_the_cache_keys_by_shape_seq_length_and_kind_and_skips_plain_kernels():
    ff = _mlp()
    cm, cache, steps, bumps = _graphed(ff)
    x, y = _batch()
    steps["train_step"](cm.params, cm.opt_state, 1, x, y)
    steps["train_step"](cm.params, cm.opt_state, 2, x, y)
    steps["train_step"](cm.params, cm.opt_state, 3, x[:2], y[:2])
    steps["train_step"](cm.params, cm.opt_state, 4, x, y, seq_length=3)
    steps["train_step"](cm.params, cm.opt_state, None, x, y)
    steps["eval_step"](cm.params, x, y)
    steps["forward_fn"](cm.params, x)
    n = len(cache.calls)
    steps["train_step"](cm.params, cm.opt_state, 5, x, y, plain_kernels=True)
    steps["forward_fn"](cm.params, x, plain_kernels=True)
    assert len(cache.calls) == n  # the plain reference path stays eager
    keys = [k for k, _ in cache.calls]
    assert keys[0] == keys[1]
    assert len(set(keys)) == 6
    assert [k[0] for k in keys] == ["train_step"] * 5 + ["eval_step", "forward_fn"]
    assert dict(keys[3][2])["seq_length"] == "3" and dict(keys[0][2])["seq_length"] == "-1"
    assert keys[2][1][1] == ((2, 6), "torch.float32")
    assert keys[4][1][0] is None  # no dropout key
    assert graph_key("forward_fn", (x,), plain_kernels=True) != \
        graph_key("forward_fn", (x,), plain_kernels=False)
    # bound: the params, the momentum buffers and the device lr, by address
    bound = cache.calls[0][1]
    assert bound == [t.data_ptr() for t in tensor_leaves(
        cm.params, cm.opt_state, ff.optimizer.device_hyper(cm.device))]
    # every 'replayed' update bumped the params version
    assert len(bumps) == 1


def test_graphed_train_steps_equal_the_eager_steps_and_bump_the_version():
    a, b = _mlp(), _mlp()
    ca = a.compiled
    cb, cache, steps, bumps = _graphed(b)
    for i in range(4):
        x, y = _batch(seed=i)
        ca.params, ca.opt_state, la, _ = ca.train_step(ca.params, ca.opt_state, i, x, y)
        cb.params, cb.opt_state, lb, _ = steps["train_step"](cb.params, cb.opt_state, i, x, y)
        assert torch.equal(la, lb)
    for op, ws in ca.params.items():
        for w, t in ws.items():
            assert torch.equal(t, cb.params[op][w])
    assert len(bumps) == 3


class _Streams:
    """Stand-ins for torch.cuda's current stream and its capture state on
    the CPU: each thread has a current stream (``use``), and the streams
    in ``capturing`` are being captured."""

    def __init__(self, monkeypatch):
        import threading
        import types

        self.local, self.capturing = threading.local(), set()
        current = lambda: types.SimpleNamespace(  # noqa: E731
            cuda_stream=getattr(self.local, "stream", 0))
        monkeypatch.setattr(torch.cuda, "current_stream", current)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: current().cuda_stream in self.capturing)

    def use(self, stream: int) -> None:
        self.local.stream = stream


def test_the_launch_tally_counts_captures_once_per_replay(monkeypatch):
    streams = _Streams(monkeypatch)
    kernels.reset_launch_counts()
    kernels.count_launch("row_gather")
    streams.use(7)
    streams.capturing.add(7)
    with kernels.capture_launches() as rec:
        for _ in range(3):
            kernels.count_launch("flash_attention_fwd")
        kernels.count_launch("flash_attention_bwd_dq")
        with pytest.raises(RuntimeError, match="already recorded"):
            with kernels.capture_launches():
                pass
    streams.capturing.clear()
    # a capture runs nothing: its launches land in the record only
    assert kernels.launch_counts()["flash_attention_fwd"] == 0
    assert rec["flash_attention_fwd"] == 3 and rec["flash_attention_bwd_dq"] == 1
    for _ in range(5):
        kernels.add_replayed(rec)
    counts = kernels.launch_counts()
    assert counts["flash_attention_fwd"] == 15 and counts["flash_attention_bwd_dq"] == 5
    assert counts["row_gather"] == 1
    # outside a capture a launch counts at once again
    kernels.count_launch("row_gather")
    assert kernels.launch_counts()["row_gather"] == 2
    kernels.reset_launch_counts()


def test_captures_on_two_threads_keep_their_own_records(monkeypatch):
    """Two threads capture at once (two models served side by side), each
    on its own stream: each launch lands in the record of the stream it
    was launched on, from whichever thread (a captured step's backward
    launches on the autograd engine's device thread, on the capture's
    stream); a launch on a stream not being captured counts at once; and
    neither capture raises."""
    import threading

    streams = _Streams(monkeypatch)
    kernels.reset_launch_counts()
    inside, go = threading.Barrier(4), threading.Barrier(4)
    records, errors = {}, []

    def capture(name, stream, kernel, n):
        try:
            streams.use(stream)
            streams.capturing.add(stream)
            with kernels.capture_launches() as rec:
                inside.wait(10)  # both captures open together
                for _ in range(n):
                    kernels.count_launch(kernel)
                go.wait(10)
            records[name] = rec
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    def device_thread():
        """Eager launches on its own stream, and the first capture's
        backward launches on that capture's stream."""
        inside.wait(10)
        for _ in range(4):
            kernels.count_launch("row_gather")
        streams.use(1)
        for _ in range(2):
            kernels.count_launch("flash_attention_bwd_dkv")
        go.wait(10)

    threads = [threading.Thread(target=capture, args=("a", 1, "flash_attention_fwd", 3)),
               threading.Thread(target=capture, args=("b", 2, "row_gather_sum", 5)),
               threading.Thread(target=device_thread)]
    for t in threads:
        t.start()
    go_main = threading.Thread(target=lambda: (inside.wait(10), go.wait(10)))
    go_main.start()
    for t in threads + [go_main]:
        t.join(30)
    assert not errors, errors
    assert {k: v for k, v in records["a"].items() if v} == {"flash_attention_fwd": 3,
                                                           "flash_attention_bwd_dkv": 2}
    assert {k: v for k, v in records["b"].items() if v} == {"row_gather_sum": 5}
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0) | {"row_gather": 4}
    kernels.add_replayed(records["a"])
    kernels.add_replayed(records["b"])
    counts = kernels.launch_counts()
    assert (counts["flash_attention_fwd"], counts["row_gather_sum"]) == (3, 5)
    kernels.reset_launch_counts()


_DOT = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="solid" shape="record" label="{MEMSET\n| {ID | 0}}"];
"graph_1_node_1"[style="bold" shape="octagon" label="{KERNEL\n| {ID | 1 | _Z20flash_fwd_kernel_mmaILi64EEvPK13__nv_bfloat16\<\<\<(8,16,1),128,0\>\>\>}\n| {{node handle | func handle} | {0x5601 | 0x7f2a}}}"];
"graph_1_node_2"[style="bold" shape="octagon" label="{KERNEL\n| {ID | 2 | void at::native::vectorized_elementwise_kernel\<4\>(...)}}"];
"graph_1_node_3"[style="bold" shape="octagon" label="{KERNEL\n| {ID | 3 | _Z21row_gather_sum_kernelIfEvPKT_PKiPKfPS0_iiii}}"];
"graph_1_node_4"[style="bold" shape="octagon" label="{KERNEL\n| {ID | 4 | _Z17row_gather_kernelIfEvPKT_PKiPKfPS0_iii}}"];
"graph_1_node_5"[style="bold" shape="octagon" label="{KERNEL\n| {ID | 5 | _Z20flash_fwd_kernel_mmaILi64EEvPK13__nv_bfloat16}}"];
"graph_1_node_0" -> "graph_1_node_1";
"graph_1_node_1" -> "graph_1_node_2" [style="solid"];
}
}
"""


def test_kernel_nodes_are_counted_from_a_graphs_dot_print():
    """A graph's DOT print (the form ``cudaGraphDebugDotPrint`` writes):
    each node counts once, for the kernel its symbol names; edges, the
    cluster's header and other kernels count for none."""
    got = count_kernel_nodes(_DOT)
    assert got == dict.fromkeys(kernels.KERNELS, 0) | {
        "flash_attention_fwd": 2, "row_gather": 1, "row_gather_sum": 1,
        "nodes": 6, "kernel_nodes": 5}


def test_kernel_symbols_tell_the_kernels_apart():
    """Each kernel's device symbols (demangled or mangled, every variant)
    match that kernel's name alone."""
    symbols = {
        "flash_attention_fwd": ["flash_fwd_kernel_mma<64>", "_Z28flash_fwd_kernel_wide_tf32x3ILi512EEvPKf"],
        "flash_attention_bwd_dq": ["flash_bwd_dq_kernel_tf32x3<128>", "flash_bwd_dq_kernel_wide_mma"],
        "flash_attention_bwd_dkv": ["flash_bwd_dkv_kernel_mma<64>", "flash_bwd_dkv_kernel_wide_tf32x3"],
        "row_gather": ["_Z17row_gather_kernelIfEvPKT_PKiPKfPS0_iii"],
        "row_gather_sum": ["void row_gather_sum_kernel<__nv_bfloat16>(...)"],
    }
    for name, syms in symbols.items():
        for sym in syms:
            assert [k for k, test in kernels.KERNEL_SYMBOLS.items() if test(sym)] == [name], sym
    assert not any(test("void at::native::elementwise_kernel<128, 4>")
                   for test in kernels.KERNEL_SYMBOLS.values())


def test_load_numpy_params_bumps_the_params_version_in_place():
    ff = _mlp()
    cm = ff.compiled
    ptrs = [t.data_ptr() for t in tensor_leaves(cm.params)]
    v = cm.params_version
    load_numpy_params(ff, {op: {w: np.zeros(t.shape, np.float32) for w, t in ws.items()}
                           for op, ws in cm.params.items()})
    assert cm.params_version == v + 1
    assert [t.data_ptr() for t in tensor_leaves(cm.params)] == ptrs


def test_dropout_with_the_key_as_a_tensor():
    """Equal keys (an int or a 0-d tensor) draw equal masks, other keys or
    ops other masks, and the kept share stays within 5 sigma."""
    x = torch.ones(200, 300)
    m = {k: drop(x, 0.25, LowerCtx(rng=k, seed=3), "d") for k in (7, 8)}
    assert torch.equal(m[7], drop(x, 0.25, LowerCtx(rng=torch.tensor(7), seed=3), "d"))
    assert not torch.equal(m[7], m[8])
    assert not torch.equal(m[7], drop(x, 0.25, LowerCtx(rng=7, seed=3), "e"))
    assert not torch.equal(m[7], drop(x, 0.25, LowerCtx(rng=7, seed=4), "d"))
    n = x.numel()
    for mask in m.values():
        kept = (mask > 0).sum().item()
        assert abs(kept - 0.75 * n) < 5 * np.sqrt(n * 0.75 * 0.25)
        assert torch.all((mask == 0) | (mask == 1 / 0.75))


def test_dropout_at_rate_0_trains_as_the_jax_package():
    """A model with a Dropout layer at rate 0, one SGD step from the same
    params through the port's train step (its key a tensor) and the JAX
    package's: loss and params within 1e-5."""
    jff = JFFModel(JFFConfig(batch_size=4, ledger="off", audit_programs="off",
                             attribution="off"))
    x = jff.create_tensor((4, 6), name="x")
    t = jff.dense(x, 8, name="d0")
    t = jff.dropout(t, 0.0, name="drop")
    jff.dense(t, 3, name="d1")
    jff.compile(optimizer=JSGDOptimizer(lr=0.1, momentum=0.9),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    ff = _mlp()
    load_numpy_params(ff, {op: {w: np.asarray(v) for w, v in ws.items()}
                           for op, ws in jff.compiled.params.items()})
    xs, y = _batch()
    import jax

    jcm, cm = jff.compiled, ff.compiled
    jcm.params, jcm.opt_state, jl, _ = jcm.train_step(jcm.params, jcm.opt_state,
                                                      jax.random.key(0), xs.numpy(), y.numpy())
    cm.params, cm.opt_state, tl, _ = cm.train_step(cm.params, cm.opt_state,
                                                   torch.tensor(5), xs, y)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for op, ws in jcm.params.items():
        for w, v in ws.items():
            want = np.asarray(v)
            np.testing.assert_allclose(cm.params[op][w].numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


def _gpt(dtype):
    ff = FFModel(FFConfig(batch_size=2, device="cpu", compute_dtype=dtype, seed=4))
    build_gpt(ff, 2, 8, GPTConfig(vocab_size=32, max_positions=24, hidden_size=16,
                                  num_heads=2, num_layers=1))
    ff.compile(SGDOptimizer(lr=0.5), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def test_decode_caches_keep_their_storage_across_calls_and_versions():
    """The Generator decodes in one cache across ``generate`` calls, and a
    bf16 cast re-derived after an update lands in the same storage (what
    a captured decode step reads); both give the answers of fresh ones."""
    from flexflow_tpu_torch.serving import Generator

    ff = _gpt("bfloat16")
    cm = ff.compiled
    gen = Generator(ff, max_length=20)
    prompt = np.random.default_rng(1).integers(0, 32, size=(2, 4)).astype(np.int32)
    first = gen.generate(prompt, 6)
    cache_ptrs = [t.data_ptr() for t in tensor_leaves(gen._gen_cache)]
    cast = gen._exec_params()
    cast_ptrs = [t.data_ptr() for t in tensor_leaves(cast)]
    np.testing.assert_array_equal(gen.generate(prompt, 6), first)
    assert [t.data_ptr() for t in tensor_leaves(gen._gen_cache)] == cache_ptrs
    rng = np.random.default_rng(2)
    tok = rng.integers(0, 32, size=(2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
    cm.params, cm.opt_state, _, _ = cm.train_step(
        cm.params, cm.opt_state, 0, torch.from_numpy(tok[:, :-1]), torch.from_numpy(pos),
        torch.from_numpy(tok[:, 1:]))
    cm.bump_params_version()
    after = gen._exec_params()
    assert after is not cast
    assert [t.data_ptr() for t in tensor_leaves(after)] == cast_ptrs
    for op, ws in cm.params.items():
        for w, t in ws.items():
            assert torch.equal(after[op][w], t.to(torch.bfloat16) if t.is_floating_point()
                               else t)
    np.testing.assert_array_equal(gen.generate(prompt, 6),
                                  Generator(ff, max_length=20).generate(prompt, 6))
