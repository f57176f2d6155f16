"""The port's simulator (``flexflow_tpu_torch/sim/``) held to the JAX
package's on the CPU: the counterparts of ``tests/test_simulator.py`` and
``tests/test_network_sim.py`` (each scenario run in both packages, the
JAX test's assertions kept and the numbers compared), every op's
``CostMetrics`` of the MLP, Transformer, MoE, DLRM and ResNet-stem graphs
under each candidate strategy on {data: 2, model: 2}, the task graph, the
step estimate and the memory accounting, the pipeline schedule ranking,
the native replay and router against the Python ones, the refusal of the
TPU presets and the H100 preset chosen by the compute dtype.

Tolerance: 1e-12 relative on every time and byte count (the two packages
run the same float arithmetic in the same order; only summation of equal
terms may reorder), exact on names, deps and schedules. Both packages
price under one machine model: the round-number ``test`` chip, or
``cpu-host`` over the same device count."""

import dataclasses
import json
import types

import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.core import parallel_tensor as jpt
from flexflow_tpu.runtime.compiler import build_ops as jbuild_ops
from flexflow_tpu.search import substitution as jsub
from flexflow_tpu.search import unity as junity
from flexflow_tpu import sim as jsim
from flexflow_tpu.sim import cost_model as jcost
from flexflow_tpu.sim import network as jnet
from flexflow_tpu.sim import simulator as jsimulator
from flexflow_tpu_torch import native_bridge
from flexflow_tpu_torch.core import parallel_tensor as tpt
from flexflow_tpu_torch.runtime.compiler import build_ops as tbuild_ops
from flexflow_tpu_torch.search import substitution as tsub
from flexflow_tpu_torch.search import unity as tunity
from flexflow_tpu_torch import sim as tsim
from flexflow_tpu_torch.sim import cost_model as tcost
from flexflow_tpu_torch.sim import machine_model as tmm
from flexflow_tpu_torch.sim import network as tnet
from flexflow_tpu_torch.sim import simulator as tsimulator
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

REL = 1e-12


def _ns(pkg: str):
    """One package's names under one set of attributes."""
    if pkg == "jax":
        return types.SimpleNamespace(
            FFModel=J.FFModel, cfg=lambda **kw: J.FFConfig(**kw), build_ops=jbuild_ops,
            PD=jpt.ParallelDim, PTS=jpt.ParallelTensorShape, DataType=J.DataType,
            ActiMode=J.ActiMode, sim=jsim, cost=jcost, simulator=jsimulator, net=jnet,
            unity=junity, sub=jsub, models=__import__("flexflow_tpu.models", fromlist=["x"]))
    return types.SimpleNamespace(
        FFModel=T.FFModel, cfg=lambda **kw: T.FFConfig(device="cpu", **kw),
        build_ops=tbuild_ops, PD=tpt.ParallelDim, PTS=tpt.ParallelTensorShape,
        DataType=T.DataType, ActiMode=T.ActiMode, sim=tsim, cost=tcost,
        simulator=tsimulator, net=tnet, unity=tunity, sub=tsub,
        models=__import__("flexflow_tpu_torch.models", fromlist=["x"]))


PKGS = ("jax", "port")


def _close(a, b, rel=REL):
    return np.isclose(a, b, rtol=rel, atol=0.0)


def _both(fn):
    """``fn(ns)`` in each package: (JAX's result, the port's)."""
    return fn(_ns("jax")), fn(_ns("port"))


# ---------------------------------------------------- tests/test_simulator.py
def _mlp_ops(ns, axis_sizes, strategies=None):
    ff = ns.FFModel(ns.cfg(batch_size=32))
    x = ff.create_tensor((32, 64), ns.DataType.FLOAT, name="x")
    h = ff.dense(x, 128, name="fc1")
    ff.dense(h, 16, name="fc2")
    d = axis_sizes.get("data", 1)
    first = ns.PD(32, d, "data") if d > 1 else ns.PD(32)
    input_ps = {x.tensor_id: ns.PTS((first, ns.PD(64)), ns.DataType.FLOAT)}
    return ns.build_ops(ff.layers, input_ps, axis_sizes, strategies or {})[0]


def test_collective_formulas():
    def run(ns):
        m = ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 4)
        b = 1e6
        return (m.allgather_time(b, 4), m.allreduce_time(b, 4), m.allreduce_time(b, 1),
                m.permute_time(b, 4), m.reducescatter_time(b, 4), m.alltoall_time(b, 4))
    j, t = _both(run)
    b = 1e6
    assert np.isclose(t[0], 3 * (b / 2e10 + 1e-6))
    assert np.isclose(t[1], 2 * 3 * (b / 4 / 2e10 + 1e-6))
    assert t[2] == 0.0 and t[3] == b / 1e10 + 1e-6
    assert j == t


def test_op_cost_roofline():
    def run(ns):
        ops = _mlp_ops(ns, {"data": 1})
        cm = ns.sim.OpCostModel(ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 1))
        fc1 = next(o for o in ops if o.name == "fc1")
        c = cm.measure(fc1)
        assert cm.measure(fc1) is c  # memoized
        return dataclasses.astuple(c)
    j, t = _both(run)
    flops = 2 * 32 * 64 * 128
    byts = (32 * 64 + 32 * 128 + 64 * 128 + 128) * 4
    want = max(flops / 1e12, byts / 1e11)
    assert np.isclose(t[0], want) and np.isclose(t[1], 2 * want) and t[2] == 0.0
    assert j == t


def test_dp_adds_grad_sync_and_divides_compute():
    def run(ns):
        ops = _mlp_ops(ns, {"data": 4})
        machine = ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 4)
        fc1 = next(o for o in ops if o.name == "fc1")
        assert fc1.axis_sizes == {"data": 4}  # build_ops stamps the mesh
        c = ns.sim.OpCostModel(machine).measure(fc1)
        want_sync = machine.allreduce_time(64 * 128 * 4, 4) + machine.allreduce_time(128 * 4, 4)
        assert np.isclose(c.sync_time, want_sync) and c.sync_time > 0
        return dataclasses.astuple(c)
    j, t = _both(run)
    flops = 2 * 32 * 64 * 128 / 4
    byts = (32 * 64 / 4 + 32 * 128 / 4 + 64 * 128 + 128) * 4
    assert np.isclose(t[0], max(flops / 1e12, byts / 1e11))
    assert j == t


def test_tp_linear_charges_contraction_allreduce():
    def run(ns):
        ff = ns.FFModel(ns.cfg(batch_size=32))
        x = ff.create_tensor((32, 64), ns.DataType.FLOAT, name="x")
        h = ff.dense(x, 128, name="fc1")
        ff.dense(h, 16, name="fc2")
        ops, _ = ns.build_ops(ff.layers, {x.tensor_id: ns.PTS.unpartitioned((32, 64))},
                              {"data": 1, "model": 4},
                              {"fc1": {"out": "model"}, "fc2": {"in": "model"}})
        sim = ns.sim.Simulator(ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 4))
        fc2 = next(o for o in ops if o.name == "fc2")
        # the port names fc2's contraction (input dim -1 against kernel dim 0)
        assert fc2.input_contraction_dims() == [(0, 1, "kernel", 0)]
        return sim._comm_time(fc2, backward=False), sim._comm_time(fc2, backward=True)
    j, t = _both(run)
    assert t[0] > 0.0 and j == t


def test_simulate_runtime_prefers_dp_at_large_batch():
    B = 4096

    def run(ns):
        machine = ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 4)

        def step_time(axis_sizes, strategies):
            ff = ns.FFModel(ns.cfg(batch_size=B))
            x = ff.create_tensor((B, 64), ns.DataType.FLOAT, name="x")
            h = ff.dense(x, 64, name="fc1")
            ff.dense(h, 8, name="fc2")
            ips = (ns.PTS((ns.PD(B, 4, "data"), ns.PD(64)), ns.DataType.FLOAT)
                   if axis_sizes.get("data", 1) > 1 else ns.PTS.unpartitioned((B, 64)))
            ops, _ = ns.build_ops(ff.layers, {x.tensor_id: ips}, axis_sizes, strategies)
            return ns.sim.Simulator(machine).simulate_runtime(ops)

        return (step_time({"data": 4}, {}),
                step_time({"model": 4}, {"fc1": {"out": "model"}, "fc2": {"in": "model"}}))
    j, t = _both(run)
    assert t[0] < t[1]
    assert _close(j[0], t[0]) and _close(j[1], t[1])


def test_task_graph_and_memory():
    def run(ns):
        ops = _mlp_ops(ns, {"data": 1})
        sim = ns.sim.Simulator(ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 1))
        tasks = sim.build_task_graph(ops)
        mu = sim.memory_usage(ops)
        return ([(x.name, x.kind, x.deps, x.run_time) for x in tasks],
                (mu.weights, mu.optimizer_state, mu.activations), sim.fits_memory(ops))
    j, t = _both(run)
    kinds = [x[1] for x in t[0]]
    assert kinds.count("fwd") == 2 and kinds.count("bwd") == 2 and "update" in kinds
    w = (64 * 128 + 128 + 128 * 16 + 16) * 4
    assert t[1][:2] == (w, 2 * w) and t[2]
    assert j == t


def test_sp_attention_comm_priced_and_modes_differ():
    def run(ns):
        machine = ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 8)
        sim = ns.sim.Simulator(machine, ns.sim.OpCostModel(machine))

        def attn(mode):
            ff = ns.FFModel(ns.cfg(batch_size=8))
            x = ff.create_tensor((8, 64, 32), ns.DataType.FLOAT, name="x")
            st = {"seq": "seq", "seq_mode": mode}
            ff.multihead_attention(x, x, x, 32, 4, name="attn", strategy=st)
            ips = {x.tensor_id: ns.PTS((ns.PD(8, 2, "data"), ns.PD(64), ns.PD(32)),
                                       ns.DataType.FLOAT)}
            ops, _ = ns.build_ops(ff.layers, ips, {"data": 2, "seq": 4}, {"attn": st})
            return next(o for o in ops if o.name == "attn")

        return sim._comm_time(attn("ring"), False), sim._comm_time(attn("a2a"), False)
    j, t = _both(run)
    assert t[0] > 0 and t[1] > 0 and t[0] != t[1]
    assert _close(j[0], t[0]) and _close(j[1], t[1])


def test_zero_optimizer_shrinks_search_memory_model():
    def run(ns):
        ff = ns.FFModel(ns.cfg(batch_size=64))
        x = ff.create_tensor((64, 256), ns.DataType.FLOAT, name="x")
        ff.softmax(ff.dense(x, 512))
        machine = ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 8)
        repl = ns.unity.full_search(ff.layers, [x], machine, ns.cfg(batch_size=64),
                                    mesh_shapes=[{"data": 8}])
        zero = ns.unity.full_search(ff.layers, [x], machine,
                                    ns.cfg(batch_size=64, zero_optimizer=True),
                                    mesh_shapes=[{"data": 8}])
        return repl.est_memory, zero.est_memory, repl.est_step_time, zero.est_step_time
    j, t = _both(run)
    assert t[1] < t[0]
    assert j[:2] == t[:2] and _close(j[2], t[2]) and _close(j[3], t[3])


def _branchy_ops(ns, axis_sizes, strategies=None, k=2, width=256):
    ff = ns.FFModel(ns.cfg(batch_size=32))
    x = ff.create_tensor((32, 64), ns.DataType.FLOAT, name="x")
    outs = [ff.dense(x, width, name=f"b{i}") for i in range(k)]
    ff.dense(ff.concat(outs, axis=-1, name="cat"), 16, name="head")
    ips = {x.tensor_id: ns.PTS((ns.PD(32), ns.PD(64)), ns.DataType.FLOAT)}
    return ns.build_ops(ff.layers, ips, axis_sizes, strategies or {})[0]


def test_backward_is_a_dag_not_a_chain():
    def run(ns):
        sim = ns.sim.Simulator(ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 4))
        return [(x.name, x.deps, x.run_time) for x in sim.build_task_graph(
            _branchy_ops(ns, {"data": 1}))]
    j, t = _both(run)
    by = {name: i for i, (name, _, _) in enumerate(t)}
    assert t[by["b0:bwd"]][1] == t[by["b1:bwd"]][1] == (by["cat:bwd"],)
    assert {by["b0:bwd"], by["b1:bwd"]} <= set(t[by["grad_sync"]][1])
    assert j == t


def test_branch_comm_overlaps_compute_in_backward():
    def run(ns):
        sim = ns.sim.Simulator(ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 4),
                               overlap_grad_sync=False)
        ops = _branchy_ops(ns, {"model": 4}, {"b0": {"in": "model"}, "b1": {"in": "model"}},
                           width=512)
        tasks = sim.build_task_graph(ops)
        makespan = sim.simulate_runtime(ops) - sim.machine.chip.step_overhead
        return ([(x.name, x.kind, x.run_time) for x in tasks], makespan,
                [(x.start_time, x.ready_time) for x in sim.last_tasks()])
    j, t = _both(run)
    assert len([x for x in t[0] if x[1] == "comm" and x[2] > 0]) >= 2
    assert t[1] < sum(x[2] for x in t[0]) * 0.999
    assert j[0] == t[0] and _close(j[1], t[1])
    assert np.allclose(j[2], t[2], rtol=REL, atol=0)


def test_straight_chain_unchanged_by_dag_backward():
    def run(ns):
        sim = ns.sim.Simulator(ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 1),
                               overlap_grad_sync=False)
        ops = _mlp_ops(ns, {"data": 1})
        tasks = sim.build_task_graph(ops)
        return sim.simulate_runtime(ops) - sim.machine.chip.step_overhead, \
            sum(x.run_time for x in tasks)
    j, t = _both(run)
    assert np.isclose(t[0], t[1]) and _close(j[0], t[0])


def test_pipe_boundary_bytes_use_real_cut_tensors():
    def run(ns):
        ff = ns.FFModel(ns.cfg(batch_size=8))
        x = ff.create_tensor((8, 1024), name="x")
        h = ff.dense(ff.dense(x, 4096, name="wide"), 8, name="narrow")
        ff.dense(ff.dense(h, 4096, name="wide2"), 8, name="out")
        cut = ns.unity._stage_cut_bytes(ff.layers, 2)
        ff2 = ns.FFModel(ns.cfg(batch_size=8))
        x2 = ff2.create_tensor((8, 1024), name="x")
        a = ff2.dense(x2, 4096, name="wide")
        c = ff2.dense(ff2.dense(a, 8, name="narrow"), 4096, name="wide2")
        ff2.add(a, c, name="skip")
        return cut, ns.unity._stage_cut_bytes(ff2.layers, 2)
    j, t = _both(run)
    assert t[0] == 4.0 * 8 * 4096 and t[1] >= t[0]
    assert j == t


def test_per_op_family_backward_factors():
    def run(ns):
        ff = ns.FFModel(ns.cfg(batch_size=16))
        x = ff.create_tensor((16, 64), ns.DataType.FLOAT, name="x")
        ids = ff.create_tensor((16, 8), ns.DataType.INT32, name="ids")
        ff.embedding(ids, 50000, 64, name="emb")
        h = ff.layer_norm(ff.relu(ff.dense(x, 128, name="fc"), name="act"), axes=[1],
                          name="ln")
        ips = {t.tensor_id: ns.PTS(tuple(ns.PD(s) for s in t.dims), t.dtype) for t in (x, ids)}
        ops, _ = ns.build_ops(ff.layers, ips, {"data": 1}, {})
        cm = ns.sim.OpCostModel(ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 1))
        return {o.name: dataclasses.astuple(cm.measure(o)) for o in ops}
    j, t = _both(run)
    assert np.isclose(t["fc"][1], 2.0 * t["fc"][0]) and np.isclose(t["ln"][1], 1.5 * t["ln"][0])
    assert np.isclose(t["act"][1], t["act"][0]) and t["emb"][1] < 0.25 * t["emb"][0]
    assert {k.name: v for k, v in tcost.BWD_FACTORS.items()} == \
        {k.name: v for k, v in jcost.BWD_FACTORS.items()}
    assert j == t


# -------------------------------------------------- tests/test_network_sim.py
def test_ring_shortest_direction():
    for net in (jnet, tnet):
        topo = net.TorusTopology((8,))
        t, max_link, hops = net.route_transfers_py(topo, [0], [6], [1e6], 1e10, 0.0)
        assert hops == 2 and max_link == 1e6 and t == pytest.approx(1e6 / 1e10)
    assert tnet.route_transfers(tnet.TorusTopology((8,)), [0], [6], [1e6], 1e10, 0.0) == \
        jnet.route_transfers_py(jnet.TorusTopology((8,)), [0], [6], [1e6], 1e10, 0.0)


def test_open_mesh_single_direction():
    for net in (jnet, tnet):
        topo = net.TorusTopology((4,), (False,))
        assert net.route_transfers_py(topo, [0], [3], [1.0], 1e10, 0.0)[2] == 3
    assert tnet.route_transfers(tnet.TorusTopology((4,), (False,)), [0], [3], [1.0],
                                1e10, 0.0)[2] == 3


def test_contention_two_transfers_share_link():
    for route in (jnet.route_transfers_py, tnet.route_transfers_py, tnet.route_transfers):
        topo = tnet.TorusTopology((4,), (False,))
        t, max_link, _ = route(topo, [0, 1], [2, 3], [1e6, 1e6], 1e10, 0.0)
        assert max_link == 2e6 and t == pytest.approx(2e6 / 1e10)


@pytest.mark.parametrize("dims", [(4, 4), (2, 3, 4), (8,)])
def test_native_matches_python(dims, monkeypatch):
    """The native router (built from native/src/network_sim.cc) against
    the port's Python router and the JAX package's: equal outputs."""
    rng = np.random.default_rng(0)
    topo = tnet.TorusTopology(dims)
    n = topo.num_nodes
    src = rng.integers(0, n, 32).tolist()
    dst = rng.integers(0, n, 32).tolist()
    b = rng.uniform(1e3, 1e6, 32).tolist()
    calls = native_bridge.SIM_CALLS["route_transfers"]
    nat = tnet.route_transfers(topo, src, dst, b, 1e10, 1e-6)
    assert native_bridge.SIM_CALLS["route_transfers"] == calls + 1
    py = tnet.route_transfers_py(topo, src, dst, b, 1e10, 1e-6)
    jpy = jnet.route_transfers_py(jnet.TorusTopology(dims), src, dst, b, 1e10, 1e-6)
    assert nat[0] == pytest.approx(py[0], rel=REL) and nat[1] == py[1] and nat[2] == py[2]
    assert py == jpy
    monkeypatch.setenv("FLEXFLOW_TPU_NATIVE", "off")
    assert tnet.route_transfers(topo, src, dst, b, 1e10, 1e-6) == py
    assert native_bridge.SIM_CALLS["route_transfers"] == calls + 1


def test_aligned_axis_matches_ring_formula():
    chip = tsim.CHIP_PRESETS["test"]
    m = tsim.NetworkedMachineModel(chip, tnet.TorusTopology((2, 4)), {"data": 2, "model": 4})
    jm = jsim.NetworkedMachineModel(jsim.CHIP_PRESETS["test"], jnet.TorusTopology((2, 4)),
                                    {"data": 2, "model": 4})
    got = m.allgather_time(4e6, 4, "model")
    assert got == pytest.approx(3 * (4e6 / chip.ici_link_bandwidth + chip.ici_latency), rel=1e-6)
    assert tsim.SimpleMachineModel(chip, 8).allgather_time(4e6, 4, "model") < got
    assert _close(got, jm.allgather_time(4e6, 4, "model"))


def test_misaligned_axis_pays_contention():
    chip = tsim.CHIP_PRESETS["test"]
    m = tsim.NetworkedMachineModel(chip, tnet.TorusTopology((4, 4)), {"data": 4, "model": 4})
    aligned = m.allgather_time(1e7, 4, "model")
    assert m.allgather_time(1e7, 4, "data") == pytest.approx(aligned, rel=1e-6)
    order = np.random.default_rng(3).permutation(16).tolist()
    bad = tsim.NetworkedMachineModel(chip, tnet.TorusTopology((4, 4)),
                                     {"data": 4, "model": 4}, device_order=order)
    jbad = jsim.NetworkedMachineModel(jsim.CHIP_PRESETS["test"], jnet.TorusTopology((4, 4)),
                                      {"data": 4, "model": 4}, device_order=order)
    assert bad.allgather_time(1e7, 4, "model") > aligned
    assert _close(bad.allgather_time(1e7, 4, "model"), jbad.allgather_time(1e7, 4, "model"))


def test_alltoall_and_allreduce_sane():
    def run(sim, net):
        m = sim.NetworkedMachineModel(sim.CHIP_PRESETS["test"], net.TorusTopology((4,)),
                                      {"model": 4})
        return (m.allreduce_time(8e6, 4, "model"), m.allgather_time(8e6, 4, "model"),
                m.reducescatter_time(8e6, 4, "model"), m.alltoall_time(8e6, 4, "model"),
                m.permute_time(8e6, 4, "model"), m.allreduce_time(8e6, 1, "model"))
    t, j = run(tsim, tnet), run(jsim, jnet)
    assert t[0] == pytest.approx(2 * t[2], rel=1e-6) and 0 < t[3] < t[1]
    assert t[4] > 0 and t[5] == 0.0
    assert np.allclose(t, j, rtol=REL, atol=0)


def test_dcn_axis_uses_hose_model():
    m = tsim.NetworkedMachineModel(tsim.CHIP_PRESETS["test"], tnet.TorusTopology((4,)),
                                   {"dcn": 2, "model": 4}, dcn_axes=("dcn",))
    jm = jsim.NetworkedMachineModel(jsim.CHIP_PRESETS["test"], jnet.TorusTopology((4,)),
                                    {"dcn": 2, "model": 4}, dcn_axes=("dcn",))
    assert m.allreduce_time(1e6, 2, "dcn") > m.allreduce_time(1e6, 4, "model")
    assert _close(m.allreduce_time(1e6, 2, "dcn"), jm.allreduce_time(1e6, 2, "dcn"))


def test_load_networked_machine_model(tmp_path):
    p = tmp_path / "mm.json"
    p.write_text(json.dumps({"version": "networked", "chip": "test",
                             "axis_degrees": {"data": 2, "model": 4}, "topology": [2, 4]}))
    m, jm = tsim.load_machine_model(str(p)), jsim.load_machine_model(str(p))
    assert isinstance(m, tsim.NetworkedMachineModel) and m.num_devices() == 8
    assert m.allreduce_time(1e6, 4, "model") > 0
    assert _close(m.allreduce_time(1e6, 4, "model"), jm.allreduce_time(1e6, 4, "model"))


# ------------------------------------------------- every op, every candidate
def _graph(ns, name: str):
    """(layers, inputs) of a small graph built by one package."""
    m = ns.models
    ff = ns.FFModel(ns.cfg(batch_size=8))
    if name == "mlp":
        m.build_mlp(ff, 8, in_dim=32, hidden_dims=(64, 64), num_classes=8)
    elif name == "transformer":
        m.build_transformer(ff, 8, m.TransformerConfig(
            hidden_size=32, embedding_size=32, num_heads=4, num_layers=2, sequence_length=8))
    elif name == "moe":
        m.build_moe_mnist(ff, 8, m.MoeConfig(input_dim=16, num_classes=4, num_exp=4,
                                             num_select=2, expert_hidden_size=16))
    elif name == "moe_stacked":
        m.build_moe_mnist(ff, 8, m.MoeConfig(input_dim=16, num_classes=4, num_exp=4,
                                             num_select=2, expert_hidden_size=16),
                          stacked=True)
    elif name == "dlrm":
        m.build_dlrm(ff, 8, m.DLRMConfig(sparse_feature_size=16, embedding_size=[64, 32],
                                         mlp_bot=[4, 16, 16], mlp_top=[48, 16, 2]))
    elif name == "resnet_stem":
        x = ff.create_tensor((8, 3, 32, 32), ns.DataType.FLOAT, name="stem_in")
        t = ff.conv2d(x, 16, 7, 7, 2, 2, 3, 3, use_bias=False, name="stem_conv")
        t = ff.pool2d(ff.batch_norm(t, name="stem_bn"), 3, 3, 2, 2, 1, 1, name="stem_pool")
        ff.softmax(ff.dense(ff.flat(t), 10, name="stem_head"))
    return ff.layers, ff.input_tensors


GRAPHS = ("mlp", "transformer", "moe", "moe_stacked", "dlrm", "resnet_stem")
MESH = {"data": 2, "model": 2}


def _to_jax(ps):
    return jpt.ParallelTensorShape(tuple(jpt.ParallelDim(d.size, d.degree, d.axis)
                                         for d in ps.dims),
                                   J.DataType(ps.dtype.value), tuple(ps.replica_axes))


def _costs(sim, op):
    return (dataclasses.astuple(sim.cost_model.measure(op)), sim._comm_time(op, False),
            sim._comm_time(op, True))


def _per_candidate(name: str, chip: str):
    """Every layer of one graph under every candidate strategy, its inputs
    in the data-parallel plan's layouts: for each (layer, candidate) the
    port's layouts and costs (CostMetrics, forward and backward
    collectives), JAX's on its own layouts, and JAX's cost model on the
    port's layouts; None where propagate rejected the candidate."""
    rows = []
    sims, ctx = {}, {}
    for pkg in PKGS:
        ns = _ns(pkg)
        layers, inputs = _graph(ns, name)
        machine = ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS[chip], 4,
                                            shared_host=chip == "cpu-host")
        sims[pkg] = ns.sim.Simulator(machine, ns.sim.OpCostModel(machine))
        ops, pshapes = ns.build_ops(layers, ns.unity.data_parallel_input_pshapes(inputs, MESH),
                                    MESH, {})
        create = __import__(("flexflow_tpu" if pkg == "jax" else "flexflow_tpu_torch")
                            + ".core.op", fromlist=["x"]).create_op
        ctx[pkg] = (ns, layers, pshapes, create)
    (tns, tlayers, tps, tcreate), (jns, jlayers, jps, jcreate) = ctx["port"], ctx["jax"]
    for tl, jl in zip(tlayers, jlayers):
        cfg = dict(batch_size=8, search_budget=1)
        cands = tns.sub.candidate_strategies(tl, MESH, tns.cfg(**cfg))
        assert cands == jns.sub.candidate_strategies(jl, MESH, jns.cfg(**cfg))
        for cand in cands:
            st = dict(cand, _axis_sizes=MESH)
            row = dict(op=tl.op_type.name, cand=cand)
            for tag, layer, ps, create, sim in (
                    ("port", tl, tps, tcreate, sims["port"]),
                    ("jax", jl, jps, jcreate, sims["jax"])):
                ins = [ps[t.tensor_id] for t in layer.inputs]
                op = create(layer, ins)
                op.axis_sizes = dict(MESH)
                try:
                    op.output_shapes, op.weight_shapes = op.propagate(ins, st)
                except Exception:
                    row[tag] = None
                    continue
                row[tag] = ([str(x) for x in op.output_shapes], _costs(sim, op),
                            [str(x) for x in op.input_shapes])
                if tag == "port":
                    port_op = op
            if row["port"] is not None:
                # JAX's cost model on the port's layouts
                op = jcreate(jl, [_to_jax(p) for p in port_op.input_shapes])
                op.axis_sizes = dict(MESH)
                op.output_shapes = [_to_jax(p) for p in port_op.output_shapes]
                op.weight_shapes = {k: _to_jax(p) for k, p in port_op.weight_shapes.items()}
                row["jax_on_port"] = _costs(sims["jax"], op)
            rows.append(row)
    return rows


def _same_costs(a, b):
    return (np.allclose(a[0], b[0], rtol=REL, atol=0) and _close(a[1], b[1])
            and _close(a[2], b[2]))


# the ops whose layouts depart on purpose from JAX's on the data-parallel
# plan: the n-branch MoE's routing reads the whole batch, gathered,
# so GROUP_BY's outputs and the ops after it read other layouts than
# JAX's, which inherit the data sharding
DEPARTS = {"moe": {"GROUP_BY", "LINEAR", "AGGREGATE", "SOFTMAX"}}


@pytest.mark.parametrize("chip", ["test", "cpu-host"])
@pytest.mark.parametrize("name", GRAPHS)
def test_cost_metrics_every_op_every_candidate_match_jax(name, chip):
    rows = _per_candidate(name, chip)
    assert len(rows) > len(_graph(_ns("port"), name)[0])  # more than DP alone
    departed = set()
    for r in rows:
        assert (r["port"] is None) == (r["jax"] is None), r
        if r["port"] is None:
            continue
        # given the same layouts, the two cost models agree
        assert _same_costs(r["port"][1], r["jax_on_port"]), r
        if r["port"][0] == r["jax"][0] and r["port"][2] == r["jax"][2]:
            assert _same_costs(r["port"][1], r["jax"][1]), r
        else:
            departed.add(r["op"])
    assert departed <= DEPARTS.get(name, set()), departed
    if name in DEPARTS:
        assert departed  # the departure shows


def _dp_ops(name: str):
    """The data-parallel plan of one graph on {data: 2, model: 2}: the
    port's ops, JAX's ops on their own layouts, and JAX's ops carrying the
    port's layouts (what JAX's simulator prices given the same layouts)."""
    out = {}
    for pkg in PKGS:
        ns = _ns(pkg)
        layers, inputs = _graph(ns, name)
        out[pkg] = ns.build_ops(layers, ns.unity.data_parallel_input_pshapes(inputs, MESH),
                                MESH, {})[0]
    from flexflow_tpu.core.op import create_op as jcreate

    same = []
    for top, jop in zip(out["port"], out["jax"]):
        op = jcreate(jop.layer, [_to_jax(p) for p in top.input_shapes])
        op.axis_sizes = dict(MESH)
        op.output_shapes = [_to_jax(p) for p in top.output_shapes]
        op.weight_shapes = {k: _to_jax(p) for k, p in top.weight_shapes.items()}
        same.append(op)
    return out["port"], out["jax"], same


def _simulated(sim_mod, ops):
    machine = sim_mod.SimpleMachineModel(sim_mod.CHIP_PRESETS["test"], 4)
    sim = sim_mod.Simulator(machine, sim_mod.OpCostModel(machine))
    tasks = sim.build_task_graph(ops)
    mu = sim.memory_usage(ops)
    return ([x.name.split(":")[-1] for x in tasks], [x.deps for x in tasks],
            [x.run_time for x in tasks], sim.simulate_runtime(ops),
            (mu.weights, mu.optimizer_state, mu.activations),
            [x.start_time for x in sim.last_tasks()])


def _same_sim(j, t):
    return (j[0] == t[0] and j[1] == t[1] and j[4] == t[4]
            and np.allclose(j[2], t[2], rtol=REL, atol=0) and _close(j[3], t[3])
            and np.allclose(j[5], t[5], rtol=REL, atol=0))


@pytest.mark.parametrize("name", GRAPHS)
def test_task_graph_step_and_memory_match_jax(name):
    """The data-parallel plan on {data: 2, model: 2}: task names, deps
    and durations, simulate_runtime (the port's native replay) and
    memory_usage equal JAX's on the same layouts; on JAX's own layouts
    too, except where the port's layouts depart (``DEPARTS``)."""
    port_ops, jax_ops, jax_on_port = _dp_ops(name)
    calls = native_bridge.SIM_CALLS["sim_taskgraph"]
    t = _simulated(tsim, port_ops)
    assert native_bridge.SIM_CALLS["sim_taskgraph"] == calls + 1
    assert _same_sim(_simulated(jsim, jax_on_port), t)
    assert _same_sim(_simulated(jsim, jax_ops), t) == (name not in DEPARTS)


def test_python_replay_matches_native(monkeypatch):
    """FLEXFLOW_TPU_NATIVE=off: the Python replay gives the native
    engine's makespan and start times on a branchy graph."""
    ns = _ns("port")
    sim = ns.sim.Simulator(ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["test"], 4),
                           overlap_grad_sync=False)
    ops = _branchy_ops(ns, {"model": 4}, {"b0": {"in": "model"}, "b1": {"in": "model"}})
    native = sim.simulate_runtime(ops)
    starts = [x.start_time for x in sim.last_tasks()]
    monkeypatch.setenv("FLEXFLOW_TPU_NATIVE", "off")
    calls = native_bridge.SIM_CALLS["sim_taskgraph"]
    assert sim.simulate_runtime(ops) == pytest.approx(native, rel=REL)
    assert np.allclose([x.start_time for x in sim.last_tasks()], starts, rtol=REL, atol=0)
    assert native_bridge.SIM_CALLS["sim_taskgraph"] == calls


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a simulator source that does not compile raises
    with the compiler's output."""
    bad = tmp_path / "sim_engine.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_bridge, "SIM_SRCS", (bad,))
    monkeypatch.setattr(native_bridge, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_bridge, "_sim_lib", None)
    with pytest.raises(RuntimeError, match="native simulator build failed"):
        native_bridge.build_sim()


@pytest.mark.parametrize("n_ops,stages,mb", [(12, 2, 4), (12, 4, 8), (3, 2, 4)])
@pytest.mark.parametrize("chip,shared,engine", [("test", False, False),
                                                ("test", False, True),
                                                ("cpu-host", True, True)])
def test_rank_pipeline_schedules_matches_jax(n_ops, stages, mb, chip, shared, engine):
    def run(ns):
        m = ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS[chip], stages, shared_host=shared)
        cands = ns.simulator.pipeline_schedule_candidates("auto", 2, stages, n_ops)
        return cands, ns.simulator.rank_pipeline_schedules(
            cands, stages, mb, 0.02, m, cut_bytes_fn=lambda c: 1e6 * c, data_degree=1,
            compiled_ok=engine, bwd_ratio=2.0)
    (jc, (jk, jv, jr)), (tc, (tk, tv, tr)) = _both(run)
    assert jc == tc and (jk, jv) == (tk, tv)
    assert [r["schedule"] for r in jr] == [r["schedule"] for r in tr]
    for a, b in zip(jr, tr):
        assert a.keys() == b.keys()
        for k in a:
            assert (_close(a[k], b[k]) if isinstance(a[k], float) else a[k] == b[k]), (k, a, b)


def test_schedule_helpers_match_jax():
    for cur, v, s, m, n in (("gpipe", 1, 2, 4, 12), ("1f1b", 1, 4, 8, 40),
                            ("interleaved", 2, 2, 4, 16), (None, 1, 2, 4, 3)):
        assert tsimulator.schedule_bubble_candidates(cur, v, s, m, n) == \
            jsimulator.schedule_bubble_candidates(cur, v, s, m, n)
    for axes in ({"data": 8}, {"data": 4, "model": 2}, {"data": 2}):
        assert tsimulator.mesh_reshape_candidates(axes) == jsimulator.mesh_reshape_candidates(axes)
    for sizes in ({"pipe": 2}, {"pipe": 2, "data": 2}, {"pipe": 2, "model": 2}):
        assert tsimulator.compiled_envelope_ok(sizes) == jsimulator.compiled_envelope_ok(sizes)
    specs = {"a": (4, 16), "b": (2, 32)}
    for kv in ("float32", "bfloat16", "int8"):
        assert tsimulator.serving_kv_pool_bytes(specs, 9, 16, kv) == \
            jsimulator.serving_kv_pool_bytes(specs, 9, 16, kv)


# ------------------------------------------------- the port's machine models
def test_tpu_presets_refused_and_explicit_numbers_load(tmp_path):
    for name in ("v4", "v5e", "v5p", "v6e"):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps({"version": "simple", "chip": name, "num_devices": 4}))
        with pytest.raises(ValueError, match="TPU preset.*h100") as e:
            tsim.load_machine_model(str(p))
        assert str(p) in str(e.value)
        assert name not in tsim.CHIP_PRESETS
    assert {"test", "cpu-host"} <= set(tsim.CHIP_PRESETS)
    for name in ("test", "cpu-host"):  # copied exactly
        assert dataclasses.asdict(tsim.CHIP_PRESETS[name]) == \
            dataclasses.asdict(jsim.CHIP_PRESETS[name])
    # a chip given by its numbers loads as in the JAX package
    chip = dataclasses.asdict(jsim.CHIP_PRESETS["v5e"])
    p = tmp_path / "explicit.json"
    p.write_text(json.dumps({"version": "multislice", "chip": chip,
                             "axis_degrees": {"data": 4, "model": 2}, "dcn_axes": ["data"]}))
    m, jm = tsim.load_machine_model(str(p)), jsim.load_machine_model(str(p))
    assert dataclasses.asdict(m.chip) == chip
    for axis, deg in (("data", 4), ("model", 2)):
        assert _close(m.allreduce_time(1e6, deg, axis), jm.allreduce_time(1e6, deg, axis))
    with pytest.raises(ValueError, match="unknown"):
        tmm.chip_preset("a100")


def test_h100_preset_follows_compute_dtype():
    f32, bf16 = tsim.CHIP_PRESETS["h100"], tsim.CHIP_PRESETS["h100-bf16"]
    assert (f32.peak_bf16_flops, bf16.peak_bf16_flops) == (67e12, 989e12)
    assert f32.hbm_bandwidth == bf16.hbm_bandwidth == 3.35e12
    assert (f32.ici_link_bandwidth, f32.dcn_bandwidth) == (450e9, 50e9)
    assert tmm.h100_chip(None) is f32 and tmm.h100_chip("float32") is f32
    assert tmm.h100_chip("bfloat16") is bf16 and tmm.h100_chip("bf16") is bf16
    # the choice is part of the strategy cache's machine signature
    from flexflow_tpu_torch.search.cache import machine_signature

    sigs = [machine_signature(tsim.SimpleMachineModel(c, 1)) for c in (f32, bf16)]
    assert sigs[0] != sigs[1]
    # the CPU: cpu-host over the world size, shared
    m = tsim.detect_machine_model(device="cpu")
    assert m.chip.name == "cpu-host" and m.shared_host and m.num_devices() == 1
    assert tsim.detect_machine_model(4, device="cpu").num_devices() == 4


def test_shared_card_model_prices_staged_collectives():
    """Ranks sharing one card: compute serialized over the ranks (no
    CPU-platform penalties); an all-reduce of S bytes a rank at S / rate +
    latency of the reading for its layout (ranks on the card, group
    size), with no ring factor or degree on top of it; the other
    collectives as the all-reduce that moves as many bytes through each
    rank's link; an unmeasured layout scaled from the nearest reading."""
    staging = {(2, 2): (2e9, 1e-3), (4, 2): (1e9, 2e-3), (4, 4): (5e8, 4e-3)}
    m = tsim.SharedCardMachineModel(tsim.CHIP_PRESETS["h100"], 4, staging=staging)
    assert m.serialization_factor() == 4.0 and m.effective_parallelism(4) == 1.0
    assert m.sharded_compute_penalty({"model"}) == 1.0 and m.gather_inefficiency() == 1.0
    assert m.chip.name == "h100-shared" and m.chip.peak_bf16_flops == 67e12
    assert m.chip.ici_link_bandwidth == 2e9  # the two-rank reading
    S = 4e8
    assert m.allreduce_time(S, 1) == 0.0
    assert m.allreduce_time(S, 2) == pytest.approx(S / 1e9 + 2e-3, rel=1e-12)
    assert m.allreduce_time(S, 4) == pytest.approx(S / 5e8 + 4e-3, rel=1e-12)
    assert m.reducescatter_time(S, 4) == m.allreduce_time(S, 4)
    assert m.allgather_time(S, 4) == pytest.approx(2 * S / 5e8 + 4e-3, rel=1e-12)
    assert m.alltoall_time(S, 4) == pytest.approx(S / 2 / 5e8 + 4e-3, rel=1e-12)
    assert m.permute_time(S, 2) == pytest.approx(S / 1e9 + 2e-3, rel=1e-12)
    two = tsim.SharedCardMachineModel(tsim.CHIP_PRESETS["h100"], 2, staging=staging)
    assert two.allreduce_time(S, 2) == pytest.approx(S / 2e9 + 1e-3, rel=1e-12)
    # 8 ranks in groups of 2: the (4, 2) reading, twice the host's bytes
    eight = tsim.SharedCardMachineModel(tsim.CHIP_PRESETS["h100"], 8, staging=staging)
    assert eight.allreduce_time(S, 2) == pytest.approx(2 * S / 1e9 + 2e-3, rel=1e-12)
    # 8 in one group: the (4, 4) reading, 2 x (7/8)/(3/4) the bytes, 7/3 the steps
    assert eight.allreduce_time(S, 8) == pytest.approx(
        2 * (7 / 8) / (3 / 4) * S / 5e8 + 4e-3 * 7 / 3, rel=1e-12)
    # the default readings are the card's
    d = tsim.SharedCardMachineModel(tsim.CHIP_PRESETS["h100"], 4)
    assert set(d.staging) == {(n, dg, *v) for (n, dg), v in tmm.SHARED_CARD_STAGING.items()}
    # the readings are part of the strategy cache's machine signature
    from flexflow_tpu_torch.search.cache import machine_signature

    assert machine_signature(m) != machine_signature(d)


def test_shared_card_prices_the_ports_gradient_sync():
    """On a shared card the gradient sync is priced as the port's step
    runs it (runtime/compiler.py's mesh step): over the axes that
    partition the op's output and not the weight, in bucketed all-reduces
    (no latency a weight: one a bucket, priced over the step, the next
    test). A data-parallel MLP on {data: 2, model: 2} syncs
    over data only (its model-axis replicas computed the same gradient);
    JAX's rule, which cpu-host keeps, prices the combined degree 4 a
    weight, latency included. fc1 sharded {"out": "model"} syncs its half
    over data."""
    staging = {(4, 2): (1e9, 2e-3), (4, 4): (5e8, 4e-3)}
    m = tsim.SharedCardMachineModel(tsim.CHIP_PRESETS["h100"], 4, staging=staging)
    cm = tsim.OpCostModel(m)
    axes = {"data": 2, "model": 2}
    fc1 = next(o for o in _mlp_ops(_ns("port"), axes) if o.name == "fc1")
    w = (64 * 128 + 128) * 4
    assert cm.measure(fc1).sync_time == pytest.approx(w / 1e9, rel=1e-12)
    jax_rule = m.allreduce_time(64 * 128 * 4, 4) + m.allreduce_time(128 * 4, 4)
    assert jax_rule > 2 * cm.measure(fc1).sync_time
    tp = next(o for o in _mlp_ops(_ns("port"), axes, {"fc1": {"out": "model"}})
              if o.name == "fc1")
    assert tsim.OpCostModel(m).measure(tp).sync_time == pytest.approx(w / 2 / 1e9, rel=1e-12)
    # one rank's replicas on one axis: no sync at all
    m1 = tsim.SharedCardMachineModel(tsim.CHIP_PRESETS["h100"], 4, staging=staging)
    rep = next(o for o in _mlp_ops(_ns("port"), {"model": 4}) if o.name == "fc1")
    assert tsim.OpCostModel(m1).measure(rep).sync_time == 0.0


def test_shared_card_prices_one_latency_a_gradient_bucket(monkeypatch):
    """The port's mesh step issues one all-reduce a gradient bucket, cut by
    parallel/grad_buckets.py: the simulator's grad_sync task
    on a shared card is the weights' bytes at the staging rate plus one
    latency a bucket. The {data: 2} MLP's gradients in backward order:
    fc2's kernel (8 KiB) and bias (64 B), fc1's kernel (32 KiB) and bias
    (512 B): one bucket at DDP's 25 MiB, three at 8 KiB (fc2.kernel |
    fc2.bias, fc1.kernel | fc1.bias), four at one byte. A machine whose
    weights price their own calls adds none."""
    from flexflow_tpu_torch.parallel import grad_buckets

    m = tsim.SharedCardMachineModel(tsim.CHIP_PRESETS["h100"], 2, staging={(2, 2): (1e9, 2e-3)})
    cm = tsim.OpCostModel(m)
    ops = _mlp_ops(_ns("port"), {"data": 2})
    payload = (64 * 128 + 128 + 128 * 16 + 16) * 4
    for size, n in ((25 << 20, 1), (8 << 10, 3), (1, 4)):
        monkeypatch.setattr(grad_buckets, "GRAD_BUCKET_BYTES", size)
        assert cm.grad_sync_latency(ops) == pytest.approx(n * 2e-3, rel=1e-12)
        for overlap in (False, True):
            sim = tsim.Simulator(m, cm, overlap_grad_sync=overlap)
            task = next(t for t in sim.build_task_graph(ops) if t.name == "grad_sync")
            assert task.run_time == pytest.approx(payload / 1e9 + n * 2e-3, rel=1e-12)
    plain = tsim.OpCostModel(tsim.SimpleMachineModel(tsim.CHIP_PRESETS["h100"], 2))
    assert plain.grad_sync_latency(ops) == 0.0


def test_measure_staging_rate_over_layouts():
    """The staging readings: one per (ranks, group size) layout, each a
    positive rate and latency fitted over the sizes (gloo ranks on the
    CPU here; on the card in chip_smoke.py)."""
    from flexflow_tpu_torch.sim.calibrate import measure_staging_rate

    got = measure_staging_rate(sizes=(1 << 12, 1 << 18), iters=2, device="cpu",
                               layouts=((2, 2), (4, 2), (4, 4)))
    assert [(r["ranks"], r["degree"]) for r in got] == [(2, 2), (4, 2), (4, 4)]
    for r in got:
        assert r["rate"] > 0 and np.isfinite(r["rate"]) and r["latency"] >= 0
        assert sorted(r["points"]) == [1 << 12, 1 << 18]
    table = {(r["ranks"], r["degree"]): (r["rate"], r["latency"]) for r in got}
    m = tsim.SharedCardMachineModel(tsim.CHIP_PRESETS["h100"], 4, staging=table)
    assert m.allreduce_time(1 << 18, 4) == pytest.approx(
        (1 << 18) / table[(4, 4)][0] + table[(4, 4)][1], rel=1e-12)


def test_multihost_machine_model_prices_the_cross_process_axis():
    from flexflow_tpu_torch.parallel import multihost as mh

    spec = mh.two_level_mesh_spec(2, 4, model_degree=2)
    assert spec["machine_model"] == {"version": "multislice", "chip": "h100",
                                     "axis_degrees": {"data": 4, "model": 2},
                                     "dcn_axes": ["data"]}
    m = tsim.multihost_machine_model(2, 4, model_degree=2)
    assert isinstance(m, tsim.MultiSliceMachineModel) and m.num_devices() == 8
    # the data axis at the NIC's 50 GB/s, the model axis on NVLink
    assert m._bw("data") == 50e9 and m._bw("model") == 2 * 450e9
    one = tsim.multihost_machine_model(1, 4)
    assert one.dcn_axes == ()
