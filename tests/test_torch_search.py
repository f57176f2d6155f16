"""The port's search (``flexflow_tpu_torch/search/``) held to the JAX
package's on the CPU: the counterparts of ``tests/test_search.py`` and of
the rewrite tests of ``tests/test_graph_xfer.py`` (each scenario run in
both packages, the JAX test's assertions kept), ``candidate_strategies``
per layer, ``graph_optimize``, ``memory_aware_search``, ``full_search``
and ``mcmc_optimize`` giving JAX's strategies, mesh, ``states_explored``
and ``est_step_time`` (1e-9 relative), the forked workers bit-identical to
the serial search, ``compile`` with a search on a mesh of ranks (gloo)
giving JAX's plan and training within ``test_torch_parallel_training.py``'s
bounds, and a file in the reference's GraphXfer schema compiling.

The departure: the port's attention reads its input's hidden dim whole
(its ``propagate`` gathers what an op reads across), so a frontier state where a tensor-parallel
dense left the hidden dim sharded gives the attention a replicated output
where JAX's inherits the sharding. On graphs with attention and a model
axis the two DPs walk other states; there the test holds the port's plan's
estimate to JAX's cost model priced on the port's layouts (1e-9), and
shows that the plans differ."""

import dataclasses
import json
import re

import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.core.op import create_op as jcreate_op
from flexflow_tpu.search import graph_xfer as jxfer
from flexflow_tpu.search import mcmc as jmcmc
from flexflow_tpu.search import unity as junity
from flexflow_tpu import sim as jsim
from flexflow_tpu_torch.parallel.distributed import spawn
from flexflow_tpu_torch.search import graph_xfer as txfer
from flexflow_tpu_torch.search import mcmc as tmcmc
from flexflow_tpu_torch.search import unity as tunity
from flexflow_tpu_torch import sim as tsim

from test_torch_sim import _close, _ns, _to_jax
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

EST = 1e-9  # est_step_time, relative


def _both(fn):
    return fn(_ns("jax")), fn(_ns("port"))


def _transformer_ish(ns, B=64, D=128, H=8, layers=2):
    ff = ns.FFModel(ns.cfg(batch_size=B))
    x = ff.create_tensor((B, 16, D), ns.DataType.FLOAT, name="x")
    h = x
    for i in range(layers):
        a = ff.multihead_attention(h, h, h, D, H, name=f"attn{i}")
        h = ff.add(a, h, name=f"res{i}")
        f = ff.dense(ff.dense(h, 4 * D, name=f"ff{i}_up"), D, name=f"ff{i}_down")
        h = ff.add(f, h, name=f"res{i}b")
    return ff, x


def _mlp_ish(ns, B=64, D=256, layers=3):
    ff = ns.FFModel(ns.cfg(batch_size=B))
    x = ff.create_tensor((B, D), ns.DataType.FLOAT, name="x")
    h = x
    for i in range(layers):
        h = ff.relu(ff.dense(h, 4 * D if i % 2 == 0 else D, name=f"fc{i}"), name=f"r{i}")
    ff.dense(h, 8, name="head")
    return ff, x


def _input_ps(ns, t, data_deg):
    dims = [ns.PD(s, data_deg, "data") if i == 0 and data_deg > 1 else ns.PD(s)
            for i, s in enumerate(t.dims)]
    return {t.tensor_id: ns.PTS(tuple(dims), t.dtype)}


def _machine(ns, chip="test", n=8, **kw):
    c = ns.sim.CHIP_PRESETS[chip] if isinstance(chip, str) else chip
    return ns.sim.SimpleMachineModel(c, n, **kw)


def _canon(strategies):
    """Strategies keyed by layer name, auto-named layers' process-local
    counter dropped (each package numbers its unnamed layers itself)."""
    return {re.sub(r"_\d+$", "_#", k): v for k, v in strategies.items()}


def _same_result(j, t, rel=EST):
    assert _canon(t.strategies) == _canon(j.strategies), (t.strategies, j.strategies)
    assert t.mesh_shape == j.mesh_shape
    assert t.states_explored == j.states_explored
    assert t.est_memory == j.est_memory
    assert np.isclose(t.est_step_time, j.est_step_time, rtol=rel, atol=0)
    assert t.rewrites == j.rewrites and t.pipe_schedule == j.pipe_schedule


def _jax_price(tff, jff, tx, axis, strategies, machine, overlap=True):
    """JAX's cost model on the port's layouts of a plan: the sum over
    layers of forward, backward, sync and both collectives, as
    graph_optimize accumulates its estimate."""
    tns = _ns("port")
    ops, _ = tns.build_ops(tff.layers, tunity.data_parallel_input_pshapes([tx], axis), axis,
                           strategies)
    sim = jsim.Simulator(machine, jsim.OpCostModel(machine), overlap_grad_sync=overlap)
    total = 0.0
    for op, jl in zip(ops, jff.layers):
        jop = jcreate_op(jl, [_to_jax(p) for p in op.input_shapes])
        jop.axis_sizes = dict(axis)
        jop.output_shapes = [_to_jax(p) for p in op.output_shapes]
        jop.weight_shapes = {k: _to_jax(p) for k, p in op.weight_shapes.items()}
        c = sim.cost_model.measure(jop)
        total += (c.forward_time + c.backward_time + c.sync_time
                  + sim._comm_time(jop, False) + sim._comm_time(jop, True))
    return total


def _bit_identical(r1, r2):
    return (r1.strategies == r2.strategies and r1.mesh_shape == r2.mesh_shape
            and r1.est_step_time == r2.est_step_time and r1.rewrites == r2.rewrites)


def _graph_inputs(ff):
    seen, out = set(), []
    for l in ff.layers:
        for t in l.inputs:
            if t.owner_layer is None and t.tensor_id not in seen:
                seen.add(t.tensor_id)
                out.append(t)
    return out


# ------------------------------------------------------ tests/test_search.py
def test_candidate_strategies_linear():
    def run(ns):
        ff = ns.FFModel(ns.cfg(batch_size=8))
        ff.dense(ff.create_tensor((8, 64), ns.DataType.FLOAT, name="x"), 128, name="fc")
        layer = ff.layers[0]
        return (ns.sub.candidate_strategies(layer, {"data": 2, "model": 4}),
                ns.sub.candidate_strategies(layer, {"model": 3}))
    j, t = _both(run)
    assert {} in t[0] and {"out": "model"} in t[0] and {"in": "model"} in t[0]
    assert t[1] == [{}] and j == t


@pytest.mark.parametrize("name", ["mlp", "transformer", "moe", "moe_stacked", "dlrm",
                                  "resnet_stem"])
def test_candidate_strategies_every_layer_match_jax(name):
    from test_torch_sim import _graph

    for axis in ({"data": 2, "model": 2}, {"model": 4}, {"data": 2, "seq": 2},
                 {"data": 2, "expert": 2}):
        def run(ns):
            layers, _ = _graph(ns, name)
            return [ns.sub.candidate_strategies(l, axis, ns.cfg(batch_size=8, search_budget=1))
                    for l in layers]
        j, t = _both(run)
        assert j == t, axis


def test_graph_optimize_runs_and_memoizes():
    axis = {"data": 2, "model": 4}

    def run(ns):
        ff, x = _transformer_ish(ns)
        machine = _machine(ns)
        r = ns.unity.graph_optimize(ff.layers, _input_ps(ns, x, 2), axis,
                                    ns.sim.Simulator(machine, ns.sim.OpCostModel(machine)),
                                    beam_width=16)
        return ff, x, r, machine
    (jff, jx, j, jm), (tff, tx, t, tm) = _both(run)
    assert t.est_step_time > 0 and t.est_memory > 0
    assert set(t.strategies) == {l.name for l in tff.layers}
    assert t.states_explored >= len(tff.layers)
    # the departure: the port's attention gathers a model-sharded hidden dim
    assert t.states_explored != j.states_explored
    assert np.isclose(t.est_step_time, _jax_price(tff, jff, tx, axis, t.strategies, jm),
                      rtol=EST, atol=0)


def test_search_beats_or_matches_data_parallel():
    axis = {"data": 2, "model": 4}
    ns = _ns("port")
    ff, x = _transformer_ish(ns, B=32, D=256, H=8)
    machine = _machine(ns)
    sim = ns.sim.Simulator(machine, ns.sim.OpCostModel(machine))
    r = ns.unity.graph_optimize(ff.layers, _input_ps(ns, x, 2), axis, sim, beam_width=32)
    t_dp = sim.simulate_runtime(ns.build_ops(ff.layers, _input_ps(ns, x, 2), axis, {})[0])
    t_best = sim.simulate_runtime(ns.build_ops(ff.layers, _input_ps(ns, x, 2), axis,
                                               r.strategies)[0])
    assert t_best <= t_dp + 1e-12
    jns = _ns("jax")
    jff, jx = _transformer_ish(jns, B=32, D=256, H=8)
    jsim_ = jsim.Simulator(_machine(jns), jsim.OpCostModel(_machine(jns)))
    # the data-parallel plan walks no departing state: equal to JAX's
    assert _close(t_dp, jsim_.simulate_runtime(
        jns.build_ops(jff.layers, _input_ps(jns, jx, 2), axis, {})[0]))


def test_enumerate_mesh_shapes():
    for args in ((8,), (8, True), (8, False, True), (12, True, True, 3), (6, False, False, 2)):
        assert tunity.enumerate_mesh_shapes(*args) == junity.enumerate_mesh_shapes(*args)
    shapes = tunity.enumerate_mesh_shapes(8)
    for s in ({"data": 8}, {"model": 8}, {"data": 2, "model": 4}, {"data": 4, "model": 2}):
        assert s in shapes
    assert {"data": 2, "expert": 4} in tunity.enumerate_mesh_shapes(8, has_moe=True)


def test_full_search_picks_a_mesh():
    def run(ns):
        ff, x = _transformer_ish(ns, B=64, D=128)
        machine = _machine(ns)
        return ff, x, ns.unity.full_search(ff.layers, [x], machine, beam_width=8), machine
    (jff, jx, j, jm), (tff, tx, t, tm) = _both(run)
    assert int(np.prod(list(t.mesh_shape.values()))) == 8 and t.est_step_time > 0
    assert t.candidates == j.candidates
    if t.mesh_shape.get("pipe", 1) == 1:
        assert np.isclose(t.est_step_time,
                          _jax_price(tff, jff, tx, t.mesh_shape, t.strategies, jm),
                          rtol=EST, atol=0)


def test_mcmc_never_worse_than_start():
    axis = {"data": 2, "model": 4}

    def run(ns, graph):
        ff, x = graph(ns)
        machine = _machine(ns)
        sim = ns.sim.Simulator(machine, ns.sim.OpCostModel(machine))
        mc = jmcmc if ns.sim is jsim else tmcmc
        start = mc._evaluate(ff.layers, _input_ps(ns, x, 2), axis, {}, sim)
        r = mc.mcmc_optimize(ff.layers, _input_ps(ns, x, 2), axis, sim, budget=60, seed=1)
        return start, r
    start, t = run(_ns("port"), lambda ns: _transformer_ish(ns, B=32, D=128))
    assert t.est_step_time <= start + 1e-12
    # on a graph without attention the annealing walks JAX's states: the
    # same seed gives the same plan, estimate and memory
    (js, j), (ts, t) = (run(_ns(p), lambda ns: _mlp_ish(ns, B=32)) for p in ("jax", "port"))
    assert _close(js, ts)
    _same_result(j, t)


def test_search_deterministic_across_runs():
    """Same graph, config and machine: identical strategies; the H100
    preset's numbers given to both packages pick the same plan."""
    h100 = dataclasses.asdict(tsim.CHIP_PRESETS["h100"])
    results = []
    for pkg in ("port", "port", "jax"):
        ns = _ns(pkg)
        ff, x = _mlp_ish(ns)
        chip = (ns.sim.CHIP_PRESETS["h100"] if pkg == "port"
                else jsim.machine_model.TPUChipSpec(**h100))
        r = ns.unity.full_search(ff.layers, [x], _machine(ns, chip), ns.cfg(batch_size=64))
        results.append(r)
    assert (results[0].mesh_shape, sorted(results[0].strategies.items())) == \
        (results[1].mesh_shape, sorted(results[1].strategies.items()))
    _same_result(results[2], results[0])


def test_enumerate_three_axis_and_pipe_shapes():
    shapes = tunity.enumerate_mesh_shapes(8, has_moe=True, has_attention=True, max_pipe=2)
    assert shapes == junity.enumerate_mesh_shapes(8, has_moe=True, has_attention=True,
                                                  max_pipe=2)
    for s in ({"data": 2, "model": 2, "seq": 2}, {"data": 2, "model": 2, "expert": 2},
              {"model": 2, "seq": 4}, {"pipe": 2, "data": 2, "model": 2}):
        assert s in shapes
    assert all(s.get("pipe", 1) == 1 for s in tunity.enumerate_mesh_shapes(8))


def test_full_search_considers_three_axis_mesh():
    def run(ns):
        ff, x = _transformer_ish(ns, B=64, D=128, H=8, layers=2)
        triples = [s for s in ns.unity.enumerate_mesh_shapes(8, has_attention=True)
                   if len(s) == 3]
        machine = _machine(ns)
        return ff, x, ns.unity.full_search(ff.layers, [x], machine, ns.cfg(batch_size=64),
                                           mesh_shapes=triples), machine
    (jff, jx, j, jm), (tff, tx, t, tm) = _both(run)
    assert set(t.mesh_shape) == {"data", "model", "seq"} and t.est_step_time > 0
    assert np.isclose(t.est_step_time, _jax_price(tff, jff, tx, t.mesh_shape, t.strategies, jm),
                      rtol=EST, atol=0)


def test_pipe_mesh_wins_when_sync_dominates():
    """Huge weights, a tiny batch and a slow fabric: a pipe split beats
    data parallelism in both packages, with JAX's schedule and estimate."""
    def run(ns):
        slow = dataclasses.replace(ns.sim.CHIP_PRESETS["test"], ici_link_bandwidth=1e9)
        ff = ns.FFModel(ns.cfg(batch_size=8, search_budget=1))
        x = ff.create_tensor((8, 1024), ns.DataType.FLOAT, name="x")
        h = x
        for i in range(6):
            h = ff.relu(ff.dense(h, 1024, name=f"fc{i}"), name=f"a{i}")
        ff.dense(h, 8, name="head")
        return ns.unity.full_search(ff.layers, [x], _machine(ns, slow),
                                    ns.cfg(batch_size=8, search_budget=1),
                                    max_pipe=len(ff.layers) // 2)
    j, t = _both(run)
    assert t.mesh_shape.get("pipe", 1) > 1, t.mesh_shape
    _same_result(j, t)
    assert t.pipe_engine == j.pipe_engine
    assert [r["schedule"] for r in t.pipe_schedule_records] == \
        [r["schedule"] for r in j.pipe_schedule_records]


def test_memory_lambda_search_finds_fastest_fitting():
    B, DIN, DOUT = 256, 128, 65535
    axis = {"data": 2, "model": 2}

    def run(ns):
        ff = ns.FFModel(ns.cfg(batch_size=B))
        x = ff.create_tensor((B, DIN), ns.DataType.FLOAT, name="x")
        ff.dense(x, DOUT, name="big")
        slow = dataclasses.replace(ns.sim.CHIP_PRESETS["test"], ici_link_bandwidth=2e9)
        machine = _machine(ns, slow, 4)
        sim = ns.sim.Simulator(machine, ns.sim.OpCostModel(machine))
        free = ns.unity.memory_aware_search(ff.layers, _input_ps(ns, x, 2), axis, sim,
                                            memory_budget=machine.chip.hbm_capacity)
        tight = ns.unity.memory_aware_search(ff.layers, _input_ps(ns, x, 2), axis, sim,
                                             memory_budget=100 * (1 << 20))
        return free, tight
    (jf, jt), (tf, tt) = _both(run)
    assert tf.mem_lambda == 0.0 and tf.strategies["big"] == {}
    assert tt.est_memory <= 100 * (1 << 20) and tt.mem_lambda > 0.0
    assert tt.strategies["big"] == {"in": "model"}
    assert tt.est_step_time >= tf.est_step_time
    _same_result(jf, tf)
    _same_result(jt, tt)
    assert tt.mem_lambda == jt.mem_lambda


class _FakeMesh:
    """A pinned mesh's shape, for the search alone (no process group)."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _port_search(cfg_kw, build, mesh_shape):
    """The port's FFModel._run_search on a pinned mesh, without ranks."""
    ff = T.FFModel(T.FFConfig(device="cpu", **cfg_kw))
    logits = build(ff)
    strat, _ = ff._run_search(_FakeMesh(mesh_shape), logits)
    return ff, strat


def _jax_compile(cfg_kw, build, mesh_shape, **compile_kw):
    jff = J.FFModel(J.FFConfig(ledger="off", audit_programs="off", attribution="off",
                               **cfg_kw))
    build(jff)
    n = int(np.prod(list(mesh_shape.values())))
    import jax

    from flexflow_tpu.core.machine import make_mesh

    jff.compile(J.SGDOptimizer(jff, 0.05), J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [],
                mesh=make_mesh(mesh_shape, jax.devices()[:n]), **compile_kw)
    return jff


def _big_mlp(ff):
    x = ff.create_tensor((32, 512), name="x")
    h = ff.dense(x, 4096, name="big_up")
    return ff.dense(h, 8, name="head")


def test_memory_search_via_compile():
    """--memory-search and --memory-threshold reach the search compile()
    runs: the plan fits 24 MiB by sharding over the model axis, JAX's."""
    cfg = T.FFConfig.parse_args(["--budget", "1", "--memory-search", "--memory-threshold", "24"])
    assert cfg.perform_memory_search and cfg.memory_threshold_mb == 24 and cfg.search_budget == 1
    kw = dict(batch_size=32, search_budget=1, perform_memory_search=True, memory_threshold_mb=24)
    mesh = {"data": 2, "model": 4}
    ff, strat = _port_search(kw, _big_mlp, mesh)
    r = ff.search_result
    assert r.est_memory <= 24 * (1 << 20)
    assert any("model" in str(v) for v in r.strategies.values()), r.strategies
    jff = _jax_compile(dict(kw), _big_mlp, mesh)
    _same_result(jff.search_result, r)
    assert strat == r.strategies


def test_substitution_json_changes_search_outcome(tmp_path, monkeypatch):
    from flexflow_tpu_torch.search import substitution as sub

    monkeypatch.setattr(sub, "_JSON_RULES", {})
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps({"rules": {"MULTIHEAD_ATTENTION": [{"seq": "model"}]}}))
    axis = {"data": 2, "model": 4}

    def run(ns):
        ff = ns.FFModel(ns.cfg(batch_size=32))
        x = ff.create_tensor((32, 1024, 128), ns.DataType.FLOAT, name="x")
        ff.dense(ff.multihead_attention(x, x, x, 128, 2, name="attn"), 1, name="head")
        machine = _machine(ns)
        return ns.unity.graph_optimize(ff.layers, _input_ps(ns, x, 2), axis,
                                       ns.sim.Simulator(machine, ns.sim.OpCostModel(machine)))
    before = run(_ns("port"))
    assert before.strategies["attn"] == {}
    assert sub.load_substitution_json(str(rules)) == 1
    after = run(_ns("port"))
    assert after.strategies["attn"] == {"seq": "model"}, after.strategies
    from flexflow_tpu.search import substitution as jsub

    monkeypatch.setattr(jsub, "_JSON_RULES", {})
    jsub.load_substitution_json(str(rules))
    _same_result(run(_ns("jax")), after)


def test_load_machine_model_file(tmp_path):
    p = tmp_path / "simple.json"
    p.write_text(json.dumps({"version": "simple", "chip": "h100", "num_devices": 16}))
    m = tsim.load_machine_model(str(p))
    assert m.num_devices() == 16 and m.chip.name == "h100"
    p = tmp_path / "torus.json"
    p.write_text(json.dumps({"version": "torus", "chip": "test",
                             "axis_degrees": {"data": 16, "model": 4},
                             "axis_links": {"data": 2}}))
    m, jm = tsim.load_machine_model(str(p)), jsim.load_machine_model(str(p))
    assert isinstance(m, tsim.TorusMachineModel) and m.num_devices() == 64
    assert m._bw("data") == 2 * m._bw("model") == jm._bw("data")
    p = tmp_path / "ms.json"
    p.write_text(json.dumps({
        "version": "multislice",
        "chip": {"name": "custom", "peak_bf16_flops": 1e14, "hbm_bandwidth": 1e12,
                 "hbm_capacity": 2 ** 34, "ici_link_bandwidth": 4.5e10, "ici_num_links": 4},
        "axis_degrees": {"data_dcn": 2, "data": 8}, "dcn_axes": ["data_dcn"]}))
    m, jm = tsim.load_machine_model(str(p)), jsim.load_machine_model(str(p))
    assert isinstance(m, tsim.MultiSliceMachineModel) and m.chip.name == "custom"
    assert m._bw("data_dcn") < m._bw("data")
    assert (m._bw("data_dcn"), m._bw("data")) == (jm._bw("data_dcn"), jm._bw("data"))


def test_machine_model_file_used_by_search(tmp_path, monkeypatch):
    import flexflow_tpu_torch.sim as sim_pkg

    p = tmp_path / "mm.json"
    p.write_text(json.dumps({"version": "simple", "chip": "h100", "num_devices": 8}))
    calls, real = [], sim_pkg.load_machine_model
    monkeypatch.setattr(sim_pkg, "load_machine_model",
                        lambda path: (calls.append(path), real(path))[1])

    def build(ff):
        return ff.dense(ff.create_tensor((32, 64), name="x"), 128, name="fc")
    ff, _ = _port_search(dict(batch_size=32, search_budget=1, machine_model_file=str(p)),
                         build, {"data": 2, "model": 4})
    assert calls == [str(p)] and ff.search_result is not None


def test_disable_sample_parallel_replicates_inputs():
    def run(ns):
        ff = ns.FFModel(ns.cfg(batch_size=32))
        x = ff.create_tensor((32, 64), ns.DataType.FLOAT, name="x")
        return [str(p) for p in ns.unity.data_parallel_input_pshapes(
            [x], {"data": 8}, sample_parallel=False).values()]
    j, t = _both(run)
    assert t == ["[32, 64]"] and j == t
    # the search prices the replicated input, and the compile builds it:
    # input layouts on a 2-rank mesh are checked in the ranks' test below
    assert T.FFConfig.parse_args(["--disable-sample-parallel"]).enable_sample_parallel is False


def test_memory_cap_forces_model_parallelism():
    B, D = 32, 512

    def run(ns):
        ff = ns.FFModel(ns.cfg(batch_size=B))
        x = ff.create_tensor((B, D), ns.DataType.FLOAT, name="x")
        ff.dense(ff.dense(x, 8 * D, name="big_up"), D, name="big_down")
        small = dataclasses.replace(ns.sim.CHIP_PRESETS["test"],
                                    hbm_capacity=int(2 * (D * 8 * D) * 4 * 2.2))
        machine = _machine(ns, small, 4)
        return ns.unity.graph_optimize(ff.layers, _input_ps(ns, x, 4), {"data": 2, "model": 2},
                                       ns.sim.Simulator(machine, ns.sim.OpCostModel(machine)),
                                       None)
    j, t = _both(run)
    assert any("model" in str(v) for v in t.strategies.values()), t.strategies
    _same_result(j, t)


def test_networked_machine_model_drives_search(tmp_path):
    p = tmp_path / "net.json"
    p.write_text(json.dumps({"version": "networked", "chip": "test",
                             "axis_degrees": {"data": 2, "model": 4}, "topology": [2, 4]}))

    def run(ns):
        machine = ns.sim.load_machine_model(str(p))
        assert isinstance(machine, ns.sim.NetworkedMachineModel)
        ff = ns.FFModel(ns.cfg(batch_size=32))
        x = ff.create_tensor((32, 256), ns.DataType.FLOAT, name="x")
        ff.dense(ff.dense(x, 4096, name="big"), 8, name="head")
        return ns.unity.full_search(ff.layers, [x], machine, ns.cfg(batch_size=32),
                                    mesh_shapes=[{"data": 2, "model": 4}])
    j, t = _both(run)
    assert t.est_step_time > 0 and t.strategies
    _same_result(j, t)


def test_parallel_full_search_bit_identical_mlp_dlrm():
    """Four forked workers (the pure-Python cost model, no torch kernel
    and no CUDA in a child) pick the serial search's plan bit for bit, and
    JAX's."""
    def run(ns, build, workers):
        ff = ns.FFModel(ns.cfg(batch_size=64))
        build(ns, ff)
        return [ns.unity.full_search(ff.layers, _graph_inputs(ff), _machine(ns),
                                     ns.cfg(batch_size=64, search_budget=1), num_workers=n)
                for n in workers]
    mlp = lambda ns, ff: ns.models.build_mlp(ff, 64)  # noqa: E731
    dlrm = lambda ns, ff: ns.models.build_dlrm(  # noqa: E731
        ff, 64, ns.models.DLRMConfig(embedding_size=[1000] * 4))
    for build in (mlp, dlrm):
        t1, t4 = run(_ns("port"), build, (1, 4))
        assert t4.workers == 4 and t1.workers == 1
        assert _bit_identical(t1, t4), (t1.mesh_shape, t4.mesh_shape)
        _same_result(run(_ns("jax"), build, (1,))[0], t1)


def test_parallel_full_search_bit_identical_rewritten_graph():
    def run(ns, workers):
        cfg = ns.cfg(batch_size=32, search_budget=1)
        ff = ns.FFModel(cfg)
        x = ff.create_tensor((32, 256), ns.DataType.FLOAT, name="x")
        h = x
        for i in range(3):
            h = ff.relu(ff.dense(h, 256, name=f"fc{i}"), name=f"relu{i}")
        ff.dense(h, 8, name="head")
        xfer = jxfer if ns.sim is jsim else txfer
        assert len(xfer.graph_variants(ff.layers, cfg)) > 1
        return [ns.unity.full_search(ff.layers, [x], _machine(ns), cfg, num_workers=n)
                for n in workers]
    t1, t4 = run(_ns("port"), (1, 4))
    assert _bit_identical(t1, t4) and t4.workers == 4
    _same_result(run(_ns("jax"), (1,))[0], t1)


def test_bound_pruning_is_selection_neutral_and_counted():
    def run(ns, build, batch, prunes):
        ff = ns.FFModel(ns.cfg(batch_size=batch))
        build(ns, ff)
        return [ns.unity.full_search(ff.layers, _graph_inputs(ff), _machine(ns),
                                     ns.cfg(batch_size=batch, search_budget=1), prune=p,
                                     num_workers=1) for p in prunes]
    deep = lambda ns, ff: ns.models.build_mlp(ff, 256, hidden_dims=(1024,) * 16)  # noqa
    dlrm = lambda ns, ff: ns.models.build_dlrm(  # noqa: E731
        ff, 64, ns.models.DLRMConfig(embedding_size=[1000] * 4))
    p, n = run(_ns("port"), deep, 256, (True, False))
    assert _bit_identical(p, n) and p.candidates == n.candidates > 0
    assert p.pruned >= 1 and n.pruned == 0
    jp = run(_ns("jax"), deep, 256, (True,))[0]
    _same_result(jp, p)
    assert (jp.candidates, jp.pruned) == (p.candidates, p.pruned)
    assert _bit_identical(*run(_ns("port"), dlrm, 64, (True, False)))


def test_search_profile_records_counters():
    def build(ff):
        return ff.dense(ff.dense(ff.create_tensor((32, 64), name="x"), 128, name="fc1"), 8,
                        name="fc2")
    ff, _ = _port_search(dict(batch_size=32, search_budget=1), build, {"data": 2, "model": 4})
    prof = ff.search_profile
    assert prof["cache"] == "off" and prof["candidates"] >= 1 and prof["pruned"] >= 0
    assert prof["search_time_s"] > 0 and prof["mesh_shape"] == {"data": 2, "model": 4}
    assert prof["est_step_time"] == ff.search_result.est_step_time
    from flexflow_tpu_torch.obs.metrics import metrics_registry

    assert metrics_registry().counter("search.cache.off").value >= 1


def test_spatial_candidate_profitability_gate():
    def run(ns):
        def conv_layer(batch, h):
            ff = ns.FFModel(ns.cfg(batch_size=batch))
            x = ff.create_tensor((batch, 8, h, h), ns.DataType.FLOAT, name="im")
            ff.conv2d(x, 16, 3, 3, 1, 1, 1, 1, name="c")
            return ff.layers[0]
        cfg = ns.cfg(batch_size=32, search_budget=1)
        return [ns.sub.candidate_strategies(conv_layer(32, 16), {"data": 2, "model": 4}, cfg),
                ns.sub.candidate_strategies(conv_layer(32, 16), {"model": 4}, cfg),
                ns.sub.candidate_strategies(conv_layer(32, 256), {"data": 2, "model": 4}, cfg)]
    j, t = _both(run)
    assert not any("spatial" in c for c in t[0])
    assert any(c.get("spatial") == "model" for c in t[1])
    assert any(c.get("spatial") == "model" for c in t[2])
    assert j == t


# --------------------------------------------- tests/test_graph_xfer.py:51-173
def _mlp_layers(ns):
    ff = ns.FFModel(ns.cfg(batch_size=8))
    x = ff.create_tensor((8, 16), name="x")
    ff.dense(ff.relu(ff.dense(x, 32, name="d1"), name="r1"), 4, name="d2")
    return ff, x


def _branchy_layers(ns, k=4, width=32):
    ff = ns.FFModel(ns.cfg(batch_size=8))
    x = ff.create_tensor((8, 16), name="x")
    outs = [ff.dense(x, width, name=f"b{i}") for i in range(k)]
    t = ff.relu(ff.concat(outs, axis=-1, name="cat"), name="act")
    ff.dense(t, 4, name="head")
    return ff, x


def _desc(layers):
    return [(l.op_type.name, l.name, sorted((k, str(v)) for k, v in l.attrs.items()
                                             if not k.startswith("_") or k == "_origin_rewrite"),
             [t.tensor_id for t in l.outputs]) for l in layers]


def test_linear_activation_fusion_rewrite():
    ff, _ = _mlp_layers(_ns("port"))
    rw = txfer.LinearActivationFusion()
    assert len(rw.find(ff.layers)) == 1
    new = rw.apply_all(list(ff.layers))
    assert len(new) == len(ff.layers) - 1
    fused = new[0]
    assert fused.op_type is T.OpType.LINEAR and fused.attrs["activation"] is T.ActiMode.RELU
    assert fused.outputs[0].tensor_id == ff.layers[1].outputs[0].tensor_id
    assert len(ff.layers) == 3
    assert ff.layers[0].attrs.get("activation", T.ActiMode.NONE) is T.ActiMode.NONE
    jff, _ = _mlp_layers(_ns("jax"))
    jnew = jxfer.LinearActivationFusion().apply_all(list(jff.layers))
    assert [(l.op_type.name, l.name) for l in jnew] == [(l.op_type.name, l.name) for l in new]


def test_linear_activation_fusion_skips_multi_consumer():
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu"))
    t = ff.dense(ff.create_tensor((8, 16), name="x"), 32, name="d1")
    ff.add(ff.relu(t, name="r1"), t, name="skip")
    assert txfer.LinearActivationFusion().find(ff.layers) == []


def test_parallel_linear_merge_rewrite():
    ff, _ = _branchy_layers(_ns("port"), k=3, width=32)
    rw = txfer.ParallelLinearMerge()
    assert len(rw.find(ff.layers)) == 1
    new = rw.apply_all(list(ff.layers))
    assert len(new) == len(ff.layers) - 3
    assert new[0].op_type is T.OpType.LINEAR and new[0].attrs["out_dim"] == 96
    assert new[0].outputs[0].tensor_id == ff.layers[3].outputs[0].tensor_id
    assert new[0].name == "merged_b0_b1_b2"


def test_parallel_linear_merge_requires_same_input():
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu"))
    x = ff.create_tensor((8, 16), name="x")
    a = ff.dense(x, 32, name="b0")
    b = ff.dense(ff.relu(x), 32, name="b1")
    ff.concat([a, b], axis=-1, name="cat")
    assert txfer.ParallelLinearMerge().find(ff.layers) == []


def test_parallel_conv_merge_rewrite():
    def build(k2, p2):
        ff = T.FFModel(T.FFConfig(batch_size=4, device="cpu"))
        x = ff.create_tensor((4, 8, 16, 16), name="img")
        a = ff.conv2d(x, 16, 3, 3, 1, 1, 1, 1, name="c0")
        b = ff.conv2d(x, 8, k2, k2, 1, 1, p2, p2, name="c1")
        ff.concat([a, b], axis=1, name="cat")
        return ff
    new = txfer.ParallelConvMerge().apply_all(list(build(3, 1).layers))
    assert len(new) == 1 and new[0].attrs["out_channels"] == 24
    assert txfer.ParallelConvMerge().find(build(5, 2).layers) == []


def test_graph_variants_enumeration_and_gate():
    ff, _ = _branchy_layers(_ns("port"))
    variants = txfer.graph_variants(ff.layers)
    descs = [tuple(d) for d, _ in variants]
    assert descs[0] == () and any("parallel_linear_merge" in d for d in descs)
    composed = [ls for d, ls in variants if len(d) >= 2]
    assert composed and any(l.op_type is T.OpType.LINEAR
                            and l.attrs.get("activation") is T.ActiMode.RELU
                            and l.attrs["out_dim"] == 128 for l in composed[0])
    cfg = T.FFConfig(batch_size=8, device="cpu", enable_graph_rewrites=False)
    assert len(txfer.graph_variants(ff.layers, cfg)) == 1
    jff, _ = _branchy_layers(_ns("jax"))
    jvariants = jxfer.graph_variants(jff.layers)
    assert [tuple(d) for d, _ in jvariants] == descs
    for (_, a), (_, b) in zip(jvariants, variants):
        assert [(l.op_type.name, l.name) for l in a] == [(l.op_type.name, l.name) for l in b]
    # rehydration replays the same enumeration
    assert txfer.rehydrate_variant(ff.layers, list(descs[1])) is not None
    assert txfer.rehydrate_variant(ff.layers, ["no_such_rewrite"]) is None


def test_structural_rewrite_wins_search():
    def run(ns, rewrites):
        ff, x = _branchy_layers(ns, k=4, width=32)
        machine = ns.sim.SimpleMachineModel(ns.sim.CHIP_PRESETS["cpu-host"], 8,
                                            shared_host=True)
        return ff, ns.unity.full_search(ff.layers, [x], machine,
                                        ns.cfg(batch_size=8, enable_graph_rewrites=rewrites),
                                        beam_width=8)
    (jff, j), (tff, t) = _both(lambda ns: run(ns, True))
    assert t.rewrites and t.layers is not None and len(t.layers) < len(tff.layers)
    _, base = run(_ns("port"), False)
    assert t.est_step_time < base.est_step_time
    _same_result(j, t)


def test_rewritten_graph_compiles_and_trains():
    """One rank: the search picks a rewritten graph, compile builds it and
    fit trains on it."""
    ff, _ = _branchy_layers(_ns("port"), k=4, width=32)
    ff.config.search_budget = -1
    ff.compile(optimizer=T.SGDOptimizer(lr=0.1),
               loss_type=T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=["accuracy"])
    assert ff._search_layers is not None, "rewrite did not reach compile"
    assert len(ff.compiled.ops) < len(ff.layers)
    rng = np.random.default_rng(0)
    hist = ff.fit(rng.normal(size=(32, 16)).astype(np.float32),
                  rng.integers(0, 4, size=(32,)).astype(np.int32), epochs=2, verbose=False)
    assert hist[-1].train_all == 32


def test_logits_tensor_protected_from_rewrites():
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu", search_budget=-1))
    d = ff.dense(ff.create_tensor((8, 16), name="x"), 10, name="d")
    ff.relu(d, name="r")
    ff.compile(optimizer=T.SGDOptimizer(lr=0.1),
               loss_type=T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[], logits_tensor=d)
    assert "d" in [o.name for o in ff.compiled.ops]


def test_reference_rule_schema_names_a8b(tmp_path):
    """The reference's GraphXfer schema ({"rule": [...]}) compiles through
    the search: the rule interpreter (tests/test_torch_rule_interpreter.py)
    classifies this empty rule as resharding, as JAX's does, and adds no
    rewrite."""
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"rule": [{"name": "x", "srcOp": [], "dstOp": [],
                                       "mappedOutput": []}]}))
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu", search_budget=1,
                              substitution_json_path=str(p), ledger="off"))
    ff.dense(ff.create_tensor((8, 16), name="x"), 4, name="d")
    ff.compile(T.SGDOptimizer(lr=0.1), T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert ff.config._graphxfer_rewrites == [] and ff.config._substitution_rules is None
    assert [o.name for o in ff.compiled.ops] == ["d"]
    assert txfer.load_graphxfer_rules(str(p)).counts() == \
        jxfer.load_graphxfer_rules(str(p)).counts() == {"resharding": 1, "structural": 0,
                                                        "unsupported": 0}


# ------------------------------------------------ compile with search, on ranks
SEARCH_SHAPE = dict(B=16, D=32)
TOL, UPDATE_TOL = 1e-5, 2 ** -4  # test_torch_parallel_training.py's


def _searched_mlp(ff):
    x = ff.create_tensor((SEARCH_SHAPE["B"], SEARCH_SHAPE["D"]), name="x")
    h = ff.dense(x, 4 * SEARCH_SHAPE["D"], name="fc1")
    h = ff.relu(h, name="act")
    return ff.dense(h, 8, name="fc2")


def _ranks_fit(rank, world, jobs):
    """Rank body: each job compiles the searched MLP over its mesh, fits
    two epochs of the given data, and returns the plan, the input's
    layout and the whole params (rank 0)."""
    out = []
    for mesh_shape, cfg_kw, x, y in jobs:
        ff = T.FFModel(T.FFConfig(batch_size=SEARCH_SHAPE["B"], device="cpu", seed=3,
                                  mesh_shape=mesh_shape, **cfg_kw))
        _searched_mlp(ff)
        ff.compile(T.SGDOptimizer(lr=0.05), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
        cm = ff.compiled
        layout = str(cm.layouts[cm.input_tensors[0].tensor_id])
        hist = ff.fit(x, y, epochs=2, shuffle=False, verbose=False)
        params = ff.numpy_params()
        out.append(dict(strategies={k: v for k, v in ff._strategies.items() if v},
                        profile=ff.search_profile, layout=layout,
                        playoff=ff._playoff_record, steps=hist[-1].train_all,
                        params=params if rank == 0 else None))
    return out


def test_compile_with_search_on_ranks_matches_jax_and_trains():
    """compile with search_budget on {data: 2, model: 2} (4 ranks over
    gloo): JAX's plan on the same pinned mesh, and params after two fit
    epochs within the mesh tests' bounds of the one-rank run from the same
    init; a search with a playoff races the plan and restores the state;
    enable_sample_parallel=False replicates the input."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, SEARCH_SHAPE["D"])).astype(np.float32)
    y = rng.integers(0, 8, size=(64, 1)).astype(np.int32)
    mesh = {"data": 2, "model": 2}
    jobs = [(mesh, dict(search_budget=1), x, y),
            (mesh, dict(search_budget=1, playoff_steps=2), x, y),
            ({"data": 4}, dict(enable_sample_parallel=False), x, y)]
    got = spawn(_ranks_fit, 4, jobs)
    one = T.FFModel(T.FFConfig(batch_size=SEARCH_SHAPE["B"], device="cpu", seed=3))
    _searched_mlp(one)
    one.compile(T.SGDOptimizer(lr=0.05), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    start = one.numpy_params()
    one.fit(x, y, epochs=2, shuffle=False, verbose=False)
    want = one.numpy_params()
    searched, raced, replicated = (got[0][i] for i in range(3))
    # JAX's plan on the same pinned mesh (the MLP walks no departing state)
    jff = _jax_compile(dict(batch_size=SEARCH_SHAPE["B"], search_budget=1),
                       _searched_mlp, mesh)
    assert searched["strategies"] == {k: v for k, v in jff.search_result.strategies.items() if v}
    assert np.isclose(searched["profile"]["est_step_time"], jff.search_result.est_step_time,
                      rtol=EST, atol=0)
    assert all(r[0]["strategies"] == searched["strategies"] for r in got)
    for run in (searched, raced):
        assert run["steps"] == 64
        for op, ws in want.items():
            for w, a in ws.items():
                atol = TOL * float(np.abs(a).max()) + \
                    UPDATE_TOL * float(np.abs(a - start[op][w]).max())
                np.testing.assert_allclose(run["params"][op][w], a, rtol=TOL, atol=atol,
                                           err_msg=f"{op}.{w}")
    po = raced["playoff"]
    if searched["strategies"]:
        assert po is not None and (po["kept"] == "dp") == (po["dp_ms"] < po["searched_ms"])
        assert all(r[1]["playoff"] == po for r in got)  # every rank kept the same plan
    assert replicated["layout"] == "[16, 32]"


def _ranks_timed_pipe_fit(rank, world, timed_steps, x, y):
    """Rank body: the MLP on {pipe: 2, data: 2} under ZeRO-1 and Adam;
    ``timed_steps`` > 0 first times the compiled plan as the playoff does
    (``_time_compiled`` on the pipeline), then fit two epochs; the whole
    params and this stage's Adam m, v and t."""
    ff = T.FFModel(T.FFConfig(batch_size=SEARCH_SHAPE["B"], device="cpu", seed=3,
                              mesh_shape={"pipe": 2, "data": 2}, zero_optimizer=True,
                              pipeline_schedule="1f1b"))
    _searched_mlp(ff)
    ff.compile(T.AdamOptimizer(alpha=0.01), T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    if timed_steps:
        ff._time_compiled(ff.compiled, ff.pipelined, [x], y, SEARCH_SHAPE["B"], timed_steps)
    ff.fit(x, y, epochs=2, shuffle=False, verbose=False)
    st = ff.pipelined.stage_opt_state
    moments = {k: {f"{op}.{w}": t.numpy().copy() for op, ws in st[k].items()
                   for w, t in ws.items()} for k in ("m", "v")}
    return dict(params=ff.numpy_params(), moments=moments, t=st["t"])


def test_playoff_timing_restores_pipeline_zero_state():
    """The playoff's timing steps leave no trace on a pipeline under
    ZeRO-1 (whose stage optimizer state is its own, not a view of the
    compiled model's): timing 2 steps and then fitting gives params and
    Adam moments and step count bitwise equal to fitting alone."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, SEARCH_SHAPE["D"])).astype(np.float32)
    y = rng.integers(0, 8, size=(64, 1)).astype(np.int32)
    plain = spawn(_ranks_timed_pipe_fit, 4, 0, x, y)
    timed = spawn(_ranks_timed_pipe_fit, 4, 2, x, y)
    for a, b in zip(plain, timed):
        assert a["t"] == b["t"] == 8
        for op, ws in a["params"].items():
            for w, arr in ws.items():
                np.testing.assert_array_equal(b["params"][op][w], arr, err_msg=f"{op}.{w}")
        for k in ("m", "v"):
            assert a["moments"][k].keys() == b["moments"][k].keys()
            for name, arr in a["moments"][k].items():
                np.testing.assert_array_equal(b["moments"][k][name], arr, err_msg=f"{k} {name}")
