"""The port's strategy cache (``flexflow_tpu_torch/search/cache.py``): the
counterparts of ``tests/test_search_cache.py`` and of
``tests/test_pipe_schedule.py``'s search-and-cache tests, on the CPU.
A pinned mesh is searched without ranks (``FFModel._run_search`` on the
mesh's shape); the one-rank runs compile and train through the cache.
Besides: the key moves with the ``torch.distributed`` world size (a
resized cohort re-searches), with the H100 preset the compute dtype picks,
and a stored plan that no longer builds (``build_ops``) is demoted to a
miss with a printed line."""

import dataclasses
import json
import os

import numpy as np
import pytest

from flexflow_tpu_torch import (DataType, FFConfig, FFModel, LossType, SGDOptimizer)
from flexflow_tpu_torch.parallel.pipeline import PipelineConfig
from flexflow_tpu_torch.search import cache as cache_mod
from flexflow_tpu_torch.search.cache import (load_payload, result_from_payload,
                                             result_to_payload, store_result,
                                             strategy_cache_key, validate_payload)
from flexflow_tpu_torch.sim import CHIP_PRESETS, SimpleMachineModel
from flexflow_tpu_torch.sim import cost_model as cost_model_mod
from flexflow_tpu_torch.sim import simulator as simulator_mod
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

MESH = {"data": 2, "model": 4}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _build(cfg, out_dim=128):
    ff = FFModel(cfg)
    x = ff.create_tensor((32, 64), DataType.FLOAT, name="x")
    h = ff.relu(ff.dense(x, out_dim, name="fc1"), name="act")
    ff.dense(h, 8, name="fc2")
    return ff


def _cfg(tmp_path, mode="on", **kw):
    return FFConfig(batch_size=32, search_budget=1, device="cpu", search_cache=mode,
                    search_cache_dir=str(tmp_path / "strategies"), **kw)


def _search(ff, mesh=MESH):
    """compile()'s search on a pinned mesh, without ranks."""
    return ff._run_search(_FakeMesh(mesh), ff._final_output())[0]


def _compile(ff):
    ff.compile(SGDOptimizer(lr=0.05), LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])


def test_cache_miss_then_hit_zero_cost_model_calls(tmp_path):
    cfg = _cfg(tmp_path)
    ff = _build(cfg)
    first = dict(_search(ff))
    assert ff.search_profile["cache"] == "miss"
    files = os.listdir(cfg.search_cache_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    cost_model_mod.MEASURE_CALLS = 0
    simulator_mod.SIM_RUNS = 0
    assert _search(ff) == first
    assert ff.search_profile["cache"] == "hit" and ff.search_profile["workers"] == 0
    assert cost_model_mod.MEASURE_CALLS == 0 and simulator_mod.SIM_RUNS == 0
    # one rank: compile through the cache twice; the hit trains
    one = _cfg(tmp_path / "one")
    for label in ("miss", "hit"):
        ff = _build(dataclasses.replace(one))
        _compile(ff)
        assert ff.search_profile["cache"] == label
    X = np.random.default_rng(0).normal(size=(32, 64)).astype(np.float32)
    Y = np.random.default_rng(1).integers(0, 8, size=(32, 1)).astype(np.int32)
    assert len(ff.fit(X, Y, epochs=1, verbose=False)) == 1


def test_cache_refresh_reruns_search_and_overwrites(tmp_path):
    cfg = _cfg(tmp_path)
    ff = _build(cfg)
    _search(ff)
    path = os.path.join(cfg.search_cache_dir, os.listdir(cfg.search_cache_dir)[0])
    before = os.stat(path).st_mtime_ns
    cfg.search_cache = "refresh"
    cost_model_mod.MEASURE_CALLS = 0
    _search(ff)
    assert ff.search_profile["cache"] == "refresh"
    assert cost_model_mod.MEASURE_CALLS > 0
    assert os.stat(path).st_mtime_ns >= before
    cfg.search_cache = "onn"
    with pytest.raises(ValueError, match="search_cache='onn'"):
        _search(ff)


def test_cache_off_never_touches_disk(tmp_path):
    cfg = _cfg(tmp_path, mode="off")
    ff = _build(cfg)
    _search(ff)
    assert ff.search_profile["cache"] == "off"
    assert not os.path.exists(cfg.search_cache_dir)


def test_key_invalidation_layer_attr_machine_and_knob(monkeypatch):
    machine = SimpleMachineModel(CHIP_PRESETS["test"], 8)
    cfg = FFConfig(batch_size=32, search_budget=1, device="cpu")

    def key(ff=None, m=machine, c=cfg, protected=None):
        ff = ff or _build(cfg)
        return strategy_cache_key(ff.layers, [ff.layers[0].inputs[0]], m, c,
                                  protected=protected)

    base = key(_build(cfg))
    assert key(_build(cfg)) == base
    assert key(_build(cfg, out_dim=256)) != base
    assert key(m=SimpleMachineModel(CHIP_PRESETS["h100"], 8)) != base
    assert key(m=SimpleMachineModel(CHIP_PRESETS["test"], 4)) != base
    # the H100 preset the compute dtype picks is part of the machine
    assert key(m=SimpleMachineModel(CHIP_PRESETS["h100"], 8)) != \
        key(m=SimpleMachineModel(CHIP_PRESETS["h100-bf16"], 8))
    assert key(c=dataclasses.replace(cfg, enable_sample_parallel=False)) != base
    assert key(c=dataclasses.replace(cfg, batch_size=64)) != base
    assert key(c=dataclasses.replace(cfg, compute_dtype="bfloat16")) != base
    assert key(c=dataclasses.replace(cfg, search_num_workers=7, search_prune=False,
                                     search_cache="refresh")) == base
    ff = _build(cfg)
    assert key(ff, protected=frozenset({ff.layers[-1].outputs[0].tensor_id})) != \
        key(ff, protected=frozenset({ff.layers[0].outputs[0].tensor_id}))
    # a resized cohort: the world size is stamped when above 1
    monkeypatch.setattr(cache_mod, "_world_size", lambda: 2)
    two = key(_build(cfg))
    monkeypatch.setattr(cache_mod, "_world_size", lambda: 4)
    assert two != base and key(_build(cfg)) not in (base, two)


def test_store_load_roundtrip_and_stale_rejection(tmp_path):
    from flexflow_tpu_torch.search.unity import full_search

    cfg = FFConfig(batch_size=32, search_budget=1, device="cpu")
    ff = _build(cfg)
    x = ff.layers[0].inputs[0]
    machine = SimpleMachineModel(CHIP_PRESETS["test"], 8)
    r = full_search(ff.layers, [x], machine, cfg, num_workers=1)
    key = strategy_cache_key(ff.layers, [x], machine, cfg)
    store_result(str(tmp_path), key, r)
    payload = load_payload(str(tmp_path), key)
    back = result_from_payload(payload, ff.layers, cfg)
    assert (back.strategies, back.mesh_shape, back.est_step_time) == \
        (r.strategies, r.mesh_shape, r.est_step_time)
    stale = dict(payload, strategies={"no_such_layer": {"out": "model"}})
    assert result_from_payload(stale, ff.layers, cfg) is None
    path = os.path.join(str(tmp_path), f"{key}.json")
    with open(path, "w") as f:
        f.write("{not json")
    with pytest.warns(cache_mod.CacheSchemaWarning):
        assert load_payload(str(tmp_path), key) is None
    assert load_payload(str(tmp_path), "0" * 64) is None


def test_auto_mesh_search_hits_after_mesh_pinned(tmp_path):
    """One rank: the unpinned search pins config.mesh_shape and stores
    under both keys, so the recompile (now pinned) hits."""
    cfg = _cfg(tmp_path)
    assert cfg.mesh_shape is None
    ff = _build(cfg)
    _compile(ff)
    assert ff.search_profile["cache"] == "miss" and cfg.mesh_shape == {"data": 1}
    cost_model_mod.MEASURE_CALLS = 0
    _compile(ff)
    assert ff.search_profile["cache"] == "hit" and cost_model_mod.MEASURE_CALLS == 0


def test_changed_world_size_misses(tmp_path, monkeypatch):
    """A cohort relaunched at another world size keys the cache anew and
    re-searches (parallel/launch.py's resized relaunch)."""
    cfg = _cfg(tmp_path)
    monkeypatch.setattr(cache_mod, "_world_size", lambda: 4)
    _search(_build(cfg))
    _search(_build(dataclasses.replace(cfg)))
    monkeypatch.setattr(cache_mod, "_world_size", lambda: 2)
    ff = _build(dataclasses.replace(cfg))
    cost_model_mod.MEASURE_CALLS = 0
    _search(ff)
    assert ff.search_profile["cache"] == "miss" and cost_model_mod.MEASURE_CALLS > 0
    assert len(os.listdir(cfg.search_cache_dir)) == 2


def test_cached_plan_that_does_not_build_is_a_miss(tmp_path, capsys):
    """A schema-valid entry whose strategies do not build (fc1 mapping the
    model axis onto both its kernel's dims) fails the PCG validation of
    the rehydrated plan: under validate_pcg="error" (the default) the
    coded error raises; under "warn" it prints the finding and a line and
    re-searches, and the re-search overwrites the entry; under "off" the
    entry must still build, and one that does not is a miss as well."""
    cfg = _cfg(tmp_path, validate_pcg="warn")
    ff = _build(cfg)
    _search(ff)
    path = os.path.join(cfg.search_cache_dir, os.listdir(cfg.search_cache_dir)[0])
    doc = json.load(open(path))
    bad = {"in": "model", "out": "model"}
    doc["result"]["strategies"] = {"fc1": bad}
    json.dump(doc, open(path, "w"))
    from flexflow_tpu_torch.analysis import PCGValidationError

    strict = _build(_cfg(tmp_path))
    with pytest.raises(PCGValidationError, match="fc1"):
        _search(strict)
    cost_model_mod.MEASURE_CALLS = 0
    strat = _search(ff)
    out = capsys.readouterr().out
    assert "[pcg] PCG0" in out and "failed PCG validation" in out
    assert ff.search_profile["cache"] == "miss" and cost_model_mod.MEASURE_CALLS > 0
    assert strat.get("fc1") != bad
    assert json.load(open(path))["result"]["strategies"].get("fc1") != bad
    doc = json.load(open(path))
    doc["result"]["strategies"] = {"fc1": bad}
    json.dump(doc, open(path, "w"))
    off = _build(_cfg(tmp_path, validate_pcg="off"))
    cost_model_mod.MEASURE_CALLS = 0
    strat = _search(off)
    out = capsys.readouterr().out
    assert "does not build" in out and "[pcg]" not in out
    assert off.search_profile["cache"] == "miss" and cost_model_mod.MEASURE_CALLS > 0
    assert strat.get("fc1") != bad


def _pipe_model(tmp_path):
    cfg = FFConfig(batch_size=8, search_budget=-1, device="cpu",
                   search_cache_dir=str(tmp_path / "s"))
    ff = FFModel(cfg)
    t = ff.create_tensor((8, 16), name="x")
    for i in range(3):
        t = ff.dense(t, 32, name=f"fc{i + 1}")
    ff.softmax(ff.dense(t, 4, name="fc4"), name="sm")
    return ff


def test_search_selects_and_caches_schedule(tmp_path):
    """A pipe-mesh search carries the schedule the model priced; the
    pipeline compile() builds takes it, and the payload round-trips it."""
    ff = _pipe_model(tmp_path)
    _search(ff, {"pipe": 2, "data": 4})
    sr = ff.search_result
    assert sr.pipe_schedule in ("gpipe", "1f1b", "interleaved")
    resolved = ff._resolve_pipeline(PipelineConfig(num_stages=2, schedule="auto"))
    assert (resolved.schedule, resolved.interleave) == (sr.pipe_schedule, sr.pipe_interleave)
    payload = result_to_payload(sr, layers=ff.layers)
    assert payload["pipe_schedule"] == sr.pipe_schedule
    back = result_from_payload(payload, ff.layers, ff.config)
    assert (back.pipe_schedule, back.pipe_interleave) == (sr.pipe_schedule, sr.pipe_interleave)
    # the JAX package picks the same schedule on the same mesh and machine
    import jax

    import flexflow_tpu as J
    from flexflow_tpu.core.machine import make_mesh

    jff = J.FFModel(J.FFConfig(batch_size=8, search_budget=-1, ledger="off",
                               audit_programs="off", attribution="off"))
    t = jff.create_tensor((8, 16), name="x")
    for i in range(3):
        t = jff.dense(t, 32, name=f"fc{i + 1}")
    jff.softmax(jff.dense(t, 4, name="fc4"), name="sm")
    jff.compile(optimizer=J.SGDOptimizer(lr=0.1),
                loss_type=J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                mesh=make_mesh({"pipe": 2, "data": 4}, jax.devices()[:8]))
    jsr = jff.search_result
    assert (jsr.pipe_schedule, jsr.pipe_interleave, jsr.pipe_engine) == \
        (sr.pipe_schedule, sr.pipe_interleave, sr.pipe_engine)
    assert jsr.strategies == sr.strategies and jsr.mesh_shape == sr.mesh_shape
    assert np.isclose(jsr.est_step_time, sr.est_step_time, rtol=1e-9, atol=0)


def test_cache_payload_roundtrips_pipe_engine(tmp_path):
    ff = _pipe_model(tmp_path)
    _search(ff, {"pipe": 2, "data": 4})
    sr = ff.search_result
    assert sr.pipe_engine in ("compiled", "host")
    payload = result_to_payload(sr, layers=ff.layers)
    assert payload["pipe_engine"] == sr.pipe_engine
    back = result_from_payload(payload, ff.layers, ff.config)
    assert back is not None and back.pipe_engine == sr.pipe_engine
    assert any("pipe_engine" in p for p in validate_payload(dict(payload, pipe_engine="warp")))
