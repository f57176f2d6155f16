"""The port's metrics registry and span tracer against the JAX package's
(``flexflow_tpu/obs/metrics.py``, ``obs/trace.py``).

Both are pure Python, so every comparison is exact: the same observations,
drawn from a numpy seed, give identical JSON and Prometheus exports,
percentiles, merges and ``from_json`` round trips.
"""

import json

import numpy as np
import pytest

from flexflow_tpu.obs import metrics as jmetrics
from flexflow_tpu.obs import trace as jtrace
from flexflow_tpu_torch.obs import metrics as tmetrics
from flexflow_tpu_torch.obs import trace as ttrace
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)


def _feed(mod, seed: int, n: int = 1500):
    """A registry fed from a seeded op stream: integral and fractional
    counter adds, gauge writes and histogram samples (more than a 1024
    reservoir holds, so the window keeps only the recent ones)."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    for _ in range(n):
        kind = int(rng.integers(0, 3))
        name = f"s{int(rng.integers(0, 4))}"
        if kind == 0:
            reg.counter(f"c.{name}").inc(int(rng.integers(1, 5)))
        elif kind == 1:
            reg.gauge(f"g.{name}").set(float(rng.normal()))
        else:
            reg.histogram(f"h.{name}").observe(float(rng.exponential()))
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exports_equal(seed):
    want, got = _feed(jmetrics, seed), _feed(tmetrics, seed)
    assert got.names() == want.names()
    assert got.to_json() == want.to_json()
    assert got.to_prometheus() == want.to_prometheus()
    for name in want.names():
        if name.startswith("h."):
            for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                assert got.get(name).percentile(q) == want.get(name).percentile(q)
            assert got.get(name).mean == want.get(name).mean


@pytest.mark.parametrize("seeds", [(0, 1), (2, 5), (3, 3)])
def test_merge_and_from_json_round_trip_equal(seeds):
    a, b = seeds
    want = _feed(jmetrics, a).merge(_feed(jmetrics, b, n=700))
    got = _feed(tmetrics, a).merge(_feed(tmetrics, b, n=700))
    assert got.to_json() == want.to_json()
    assert got.to_prometheus() == want.to_prometheus()
    doc = json.loads(json.dumps(want.to_json()))
    rt_want = jmetrics.MetricsRegistry.from_json(doc)
    rt_got = tmetrics.MetricsRegistry.from_json(doc)
    assert rt_got.to_json() == rt_want.to_json()
    assert {n: type(rt_got.get(n)).__name__ for n in rt_got.names()} == \
        {n: type(rt_want.get(n)).__name__ for n in rt_want.names()}


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_nearest_rank_percentile_equal(n):
    xs = sorted(np.random.default_rng(n).normal(size=n).tolist())
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert tmetrics.nearest_rank_percentile(xs, q) == \
            jmetrics.nearest_rank_percentile(xs, q)


def test_type_clash_raises_as_the_reference_does():
    msgs = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError) as e:
            reg.gauge("x")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_epoch_throughput_record_keys_and_counts():
    recs = []
    for mod in (jmetrics, tmetrics):
        saved = mod._REGISTRY
        mod._REGISTRY = mod.MetricsRegistry()
        try:
            et = mod.EpochThroughput(prefix="probe")
            et.record_steps(3, nbytes=96)
            et.record_depth(2)
            et.record_inflight(1)
            et.record_tokens(10, 16)
            rec = et.finish()
            recs.append((sorted(rec), rec["steps"], rec["queue_depth_hist"],
                         rec["padded_token_fraction"], mod._REGISTRY.names()))
        finally:
            mod._REGISTRY = saved
    assert recs[0] == recs[1]


def test_tracer_mode_knob_and_noop_as_the_reference():
    class Cfg:
        trace = "sometimes"

    msgs = []
    for mod in (jtrace, ttrace):
        with pytest.raises(ValueError) as e:
            mod.configure_tracer(Cfg())
        msgs.append(str(e.value))
        tr = mod.Tracer(enabled=False)
        assert tr.span("x") is mod._NOOP
        tr.complete("x", tr.now(), 0.1)
        tr.instant("y")
        assert tr.events() == []
    assert msgs[0] == msgs[1]


def test_tracer_events_and_export_validate(tmp_path):
    """The same recorded spans give events of the same shape, an export
    each package's validator accepts, and a partial overlap both flag."""
    shapes = []
    for mod in (jtrace, ttrace):
        tr = mod.Tracer(enabled=True, capacity=8)
        with tr.span("outer", cat="c", k=1):
            with tr.span("inner"):
                pass
        tr.instant("mark", cat="m")
        t0 = tr.now()
        tr.complete("req", t0, 0.002, cat="serving", tid=mod.VIRTUAL_TID_BASE + 3,
                    args={"request_id": 3})
        path = tmp_path / f"{mod.__name__}.json"
        assert tr.export(str(path), label="rank0") == 4
        payload = json.loads(path.read_text())
        assert jtrace.validate_chrome_trace(payload) == []
        assert ttrace.validate_chrome_trace(payload) == []
        shapes.append([(e["name"], e["ph"], sorted(e)) for e in tr.events()]
                      + [sorted(payload["metadata"]), tr.counts_by_cat()])
        for _ in range(10):  # the ring keeps the newest `capacity` events
            tr.instant("spill")
        assert tr.event_count() == 8
    assert shapes[0] == shapes[1]
    bad = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": 5.0, "dur": 10.0, "pid": 1, "tid": 1}]}
    assert ttrace.validate_chrome_trace(bad) == jtrace.validate_chrome_trace(bad) != []
