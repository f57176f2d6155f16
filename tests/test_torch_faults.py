"""The port's fault plan and retry accounting against the JAX package's
(``flexflow_tpu/runtime/faults.py``, ``runtime/retry.py``).

Plan validation and the per-site firing sequences are pure Python and held
exactly: the same plans give the same acceptance and the same ``ValueError``
text, and 1000 evaluations of each trigger fire at the same evaluations. A
plan naming a site the port does not evaluate yet (the ``multihost.*``
sites) raises ``NotImplementedError`` at ``configure_faults``, naming
ROADMAP A7; the five training sites arm and fire as the reference's.
A ``fit`` whose batch copies fail transiently trains exactly as the
plan-less ``fit`` (the retry absorbs every fault: ``max_fires`` stays below
the retry's three attempts).
"""

import numpy as np
import pytest
import torch

from flexflow_tpu.obs import metrics as jmetrics
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.runtime.retry import RetryPolicy as JRetryPolicy
from flexflow_tpu_torch import FFConfig, FFModel, LossType, MetricsType, SGDOptimizer
from flexflow_tpu_torch.models import build_mlp
from flexflow_tpu_torch.obs import metrics as tmetrics
from flexflow_tpu_torch.runtime import faults as tfaults
from flexflow_tpu_torch.runtime.retry import RetryPolicy


@pytest.fixture(autouse=True)
def _disarm():
    """A plan never leaks from one test into the next, in either package."""
    yield
    tfaults.configure_faults(None)
    jfaults.configure_faults(None)


@pytest.fixture
def fresh_registries(monkeypatch):
    """Empty process registries for the test, in both packages."""
    monkeypatch.setattr(tmetrics, "_REGISTRY", tmetrics.MetricsRegistry())
    monkeypatch.setattr(jmetrics, "_REGISTRY", jmetrics.MetricsRegistry())


PLANS = [
    ("ok_at_step", {"schema": 1, "sites": {"serving.worker": {"at_step": 3}}}),
    ("ok_p_max_fires", {"schema": 1, "seed": 4,
                        "sites": {"device_put.transient": {"p": 0.2, "max_fires": 2}}}),
    ("ok_site_params", {"schema": 1, "sites": {"train.kill": {"at_step": 2, "exit_code": 9},
                                               "train.stall": {"p": 1.0, "stall_s": 0.1}}}),
    ("not_a_dict", [1, 2]),
    ("bad_schema", {"schema": 2, "sites": {"serving.worker": {"at_step": 1}}}),
    ("no_sites", {"schema": 1, "sites": {}}),
    ("unknown_site", {"schema": 1, "sites": {"serving.wrker": {"at_step": 1}}}),
    ("rule_not_dict", {"schema": 1, "sites": {"serving.worker": 3}}),
    ("two_triggers", {"schema": 1, "sites": {"serving.worker": {"at_step": 1, "p": 0.5}}}),
    ("no_trigger", {"schema": 1, "sites": {"serving.worker": {"max_fires": 1}}}),
    ("p_zero", {"schema": 1, "sites": {"device_put.transient": {"p": 0.0}}}),
    ("p_above_one", {"schema": 1, "sites": {"device_put.transient": {"p": 1.5}}}),
    ("at_step_zero", {"schema": 1, "sites": {"serving.worker": {"at_step": 0}}}),
    ("extra_key", {"schema": 1, "sites": {"serving.worker": {"at_step": 1, "stall_s": 1}}}),
]


def _outcome(mod, spec):
    try:
        mod.FaultPlan(spec)
    except ValueError as e:
        return "ValueError", str(e)
    return "ok", None


@pytest.mark.parametrize("spec", [s for _, s in PLANS], ids=[n for n, _ in PLANS])
def test_plan_validation_equals_the_reference(spec):
    want, got = _outcome(jfaults, spec), _outcome(tfaults, spec)
    assert got == want


def test_site_table_and_schema_equal_the_reference():
    assert tfaults.FAULT_PLAN_SCHEMA == jfaults.FAULT_PLAN_SCHEMA
    assert sorted(tfaults.SITES) == sorted(jfaults.SITES)
    assert tfaults._SITE_PARAMS == jfaults._SITE_PARAMS


@pytest.mark.parametrize("rule", [{"p": 0.2}, {"p": 0.7, "max_fires": 5},
                                  {"at_step": 17}, {"at_step": 3, "max_fires": 1},
                                  {"p": 1.0, "max_fires": 3}])
@pytest.mark.parametrize("seed", [0, 11])
def test_firing_sequences_equal_the_reference(rule, seed, fresh_registries):
    spec = {"schema": 1, "seed": seed,
            "sites": {"device_put.transient": rule, "serving.worker": {"p": 0.5}}}
    plans = (jfaults.FaultPlan(spec), tfaults.FaultPlan(spec))
    seqs = [[p.should_fire(site) is not None
             for _ in range(1000) for site in ("device_put.transient", "serving.worker")]
            for p in plans]
    assert seqs[0] == seqs[1] and any(seqs[1])
    assert plans[1].snapshot() == plans[0].snapshot()
    assert tmetrics.metrics_registry().to_json() == jmetrics.metrics_registry().to_json()


@pytest.mark.parametrize("site,item", [
    ("prefetch.worker", "A9"), ("checkpoint.torn_write", "A9"), ("train.nan_loss", "A9"),
    ("train.stall", "A9"), ("train.kill", "A9"), ("multihost.init_timeout", "A7"),
    ("multihost.peer_kill", "A7"), ("multihost.slow_peer", "A7")])
def test_unwired_site_raises_naming_its_item(site, item):
    """The A7 sites are still unwired and raise naming A7; the A9 sites are
    wired now (their queue item is done) and arm as the reference's do."""
    cfg = FFConfig(device="cpu", fault_plan={
        "schema": 1, "sites": {"serving.worker": {"at_step": 1}, site: {"at_step": 1}}})
    if item == "A9":
        assert tfaults.configure_faults(cfg) is not None
        assert tfaults.active()
    else:
        with pytest.raises(NotImplementedError, match=rf"'{site}' \(ROADMAP {item}"):
            tfaults.configure_faults(cfg)
        assert not tfaults.active()  # nothing was armed
    jfaults.configure_faults(type("C", (), {"fault_plan": cfg.fault_plan})())
    assert jfaults.active()  # the reference arms it


@pytest.mark.parametrize("site,rule", [
    ("prefetch.worker", {"at_step": 3}), ("checkpoint.torn_write", {"p": 0.3, "target": "sidecar"}),
    ("train.nan_loss", {"p": 0.25, "max_fires": 4}), ("train.stall", {"at_step": 2, "stall_s": 0.5}),
    ("train.kill", {"at_step": 5, "exit_code": 41})])
def test_a9_site_arms_and_fires_as_in_the_reference(site, rule):
    spec = {"schema": 1, "seed": 3, "sites": {site: rule}}
    plan = tfaults.configure_faults(FFConfig(device="cpu", fault_plan=spec))
    jfaults.configure_faults(type("C", (), {"fault_plan": spec})())
    got = [tfaults.fire(site) for _ in range(200)]
    want = [jfaults.fire(site) for _ in range(200)]
    assert got == want and any(r is not None for r in got)
    assert plan.snapshot() == jfaults.faults_block()


def test_a7_site_still_raises_naming_a7():
    spec = {"schema": 1, "sites": {"train.kill": {"at_step": 1},
                                   "multihost.peer_kill": {"at_step": 1}}}
    with pytest.raises(NotImplementedError, match="'multihost.peer_kill' \\(ROADMAP A7"):
        tfaults.configure_faults(FFConfig(device="cpu", fault_plan=spec))
    assert not tfaults.active()


def test_configure_keeps_an_equal_plan_and_none_clears():
    spec = {"schema": 1, "sites": {"serving.worker": {"at_step": 2}}}
    plan = tfaults.configure_faults(FFConfig(device="cpu", fault_plan=spec))
    assert tfaults.fire("serving.worker") is None
    assert tfaults.configure_faults(FFConfig(device="cpu", fault_plan=dict(spec))) is plan
    with pytest.raises(tfaults.InjectedFault, match="serving.worker"):
        tfaults.inject("serving.worker")  # the second evaluation fires
    assert tfaults.faults_block()["fired"] == {"serving.worker": 1}
    assert issubclass(tfaults.TransientFault, tfaults.InjectedFault)
    tfaults.configure_faults(FFConfig(device="cpu"))
    assert not tfaults.active() and tfaults.faults_block() is None
    assert tfaults.fire("serving.worker") is None


def _retry_counts(policy_cls, mod, fails: int, attempts: int):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) <= fails:
            raise OSError("flaky")
        return "ok"

    policy = policy_cls(max_attempts=attempts, base_delay_s=0.0, label="probe", seed=0)
    try:
        out = policy.call(flaky)
    except OSError:
        out = "gave up"
    reg = mod.metrics_registry()
    return out, {k: reg.get(f"retry.probe.{k}").value if reg.get(f"retry.probe.{k}") else 0
                 for k in ("attempts", "retries", "giveups")}


@pytest.mark.parametrize("fails,attempts", [(0, 3), (2, 3), (3, 3), (5, 2)])
def test_retry_counters_count_as_the_reference(fails, attempts, fresh_registries):
    want = _retry_counts(JRetryPolicy, jmetrics, fails, attempts)
    got = _retry_counts(RetryPolicy, tmetrics, fails, attempts)
    assert got == want
    assert got[1]["attempts"] == min(fails + 1, attempts)


def _fit(plan, epochs=2):
    torch.manual_seed(0)
    ff = FFModel(FFConfig(batch_size=16, seed=3, device="cpu", fault_plan=plan))
    build_mlp(ff, 16, in_dim=8, hidden_dims=(16,), num_classes=4)
    ff.compile(optimizer=SGDOptimizer(lr=0.1), loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = np.argmax(x @ rng.normal(size=(8, 4)), axis=1).astype(np.int32).reshape(-1, 1)
    hist = ff.fit(x, y, epochs=epochs, verbose=False)
    params = {op: {w: v.clone() for w, v in ws.items()} for op, ws in ff.compiled.params.items()}
    return hist, params


def test_plan_less_fit_registers_no_fault_metric(fresh_registries):
    _fit(None, epochs=1)
    names = tmetrics.metrics_registry().names()
    assert not [n for n in names if n.startswith("faults.")]
    assert not tfaults.active()


def test_fit_under_transient_copies_equals_the_plan_less_fit(fresh_registries):
    want_hist, want_params = _fit(None)
    plan = {"schema": 1, "seed": 1, "sites": {"device_put.transient": {"p": 0.3, "max_fires": 2}}}
    got_hist, got_params = _fit(plan)
    reg = tmetrics.metrics_registry()
    assert reg.get("faults.device_put.transient").value == 2
    assert reg.get("retry.device_put.retries").value == 2
    assert reg.get("retry.device_put.giveups") is None
    assert got_hist == want_hist
    for op, ws in want_params.items():
        for w, v in ws.items():
            assert torch.equal(got_params[op][w], v), (op, w)
