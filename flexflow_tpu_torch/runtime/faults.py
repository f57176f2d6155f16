"""Deterministic fault injection: a seeded, schema-versioned fault plan.

PyTorch counterpart of ``flexflow_tpu/runtime/faults.py``. A plan
(``FFConfig.fault_plan``) makes named failure sites fire
deterministically, so recovery (serving's worker respawn, the retry of a
transient dispatch or batch copy) is proven by a run instead of waited
for:

* free when off: each site costs one ``_PLAN is None`` check
  (:func:`active`/:func:`fire`) while no plan is armed, and no
  ``faults.*`` metric appears;
* validated at entry: :func:`configure_faults` runs at ``compile()``,
  ``fit()`` and serving-instance construction, and a malformed plan raises
  ``ValueError`` there, with the reference's messages;
* deterministic: ``at_step: k`` fires on the k-th evaluation of its site,
  ``p: x`` draws from a per-site ``random.Random(f"{seed}:{site}")``, so a
  plan replays identically;
* counted: each firing adds to ``faults.fired`` and ``faults.<site>``.

Plan schema (``FAULT_PLAN_SCHEMA`` = 1)::

    FFConfig.fault_plan = {
        "schema": 1,
        "seed": 0,                      # optional, default 0
        "sites": {
            "serving.worker": {"at_step": 3},
            "device_put.transient": {"p": 0.2, "max_fires": 2},
        },
    }

Each rule has exactly one trigger (``at_step``, the 1-based evaluation
index of its site, or ``p``, a Bernoulli draw an evaluation) plus an
optional ``max_fires`` and its site's parameters (:data:`SITES`).

The port evaluates every site where the reference does:
``serving.worker``, ``device_put.transient``, ``prefetch.worker`` (the
Prefetcher's worker), ``checkpoint.torn_write`` (both checkpoint
managers), ``train.nan_loss``, ``train.stall`` and ``train.kill``
(``fit``'s step loop), ``multihost.init_timeout``
(``parallel/multihost.elastic_init``'s retried attempt) and
``multihost.slow_peer`` and ``multihost.peer_kill`` (``fit``'s step loop,
after the checkpoint block, as ``train.kill``). ``train.stall`` and
``multihost.slow_peer`` sleep as in the reference: past
``config.watchdog_threshold_s`` the armed stall watchdog
(``obs/watchdog.py``) dumps its black box, and the supervisor
(``parallel/launch.py``) sees the stalled heartbeat.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, Optional

from ..obs.metrics import metrics_registry

FAULT_PLAN_SCHEMA = 1

# site name -> what firing it does (the reference's table)
SITES: Dict[str, str] = {
    "prefetch.worker": (
        "raise inside the Prefetcher worker's batch assembly — proves "
        "worker exceptions surface on the consumer without leaking the "
        "thread"),
    "device_put.transient": (
        "transient host->device placement failure (TransientFault) — "
        "retried by the shared backoff policy (runtime/retry.py)"),
    "checkpoint.torn_write": (
        "tear the just-committed checkpoint (truncate payload files, or "
        "write a partial sidecar with target='sidecar') — proves "
        "restore falls back to the newest intact step, counted"),
    "train.nan_loss": (
        "multiply the step loss by NaN — proves the TrainingGuard "
        "rollback + lr-backoff path"),
    "train.stall": (
        "sleep stall_s inside the step loop — proves the stall "
        "watchdog trips and writes a black-box dump"),
    "train.kill": (
        "hard process kill (os._exit(exit_code), default 41) after the "
        "step completes — proves crash-safe resume bit-identity"),
    "serving.worker": (
        "crash a serving batcher-worker after re-queuing its batch — "
        "proves the respawn budget and that every accepted future still "
        "resolves"),
    "multihost.init_timeout": (
        "raise TransientFault inside the retried multi-host bootstrap "
        "— proves the jittered timeout-retry init path"),
    "multihost.peer_kill": (
        "hard-kill this worker process mid-fit (os._exit, default 43) "
        "after the step completes — the supervisor must detect the dead "
        "peer, tear the cohort down, and relaunch with resume_from"),
    "multihost.slow_peer": (
        "sleep stall_s inside the step loop — the worker's heartbeat "
        "stops progressing so the supervisor's hang detector (and the "
        "stall watchdog's black-box dump) must fire"),
}

# rule keys accepted per site (trigger keys are shared)
_TRIGGER_KEYS = {"at_step", "p"}
_COMMON_KEYS = {"max_fires"}
_SITE_PARAMS = {
    "train.stall": {"stall_s"},
    "train.kill": {"exit_code"},
    "checkpoint.torn_write": {"target"},
    "multihost.peer_kill": {"exit_code"},
    "multihost.slow_peer": {"stall_s"},
}


class InjectedFault(RuntimeError):
    """A fault fired by the active fault plan (runtime/faults.py)."""


class TransientFault(InjectedFault):
    """A retryable injected fault — the shared retry policy's target."""


class FaultPlan:
    """Validated fault plan with per-site deterministic state. The
    ``evaluated``/``fired`` counts change from the fit loop and serving
    workers at once; one lock guards them (a plan exists only on chaos
    runs, off the hot path)."""

    def __init__(self, spec: Dict[str, Any]):
        self.spec = _validate_plan(spec)
        self.seed = int(self.spec.get("seed", 0))
        self._sites: Dict[str, Dict] = dict(self.spec["sites"])
        self._mu = threading.Lock()
        self._evaluated: Dict[str, int] = {s: 0 for s in self._sites}
        self._fired: Dict[str, int] = {s: 0 for s in self._sites}
        # per-site rng: seeded by (plan seed, site) so one site's draw
        # sequence never depends on another site's evaluation order
        self._rngs: Dict[str, random.Random] = {
            s: random.Random(f"{self.seed}:{s}") for s in self._sites}

    def should_fire(self, site: str) -> Optional[Dict]:
        """Evaluate ``site`` once; the rule dict when it fires, None
        otherwise (also None for sites the plan does not mention)."""
        rule = self._sites.get(site)
        if rule is None:
            return None
        with self._mu:
            self._evaluated[site] += 1
            n = self._evaluated[site]
            mf = rule.get("max_fires")
            if mf is not None and self._fired[site] >= int(mf):
                return None
            if "at_step" in rule:
                hit = n == int(rule["at_step"])
            else:
                hit = self._rngs[site].random() < float(rule["p"])
            if hit:
                self._fired[site] += 1
        if not hit:
            return None
        reg = metrics_registry()
        reg.counter("faults.fired").inc()
        reg.counter(f"faults.{site}").inc()
        return dict(rule)

    def snapshot(self) -> Dict:
        """The plan and what happened: the reference's ledger ``faults``
        block."""
        with self._mu:
            fired = dict(self._fired)
            evaluated = dict(self._evaluated)
        return {
            "schema": FAULT_PLAN_SCHEMA,
            "seed": self.seed,
            "sites": sorted(self._sites),
            "evaluated": evaluated,
            "fired": fired,
            "total_fired": sum(fired.values()),
        }


def _validate_plan(spec) -> Dict[str, Any]:
    if not isinstance(spec, dict):
        raise ValueError(
            f"fault_plan must be a dict, got {type(spec).__name__}")
    schema = spec.get("schema")
    if schema != FAULT_PLAN_SCHEMA:
        raise ValueError(
            f"fault_plan schema {schema!r}: this build understands "
            f"schema {FAULT_PLAN_SCHEMA}")
    sites = spec.get("sites")
    if not isinstance(sites, dict) or not sites:
        raise ValueError("fault_plan needs a non-empty 'sites' dict")
    for name, rule in sites.items():
        if name not in SITES:
            raise ValueError(
                f"fault_plan site {name!r} is not a known site; known: "
                f"{sorted(SITES)}")
        if not isinstance(rule, dict):
            raise ValueError(f"fault_plan site {name!r}: rule must be a "
                             f"dict, got {type(rule).__name__}")
        triggers = _TRIGGER_KEYS & set(rule)
        if len(triggers) != 1:
            raise ValueError(
                f"fault_plan site {name!r}: exactly one trigger of "
                f"{sorted(_TRIGGER_KEYS)} required, got {sorted(triggers)}")
        if "p" in rule and not (0.0 < float(rule["p"]) <= 1.0):
            raise ValueError(f"fault_plan site {name!r}: p must be in "
                             f"(0, 1], got {rule['p']}")
        if "at_step" in rule and int(rule["at_step"]) < 1:
            raise ValueError(f"fault_plan site {name!r}: at_step is "
                             f"1-based, got {rule['at_step']}")
        allowed = (_TRIGGER_KEYS | _COMMON_KEYS
                   | _SITE_PARAMS.get(name, set()))
        extra = set(rule) - allowed
        if extra:
            raise ValueError(
                f"fault_plan site {name!r}: unknown rule keys "
                f"{sorted(extra)} (allowed: {sorted(allowed)})")
    return dict(spec)


# ------------------------------------------------------------ global state
_PLAN: Optional[FaultPlan] = None


def configure_faults(config) -> Optional[FaultPlan]:
    """Arm (or clear) the process fault plan from ``config.fault_plan``.

    Runs at ``compile()``, ``fit()`` and serving-instance construction, so
    a malformed plan fails before any work. A config whose ``fault_plan``
    is None clears the plan: chaos never leaks from one run into the next.
    Configuring again with an equal spec keeps the armed plan's counts."""
    global _PLAN
    spec = getattr(config, "fault_plan", None)
    if spec is None:
        # lock-free swap: a racing site sees the old or the new plan
        _PLAN = None  # concurrency: race-ok (lock-free plan swap, the tracer's enabled pattern: sites read the reference once; a racing site sees the old or new plan atomically)
        return None
    cur = _PLAN
    if cur is not None and cur.spec == spec:
        return cur
    plan = FaultPlan(spec)
    _PLAN = plan  # concurrency: race-ok (lock-free plan swap, see above)
    return plan


def active() -> bool:
    """One global read: the off-path cost of the whole subsystem."""
    return _PLAN is not None


def fire(site: str) -> Optional[Dict]:
    """Evaluate ``site`` against the armed plan; the rule dict when it
    fires, None when it doesn't (or no plan is armed)."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.should_fire(site)


def inject(site: str, exc: type = InjectedFault) -> None:
    """Raise ``exc`` when ``site`` fires; no-op otherwise."""
    rule = fire(site)
    if rule is not None:
        raise exc(f"injected fault at site {site!r} (rule {rule})")


def faults_block() -> Optional[Dict]:
    """The armed plan's :meth:`FaultPlan.snapshot`, or None while no plan
    is armed."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.snapshot()


__all__ = [
    "FAULT_PLAN_SCHEMA", "FaultPlan", "InjectedFault", "SITES",
    "TransientFault", "active", "configure_faults", "faults_block",
    "fire", "inject",
]
