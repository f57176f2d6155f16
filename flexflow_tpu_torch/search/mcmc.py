"""MCMC strategy search (the MLSys'19 fallback).

PyTorch counterpart of ``flexflow_tpu/search/mcmc.py``, the reference's
``FFModel::mcmc_optimize``
(reference: src/runtime/model.cc:3286-3357 — simulated annealing over
per-op ParallelConfigs: propose via ``rewrite`` (model.cc:3261, one random
op gets a random parallel config), evaluate with
``Simulator::simulate_runtime``, accept with probability
``exp(-alpha * diff)``; budget/alpha from --search-budget/--search-alpha).

Here a proposal rewrites one random layer's strategy to a random candidate
from the substitution library, and evaluation rebuilds the op list (cheap —
per-op costs are memoized across evaluations by the cost model, the same
economics as the reference's hash_to_operator_cost).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

from ..config import FFConfig
from ..core.layer import Layer
from ..core.parallel_tensor import ParallelTensorShape
from ..sim.simulator import Simulator
from .substitution import candidate_strategies
from .unity import GraphSearchResult


def _evaluate(
    layers: List[Layer],
    input_pshapes: Dict[int, ParallelTensorShape],
    axis_sizes: Dict[str, int],
    strategies: Dict[str, Dict[str, str]],
    simulator: Simulator,
) -> float:
    from ..runtime.compiler import build_ops

    ops, _ = build_ops(layers, input_pshapes, axis_sizes, strategies)
    if not simulator.fits_memory(ops):
        return math.inf
    return simulator.simulate_runtime(ops)


def mcmc_optimize(
    layers: List[Layer],
    input_pshapes: Dict[int, ParallelTensorShape],
    axis_sizes: Dict[str, int],
    simulator: Simulator,
    config: Optional[FFConfig] = None,
    budget: int = 200,
    alpha: float = 1.2,
    seed: int = 0,
) -> GraphSearchResult:
    """Simulated annealing; returns the best strategy assignment found.

    ``alpha`` matches the reference's acceptance sharpness (model.cc:3335:
    accept if diff<0 else with prob exp(-alpha*diff)). Our simulated costs
    are seconds; diff is scaled to *milliseconds* so the reference's
    default ``--search-alpha`` 1.2 (config.py:50) gives a sane acceptance
    curve (a 1 ms/iter regression is accepted with p≈0.30).
    """
    if config is not None:
        budget = config.search_budget if config.search_budget > 0 else budget
        alpha = config.search_alpha if config.search_alpha > 0 else alpha
    rng = random.Random(seed)
    cands_per_layer = {
        l.name: candidate_strategies(l, axis_sizes, config) for l in layers
    }
    current: Dict[str, Dict[str, str]] = {}
    cur_cost = _evaluate(layers, input_pshapes, axis_sizes, current, simulator)
    best, best_cost = dict(current), cur_cost
    explored = 0
    for _ in range(budget):
        layer = rng.choice(layers)
        cands = cands_per_layer[layer.name]
        if len(cands) <= 1:
            continue
        proposal = dict(current)
        proposal[layer.name] = rng.choice(cands)
        cost = _evaluate(layers, input_pshapes, axis_sizes, proposal, simulator)
        explored += 1
        diff_ms = (cost - cur_cost) * 1e3
        if cost < cur_cost or (
            math.isfinite(diff_ms) and rng.random() < math.exp(-alpha * diff_ms)
        ):
            current, cur_cost = proposal, cost
            if cur_cost < best_cost:
                best, best_cost = dict(current), cur_cost
    mem = 0
    if math.isfinite(best_cost):
        from ..runtime.compiler import build_ops

        ops, _ = build_ops(layers, input_pshapes, axis_sizes, best)
        mem = simulator.memory_usage(ops).total
    return GraphSearchResult(
        {k: v for k, v in best.items() if v},
        dict(axis_sizes),
        best_cost,
        mem,
        explored,
    )
