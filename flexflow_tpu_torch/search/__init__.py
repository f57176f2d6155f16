"""Auto-parallelization search.

PyTorch counterpart of ``flexflow_tpu/search/`` (the reference's Unity
search and its MLSys'19 MCMC fallback): per-layer candidate strategies
(:mod:`.substitution`), structural rewrites (:mod:`.graph_xfer`), the
frontier DP over layers and mesh shapes driven by the simulator
(:mod:`.unity`), simulated annealing (:mod:`.mcmc`) and the persistent
strategy cache (:mod:`.cache`). ``FFModel.compile`` runs it when
``FFConfig.search_budget`` is nonzero and no strategy was given.
"""

from .substitution import candidate_strategies, load_substitution_json
from .unity import (GraphSearchResult, enumerate_mesh_shapes, full_search,
                    graph_optimize, memory_aware_search)
from .cache import (load_payload, result_from_payload, store_result,
                    strategy_cache_key)
from .mcmc import mcmc_optimize

__all__ = [
    "candidate_strategies",
    "load_substitution_json",
    "GraphSearchResult",
    "enumerate_mesh_shapes",
    "full_search",
    "graph_optimize",
    "memory_aware_search",
    "load_payload",
    "result_from_payload",
    "store_result",
    "strategy_cache_key",
    "mcmc_optimize",
]
