"""Observability: the span tracer (:mod:`.trace`) and the metrics registry
(:mod:`.metrics`), the two parts of ``flexflow_tpu/obs`` that serving, the
retry policy and the fault plan call. The rest of the reference's
``obs/`` (ledger, watchdog, server, attribution, advisor, cohort,
divergence, cost corpus, executable telemetry) is ROADMAP A10."""

from .metrics import (Counter, EpochThroughput, Gauge, Histogram, MetricsRegistry,
                      metrics_registry, nearest_rank_percentile)
from .trace import (VIRTUAL_TID_BASE, Tracer, configure_tracer, span, trace_enabled,
                    tracer, validate_chrome_trace)

__all__ = ["Counter", "EpochThroughput", "Gauge", "Histogram", "MetricsRegistry",
           "Tracer", "VIRTUAL_TID_BASE", "configure_tracer", "metrics_registry",
           "nearest_rank_percentile", "span", "trace_enabled", "tracer",
           "validate_chrome_trace"]
