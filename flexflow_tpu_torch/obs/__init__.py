"""Observability: the PyTorch counterpart of ``flexflow_tpu/obs/``.

* :mod:`.trace` — the ring-buffered span tracer (Chrome trace-event
  JSON); :mod:`.metrics` — counters, gauges and histograms in one
  registry (JSON and Prometheus text), and :class:`EpochThroughput`, the
  fit/eval epoch record;
* :mod:`.divergence` — the simulator's step time and per-op costs
  against the measured ones (OBS001);
* :mod:`.ledger` — one schema-versioned JSONL record a compile, fit,
  eval, serving session or bench run, under ``.ffcache/obs/runs``;
* :mod:`.exec_telemetry` — one step's flops and the card's peak bytes,
  reconciled with the simulator's memory estimate (OBS002);
* :mod:`.watchdog` — heartbeats and black-box dumps on a stall;
* :mod:`.attribution` — the measured step split into phases;
* :mod:`.advisor` — the dominant phase mapped to ranked knob deltas;
* :mod:`.costcorpus` — every op timed forward and backward, kept as
  featurized rows;
* :mod:`.server` — ``/metrics``, ``/healthz``, ``/runs``, ``/trace``,
  ``/attribution``, ``/advice`` and ``/cohort`` over HTTP;
* :mod:`.cohort` — per-rank exports, merged traces, cross-rank skew
  (OBS003) and the cohort report.

``runtime/profiling.py`` re-exports this surface beside the per-op
profiling and graph exports.
"""

from .trace import (VIRTUAL_TID_BASE, Tracer, configure_tracer, span, trace_enabled,
                    tracer, validate_chrome_trace)
from .metrics import (Counter, EpochThroughput, Gauge, Histogram, MetricsRegistry,
                      metrics_registry, nearest_rank_percentile)
from .divergence import (divergence_report, maybe_record_divergence, predicted_step_time,
                         record_divergence)
from .ledger import (LEDGER_SCHEMA, cohort_key, last_record, ledger_dir, load_runs,
                     merge_runs, record_run, scan_ledger)
from .exec_telemetry import collect_traced, reconcile_peak_memory, telemetry_mode
from .watchdog import Watchdog, configure_watchdog, watchdog
from .attribution import (attribute_fit, attribution_report, format_phase_table,
                          maybe_attribute, serving_attribution)
from .advisor import (RULE_FAMILIES, advise_record, judge_experiment, maybe_advise,
                      top_suggestion, validate_report)
from .costcorpus import append_rows, build_rows, corpus_dir, load_rows, scan_corpus
from .server import (ObsServer, configure_obs_server, latest_advice, latest_attribution,
                     latest_cohort, obs_server, publish_advice, publish_attribution,
                     publish_cohort, stop_obs_server)
from .cohort import (build_cohort_report, cohort_attribution, cohort_dir,
                     maybe_export_cohort, merge_metric_snapshots, merge_traces, step_skew)

__all__ = [
    "Counter", "EpochThroughput", "Gauge", "Histogram", "LEDGER_SCHEMA", "MetricsRegistry",
    "ObsServer", "RULE_FAMILIES", "Tracer", "VIRTUAL_TID_BASE", "Watchdog", "advise_record",
    "append_rows", "attribute_fit", "attribution_report", "build_cohort_report",
    "build_rows", "cohort_attribution", "cohort_dir", "cohort_key", "collect_traced",
    "configure_obs_server", "configure_tracer", "configure_watchdog", "corpus_dir",
    "divergence_report", "format_phase_table", "judge_experiment", "last_record",
    "latest_advice", "latest_attribution", "latest_cohort", "ledger_dir", "load_rows",
    "load_runs", "maybe_advise", "maybe_attribute", "maybe_export_cohort",
    "maybe_record_divergence", "merge_metric_snapshots", "merge_runs", "merge_traces",
    "metrics_registry", "nearest_rank_percentile", "obs_server", "predicted_step_time",
    "publish_advice", "publish_attribution", "publish_cohort", "reconcile_peak_memory",
    "record_divergence", "record_run", "scan_corpus", "scan_ledger", "serving_attribution",
    "span", "step_skew", "stop_obs_server", "telemetry_mode", "top_suggestion",
    "trace_enabled", "tracer", "validate_chrome_trace", "validate_report", "watchdog",
]
