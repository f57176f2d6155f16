"""Static analysis: the PCG validator, the strategy linter, the program
audit and the three source gates.

PyTorch counterpart of ``flexflow_tpu/analysis``:

* :func:`validate_pcg` (:mod:`.pcg_check`) — graph well-formedness and
  sharding legality with ``PCG0xx`` codes and layer provenance; wired
  into ``FFModel.compile()`` through ``config.validate_pcg`` and into
  every strategy-cache rehydration.
* :func:`lint_strategy` (:mod:`.strategy_lint`) — non-fatal ``LINT0xx``
  findings on legal-but-suspect strategies (``tools/torch_pcg_lint.py``).
* :func:`lint_hotpaths <.hotpath_lint.lint_paths>` (:mod:`.hotpath_lint`)
  — the AST ``HOT0xx`` race/sync lint over the port's own source.
* :func:`check_concurrency <.concurrency_check.check_package>`
  (:mod:`.concurrency_check`) — the whole-package concurrency audit
  (``CCY0xx``).
* :func:`check_knobflow <.knobflow_check.check_package>`
  (:mod:`.knobflow_check`) — cache-key and cohort-key coverage of every
  config knob (``KNB0xx``).

A sixth pass runs after lowering: :func:`audit_compiled_model`
(:mod:`.program_audit`) records the aten stream of one real call of each
step program and checks donation, closed-over tensors, host round trips,
accumulator precision and collective legality (``AUD0xx``), wired into
``FFModel.compile()`` through ``config.audit_programs``. Suppression
pragmas for every pass share one grammar (:mod:`.pragmas`).
"""

from .concurrency_check import check_package as check_concurrency
from .concurrency_check import check_source as check_concurrency_source
from .findings import (CODE_CATALOG, ConcurrencyAuditError, Finding,
                       KnobFlowAuditError, PCGValidationError,
                       ProgramAuditError, ValidationReport,
                       layer_provenance, report_to_json_line)
from .hotpath_lint import lint_paths as lint_hotpaths
from .hotpath_lint import lint_source as lint_hotpath_source
from .knobflow_check import check_package as check_knobflow
from .knobflow_check import check_sources as check_knobflow_sources
from .pcg_check import propagate_strategies, validate_pcg
from .program_audit import (ExecutableSpec, ProgramRecorder,
                            audit_compiled_model, audit_recorded,
                            audit_spec, lint_donated_reuse, record_call)
from .strategy_lint import lint_strategy

__all__ = [
    "CODE_CATALOG",
    "ConcurrencyAuditError",
    "ExecutableSpec",
    "Finding",
    "KnobFlowAuditError",
    "PCGValidationError",
    "ProgramAuditError",
    "ProgramRecorder",
    "ValidationReport",
    "audit_compiled_model",
    "audit_recorded",
    "audit_spec",
    "check_concurrency",
    "check_concurrency_source",
    "check_knobflow",
    "check_knobflow_sources",
    "layer_provenance",
    "lint_donated_reuse",
    "lint_hotpath_source",
    "lint_hotpaths",
    "lint_strategy",
    "propagate_strategies",
    "record_call",
    "validate_pcg",
    "report_to_json_line",
]
