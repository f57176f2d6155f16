"""Finding and report types shared by the static-analysis passes.

PyTorch counterpart of ``flexflow_tpu/analysis/findings.py``. Every
violation carries:

* a machine-readable **code** (``PCG0xx`` validator errors, ``LINT0xx``
  strategy-lint findings, ``AUD0xx`` program-audit findings, ``CCY0xx``
  concurrency findings, ``KNB0xx`` knob-flow findings, ``HOT0xx``
  hot-path lint findings, ``OBS0xx`` observability findings) so tooling
  and tests can assert on the exact class;
* **layer provenance** — name, op type, and the originating rewrite rule
  when the layer was produced by :mod:`..search.graph_xfer` (the builder
  graph's layers have none) — or, on source passes, the file and line.

The catalog's text is the JAX package's, reworded where the port's
mechanism differs: the program audit (``AUD0xx``) reads the recorded
aten stream of one real call instead of a jaxpr, and HOT002 is a torch
call on a worker thread.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

# ---------------------------------------------------------------- catalog
# One line per code; tools/torch_pcg_lint.py exports this table verbatim.
CODE_CATALOG: Dict[str, str] = {
    # PCG validator (analysis/pcg_check.py) — compile-blocking classes
    "PCG001": "graph order violation / cycle: a layer consumes a tensor "
              "produced by a later layer (or produced twice)",
    "PCG002": "dangling tensor ref: input tensor has no producer and is "
              "not a model input",
    "PCG003": "dead layer: no output is consumed and none is a protected "
              "graph output (warning)",
    "PCG004": "shape-flow mismatch: declared output dims differ from the "
              "propagated ParallelTensorShape sizes",
    "PCG005": "dtype-flow mismatch: declared output dtype differs from "
              "the propagated dtype",
    "PCG006": "unrealizable sharding: the strategy requests a mesh axis "
              "the op's tensors cannot realize (indivisible dim or axis "
              "conflict) — ops silently drop such requests, so the "
              "executed plan would diverge from the stored one",
    "PCG007": "mesh-axis violation: a partitioned dim references an axis "
              "absent from the mesh or with a mismatched degree",
    "PCG008": "duplicate mesh axis: one mesh axis shards two dims of the "
              "same tensor (impossible block layout)",
    "PCG009": "producer/consumer sharding inconsistency across an edge",
    "PCG010": "memory budget exceeded: weight + optimizer state "
              "(ZeRO- and pipe-aware) over the configured threshold "
              "(warning: the memory-aware search may deliberately "
              "report an over-budget trade-off)",
    "PCG011": "schedule incompatibility: pipe axis degree exceeds the "
              "graph's stage count (compile would silently un-pipe)",
    "PCG012": "unregistered op type: no Op implementation for this layer",
    "PCG013": "strategy for unknown layer: a strategy entry names no "
              "layer in the graph (stale or corrupt plan)",
    "PCG014": "propagation failure: the op rejected its inputs/strategy",
    "PCG015": "illegal pipeline schedule: unknown schedule name, bad "
              "interleave degree, or more virtual chunks than graph ops "
              "for the mesh's pipe axis",
    # strategy linter (analysis/strategy_lint.py) — legal but suspect
    "LINT001": "replicated large weight where a free mesh axis could "
               "shard it",
    "LINT002": "degree-1 parallel choice: strategy entry or parallel op "
               "maps to a trivial (size-1/absent) mesh axis",
    "LINT003": "float-to-float cast in the step graph (mixed-precision "
               "boundary cast in the hot loop)",
    # flight recorder (obs/) — runtime, not compile-time
    "OBS001": "sim-vs-measured divergence: the measured step time missed "
              "the cost model's end-to-end prediction by more than "
              "config.divergence_threshold — the model steering the "
              "search no longer matches this machine (warning)",
    "OBS002": "static-vs-measured peak-memory divergence: the program "
              "audit's static liveness estimate of the recorded step (the "
              "simulator's static memory estimate where the audit did not "
              "run) and the step's measured peak memory on the card "
              "disagree by more than config.exec_mem_threshold — the "
              "liveness model steering memory-aware decisions no longer "
              "matches the allocator (warning; suppressible only with a "
              "reasoned allow entry)",
    "OBS003": "cross-rank step skew: the cohort's steady-state skew "
              "fraction (slowest minus median rank step time, over the "
              "median) exceeded config.cohort_skew_threshold — one "
              "straggler rank is pacing the whole barrier-synchronized "
              "cohort; the finding names it (warning)",
    "PCG016": "non-positive tensor dimension: a declared shape has a "
              "dim <= 0 (e.g. a conv/pool window larger than its input "
              "— the size formula goes negative and downstream sizes "
              "silently multiply back positive); the program cannot "
              "execute",
    # checkpoint/resume (runtime/checkpoint.py) — runtime, not compile
    "CKPT001": "checkpoint topology mismatch: a resume sidecar or "
               "multi-host manifest was written under a different "
               "topology (process count, device count, mesh axes) than "
               "the restoring process — restoring anyway would silently "
               "load a mismatched shard layout; recompile for the new "
               "topology (the strategy-cache key covers it, so search "
               "re-runs) and opt into config.elastic_resume for an "
               "explicit, counted portable restore",
    # program audit (analysis/program_audit.py) — checks over the
    # recorded aten stream of one real call of each step program
    "AUD000": "program could not be recorded for audit — the recorded "
              "call raised and the audit was skipped for this program "
              "(warning; the first real call surfaces the underlying "
              "error with full context)",
    "AUD001": "large closed-over tensor: an op of the recorded call "
              "reads a tensor of at least config.audit_const_bytes that is "
              "neither an argument's storage (params, optimizer state, "
              "batch) nor made inside the call — the step closes over it, "
              "invisible to the caller's placement and donation — or the "
              "call copies that many bytes from the host to the card "
              "(warning)",
    "AUD002": "donation coverage: a param or optimizer-state tensor of "
              "at least config.audit_donate_bytes whose value after the "
              "step lives in a new storage instead of its own (the "
              "port's optimizer updates in place, which is how it "
              "donates; peak memory pays for both buffers), or a caller "
              "reuses a buffer it already donated",
    "AUD003": "host round trip inside a step program: a scalar read "
              "(aten._local_scalar_dense: .item(), float(t), bool(t)), a "
              "device-to-host copy, or an op whose output shape depends "
              "on the data (nonzero, masked_select, unique, "
              "repeat_interleave without output_size) — the host waits "
              "for the card on every call",
    "AUD004": "accumulator precision: a chain of two or more "
              "add-accumulations into one bf16/f16 value at one source "
              "line within the call (a Python loop's running sum) — "
              "every iteration rounds the running sum",
    "AUD005": "collective legality: a partner table of a collective "
              "the call issued (parallel/collectives.py) is not a "
              "permutation within its group, or the pipeline stages' "
              "programs issue different ordered collective sequences — "
              "ranks wait on transfers that never arrive",
    "AUD006": "retrace risk: a traced scalar closure baked into a "
              "compiled step program, or an unhashable static argument. "
              "Cannot fire in the port: an eager step reads its closures "
              "on every call and nothing caches a traced program",
    # dynamic shapes (runtime/buckets.py) — token-native bucketing /
    # packing contract violations, raised at plan time (AUD006's dynamic
    # complement: every bucket compile is planned and counted, so these
    # codes fire where an unplanned shape would otherwise retrace)
    "DYN001": "row length exceeds the bucket ladder top — the ladder "
              "was resolved against different data; dispatching would "
              "silently retrace at an unplanned width",
    "DYN002": "non-trailing label padding: a -1 appears before a valid "
              "token, so pad-to-row-length would drop real tokens — "
              "bucketed packing requires trailing padding only",
    "DYN003": "dynamic-shape misconfiguration: bad seq_buckets/"
              "seq_bucket_pad_max spec, token_budget without a ladder, "
              "non-(N,S) sparse-CE labels, or a mode the packed loader "
              "cannot serve (dense loss, pipelined fit)",
    "DYN004": "token_budget below the ladder top — a max-length row "
              "could never ship within the budget",
    # concurrency auditor (analysis/concurrency_check.py) — whole-package
    # thread-role / lock-graph / shared-state checks
    "CCY000": "unparseable module (syntax error) — excluded from the "
              "concurrency audit",
    "CCY001": "unguarded shared mutation: a field reachable from two or "
              "more thread roles is written with no lock held (error), "
              "or read outside the lock that guards its writes "
              "(warning)",
    "CCY002": "lock-acquisition-order cycle: two locks are taken in "
              "opposite orders on different paths — two threads "
              "interleaving at the ends deadlock (ABBA)",
    "CCY003": "blocking call while holding a lock: queue get/put, "
              "thread/queue join, event wait, host sync or sleep inside "
              "a lock region stalls every thread needing that lock",
    "CCY004": "Condition discipline violation: wait() without an "
              "enclosing predicate loop, or wait/notify outside the "
              "condition's lock",
    "CCY005": "thread leak: a started thread with no join path and no "
              "stop-event — shutdown cannot reclaim it",
    "CCY006": "guarded-by inconsistency: the same field is guarded by "
              "DIFFERENT locks at different sites, so the regions do "
              "not exclude each other",
    # knob-flow auditor (analysis/knobflow_check.py) — cache-key /
    # cohort-key coverage for every compile-determinant config knob
    "KNB000": "unparseable module (syntax error) — excluded from the "
              "knob-flow audit",
    "KNB001": "uncovered compile-determinant knob: a config knob read "
              "on the compile/search path is stamped into neither "
              "_SEARCH_KNOBS nor config_signature — a cached plan "
              "selected under one value would silently replay under "
              "another",
    "KNB002": "uncovered perf-relevant knob: a config knob read on the "
              "fit/serving path is absent from the ledger cohort "
              "context (_KNOB_FIELDS/model_context/"
              "serving_knob_context) — perf_sentinel would compare "
              "runs across different settings (warning)",
    "KNB003": "dead knob: defined in config.py, never read anywhere "
              "in the scanned source (warning)",
    "KNB004": "CLI-flag/config-field parity drift: parse_args sets an "
              "unknown field, one flag claims two fields, or a field "
              "has no flag at all (the last: warning)",
    "KNB005": "unvalidated serializer version: a *_SCHEMA/*_VERSION "
              "constant is written into records but no reader ever "
              "compares against it — a layout change would be "
              "consumed silently instead of demoting to a counted "
              "skip",
    "KNB006": "guard-asymmetric stamp: a knob stamped into the key "
              "only under a mode guard is read without consulting the "
              "same mode knob — the knob can influence the run while "
              "the key omits it",
    # hot-path lint (analysis/hotpath_lint.py) — source-level race/sync
    "HOT000": "unparseable source file (syntax error) — nothing else "
              "could be checked",
    "HOT001": "host sync inside the step loop (.item() / .tolist() / "
              ".cpu() / .numpy() / float() / int() / bool() / np.asarray / "
              "torch.cuda.synchronize / Event.synchronize)",
    "HOT002": "device work (a torch call that allocates or launches on "
              "the card) on an input-pipeline worker thread",
    "HOT003": "shared-state mutation in a worker thread without "
              "lock/queue discipline",
    # serving KV quantization gate (serving/generation.py PagedDecoder
    # calibration)
    "KVQ001": "quantized KV pool calibration divergence exceeds "
              "serving_kv_divergence_budget — decoder fell back to "
              "float32 arenas (loud: stderr + "
              "serving.kv_dtype_fallbacks counter)",
}

_SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass
class Finding:
    """One violation/observation from any analysis pass."""

    code: str
    severity: str  # "error" | "warning" | "info"
    message: str
    layer: Optional[str] = None      # layer name (graph passes)
    op_type: Optional[str] = None    # op type string (graph passes)
    origin: Optional[str] = None     # rewrite rule that made the layer
    file: Optional[str] = None       # source file (hot-path lint)
    line: Optional[int] = None       # source line (hot-path lint)

    def __post_init__(self):
        assert self.severity in _SEVERITIES, self.severity

    def where(self) -> str:
        if self.file is not None:
            return f"{self.file}:{self.line}"
        if self.layer is not None:
            prov = f"layer '{self.layer}'"
            if self.op_type:
                prov += f" (op {self.op_type}"
                prov += f", via rewrite {self.origin})" if self.origin \
                    else ")"
            return prov
        return "<graph>"

    def format(self) -> str:
        return f"{self.code} [{self.severity}] {self.where()}: " \
               f"{self.message}"

    def to_dict(self) -> Dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass
class ValidationReport:
    """Findings from one analysis run, ordered by discovery."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    source: str = "builder"  # "builder" | "cache" | "rewrite" | path
    # which gate produced the report: "pcg" (graph passes), "audit"
    # (program audit), "concurrency" (whole-package concurrency
    # audit) or "knobflow" (config-knob key-coverage audit) — picks
    # the print prefix and the error class
    tag: str = "pcg"

    def add(self, code: str, message: str, *, severity: str = "error",
            layer=None, **kw) -> Finding:
        """Append one finding; ``layer`` may be a Layer object (provenance
        is extracted) or a plain name string."""
        name = op_type = origin = None
        if layer is not None:
            if isinstance(layer, str):
                name = layer
            else:
                name = layer.name
                op_type = getattr(getattr(layer, "op_type", None),
                                  "value", None)
                origin = layer.attrs.get("_origin_rewrite") \
                    if getattr(layer, "attrs", None) else None
        f = Finding(code=code, severity=severity, message=message,
                    layer=name, op_type=op_type, origin=origin, **kw)
        self.findings.append(f)
        return f

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> List[str]:
        return [f.code for f in self.findings]

    def format(self) -> str:
        return "\n".join(f.format() for f in self.findings) or "clean"

    def to_json(self) -> Dict:
        """The machine-readable report (tools/torch_pcg_lint.py schema)."""
        return {
            "source": self.source,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "findings": [f.to_dict() for f in self.findings],
        }

    def handle(self, mode: str, printer=print) -> None:
        """Apply a gate mode (``config.validate_pcg`` /
        ``config.audit_programs``): ``"error"`` raises the gate's coded
        error when any error-severity finding exists (warnings stay
        silent on the report object); ``"warn"`` prints everything;
        ``"off"`` is a no-op."""
        if mode == "off":
            return
        if mode == "error" and self.errors:
            raise _TAG_ERRORS.get(self.tag, PCGValidationError)(self)
        if mode == "warn" and self.findings:
            for f in self.findings:
                printer(f"[{self.tag}] {f.format()}", flush=True)


class PCGValidationError(ValueError):
    """A PCG validation gate failure. ``report`` carries every finding;
    the message leads with the first error (code + layer provenance) so
    the one-line traceback is already actionable."""

    _WHAT = "PCG validation failed"

    def __init__(self, report: ValidationReport):
        self.report = report
        errs = report.errors
        head = errs[0].format() if errs else report.format()
        more = f" (+{len(errs) - 1} more)" if len(errs) > 1 else ""
        super().__init__(
            f"{self._WHAT} [{report.source}]: {head}{more}")


class ProgramAuditError(PCGValidationError):
    """A program-audit gate failure (AUD0xx codes). Subclasses
    :class:`PCGValidationError` so existing except-clauses around
    compile() keep catching every analysis gate."""

    _WHAT = "program audit failed"


class ConcurrencyAuditError(PCGValidationError):
    """A concurrency-audit gate failure (CCY0xx codes); same subclass
    rationale as :class:`ProgramAuditError`."""

    _WHAT = "concurrency audit failed"


class KnobFlowAuditError(PCGValidationError):
    """A knob-flow audit gate failure (KNB0xx codes); same subclass
    rationale as :class:`ProgramAuditError`."""

    _WHAT = "knob-flow audit failed"


_TAG_ERRORS = {
    "audit": ProgramAuditError,
    "concurrency": ConcurrencyAuditError,
    "knobflow": KnobFlowAuditError,
}


def gate_mode(mode: Optional[str], knob: str) -> str:
    """A gate's validated mode: ``mode`` is the config's ``knob`` value
    ("error", "warn" or "off"; None is "off"), and a misspelled mode
    raises instead of silently turning the gate off."""
    mode = mode or "off"
    if mode not in ("error", "warn", "off"):
        raise ValueError(f"{knob}={mode!r}: expected 'error', 'warn' or 'off'")
    return mode


def layer_provenance(layer) -> str:
    """One-line provenance for compile-time error messages (the same
    plumbing the validator's findings use): layer name, op type, and the
    originating rewrite rule when the layer came out of graph_xfer."""
    op = getattr(getattr(layer, "op_type", None), "value", None)
    origin = layer.attrs.get("_origin_rewrite") \
        if getattr(layer, "attrs", None) else None
    s = f"layer '{layer.name}'"
    if op:
        s += f" (op {op}" + (f", via rewrite {origin})" if origin else ")")
    return s


def report_to_json_line(reports: Dict[str, ValidationReport],
                        extra: Optional[Dict] = None) -> str:
    """The one-line JSON record tools/torch_pcg_lint.py emits."""
    doc = {
        "reports": {k: r.to_json() for k, r in reports.items()},
        "codes": CODE_CATALOG,
    }
    if extra:
        doc.update(extra)
    return json.dumps(doc, sort_keys=True)
