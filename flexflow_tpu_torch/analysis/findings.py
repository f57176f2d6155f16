"""Finding and report types shared by the analysis passes.

PyTorch counterpart of the part of ``flexflow_tpu/analysis/findings.py``
that the observability layer needs: :class:`Finding`,
:class:`ValidationReport`, the code table of the observability findings
(OBS001 divergence, OBS002 peak memory, OBS003 cross-rank skew) and
:func:`layer_provenance`. Every finding carries a machine-readable code
and, on graph passes, the layer's provenance: name, op type and the
rewrite rule that made it (``search/graph_xfer.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

CODE_CATALOG: Dict[str, str] = {
    "OBS001": "sim-vs-measured divergence: the measured step time missed "
              "the cost model's end-to-end prediction by more than "
              "config.divergence_threshold — the model steering the "
              "search no longer matches this machine (warning)",
    "OBS002": "static-vs-measured peak-memory divergence: the simulator's "
              "static memory estimate and the step's measured peak "
              "memory on the card disagree by more than "
              "config.exec_mem_threshold — the liveness model steering "
              "memory-aware decisions no longer matches the allocator "
              "(warning; suppressible only with a reasoned allow entry)",
    "OBS003": "cross-rank step skew: the cohort's steady-state skew "
              "fraction (slowest minus median rank step time, over the "
              "median) exceeded config.cohort_skew_threshold — one "
              "straggler rank is pacing the whole barrier-synchronized "
              "cohort; the finding names it (warning)",
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
        """The machine-readable report."""
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


# A11's gates (program audit, concurrency, knob flow) add their error
# classes here by tag
_TAG_ERRORS: Dict[str, type] = {}


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
