"""Analysis: the finding and report types the observability layer raises
(:mod:`.findings`)."""

from .findings import CODE_CATALOG, Finding, ValidationReport, layer_provenance

__all__ = ["CODE_CATALOG", "Finding", "ValidationReport", "layer_provenance"]
