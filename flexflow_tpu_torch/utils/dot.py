"""Dot-file writers for the graph exports.

PyTorch counterpart of ``flexflow_tpu/utils/dot.py`` (reference:
include/flexflow/utils/dot/, used by the ``--compgraph`` and
``--taskgraph`` exports, model.cc:3666-3674): one record-shaped node an
op, edges by tensor, and :func:`annotate_findings` to colour nodes by
analysis findings."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# severity -> node fill color for annotated findings
_SEVERITY_COLORS = {
    "error": "#ffb3b3",    # red: validator rejections
    "warning": "#ffe0a3",  # amber: linter findings
    "info": "#cfe2ff",     # blue: informational
}
_SEVERITY_RANK = {"error": 2, "warning": 1, "info": 0}


def _esc(s: str) -> str:
    return s.replace('"', '\\"')


class DotFile:
    """Minimal digraph writer matching the reference's export format: one
    record-shaped node per op, edges per tensor. Nodes are kept
    structured until :meth:`render` so annotation passes can restyle
    them after the graph is built."""

    def __init__(self, name: str = "graph"):
        self.name = name
        # node_id -> attr dict (insertion-ordered; label/shape seeded by
        # add_node, later writers — annotate() — win)
        self.nodes: Dict[str, Dict[str, str]] = {}
        self.edges: List[str] = []

    def add_node(self, node_id: str, label: str,
                 extra: Optional[Dict[str, str]] = None) -> None:
        attrs = {"label": label, "shape": "record"}
        attrs.update(extra or {})
        self.nodes[node_id] = attrs

    def add_edge(self, src: str, dst: str, label: str = "") -> None:
        lab = f' [label="{_esc(label)}"]' if label else ""
        self.edges.append(f'  "{_esc(src)}" -> "{_esc(dst)}"{lab};')

    def annotate(self, node_id: str, note: str,
                 severity: str = "warning") -> bool:
        """Append an analysis note to a node's label and color it by
        severity (errors win over warnings win over info). Returns False
        when the node does not exist — annotation must never invent
        graph structure. Record-label metacharacters in the note are
        backslash-escaped: finding messages embed braces/pipes (strategy
        dict reprs) and the default node shape is ``record``, where raw
        ``{ } | < >`` change the label structure."""
        attrs = self.nodes.get(node_id)
        if attrs is None:
            return False
        for ch in "{}|<>":
            note = note.replace(ch, "\\" + ch)
        attrs["label"] = attrs.get("label", node_id) + f"\\n{note}"
        cur = attrs.get("_severity", "")
        if _SEVERITY_RANK.get(severity, 0) >= _SEVERITY_RANK.get(cur, -1):
            attrs["_severity"] = severity
            attrs["style"] = "filled"
            attrs["fillcolor"] = _SEVERITY_COLORS.get(
                severity, _SEVERITY_COLORS["info"])
        return True

    def render(self) -> str:
        lines = []
        for node_id, attrs in self.nodes.items():
            a = ", ".join(f'{k}="{_esc(v)}"' for k, v in attrs.items()
                          if not k.startswith("_"))
            lines.append(f'  "{_esc(node_id)}" [{a}];')
        body = "\n".join(lines + self.edges)
        return f'digraph "{_esc(self.name)}" {{\n{body}\n}}\n'

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.render())


def annotate_findings(dot: DotFile, findings: Iterable) -> int:
    """Render analysis findings onto an existing strategy/graph export.

    ``findings``: :class:`~flexflow_tpu_torch.analysis.findings.Finding`
    objects OR plain dicts in their ``to_dict`` JSON shape
    (``{"code", "severity", "layer", "message"}``). Findings are matched
    to nodes by layer name; graph-level findings (no layer) land on a
    synthetic ``__graph__`` legend node. Returns the number of findings
    actually attached."""
    n = 0
    for f in findings:
        if isinstance(f, dict):
            code = f.get("code", "?")
            severity = f.get("severity", "warning")
            layer = f.get("layer")
            message = f.get("message", "")
        else:
            code, severity = f.code, f.severity
            layer, message = f.layer, f.message
        note = f"[{code}] {message}"
        if len(note) > 120:
            note = note[:117] + "..."
        if layer is not None and dot.annotate(layer, note, severity):
            n += 1
            continue
        # graph-level (or unmatched-layer) findings: one legend node
        if "__graph__" not in dot.nodes:
            dot.add_node("__graph__", "analysis findings",
                         extra={"shape": "note"})
        dot.annotate("__graph__", note, severity)
        n += 1
    return n
