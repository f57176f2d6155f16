"""Shared suppression-pragma grammar for every static-analysis pass.

A copy of ``flexflow_tpu/analysis/pragmas.py`` (the port imports nothing
of the JAX package). The hot-path lint's inline suppressions
(``# hotpath: sync-ok (reason)``) and the program auditor's
(``# audit: const-ok (...)``, ``# audit: donate-ok (...)``) share ONE
grammar:

    # <tool>: <token> (<reason>)

* ``tool``  — the pass family: ``hotpath`` (AST lint), ``audit``
  (recorded-step program audit), ``concurrency`` (whole-package concurrency
  audit), ``knobflow`` (config-knob key-coverage audit). Lowercase
  letters only.
* ``token`` — the specific suppression, conventionally ``<what>-ok``:
  ``sync-ok``/``lock-ok`` (HOT001-003), ``const-ok`` (AUD001),
  ``donate-ok`` (AUD002), ``callback-ok`` (AUD003), ``accum-ok``
  (AUD004), ``collective-ok`` (AUD005), ``retrace-ok`` (AUD006),
  ``race-ok``/``order-ok``/
  ``block-ok``/``cond-ok``/``leak-ok``/``guard-ok`` (CCY001-006),
  ``key-ok``/``cohort-ok``/``dead-ok``/``flag-ok``/``schema-ok``/
  ``guard-ok`` (KNB001-006). Lowercase letters/digits/dashes.
* ``reason`` — REQUIRED free text. The pragma is the review trail:
  a suppression without a reason does not suppress (and
  :func:`lint_reasonless` reports it so the gap is visible).

A pragma applies to the source LINE it sits on — the line that raises
the finding (for program-audit findings: the port source line that
issued the recorded op). Multiple pragmas may share a line.

Example::

    table = torch.load(path)       # audit: const-ok (4KB lookup table)
    q.put(batch)                   # hotpath: lock-ok (Queue is thread-safe)
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

_PRAGMA_RE = re.compile(
    r"#\s*(?P<tool>[a-z]+)\s*:\s*(?P<token>[a-z][a-z0-9-]*)"
    r"(?:\s*\(\s*(?P<reason>[^)]*?)\s*\))?")


@dataclasses.dataclass(frozen=True)
class Pragma:
    tool: str
    token: str
    reason: Optional[str]  # None when the parens were omitted entirely

    def ok(self) -> bool:
        """A pragma only suppresses when it carries a non-empty reason."""
        return bool(self.reason)


def parse_line(line: str) -> List[Pragma]:
    """Every pragma on one source line (there may be several)."""
    out = []
    for m in _PRAGMA_RE.finditer(line):
        reason = m.group("reason")
        out.append(Pragma(m.group("tool"), m.group("token"),
                          reason if reason else None))
    return out


def line_has(lines: Sequence[str], lineno: int, tool: str,
             token: str) -> bool:
    """True when line ``lineno`` (1-based) carries an effective
    ``# <tool>: <token> (reason)`` pragma."""
    if not (0 < lineno <= len(lines)):
        return False
    return any(p.tool == tool and p.token == token and p.ok()
               for p in parse_line(lines[lineno - 1]))


# small per-process cache so program-audit suppression checks (one lookup
# per finding, same few files) do not re-read source files
_FILE_CACHE: Dict[str, Tuple[float, List[str]]] = {}


def file_lines(path: str) -> List[str]:
    import os

    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return []
    hit = _FILE_CACHE.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    try:
        with open(path, errors="replace") as f:
            lines = f.read().splitlines()
    except OSError:
        lines = []
    _FILE_CACHE[path] = (mtime, lines)
    return lines


def file_has(path: Optional[str], lineno: Optional[int], tool: str,
             token: str) -> bool:
    """Like :func:`line_has` but reading (and caching) ``path``."""
    if not path or not lineno:
        return False
    return line_has(file_lines(path), lineno, tool, token)


def lint_reasonless(src: str) -> List[Tuple[int, Pragma]]:
    """Pragmas that would NOT suppress because the reason is missing or
    empty — surfaced so a decorative suppression cannot silently rot."""
    out = []
    for i, line in enumerate(src.splitlines(), start=1):
        for p in parse_line(line):
            if not p.ok():
                out.append((i, p))
    return out
