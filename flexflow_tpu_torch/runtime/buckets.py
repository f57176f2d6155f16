"""Sequence buckets: the bucket ladder and the token-budget packing plan.

The port's own copy of the pure-numpy ``flexflow_tpu/runtime/buckets.py``
(the same functions, names and error codes). Padding every batch of a
variable-length workload to the dataset's longest row wastes work on dead
positions; a pow2 pad-to-bucket ladder pads each batch's sequence dim to
the smallest rung that fits its longest row instead, so the set of
dispatch shapes stays bounded (one per distinct (rows, bucket), each
counted on ``fit.bucket_compiles``) and the padded-token share drops.

Everything here is host-side planning over numpy length vectors:

* :func:`resolve_ladder`: the config knobs -> a sorted rung tuple;
* :func:`bucket_for`: the smallest rung >= a length (DYN001 past the top);
* :func:`row_lengths`: per-row valid-token counts from trailing ``-1``
  padding of sparse-CE labels (DYN002 on interior padding);
* :func:`build_epoch_plan`: the epoch plan, fixed-row groups or
  token-budget packing with pow2-quantized row counts. A pure function of
  (permuted lengths, knobs), so a resumed epoch rebuilds the same plan.

The padded positions are inert: the masked sparse-CE loss and metrics
(``runtime/loss.py``, ``runtime/metrics.py``) give every ``-1`` position
an exactly-zero term, so its gradient contributions are exact zeros, and
causal attention keeps padding out of the valid rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


class DynamicShapeError(ValueError):
    """Coded dynamic-shape planning error (DYN001..DYN004)."""

    def __init__(self, code: str, msg: str):
        super().__init__(f"{code}: {msg}")
        self.code = code


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def resolve_ladder(spec: str, lo: int, hi: int) -> Tuple[int, ...]:
    """Resolve the ``seq_buckets`` knob into a sorted rung tuple.

    ``spec``: ``"pow2"`` (powers of two from ``lo`` up; the top rung is
    ``hi`` itself so the data's full width is always reachable) or an
    explicit comma list (``"32,64,128"``). ``hi`` is the sequence dim of
    the data; an explicit ladder is capped there and always ends on it.
    The mode-knob convention: a typo raises here, at entry, not as a
    shape error steps later.
    """
    if hi <= 0:
        raise DynamicShapeError(
            "DYN003", f"seq_bucket_max resolved to {hi}; the data has no "
            "sequence dim to bucket (sparse-CE labels must be (N, S))")
    if spec == "pow2":
        lo = max(1, int(lo))
        rungs = []
        b = _next_pow2(lo)
        while b < hi:
            rungs.append(b)
            b *= 2
        rungs.append(hi)
        return tuple(rungs)
    try:
        rungs = sorted({int(x) for x in str(spec).split(",") if x.strip()})
    except ValueError:
        rungs = []
    if not rungs or any(r <= 0 for r in rungs):
        raise DynamicShapeError(
            "DYN003", f"seq_buckets={spec!r} is neither 'off', 'pow2' "
            "nor a comma list of positive lengths")
    rungs = [r for r in rungs if r < hi] + [hi]
    return tuple(rungs)


def bucket_for(ladder: Sequence[int], length: int) -> int:
    """Smallest rung >= ``length``; DYN001 past the top (the caller
    sized the ladder from the data, so this firing means the data changed
    under it)."""
    for b in ladder:
        if length <= b:
            return b
    raise DynamicShapeError(
        "DYN001", f"row length {length} exceeds the bucket ladder top "
        f"{ladder[-1]}; re-resolve the ladder for this data")


def row_lengths(labels: np.ndarray) -> np.ndarray:
    """Per-row valid-token counts of a sparse-CE label array (N, S)
    whose padding convention is TRAILING ``-1``s.

    Interior negatives would make "pad to the row's length" drop real
    tokens, so the contract is validated up front (DYN002) rather than
    silently truncating mid-row.
    """
    lab = np.asarray(labels)
    if lab.ndim != 2:
        raise DynamicShapeError(
            "DYN003", f"bucketing needs (N, S) sparse-CE labels, got "
            f"shape {lab.shape}")
    valid = lab >= 0
    lengths = valid.sum(axis=1).astype(np.int64)
    expect = np.arange(lab.shape[1])[None, :] < lengths[:, None]
    if not np.array_equal(valid, expect):
        bad = int(np.nonzero((valid != expect).any(axis=1))[0][0])
        raise DynamicShapeError(
            "DYN002", f"label row {bad} has non-trailing padding (a -1 "
            "before a valid token); bucketed packing requires trailing "
            "padding only")
    return lengths


@dataclasses.dataclass(frozen=True)
class PlanGroup:
    """One packed batch of the epoch plan, in dispatch order.

    ``rows`` real samples (consecutive in the epoch permutation) padded
    up to ``pad_rows`` all-padding rows, sequence dim padded to
    ``width``; ``valid_tokens``/``total_tokens`` feed the padded-token
    fraction without another pass over the data.
    """

    rows: int
    pad_rows: int
    width: int
    valid_tokens: int

    @property
    def total_tokens(self) -> int:
        return self.pad_rows * self.width


@dataclasses.dataclass(frozen=True)
class PackingSpec:
    """Resolved dynamic-shape configuration handed to the dataloader.

    ``quantum`` is the data-parallel degree of the batch axis (1 on one
    card): every ``pad_rows`` is a pow2 multiple of it, so the shape set
    stays bounded (at most log2(cap/quantum)+1 row counts per rung).
    ``pad_max`` keeps the PLAN (groups, order, row padding) but pads
    every width to the ladder top: the pad-to-max comparison run.
    """

    ladder: Tuple[int, ...]
    token_budget: int  # 0 = fixed-row groups (bucketed compile only)
    batch_size: int
    quantum: int = 1
    pad_max: bool = False
    # per-loader assembly directives (aligned with the group's loaders)
    seq_axes: Tuple[bool, ...] = ()
    pad_values: Tuple[int, ...] = ()

    def row_cap(self, width: int) -> int:
        """Largest admissible pad_rows for a rung: the biggest
        quantum*2^j at or under the token budget (never below one
        quantum — a single over-long row still has to ship)."""
        cap = max(1, self.token_budget // max(1, width))
        q = max(1, self.quantum)
        p = q
        while p * 2 <= max(q, cap):
            p *= 2
        return p

    def quantize_rows(self, rows: int, width: int) -> int:
        q = max(1, self.quantum)
        p = q * _next_pow2(max(1, (rows + q - 1) // q))
        if self.token_budget > 0:
            return min(p, self.row_cap(width))
        return p


def build_epoch_plan(lengths: np.ndarray,
                     spec: PackingSpec) -> List[PlanGroup]:
    """The deterministic epoch plan over ``lengths`` — already in
    PERMUTED order (the caller applies the epoch's shuffle permutation
    first, so the plan is a pure function of (seed, epoch)).

    ``token_budget == 0``: fixed ``batch_size``-row groups in order,
    truncated to whole batches (the historical loader semantics), each
    dispatched at its own rung. ``token_budget > 0``: greedy in-order
    packing — a group closes when adding the next row would push
    ``pad_rows * width`` past the budget (width being the rung of the
    group max including that row) or past the rung's row cap. In-order
    (no length sorting) keeps sample order a function of the shuffle
    permutation alone, which resume's skip-replay depends on.
    """
    lens = np.asarray(lengths, dtype=np.int64)
    # Packing decisions ALWAYS use the bucketed rung so pad_max shares
    # the exact same grouping (same groups, same pad_rows) and differs
    # only in dispatch width — that is what makes its trajectories
    # bit-comparable to the bucketed run's.
    width_of = lambda l: bucket_for(spec.ladder, int(l))  # noqa: E731
    ship_w = (lambda _w: spec.ladder[-1]) if spec.pad_max else (
        lambda w: w)
    plan: List[PlanGroup] = []
    if spec.token_budget <= 0:
        nb = len(lens) // spec.batch_size
        for i in range(nb):
            rows = lens[i * spec.batch_size:(i + 1) * spec.batch_size]
            w = width_of(rows.max())
            plan.append(PlanGroup(spec.batch_size, spec.batch_size,
                                  ship_w(w), int(rows.sum())))
        return plan
    if spec.token_budget < spec.ladder[-1]:
        raise DynamicShapeError(
            "DYN004", f"token_budget {spec.token_budget} is below the "
            f"ladder top {spec.ladder[-1]}; a max-length row could "
            "never ship")
    start = 0
    n = len(lens)
    while start < n:
        end = start
        gmax = 0
        while end < n:
            cand_max = max(gmax, int(lens[end]))
            w = width_of(cand_max)
            rows = end - start + 1
            if rows > spec.row_cap(w) or \
                    spec.quantize_rows(rows, w) * w > spec.token_budget:
                if end == start:
                    # a single row must always ship (budget >= ladder
                    # top guarantees quantum * width can exceed the
                    # budget only through row quantization, which
                    # row_cap already floors at one quantum)
                    end += 1
                    gmax = cand_max
                break
            gmax = cand_max
            end += 1
        rows = end - start
        w = width_of(gmax)
        plan.append(PlanGroup(rows, spec.quantize_rows(rows, w),
                              ship_w(w), int(lens[start:end].sum())))
        start = end
    return plan


def plan_token_stats(plan: Sequence[PlanGroup]) -> Tuple[int, int]:
    """(valid_tokens, total_tokens) over a plan — the epoch's
    padded-token fraction is ``1 - valid/total``."""
    valid = sum(g.valid_tokens for g in plan)
    total = sum(g.total_tokens for g in plan)
    return valid, total
