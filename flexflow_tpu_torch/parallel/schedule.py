"""Pipeline schedule IR: tick tables for GPipe / 1F1B / interleaved.

PyTorch port's own copy of ``flexflow_tpu/parallel/schedule.py`` (pure
Python; the port imports nothing of the JAX package). The schedule is an
inspectable object the two engines replay verbatim: the host-driven
:mod:`.pipeline` and the single-call :mod:`.pipeline_compiled`.

Representation: ``ticks[t][s]`` is the :class:`Action` stage *s* executes
at tick *t* (or None = bubble). Actions are ``F`` (forward of one
microbatch through one stage chunk), ``B`` (backward), or ``FB`` (the
last chunk's fused forward+loss+backward, the pipeline's tail turnaround).

Schedules are built from per-stage ordered work queues by a greedy ASAP
placement with a one-tick transfer latency between stages; the per-stage
queue ORDER is what distinguishes GPipe from 1F1B (1F1B interleaves one
backward after each steady-state forward, which caps the live activations
a stage holds at O(num_stages) instead of O(num_microbatches)). Every
stage runs its backwards in microbatch order under every schedule, so
the gradient-accumulation order, and so each step's numbers, do not
depend on the schedule.

Interleaved virtual stages (``interleave`` = V > 1) split the op chain
into S*V chunks; stage s hosts chunks {s, s+S, ...} and each microbatch
makes V round trips. The per-stage queue merges the chunks' work in
virtual-(S*V)-stage 1F1B priority order, shrinking the bubble by ~V at
the cost of V x boundary traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# action kinds
F, B, FB = "F", "B", "FB"

SCHEDULES = ("gpipe", "1f1b", "interleaved")


@dataclasses.dataclass(frozen=True)
class Action:
    """One unit of stage work: ``kind`` ∈ {"F","B","FB"}, microbatch
    ``mb``, and the virtual ``chunk`` the work belongs to (chunk = stage
    index when interleave == 1)."""

    kind: str
    mb: int
    chunk: int


class ScheduleError(ValueError):
    """An (schedule, num_stages, num_microbatches, interleave) combination
    the engines cannot execute."""


def check_schedule(kind: str, num_stages: int, num_microbatches: int,
                   interleave: int = 1) -> None:
    """Raise :class:`ScheduleError` on an illegal combination. The single
    legality source shared by the engines and the config resolution."""
    if kind not in SCHEDULES:
        raise ScheduleError(
            f"unknown pipeline schedule {kind!r}: expected one of "
            f"{'|'.join(SCHEDULES)} (or 'auto' before resolution)")
    if num_stages < 2:
        raise ScheduleError(
            f"pipeline needs at least 2 stages, got {num_stages}")
    if num_microbatches < 1:
        raise ScheduleError(
            f"num_microbatches must be >= 1, got {num_microbatches}")
    if interleave < 1:
        raise ScheduleError(f"interleave must be >= 1, got {interleave}")
    if kind != "interleaved" and interleave != 1:
        raise ScheduleError(
            f"interleave={interleave} requires schedule='interleaved' "
            f"(got {kind!r})")
    if kind == "interleaved" and interleave < 2:
        raise ScheduleError(
            "schedule='interleaved' needs interleave >= 2 virtual chunks "
            "per stage (interleave=1 IS 1f1b; use that)")


def _stage_orders(kind: str, S: int, M: int, V: int) -> List[List[Action]]:
    """Per-stage ordered work queues. The LAST chunk's F+B always fuse
    into one FB action (the engines' compiled tail program computes
    forward, loss, and backward in one program — the same turnaround the
    sync GPipe engine has always used, so numerics are unchanged)."""
    C = S * V  # total virtual chunks
    if kind == "gpipe":
        orders = []
        for s in range(S):
            if s == S - 1:
                orders.append([Action(FB, m, S - 1) for m in range(M)])
            else:
                orders.append([Action(F, m, s) for m in range(M)]
                              + [Action(B, m, s) for m in range(M)])
        return orders
    if kind == "1f1b":
        orders = []
        for s in range(S):
            if s == S - 1:
                orders.append([Action(FB, m, S - 1) for m in range(M)])
                continue
            w = min(M, S - s)  # warmup depth
            q = [Action(F, m, s) for m in range(w)]
            for m in range(M - w):
                q.append(Action(B, m, s))
                q.append(Action(F, w + m, s))
            for m in range(M - w, M):
                q.append(Action(B, m, s))
            orders.append(q)
        return orders
    # interleaved: materialize the virtual C-stage 1f1b schedule, then
    # fold virtual stage c onto physical stage c % S, ordering each
    # physical stage's queue by the action's VIRTUAL tick (tie-broken by
    # earlier chunk). Virtual ticks are a topological order of the
    # dependency DAG and same-physical-stage contention only delays
    # actions, so the ASAP replay below can never deadlock; the order is
    # deterministic, so the gradient-accumulation order is reproducible.
    vsched = build_schedule("1f1b", C, M, 1)
    orders = [[] for _ in range(S)]
    keyed: List[List[Tuple[int, int, Action]]] = [[] for _ in range(S)]
    for t, row in enumerate(vsched.ticks):
        for c, a in enumerate(row):
            if a is not None:
                keyed[c % S].append((t, c, Action(a.kind, a.mb, c)))
    for s in range(S):
        keyed[s].sort(key=lambda e: (e[0], e[1]))
        orders[s] = [a for _, _, a in keyed[s]]
    return orders


def _deps(a: Action, S: int, V: int) -> List[Action]:
    """Cross-stage dependencies of one action (same-stage ordering is
    enforced by the queue itself). One-tick transfer latency is applied
    by the ASAP placement, not here."""
    C = S * V
    if a.kind in (F, FB):
        if a.chunk == 0:
            return []
        up = a.chunk - 1
        kind = FB if up == C - 1 else F  # never: upstream of FB is F
        return [Action(kind, a.mb, up)]
    # backward: needs the downstream chunk's backward (or the tail FB)
    down = a.chunk + 1
    return [Action(FB if down == C - 1 else B, a.mb, down)]


@dataclasses.dataclass
class PipelineSchedule:
    """A fully-materialized schedule: the tick table plus the static
    stats every consumer reads off it."""

    kind: str
    num_stages: int
    num_microbatches: int
    interleave: int
    ticks: List[List[Optional[Action]]]

    # ------------------------------------------------------------- stats
    @property
    def num_ticks(self) -> int:
        return len(self.ticks)

    def actions(self, stage: int) -> List[Action]:
        return [row[stage] for row in self.ticks if row[stage] is not None]

    def work_slots(self) -> int:
        """Occupied (stage, tick) slots; FB counts once (one program)."""
        return sum(1 for row in self.ticks for a in row if a is not None)

    def bubble_fraction(self, bwd_ratio: float = 2.0) -> float:
        """Idle fraction of the (stage × tick) grid, weighting each
        action by its relative cost (F=1, B=bwd_ratio, FB=1+bwd_ratio)
        under the tick-synchronous time model: each tick costs the MAX
        over stages, a stage's useful work is the SUM of its actions."""
        w = {F: 1.0, B: float(bwd_ratio), FB: 1.0 + float(bwd_ratio)}
        total = 0.0
        for row in self.ticks:
            total += max((w[a.kind] for a in row if a is not None),
                         default=0.0)
        useful = sum(w[a.kind] for row in self.ticks for a in row
                     if a is not None)
        cap = total * self.num_stages
        return 1.0 - useful / cap if cap > 0 else 0.0

    def step_ticks_cost(self, t_fwd: float, t_bwd: float) -> float:
        """Tick-synchronous step time for uniform per-stage costs: every
        tick costs the most expensive action running in it (stages wait
        on each other at tick boundaries — the lock-step model both the
        single-dispatch engine's scan and the host engine's dependency
        chain converge to in steady state)."""
        w = {F: t_fwd, B: t_bwd, FB: t_fwd + t_bwd}
        return sum(max((w[a.kind] for a in row if a is not None),
                       default=0.0) for row in self.ticks)

    def peak_live(self, stage: int) -> int:
        """Max simultaneously-live forward activations stage ``stage``
        holds (stage inputs saved for a later backward; an FB releases
        within its own tick but holds one during it). THE 1F1B claim:
        O(num_stages) here vs O(num_microbatches) for GPipe."""
        live = 0
        peak = 0
        for row in self.ticks:
            a = row[stage]
            if a is None:
                continue
            if a.kind == F:
                live += 1
                peak = max(peak, live)
            elif a.kind == B:
                peak = max(peak, live)
                live -= 1
            else:  # FB: holds its input for the duration of the tick
                peak = max(peak, live + 1)
        return peak

    def peak_live_total(self) -> int:
        return max(self.peak_live(s) for s in range(self.num_stages))

    def host_dispatches(self) -> int:
        """Program dispatches the host-driven engine issues per step:
        one per action plus one optimizer update per stage. Boundary
        device_put transfers ride on top (one per cross-stage edge) —
        counted separately by the engine's live counter."""
        return self.work_slots() + self.num_stages

    def transfer_edges(self) -> int:
        """Cross-stage boundary transfers per step (forward activations
        + backward cotangents actually shipped)."""
        n = 0
        C = self.num_stages * self.interleave
        for row in self.ticks:
            for a in row:
                if a is None:
                    continue
                if a.kind in (F,) and a.chunk < C - 1:
                    n += 1
                if a.kind in (B, FB) and a.chunk > 0:
                    n += 1
        return n

    def validate_buffers(self) -> int:
        """Verify the one-slot-per-edge transfer discipline the compiled
        engine relies on: every shipped value is consumed before the next
        value arrives on the same edge. Returns the max number of
        in-flight values per edge (1 when the discipline holds); raises
        :class:`ScheduleError` on a clobber."""
        C = self.num_stages * self.interleave
        pending_f: Dict[int, List[int]] = {c: [] for c in range(C)}
        pending_b: Dict[int, List[int]] = {c: [] for c in range(C)}
        worst = 0
        for t, row in enumerate(self.ticks):
            # consume at tick start
            for a in row:
                if a is None:
                    continue
                if a.kind in (F, FB) and a.chunk > 0:
                    if not pending_f[a.chunk] or \
                            pending_f[a.chunk][0] != a.mb:
                        raise ScheduleError(
                            f"tick {t}: {a} consumes a forward input "
                            f"that has not arrived (pending "
                            f"{pending_f[a.chunk]})")
                    pending_f[a.chunk].pop(0)
                if a.kind == B and a.chunk < C - 1:
                    if not pending_b[a.chunk] or \
                            pending_b[a.chunk][0] != a.mb:
                        raise ScheduleError(
                            f"tick {t}: {a} consumes a cotangent that "
                            f"has not arrived (pending "
                            f"{pending_b[a.chunk]})")
                    pending_b[a.chunk].pop(0)
            # produce at tick end
            for a in row:
                if a is None:
                    continue
                if a.kind == F and a.chunk < C - 1:
                    pending_f[a.chunk + 1].append(a.mb)
                if a.kind in (B, FB) and a.chunk > 0:
                    pending_b[a.chunk - 1].append(a.mb)
            worst = max(worst, *(len(v) for v in pending_f.values()),
                        *(len(v) for v in pending_b.values()))
        return max(worst, 1)


def build_schedule(kind: str, num_stages: int, num_microbatches: int,
                   interleave: int = 1) -> PipelineSchedule:
    """Materialize a schedule's tick table by greedy ASAP placement of
    the per-stage work queues under a one-tick transfer latency (an
    action at tick t may consume values produced at tick <= t-1)."""
    check_schedule(kind, num_stages, num_microbatches, interleave)
    S, M, V = num_stages, num_microbatches, interleave
    orders = _stage_orders(kind, S, M, V)
    done_tick: Dict[Action, int] = {}
    ptr = [0] * S
    ticks: List[List[Optional[Action]]] = []
    limit = 4 * (S * V + M) * (V + 1) + 16  # generous deadlock guard
    while any(ptr[s] < len(orders[s]) for s in range(S)):
        t = len(ticks)
        if t > limit:
            raise ScheduleError(
                f"schedule {kind} S={S} M={M} V={V} failed to make "
                f"progress (deadlocked work queue: a bug in the queue order)")
        row: List[Optional[Action]] = [None] * S
        for s in range(S):
            if ptr[s] >= len(orders[s]):
                continue
            a = orders[s][ptr[s]]
            if all(done_tick.get(d, t) < t for d in _deps(a, S, V)):
                row[s] = a
        for s, a in enumerate(row):
            if a is not None:
                done_tick[a] = t
                ptr[s] += 1
        ticks.append(row)
    sched = PipelineSchedule(kind, S, M, V, ticks)
    sched.validate_buffers()  # engines rely on the 1-slot discipline
    return sched


def schedule_summary(sched: PipelineSchedule,
                     bwd_ratio: float = 2.0) -> Dict:
    """The JSON-able record profiling/fit_profile and pipe_bench embed."""
    return {
        "schedule": sched.kind,
        "num_stages": sched.num_stages,
        "num_microbatches": sched.num_microbatches,
        "interleave": sched.interleave,
        "ticks": sched.num_ticks,
        "bubble_fraction": round(sched.bubble_fraction(bwd_ratio), 4),
        "peak_live_microbatches": [
            sched.peak_live(s) for s in range(sched.num_stages)],
        "host_dispatches_per_step": sched.host_dispatches(),
        "transfer_edges_per_step": sched.transfer_edges(),
    }


def render_timeline(sched: PipelineSchedule) -> List[str]:
    """Human-readable per-stage timeline (one string per stage), e.g.
    ``s0 |F0|F1|B0|F2|B1|..``. Used by --profiling prints and tests."""
    out = []
    for s in range(sched.num_stages):
        cells = []
        for row in sched.ticks:
            a = row[s]
            cells.append(".." if a is None else f"{a.kind}{a.mb}")
        out.append(f"s{s} |" + "|".join(cells) + "|")
    return out
