"""The pipeline schedule IR (``parallel/schedule.py``), the port's own copy
of the JAX module, held against it: every schedule's tick table over a grid
of (stages, microbatches, interleave), tick for tick, and every statistic
read off it; ``check_schedule``'s errors; and the single-call engine's
static slot tables (``_build_tables``) against the JAX engine's. One
process, no ranks."""

import itertools

import numpy as np
import pytest

from flexflow_tpu.parallel import schedule as js
from flexflow_tpu.parallel.pipeline_compiled import _build_tables as jbuild_tables
from flexflow_tpu_torch.parallel import schedule as ts
from flexflow_tpu_torch.parallel.pipeline_compiled import _build_tables
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

GRID = [(kind, S, M, V) for kind, S, M in itertools.product(
    ("gpipe", "1f1b", "interleaved"), (2, 3, 4), (1, 2, 4, 7))
    for V in ((2, 3) if kind == "interleaved" else (1,))]


def _ticks(sched):
    return [[None if a is None else (a.kind, a.mb, a.chunk) for a in row]
            for row in sched.ticks]


@pytest.mark.parametrize("kind, S, M, V", GRID, ids=lambda v: str(v))
def test_schedule_matches_jax_tick_for_tick(kind, S, M, V):
    got, want = ts.build_schedule(kind, S, M, V), js.build_schedule(kind, S, M, V)
    assert _ticks(got) == _ticks(want)
    assert got.num_ticks == want.num_ticks and got.work_slots() == want.work_slots()
    for r in (1.0, 2.0, 3.0):
        assert got.bubble_fraction(r) == want.bubble_fraction(r)
    assert got.step_ticks_cost(1.0, 2.5) == want.step_ticks_cost(1.0, 2.5)
    assert [got.peak_live(s) for s in range(S)] == [want.peak_live(s) for s in range(S)]
    assert got.peak_live_total() == want.peak_live_total()
    assert got.host_dispatches() == want.host_dispatches()
    assert got.transfer_edges() == want.transfer_edges()
    assert got.validate_buffers() == want.validate_buffers()
    assert ts.render_timeline(got) == js.render_timeline(want)
    assert ts.schedule_summary(got) == js.schedule_summary(want)
    # the single-call engine's static tables
    tg, tw = _build_tables(got), jbuild_tables(want)
    assert set(tg) == set(tw)
    for k in tg:
        assert np.array_equal(np.asarray(tg[k]), np.asarray(tw[k])), k


def test_every_stage_runs_its_backwards_in_microbatch_order():
    """The gradient-accumulation order the engines' bitwise agreement rests
    on: under every schedule each chunk's backwards come in microbatch
    order."""
    for kind, S, M, V in GRID:
        sched = ts.build_schedule(kind, S, M, V)
        for s in range(S):
            by_chunk = {}
            for a in sched.actions(s):
                if a.kind in ("B", "FB"):
                    by_chunk.setdefault(a.chunk, []).append(a.mb)
            assert all(mbs == list(range(M)) for mbs in by_chunk.values())


@pytest.mark.parametrize("args", [
    ("zigzag", 2, 4, 1), ("gpipe", 1, 4, 1), ("1f1b", 2, 0, 1), ("1f1b", 2, 4, 0),
    ("1f1b", 2, 4, 2), ("interleaved", 2, 4, 1)], ids=lambda v: str(v))
def test_check_schedule_errors_match_jax(args):
    with pytest.raises(js.ScheduleError) as want:
        js.check_schedule(*args)
    with pytest.raises(ts.ScheduleError) as got:
        ts.check_schedule(*args)
    assert str(got.value) == str(want.value)
    with pytest.raises(ts.ScheduleError):
        ts.build_schedule(*args)
    assert issubclass(ts.ScheduleError, ValueError)
