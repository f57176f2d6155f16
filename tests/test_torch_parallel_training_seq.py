"""Sequence-parallel training: the reference Transformer on {data: 2,
seq: 2} with ``seq_mode`` "ring" and then "a2a", three SGD train steps
from the same params and global batches in one process group of 4 gloo
ranks, held against the JAX package over the same mesh and against the
one-rank port, at the tolerances of ``test_torch_parallel_training.py``
(whose helpers these runs use). Both modes share one process group for
the run, whichever xdist worker asks first."""

import pytest

import test_torch_parallel_training as base
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)
from _torch_shared import run_once


@pytest.mark.parametrize("name", base.SEQ_RUNS)
def test_ring_and_a2a_match_jax_and_one_rank(name, tmp_path_factory):
    base.check_run(name, lambda: run_once(tmp_path_factory, "parallel_seq_ranks",
                                          lambda: base.spawn_runs(list(base.SEQ_RUNS), 4))[name])
