"""Sequence-parallel training: the reference Transformer on {data: 2,
seq: 2} with ``seq_mode`` "ring" and then "a2a", three SGD train steps
from the same params and global batches in one process group of 4 gloo
ranks, held against the JAX package over the same mesh and against the
one-rank port, at the tolerances of ``test_torch_parallel_training.py``
(whose helpers these runs use)."""

import test_torch_parallel_training as base
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)


def test_ring_and_a2a_match_jax_and_one_rank():
    runs = base.spawn_runs(list(base.SEQ_RUNS), 4)
    for name in base.SEQ_RUNS:
        base.check_run(name, runs[name])
