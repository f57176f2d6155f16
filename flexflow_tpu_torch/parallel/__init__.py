"""Parallelism over ``torch.distributed``: the process group and its
launcher (``distributed``), the collectives and their autograd pairs
(``collectives``), the mesh step's gradient buckets (``grad_buckets``),
sequence-parallel attention (``ring_attention``), the
pipeline (``schedule``, ``pipeline``, ``pipeline_compiled``), multi-process
runs (``multihost``) and their supervisor (``launch``)."""
