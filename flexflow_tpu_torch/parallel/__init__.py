"""Parallelism over ``torch.distributed``: the process group and its
launcher (``distributed``), the collectives and their autograd pairs
(``collectives``), sequence-parallel attention (``ring_attention``), the
pipeline (``schedule``, ``pipeline``, ``pipeline_compiled``), multi-process
runs (``multihost``) and their supervisor (``launch``)."""
