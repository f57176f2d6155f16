"""Parallelism over ``torch.distributed``: the process group and its
launcher (``distributed``), the collectives and their autograd pairs
(``collectives``) and sequence-parallel attention (``ring_attention``)."""
