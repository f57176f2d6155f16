"""The buckets of a mesh training step's gradient all-reduce.

One rule, read by the step that issues the buckets
(``runtime/compiler.py``) and by the simulator that prices them
(``sim/cost_model.py`` ``OpCostModel.grad_sync_latency``), so the two
cut the same buckets. A weight's gradient is all-reduced over the mesh
axes that partition its op's output and not the weight: a replicated
computation's gradients already agree, and an axis that cuts the weight
holds another block of it. Each (set of axes, dtype) is one collective's
payload; its weights, in reverse op order (the order the backward
produces their gradients), fill buckets of ``GRAD_BUCKET_BYTES``, as
DDP's buckets do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# a bucket's size: DDP's default
GRAD_BUCKET_BYTES = 25 << 20

Name = Tuple[str, str]  # (op name, weight name)
Bucket = Tuple[tuple, List[Name], int]  # ((axes, dtype), names, bytes)


def sync_axes(op) -> Dict[str, Tuple[str, ...]]:
    """Each weight of ``op`` whose gradient is all-reduced, with the axes
    (sorted) it is all-reduced over."""
    out_axes = set(op.output_shapes[0].partition_axes) if op.output_shapes else set()
    got = {}
    for w_name, ps in op.weight_shapes.items():
        axes = tuple(sorted(out_axes - set(ps.partition_axes)))
        if axes:
            got[w_name] = axes
    return got


def cut_buckets(entries: Sequence[Tuple[tuple, Name, int]],
                bucket_bytes: Optional[int] = None) -> List[Bucket]:
    """Cut gradients into buckets. ``entries``: (key, name, bytes) in the
    order the backward produces the gradients. Each key's gradients fill
    buckets of ``bucket_bytes`` (default ``GRAD_BUCKET_BYTES``), a bucket
    closing once it holds that many. The buckets come back as (key,
    names, bytes) in the order they complete, by their last gradient's
    place: the order every rank issues them in."""
    size = GRAD_BUCKET_BYTES if bucket_bytes is None else bucket_bytes
    filling: Dict[tuple, list] = {}
    done = []
    for pos, (key, name, nbytes) in enumerate(entries):
        b = filling.setdefault(key, [key, [], 0, pos])
        b[1].append(name)
        b[2] += nbytes
        b[3] = pos
        if b[2] >= size:
            done.append(filling.pop(key))
    done = sorted(done + list(filling.values()), key=lambda b: b[3])
    return [(key, names, nbytes) for key, names, nbytes, _ in done]


def plan_grad_buckets(ops: Sequence, bucket_bytes: Optional[int] = None) -> List[Bucket]:
    """The buckets of ``ops``' gradients (:func:`cut_buckets`), each
    weight keyed by its axes (:func:`sync_axes`) and its dtype, with this
    rank's bytes of it."""
    entries = []
    for op in reversed(ops):
        for w_name, axes in sync_axes(op).items():
            ps = op.weight_shapes[w_name]
            n = 1
            for d in ps.dims:
                n *= d.size // d.degree
            entries.append(((axes, ps.dtype), (op.name, w_name), n * ps.dtype.itemsize()))
    return cut_buckets(entries, bucket_bytes)
