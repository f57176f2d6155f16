"""The device mesh: named axes over the ranks of a process group.

PyTorch counterpart of ``flexflow_tpu/core/machine.py``. The JAX package
names a grid of devices in one process (``jax.sharding.Mesh``) and lets
XLA's SPMD partitioner place the collectives. The port runs one process
per rank (SPMD over ``torch.distributed``): :class:`Mesh` names the grid
of ranks, in the order ``make_mesh``'s ``reshape(sizes)`` gives the JAX
devices, and holds one process group for every set of axes, so a
collective over the ``data`` axis (or over ``data`` and ``seq`` together)
runs among the ranks that differ only in those coordinates.

Every process of the group calls :func:`make_mesh` with the same shape:
creating a sub-group is collective over the whole group.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

# canonical axis names (the strategy vocabulary)
DATA_AXIS = "data"      # sample/batch parallelism
MODEL_AXIS = "model"    # parameter/attribute (tensor) parallelism
PIPE_AXIS = "pipe"      # pipeline parallelism
SEQ_AXIS = "seq"        # sequence/context parallelism
EXPERT_AXIS = "expert"  # expert parallelism

LAUNCH_HINT = ("start one process per rank: torchrun --nproc-per-node N, or "
               "flexflow_tpu_torch.parallel.distributed.spawn(fn, N)")


@dataclasses.dataclass(frozen=True)
class MachineView:
    """A named nd-view of devices: ``axes`` maps mesh-axis name to degree,
    degree-1 axes left out."""

    axes: Tuple[Tuple[str, int], ...]

    @staticmethod
    def from_dict(d: Dict[str, int]) -> "MachineView":
        return MachineView(tuple((k, int(v)) for k, v in d.items() if v > 1))

    @property
    def num_devices(self) -> int:
        n = 1
        for _, deg in self.axes:
            n *= deg
        return n

    def degree(self, axis: str) -> int:
        for a, deg in self.axes:
            if a == axis:
                return deg
        return 1

    def __str__(self) -> str:
        return "MachineView(" + ",".join(f"{a}={d}" for a, d in self.axes) + ")"


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks that differ only along ``axes``: ``pg`` is their process
    group, ``ranks`` their global ranks in row-major order of the axes'
    coordinates and ``index`` this rank's place among them."""

    axes: Tuple[str, ...]
    pg: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps axis name to degree, in insertion order; the grid of
    global ranks is ``arange(world).reshape(sizes)``, so this rank's
    coordinate along each axis is its index in that grid."""

    def __init__(self, shape: Dict[str, int], rank: int, groups: Dict[Tuple[str, ...], Group]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self.grid = np.arange(self.size).reshape([self.shape[a] for a in self.axis_names])
        where = np.argwhere(self.grid == rank)[0]
        self.coords = {a: int(c) for a, c in zip(self.axis_names, where)}
        self._groups = groups

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def degree(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis else 1

    def group(self, axes: Sequence[str]) -> Group:
        """The group of the ranks that differ only along ``axes`` (any
        order; degree-1 axes are dropped)."""
        key = tuple(a for a in self.axis_names if a in set(axes) and self.shape[a] > 1)
        if not key:
            raise ValueError(f"no axis of {tuple(axes)} has a degree above 1 in {self.shape}")
        return self._groups[key]

    def local_slices(self, pshape) -> Tuple[slice, ...]:
        """This rank's block of a tensor laid out as ``pshape`` (a
        ``ParallelTensorShape``): one slice per dim."""
        out = []
        for d in pshape.dims:
            if not d.is_partitioned:
                out.append(slice(None))
                continue
            if d.degree != self.degree(d.axis):
                raise ValueError(f"dim {d} has degree {d.degree}; mesh axis {d.axis!r} has "
                                 f"{self.degree(d.axis)}")
            chunk = d.size // d.degree
            c = self.coords[d.axis]
            out.append(slice(c * chunk, (c + 1) * chunk))
        return tuple(out)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def mesh_axis_sizes(mesh: Optional[Mesh]) -> Dict[str, int]:
    return dict(mesh.shape) if mesh is not None else {}


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one. A process started by torchrun (``WORLD_SIZE`` above 1 in the
    environment) joins its group here."""
    import torch.distributed as dist

    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from ..parallel.distributed import init_process_group

        init_process_group()
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# meshes built in this process, by (group, shape): every rank builds the
# same sequence, so a second compile over one shape reuses the groups
_meshes: Dict[Tuple[Any, Tuple[Tuple[str, int], ...]], Mesh] = {}


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None) -> Optional[Mesh]:
    """The mesh over every rank of the process group.

    ``mesh_shape`` (``{"data": 2, "model": 2}``) maps axis name to degree
    in insertion order; without one, a 1-D ``data`` mesh over every rank,
    as the JAX package's default. Its product must equal the group's world
    size. None when there is one rank: a one-device model needs no mesh."""
    rank, world = _world()
    if not mesh_shape:
        mesh_shape = {DATA_AXIS: world}
    sizes = {str(k): int(v) for k, v in mesh_shape.items()}
    if any(v < 1 for v in sizes.values()):
        raise ValueError(f"mesh shape {mesh_shape}: degrees must be at least 1")
    n = int(np.prod(list(sizes.values()), dtype=np.int64))
    if n != world:
        raise ValueError(
            f"mesh shape {mesh_shape} needs {n} ranks; this process group has {world}: "
            f"{LAUNCH_HINT} with N = {n}")
    if n == 1:
        return None
    import torch.distributed as dist

    key = (id(dist.group.WORLD), tuple(sizes.items()))
    if key in _meshes:
        return _meshes[key]
    names = tuple(sizes)
    grid = np.arange(n).reshape([sizes[a] for a in names])
    groups: Dict[Tuple[str, ...], Group] = {}
    live = [a for a in names if sizes[a] > 1]
    for r in range(1, len(live) + 1):
        for axes in itertools.combinations(live, r):
            # move the group's axes last: each row of the flattened rest
            # is one group, its ranks in row-major order of those axes
            order = [names.index(a) for a in names if a not in axes] + \
                    [names.index(a) for a in axes]
            rows = grid.transpose(order).reshape(-1, int(np.prod([sizes[a] for a in axes])))
            for row in rows:
                ranks = tuple(int(x) for x in row)
                pg = dist.group.WORLD if len(ranks) == n else dist.new_group(list(ranks))
                if rank in ranks:
                    groups[axes] = Group(axes, pg, ranks, ranks.index(rank))
    _meshes[key] = Mesh(sizes, rank, groups)
    return _meshes[key]
