"""Torus topology, routing and contention-aware collective costs.

PyTorch counterpart of ``flexflow_tpu/sim/network.py``: the version-2
machine model. A mesh axis is an embedded set of rings on an N-dimensional
(wrapped) grid; collectives are lowered to explicit transfer sets, every
participant group of the axis at once, routed dimension-ordered (the
shorter way around each wrapped ring), and the busiest link bounds the
round time, which is what the closed-form ring formulas miss when an axis
is laid out with strides across the grid. The router is native
(``native/src/network_sim.cc``, built by ``native_bridge.py``); the
Python mirror serves under ``FLEXFLOW_TPU_NATIVE=off``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .machine_model import (
    MachineModel,
    MultiSliceMachineModel,
    SimpleMachineModel,
    ChipSpec,
)


@dataclasses.dataclass(frozen=True)
class TorusTopology:
    """An N-dimensional (optionally wrapped) chip grid.

    Chips are numbered row-major (last dim fastest), the order of the
    rank grid (``core/machine.py``).
    """

    dims: Tuple[int, ...]
    wrap: Tuple[bool, ...] = ()

    def __post_init__(self):
        if not self.wrap:
            object.__setattr__(self, "wrap", tuple(True for _ in self.dims))
        if len(self.wrap) != len(self.dims):
            raise ValueError("wrap/dims length mismatch")

    @property
    def num_nodes(self) -> int:
        return int(np.prod(self.dims))

    def coords(self, node: int) -> Tuple[int, ...]:
        return tuple(np.unravel_index(node, self.dims))

    def node(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.dims))


def route_transfers_py(
    topo: TorusTopology,
    src: Sequence[int],
    dst: Sequence[int],
    bytes_: Sequence[float],
    link_bandwidth: float,
    hop_latency: float,
) -> Tuple[float, float, int]:
    """Pure-Python mirror of native ``fftpu_route_transfers`` (the same
    dimension-ordered routing and per-directed-link byte accumulation),
    used under ``FLEXFLOW_TPU_NATIVE=off``."""
    if not (len(src) == len(dst) == len(bytes_)):
        raise ValueError(
            f"src/dst/bytes length mismatch: {len(src)}/{len(dst)}/{len(bytes_)}")
    ndims = len(topo.dims)
    dims = topo.dims
    # row-major strides, last dim fastest (matches the native router)
    strides = [1] * ndims
    for dd in range(ndims - 2, -1, -1):
        strides[dd] = strides[dd + 1] * dims[dd + 1]
    link_bytes: Dict[Tuple[int, int, int], float] = {}
    max_hops = 0
    for s, d, b in zip(src, dst, bytes_):
        if s == d or b <= 0:
            continue
        coord = [(s // strides[dd]) % dims[dd] for dd in range(ndims)]
        hops = 0
        for dim in range(ndims):
            want = (d // strides[dim]) % dims[dim]
            have = coord[dim]
            if want == have:
                continue
            n = dims[dim]
            fwd = (want - have) % n
            bwd = (have - want) % n
            if topo.wrap[dim]:
                use_fwd = fwd <= bwd
                steps = min(fwd, bwd)
            else:
                use_fwd = want > have
                steps = fwd if use_fwd else bwd
            for _ in range(steps):
                node = 0
                for dd in range(ndims):
                    node += coord[dd] * strides[dd]
                key = (node, dim, 1 if use_fwd else 0)
                link_bytes[key] = link_bytes.get(key, 0.0) + b
                coord[dim] = (coord[dim] + (1 if use_fwd else -1)) % n
                hops += 1
        max_hops = max(max_hops, hops)
    max_link = max(link_bytes.values(), default=0.0)
    return max_link / link_bandwidth + max_hops * hop_latency, max_link, max_hops


def route_transfers(
    topo: TorusTopology,
    src: Sequence[int],
    dst: Sequence[int],
    bytes_: Sequence[float],
    link_bandwidth: float,
    hop_latency: float,
) -> Tuple[float, float, int]:
    """Route a transfer set with the native router
    (``native/src/network_sim.cc``), or the Python one under
    ``FLEXFLOW_TPU_NATIVE=off``; a failed build raises."""
    from .. import native_bridge

    if native_bridge.native_disabled():
        return route_transfers_py(topo, src, dst, bytes_, link_bandwidth,
                                  hop_latency)
    return native_bridge.route_transfers(topo.dims, topo.wrap, src, dst, bytes_,
                                         link_bandwidth, hop_latency)


class NetworkedMachineModel(MachineModel):
    """Machine model whose collective costs come from routing explicit
    transfer sets over a torus, concurrently for every participant group
    of the axis (the version-2 machine-model files).

    ``axis_degrees``: ordered mesh axes (first = outermost), as the rank
    grid orders them. Mesh device i maps to torus chip i row-major unless
    ``device_order`` says otherwise.
    """

    def __init__(
        self,
        chip: ChipSpec,
        topology: TorusTopology,
        axis_degrees: Dict[str, int],
        device_order: Optional[Sequence[int]] = None,
        dcn_axes: Tuple[str, ...] = (),
    ):
        n_mesh = int(np.prod(list(axis_degrees.values()) or [1]))
        ici_n = n_mesh
        for a in dcn_axes:
            if a in axis_degrees:
                ici_n //= axis_degrees[a]
        if ici_n != topology.num_nodes:
            raise ValueError(
                f"mesh ICI size {ici_n} != topology nodes {topology.num_nodes}")
        self.chip = chip
        self.topology = topology
        self.axis_degrees = dict(axis_degrees)
        self.dcn_axes = tuple(dcn_axes)
        order = list(device_order) if device_order is not None else list(range(ici_n))
        if sorted(order) != list(range(ici_n)):
            raise ValueError("device_order must be a permutation of mesh devices")
        self._chip_of = order  # mesh device index -> torus chip id
        self._groups_cache: Dict[str, List[List[int]]] = {}
        # DCN costs share MultiSliceMachineModel's hose-model algebra; axes
        # this model doesn't know (a search probing other mesh shapes) fall
        # back to the closed-form ICI ring rather than mis-pricing as DCN
        self._dcn_helper = MultiSliceMachineModel(
            chip, axis_degrees, dcn_axes=self.dcn_axes or ("data_dcn",))
        self._ici_fallback = SimpleMachineModel(chip, self.num_devices())

    def num_devices(self) -> int:
        n = 1
        for d in self.axis_degrees.values():
            n *= d
        return n

    # ---- mesh-axis participant groups ------------------------------------
    def _axis_groups(self, axis: str) -> List[List[int]]:
        """All participant groups (torus chip ids, ring order) for an axis:
        mesh devices that differ only in the ``axis`` coordinate."""
        if axis in self._groups_cache:
            return self._groups_cache[axis]
        ici_axes = [(a, d) for a, d in self.axis_degrees.items()
                    if a not in self.dcn_axes]
        names = [a for a, _ in ici_axes]
        shape = [d for _, d in ici_axes]
        if axis not in names:
            raise KeyError(f"axis {axis!r} not in mesh {names}")
        ai = names.index(axis)
        grid = np.arange(int(np.prod(shape))).reshape(shape)
        moved = np.moveaxis(grid, ai, -1).reshape(-1, shape[ai])
        groups = [[self._chip_of[int(i)] for i in row] for row in moved]
        self._groups_cache[axis] = groups
        return groups

    # ---- transfer-set generators ------------------------------------------
    def _ring_round(self, axis: str, bytes_per_hop: float) -> float:
        """One round of a ring collective: every participant sends to its
        ring successor, in every group of the axis concurrently."""
        src, dst, b = [], [], []
        for g in self._axis_groups(axis):
            n = len(g)
            for i in range(n):
                src.append(g[i])
                dst.append(g[(i + 1) % n])
                b.append(bytes_per_hop)
        t, _, _ = route_transfers(self.topology, src, dst, b,
                                  self.chip.ici_link_bandwidth,
                                  self.chip.ici_latency)
        return t

    # ---- MachineModel interface -------------------------------------------
    def _fallback_for(self, axis: str, degree: int) -> Optional[MachineModel]:
        """Which closed-form model prices this (axis, degree), or None for
        the routed path. DCN axes ride the hose model; axes/degrees this
        topology doesn't describe (a search probing other mesh shapes) get
        the contention-free ICI ring formula instead of a mis-priced DCN."""
        if axis in self.dcn_axes:
            return self._dcn_helper
        if axis in self.axis_degrees and degree == self.axis_degrees[axis]:
            return None
        return self._ici_fallback

    def allreduce_time(self, bytes_per_device, degree, axis=""):
        if degree <= 1:
            return 0.0
        fb = self._fallback_for(axis, degree)
        if fb is not None:
            return fb.allreduce_time(bytes_per_device, degree, axis)
        # reduce-scatter + all-gather: 2*(n-1) rounds of shard-sized hops
        shard = bytes_per_device / degree
        return 2 * (degree - 1) * self._ring_round(axis, shard)

    def allgather_time(self, bytes_per_device, degree, axis=""):
        if degree <= 1:
            return 0.0
        fb = self._fallback_for(axis, degree)
        if fb is not None:
            return fb.allgather_time(bytes_per_device, degree, axis)
        return (degree - 1) * self._ring_round(axis, bytes_per_device)

    def reducescatter_time(self, bytes_per_device, degree, axis=""):
        if degree <= 1:
            return 0.0
        fb = self._fallback_for(axis, degree)
        if fb is not None:
            return fb.reducescatter_time(bytes_per_device, degree, axis)
        return (degree - 1) * self._ring_round(axis, bytes_per_device / degree)

    def alltoall_time(self, bytes_per_device, degree, axis=""):
        if degree <= 1:
            return 0.0
        fb = self._fallback_for(axis, degree)
        if fb is not None:
            return fb.alltoall_time(bytes_per_device, degree, axis)
        # full pairwise exchange, all groups at once, one routed shot
        src, dst, b = [], [], []
        for g in self._axis_groups(axis):
            n = len(g)
            per_pair = bytes_per_device / n
            for i in range(n):
                for j in range(n):
                    if i != j:
                        src.append(g[i])
                        dst.append(g[j])
                        b.append(per_pair)
        t, _, _ = route_transfers(self.topology, src, dst, b,
                                  self.chip.ici_link_bandwidth,
                                  self.chip.ici_latency)
        return t

    def permute_time(self, bytes_per_device, degree, axis=""):
        if degree <= 1:
            return 0.0
        fb = self._fallback_for(axis, degree)
        if fb is not None:
            return fb.permute_time(bytes_per_device, degree, axis)
        return self._ring_round(axis, bytes_per_device)

    # ---- diagnostics -------------------------------------------------------
    def link_utilization(self, axis: str, bytes_per_device: float):
        """(time, max_link_bytes, max_hops) for one all-gather round on an
        axis — the tool for judging a mesh→torus layout."""
        src, dst, b = [], [], []
        for g in self._axis_groups(axis):
            n = len(g)
            for i in range(n):
                src.append(g[i])
                dst.append(g[(i + 1) % n])
                b.append(bytes_per_device)
        return route_transfers(self.topology, src, dst, b,
                               self.chip.ici_link_bandwidth,
                               self.chip.ici_latency)


def default_topology_for(n_devices: int) -> TorusTopology:
    """Factor a device count into the squarest 2-D (wrapped) torus, the
    JAX package's default topology for a version-2 file without one."""
    best = (1, n_devices)
    for a in range(1, int(math.isqrt(n_devices)) + 1):
        if n_devices % a == 0:
            best = (a, n_devices // a)
    if best[0] == 1:
        return TorusTopology((n_devices,), (n_devices > 2,))
    return TorusTopology(best)
