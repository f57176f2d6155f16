"""Machine models: a chip and its interconnect, priced analytically.

PyTorch counterpart of ``flexflow_tpu/sim/machine_model.py``, with the
same pricing algebra: a **chip spec** (peak matmul rate, memory bandwidth
and capacity, fitted efficiencies), an **intra-node fabric** priced by the
ring formulas (the spec's ``ici_*`` fields: NVLink through NVSwitch on an
H100 node) and a **cross-process fabric** (the ``dcn_*`` fields: one NIC
a GPU). An all-reduce of S bytes over an axis of n devices moves
``2 (n-1)/n · S`` bytes through each device's link.

The port carries no TPU figures: the JAX package's ``v4``/``v5e``/``v5p``/
``v6e`` presets are not here, and a machine-model file that names one
raises. ``test`` (round numbers for hermetic tests) and ``cpu-host`` (a
mesh of ranks time-slicing one host) are the JAX package's, unchanged.
``h100`` and ``h100-bf16`` take their peaks from the H100 SXM data sheet
and their efficiencies and per-step overhead from ``sim/calibrate.py`` on
the card; :func:`detect_machine_model` picks one by the compute dtype,
since bf16's tensor-core peak is 15 times the f32 CUDA-core peak the
port's f32 products run at (no TF32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak numbers of one device. The field names are the JAX package's
    (``TPUChipSpec``), so its machine-model files load unchanged;
    ``peak_bf16_flops`` is the dense matmul peak at the dtype the spec
    prices (the ``h100`` preset prices f32), ``ici_*`` the intra-node
    fabric and ``dcn_*`` the cross-process one."""

    name: str
    peak_bf16_flops: float          # FLOP/s of dense matmuls
    hbm_bandwidth: float            # bytes/s
    hbm_capacity: float             # bytes
    ici_link_bandwidth: float       # bytes/s per link per direction
    ici_num_links: int
    ici_latency: float = 1e-6       # per-hop seconds
    dcn_bandwidth: float = 25e9     # bytes/s per device across processes
    dcn_latency: float = 10e-6
    # achievable fractions of peak (fitted by sim/calibrate.py)
    mxu_efficiency: float = 0.55
    hbm_efficiency: float = 0.8
    kernel_overhead: float = 2e-6   # fixed cost of one op
    # fixed cost of one step (launches the roofline does not see)
    step_overhead: float = 0.0


# The H100 fits, one a compute dtype: sim/calibrate.py ``calibrate()`` on
# an NVIDIA H100 80GB HBM3 at a power limit of 700.00 W (f32: scale 0.8013
# of the neutral chip; bf16: scale 5.811, the step bound by its launches)
_H100_F32_FIT = dict(mxu_efficiency=0.6864, hbm_efficiency=0.9984, step_overhead=4.311e-3)
_H100_BF16_FIT = dict(mxu_efficiency=0.09464, hbm_efficiency=0.1377, step_overhead=5.513e-3)
# gloo's all-reduce among ranks that share one card, staged through the
# host: (ranks on the card, ranks in each all-reduce) -> (payload bytes a
# second, fixed seconds of one call), every group of the card's ranks
# all-reducing at once; sim/calibrate.py ``measure_staging_rate`` on the
# same card (1 and 64 MiB; two-rank readings part by up to 30 % between
# machines: 0.43-0.63 GB/s)
SHARED_CARD_STAGING: Dict[Tuple[int, int], Tuple[float, float]] = {
    (2, 2): (4.2556e8, 9.474e-4),
    (4, 2): (3.5425e8, 1.9238e-3),
    (4, 4): (2.8716e8, 6.0857e-3),
}

CHIP_PRESETS: Dict[str, ChipSpec] = {
    # hermetic-test chip: round numbers so expected costs are exact
    "test": ChipSpec(
        "test", 1e12, 1e11, 8 << 30, 1e10, 4,
        ici_latency=1e-6, dcn_bandwidth=1e9, dcn_latency=1e-5,
        mxu_efficiency=1.0, hbm_efficiency=1.0, kernel_overhead=0.0,
    ),
    # ranks time-slicing one host (used with shared_host=True): sharding
    # buys no compute and collectives are memcpys
    "cpu-host": ChipSpec(
        "cpu-host", 2e11, 2e10, 16 << 30, 5e9, 1,
        ici_latency=5e-6, dcn_bandwidth=1e9, dcn_latency=5e-5,
        mxu_efficiency=0.5, hbm_efficiency=0.5, kernel_overhead=5e-6,
        step_overhead=5e-3,
    ),
    # H100 SXM data sheet: 67 TFLOP/s f32 (CUDA cores; the port's f32
    # products run without TF32), 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
    # 80 GB; NVLink 4 at 450 GB/s a direction over 18 links, flat through
    # NVSwitch, so the model sees one 450 GB/s port a direction a GPU; one
    # 400 Gb/s NDR port a GPU (50 GB/s) across processes. The latencies
    # are the spec's defaults, not data-sheet figures.
    "h100": ChipSpec("h100", 67e12, 3.35e12, 80e9, 450e9, 1,
                     dcn_bandwidth=50e9, **_H100_F32_FIT),
    "h100-bf16": ChipSpec("h100-bf16", 989e12, 3.35e12, 80e9, 450e9, 1,
                          dcn_bandwidth=50e9, **_H100_BF16_FIT),
}

# the JAX package's TPU presets, refused by name
TPU_PRESETS = ("v4", "v5e", "v5p", "v6e")


def chip_preset(name: str) -> ChipSpec:
    """The preset ``name``; a TPU preset or an unknown name raises naming
    the presets the port has."""
    if name in CHIP_PRESETS:
        return CHIP_PRESETS[name]
    what = "a TPU preset the port does not carry" if name in TPU_PRESETS else "unknown"
    raise ValueError(
        f"chip preset {name!r} is {what}; the port has {sorted(CHIP_PRESETS)}, "
        "or give the chip's numbers explicitly in the machine-model file")


def h100_chip(compute_dtype: Optional[str] = None) -> ChipSpec:
    """The H100 preset fitted for ``compute_dtype`` (FFConfig's)."""
    bf16 = compute_dtype in ("bfloat16", "bf16")
    return CHIP_PRESETS["h100-bf16" if bf16 else "h100"]


class MachineModel:
    """Interface: collective and point-to-point costs over a named mesh.
    Axis degrees come from the mesh a strategy targets; the model decides
    which fabric each axis rides."""

    chip: ChipSpec

    def num_devices(self) -> int:
        raise NotImplementedError

    def effective_parallelism(self, parts: int) -> float:
        """Wall-clock compute speedup from splitting work ``parts`` ways:
        ``parts`` on devices that each run their shard, 1.0 where the
        shards time-slice one resource."""
        return float(max(parts, 1))

    def sharded_compute_penalty(self, non_data_axes) -> float:
        """Compute multiplier for ops sharded beyond the batch dim."""
        return 1.0

    def serialization_factor(self) -> float:
        """How many device programs' work funnels through one execution
        resource: 1 on real devices, the device count where they share
        one (a replicated op is then charged for every replica)."""
        return 1.0

    def sharded_tiny_op_latency(self) -> float:
        """Fixed per-direction cost of a small sharded op."""
        return 0.0

    def gather_inefficiency(self) -> float:
        """Embedding gather/scatter multiplier."""
        return 1.0

    def combine_sync_axes(self) -> bool:
        """Whether the gradient sync of a weight replicated over several
        axes is priced as one all-reduce over their combined degree (a
        shared resource) or per axis (each axis on its own fabric)."""
        return False

    # every cost takes per-participant payload bytes and the axis degree
    def allreduce_time(self, bytes_per_device: float, degree: int, axis: str = "") -> float:
        raise NotImplementedError

    def allgather_time(self, bytes_per_device: float, degree: int, axis: str = "") -> float:
        raise NotImplementedError

    def reducescatter_time(self, bytes_per_device: float, degree: int, axis: str = "") -> float:
        raise NotImplementedError

    def alltoall_time(self, bytes_per_device: float, degree: int, axis: str = "") -> float:
        raise NotImplementedError

    def permute_time(self, bytes_per_device: float, degree: int, axis: str = "") -> float:
        raise NotImplementedError


class SimpleMachineModel(MachineModel):
    """Every mesh axis rides the intra-node fabric at the same per-link
    bandwidth. ``shared_host``: the ranks time-slice one host (the
    ``cpu-host`` chip), with the JAX package's fitted penalties for that
    platform."""

    def __init__(self, chip: Optional[ChipSpec] = None,
                 n_devices: int = 1, shared_host: bool = False):
        self.chip = chip if chip is not None else CHIP_PRESETS["h100"]
        self._n = n_devices
        self.shared_host = shared_host

    def num_devices(self) -> int:
        return self._n

    def effective_parallelism(self, parts: int) -> float:
        if self.shared_host:
            return 1.0
        return float(max(parts, 1))

    def sharded_compute_penalty(self, non_data_axes) -> float:
        """Shared host: model/seq-sharded ops ran ~1.6x their
        batch-sharded cost on the JAX package's one-core virtual mesh, the
        expert-parallel family another ~4.5x; real devices 1.0."""
        if not self.shared_host or not non_data_axes:
            return 1.0
        penalty = 1.6
        if "expert" in non_data_axes:
            penalty *= 4.5
        return penalty

    def serialization_factor(self) -> float:
        return float(self._n) if self.shared_host else 1.0

    def sharded_tiny_op_latency(self) -> float:
        return 5e-4 if self.shared_host else 0.0

    def gather_inefficiency(self) -> float:
        return 3.0 if self.shared_host else 1.0

    def combine_sync_axes(self) -> bool:
        return self.shared_host

    # ring formulas; links are bidirectional, so a ring all-gather uses
    # both directions: effective per-link bandwidth x2
    def _serial(self, degree: int) -> float:
        """Shared resource: the ring formulas assume ``degree`` links
        transferring at once; one memory system serializes them."""
        return float(degree) if self.shared_host else 1.0

    def _bw(self, axis: str) -> float:
        return self.chip.ici_link_bandwidth * 2.0

    def _bw_unidir(self, axis: str) -> float:
        """One-direction bandwidth (a permute shifts data one way only)."""
        return self._bw(axis) / 2.0

    def _lat(self, axis: str) -> float:
        return self.chip.ici_latency

    def allgather_time(self, bytes_per_device, degree, axis=""):
        if degree <= 1:
            return 0.0
        return self._serial(degree) * (degree - 1) * (
            bytes_per_device / self._bw(axis) + self._lat(axis))

    def reducescatter_time(self, bytes_per_device, degree, axis=""):
        if degree <= 1:
            return 0.0
        shard = bytes_per_device / degree
        return self._serial(degree) * (degree - 1) * (
            shard / self._bw(axis) + self._lat(axis))

    def allreduce_time(self, bytes_per_device, degree, axis=""):
        # reduce-scatter + all-gather of the scattered shard
        if degree <= 1:
            return 0.0
        shard = bytes_per_device / degree
        return self._serial(degree) * 2 * (degree - 1) * (
            shard / self._bw(axis) + self._lat(axis))

    def alltoall_time(self, bytes_per_device, degree, axis=""):
        if degree <= 1:
            return 0.0
        vol = bytes_per_device * (degree - 1) / degree
        return (self._serial(degree) * vol / (2.0 * self._bw(axis))
                + self._lat(axis) * degree / 2)

    def permute_time(self, bytes_per_device, degree, axis=""):
        if degree <= 1:
            return 0.0
        return (self._serial(degree) * bytes_per_device / self._bw_unidir(axis)
                + self._lat(axis))


class SharedCardMachineModel(SimpleMachineModel):
    """More ranks than cards: the ranks share one card over gloo (every
    mesh run in ``chip_smoke.py``). Their kernels serialize on the card
    (``shared_host``'s serialization, without the CPU platform's fitted
    penalties), and every collective is staged through the host, priced
    from all-reduces measured on the card (``staging``: (ranks on the
    card, group size) -> (payload bytes a second, seconds a call)). Such a
    reading already holds the host's serialization of every group of the
    card's ranks, so no ring factor or degree multiplies it: an
    all-reduce of S bytes a rank over groups of d prices at ``S / rate +
    latency``. The other collectives price as the all-reduce that moves
    as many bytes through each rank's ring link (a ring all-reduce of P
    moves ``2 (d-1)/d · P``). A layout not measured scales the nearest
    reading's time a byte by the bytes the host then moves (ranks ×
    ``(d-1)/d``) and its latency by the ring's steps."""

    def __init__(self, chip: ChipSpec, n_devices: int,
                 staging: Optional[Dict[Tuple[int, int], Tuple[float, float]]] = None):
        staging = dict(SHARED_CARD_STAGING if staging is None else staging)
        rate2, lat2 = staging.get((2, 2), next(iter(staging.values())))
        # the chip's fabric fields keep a two-rank reading for the pipeline
        # model's boundary transfers (simulator.pipeline_schedule_cost)
        staged = dataclasses.replace(
            chip, name=f"{chip.name}-shared", ici_link_bandwidth=rate2,
            ici_latency=lat2 / 4.0)
        super().__init__(staged, n_devices, shared_host=True)
        self.staging = tuple(sorted((n, d, r, lat) for (n, d), (r, lat) in staging.items()))

    def sharded_compute_penalty(self, non_data_axes) -> float:
        return 1.0

    def sharded_tiny_op_latency(self) -> float:
        return 0.0

    def gather_inefficiency(self) -> float:
        return 1.0

    # the port's step all-reduces gradients as runtime/compiler.py
    # sync_grads does (OpCostModel reads this)
    port_grad_sync = True

    def _staging_at(self, degree: int) -> Tuple[float, float]:
        """(seconds a payload byte, seconds a call) of an all-reduce over
        groups of ``degree`` of this card's ranks."""
        n = self._n
        ring = lambda d: (d - 1) / d  # noqa: E731
        n0, d0, rate, lat = min(self.staging, key=lambda e: (
            abs(math.log2(e[0] / n)) + abs(math.log2(e[1] / degree)), e[0], e[1]))
        return (n * ring(degree)) / (n0 * ring(d0)) / rate, lat * (degree - 1) / (d0 - 1)

    def staged_allreduce_time(self, payload: float, degree: int) -> float:
        """Seconds of an all-reduce of ``payload`` bytes a rank over groups
        of ``degree`` of this card's ranks."""
        if degree <= 1:
            return 0.0
        per_byte, lat = self._staging_at(degree)
        return payload * per_byte + lat

    def coalesced_allreduce_time(self, payload: float, degree: int) -> float:
        """``payload``'s share of a coalesced all-reduce (one flat buffer
        for many tensors, as the port's gradient sync): its bytes, the
        call's latency paid once a step for all of them and left out."""
        return payload * self._staging_at(degree)[0] if degree > 1 else 0.0

    def allreduce_time(self, bytes_per_device, degree, axis=""):
        return self.staged_allreduce_time(bytes_per_device, degree)

    def reducescatter_time(self, bytes_per_device, degree, axis=""):
        # the port has no reduce-scatter: partial sums are all-reduced
        return self.staged_allreduce_time(bytes_per_device, degree)

    def allgather_time(self, bytes_per_device, degree, axis=""):
        # (d-1) S through each rank's link
        return self.staged_allreduce_time(bytes_per_device * degree / 2.0, degree)

    def alltoall_time(self, bytes_per_device, degree, axis=""):
        # (d-1)/d S through each rank's link
        return self.staged_allreduce_time(bytes_per_device / 2.0, degree)

    def permute_time(self, bytes_per_device, degree, axis=""):
        # S through each rank's link
        if degree <= 1:
            return 0.0
        return self.staged_allreduce_time(bytes_per_device * degree / (2.0 * (degree - 1)),
                                          degree)


class TorusMachineModel(SimpleMachineModel):
    """Mesh axes assigned to fabric dimensions: an axis folded over k
    links gets k times the link bandwidth (``axis_links``)."""

    def __init__(
        self,
        chip: ChipSpec,
        axis_degrees: Dict[str, int],
        axis_links: Optional[Dict[str, int]] = None,
        wraparound: bool = True,
    ):
        n = 1
        for d in axis_degrees.values():
            n *= d
        super().__init__(chip, n)
        self.axis_degrees = dict(axis_degrees)
        self.axis_links = dict(axis_links or {})
        self.wraparound = wraparound

    def _bw(self, axis: str) -> float:
        links = self.axis_links.get(axis, 1)
        dirs = 2.0 if self.wraparound else 1.0
        return self.chip.ici_link_bandwidth * links * dirs


class MultiSliceMachineModel(TorusMachineModel):
    """The axes in ``dcn_axes`` (usually the outermost data axis) cross
    processes and ride the cross-process fabric; the rest stay inside a
    node."""

    def __init__(self, chip, axis_degrees, dcn_axes: Tuple[str, ...] = ("data_dcn",), **kw):
        super().__init__(chip, axis_degrees, **kw)
        self.dcn_axes = tuple(dcn_axes)

    def _bw(self, axis: str) -> float:
        if axis in self.dcn_axes:
            return self.chip.dcn_bandwidth
        return super()._bw(axis)

    def _bw_unidir(self, axis: str) -> float:
        if axis in self.dcn_axes:
            return self.chip.dcn_bandwidth
        return super()._bw_unidir(axis)

    def _lat(self, axis: str) -> float:
        if axis in self.dcn_axes:
            return self.chip.dcn_latency
        return super()._lat(axis)


def load_machine_model(path: str) -> MachineModel:
    """A machine model from a JSON file, the JAX package's schema::

        {
          "version": "simple" | "torus" | "multislice" | "networked",
          "chip": "h100" | {"name": ..., "peak_bf16_flops": ..., ...},
          "num_devices": 8,                  # simple only
          "axis_degrees": {"data": 4, "model": 2},   # torus/multislice/networked
          "axis_links": {"data": 2},         # optional, torus/multislice
          "wraparound": true,                # optional
          "dcn_axes": ["data_dcn"],          # multislice/networked
          "topology": [4, 2],                # networked: torus chip grid
          "topology_wrap": [true, true],     # optional
          "device_order": [0, 1, ...]        # optional mesh->chip permutation
        }

    A chip named by a TPU preset raises; one given by its numbers loads.
    Every config-shaped failure raises ``ValueError`` naming the file."""
    import json

    with open(path) as f:
        cfg = json.load(f)
    try:
        return machine_model_from_config(cfg)
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"{type(e).__name__}: {e} (from {path})") from e


def machine_model_from_config(cfg: Dict) -> MachineModel:
    """A machine model from an in-memory ``load_machine_model`` dict (the
    launcher's cohorts and the tests build these). Without ``"chip"`` the
    chip is ``h100``."""
    chip_cfg = cfg.get("chip", "h100")
    chip = chip_preset(chip_cfg) if isinstance(chip_cfg, str) else ChipSpec(**chip_cfg)
    version = cfg.get("version", "simple")
    if version == "simple":
        return SimpleMachineModel(chip, int(cfg.get("num_devices", 1)))
    if version == "torus":
        return TorusMachineModel(
            chip, cfg["axis_degrees"], cfg.get("axis_links"),
            wraparound=bool(cfg.get("wraparound", True)))
    if version == "multislice":
        return MultiSliceMachineModel(
            chip, cfg["axis_degrees"],
            dcn_axes=tuple(cfg.get("dcn_axes", ["data_dcn"])),
            axis_links=cfg.get("axis_links"),
            wraparound=bool(cfg.get("wraparound", True)))
    if version == "networked":
        from .network import NetworkedMachineModel, TorusTopology, default_topology_for

        axis_degrees = cfg["axis_degrees"]
        dcn_axes = tuple(cfg.get("dcn_axes", []))
        if "topology" in cfg:
            topo = TorusTopology(
                tuple(cfg["topology"]),
                tuple(cfg["topology_wrap"]) if "topology_wrap" in cfg else ())
        else:
            n = 1
            for a, d in axis_degrees.items():
                if a not in dcn_axes:
                    n *= d
            topo = default_topology_for(n)
        return NetworkedMachineModel(
            chip, topo, axis_degrees,
            device_order=cfg.get("device_order"), dcn_axes=dcn_axes)
    raise ValueError(f"unknown machine model version {version!r}")


def multihost_machine_model(num_processes: int, devices_per_process: int,
                            model_degree: int = 1,
                            chip: str = "h100") -> MachineModel:
    """The cohort's two-level model: a :class:`MultiSliceMachineModel`
    whose composed ``data`` axis is priced across processes while a
    ``model`` axis stays inside one, from the same plan the launcher's
    workers use (``parallel/multihost.two_level_mesh_spec``)."""
    from ..parallel.multihost import two_level_mesh_spec

    return machine_model_from_config(two_level_mesh_spec(
        num_processes, devices_per_process, model_degree=model_degree,
        chip=chip)["machine_model"])


def world_size() -> int:
    """The ``torch.distributed`` world size (1 without a process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def detect_machine_model(n_devices: Optional[int] = None,
                         compute_dtype: Optional[str] = None,
                         device: Optional[str] = None) -> MachineModel:
    """The model of the platform this process runs on. ``n_devices``
    defaults to the ``torch.distributed`` world size (1 without a group);
    ``device`` is ``FFConfig.device``, whose default, the card, it takes
    when given none (and raises without a card):

    * on the CPU: ``cpu-host`` with ``shared_host=True``, as the JAX
      package on its virtual mesh;
    * on an H100: ``h100`` or ``h100-bf16`` by ``compute_dtype``; when
      more ranks than cards share the node's cards (a gloo group on one
      card), :class:`SharedCardMachineModel`;
    * any other card raises: give its numbers in a machine-model file
      (``FFConfig.machine_model_file``)."""
    import torch

    from ..config import FFConfig

    n = n_devices if n_devices is not None else world_size()
    # no device: FFConfig's default, the card (raises without one)
    dev = FFConfig(device=FFConfig.device if device is None else str(device)).torch_device()
    if dev.type == "cpu":
        return SimpleMachineModel(CHIP_PRESETS["cpu-host"], n, shared_host=True)
    name = torch.cuda.get_device_name(dev)
    if "H100" not in name:
        raise ValueError(
            f"no machine model for {name!r}: the port carries the H100's; give this "
            "card's numbers in a machine-model file (FFConfig.machine_model_file, "
            "sim/machine_model.py load_machine_model)")
    chip = h100_chip(compute_dtype)
    if n > torch.cuda.device_count():
        return SharedCardMachineModel(chip, n)
    return SimpleMachineModel(chip, n)
