"""Execution simulator and cost model.

PyTorch counterpart of ``flexflow_tpu/sim/`` (the reference's
profiling-based simulator): per-op cost (memoized), an analytic machine and
network model, and full-step simulation, used by the strategy search
(``search/``) and the pipeline's ``schedule="auto"``. The JAX package's
TPU chip presets are not carried; ``h100``/``h100-bf16`` are fitted on the
card (``sim/calibrate.py``).
"""

from .machine_model import (
    CHIP_PRESETS,
    ChipSpec,
    MachineModel,
    MultiSliceMachineModel,
    SharedCardMachineModel,
    SimpleMachineModel,
    TorusMachineModel,
    detect_machine_model,
    load_machine_model,
    machine_model_from_config,
    multihost_machine_model,
)
from .cost_model import CostMetrics, OpCostModel, ProfilingCostModel
from .network import (
    NetworkedMachineModel,
    TorusTopology,
    default_topology_for,
    route_transfers,
)
from .simulator import MemoryUsage, SimTask, Simulator, serving_kv_pool_bytes

__all__ = [
    "ChipSpec",
    "MachineModel",
    "SimpleMachineModel",
    "SharedCardMachineModel",
    "TorusMachineModel",
    "MultiSliceMachineModel",
    "CHIP_PRESETS",
    "detect_machine_model",
    "load_machine_model",
    "machine_model_from_config",
    "multihost_machine_model",
    "CostMetrics",
    "OpCostModel",
    "ProfilingCostModel",
    "NetworkedMachineModel",
    "TorusTopology",
    "default_topology_for",
    "route_transfers",
    "MemoryUsage",
    "SimTask",
    "Simulator",
    "serving_kv_pool_bytes",
]
