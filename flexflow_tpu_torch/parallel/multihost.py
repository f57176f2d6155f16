"""Multi-process runs: bootstrap, capability probe and meshes over processes.

PyTorch counterpart of ``flexflow_tpu/parallel/multihost.py``. The JAX
package runs one process a host over ``jax.distributed`` and lets XLA's
collectives cross the hosts; the port runs one process a rank over
``torch.distributed`` (``parallel/distributed.py``), so a multi-host run
is a process group whose ranks sit on several hosts.

* :func:`distributed_init`: the process's bootstrap from its arguments or
  the launcher's environment;
* :func:`elastic_init`: :func:`distributed_init` with a bounded timeout,
  retried under the shared jittered backoff (``runtime/retry.py``, label
  ``mh_init``), the ``multihost.init_timeout`` fault site firing inside
  each attempt; the supervisor's workers (``parallel/launch.py``) call it;
* :func:`multiprocess_compute_support`: one small all-reduce over the
  group. gloo and nccl run every collective the port needs, so where the
  JAX package falls back to process-local replicas the port raises;
* :func:`make_local_mesh`, :func:`two_level_mesh_spec`,
  :func:`make_multihost_mesh`: meshes whose axis that crosses processes
  (hosts) is the outermost;
* :func:`process_local_batch`: this rank's rows of a global batch.

:func:`two_level_mesh_spec` also returns the machine model that prices
the cross-process axis (``sim/machine_model.py``
``MultiSliceMachineModel``), for ``FFConfig.machine_model_file``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.machine import Mesh, make_mesh
from . import distributed


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     initialization_timeout: Optional[float] = None) -> None:
    """Join this process to its run's process group.

    The arguments default from the environment, so one launch script
    serves every scheduler, in this order:

    * the explicit arguments;
    * ``FLEXFLOW_COORDINATOR`` (``host:port``) / ``FLEXFLOW_NUM_PROCESSES``
      / ``FLEXFLOW_PROCESS_ID``;
    * OpenMPI (``OMPI_COMM_WORLD_RANK`` / ``OMPI_COMM_WORLD_SIZE``);
    * SLURM (``SLURM_PROCID`` / ``SLURM_NTASKS``);
    * torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` and
      ``MASTER_PORT``.

    The group rendezvous at ``tcp://<coordinator>`` (torchrun's variables
    alone: ``env://``). ``local_device_ids``: this process's card (the
    first id); by default the local rank's. ``initialization_timeout``
    bounds the rendezvous and every later collective's wait. The backend
    is ``distributed.choose_backend``'s. Idempotent: a second call in a
    joined process does nothing."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = os.environ
    coordinator_address = coordinator_address or env.get("FLEXFLOW_COORDINATOR") or None
    num_processes = num_processes if num_processes is not None else _env_int(
        "FLEXFLOW_NUM_PROCESSES", "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS", "WORLD_SIZE")
    process_id = process_id if process_id is not None else _env_int(
        "FLEXFLOW_PROCESS_ID", "OMPI_COMM_WORLD_RANK", "SLURM_PROCID", "RANK")
    if num_processes is None or process_id is None:
        raise ValueError("distributed_init: no process count or id in the arguments or "
                         "in FLEXFLOW_*/OMPI_*/SLURM_*/torchrun's environment")
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    local_world = _env_int("LOCAL_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE",
                           "SLURM_NTASKS_PER_NODE") or num_processes
    distributed.init_process_group(
        process_id, num_processes, init_method, local_world,
        timeout_s=initialization_timeout or distributed.TIMEOUT_S)
    if local_device_ids and torch.cuda.is_available():
        torch.cuda.set_device(int(local_device_ids[0]))


def elastic_init(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 local_device_ids: Optional[Sequence[int]] = None,
                 timeout_s: float = 60.0, max_attempts: int = 3,
                 base_delay_s: float = 0.5, seed: Optional[int] = None,
                 _init_fn=None) -> Dict:
    """:func:`distributed_init` with the rendezvous bounded by
    ``timeout_s``, retried under the jittered backoff (label ``mh_init``:
    attempts, retries and give-ups land in the metrics registry); the
    ``multihost.init_timeout`` site fires inside each attempt. A failed
    attempt leaves no half-joined group behind. ``seed`` makes the jitter
    replayable; ``_init_fn`` replaces the bootstrap for tests. Returns
    ``{attempts, process_id, process_count, local_devices,
    global_devices}`` (a device is a rank's card, or its CPU)."""
    import torch.distributed as dist

    from ..runtime import faults as _fx
    from ..runtime.faults import TransientFault
    from ..runtime.retry import RetryPolicy

    state = {"attempts": 0}

    def attempt():
        state["attempts"] += 1
        _fx.inject("multihost.init_timeout", TransientFault)
        try:
            if _init_fn is not None:
                _init_fn()
            else:
                distributed_init(coordinator_address, num_processes, process_id,
                                 local_device_ids, initialization_timeout=timeout_s)
        except BaseException:
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    RetryPolicy(max_attempts=max_attempts, base_delay_s=base_delay_s, multiplier=2.0,
                max_delay_s=max(base_delay_s, 10.0), jitter=0.5,
                retry_on=(TransientFault, RuntimeError, OSError), label="mh_init",
                seed=seed).call(attempt)
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    return {"attempts": state["attempts"],
            "process_id": dist.get_rank() if joined else 0,
            "process_count": world,
            "local_devices": max(1, torch.cuda.device_count()),
            "global_devices": world}


_MP_SUPPORT: Optional[Tuple[bool, Optional[str]]] = None


def multiprocess_compute_support(refresh: bool = False) -> Tuple[bool, Optional[str]]:
    """Whether the group runs collectives across its processes: one
    all-reduce of ones, checked against the world size, cached. The JAX
    package answers False on backends without cross-process programs and
    falls back to process-local replicas; gloo and nccl always run them,
    so a failure here raises (no fallback)."""
    import torch.distributed as dist

    global _MP_SUPPORT
    if _MP_SUPPORT is not None and not refresh:
        return _MP_SUPPORT
    if not dist.is_initialized() or dist.get_world_size() == 1:
        _MP_SUPPORT = (True, None)
        return _MP_SUPPORT
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ones = torch.ones(1, device=device)
    dist.all_reduce(ones)
    if int(ones.item()) != dist.get_world_size():
        raise RuntimeError(f"the probe all-reduce summed {ones.item()} over "
                           f"{dist.get_world_size()} processes")
    _MP_SUPPORT = (True, None)
    return _MP_SUPPORT


def make_local_mesh(mesh_shape: Optional[Dict[str, int]] = None) -> Optional[Mesh]:
    """The mesh over this process's own devices. A process is one rank
    with one device, so that is no mesh (None, a one-device model), and a
    shape of more than one device raises: the port has no process-local
    replica fallback."""
    n = int(np.prod(list((mesh_shape or {}).values()) or [1], dtype=np.int64))
    if n != 1:
        raise ValueError(f"mesh {mesh_shape}: a process holds one rank and one device")
    return None


def two_level_mesh_spec(num_processes: int, devices_per_process: int,
                        model_degree: int = 1, chip: str = "h100") -> Dict:
    """The two-level layout of a cohort: a model axis stays inside a
    process's devices, the data axis composes the in-process and the
    cross-process degrees, the cross-process factor outermost (the
    :func:`make_multihost_mesh` convention). Returns ``{"mesh_shape",
    "dcn_mesh_shape", "machine_model"}``, the last a
    ``load_machine_model`` multislice config that prices the whole
    composed data axis at the cross-process rate (the hop its gradient
    all-reduce crosses) and a model axis inside a node; write it to a file
    for ``FFConfig.machine_model_file``."""
    if devices_per_process <= 0 or num_processes <= 0:
        raise ValueError("num_processes and devices_per_process must be positive")
    if model_degree < 1 or devices_per_process % model_degree:
        raise ValueError(
            f"model_degree {model_degree} must divide the per-process device count "
            f"{devices_per_process} (model/tensor axes stay inside a process)")
    ici_data = devices_per_process // model_degree
    mesh_shape: Dict[str, int] = {"data": ici_data}
    axis_degrees: Dict[str, int] = {"data": ici_data * num_processes}
    if model_degree > 1:
        mesh_shape["model"] = model_degree
        axis_degrees["model"] = model_degree
    return {"mesh_shape": mesh_shape, "dcn_mesh_shape": {"data": num_processes},
            "machine_model": {"version": "multislice", "chip": chip,
                              "axis_degrees": axis_degrees,
                              "dcn_axes": ["data"] if num_processes > 1 else []}}


def make_multihost_mesh(mesh_shape: Optional[Dict[str, int]] = None,
                        dcn_mesh_shape: Optional[Dict[str, int]] = None) -> Optional[Mesh]:
    """The mesh over every rank of the group. With ``dcn_mesh_shape``
    (``{"data": hosts}``) the cross-host axes come first, an axis named in
    both composing (its cross-host degree times its in-host one): ranks
    are numbered host by host, so the outermost axis is the one whose
    collectives cross hosts and the inner axes stay inside one."""
    if not dcn_mesh_shape:
        return make_mesh(mesh_shape)
    mesh_shape = dict(mesh_shape or {})
    names = list(dict.fromkeys(list(dcn_mesh_shape) + list(mesh_shape)))
    return make_mesh({a: int(dcn_mesh_shape.get(a, 1)) * int(mesh_shape.get(a, 1))
                      for a in names})


def process_local_batch(global_batch: np.ndarray, cm, input_index: int = 0) -> np.ndarray:
    """This rank's rows of a global batch of input ``input_index`` (the
    label when it is the input count) of a compiled model: every process
    holds the whole dataset, as in the JAX package, and takes the rows its
    layout gives it (all of them on one rank)."""
    return np.asarray(global_batch)[cm.batch_rows(input_index)]


__all__ = ["distributed_init", "elastic_init", "make_local_mesh", "make_multihost_mesh",
           "multiprocess_compute_support", "process_local_batch", "two_level_mesh_spec"]
