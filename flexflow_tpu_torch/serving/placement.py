"""Instance placement and the model repository.

PyTorch counterpart of ``flexflow_tpu/serving/placement.py``. The
reference carves a disjoint device submesh for each instance of each model
and compiles the instance over it; serving over a mesh is ROADMAP
A7b, so each instance is one ``torch.device`` and a ``mesh_shape`` whose
product exceeds 1 raises ``NotImplementedError``. Placement is first-fit
over the device list (by default ``cuda:0`` .. ``cuda:{n-1}``) in file
order, and raises when the devices run out: two models never share a
device.

The repository file is the reference's JSON::

    {"models": {
        "clf": {"instances": 2, "batch_size": 8},
        "lm":  {"generator": true, "decode_slots": 4, "block_size": 16,
                "num_blocks": 64, "max_length": 128}
    }}

A model's ``builder(ff, batch_size)`` (looked up by its name) adds its
graph. An entry with ``"generator": true`` registers a continuous-batching
:class:`~flexflow_tpu_torch.serving.engine.GenerationInstance` (one
scheduler owns the paged pool, so ``instances`` must be 1) whose builder
makes a causal LM, its ``_GEN_KNOBS`` keys over the config's ``serving_*``
defaults. A builder that wants another compute dtype sets
``ff.config.compute_dtype`` itself (compile reads it). An ``"onnx"``
entry raises ``NotImplementedError`` (ROADMAP A12).
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence

import torch


def default_devices() -> List[torch.device]:
    """Every card this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def instance_meshes(n_instances: int, mesh_shape: Dict[str, int],
                    devices: Optional[Sequence] = None,
                    offset: int = 0) -> List[torch.device]:
    """``n_instances`` disjoint placements of ``mesh_shape`` from the
    device list, starting at ``offset``: serving over a mesh is ROADMAP
    A7b, so each is one device. Raises when the devices run out, which would put two
    instances on one device."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    per = 1
    for s in mesh_shape.values():
        per *= int(s)
    if per != 1:
        raise NotImplementedError(
            f"mesh_shape {mesh_shape} spans {per} devices an instance: instances "
            f"over a device mesh are ROADMAP A7b")
    need = offset + n_instances * per
    if need > len(devices):
        raise ValueError(
            f"{n_instances} instances of mesh {mesh_shape} need {need} "
            f"devices (offset {offset}), have {len(devices)}")
    return [devices[offset + i] for i in range(n_instances)]


def load_repository(engine, path: str,
                    builders: Optional[Dict[str, Callable]] = None,
                    devices: Optional[Sequence] = None) -> Dict[str, int]:
    """Load a model repository file into ``engine``. Returns
    ``{model_name: instance_count}``."""
    with open(path) as f:
        spec = json.load(f)
    devices = list(devices if devices is not None else default_devices())
    builders = builders or {}
    placed: Dict[str, int] = {}
    offset = 0
    for name, m in spec.get("models", {}).items():
        n = int(m.get("instances", 1))
        mesh_shape = {k: int(v) for k, v in (m.get("mesh_shape") or {"data": 1}).items()}
        if "onnx" in m:
            raise NotImplementedError(
                f"model {name!r}: ONNX repository entries wait for the port's "
                f"ONNX frontend (ROADMAP A12)")
        if m.get("generator"):
            if n != 1:
                raise ValueError(
                    f"generator {name!r}: instances must be 1 (one "
                    f"scheduler owns the paged KV pool), got {n}")
            if name not in builders:
                raise ValueError(
                    f"generator {name!r} needs a builder (a causal-LM "
                    f"graph; ONNX generators are not supported yet)")
            (device,) = instance_meshes(1, mesh_shape, devices, offset)
            offset += 1
            _register_generator(engine, name, builders[name], device, m)
            placed[name] = 1
            continue
        placement = instance_meshes(n, mesh_shape, devices, offset)
        offset += n
        if name not in builders:
            raise ValueError(
                f"model {name!r} has no 'onnx' path and no builder was "
                f"supplied for it")
        engine.register_built_instances(
            builders[name], name=name, devices=placement,
            batch_size=int(m.get("batch_size", 8)), strategies=m.get("strategies"))
        placed[name] = n
    return placed


_GEN_KNOBS = ("decode_slots", "block_size", "num_blocks", "max_length",
              "prefill_buckets", "max_prefills_per_step")


def _register_generator(engine, name: str, build: Callable, device,
                        entry: Dict) -> None:
    """Compile a builder-defined causal LM for inference on ``device`` and
    register it as a continuous-batching generation instance."""
    from ..config import FFConfig
    from ..ffconst import CompMode
    from ..runtime.model import FFModel

    if entry.get("strategies"):
        raise NotImplementedError(
            f"generator {name!r}: per-op strategies shard over a device mesh: "
            f"serving over a mesh is ROADMAP A7b")
    ff = FFModel(FFConfig(batch_size=int(entry.get("batch_size", 1)),
                          computation_mode=CompMode.INFERENCE, device=str(device)))
    build(ff, ff.config.batch_size)
    ff.compile()
    kw = {k: entry[k] for k in _GEN_KNOBS if k in entry}
    engine.register_generator(ff, name=name, **kw)


__all__ = ["default_devices", "instance_meshes", "load_repository"]
