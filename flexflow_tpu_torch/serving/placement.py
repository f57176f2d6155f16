"""Instance placement and the model repository.

PyTorch counterpart of ``flexflow_tpu/serving/placement.py``. The
reference carves a disjoint device submesh for each instance of each model
and compiles the instance over it. Here an instance of one device is one
``torch.device``; an instance over a mesh (a ``mesh_shape`` whose product
exceeds 1) is a :class:`MeshPlacement`, one device a rank, which the
engine serves as a group of rank processes (``serving/group.py``).
Placement is first-fit over the device list in file order, and raises
when the devices run out. The default list has one entry per card, so two
instances never share a card and a mesh needs as many cards as ranks. A
caller's list may name a card more than once: an instance's ranks then
share it (over gloo), while instances still take disjoint stretches of
the list.

The repository file is the reference's JSON::

    {"models": {
        "clf": {"instances": 2, "batch_size": 8},
        "tp":  {"instances": 1, "mesh_shape": {"model": 2}, "batch_size": 8,
                "strategies": {"dense_1": {"out": "model"}}},
        "lm":  {"generator": true, "decode_slots": 4, "block_size": 16,
                "num_blocks": 64, "max_length": 128}
    }}

A model's ``builder(ff, batch_size)`` (looked up by its name) adds its
graph; over a mesh it must be importable by name (the ranks unpickle it).
An entry with ``"generator": true`` registers a continuous-batching
:class:`~flexflow_tpu_torch.serving.engine.GenerationInstance` (one
scheduler owns the paged pool, so ``instances`` must be 1) whose builder
makes a causal LM, its ``_GEN_KNOBS`` keys over the config's ``serving_*``
defaults; with a ``mesh_shape`` it runs over a rank group too. A builder
that wants another compute dtype sets ``ff.config.compute_dtype`` itself
(compile reads it); over a mesh the entry's ``"config"`` dict gives the
ranks' further ``FFConfig`` fields. An ``"onnx": path`` entry serves that
file's graph with its initializers (``onnx_frontend``), on devices or over
a mesh, as a builder's entry does.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class MeshPlacement:
    """One instance over a mesh: its axes and degrees, and one device a
    rank in rank order (``arange(world).reshape(sizes)``, as
    ``core/machine.make_mesh`` lays the ranks out)."""

    mesh_shape: Dict[str, int]
    devices: Tuple[torch.device, ...]


def default_devices() -> List[torch.device]:
    """Every card this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def instance_meshes(n_instances: int, mesh_shape: Dict[str, int],
                    devices: Optional[Sequence] = None,
                    offset: int = 0) -> List[Union[torch.device, MeshPlacement]]:
    """``n_instances`` disjoint placements of ``mesh_shape`` from the
    device list, starting at ``offset``: a device each when the mesh is
    one device, else a :class:`MeshPlacement` of as many consecutive
    entries as the mesh has ranks. Raises when the devices run out, which
    would put two instances on one entry."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    per = 1
    for s in mesh_shape.values():
        per *= int(s)
    need = offset + n_instances * per
    if need > len(devices):
        raise ValueError(
            f"{n_instances} instances of mesh {mesh_shape} need {need} "
            f"devices (offset {offset}), have {len(devices)}")
    if per == 1:
        return [devices[offset + i] for i in range(n_instances)]
    shape = {str(k): int(v) for k, v in mesh_shape.items()}
    return [MeshPlacement(shape, tuple(devices[offset + i * per: offset + (i + 1) * per]))
            for i in range(n_instances)]


def _per(mesh_shape: Dict[str, int]) -> int:
    per = 1
    for s in mesh_shape.values():
        per *= int(s)
    return per


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
        if m.get("generator"):
            if n != 1:
                raise ValueError(
                    f"generator {name!r}: instances must be 1 (one "
                    f"scheduler owns the paged KV pool), got {n}")
            if name not in builders:
                raise ValueError(
                    f"generator {name!r} needs a builder (a causal-LM "
                    f"graph; ONNX generators are not supported yet)")
            (placement,) = instance_meshes(1, mesh_shape, devices, offset)
            offset += _per(mesh_shape)
            _register_generator(engine, name, builders[name], placement, m)
            placed[name] = 1
            continue
        placement = instance_meshes(n, mesh_shape, devices, offset)
        offset += n * _per(mesh_shape)
        if "onnx" in m:
            engine.register_onnx_instances(m["onnx"], name=name, devices=placement,
                                           batch_size=m.get("batch_size"))
            placed[name] = n
            continue
        if name not in builders:
            raise ValueError(
                f"model {name!r} has no 'onnx' path and no builder was "
                f"supplied for it")
        engine.register_built_instances(
            builders[name], name=name, devices=placement,
            batch_size=int(m.get("batch_size", 8)), strategies=m.get("strategies"),
            config=m.get("config"))
        placed[name] = n
    return placed


_GEN_KNOBS = ("decode_slots", "block_size", "num_blocks", "max_length",
              "prefill_buckets", "max_prefills_per_step")


def _register_generator(engine, name: str, build: Callable, placement,
                        entry: Dict) -> None:
    """Compile a builder-defined causal LM for inference on ``placement``
    (a device, or a :class:`MeshPlacement` whose rank group compiles it)
    and register it as a continuous-batching generation instance."""
    from ..config import FFConfig
    from ..ffconst import CompMode
    from ..runtime.model import FFModel

    kw = {k: entry[k] for k in _GEN_KNOBS if k in entry}
    batch = int(entry.get("batch_size", 1))
    if isinstance(placement, MeshPlacement):
        from .group import GroupSpec

        spec = GroupSpec(build, dict(placement.mesh_shape),
                         tuple(str(d) for d in placement.devices), batch,
                         entry.get("strategies"), dict(entry.get("config") or {}))
        engine.register_generator(None, name=name, group=spec, **kw)
        return
    ff = FFModel(FFConfig(batch_size=batch, computation_mode=CompMode.INFERENCE,
                          device=str(placement), **(entry.get("config") or {})))
    build(ff, ff.config.batch_size)
    ff.compile(strategies=entry.get("strategies"))
    engine.register_generator(ff, name=name, **kw)


__all__ = ["MeshPlacement", "default_devices", "instance_meshes", "load_repository"]
