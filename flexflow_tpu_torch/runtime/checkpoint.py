"""Checkpoint and resume, on one host.

PyTorch counterpart of ``CheckpointManager`` in
``flexflow_tpu/runtime/checkpoint.py``. The card's machine has neither
orbax nor JAX, so the port writes its own payload: one directory per step,
``<dir>/<step>/state.pt``, holding the params, the optimizer state (every
slot, BatchNorm's running statistics among the params) and the iteration
as CPU tensors through ``torch.save``, read back with
``torch.load(weights_only=True)`` into the live tensors in place. It does
not read the JAX package's orbax files.

The crash-safety contract is the reference's:

* the payload is written into a temporary directory, fsynced and renamed
  into place, and the ``extra_<step>.json`` sidecar (the step loop's
  position, written by ``fit``) is written to a temporary name, fsynced
  and renamed: a crash mid-write leaves no half-written step or sidecar
  under its real name;
* :meth:`CheckpointManager.restore` without a step falls back to the
  newest intact step: a torn payload or a corrupt sidecar demotes its
  step, counted on ``checkpoint.corrupt_fallbacks`` /
  ``checkpoint.corrupt_sidecars``, never silent;
* saves and sidecar writes retry ``OSError`` through the shared backoff
  policy (``runtime/retry.py``);
* the ``checkpoint.torn_write`` fault site tears a just-saved step (its
  payload, or its sidecar with ``target='sidecar'``), counted on
  ``faults.torn_checkpoints``;
* a sidecar stamped with another topology (process count, device count,
  backend) raises :class:`CheckpointTopologyError` (CKPT001) unless the
  caller opts into :meth:`CheckpointManager.restore_elastic`, counted on
  ``checkpoint.elastic_resumes``.

Multi-process checkpoints (``MultiHostCheckpointManager``) are ROADMAP
queue A7: a manager opened in a process group of more than one process
raises ``NotImplementedError``.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import sys
from typing import Any, Dict, List, Optional

import torch

from ..obs.metrics import metrics_registry
from .faults import fire as _fault_fire
from .guard import load_into, to_host
from .retry import RetryPolicy

# checkpoint I/O retry: transient directory-level failures back off
# briefly; a persistent failure is raised after the budget
_IO_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.02, max_delay_s=0.25,
                        retry_on=(OSError,), label="checkpoint")

_PAYLOAD = "state.pt"


def _process_count() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def topology_signature(device: Optional[torch.device] = None,
                       process_count: Optional[int] = None) -> Dict:
    """The topology a checkpoint was written under: process count, device
    count and backend (``cuda`` or ``cpu``, the model's device type)."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return {
        "process_count": int(process_count if process_count is not None
                             else _process_count()),
        "device_count": int(torch.cuda.device_count() if dev.type == "cuda" else 1),
        "backend": dev.type,
    }


def topology_matches(saved: Optional[Dict], current: Optional[Dict]) -> bool:
    """Compare two signatures on the fields both carry (a sidecar without
    a stamp matches anything)."""
    if not saved or not current:
        return True
    for k in ("process_count", "device_count", "backend", "mesh_axes"):
        if k in saved and k in current and saved[k] != current[k]:
            return False
    return True


class CheckpointTopologyError(RuntimeError):
    """CKPT001: a resume sidecar was written under another topology than
    the one restoring; set ``config.elastic_resume`` for the explicit,
    counted portable restore."""

    code = "CKPT001"

    def __init__(self, msg: str, expected: Optional[Dict] = None,
                 found: Optional[Dict] = None):
        super().__init__(f"[{self.code}] {msg}")
        self.expected = expected
        self.found = found


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write_json(path: str, doc: Dict) -> None:
    """tmp + fsync + rename: the sidecar exists whole or not at all."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_payload(directory: str, step: int, state: Dict[str, Any]) -> None:
    """``state`` into ``<directory>/<step>/state.pt`` through a fsynced
    temporary directory renamed into place."""
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".{step}.tmp.{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, _PAYLOAD), "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(directory)


def _check_like(live: Any, saved: Any, where: str = "state") -> None:
    """Raise ValueError unless ``saved`` has the live tree's structure,
    shapes and dtypes (checked before anything is copied)."""
    if isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: not a tensor in the checkpoint")
        if tuple(saved.shape) != tuple(live.shape) or saved.dtype != live.dtype:
            raise ValueError(f"{where}: {tuple(saved.shape)} {saved.dtype} in the "
                             f"checkpoint, {tuple(live.shape)} {live.dtype} live")
    elif isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(f"{where}: keys differ from the live model's")
        for k in live:
            _check_like(live[k], saved[k], f"{where}.{k}")
    elif isinstance(live, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(live):
            raise ValueError(f"{where}: length differs from the live model's")
        for i, (a, b) in enumerate(zip(live, saved)):
            _check_like(a, b, f"{where}[{i}]")


class CheckpointManager:
    """Step-numbered checkpoints with retention.

    Usage::

        ckpt = CheckpointManager(dir, max_to_keep=3)
        ckpt.save(ff, step)
        step = ckpt.restore(ff)          # newest intact; or restore(ff, step=N)
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        if _process_count() > 1:
            raise NotImplementedError(
                "multi-process checkpoints (MultiHostCheckpointManager) are not "
                "ported yet (ROADMAP A7)")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------ #
    def save(self, ffmodel, step: int, extra: Optional[Dict[str, Any]] = None,
             wait: bool = True) -> None:
        """Save the params, the optimizer state and the iteration; ``extra``
        (JSON) goes into the step's sidecar, handed back by
        :meth:`restore_extra`. The copy to the host and the write finish
        before this returns (``wait`` is the reference's keyword)."""
        cm = ffmodel.compiled
        if cm is None:
            raise RuntimeError("compile() before saving")
        state = {"params": to_host(cm.params), "opt_state": to_host(cm.opt_state),
                 "iteration": int(cm.resume_state()["iteration"])}
        _IO_RETRY.call(_write_payload, self.directory, int(step), state)
        if extra is not None:
            _IO_RETRY.call(_atomic_write_json, self._extra_path(step), extra)
        self._apply_retention()
        # chaos: tear what was just written, so restore's fallback to the
        # newest intact step is provable
        rule = _fault_fire("checkpoint.torn_write")
        if rule is not None:
            self._tear(step, rule.get("target", "payload"))

    def _tear(self, step: int, target: str) -> None:
        """Corrupt a saved step on purpose: truncate every payload file to
        half, or replace the sidecar with a torn JSON prefix."""
        metrics_registry().counter("faults.torn_checkpoints").inc()
        if target == "sidecar":
            with open(self._extra_path(step), "w") as f:
                f.write('{"schema": 1, "epoch"')  # torn mid-key
            return
        root = os.path.join(self.directory, str(step))
        for dirpath, _dirnames, filenames in sorted(os.walk(root)):
            for name in sorted(filenames):
                p = os.path.join(dirpath, name)
                try:
                    size = os.path.getsize(p)
                    if size > 0:
                        os.truncate(p, size // 2)
                except OSError:
                    pass

    def _apply_retention(self) -> None:
        """Keep the newest ``max_to_keep`` steps; drop the others and the
        sidecars whose step is gone."""
        steps = self.all_steps()
        if self.max_to_keep is not None and len(steps) > self.max_to_keep:
            for s in steps[:len(steps) - self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)
        live = set(self.all_steps())
        for p in glob.glob(os.path.join(self.directory, "extra_*.json")):
            m = re.match(r"extra_(\d+)\.json$", os.path.basename(p))
            if m and int(m.group(1)) not in live:
                try:
                    os.remove(p)
                except OSError:
                    pass

    def _extra_path(self, step: int) -> str:
        return os.path.join(self.directory, f"extra_{step}.json")

    def _load_extra(self, step: int) -> Optional[Dict[str, Any]]:
        """One step's sidecar; ValueError when it is corrupt."""
        path = self._extra_path(step)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"sidecar {path} is not a JSON object")
        return doc

    def restore_extra(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The ``extra`` dict saved with a step, or None; a corrupt sidecar
        gives None and counts on ``checkpoint.corrupt_sidecars``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        try:
            return self._load_extra(step)
        except ValueError as e:
            metrics_registry().counter("checkpoint.corrupt_sidecars").inc()
            print(f"[checkpoint] corrupt sidecar for step {step}: {e}",
                  file=sys.stderr, flush=True)
            return None

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def payload_bytes(self, step: int) -> int:
        """Bytes of one step's payload on disk."""
        root = os.path.join(self.directory, str(step))
        return sum(os.path.getsize(os.path.join(d, n))
                   for d, _, names in os.walk(root) for n in names)

    def _restore_step(self, ffmodel, step: int) -> None:
        """Read one step's payload and copy it into the live model; raises
        on a torn or mismatched payload before anything is changed."""
        cm = ffmodel.compiled
        path = os.path.join(self.directory, str(step), _PAYLOAD)
        state = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(state, dict) or {"params", "opt_state", "iteration"} - set(state):
            raise ValueError(f"{path}: not a checkpoint payload")
        _check_like(cm.params, state["params"], "params")
        _check_like(cm.opt_state, state["opt_state"], "opt_state")
        cm.params = load_into(cm.params, state["params"])
        cm.opt_state = load_into(cm.opt_state, state["opt_state"])
        cm.bump_params_version()  # serving cast caches re-derive
        cm.load_resume_state({"iteration": int(state["iteration"])})

    def _check_topology(self, ffmodel, extra: Optional[Dict], step: int) -> None:
        saved = (extra or {}).get("topology")
        cur = topology_signature(ffmodel.compiled.device)
        if not topology_matches(saved, cur):
            raise CheckpointTopologyError(
                f"checkpoint step {step} under {self.directory} was written for "
                f"topology {saved}, but this process runs {cur}; refusing to "
                f"restore (set config.elastic_resume for a portable restore)",
                expected=cur, found=saved)

    def restore(self, ffmodel, step: Optional[int] = None,
                require_extra: bool = False, check_topology: bool = True) -> int:
        """Restore into the compiled model in place; returns the step. With
        a ``step`` the restore is strict. Without one, steps are tried
        newest first and one whose payload or sidecar is corrupt (or, with
        ``require_extra``, has no sidecar) is skipped and counted on
        ``checkpoint.corrupt_fallbacks``. A topology mismatch raises
        :class:`CheckpointTopologyError` and never falls back."""
        cm = ffmodel.compiled
        if cm is None:
            raise RuntimeError("compile() before restoring")
        if step is not None:
            if check_topology:
                try:
                    self._check_topology(ffmodel, self._load_extra(step), step)
                except (ValueError, OSError):
                    pass  # an unreadable sidecar: the strict payload path decides
            self._restore_step(ffmodel, step)
            return step
        candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        last_err: Optional[BaseException] = None
        for s in candidates:
            try:
                extra = self._load_extra(s)
                if extra is None and require_extra:
                    raise ValueError(f"step {s} has no resume sidecar "
                                     f"({self._extra_path(s)})")
                if check_topology:
                    self._check_topology(ffmodel, extra, s)
                self._restore_step(ffmodel, s)
                return s
            except CheckpointTopologyError:
                raise  # a configuration change, not corruption
            except Exception as e:  # noqa: BLE001 (any torn read demotes the step)
                last_err = e
                metrics_registry().counter("checkpoint.corrupt_fallbacks").inc()
                print(f"[checkpoint] step {s} is not intact ({type(e).__name__}: {e}); "
                      f"falling back to the next-newest step", file=sys.stderr, flush=True)
        raise RuntimeError(f"no intact checkpoint under {self.directory} "
                           f"(tried {candidates})") from last_err

    def restore_elastic(self, ffmodel) -> int:
        """The newest-intact restore with the topology gate off (the payload
        is copied into the current model's tensors, wherever they live),
        counted on ``checkpoint.elastic_resumes``."""
        step = self.restore(ffmodel, require_extra=True, check_topology=False)
        metrics_registry().counter("checkpoint.elastic_resumes").inc()
        return step

    def close(self) -> None:
        """Saves finish inside :meth:`save`; nothing is pending."""


def save_checkpoint(ffmodel, path: str, step: int = 0) -> None:
    """One-shot save (``FFModel.save_checkpoint``)."""
    CheckpointManager(path, max_to_keep=None).save(ffmodel, step)


def load_checkpoint(ffmodel, path: str, step: Optional[int] = None) -> int:
    """One-shot restore (``FFModel.load_checkpoint``); returns the step."""
    return CheckpointManager(path, max_to_keep=None).restore(ffmodel, step)


__all__ = ["CheckpointManager", "CheckpointTopologyError", "load_checkpoint",
           "save_checkpoint", "topology_matches", "topology_signature"]
