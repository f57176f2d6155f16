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

In a process group of more than one process a :class:`CheckpointManager`
(and so ``save_checkpoint``/``load_checkpoint``) is a
:class:`MultiHostCheckpointManager`, the reference's multi-process layout
and the only one: each rank's payload, sidecar and acknowledgement
committed on a background thread, and rank 0's topology-stamped manifest
once every rank has acknowledged (its contract is on the class).
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.machine import DATA_AXIS
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


def _process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def topology_signature(device: Optional[torch.device] = None,
                       process_count: Optional[int] = None, mesh=None) -> Dict:
    """The topology a checkpoint was written under: process count, device
    count, backend (``cuda`` or ``cpu``, the model's device type) and,
    over a mesh, its axes and degrees."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    sig = {
        "process_count": int(process_count if process_count is not None
                             else _process_count()),
        "device_count": int(torch.cuda.device_count() if dev.type == "cuda" else 1),
        "backend": dev.type,
    }
    if mesh is not None:
        sig["mesh_axes"] = {str(a): int(d) for a, d in mesh.shape.items()}
    return sig


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

    In a process group of more than one process it is a
    :class:`MultiHostCheckpointManager`: the one multi-process layout.
    """

    def __new__(cls, directory: str, max_to_keep: Optional[int] = 3):
        if cls is CheckpointManager and _process_count() > 1:
            return MultiHostCheckpointManager(directory, max_to_keep=max_to_keep)
        return super().__new__(cls)

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
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


# ------------------------------------------------------------- multi-process
MH_MANIFEST_SCHEMA = 1


def is_multihost_dir(path: str) -> bool:
    """True when ``path`` holds the multi-process layout
    (``manifest_<step>.json`` and ``shard-<rank>/``): ``fit`` takes
    :class:`MultiHostCheckpointManager` for such a directory even in one
    process, so a shrunk relaunch reads its cohort's checkpoints."""
    try:
        names = os.listdir(path)
    except OSError:
        return False
    return any(n.startswith("manifest_") and n.endswith(".json") for n in names) or \
        any(n.startswith("shard-") for n in names)


def _regions(cm, tree: Any, share: bool) -> Dict[str, list]:
    """Where each tensor leaf of ``tree`` lies in its whole array:
    ``"a/b/c"`` (the leaf's path) -> ``[whole shape, [[start, stop] a
    dim]]``. A weight's block (``tree`` the params) is this rank's along
    every axis its layout shards; with ``share`` (``tree`` an optimizer
    state) a ZeRO-1 share is that block cut again along ``data``. Any
    other leaf is whole."""
    layouts = {op.name: op.weight_shapes for op in cm.ops} if cm.mesh is not None else {}
    out: Dict[str, list] = {}

    def walk(node: Any, path: tuple) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if not isinstance(node, torch.Tensor):
            return
        shape = list(node.shape)
        region = [[0, n] for n in shape]
        op_w = tuple(path[-2:])
        layout = layouts.get(op_w[0], {}).get(op_w[1]) if len(op_w) == 2 else None
        if layout is not None:
            shape = list(layout.sizes)
            region = [[s.start or 0, n if s.stop is None else s.stop]
                      for s, n in zip(cm.mesh.local_slices(layout), shape)]
            d = cm.zero_dims.get(op_w)
            if share and d is not None:
                step = int(node.shape[d])
                lo = region[d][0] + cm.mesh.coords[DATA_AXIS] * step
                region[d] = [lo, lo + step]
        if [b - a for a, b in region] != list(node.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: a block of {list(node.shape)} "
                             f"does not fit its region {region} of {shape}")
        out["/".join(map(str, path))] = [shape, region]

    walk(tree, ())
    return out


def _assemble(key: str, shape: list, region: list, like: torch.Tensor,
              shards: List[Tuple[Dict, torch.Tensor]]) -> torch.Tensor:
    """The block ``region`` of the whole array ``key``, from the saved
    ``(regions, leaf)`` pairs: each element is copied from a shard that
    held it; an element that no shard held raises CKPT001."""
    out = torch.empty([b - a for a, b in region], dtype=like.dtype)
    covered = torch.zeros(out.shape, dtype=torch.bool)
    for regions, leaf in shards:
        saved_shape, saved = regions[key]
        if list(saved_shape) != list(shape):
            raise CheckpointTopologyError(
                f"{key} is {list(saved_shape)} in the checkpoint but {shape} in this model",
                expected={"shape": shape}, found={"shape": list(saved_shape)})
        lo = [max(a, c) for (a, _), (c, _) in zip(saved, region)]
        hi = [min(b, d) for (_, b), (_, d) in zip(saved, region)]
        if any(x >= y for x, y in zip(lo, hi)):
            continue
        dst = tuple(slice(x - c, y - c) for x, y, (c, _) in zip(lo, hi, region))
        src = tuple(slice(x - a, y - a) for x, y, (a, _) in zip(lo, hi, saved))
        out[dst] = leaf[src]
        covered[dst] = True
    if not bool(covered.all()):
        raise CheckpointTopologyError(
            f"{key}: the saved shards do not cover this rank's block {region} of {shape}",
            expected={"region": region}, found=None)
    return out


def _leaf(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


class MultiHostCheckpointManager:
    """Each rank's checkpoint and a topology-stamped manifest: the
    multi-process runtime's durable state (the reference's manager, with
    the port's own ``torch.save`` payloads).

    Layout under ``directory``::

        shard-000/step_8.pt       # rank 0's payload (atomic tmp + rename)
        shard-000/extra_8.json    # rank 0's resume sidecar (atomic)
        shard-000/ack_8.json      # rank 0's commit receipt
        shard-001/...
        manifest_8.json           # rank 0, after every rank acknowledged

    A rank saves what it holds: its params (its blocks of the sharded
    ones), its optimizer state (a ZeRO-1 rank its share, a pipeline stage
    its own after ``sync_to``) and where its share lies along ``data``.

    * **per-rank commit, in the background**: each rank copies its state
      to the host at once, then writes payload, sidecar and ack on a
      thread; ``wait=False`` returns at once and the next save, restore or
      close joins it, re-raising its error there;
    * **the manifest is the global commit point**: rank 0 writes it only
      after it has seen every rank's ack for the step, within
      ``barrier_timeout_s``; past it no manifest is written (counted on
      ``checkpoint.barrier_timeouts``) and a restore uses the previous
      manifested step;
    * **topology-stamped**: :meth:`restore` checks the manifest's topology
      (process count, device count, backend, mesh axes) against the
      restoring cohort and raises :class:`CheckpointTopologyError`
      (CKPT001) on a mismatch; :meth:`restore_elastic` is the explicit,
      counted restore onto another world or mesh: each payload records
      where each of its tensors lies in the whole array, and each rank
      cuts its own block (along every sharded axis, its ZeRO-1 share
      along ``data``) from every saved shard that held a part of it;
    * **torn-manifest fallback**: a manifest that does not parse is
      skipped and counted (``checkpoint.torn_manifests``);
    * **retention counts manifested steps**: a run of saves that never
      manifested (a wedged peer) never evicts the payload a surviving
      manifest points at; acks are never pruned;
    * **incarnations**: acks carry ``launch_id`` (``FLEXFLOW_TPU_MH_LAUNCH_ID``,
      one id a cohort launch from the supervisor); the barrier counts only
      the current launch's, so a stale ack of a torn-down launch cannot
      manifest a step its peer has not committed again.
    """

    def __init__(self, directory: str, process_id: Optional[int] = None,
                 process_count: Optional[int] = None, max_to_keep: Optional[int] = 3,
                 barrier_timeout_s: Optional[float] = None,
                 launch_id: Optional[str] = None):
        self.directory = os.path.abspath(directory)
        self.rank = int(process_id if process_id is not None else _process_index())
        self.world = int(process_count if process_count is not None else _process_count())
        self.max_to_keep = max_to_keep
        self.barrier_timeout_s = 60.0 if barrier_timeout_s is None else float(barrier_timeout_s)
        self.launch_id = (launch_id if launch_id is not None
                          else os.environ.get("FLEXFLOW_TPU_MH_LAUNCH_ID"))
        self._torn_seen: set = set()  # each torn manifest is counted once
        self._mu = threading.Lock()  # guards _pending and _commit_err
        self._pending: Optional[threading.Thread] = None
        self._commit_err: Optional[BaseException] = None
        os.makedirs(self._shard_dir(self.rank), exist_ok=True)

    # ---- paths ------------------------------------------------------------
    def _shard_dir(self, rank: int) -> str:
        return os.path.join(self.directory, f"shard-{rank:03d}")

    def _payload_path(self, step: int, rank: Optional[int] = None) -> str:
        return os.path.join(self._shard_dir(self.rank if rank is None else rank),
                            f"step_{step}.pt")

    def _extra_path(self, step: int, rank: Optional[int] = None) -> str:
        return os.path.join(self._shard_dir(self.rank if rank is None else rank),
                            f"extra_{step}.json")

    def _ack_path(self, step: int, rank: int) -> str:
        return os.path.join(self._shard_dir(rank), f"ack_{step}.json")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"manifest_{step}.json")

    # ---- the background commit ---------------------------------------------
    def _join_pending(self) -> None:
        """Wait for the commit in flight; its failure is raised here."""
        with self._mu:
            t, self._pending = self._pending, None
        if t is not None and t is not threading.current_thread():
            t.join()
        with self._mu:
            err, self._commit_err = self._commit_err, None
        if err is not None:
            raise RuntimeError(f"the background commit of rank {self.rank} under "
                               f"{self.directory} failed") from err

    def save(self, ffmodel, step: int, extra: Optional[Dict[str, Any]] = None,
             wait: bool = True) -> None:
        """Commit this rank's shard for ``step``; rank 0 also writes the
        manifest once every rank has acknowledged it."""
        cm = ffmodel.compiled
        if cm is None:
            raise RuntimeError("compile() before saving")
        self._join_pending()
        step = int(step)
        if getattr(ffmodel, "pipelined", None) is not None:
            ffmodel.pipelined.sync_to(cm)  # collective over the pipe group
        topo = topology_signature(cm.device, self.world, cm.mesh)
        extra_doc = dict(extra or {})
        extra_doc["topology"] = topo
        manifest = {"schema": MH_MANIFEST_SCHEMA, "step": step, "process_count": self.world,
                    "topology": topo, "mesh_axes": topo.get("mesh_axes"),
                    "strategy_key": None, "ts_unix_s": round(time.time(), 3),
                    "ranks": list(range(self.world))}
        pipe = getattr(ffmodel, "pipelined", None)
        state = {"params": to_host(cm.params), "opt_state": to_host(cm.opt_state),
                 "iteration": int(cm.resume_state()["iteration"]),
                 "regions": {"params": _regions(cm, cm.params, share=False),
                             "opt_state": _regions(cm, cm.opt_state, share=True)},
                 # a pipeline stage's optimizer state is its own ops' only
                 "owned_ops": None if pipe is None else
                 sorted(op.name for op in pipe.stages[pipe.stage])}
        t = threading.Thread(target=self._commit, args=(step, state, extra_doc, manifest),
                             name=f"ff-mh-ckpt-r{self.rank}", daemon=False)
        with self._mu:
            self._pending = t
        t.start()
        if wait:
            self._join_pending()

    def _commit(self, step: int, state: Dict, extra_doc: Dict, manifest: Dict) -> None:
        """Payload, sidecar and ack; on rank 0 then the manifest barrier.
        An error is kept for the next join."""
        try:
            _IO_RETRY.call(self._write_payload, step, state)
            _IO_RETRY.call(_atomic_write_json, self._extra_path(step), extra_doc)
            _IO_RETRY.call(_atomic_write_json, self._ack_path(step, self.rank),
                           {"rank": self.rank, "step": step, "launch_id": self.launch_id,
                            "ts_unix_s": round(time.time(), 3)})
            metrics_registry().counter("checkpoint.shard_saves").inc()
            if self.rank == 0:
                if self._await_acks(step):
                    _IO_RETRY.call(_atomic_write_json, self._manifest_path(step), manifest)
                else:
                    metrics_registry().counter("checkpoint.barrier_timeouts").inc()
                    print(f"[checkpoint] step {step}: not every rank acknowledged within "
                          f"{self.barrier_timeout_s}s; manifest not written (a restore "
                          f"uses the previous manifested step)", file=sys.stderr, flush=True)
            self._prune()
            # chaos: tear what was just committed (target 'manifest' tears
            # the global commit point itself)
            rule = _fault_fire("checkpoint.torn_write")
            if rule is not None:
                self._tear(step, rule.get("target", "payload"))
        except BaseException as e:  # noqa: BLE001 (raised at the next join)
            with self._mu:
                self._commit_err = e

    def _write_payload(self, step: int, state: Dict) -> None:
        path = self._payload_path(step)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _await_acks(self, step: int) -> bool:
        deadline = time.monotonic() + self.barrier_timeout_s
        want = [self._ack_path(step, r) for r in range(self.world)]
        # a rank waiting here for a slow peer is alive: the supervisor's
        # heartbeat reads this counter besides the iteration
        polls = metrics_registry().counter("checkpoint.barrier_polls")

        def acked(path: str) -> bool:
            if self.launch_id is None:
                return os.path.exists(path)
            try:
                with open(path) as f:
                    return json.load(f).get("launch_id") == self.launch_id
            except (OSError, ValueError):
                return False  # absent or mid-write

        while True:
            polls.inc()
            if all(acked(p) for p in want):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    @staticmethod
    def _steps(pattern: str, rx: str) -> List[Tuple[int, str]]:
        out = []
        for p in glob.glob(pattern):
            m = re.match(rx, os.path.basename(p))
            if m:
                out.append((int(m.group(1)), p))
        return sorted(out, reverse=True)

    def _prune(self) -> None:
        """Keep this rank's newest ``max_to_keep`` payloads and as many
        manifested ones (and rank 0 the newest manifests); acks stay."""
        if self.max_to_keep is None:
            return
        keep = max(1, int(self.max_to_keep))
        shard = self._shard_dir(self.rank)
        payloads = self._steps(os.path.join(shard, "step_*.pt"), r"step_(\d+)\.pt$")
        manifested = {s for s, _ in self._manifests()}
        keep_steps = {s for s, _ in payloads[:keep]}
        keep_steps.update([s for s, _ in payloads if s in manifested][:keep])
        dead = {s for s, _ in payloads} - keep_steps
        doomed = [p for s, p in payloads if s in dead]
        doomed += [p for s, p in self._steps(os.path.join(shard, "extra_*.json"),
                                             r"extra_(\d+)\.json$") if s in dead]
        if self.rank == 0:
            doomed += [p for _, p in self._manifests()[keep:]]
        for p in doomed:
            try:
                os.remove(p)
            except OSError:
                pass

    def _tear(self, step: int, target: str) -> None:
        """Corrupt on purpose (``checkpoint.torn_write``): this rank's
        payload, its sidecar, or (rank 0) the manifest."""
        metrics_registry().counter("faults.torn_checkpoints").inc()
        if target == "sidecar":
            with open(self._extra_path(step), "w") as f:
                f.write('{"schema": 1, "epoch"')
            return
        if target == "manifest":
            if self.rank == 0:
                with open(self._manifest_path(step), "w") as f:
                    f.write('{"schema": 1, "step"')
            return
        p = self._payload_path(step)
        try:
            size = os.path.getsize(p)
            if size > 0:
                os.truncate(p, size // 2)
        except OSError:
            pass

    # ---- restore ------------------------------------------------------------
    def _manifests(self) -> List[Tuple[int, str]]:
        return self._steps(os.path.join(self.directory, "manifest_*.json"),
                           r"manifest_(\d+)\.json$")

    def _intact_manifests(self) -> List[Tuple[int, Dict]]:
        """Newest first; a torn one is skipped and counted once."""
        out = []
        for step, path in self._manifests():
            try:
                with open(path) as f:
                    doc = json.load(f)
                if not isinstance(doc, dict) or doc.get("schema") != MH_MANIFEST_SCHEMA:
                    raise ValueError(f"bad manifest schema in {path}")
                out.append((step, doc))
            except (ValueError, OSError) as e:
                if path not in self._torn_seen:
                    self._torn_seen.add(path)
                    metrics_registry().counter("checkpoint.torn_manifests").inc()
                    print(f"[checkpoint] manifest {path} is not intact ({type(e).__name__}: "
                          f"{e}); falling back to the next-newest manifest", file=sys.stderr,
                          flush=True)
        return out

    def latest_manifest(self) -> Optional[Tuple[int, Dict]]:
        self._join_pending()
        items = self._intact_manifests()
        return items[0] if items else None

    def latest_step(self) -> Optional[int]:
        m = self.latest_manifest()
        return m[0] if m else None

    def all_steps(self) -> List[int]:
        self._join_pending()
        return sorted(s for s, _ in self._intact_manifests())

    def _load_extra(self, step: int, rank: Optional[int] = None) -> Optional[Dict]:
        path = self._extra_path(step, rank)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"sidecar {path} is not a JSON object")
        return doc

    def restore_extra(self, step: Optional[int] = None) -> Optional[Dict]:
        """This rank's sidecar (shard 0's when this rank has none: the
        world grew), or None; a corrupt one is counted."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        try:
            doc = self._load_extra(step)
            if doc is None and self.rank != 0:
                doc = self._load_extra(step, rank=0)
            return doc
        except ValueError as e:
            metrics_registry().counter("checkpoint.corrupt_sidecars").inc()
            print(f"[checkpoint] corrupt sidecar for step {step}: {e}", file=sys.stderr,
                  flush=True)
            return None

    def _load_payload(self, step: int, rank: Optional[int] = None) -> Dict:
        path = self._payload_path(step, rank)
        state = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(state, dict) or {"params", "opt_state", "iteration"} - set(state):
            raise ValueError(f"{path}: not a checkpoint payload")
        return state

    def _apply(self, ffmodel, params, opt_state, iteration: int) -> None:
        """Check every tree against the live model, then copy it in."""
        cm = ffmodel.compiled
        _check_like(cm.params, params, "params")
        _check_like(cm.opt_state, opt_state, "opt_state")
        cm.params = load_into(cm.params, params)
        cm.opt_state = load_into(cm.opt_state, opt_state)
        cm.bump_params_version()
        cm.load_resume_state({"iteration": int(iteration)})
        if getattr(ffmodel, "pipelined", None) is not None:
            ffmodel.pipelined.sync_from(cm)

    def _restore_shard(self, ffmodel, step: int, require_extra: bool) -> None:
        if require_extra and self._load_extra(step) is None:
            raise ValueError(f"step {step} has no resume sidecar ({self._extra_path(step)})")
        state = self._load_payload(step)
        self._apply(ffmodel, state["params"], state["opt_state"], state["iteration"])

    def restore(self, ffmodel, step: Optional[int] = None, require_extra: bool = False,
                check_topology: bool = True) -> int:
        """Restore this rank's shard at the newest manifested intact step
        (or exactly ``step``). A manifest of another topology raises
        :class:`CheckpointTopologyError` (use :meth:`restore_elastic`)."""
        cm = ffmodel.compiled
        if cm is None:
            raise RuntimeError("compile() before restoring")
        self._join_pending()
        cur = topology_signature(cm.device, self.world, cm.mesh)

        def verify(man: Dict, s: int) -> None:
            if check_topology and not topology_matches(man.get("topology"), cur):
                raise CheckpointTopologyError(
                    f"manifest step {s} under {self.directory} was written for topology "
                    f"{man.get('topology')} (process_count {man.get('process_count')}), "
                    f"but this cohort runs {cur}; refusing to restore a mismatched shard "
                    f"layout (set config.elastic_resume for a portable restore)",
                    expected=cur, found=man.get("topology"))

        if step is not None:
            with open(self._manifest_path(step)) as f:
                verify(json.load(f), step)
            self._restore_shard(ffmodel, step, require_extra)
            return step
        items = self._intact_manifests()
        if not items:
            raise FileNotFoundError(f"no intact manifest under {self.directory}")
        verify(items[0][1], items[0][0])  # the cohort's topology, before any payload
        last_err: Optional[BaseException] = None
        for s, man in items:
            try:
                verify(man, s)
                self._restore_shard(ffmodel, s, require_extra)
                return s
            except CheckpointTopologyError:
                raise
            except Exception as e:  # noqa: BLE001 (a torn shard demotes its step)
                last_err = e
                metrics_registry().counter("checkpoint.corrupt_fallbacks").inc()
                print(f"[checkpoint] shard step {s} is not intact ({type(e).__name__}: {e}); "
                      f"falling back to the next-newest manifest", file=sys.stderr, flush=True)
        raise RuntimeError(f"no intact shard checkpoint under {self.directory} "
                           f"(tried {[s for s, _ in items]})") from last_err

    def _elastic_state(self, ffmodel, step: int, ranks: List[int]) -> tuple:
        """(params, optimizer state, iteration) of ``step`` for this rank
        of the current topology: each tensor is this rank's block of the
        whole array (by its mesh coordinates along every sharded axis, a
        ZeRO-1 share cut again along ``data``), copied from every saved
        shard that held a part of it; a pipeline stage's optimizer state
        only from the shards whose stage owns the op."""
        payloads = {r: self._load_payload(step, r) for r in ranks}
        own = payloads.get(self.rank, payloads[ranks[0]])
        cm = ffmodel.compiled

        def rebuild(tree: str, live: Any) -> Any:
            regions = _regions(cm, live, share=tree == "opt_state")

            def walk(node: Any, path: tuple) -> Any:
                if isinstance(node, dict):
                    return {k: walk(v, path + (k,)) for k, v in node.items()}
                key = "/".join(map(str, path))
                if key not in regions:  # a scalar (Adam's step count)
                    return _leaf(own[tree], path)
                shards = [(p["regions"][tree], _leaf(p[tree], path)) for p in payloads.values()
                          if tree == "params" or p["owned_ops"] is None
                          or path[-2] in p["owned_ops"]]
                return _assemble(key, *regions[key], node, shards)

            return walk(live, ())

        return (rebuild("params", cm.params), rebuild("opt_state", cm.opt_state),
                int(own["iteration"]))

    def restore_elastic(self, ffmodel) -> int:
        """The counted restore onto another topology (a shrunk or grown
        world, another mesh): see :meth:`_elastic_state`; counted on
        ``checkpoint.elastic_resumes``."""
        self._join_pending()
        items = self._intact_manifests()
        if not items:
            raise FileNotFoundError(f"no intact manifest under {self.directory}")
        last_err: Optional[BaseException] = None
        for s, man in items:
            try:
                if self._load_extra(s) is None and self._load_extra(s, 0) is None:
                    raise ValueError(f"step {s} has no resume sidecar")
                ranks = list(man.get("ranks") or range(int(man.get("process_count", 1))))
                self._apply(ffmodel, *self._elastic_state(ffmodel, s, ranks))
                metrics_registry().counter("checkpoint.elastic_resumes").inc()
                print(f"[checkpoint] elastic resume: restored step {s} under the new "
                      f"topology", file=sys.stderr, flush=True)
                return s
            except CheckpointTopologyError:
                raise
            except Exception as e:  # noqa: BLE001 (a torn shard demotes its step)
                last_err = e
                metrics_registry().counter("checkpoint.corrupt_fallbacks").inc()
        raise RuntimeError(f"no intact shard checkpoint under {self.directory} for an "
                           f"elastic restore (tried {[s for s, _ in items]})") from last_err

    def close(self) -> None:
        self._join_pending()


def save_checkpoint(ffmodel, path: str, step: int = 0) -> None:
    """One-shot save (``FFModel.save_checkpoint``)."""
    CheckpointManager(path, max_to_keep=None).save(ffmodel, step)


def load_checkpoint(ffmodel, path: str, step: Optional[int] = None) -> int:
    """One-shot restore (``FFModel.load_checkpoint``); returns the step."""
    return CheckpointManager(path, max_to_keep=None).restore(ffmodel, step)


__all__ = ["CheckpointManager", "CheckpointTopologyError", "MultiHostCheckpointManager",
           "is_multihost_dir", "load_checkpoint", "save_checkpoint", "topology_matches",
           "topology_signature"]
