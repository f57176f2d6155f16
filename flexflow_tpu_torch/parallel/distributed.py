"""The process group and a launcher for SPMD ranks.

The port runs one process per rank. A rank joins its group either under
``torchrun`` (the usual ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT`` variables; :func:`init_process_group` reads them) or
through :func:`spawn`, which starts the ranks itself with a file
rendezvous in a fresh temporary directory (no port to collide).

The backend follows from placement and nothing else: ``nccl`` when every
rank of this host has a card of its own (``torch.cuda.device_count() >=``
the local world size), ``gloo`` on the CPU and when ranks share a card.
On a gloo group every CUDA tensor a collective moves goes through a host
buffer (``parallel/collectives.py``, which counts the bytes). A backend
that fails to start raises: no code retries with another one.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, Optional

import torch

# a collective that waits longer than this on a peer raises
TIMEOUT_S = 300


def choose_backend(local_world_size: int) -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def init_process_group(rank: Optional[int] = None, world_size: Optional[int] = None,
                       init_method: str = "env://",
                       local_world_size: Optional[int] = None,
                       backend: Optional[str] = None,
                       timeout_s: float = TIMEOUT_S) -> str:
    """Join the default process group with the backend placement picks
    (or ``backend``, when the caller placed the ranks itself); returns the
    backend. Without arguments it reads torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). Under ``nccl``
    the rank's current card is its local rank. A collective that waits
    longer than ``timeout_s`` on a peer raises."""
    import torch.distributed as dist

    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world_size))
    backend = backend or choose_backend(local_world_size)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def backend() -> Optional[str]:
    """The default group's backend; None without a group."""
    import torch.distributed as dist

    return dist.get_backend() if dist.is_initialized() else None


def _worker(fn: Callable, rank: int, world_size: int, init_file: str, results,
            args: tuple) -> None:
    if not torch.cuda.is_available():
        torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        init_process_group(rank, world_size, f"file://{init_file}", world_size)
        out = fn(rank, world_size, *args)
        # every rank is done with every collective before any leaves
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))
    results.close()
    results.join_thread()  # the result is written before the process ends
    # a finished rank skips the interpreter's teardown, where the process
    # group's C++ threads were seen to abort (SIGABRT) under load
    os._exit(0)


def spawn(fn: Callable, world_size: int, *args: Any, timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    (the ``spawn`` start method), each a rank of one process group, and
    return their results in rank order. ``fn`` and ``args`` are pickled:
    ``fn`` must be importable by name. The first rank to raise stops every
    rank and raises here with its traceback; so does a run past
    ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ff_rendezvous_")
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, r, world_size, os.path.join(tmp, "init"), results, args))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        out: List[Any] = [None] * world_size
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
        pending = set(range(world_size))
        while pending:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, value = results.get(timeout=max(0.1, min(left, 5.0)))
            except queue.Empty:
                dead = [r for r in pending if procs[r].exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                if left <= 0:
                    raise TimeoutError(f"spawn: ranks {sorted(pending)} gave no result "
                                       f"in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with code {p.exitcode}")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
