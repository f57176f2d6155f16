"""Failure detection and recovery for training.

PyTorch counterpart of ``flexflow_tpu/runtime/guard.py``. Divergence
usually shows as a non-finite loss (bf16 overflow, an lr spike, a bad
batch), and the cheapest recovery is a rollback and a smaller step, not a
restart. :class:`TrainingGuard` keeps a host (CPU) copy of the params and
the optimizer state from the last healthy point; when ``fit`` sees a
non-finite epoch loss sum it copies the snapshot back into the live
tensors, bumps the params version (so the serving bf16 cast cache does not
serve the diverged weights) and scales the learning rate by
``lr_backoff``, which the next step reads. After ``max_restores``
consecutive failures ``fit`` raises :class:`DivergenceError`.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch


class DivergenceError(RuntimeError):
    """Training produced a non-finite loss beyond the guard's restore budget."""


def to_host(tree: Any) -> Any:
    """A CPU copy of a tree of dicts, lists and tensors (other leaves as
    they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def load_into(live: Any, host: Any) -> Any:
    """Copy a host tree into the live one in place (tensors keep their
    identity, device and dtype; other leaves are replaced); returns the
    live tree. The structures must match."""
    if isinstance(live, torch.Tensor):
        if tuple(live.shape) != tuple(host.shape):
            raise ValueError(f"shape {tuple(host.shape)} vs live {tuple(live.shape)}")
        with torch.no_grad():
            live.copy_(host)
        return live
    if isinstance(live, dict):
        if set(live) != set(host):
            raise ValueError(f"keys {sorted(host)} vs live {sorted(live)}")
        for k in live:
            live[k] = load_into(live[k], host[k])
        return live
    if isinstance(live, list):
        live[:] = [load_into(a, b) for a, b in zip(live, host)]
        return live
    if isinstance(live, tuple):
        return tuple(load_into(a, b) for a, b in zip(live, host))
    return host


class TrainingGuard:
    def __init__(self, max_restores: int = 3, lr_backoff: float = 0.5):
        self.max_restores = int(max_restores)
        self.lr_backoff = float(lr_backoff)
        self.restores_used = 0
        self._snap: Optional[Tuple[Any, Any]] = None
        # recovery narrative: one entry per snapshot/restore (counts, not
        # payloads), bounded as in the reference
        self.events: List[dict] = []
        self._snapshots_total = 0
        self._restores_total = 0

    # ---- snapshot ----------------------------------------------------------
    def snapshot(self, ff, scope: str = "epoch") -> None:
        """Record the current (healthy) params and optimizer state on the
        host. ``scope``: "epoch", "interval" (fit's checkpoint interval)
        or "init"."""
        cm = ff.compiled
        self._snap = (to_host(cm.params), to_host(cm.opt_state))
        self.restores_used = 0  # a healthy snapshot resets the budget
        self._snapshots_total += 1
        self._log({"kind": "snapshot", "scope": scope,
                   "step": int(cm.resume_state()["iteration"])})

    def ensure_snapshot(self, ff) -> None:
        """The first snapshot, before any step, so a first-epoch
        divergence rolls back to the initial weights."""
        if self._snap is None:
            self.snapshot(ff, scope="init")

    # ---- resume and reporting ------------------------------------------------
    _EVENTS_KEPT = 256
    _EVENTS_SERIALIZED = 64

    def _log(self, event: dict) -> None:
        self.events.append(event)
        if len(self.events) > self._EVENTS_KEPT:
            del self.events[:len(self.events) - self._EVENTS_KEPT]

    def state(self) -> dict:
        """JSON-scalar resume state (the checkpoint sidecar): exact totals
        and the newest events. Neither the snapshot nor ``restores_used``
        is saved: a checkpoint is only written right after a healthy
        snapshot, which resets the budget, and a resumed fit snapshots the
        restored params again."""
        return {"snapshots_total": int(self._snapshots_total),
                "restores_total": int(self._restores_total),
                "events": [dict(e) for e in self.events[-self._EVENTS_SERIALIZED:]]}

    def load_state(self, state: Optional[dict]) -> None:
        if not state:
            return
        self._snapshots_total = int(state.get("snapshots_total", 0))
        self._restores_total = int(state.get("restores_total", 0))
        self.events = [dict(e) for e in state.get("events") or []]

    def report(self) -> dict:
        """The ``fit_profile["guard"]`` block."""
        return {
            "max_restores": self.max_restores,
            "lr_backoff": self.lr_backoff,
            "restores_used": self.restores_used,
            "snapshots": self._snapshots_total,
            "restores": self._restores_total,
            "events": [dict(e) for e in self.events[-32:]],
        }

    # ---- recovery ----------------------------------------------------------
    def recover(self, ff, verbose: bool = True) -> bool:
        """Roll back to the last snapshot and back off the learning rate.
        False (the caller raises) when there is no snapshot or the budget
        is spent."""
        if self._snap is None or self.restores_used >= self.max_restores:
            return False
        cm = ff.compiled
        cm.params = load_into(cm.params, self._snap[0])
        cm.opt_state = load_into(cm.opt_state, self._snap[1])
        cm.bump_params_version()  # derived caches must not serve the
        #                           diverged weights they were cast from
        self.restores_used += 1
        self._restores_total += 1
        self._log({
            "kind": "restore",
            "restores_used": int(self.restores_used),
            "step": int(cm.resume_state()["iteration"]),
            "lr_backoff": self.lr_backoff if self.lr_backoff != 1.0 else None,
        })
        opt = cm.optimizer
        if self.lr_backoff != 1.0 and opt is not None:
            for attr in ("lr", "alpha"):
                if hasattr(opt, attr):
                    setattr(opt, attr, getattr(opt, attr) * self.lr_backoff)
                    break
        if verbose:
            lr = getattr(opt, "lr", getattr(opt, "alpha", None))
            print(f"[guard] non-finite loss: rolled back to last healthy snapshot "
                  f"(restore {self.restores_used}/{self.max_restores}), lr -> {lr}",
                  flush=True)
        return True
