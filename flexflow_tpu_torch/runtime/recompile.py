"""Recompile on a condition.

The port's own copy of ``flexflow_tpu/runtime/recompile.py`` (the
reference's ``RecompileState`` and ``FFModel::recompile_on_condition``):
``trigger_func(state)`` runs between iterations of ``fit``; when it
returns True, ``alter_func(state)`` may change the layer graph or the
config, and the model compiles again, keeping every weight whose (op
name, weight name, shape) survives and the iteration counter. Each fire is
counted on ``recompile.triggers`` with a tracer instant.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..obs.metrics import metrics_registry
from ..obs.trace import tracer


class RecompileState:
    def __init__(self, trigger_func: Callable[["RecompileState"], bool],
                 alter_func: Callable[["RecompileState"], None], ffmodel,
                 check_interval: int = 1):
        self.trigger_func = trigger_func
        self.alter_func = alter_func
        self.ffmodel = ffmodel
        self.recompilations = 0
        # scratch for the trigger: fit feeds it the most recent step's loss
        # every ``check_interval`` iterations (the read syncs with the card)
        self.last_metric: Optional[float] = None
        self.iteration = 0
        self.check_interval = max(1, int(check_interval))

    def trigger(self) -> bool:
        return bool(self.trigger_func(self))

    def alter(self) -> None:
        self.alter_func(self)
        self.recompilations += 1


def recompile_on_condition(ffmodel, state: RecompileState) -> bool:
    """Evaluate the trigger; on a fire, alter and compile again, keeping
    the surviving weights. True when a recompilation happened."""
    state.iteration += 1
    if not state.trigger():
        return False
    metrics_registry().counter("recompile.triggers").inc()
    tracer().instant("recompile.trigger", cat="fit", iteration=state.iteration,
                     recompilations=state.recompilations)
    cm = ffmodel.compiled
    old_params = {}
    old_iteration = 0
    if cm is not None:
        old_params = {op: {w: t.detach().clone() for w, t in ws.items()}
                      for op, ws in cm.params.items()}
        old_iteration = cm.iteration
    state.alter()
    ffmodel.compile(optimizer=ffmodel.optimizer,
                    loss_type=cm.loss_type if cm is not None else None,
                    metrics=list(cm.metrics) if cm is not None else [])
    new_cm = ffmodel.compiled
    with torch.no_grad():
        for op_name, ws in new_cm.params.items():
            for wname, val in ws.items():
                old = old_params.get(op_name, {}).get(wname)
                if old is not None and old.shape == val.shape:
                    val.copy_(old.to(val.dtype))
    new_cm.iteration = old_iteration
    return True
