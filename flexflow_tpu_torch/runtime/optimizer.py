"""Optimizers.

PyTorch counterpart of ``flexflow_tpu/runtime/optimizer.py``: SGD with
momentum/nesterov/weight decay and Adam, with the reference's update rules
and weight-decay placement. Params, grads, state and the weight-decay mask
are ``{op name: {weight name: ...}}`` trees, so state is keyed by name, not
by tensor identity.

Unlike the JAX package, whose update returns new arrays, :meth:`update`
changes the params and the state in place under ``torch.no_grad()`` (no
second copy of the weights) and returns the same trees. The update runs
as multi-tensor ``torch._foreach_*`` ops (a few launches a step, not a few
a weight), in the reference's formulas and f32 arithmetic. The step-size
hyperparameters reach it as 0-d f32 tensors on the params' device
(:meth:`Optimizer.device_hyper`, filled from the Python attributes by
:meth:`Optimizer.load_hyper` before each step) and Adam's step count
``t`` is a 0-d int32 tensor in its state (the JAX package's dtype),
advanced on the device and cast to f32 for the bias correction: a step
captured into a CUDA graph reads the current values at every replay, as
the JAX package passes them to its compiled step as dynamic arguments so
that a schedule takes effect without recompiling.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

Tree = Dict[str, Dict[str, Any]]


def _weights(params: Tree):
    """(op name, weight name, param) over every weight."""
    for op, ws in params.items():
        for w, p in ws.items():
            yield op, w, p


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A hyperparameter as a 0-d f32 tensor on ``like``'s device (a device
    tensor passes through)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def _decayed(ps: List[torch.Tensor], gs: List[torch.Tensor], decay: List[bool],
             wd: float) -> List[torch.Tensor]:
    """``g + wd * p`` for the weights ``decay`` marks, ``g`` elsewhere."""
    idx = [i for i, d in enumerate(decay) if d]
    if wd <= 0.0 or not idx:
        return gs
    out = list(gs)
    summed = torch._foreach_add([gs[i] for i in idx],
                                torch._foreach_mul([ps[i] for i in idx], wd))
    for i, g in zip(idx, summed):
        out[i] = g
    return out


class Optimizer:
    """Base class."""

    def init_state(self, params: Tree) -> Any:
        raise NotImplementedError

    def update(self, params: Tree, grads: Tree, state: Any, wd_mask: Tree,
               hyper: Optional[dict] = None) -> Tuple[Tree, Any]:
        """Apply one step in place; returns (params, state). ``wd_mask``
        marks the weights that get weight decay; ``hyper`` is
        :meth:`hyperparams` as the step read it, floats or 0-d device
        tensors (defaults to the current attributes)."""
        raise NotImplementedError

    def hyperparams(self) -> dict:
        """Step-size hyperparameters, read fresh at every step."""
        return {}

    def device_hyper(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The 0-d f32 tensors on ``device`` a step reads its
        hyperparameters from: one set a device, kept for the optimizer's
        life, so a captured step reads them at every replay."""
        cache = self.__dict__.setdefault("_device_hyper", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = {k: torch.zeros((), dtype=torch.float32, device=device)
                          for k in self.hyperparams()}
        return cache[key]

    def load_hyper(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """Fill :meth:`device_hyper` from the current attributes (on the
        current stream, before the step that reads them); returns it."""
        hyper = self.device_hyper(device)
        for k, v in self.hyperparams().items():
            hyper[k].fill_(float(v))
        return hyper


def _grad_lists(params: Tree, grads: Tree, wd_mask: Tree):
    ps, gs, decay = [], [], []
    for op, w, p in _weights(params):
        ps.append(p)
        gs.append(grads[op][w].to(p.dtype))
        decay.append(bool(wd_mask[op][w]))
    return ps, gs, decay


class SGDOptimizer(Optimizer):
    """SGD with momentum/nesterov (the reference's sgd_update: g = g + wd*w;
    v = m*v + g; w -= lr * (nesterov ? g + m*v : v))."""

    def __init__(self, ffmodel=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init_state(self, params: Tree) -> Tree:
        """Momentum buffers (none without momentum)."""
        if self.momentum == 0.0:
            return {}
        return {op: {w: torch.zeros_like(p) for w, p in ws.items()}
                for op, ws in params.items()}

    def hyperparams(self) -> dict:
        return {"lr": self.lr}

    @torch.no_grad()
    def update(self, params, grads, state, wd_mask, hyper=None):
        ps, gs, decay = _grad_lists(params, grads, wd_mask)
        if not ps:
            return params, state
        lr = _scalar((hyper or self.hyperparams())["lr"], ps[0])
        m = self.momentum
        gs = _decayed(ps, gs, decay, self.weight_decay)
        if m > 0.0:
            vs = [state[op][w] for op, w, _ in _weights(params)]
            torch._foreach_mul_(vs, m)
            torch._foreach_add_(vs, gs)
            steps = (torch._foreach_add(gs, torch._foreach_mul(vs, m))
                     if self.nesterov else vs)
        else:
            steps = gs
        torch._foreach_sub_(ps, torch._foreach_mul(steps, lr))
        return params, state


class AdamOptimizer(Optimizer):
    """Adam (the reference's adam_update: g = g + wd*w; m = b1*m + (1-b1)g;
    v = b2*v + (1-b2)g^2; w -= alpha_t * m / (sqrt(v) + eps), with the
    bias-corrected alpha_t = alpha * sqrt(1-b2^t) / (1-b1^t))."""

    def __init__(self, ffmodel=None, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8):
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon

    def init_state(self, params: Tree) -> dict:
        """The moments and the step count ``t``, a 0-d int32 tensor on the
        params' device (advanced by each update on the device)."""
        zeros = lambda: {op: {w: torch.zeros_like(p) for w, p in ws.items()}  # noqa: E731
                         for op, ws in params.items()}
        device = next((p.device for _, _, p in _weights(params)), torch.device("cpu"))
        return {"m": zeros(), "v": zeros(),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def hyperparams(self) -> dict:
        return {"alpha": self.alpha}

    @torch.no_grad()
    def update(self, params, grads, state, wd_mask, hyper=None):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        ps, gs, decay = _grad_lists(params, grads, wd_mask)
        state["t"].add_(1)
        if not ps:
            return params, state
        alpha = _scalar((hyper or self.hyperparams())["alpha"], ps[0])
        # in f32, as the JAX package computes it
        t = state["t"].to(torch.float32)
        alpha_t = alpha * torch.sqrt(1.0 - torch.pow(b2, t)) / (1.0 - torch.pow(b1, t))
        gs = _decayed(ps, gs, decay, self.weight_decay)
        ms = [state["m"][op][w] for op, w, _ in _weights(params)]
        vs = [state["v"][op][w] for op, w, _ in _weights(params)]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - b2))
        denom = torch._foreach_add(torch._foreach_sqrt(vs), eps)
        torch._foreach_sub_(ps, torch._foreach_div(torch._foreach_mul(ms, alpha_t), denom))
        return params, state
