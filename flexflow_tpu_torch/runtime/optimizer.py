"""Optimizers.

PyTorch counterpart of ``flexflow_tpu/runtime/optimizer.py``: SGD with
momentum/nesterov/weight decay and Adam, with the reference's update rules
and weight-decay placement. Params, grads, state and the weight-decay mask
are ``{op name: {weight name: ...}}`` trees, so state is keyed by name, not
by tensor identity.

Unlike the JAX package, whose update returns new arrays, :meth:`update`
changes the params and the state in place under ``torch.no_grad()`` (no
second copy of the weights) and returns the same trees.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, Dict[str, Any]]


def _weights(params: Tree):
    """(op name, weight name, param) over every weight."""
    for op, ws in params.items():
        for w, p in ws.items():
            yield op, w, p


class Optimizer:
    """Base class."""

    def init_state(self, params: Tree) -> Any:
        raise NotImplementedError

    def update(self, params: Tree, grads: Tree, state: Any, wd_mask: Tree,
               hyper: Optional[dict] = None) -> Tuple[Tree, Any]:
        """Apply one step in place; returns (params, state). ``wd_mask``
        marks the weights that get weight decay; ``hyper`` is
        :meth:`hyperparams` as the step read it (defaults to the current
        attributes)."""
        raise NotImplementedError

    def hyperparams(self) -> dict:
        """Step-size hyperparameters, read fresh at every step."""
        return {}


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
        lr = (hyper or self.hyperparams())["lr"]
        m, wd = self.momentum, self.weight_decay
        for op, w, p in _weights(params):
            g = grads[op][w].to(p.dtype)
            if wd > 0.0 and wd_mask[op][w]:
                g = g + wd * p
            if m > 0.0:
                v = state[op][w]
                v.mul_(m).add_(g)
                step = g + m * v if self.nesterov else v
            else:
                step = g
            p.sub_(lr * step)
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
        zeros = lambda: {op: {w: torch.zeros_like(p) for w, p in ws.items()}  # noqa: E731
                         for op, ws in params.items()}
        return {"m": zeros(), "v": zeros(), "t": 0}

    def hyperparams(self) -> dict:
        return {"alpha": self.alpha}

    @torch.no_grad()
    def update(self, params, grads, state, wd_mask, hyper=None):
        b1, b2, wd, eps = self.beta1, self.beta2, self.weight_decay, self.epsilon
        alpha = (hyper or self.hyperparams())["alpha"]
        t = state["t"] + 1
        # in f32, as the JAX package computes it
        f32 = np.float32
        alpha_t = float(f32(alpha) * np.sqrt(f32(1.0) - f32(b2) ** f32(t))
                        / (f32(1.0) - f32(b1) ** f32(t)))
        for op, w, p in _weights(params):
            g = grads[op][w].to(p.dtype)
            m, v = state["m"][op][w], state["v"][op][w]
            if wd > 0.0 and wd_mask[op][w]:
                g = g + wd * p
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * (g * g))
            p.sub_(alpha_t * m / (torch.sqrt(v) + eps))
        state["t"] = t
        return params, state
