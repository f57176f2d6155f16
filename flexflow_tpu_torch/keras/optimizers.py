"""Keras-style optimizer shims, the PyTorch counterpart of
``flexflow_tpu/keras/optimizers.py`` (reference:
python/flexflow/keras/optimizers.py — SGD/Adam wrapping the FF
optimizers)."""

from __future__ import annotations

from ..runtime.optimizer import AdamOptimizer, SGDOptimizer


class SGD:
    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.ff_optimizer = SGDOptimizer(lr=learning_rate, momentum=momentum,
                                         nesterov=nesterov,
                                         weight_decay=weight_decay)


class Adam:
    def __init__(self, learning_rate: float = 0.001, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8):
        self.ff_optimizer = AdamOptimizer(alpha=learning_rate, beta1=beta_1,
                                          beta2=beta_2, epsilon=epsilon)


def resolve(opt):
    if isinstance(opt, (SGD, Adam)):
        return opt.ff_optimizer
    if isinstance(opt, str):
        return {"sgd": SGD(), "adam": Adam()}[opt.lower()].ff_optimizer
    return opt  # already an FF optimizer
