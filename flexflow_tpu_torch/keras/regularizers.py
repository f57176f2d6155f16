"""Keras-style weight regularizers.

PyTorch counterpart of ``flexflow_tpu/keras/regularizers.py``: a
regularizer is a function of the weight, and ``train_step`` adds its
penalty on the f32 master kernel to the training loss, so autograd gives
its gradient (``grad_step`` and ``eval_step`` add none, as in the JAX
package).
"""

from __future__ import annotations

import torch


class Regularizer:
    def penalty(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class L1(Regularizer):
    def __init__(self, l1: float = 0.01):
        self.l1 = float(l1)

    def penalty(self, w):
        return self.l1 * torch.sum(torch.abs(w))


class L2(Regularizer):
    def __init__(self, l2: float = 0.01):
        self.l2 = float(l2)

    def penalty(self, w):
        return self.l2 * torch.sum(torch.square(w))


class L1L2(Regularizer):
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = float(l1)
        self.l2 = float(l2)

    def penalty(self, w):
        return self.l1 * torch.sum(torch.abs(w)) + self.l2 * torch.sum(torch.square(w))
