"""Loss functions.

PyTorch counterpart of ``flexflow_tpu/runtime/loss.py``: the scalar loss
(mean over the batch) of the final op's output, whose gradient autograd
takes. The masked token-level path (``mask_padding``, for bucketed
sequences) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ffconst import LossType
from ..ops.embedding import _take_index


def log_probs(logits: torch.Tensor, from_logits: bool) -> torch.Tensor:
    """Log-probabilities of the final op's output: raw logits get a fused
    log-softmax; a softmax-terminated graph's probabilities are clipped
    before the log, as in the reference."""
    if from_logits:
        return F.log_softmax(logits, dim=-1)
    return torch.log(torch.clamp(logits, 1e-10, 1.0))


def pick_log_prob(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logp[i, labels[i]]`` for (N, V) ``logp`` and (N,) ``labels``, as
    the reference's ``jnp.take_along_axis`` gives it: a label in [-V, 0)
    wraps from the end, one outside [-V, V) gives NaN. Nothing raises and
    no device-side assert fires; the invalid entries get no gradient."""
    idx, valid = _take_index(labels, logp.shape[-1])
    ll = logp.gather(-1, idx[:, None])[:, 0]
    return torch.where(valid, ll, torch.nan)


def compute_loss(loss_type: LossType, logits: torch.Tensor,
                 labels: torch.Tensor, from_logits: bool = False) -> torch.Tensor:
    """Return the scalar loss (mean over the batch). ``from_logits`` is
    True when the graph does not end in a softmax (the compiler decides)."""
    if loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        if logits.dim() >= 3:
            # token-level CE: one label per position, positions flatten
            # into the batch
            logits = logits.reshape(-1, logits.shape[-1])
            labels = labels.reshape(-1)
        else:
            labels = labels.reshape(labels.shape[0], -1)[:, 0]
        return -pick_log_prob(log_probs(logits, from_logits), labels).mean()
    if loss_type is LossType.CATEGORICAL_CROSSENTROPY:
        return -torch.mean(torch.sum(labels * log_probs(logits, from_logits), dim=-1))
    if loss_type is LossType.MEAN_SQUARED_ERROR_AVG_REDUCE:
        # mean over batch * features
        return torch.mean((logits - labels) ** 2)
    if loss_type is LossType.MEAN_SQUARED_ERROR_SUM_REDUCE:
        # sum over features, mean over the batch
        return torch.mean(torch.sum((logits - labels) ** 2, dim=-1))
    if loss_type is LossType.IDENTITY:
        return torch.mean(logits)
    raise ValueError(loss_type)


def loss_from_string(s: str) -> LossType:
    """The loss-type names the frontends accept."""
    m = {
        "categorical_crossentropy": LossType.CATEGORICAL_CROSSENTROPY,
        "sparse_categorical_crossentropy": LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        "mean_squared_error": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        "mse": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        "identity": LossType.IDENTITY,
    }
    return m[s]
