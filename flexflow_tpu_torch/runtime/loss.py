"""Loss functions.

PyTorch counterpart of ``flexflow_tpu/runtime/loss.py``: the scalar loss
(mean over the batch) of the final op's output, whose gradient autograd
takes. ``mask_padding`` (bucketed sequences) masks ``-1`` positions out
of token-level sparse cross-entropy.

With the logits' class dim cut over a mesh axis (a :class:`ClassShard`),
every sum over the classes runs on this rank's block and is all-reduced
over the axis's group (``reduce_from``: its backward is the identity, so
each rank's block gets the whole row's gradient): the log-softmax takes
the row max and the sum of exponentials over the group, the picked logit
comes from the rank that owns the label, and every rank of the group
holds the same per-row loss.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.machine import Group
from ..ffconst import LossType
from ..ops.embedding import _take_index
from ..parallel import collectives as C


@dataclasses.dataclass(frozen=True)
class ClassShard:
    """The logits' class dim cut over ``group``: this rank holds classes
    ``[offset, offset + local)`` of ``size``."""

    group: Group
    offset: int
    size: int


def class_sum(x: torch.Tensor, shard: Optional[ClassShard]) -> torch.Tensor:
    """The sum over the last (class) dim of the whole row."""
    s = x.sum(dim=-1)
    return s if shard is None else C.reduce_from(s, shard.group)


def _sharded_lse(logits: torch.Tensor, shard: ClassShard) -> torch.Tensor:
    """log Σ exp over the whole row: the row max over the group (a
    constant for autograd) and the blocks' sums of exponentials."""
    m = C.all_reduce_max(logits.detach().amax(dim=-1), shard.group)
    return m + torch.log(class_sum(torch.exp(logits - m[..., None]), shard))


def sharded_label_log_probs(logits: torch.Tensor, labels: torch.Tensor, from_logits: bool,
                            shard: ClassShard) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log p at each label, which labels are in range) for class-sharded
    ``logits`` and labels of their leading shape: the label wraps and
    validates against the whole class count (C8's rule); the rank that
    owns it gives its logit, the others 0."""
    idx, valid = _take_index(labels, shard.size)
    local = idx - shard.offset
    n = logits.shape[-1]
    own = (local >= 0) & (local < n)
    src = logits if from_logits else torch.log(torch.clamp(logits, 1e-10, 1.0))
    got = src.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    picked = C.reduce_from(torch.where(own, got, torch.zeros_like(got)), shard.group)
    if from_logits:
        picked = picked - _sharded_lse(logits, shard)
    return picked, valid


def sharded_row_cce(logits: torch.Tensor, labels: torch.Tensor, from_logits: bool,
                    shard: ClassShard) -> torch.Tensor:
    """Each row's -Σ labels·log p over class-sharded ``logits`` and
    labels: with logits, Σ y·z - lse·Σ y, so the normalizer's gradient
    sees every rank's labels."""
    if not from_logits:
        return -class_sum(labels * torch.log(torch.clamp(logits, 1e-10, 1.0)), shard)
    return _sharded_lse(logits, shard) * class_sum(labels, shard) \
        - class_sum(labels * logits, shard)


def _sharded_loss(loss_type: LossType, logits: torch.Tensor, labels: torch.Tensor,
                  from_logits: bool, mask_padding: bool, shard: ClassShard) -> torch.Tensor:
    """:func:`compute_loss` over class-sharded logits: the same value on
    every rank of the class group."""
    if loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        if mask_padding and logits.dim() >= 3:
            lab = labels.reshape(logits.shape[:-1])
            valid = lab >= 0
            ll, in_range = sharded_label_log_probs(
                logits, torch.where(valid, lab, torch.zeros_like(lab)), from_logits, shard)
            ll = torch.where(in_range, ll, torch.nan)
            row = torch.where(valid, ll, torch.zeros_like(ll)).sum(dim=-1)
            return -row.sum() / valid.sum().clamp(min=1).to(row.dtype)
        if logits.dim() >= 3:
            logits = logits.reshape(-1, logits.shape[-1])
            labels = labels.reshape(-1)
        else:
            labels = labels.reshape(labels.shape[0], -1)[:, 0]
        ll, valid = sharded_label_log_probs(logits, labels, from_logits, shard)
        return -torch.where(valid, ll, torch.nan).mean()
    if loss_type is LossType.CATEGORICAL_CROSSENTROPY:
        return torch.mean(sharded_row_cce(logits, labels, from_logits, shard))
    if loss_type is LossType.MEAN_SQUARED_ERROR_AVG_REDUCE:
        return torch.mean(class_sum((logits - labels) ** 2, shard)) / shard.size
    if loss_type is LossType.MEAN_SQUARED_ERROR_SUM_REDUCE:
        return torch.mean(class_sum((logits - labels) ** 2, shard))
    if loss_type is LossType.IDENTITY:
        return torch.mean(class_sum(logits, shard)) / shard.size
    raise ValueError(loss_type)


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


def masked_token_log_probs(logp: torch.Tensor, labels: torch.Tensor):
    """(per-position log-probability with ``-1`` positions exactly 0,
    valid mask) for (..., V) ``logp`` and labels of its leading shape.
    The index is replaced before the gather and the value after it, so a
    padded position carries an exact zero (and no gradient) where
    :func:`pick_log_prob` would give it a NaN; a label past the vocab
    still gives NaN, as in the JAX package."""
    lab = labels.reshape(logp.shape[:-1])
    valid = lab >= 0
    idx, in_range = _take_index(torch.where(valid, lab, torch.zeros_like(lab)),
                                logp.shape[-1])
    ll = torch.where(in_range, logp.gather(-1, idx[..., None])[..., 0], torch.nan)
    return torch.where(valid, ll, torch.zeros_like(ll)), valid


def compute_loss(loss_type: LossType, logits: torch.Tensor,
                 labels: torch.Tensor, from_logits: bool = False,
                 mask_padding: bool = False,
                 shard: Optional[ClassShard] = None) -> torch.Tensor:
    """Return the scalar loss (mean over the batch). ``from_logits`` is
    True when the graph does not end in a softmax (the compiler decides).

    ``mask_padding`` (token-level sparse CE; on when ``seq_buckets`` is):
    ``-1`` positions contribute an exact zero, the sum runs per row first
    and then across rows, and the mean divides by the valid-token count,
    as in the JAX package.

    ``shard``: the logits' class dim is cut over a mesh axis; the loss is
    the whole rows' on every rank of its group."""
    if shard is not None:
        return _sharded_loss(loss_type, logits, labels, from_logits, mask_padding, shard)
    if loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        if mask_padding and logits.dim() >= 3:
            ll, valid = masked_token_log_probs(log_probs(logits, from_logits), labels)
            row = ll.sum(dim=-1)
            n = valid.sum().clamp(min=1).to(row.dtype)
            return -row.sum() / n
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
