"""Training metrics.

PyTorch counterpart of ``flexflow_tpu/runtime/metrics.py``: per-batch
metrics computed on the device from the final op's output, accumulated on
the device across an epoch and read back once at its end
(:meth:`PerfMetrics.flush`). ``mask_padding`` drops ``-1`` positions out of
the token-level sparse metrics, as the loss does. Over class-sharded
logits (a :class:`~flexflow_tpu_torch.runtime.loss.ClassShard`) every sum
over the classes is the whole row's, and the accuracy's argmax is the
whole row's with ``torch.argmax``'s rule (the first maximum, a NaN
before any number).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..ffconst import LossType, MetricsType
from ..parallel import collectives as C
from .loss import (ClassShard, class_sum, log_probs, masked_token_log_probs, pick_log_prob,
                   sharded_label_log_probs, sharded_row_cce)

_SUMS = ("cce_loss", "sparse_cce_loss", "mse_loss", "rmse_loss", "mae_loss")


@dataclasses.dataclass
class PerfMetrics:
    """Accumulated metrics (the reference's PerfMetrics)."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0
    # per-batch sums parked on the device until flush()
    _pending: Optional[Dict[str, torch.Tensor]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def update(self, batch: Dict[str, float]) -> None:
        self.train_all += int(batch.get("count", 0))
        self.train_correct += int(batch.get("correct", 0))
        for k in _SUMS:
            if k in batch:
                setattr(self, k, getattr(self, k) + float(batch[k]))

    def accumulate(self, batch: Dict[str, torch.Tensor]) -> None:
        """Add one batch's metrics to the device-side sums (no host sync);
        keys present in only one side survive."""
        acc = self._pending
        if acc is None:
            self._pending = dict(batch)
            return
        for k, v in batch.items():
            acc[k] = acc[k] + v if k in acc else v

    @property
    def pending(self) -> Optional[Dict[str, torch.Tensor]]:
        """The device-side sums not yet flushed (None: none)."""
        return self._pending

    @pending.setter
    def pending(self, sums: Optional[Dict[str, torch.Tensor]]) -> None:
        self._pending = sums

    def flush(self) -> None:
        """Fold the device-side sums into the host counters (one sync)."""
        if self._pending:
            self.update({k: v.item() for k, v in self._pending.items()})
        self._pending = None

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(1, self.train_all)

    def report(self, metrics: List[MetricsType]) -> str:
        n = max(1, self.train_all)
        parts = []
        if MetricsType.ACCURACY in metrics:
            parts.append(f"accuracy: {100.0 * self.accuracy:.2f}% "
                         f"({self.train_correct} / {self.train_all})")
        for mt, key, label in (
                (MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY, "sparse_cce_loss", "sparse_cce"),
                (MetricsType.CATEGORICAL_CROSSENTROPY, "cce_loss", "cce"),
                (MetricsType.MEAN_SQUARED_ERROR, "mse_loss", "mse"),
                (MetricsType.ROOT_MEAN_SQUARED_ERROR, "rmse_loss", "rmse"),
                (MetricsType.MEAN_ABSOLUTE_ERROR, "mae_loss", "mae")):
            if mt in metrics:
                parts.append(f"{label}: {getattr(self, key) / n:.4f}")
        return "  ".join(parts)


def class_argmax(x: torch.Tensor, shard: Optional[ClassShard]) -> torch.Tensor:
    """``torch.argmax(x, -1)`` of the whole row: over a class shard, each
    rank's first maximum and its global index, the best value (a NaN
    first) max-reduced, then the lowest index among the ranks holding it."""
    if shard is None:
        return torch.argmax(x, dim=-1)
    loc = torch.argmax(x, dim=-1)
    v = x.gather(-1, loc[..., None])[..., 0]
    nan = torch.isnan(v)
    best = C.all_reduce_max(torch.stack([nan.to(v.dtype),
                                         torch.where(nan, -torch.inf, v)]), shard.group)
    gidx = loc + shard.offset
    none = torch.full_like(gidx, shard.size)
    mine = torch.where(best[0] > 0, nan, ~nan & (v == best[1]))
    return C.all_reduce_min(torch.where(mine, gidx, none), shard.group)


def _sharded_batch_metrics(metrics: List[MetricsType], sparse: bool, logits: torch.Tensor,
                           labels: torch.Tensor, from_logits: bool, mask_padding: bool,
                           shard: ClassShard) -> Dict[str, torch.Tensor]:
    """:func:`compute_batch_metrics` over class-sharded logits: the whole
    rows' sums on every rank of the class group."""
    if sparse:
        lab = labels.reshape(logits.shape[:-1]) if logits.dim() >= 3 \
            else labels.reshape(labels.shape[0], -1)[:, 0]
        valid = lab >= 0 if mask_padding and logits.dim() >= 3 \
            else torch.ones_like(lab, dtype=torch.bool)
        out: Dict[str, torch.Tensor] = {"count": valid.sum()}
        if MetricsType.ACCURACY in metrics:
            pred = class_argmax(logits, shard)
            out["correct"] = torch.sum(valid & (pred == lab.to(pred.dtype)))
        if MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY in metrics:
            ll, in_range = sharded_label_log_probs(
                logits, torch.where(valid, lab, torch.zeros_like(lab)), from_logits, shard)
            ll = torch.where(in_range, ll, torch.nan)
            out["sparse_cce_loss"] = -torch.sum(torch.where(valid, ll, torch.zeros_like(ll)))
        return out
    out = {"count": torch.full((), logits.shape[0], dtype=torch.int64, device=logits.device)}
    if MetricsType.ACCURACY in metrics:
        out["correct"] = torch.sum(class_argmax(logits, shard) == class_argmax(labels, shard))
    if MetricsType.CATEGORICAL_CROSSENTROPY in metrics:
        out["cce_loss"] = torch.sum(sharded_row_cce(logits, labels, from_logits, shard))
    sq = class_sum((logits - labels) ** 2, shard) if (
        MetricsType.MEAN_SQUARED_ERROR in metrics
        or MetricsType.ROOT_MEAN_SQUARED_ERROR in metrics) else None
    if MetricsType.MEAN_SQUARED_ERROR in metrics:
        out["mse_loss"] = torch.sum(sq)
    if MetricsType.ROOT_MEAN_SQUARED_ERROR in metrics:
        out["rmse_loss"] = torch.sum(torch.sqrt(sq / shard.size))
    if MetricsType.MEAN_ABSOLUTE_ERROR in metrics:
        out["mae_loss"] = torch.sum(class_sum(torch.abs(logits - labels), shard))
    return out


def compute_batch_metrics(metrics: List[MetricsType], loss_type: LossType,
                          logits: torch.Tensor, labels: torch.Tensor,
                          from_logits: bool = False,
                          mask_padding: bool = False,
                          shard: Optional[ClassShard] = None) -> Dict[str, torch.Tensor]:
    """Per-batch metric sums, as device tensors. ``from_logits``,
    ``mask_padding`` and ``shard`` mirror
    :func:`~flexflow_tpu_torch.runtime.loss.compute_loss`: masked, ``-1``
    positions drop out of the count, the correct count and the CE sum,
    each summed per row first."""
    sparse = loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY
    if shard is not None:
        return _sharded_batch_metrics(metrics, sparse, logits, labels, from_logits,
                                      mask_padding, shard)
    if sparse and logits.dim() >= 3 and mask_padding:
        lab = labels.reshape(logits.shape[:-1])
        valid = lab >= 0
        out: Dict[str, torch.Tensor] = {"count": valid.sum()}
        if MetricsType.ACCURACY in metrics:
            pred = torch.argmax(logits, dim=-1)
            out["correct"] = torch.sum(torch.sum(valid & (pred == lab), dim=-1))
        if MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY in metrics:
            ll, _ = masked_token_log_probs(log_probs(logits, from_logits), labels)
            out["sparse_cce_loss"] = -torch.sum(torch.sum(ll, dim=-1))
        return out
    if sparse and logits.dim() >= 3:
        # token-level metrics: positions flatten into the batch, as in
        # compute_loss's rank-3 path
        logits = logits.reshape(-1, logits.shape[-1])
        labels = labels.reshape(-1, 1)
    out: Dict[str, torch.Tensor] = {
        "count": torch.full((), logits.shape[0], dtype=torch.int64, device=logits.device)}
    if MetricsType.ACCURACY in metrics:
        pred = torch.argmax(logits, dim=-1)
        if sparse:
            true = labels.reshape(labels.shape[0], -1)[:, 0].to(pred.dtype)
        else:
            true = torch.argmax(labels, dim=-1)
        out["correct"] = torch.sum(pred == true)
    if MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY in metrics and sparse:
        lab = labels.reshape(labels.shape[0], -1)[:, 0]
        out["sparse_cce_loss"] = -torch.sum(
            pick_log_prob(log_probs(logits, from_logits), lab))
    if MetricsType.CATEGORICAL_CROSSENTROPY in metrics and not sparse:
        out["cce_loss"] = -torch.sum(labels * log_probs(logits, from_logits))
    if MetricsType.MEAN_SQUARED_ERROR in metrics:
        out["mse_loss"] = torch.sum((logits - labels) ** 2)
    if MetricsType.ROOT_MEAN_SQUARED_ERROR in metrics:
        # per-sample RMSE summed over the batch
        out["rmse_loss"] = torch.sum(torch.sqrt(torch.mean((logits - labels) ** 2, dim=-1)))
    if MetricsType.MEAN_ABSOLUTE_ERROR in metrics:
        out["mae_loss"] = torch.sum(torch.abs(logits - labels))
    return out
