"""Training metrics.

PyTorch counterpart of ``flexflow_tpu/runtime/metrics.py``: per-batch
metrics computed on the device from the final op's output, accumulated on
the device across an epoch and read back once at its end
(:meth:`PerfMetrics.flush`). The masked token-level path (``mask_padding``)
is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..ffconst import LossType, MetricsType
from .loss import log_probs, pick_log_prob

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


def compute_batch_metrics(metrics: List[MetricsType], loss_type: LossType,
                          logits: torch.Tensor, labels: torch.Tensor,
                          from_logits: bool = False) -> Dict[str, torch.Tensor]:
    """Per-batch metric sums, as device tensors. ``from_logits`` mirrors
    :func:`~flexflow_tpu_torch.runtime.loss.compute_loss`."""
    sparse = loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY
    if sparse and logits.dim() >= 3:
        # token-level metrics: positions flatten into the batch, as in
        # compute_loss's rank-3 path
        logits = logits.reshape(-1, logits.shape[-1])
        labels = labels.reshape(-1, 1)
    out: Dict[str, torch.Tensor] = {
        "count": torch.tensor(logits.shape[0], device=logits.device)}
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
