"""Evaluation metrics with the reference's semantics (counterpart of
``mer_tpu/objectives/metrics.py``).

The reference computes sklearn ``accuracy_score`` and
``f1_score(average='weighted')`` on the -1-masked predictions of each batch
and averages **over batches** (src/test.py:51-74); pooled variants are kept
beside them. Pure numpy on host-side label vectors.
"""

from __future__ import annotations

import numpy as np


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    if y_true.size == 0:
        return 0.0
    return float((y_true == y_pred).mean())


def weighted_f1(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int = 7) -> float:
    """sklearn ``f1_score(average='weighted')`` parity: per-class F1 (0 where
    undefined) weighted by the class's support in ``y_true``."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    if y_true.size == 0:
        return 0.0
    f1s = np.zeros(num_classes, dtype=np.float64)
    support = np.zeros(num_classes, dtype=np.float64)
    for c in range(num_classes):
        tp = float(np.sum((y_pred == c) & (y_true == c)))
        fp = float(np.sum((y_pred == c) & (y_true != c)))
        fn = float(np.sum((y_pred != c) & (y_true == c)))
        denom = 2 * tp + fp + fn
        f1s[c] = (2 * tp / denom) if denom > 0 else 0.0
        support[c] = tp + fn
    total = support.sum()
    if total == 0:
        return 0.0
    return float((f1s * support).sum() / total)


class BatchAveragedMetrics:
    """The reference's per-batch-averaged accuracy and weighted F1, plus
    corpus-pooled variants."""

    def __init__(self, num_classes: int = 7):
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        self._acc_sum = 0.0
        self._f1_sum = 0.0
        self._batches = 0
        self._all_true: list[np.ndarray] = []
        self._all_pred: list[np.ndarray] = []

    def update(self, y_true: np.ndarray, y_pred: np.ndarray, mask: np.ndarray | None = None) -> None:
        """Add one batch; ``mask`` selects valid positions (default label != -1)."""
        y_true = np.asarray(y_true)
        y_pred = np.asarray(y_pred)
        if mask is None:
            mask = y_true != -1
        y_true = y_true[mask].ravel()
        y_pred = y_pred[mask].ravel()
        self._acc_sum += accuracy(y_true, y_pred)
        self._f1_sum += weighted_f1(y_true, y_pred, self.num_classes)
        self._batches += 1
        self._all_true.append(y_true)
        self._all_pred.append(y_pred)

    @property
    def batch_averaged_accuracy(self) -> float:
        return self._acc_sum / max(self._batches, 1)

    @property
    def batch_averaged_weighted_f1(self) -> float:
        return self._f1_sum / max(self._batches, 1)

    @property
    def pooled_accuracy(self) -> float:
        if not self._all_true:
            return 0.0
        return accuracy(np.concatenate(self._all_true), np.concatenate(self._all_pred))

    @property
    def pooled_weighted_f1(self) -> float:
        if not self._all_true:
            return 0.0
        return weighted_f1(np.concatenate(self._all_true), np.concatenate(self._all_pred), self.num_classes)

    def summary(self) -> dict[str, float]:
        return {
            "accuracy": self.batch_averaged_accuracy,
            "weighted_f1": self.batch_averaged_weighted_f1,
            "pooled_accuracy": self.pooled_accuracy,
            "pooled_weighted_f1": self.pooled_weighted_f1,
        }
