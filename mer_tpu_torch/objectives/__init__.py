"""Evaluation metrics."""

from mer_tpu_torch.objectives.metrics import BatchAveragedMetrics, accuracy, weighted_f1

__all__ = ["BatchAveragedMetrics", "accuracy", "weighted_f1"]
