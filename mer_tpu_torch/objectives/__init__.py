"""Training loss, class weights and evaluation metrics."""

from mer_tpu_torch.objectives.classification import balanced_class_weights, cross_entropy
from mer_tpu_torch.objectives.metrics import BatchAveragedMetrics, accuracy, weighted_f1

__all__ = ["BatchAveragedMetrics", "accuracy", "balanced_class_weights", "cross_entropy", "weighted_f1"]
