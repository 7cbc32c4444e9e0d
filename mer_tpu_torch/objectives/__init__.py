"""Training losses, class weights and evaluation metrics."""

from mer_tpu_torch.objectives.classification import balanced_class_weights, cross_entropy
from mer_tpu_torch.objectives.embedding import make_embedding_loss
from mer_tpu_torch.objectives.metrics import BatchAveragedMetrics, accuracy, weighted_f1

__all__ = ["BatchAveragedMetrics", "accuracy", "balanced_class_weights", "cross_entropy", "make_embedding_loss",
           "weighted_f1"]
