"""Offline batch inference and the online micro-batching server."""

from mer_tpu_torch.serving.offline import BatchedPredictor, recollate_batches, split_recollated
from mer_tpu_torch.serving.online import DEFAULT_BATCH_BUCKETS, OnlineServer, ServerStats

__all__ = [
    "BatchedPredictor", "DEFAULT_BATCH_BUCKETS", "OnlineServer", "ServerStats",
    "recollate_batches", "split_recollated",
]
