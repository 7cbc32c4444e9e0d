"""Fusion datasets and batching."""

from mer_tpu_torch.data.fusion import (
    DEFAULT_LENGTH_BUCKETS,
    DeviceFusionBatcher,
    FusionBatcher,
    FusionDataset,
    collate_dialogues,
    pick_bucket,
)
from mer_tpu_torch.data.synthetic import SyntheticFusionDataset, synthetic_dialogues

__all__ = [
    "DEFAULT_LENGTH_BUCKETS", "DeviceFusionBatcher", "FusionBatcher", "FusionDataset", "SyntheticFusionDataset",
    "collate_dialogues", "pick_bucket", "synthetic_dialogues",
]
