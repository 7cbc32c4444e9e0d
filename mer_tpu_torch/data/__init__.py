"""Fusion datasets and batching; the mel extractor's utterance dataset;
synthetic data."""

from mer_tpu_torch.data.fusion import (
    DEFAULT_LENGTH_BUCKETS,
    DeviceFusionBatcher,
    FusionBatcher,
    FusionDataset,
    collate_dialogues,
    pick_bucket,
)
from mer_tpu_torch.data.mel_fe import MelFeatureDataset
from mer_tpu_torch.data.synthetic import SyntheticFusionDataset, synthetic_dialogues, write_synthetic_meld

__all__ = [
    "DEFAULT_LENGTH_BUCKETS", "DeviceFusionBatcher", "FusionBatcher", "FusionDataset", "MelFeatureDataset",
    "SyntheticFusionDataset", "collate_dialogues", "pick_bucket", "synthetic_dialogues", "write_synthetic_meld",
]
