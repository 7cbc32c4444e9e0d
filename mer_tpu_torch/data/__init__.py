"""Fusion datasets and batching; the mel and wav2vec2 extractors' utterance
datasets; synthetic data."""

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
from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, Wav2Vec2FeatureDataset

__all__ = [
    "DEFAULT_LENGTH_BUCKETS", "DeviceFusionBatcher", "FusionBatcher", "FusionDataset", "MelFeatureDataset",
    "SyntheticFusionDataset", "Wav2Vec2Batcher", "Wav2Vec2FeatureDataset", "collate_dialogues", "pick_bucket",
    "synthetic_dialogues", "write_synthetic_meld",
]
