"""Fusion datasets and batching; the mel, wav2vec2 and text extractors'
utterance datasets; synthetic data."""

from mer_tpu_torch.data.fusion import (
    DEFAULT_LENGTH_BUCKETS,
    DeviceFusionBatcher,
    FusionBatcher,
    FusionDataset,
    collate_dialogues,
    pick_bucket,
)
from mer_tpu_torch.data.mel_fe import MelFeatureDataset
from mer_tpu_torch.data.process_sharding import local_num_batches, resolve_process, shard_batches
from mer_tpu_torch.data.synthetic import SyntheticFusionDataset, synthetic_dialogues, write_synthetic_meld
from mer_tpu_torch.data.text_fe import TextBatcher, TextFeatureDataset, ToyWhitespaceTokenizer
from mer_tpu_torch.data.wav2vec2_fe import Wav2Vec2Batcher, Wav2Vec2FeatureDataset

__all__ = [
    "DEFAULT_LENGTH_BUCKETS", "DeviceFusionBatcher", "FusionBatcher", "FusionDataset", "MelFeatureDataset",
    "SyntheticFusionDataset", "TextBatcher", "TextFeatureDataset", "ToyWhitespaceTokenizer", "Wav2Vec2Batcher", "Wav2Vec2FeatureDataset", "collate_dialogues", "pick_bucket",
    "local_num_batches", "resolve_process", "shard_batches", "synthetic_dialogues", "write_synthetic_meld",
]
