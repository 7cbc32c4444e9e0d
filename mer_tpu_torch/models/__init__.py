"""M2FNet fusion model, its layers, the ResNet18 mel extractor and weight conversion."""

from mer_tpu_torch.models.convert import (
    adam_state_from_jax,
    load_reference_checkpoint,
    mel_state_dict_from_jax,
    save_reference_checkpoint,
    state_dict_from_jax,
)
from mer_tpu_torch.models.layers import (
    MultiheadAttention,
    TransformerEncoder,
    TransformerEncoderLayer,
    set_attention_generator,
)
from mer_tpu_torch.models.m2fnet import FusionAttentionModule, M2FNet, init_random_
from mer_tpu_torch.models.resnet import AudioMelFeatureExtractor, mel_extractor_from_seed

__all__ = [
    "AudioMelFeatureExtractor", "FusionAttentionModule", "M2FNet", "MultiheadAttention", "TransformerEncoder",
    "TransformerEncoderLayer", "adam_state_from_jax", "init_random_", "load_reference_checkpoint",
    "mel_extractor_from_seed", "mel_state_dict_from_jax", "save_reference_checkpoint", "set_attention_generator",
    "state_dict_from_jax",
]
