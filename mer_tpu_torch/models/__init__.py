"""M2FNet fusion model, its layers, the ResNet18 mel extractor, the wav2vec2 and RoBERTa extractors and weight
conversion."""

from mer_tpu_torch.models.convert import (
    adam_state_from_jax,
    audio_state_dict_from_jax,
    load_reference_checkpoint,
    mel_state_dict_from_jax,
    save_reference_checkpoint,
    state_dict_from_jax,
    text_state_dict_from_jax,
)
from mer_tpu_torch.models.layers import (
    MultiheadAttention,
    TransformerEncoder,
    TransformerEncoderLayer,
    set_attention_generator,
)
from mer_tpu_torch.models.m2fnet import FusionAttentionModule, M2FNet, init_random_
from mer_tpu_torch.models.resnet import AudioMelFeatureExtractor, mel_extractor_from_seed
from mer_tpu_torch.models.roberta import RobertaConfig, RobertaModel, TextERC, text_erc_from_seed
from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config, Wav2Vec2Model, audio_erc_from_seed

__all__ = [
    "AudioERC", "AudioMelFeatureExtractor", "FusionAttentionModule", "M2FNet", "MultiheadAttention",
    "RobertaConfig", "RobertaModel", "TextERC", "TransformerEncoder", "TransformerEncoderLayer", "Wav2Vec2Config",
    "Wav2Vec2Model", "adam_state_from_jax", "audio_erc_from_seed", "audio_state_dict_from_jax", "init_random_",
    "load_reference_checkpoint", "mel_extractor_from_seed", "mel_state_dict_from_jax", "save_reference_checkpoint",
    "set_attention_generator", "state_dict_from_jax", "text_erc_from_seed", "text_state_dict_from_jax",
]
