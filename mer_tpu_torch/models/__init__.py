"""M2FNet fusion model, its layers and weight conversion."""

from mer_tpu_torch.models.convert import (
    load_reference_checkpoint,
    save_reference_checkpoint,
    state_dict_from_jax,
)
from mer_tpu_torch.models.layers import MultiheadAttention, TransformerEncoder, TransformerEncoderLayer
from mer_tpu_torch.models.m2fnet import FusionAttentionModule, M2FNet, init_random_

__all__ = [
    "FusionAttentionModule", "M2FNet", "MultiheadAttention", "TransformerEncoder",
    "TransformerEncoderLayer", "init_random_", "load_reference_checkpoint",
    "save_reference_checkpoint", "state_dict_from_jax",
]
