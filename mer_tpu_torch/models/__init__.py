"""M2FNet fusion model, its layers and weight conversion."""

from mer_tpu_torch.models.convert import (
    adam_state_from_jax,
    load_reference_checkpoint,
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

__all__ = [
    "FusionAttentionModule", "M2FNet", "MultiheadAttention", "TransformerEncoder",
    "TransformerEncoderLayer", "adam_state_from_jax", "init_random_", "load_reference_checkpoint",
    "save_reference_checkpoint", "set_attention_generator", "state_dict_from_jax",
]
