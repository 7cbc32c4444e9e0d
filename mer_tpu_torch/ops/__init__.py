"""Attention op and the port's hand-written kernels (attention forward and
backward here; the log-mel kernel in ``logmel_kernel``, the wav2vec2 conv
frontend's in ``w2v_conv``)."""

from mer_tpu_torch.ops.attention import dot_product_attention
from mer_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_forward,
    flash_attention_reference,
)

__all__ = [
    "FlashAttention", "dot_product_attention", "flash_attention_backward", "flash_attention_backward_reference",
    "flash_attention_forward", "flash_attention_reference",
]
