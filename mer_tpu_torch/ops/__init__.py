"""Attention op and the port's hand-written kernels (the attention forwards
K1, K3 and backwards K2, K4 here; the log-mel kernel in ``logmel_kernel``, the
wav2vec2 conv frontend's in ``w2v_conv``, its positional conv's K9 in
``pos_conv``)."""

from mer_tpu_torch.ops.attention import dot_product_attention
from mer_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_forward,
    flash_attention_fused_backward,
    flash_attention_reference,
    flash_attention_stream,
    flash_attention_stream_reference,
    flash_attention_tiled_backward,
    flash_attention_tiled_backward_reference,
)

__all__ = [
    "FlashAttention", "dot_product_attention", "flash_attention_backward", "flash_attention_backward_reference",
    "flash_attention_forward", "flash_attention_fused_backward", "flash_attention_reference", "flash_attention_stream",
    "flash_attention_stream_reference", "flash_attention_tiled_backward", "flash_attention_tiled_backward_reference",
]
