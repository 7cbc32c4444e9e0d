"""Attention op and the port's hand-written kernels."""

from mer_tpu_torch.ops.attention import dot_product_attention
from mer_tpu_torch.ops.flash_attention import flash_attention_forward, flash_attention_reference

__all__ = ["dot_product_attention", "flash_attention_forward", "flash_attention_reference"]
