"""Scaled dot-product attention (counterpart of ``mer_tpu/ops/attention.py``).

Models call :func:`dot_product_attention` whatever the device; masking lives
here once. On a CUDA tensor it runs the hand-written kernel, on a CPU tensor
the kernel's plain version, which restates ``_attention_reference``: an
additive -1e30 bias on ignored keys, the scale applied to q before the
product, softmax in float32. There is no size threshold: on the card every
call goes through the kernel.
"""

from __future__ import annotations

from mer_tpu_torch.ops.flash_attention import flash_attention_forward


def dot_product_attention(q, k, v, *, key_padding_mask=None, dropout_rate: float = 0.0):
    """q [B, H, Sq, Dh], k/v [B, H, Sk, Dh]; ``key_padding_mask`` [B, Sk] bool,
    True = ignore (torch convention). Returns [B, H, Sq, Dh].

    Attention-probability dropout (training) is not part of the serving
    slice: any ``dropout_rate`` > 0 raises, on every device, rather than run
    without it."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout runs inside the kernel and arrives with the fusion "
            "training slice (slice 2); this port serves in eval mode only")
    out, _ = flash_attention_forward(q, k, v, key_padding_mask)
    return out
