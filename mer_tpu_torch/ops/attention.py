"""Scaled dot-product attention (counterpart of ``mer_tpu/ops/attention.py``).

Models call :func:`dot_product_attention` whatever the device; masking and
attention-probability dropout live here once. Every call goes through
:class:`~mer_tpu_torch.ops.flash_attention.FlashAttention`: on a CUDA tensor
the hand-written kernels (forward and backward), on a CPU tensor their plain
versions, which restate ``_attention_reference``: an additive -1e30 bias on
ignored keys, the scale applied to q before the product, softmax in float32.
No size sends a call to XLA-style plain code on the card: the key count only
picks the kernel, as ``mer_tpu``'s dispatch does. The forward runs K1 up to
4,096 keys and the streaming K3 above; the backward K2 up to 2,048 keys and
the key-tiled K4 above.
"""

from __future__ import annotations

import torch

from mer_tpu_torch.ops.flash_attention import FlashAttention


def draw_dropout_seed(generator: torch.Generator) -> tuple[int, int]:
    """Two 32-bit seed words from a host ``torch.Generator`` (no device sync)."""
    return tuple(torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64).tolist())


def dot_product_attention(q, k, v, *, key_padding_mask=None, dropout_rate: float = 0.0,
                          generator: torch.Generator | None = None):
    """q [B, H, Sq, Dh], k/v [B, H, Sk, Dh]; ``key_padding_mask`` [B, Sk] bool,
    True = ignore (torch convention). Returns [B, H, Sq, Dh], differentiable.

    ``dropout_rate`` > 0 drops normalised attention probabilities inside the
    kernels (torch MHA training semantics). Each such call draws its two seed
    words from ``generator``, which is required: the global RNG is never used
    for attention dropout."""
    seed = None
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout draws its seed from an explicit torch.Generator; "
                             "pass generator= (models: set_attention_generator)")
        seed = draw_dropout_seed(generator)
    out, _ = FlashAttention.apply(q, k, v, key_padding_mask, seed, float(dropout_rate))
    return out
