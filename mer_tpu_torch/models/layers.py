"""Transformer blocks in the reference's torch ``state_dict`` layout.

Counterpart of ``mer_tpu/models/layers.py``. Parameter names follow
``torch.nn.MultiheadAttention`` / ``nn.TransformerEncoderLayer`` /
``nn.TransformerEncoder`` (reference src/model.py:8,61,73), so reference
checkpoints load with ``strict=True``; the attention itself goes through
:func:`mer_tpu_torch.ops.attention.dot_product_attention`, and with it
through the hand-written kernels on the card. Batch-first [B, S, D].

In train mode attention dropout draws its seed words from the host
``torch.Generator`` that :func:`set_attention_generator` hands every
:class:`MultiheadAttention`; dropout elsewhere is stock ``nn.Dropout``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mer_tpu_torch.ops.attention import dot_product_attention


class MultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention`` parity (batch_first): packed
    ``in_proj_weight`` [3D, D] / ``in_proj_bias`` [3D] and ``out_proj``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.generator: torch.Generator | None = None  # attention-dropout seeds (train mode)

    def _heads(self, x: torch.Tensor, which: int) -> torch.Tensor:
        d = self.embed_dim
        w = self.in_proj_weight[which * d : (which + 1) * d]
        b = self.in_proj_bias[which * d : (which + 1) * d]
        bsz, s, _ = x.shape
        y = F.linear(x, w, b).view(bsz, s, self.num_heads, d // self.num_heads)
        return y.transpose(1, 2).contiguous()  # [B, H, S, Dh]

    def forward(self, query, key, value, key_padding_mask=None):
        bsz, sq, _ = query.shape
        out = dot_product_attention(
            self._heads(query, 0), self._heads(key, 1), self._heads(value, 2),
            key_padding_mask=key_padding_mask,
            dropout_rate=self.dropout if self.training else 0.0,
            generator=self.generator,
        )
        return self.out_proj(out.transpose(1, 2).reshape(bsz, sq, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Post-LN ``nn.TransformerEncoderLayer`` parity (ReLU, d_ff 2048, eps 1e-5):
    ``x = norm1(x + drop(attn(x)))``, ``x = norm2(x + drop(ffn(x)))``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, layer_norm_eps: float = 1e-5):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dropout=dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.dropout = nn.Dropout(dropout)

    def forward(self, src, src_key_padding_mask=None):
        attn = self.self_attn(src, src, src, key_padding_mask=src_key_padding_mask)
        x = self.norm1(src + self.dropout(attn))
        h = self.linear2(self.dropout(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout(h))


class TransformerEncoder(nn.Module):
    """``nn.TransformerEncoder`` parity: ``layers.{i}`` plus the final
    LayerNorm ``norm`` the reference passes (src/model.py:62,74)."""

    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, layer_norm_eps: float = 1e-5):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout, layer_norm_eps)
            for _ in range(num_layers)
        )
        self.norm = nn.LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, src, src_key_padding_mask=None):
        x = src
        for layer in self.layers:
            x = layer(x, src_key_padding_mask=src_key_padding_mask)
        return self.norm(x)


def set_attention_generator(model: nn.Module, generator: torch.Generator | None) -> None:
    """Give every :class:`MultiheadAttention` of ``model`` the host generator
    its train-mode attention dropout draws seed words from."""
    for module in model.modules():
        if isinstance(module, MultiheadAttention):
            module.generator = generator
