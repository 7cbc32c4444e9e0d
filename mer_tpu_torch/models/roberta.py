"""RoBERTa encoder + classification head, the stage-1a text feature extractor
(counterpart of ``mer_tpu/models/roberta.py``).

The reference fine-tunes Hugging Face's ``RobertaModel`` (no pooler) under a
``RobertaClassificationHead`` (text/model.py:9-22) and exports the [CLS] row
(text/embeddings.py:83). The ``state_dict`` of :class:`TextERC` carries Hugging
Face's key names (``roberta.embeddings.word_embeddings.weight``,
``roberta.encoder.layer.{i}.attention.self.query.weight``,
``classifier_head.dense.weight``, ...), so a ``RobertaModel`` checkpoint loads
into the backbone as it is, and ``mer_tpu``'s ``convert_hf_roberta(sd, cfg,
prefix="roberta.")`` and ``convert_hf_classification_head(sd,
prefix="classifier_head.")`` read the port's checkpoints.

Architecture (base): word + position + token-type embeddings -> LayerNorm ->
12 post-LN layers (12 heads of 64, exact GELU FFN 3072, eps 1e-5). Position ids
start at ``pad_token_id + 1`` and advance on non-pad tokens only. Attention
masks keys only (``attention_mask == 0``); a padded query's row is never read:
the head takes token 0, always real. The attention goes through
:func:`~mer_tpu_torch.ops.attention.dot_product_attention`, on the card kernels
K1 and K4 at Sq = Sk in {64, 128, 256, 512} and head dim 64. One encoder
layout, unrolled.

Dropout (train mode): ``hidden_dropout`` after the embeddings' LayerNorm, on
the attention output and on the feed-forward output of every layer, and twice
in the head (before ``dense`` and after the tanh); ``attention_dropout`` on the
attention probabilities inside the kernels, seeded from the generator
:func:`~mer_tpu_torch.models.layers.set_attention_generator` hands the
attentions.

Mixed precision as in ``mer_tpu`` (Flax ``dtype`` against ``param_dtype``): the
parameters stay float32 and ``dtype`` is the compute dtype. Embedding rows,
Linear operands and activations are cast to it; LayerNorm statistics and the
attention softmax are float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mer_tpu_torch.models.layers import SeededAttention
from mer_tpu_torch.models.wav2vec2 import _layer_norm, _linear
from mer_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    num_labels: int = 7

    @classmethod
    def base(cls) -> "RobertaConfig":
        return cls()

    @classmethod
    def large(cls) -> "RobertaConfig":
        return cls(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096)


def create_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """RoBERTa position ids: the running count of non-pad tokens, offset by the
    pad id; a pad token keeps the pad id."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class RobertaEmbeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.pad_token_id = cfg.pad_token_id
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = cfg.hidden_dropout

    def forward(self, input_ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        rows = lambda table, ids: F.embedding(ids, table.weight).to(dtype)
        hidden = (rows(self.word_embeddings, input_ids)
                  + rows(self.position_embeddings, create_position_ids(input_ids, self.pad_token_id))
                  + rows(self.token_type_embeddings, torch.zeros_like(input_ids)))
        return F.dropout(_layer_norm(hidden, self.LayerNorm, dtype), self.dropout, self.training)


class RobertaSelfAttention(SeededAttention):
    """``attention.self``: the query, key and value projections and the
    attention itself; returns [B, S, H] before the output projection."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.dropout = cfg.attention_dropout
        self.query, self.key, self.value = (nn.Linear(h, h) for _ in range(3))

    def forward(self, hidden: torch.Tensor, key_padding_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, s, h = hidden.shape

        def heads(layer):
            return _linear(hidden, layer, dtype).view(b, s, self.num_heads, h // self.num_heads) \
                .transpose(1, 2).contiguous()  # [B, H, S, Dh]

        out = dot_product_attention(heads(self.query), heads(self.key), heads(self.value),
                                    key_padding_mask=key_padding_mask,
                                    dropout_rate=self.dropout if self.training else 0.0, generator=self.generator)
        return out.transpose(1, 2).reshape(b, s, h)


class _DenseLayerNorm(nn.Module):
    """``attention.output`` and ``output``: ``LayerNorm(residual + drop(dense(x)))``."""

    def __init__(self, d_in: int, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = cfg.hidden_dropout

    def forward(self, x: torch.Tensor, residual: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = F.dropout(_linear(x, self.dense, dtype), self.dropout, self.training)
        return _layer_norm(residual + x, self.LayerNorm, dtype)


class _Attention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.self = RobertaSelfAttention(cfg)
        self.output = _DenseLayerNorm(cfg.hidden_size, cfg)


class _Intermediate(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class RobertaLayer(nn.Module):
    """Post-LN: ``x = LayerNorm(x + drop(dense(attention(x))))``,
    ``x = LayerNorm(x + drop(dense(gelu(dense(x)))))``."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseLayerNorm(cfg.intermediate_size, cfg)

    def forward(self, hidden: torch.Tensor, key_padding_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        attn = self.attention.self(hidden, key_padding_mask, dtype)
        hidden = self.attention.output(attn, hidden, dtype)
        inner = F.gelu(_linear(hidden, self.intermediate.dense, dtype))
        return self.output(inner, hidden, dtype)


class _Encoder(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(cfg) for _ in range(cfg.num_hidden_layers))


class RobertaModel(nn.Module):
    """Input ids + attention mask [B, S] -> last hidden state [B, S, H] in
    ``dtype`` (no pooler: the reference disables it, text/model.py:16)."""

    def __init__(self, cfg: RobertaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = RobertaEmbeddings(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        hidden = self.embeddings(input_ids, self.dtype)
        key_padding_mask = (attention_mask == 0).contiguous()  # True = ignore
        for layer in self.encoder.layer:
            hidden = layer(hidden, key_padding_mask, self.dtype)
        return hidden


class RobertaClassificationHead(nn.Module):
    """Hugging Face's ``RobertaClassificationHead``: CLS -> dropout -> dense ->
    tanh -> dropout -> out_proj."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.num_labels)
        self.dropout = cfg.hidden_dropout

    def forward(self, hidden: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        drop = lambda x: F.dropout(x, self.dropout, self.training)
        x = torch.tanh(_linear(drop(hidden[:, 0, :]), self.dense, dtype))
        return _linear(drop(x), self.out_proj, dtype)


class TextERC(nn.Module):
    """RoBERTa + classification head, the stage-1a fine-tuning model (reference
    text/model.py:9-22). ``dtype`` is the compute dtype; the parameters stay
    float32. The backbone is the submodule ``roberta``, the head
    ``classifier_head``."""

    def __init__(self, cfg: RobertaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.roberta = RobertaModel(cfg, dtype)
        self.classifier_head = RobertaClassificationHead(cfg)

    def set_compute_dtype(self, dtype: torch.dtype) -> "TextERC":
        self.dtype = self.roberta.dtype = dtype
        return self

    def load_backbone(self, state_dict: dict) -> None:
        """Fill the backbone from a pretrained ``RobertaModel`` ``state_dict``
        (Hugging Face names, bare or under ``roberta.``); keys the backbone
        does not have (the pooler, the LM head, ``position_ids``) are ignored,
        every key it has must be there."""
        own = self.roberta.state_dict()
        bare = {k.removeprefix("roberta."): v for k, v in state_dict.items()}
        self.roberta.load_state_dict({k: v for k, v in bare.items() if k in own}, strict=True)

    def embed(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[CLS] embeddings [B, H] for export (reference text/embeddings.py:83)."""
        return self.roberta(input_ids, attention_mask)[:, 0, :]

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Logits [B, num_labels] in the compute dtype."""
        return self.classifier_head(self.roberta(input_ids, attention_mask), self.dtype)


@torch.no_grad()
def init_text_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for runs without a checkpoint, with ``mer_tpu``'s
    initial scale: every Linear weight N(0, 1 / fan_in), every embedding table
    N(0, 1 / hidden) from ``generator``, biases 0, the LayerNorms at 1 and 0."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            fan_in = module.weight.shape[1]
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) / math.sqrt(fan_in))
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model


def text_erc_from_seed(seed: int, cfg: RobertaConfig | None = None, dtype: torch.dtype = torch.float32) -> TextERC:
    """A :class:`TextERC` (the base config unless ``cfg``) with
    :func:`init_text_random_` weights drawn from ``seed`` (the global
    generators are left as they were)."""
    with torch.random.fork_rng(devices=[]):
        model = TextERC(cfg or RobertaConfig.base(), dtype)
    return init_text_random_(model, torch.Generator().manual_seed(seed))
