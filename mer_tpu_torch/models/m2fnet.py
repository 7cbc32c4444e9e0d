"""M2FNet fusion model (stage 2), counterpart of ``mer_tpu/models/m2fnet.py``.

Architecture of the reference (src/model.py:5-145), in its ``state_dict``
layout, so reference ``.pth`` checkpoints load with ``strict=True``:

- per-modality stacks of post-LN encoders, each with an additive skip around
  the whole encoder: ``x = x + Encoder(x, key_padding_mask)``;
- dropout -> Linear projection to d_fam -> dropout per modality;
- Fusion Attention Modules: MHA with query = text, key = audio, value = text,
  concat with the text residual, ReLU, Linear(2d -> d), ReLU;
- concat(audio, text) -> ``output_layer``: Linear [-> ReLU -> Linear]* ->
  ReLU -> Dropout -> Linear;
- modality toggles AUDIO / TEXT / FAM ``enabled`` with the reference's
  validation.

Mixed precision as ``mer_tpu`` does it (``mer_tpu/models/m2fnet.py:181,188``):
the embeddings stay in their own dtype (f32) across each encoder's additive
skip, so the skip sum is f32; the input is cast to the weights' dtype at the
encoder's entrance and before ``audio_proj`` / ``text_proj``. Serving casts
the weights to bf16; training keeps f32 weights and runs under
``torch.autocast``, where the casts are no-ops and autocast picks the dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mer_tpu_torch.models.layers import MultiheadAttention, TransformerEncoder


class FusionAttentionModule(nn.Module):
    """Cross-modal fusion attention (reference src/model.py:5-20)."""

    def __init__(self, embedding_size: int, n_head: int, dropout: float):
        super().__init__()
        self.multihead_attention = MultiheadAttention(embedding_size, n_head, dropout=dropout)
        self.linear = nn.Linear(2 * embedding_size, embedding_size)

    def forward(self, text, audio, key_padding_mask=None):
        x = self.multihead_attention(text, audio, text, key_padding_mask=key_padding_mask)
        x = F.relu(torch.cat([x, text], dim=-1))
        return F.relu(self.linear(x))


class M2FNet(nn.Module):
    """Stage-2 fusion classifier over dialogue batches [B, U, D]."""

    def __init__(
        self,
        audio_enabled: bool = True,
        text_enabled: bool = True,
        fam_enabled: bool = True,
        d_model_audio: int = 768,
        d_model_text: int = 768,
        d_model_fam: int = 768,
        n_head_audio: int = 8,
        n_head_text: int = 8,
        n_head_fam: int = 8,
        n_layers_audio: int = 6,
        n_layers_text: int = 6,
        n_layers_fam: int = 5,
        n_transformers_audio: int = 1,
        n_transformers_text: int = 1,
        n_layers_classifier: int = 2,
        hidden_size_classifier: int = 768,
        output_size_classifier: int = 7,
        dropout: float = 0.4,
    ):
        super().__init__()
        if not audio_enabled and not text_enabled:
            raise ValueError("At least one of audio and text must be enabled!")
        if fam_enabled and not (audio_enabled and text_enabled):
            raise ValueError("Fusion Attention Module can only be used with both audio and text enabled!")
        self.audio_enabled = audio_enabled
        self.text_enabled = text_enabled
        self.fam_enabled = fam_enabled

        if audio_enabled:
            self.audio_encoders = nn.ModuleList(
                TransformerEncoder(d_model_audio, n_head_audio, n_layers_audio, dropout=dropout)
                for _ in range(n_transformers_audio)
            )
            self.audio_proj = nn.Linear(d_model_audio, d_model_fam)
        if text_enabled:
            self.text_encoders = nn.ModuleList(
                TransformerEncoder(d_model_text, n_head_text, n_layers_text, dropout=dropout)
                for _ in range(n_transformers_text)
            )
            self.text_proj = nn.Linear(d_model_text, d_model_fam)
        if fam_enabled:
            self.fusion_layers = nn.ModuleList(
                FusionAttentionModule(d_model_fam, n_head_fam, dropout) for _ in range(n_layers_fam)
            )

        cls_in = 2 * d_model_fam if (audio_enabled and text_enabled) else d_model_fam
        head: list[nn.Module] = [nn.Linear(cls_in, hidden_size_classifier)]
        for _ in range(max(n_layers_classifier - 2, 0)):
            head += [nn.ReLU(), nn.Linear(hidden_size_classifier, hidden_size_classifier)]
        head += [nn.ReLU(), nn.Dropout(dropout), nn.Linear(hidden_size_classifier, output_size_classifier)]
        self.output_layer = nn.Sequential(*head)
        self.dropout = nn.Dropout(dropout)

    @classmethod
    def from_config(cls, model_cfg) -> "M2FNet":
        """Build from the reference ``model:`` block of src/config.yaml."""
        return cls(
            audio_enabled=bool(model_cfg.AUDIO.enabled),
            text_enabled=bool(model_cfg.TEXT.enabled),
            fam_enabled=bool(model_cfg.FAM.enabled),
            d_model_audio=int(model_cfg.AUDIO.embedding_size),
            d_model_text=int(model_cfg.TEXT.embedding_size),
            d_model_fam=int(model_cfg.FAM.embedding_size),
            n_head_audio=int(model_cfg.AUDIO.n_head),
            n_head_text=int(model_cfg.TEXT.n_head),
            n_head_fam=int(model_cfg.FAM.n_head),
            n_layers_audio=int(model_cfg.AUDIO.n_encoder_layers),
            n_layers_text=int(model_cfg.TEXT.n_encoder_layers),
            n_layers_fam=int(model_cfg.FAM.n_layers),
            n_transformers_audio=int(model_cfg.AUDIO.n_transformers),
            n_transformers_text=int(model_cfg.TEXT.n_transformers),
            n_layers_classifier=int(model_cfg.CLASSIFIER.n_layers),
            hidden_size_classifier=int(model_cfg.CLASSIFIER.hidden_size),
            output_size_classifier=int(model_cfg.CLASSIFIER.output_size),
            dropout=float(model_cfg.dropout),
        )

    def forward(self, text, audio, padding_mask):
        """text/audio [B, U, D] (f32 embeddings), padding_mask [B, U] bool
        True = pad -> logits [B, U, num_classes] in the weights' dtype."""
        dtype = self.output_layer[-1].weight.dtype  # compute dtype of the weights
        if self.audio_enabled:
            for encoder in self.audio_encoders:
                audio = audio + encoder(audio.to(dtype), src_key_padding_mask=padding_mask)
            audio = self.dropout(self.audio_proj(self.dropout(audio).to(dtype)))
        if self.text_enabled:
            for encoder in self.text_encoders:
                text = text + encoder(text.to(dtype), src_key_padding_mask=padding_mask)
            text = self.dropout(self.text_proj(self.dropout(text).to(dtype)))

        if self.fam_enabled:
            for fusion_layer in self.fusion_layers:
                text = self.dropout(fusion_layer(text, audio, key_padding_mask=padding_mask))
        if self.audio_enabled and self.text_enabled:
            x = torch.cat([audio, text], dim=-1)
        else:
            x = text if self.text_enabled else audio
        return self.output_layer(x)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every Linear weight and bias and every packed in-projection with
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from ``generator`` (LayerNorms stay at
    1 and 0): seeded random weights for runs without a checkpoint."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            fan_in, params = module.in_features, (module.weight, module.bias)
        elif isinstance(module, MultiheadAttention):
            fan_in, params = module.embed_dim, (module.in_proj_weight, module.in_proj_bias)
        else:
            continue
        bound = 1.0 / math.sqrt(fan_in)
        for p in params:
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model
