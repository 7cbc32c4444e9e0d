"""wav2vec 2.0 encoder + classifier, the stage-1b audio feature extractor
(counterpart of ``mer_tpu/models/wav2vec2.py``).

The reference fine-tunes torchaudio's WAV2VEC2_BASE bundle
(audio_wav2vec2/model.py:9), the architecture of Hugging Face's
``facebook/wav2vec2-base``, with masked mean pooling over the valid frames
(:27) and a Linear-Tanh-Linear head (:12-16). The ``state_dict`` of
:class:`Wav2Vec2Model` carries Hugging Face's key names
(``feature_extractor.conv_layers.{i}.conv.weight`` [out, in, k],
``encoder.layers.{i}.attention.q_proj.weight``, ...), the positional conv's
weight norm folded into a plain ``weight``; :meth:`AudioERC.load_state_dict`
folds a ``weight_g`` / ``weight_v`` (or ``parametrizations.weight.original0 /
original1``) pair on the way in.

Architecture (base): 7 temporal convs (512 channels; k / stride 10/5, 3/2 x 4,
2/2 x 2; GroupNorm(512, 512) after the first only; exact GELU; no bias) ->
LayerNorm -> Linear(512 -> 768) -> grouped positional conv (k 128, 16 groups),
added -> LayerNorm -> 12 post-LN transformer layers (12 heads, GELU FFN 3072).
Padded frames are zeroed before the positional conv and masked as attention
keys.

On a CUDA tensor the conv frontend runs kernels K7 then K6
(:mod:`mer_tpu_torch.ops.w2v_conv`) in [B, T, C] layout throughout, and the
attention kernels (K1 and K4 up to 4,096 frames, K3 and K4 above); on a CPU
tensor their plain versions. K7 and K6
are forward-only, as the TPU kernels they replace: when the frontend trains
(grad enabled and one of its parameters requires grad) it takes the stock
differentiable convolutions instead, as ``mer_tpu``'s training differentiates
XLA's. One encoder layout, unrolled.

Dropout (train mode, ``mer_tpu``'s ``deterministic=False``): ``hidden_dropout``
after the feature projection, after the positional conv's LayerNorm, and in
every layer on the attention output, on the feed-forward's GELU and on its
output; ``attention_dropout`` on the attention probabilities inside K1 (K3) and K4,
seeded from the generator :func:`~mer_tpu_torch.models.layers.set_attention_generator`
hands the attentions. Eval mode applies none.

Mixed precision as in ``mer_tpu`` (Flax ``dtype`` against ``param_dtype``): the
parameters stay float32 and ``dtype`` is the compute dtype. Linear and conv
operands are cast to it, LayerNorm and GroupNorm statistics and the attention
softmax are float32, and the pooled mean is taken in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mer_tpu_torch.models.layers import SeededAttention
from mer_tpu_torch.ops import w2v_conv
from mer_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    num_labels: int = 7

    @classmethod
    def base(cls) -> "Wav2Vec2Config":
        return cls()

    def feat_extract_output_lengths(self, input_lengths):
        """Frames the conv stack leaves of ``input_lengths`` samples (an int
        or an integer tensor; <= 0 for a clip shorter than the receptive field)."""
        lengths = input_lengths
        for k, s in zip(self.conv_kernel, self.conv_stride):
            lengths = (lengths - k) // s + 1
        return lengths


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(x: torch.Tensor, layer: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps).to(dtype)


class _ConvLayer(nn.Module):
    """``conv_layers.{i}``: ``conv`` and, for layer 0, the GroupNorm ``layer_norm``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, eps: float, group_norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=False)
        if group_norm:
            self.layer_norm = nn.GroupNorm(c_out, c_out, eps=eps)


class ConvFeatureExtractor(nn.Module):
    """Temporal conv stack on raw waveforms [B, L] -> [B, T, C]: layer 0 with
    its GroupNorm and GELU through :func:`~mer_tpu_torch.ops.w2v_conv.layer0_gn`
    (K7), layers 1.. through :func:`~mer_tpu_torch.ops.w2v_conv.conv_stack_fused`
    (K6). The kernels have no backward (nor have ``mer_tpu``'s), so when the
    stack trains, i.e. grad is enabled and one of its parameters requires grad,
    it runs :func:`~mer_tpu_torch.ops.w2v_conv.conv_stack_stock` instead. The
    choice follows what can be differentiated, never what is built or present."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        dims = (1, *cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, cfg.layer_norm_eps, group_norm=i == 0)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))
        self.strides = tuple(cfg.conv_stride)

    def forward(self, waveforms: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        first = self.conv_layers[0]
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            return w2v_conv.conv_stack_stock(waveforms, [layer.conv.weight for layer in self.conv_layers],
                                             first.layer_norm.weight, first.layer_norm.bias, self.strides,
                                             eps=first.layer_norm.eps, dtype=dtype)
        x = w2v_conv.layer0_gn(waveforms, first.conv.weight, first.layer_norm.weight, first.layer_norm.bias,
                               stride=self.strides[0], eps=first.layer_norm.eps, dtype=dtype)
        return w2v_conv.conv_stack_fused(x, [layer.conv.weight for layer in self.conv_layers[1:]], self.strides[1:])


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)
        self.dropout = cfg.hidden_dropout

    def forward(self, feats: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = _linear(_layer_norm(feats, self.layer_norm, dtype), self.projection, dtype)
        return F.dropout(x, self.dropout, self.training)


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv positional embedding over [B, T, H]: pad k / 2 on both
    sides, drop the last frame for an even k, exact GELU. ``conv.weight`` is
    the folded kernel [H, H / groups, k]."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, hidden: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        conv = self.conv
        x = F.conv1d(hidden.to(dtype).transpose(1, 2), conv.weight.to(dtype), conv.bias.to(dtype),
                     padding=conv.padding[0], groups=conv.groups)
        if conv.kernel_size[0] % 2 == 0:
            x = x[:, :, :-1]
        return F.gelu(x).transpose(1, 2)


class _Attention(SeededAttention):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.dropout = cfg.attention_dropout
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(h, h) for _ in range(4))

    def forward(self, hidden: torch.Tensor, key_padding_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, s, h = hidden.shape

        def heads(layer):
            return _linear(hidden, layer, dtype).view(b, s, self.num_heads, h // self.num_heads) \
                .transpose(1, 2).contiguous()  # [B, H, S, Dh]

        out = dot_product_attention(heads(self.q_proj), heads(self.k_proj), heads(self.v_proj),
                                    key_padding_mask=key_padding_mask,
                                    dropout_rate=self.dropout if self.training else 0.0, generator=self.generator)
        return _linear(out.transpose(1, 2).reshape(b, s, h), self.out_proj, dtype)


class _FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.dropout = cfg.hidden_dropout

    def forward(self, hidden: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        inner = F.dropout(F.gelu(_linear(hidden, self.intermediate_dense, dtype)), self.dropout, self.training)
        return _linear(inner, self.output_dense, dtype)


class Wav2Vec2EncoderLayer(nn.Module):
    """Post-LN: ``x = layer_norm(x + drop(attention(x)))``,
    ``x = final_layer_norm(x + drop(feed_forward(x)))``."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.attention = _Attention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = cfg.hidden_dropout

    def forward(self, hidden: torch.Tensor, key_padding_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        drop = lambda x: F.dropout(x, self.dropout, self.training)
        hidden = _layer_norm(hidden + drop(self.attention(hidden, key_padding_mask, dtype)), self.layer_norm, dtype)
        return _layer_norm(hidden + drop(self.feed_forward(hidden, dtype)), self.final_layer_norm, dtype)


class _Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = ConvPositionalEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(Wav2Vec2EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.dropout = cfg.hidden_dropout

    def forward(self, x: torch.Tensor, frame_valid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # padded frames are zeroed before the positional conv (HF semantics)
        x = torch.where(frame_valid[..., None], x, 0.0)
        x = _layer_norm(x + self.pos_conv_embed(x, dtype), self.layer_norm, dtype)
        x = F.dropout(x, self.dropout, self.training)
        key_padding_mask = ~frame_valid
        for layer in self.layers:
            x = layer(x, key_padding_mask, dtype)
        return x


class Wav2Vec2Model(nn.Module):
    """Waveforms [B, L] + lengths [B] -> frame features [B, T, H] in ``dtype``
    and the frame counts [B] (<= 0 for a clip shorter than the receptive field)."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, waveforms: torch.Tensor, lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        feats = self.feature_extractor(waveforms, self.dtype)
        out_lengths = self.cfg.feat_extract_output_lengths(lengths.to(torch.int32))
        frame_valid = torch.arange(feats.shape[1], device=feats.device)[None, :] < out_lengths[:, None]
        x = self.feature_projection(feats, self.dtype)
        return self.encoder(x, frame_valid, self.dtype), out_lengths


def fold_pos_conv_weight_norm(state_dict: dict) -> dict:
    """A copy of ``state_dict`` in which every positional conv stored as a
    weight-norm pair (``conv.weight_g`` / ``conv.weight_v``, or torch >= 2.1's
    ``conv.parametrizations.weight.original0`` / ``original1``) holds the
    folded ``conv.weight`` instead: fairseq's ``weight_norm(dim=2)``, a norm
    per kernel position over (out, in), as ``convert_hf_wav2vec2`` folds it."""
    out = dict(state_dict)
    for g_name, v_name in (("weight_g", "weight_v"),
                           ("parametrizations.weight.original0", "parametrizations.weight.original1")):
        for key in [k for k in out if k.endswith(f"pos_conv_embed.conv.{g_name}")]:
            prefix = key[: -len(g_name)]
            g, v = out.pop(key).float(), out.pop(prefix + v_name).float()
            norm = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
            out[prefix + "weight"] = g * v / norm.clamp_min(1e-12)
    return out


class AudioERC(nn.Module):
    """wav2vec2 + masked mean pooling + Linear-Tanh-Linear head (reference
    audio_wav2vec2/model.py:5-29). ``dtype`` is the compute dtype; the
    parameters stay float32."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.wav2vec2 = Wav2Vec2Model(cfg, dtype)
        self.head_dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.head_out = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def set_compute_dtype(self, dtype: torch.dtype) -> "AudioERC":
        self.dtype = self.wav2vec2.dtype = dtype
        return self

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        return super().load_state_dict(fold_pos_conv_weight_norm(state_dict), strict=strict, assign=assign)

    def load_backbone(self, state_dict: dict) -> None:
        """Fill the backbone from a pretrained wav2vec2 ``state_dict`` (Hugging
        Face names, bare or under ``wav2vec2.``); keys the backbone does not
        have (the pretraining heads, ``masked_spec_embed``) are ignored, every
        key it has must be there."""
        own = self.wav2vec2.state_dict()
        folded = fold_pos_conv_weight_norm({k.removeprefix("wav2vec2."): v for k, v in state_dict.items()})
        self.wav2vec2.load_state_dict({k: v for k, v in folded.items() if k in own}, strict=True)

    @staticmethod
    def pool(hidden: torch.Tensor, out_lengths: torch.Tensor) -> torch.Tensor:
        """Mean over the valid frames, float32; a clip with none gives zeros
        (the sum is empty and the divisor is max(length, 1))."""
        valid = (torch.arange(hidden.shape[1], device=hidden.device)[None, :] < out_lengths[:, None])[..., None]
        summed = torch.where(valid, hidden.float(), 0.0).sum(dim=1)
        return summed / out_lengths.clamp_min(1)[:, None]

    def embed(self, waveforms: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Masked mean-pooled embeddings [B, H] float32 for export (reference
        audio_wav2vec2/embeddings.py:85)."""
        return self.pool(*self.wav2vec2(waveforms, lengths))

    def forward(self, waveforms: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Logits [B, num_labels] in the compute dtype."""
        pooled = self.embed(waveforms, lengths)
        return _linear(torch.tanh(_linear(pooled, self.head_dense, self.dtype)), self.head_out, self.dtype)


@torch.no_grad()
def init_audio_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for runs without a checkpoint, with ``mer_tpu``'s
    initial scale: every conv and Linear weight N(0, 1 / fan_in) from
    ``generator``, biases 0, the norms at 1 and 0."""
    for module in model.modules():
        if isinstance(module, (nn.Conv1d, nn.Linear)):
            fan_in = module.weight[0].numel()
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model


def audio_erc_from_seed(seed: int, cfg: Wav2Vec2Config | None = None,
                        dtype: torch.dtype = torch.float32) -> AudioERC:
    """An :class:`AudioERC` (the base config unless ``cfg``) with
    :func:`init_audio_random_` weights drawn from ``seed`` (the global
    generators are left as they were)."""
    with torch.random.fork_rng(devices=[]):
        model = AudioERC(cfg or Wav2Vec2Config.base(), dtype)
    return init_audio_random_(model, torch.Generator().manual_seed(seed))
