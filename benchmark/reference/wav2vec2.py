"""wav2vec 2.0 (base) with the emotion head, in plain PyTorch, float32.

Follows the published description (arXiv:2006.11477; Hugging Face's
``facebook/wav2vec2-base``): 7 temporal convolutions without bias (512
channels; kernel / stride 10/5, 3/2 x 4, 2/2 x 2), a GroupNorm of one
channel a group after the first only, exact GELU after each; LayerNorm,
Linear 512 -> 768; a grouped positional convolution (kernel 128, 16 groups,
padding 64, the last frame dropped, GELU) added; LayerNorm; 12 post-LN
encoder layers (12 heads, GELU FFN 3072). Parameter names are Hugging
Face's, under ``wav2vec2.``, with the positional conv's weight norm folded
into a plain weight.

Departures from the published model, as the system under test runs it:

- the emotion head of the MELD extractor: the mean of the valid frames'
  last hidden states, then Linear-Tanh-Linear to 7 classes;
- padded frames (past a clip's own frame count) are zeroed before the
  positional convolution and ignored as attention keys; the GroupNorm after
  the first convolution takes its statistics over the whole padded width,
  as Hugging Face's does for a group-norm model;
- dropout as the system under test places it (``masks``, a
  :class:`~benchmark.reference.dropout.StepMasks`): ``hidden_dropout`` after
  the feature projection (published: ``feat_proj_dropout``, the same 0.1),
  after the LayerNorm that follows the positional convolution, and in every
  layer on the attention output, on the feed-forward's GELU output
  (published: ``activation_dropout`` 0) and on the feed-forward's output;
  ``attention_dropout`` on the attention probabilities; no LayerDrop and no
  time masking (the system has neither).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.common import FP32, Precision, attention, layer_norm, linear, merge_heads, split_heads


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """[(name, shape)] of the model with its head, in a fixed order."""
    h, ff = cfg["hidden_size"], cfg["intermediate_size"]
    spec, c_in = [], 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        spec.append((f"wav2vec2.feature_extractor.conv_layers.{i}.conv.weight", (c, c_in, k)))
        if i == 0:
            spec += [(f"wav2vec2.feature_extractor.conv_layers.0.layer_norm.{p}", (c,)) for p in ("weight", "bias")]
        c_in = c
    spec += [("wav2vec2.feature_projection.layer_norm.weight", (c_in,)),
             ("wav2vec2.feature_projection.layer_norm.bias", (c_in,)),
             ("wav2vec2.feature_projection.projection.weight", (h, c_in)),
             ("wav2vec2.feature_projection.projection.bias", (h,)),
             ("wav2vec2.encoder.pos_conv_embed.conv.weight",
              (h, h // cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"])),
             ("wav2vec2.encoder.pos_conv_embed.conv.bias", (h,)),
             ("wav2vec2.encoder.layer_norm.weight", (h,)),
             ("wav2vec2.encoder.layer_norm.bias", (h,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"wav2vec2.encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            spec += [(p + f"attention.{proj}.weight", (h, h)), (p + f"attention.{proj}.bias", (h,))]
        spec += [(p + "layer_norm.weight", (h,)), (p + "layer_norm.bias", (h,)),
                 (p + "feed_forward.intermediate_dense.weight", (ff, h)),
                 (p + "feed_forward.intermediate_dense.bias", (ff,)),
                 (p + "feed_forward.output_dense.weight", (h, ff)),
                 (p + "feed_forward.output_dense.bias", (h,)),
                 (p + "final_layer_norm.weight", (h,)), (p + "final_layer_norm.bias", (h,))]
    spec += [("head_dense.weight", (h, h)), ("head_dense.bias", (h,)),
             ("head_out.weight", (cfg["num_labels"], h)), ("head_out.bias", (cfg["num_labels"],))]
    return spec


def frame_counts(cfg: dict, lengths: torch.Tensor) -> torch.Tensor:
    out = lengths.long()
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        out = torch.div(out - k, s, rounding_mode="floor") + 1
    return out


def conv_features(w: dict, cfg: dict, wave: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[B, L] -> [B, T, 512]."""
    eps = cfg["layer_norm_eps"]
    x = wave[:, None, :]
    for i, s in enumerate(cfg["conv_stride"]):
        x = F.conv1d(prec(x), prec(w[f"wav2vec2.feature_extractor.conv_layers.{i}.conv.weight"]), stride=s)
        if i == 0:
            x = F.group_norm(x, x.shape[1], w["wav2vec2.feature_extractor.conv_layers.0.layer_norm.weight"],
                             w["wav2vec2.feature_extractor.conv_layers.0.layer_norm.bias"], eps)
        x = F.gelu(x)
    return x.transpose(1, 2)


def encode(w: dict, cfg: dict, wave: torch.Tensor, lengths: torch.Tensor, prec: Precision = FP32, masks=None):
    """(last hidden states [B, T, H], frame counts [B]) of waveforms [B, L]
    in [-1, 1) and their lengths in samples; ``masks`` the step's dropout
    (none: eval mode)."""
    eps, n_heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    drop = masks.hidden if masks is not None else (lambda x: x)
    feats = conv_features(w, cfg, wave, prec)
    frames = frame_counts(cfg, lengths)
    valid = torch.arange(feats.shape[1], device=feats.device)[None, :] < frames[:, None]
    x = layer_norm(feats, w["wav2vec2.feature_projection.layer_norm.weight"],
                   w["wav2vec2.feature_projection.layer_norm.bias"], eps)
    x = drop(linear(x, w["wav2vec2.feature_projection.projection.weight"],
                    w["wav2vec2.feature_projection.projection.bias"], prec))
    x = torch.where(valid[..., None], x, 0.0)
    k = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(prec(x.transpose(1, 2)), prec(w["wav2vec2.encoder.pos_conv_embed.conv.weight"]),
                   w["wav2vec2.encoder.pos_conv_embed.conv.bias"], padding=k // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = drop(layer_norm(x + F.gelu(pos).transpose(1, 2), w["wav2vec2.encoder.layer_norm.weight"],
                        w["wav2vec2.encoder.layer_norm.bias"], eps))
    ignored = ~valid
    for i in range(cfg["num_hidden_layers"]):
        p = f"wav2vec2.encoder.layers.{i}."
        q, kk, v = (split_heads(linear(x, w[p + f"attention.{n}.weight"], w[p + f"attention.{n}.bias"], prec),
                                n_heads) for n in ("q_proj", "k_proj", "v_proj"))
        factor = masks.attention(q.shape[:3] + kk.shape[2:3]) if masks is not None else None
        a = linear(merge_heads(attention(q, kk, v, ignored, prec, factor)), w[p + "attention.out_proj.weight"],
                   w[p + "attention.out_proj.bias"], prec)
        x = layer_norm(x + drop(a), w[p + "layer_norm.weight"], w[p + "layer_norm.bias"], eps)
        f = drop(F.gelu(linear(x, w[p + "feed_forward.intermediate_dense.weight"],
                               w[p + "feed_forward.intermediate_dense.bias"], prec)))
        f = linear(f, w[p + "feed_forward.output_dense.weight"], w[p + "feed_forward.output_dense.bias"], prec)
        x = layer_norm(x + drop(f), w[p + "final_layer_norm.weight"], w[p + "final_layer_norm.bias"], eps)
    return x, frames


def embed(w: dict, cfg: dict, wave: torch.Tensor, lengths: torch.Tensor, prec: Precision = FP32,
          masks=None) -> torch.Tensor:
    """The mean of each clip's valid frames [B, H] (zeros for a clip with none)."""
    hidden, frames = encode(w, cfg, wave, lengths, prec, masks)
    valid = torch.arange(hidden.shape[1], device=hidden.device)[None, :] < frames[:, None]
    return torch.where(valid[..., None], hidden, 0.0).sum(dim=1) / frames.clamp_min(1)[:, None]


def logits(w: dict, cfg: dict, wave: torch.Tensor, lengths: torch.Tensor, prec: Precision = FP32,
           masks=None) -> torch.Tensor:
    pooled = embed(w, cfg, wave, lengths, prec, masks)
    return linear(torch.tanh(linear(pooled, w["head_dense.weight"], w["head_dense.bias"], prec)),
                  w["head_out.weight"], w["head_out.bias"], prec)
