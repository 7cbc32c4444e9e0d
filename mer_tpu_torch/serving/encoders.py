"""int8 serving engines of the stage-1 backbones (counterpart of
``mer_tpu/serving/encoders.py``): RoBERTa's [CLS] embeddings and wav2vec2's
masked mean-pooled embeddings, with their classifier heads, over
:func:`quantize_roberta` / :func:`quantize_wav2vec2` trees of the port's
``TextERC`` and ``AudioERC`` weights. The recipe of
:mod:`mer_tpu_torch.serving.quant`: int8 kernels per output channel, int8
activations per row, int8 x int8 -> int32 products.

What stays float: the embedding tables (gathers), the LayerNorms, and
wav2vec2's conv frontend and positional conv. The frontend runs in f32
through the port's conv kernels (K7 then K6, f32 on the tensor cores in
3xTF32, on the card; their plain versions on the CPU); the positional conv
takes bf16-rounded operands and sums in f32; attention is bf16 (K1 on the card).
Like :class:`~mer_tpu_torch.serving.quant.M2FNetInt8` these are forwards of
their own over the quantized tree, not the float models with a quantized
Linear swapped in (the reasons are in that module's docstring).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mer_tpu_torch.models.roberta import create_position_ids
from mer_tpu_torch.ops import w2v_conv
from mer_tpu_torch.serving.quant import _dense, attention, layer_norm, module_tree, quantize_tree


def quantize_roberta(model: nn.Module, weight_only: bool = False) -> dict:
    """The int8 tree of a ``TextERC``'s weights (its module names)."""
    return quantize_tree(module_tree(model), weight_only=weight_only)


def quantize_wav2vec2(model: nn.Module, weight_only: bool = False) -> dict:
    """The int8 tree of an ``AudioERC``'s weights; the conv frontend and the
    positional conv stay float."""
    return quantize_tree(module_tree(model), skip_subtrees=("feature_extractor", "pos_conv_embed"),
                         weight_only=weight_only)


# ---------------------------------------------------------------------------
# RoBERTa
# ---------------------------------------------------------------------------


class RobertaInt8:
    """int8 serving forward of a ``TextERC``: [CLS] embeddings (the export)
    and classifier logits. The architecture comes from ``model.cfg``."""

    def __init__(self, model: nn.Module):
        self.cfg = model.cfg

    def _encode(self, p: dict, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        emb = p["embeddings"]
        hidden = (emb["word_embeddings"]["weight"][input_ids]
                  + emb["position_embeddings"]["weight"][create_position_ids(input_ids, c.pad_token_id)]
                  + emb["token_type_embeddings"]["weight"][torch.zeros_like(input_ids)])
        hidden = layer_norm(hidden, emb["LayerNorm"], c.layer_norm_eps)
        mask = (attention_mask == 0).contiguous()  # True = ignore
        for i in range(c.num_hidden_layers):
            lp = p["encoder"]["layer"][str(i)]
            sa = lp["attention"]["self"]
            attn = attention(_dense(hidden, sa["query"]), _dense(hidden, sa["key"]), _dense(hidden, sa["value"]),
                             c.num_attention_heads, mask)
            out = lp["attention"]["output"]
            hidden = layer_norm(hidden + _dense(attn, out["dense"]), out["LayerNorm"], c.layer_norm_eps)
            inner = F.gelu(_dense(hidden, lp["intermediate"]["dense"]))
            hidden = layer_norm(hidden + _dense(inner, lp["output"]["dense"]), lp["output"]["LayerNorm"],
                                c.layer_norm_eps)
        return hidden

    def embed(self, qparams: dict, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[N, H] float32 [CLS]-token embeddings."""
        return self._encode(qparams["roberta"], input_ids, attention_mask)[:, 0, :]

    def apply(self, qparams: dict, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[N, num_labels] float32 classifier logits."""
        head = qparams["classifier_head"]
        x = torch.tanh(_dense(self.embed(qparams, input_ids, attention_mask), head["dense"]))
        return _dense(x, head["out_proj"])


# ---------------------------------------------------------------------------
# wav2vec2
# ---------------------------------------------------------------------------


class Wav2Vec2Int8:
    """int8 serving forward of an ``AudioERC``: masked mean-pooled
    embeddings (the export) and classifier logits. The architecture comes
    from ``model.cfg``; the conv frontend runs float (module docstring)."""

    def __init__(self, model: nn.Module):
        self.cfg = model.cfg

    def _frames(self, p: dict, waveforms: torch.Tensor) -> torch.Tensor:
        """Waveforms [B, L] -> conv features [B, T, C] in f32: layer 0 with
        its GroupNorm and GELU (K7 on the card), layers 1.. (K6)."""
        c = self.cfg
        layers = p["feature_extractor"]["conv_layers"]
        gn = layers["0"]["layer_norm"]
        x = w2v_conv.layer0_gn(waveforms.float().contiguous(), layers["0"]["conv"]["weight"], gn["weight"],
                               gn["bias"], stride=c.conv_stride[0], eps=c.layer_norm_eps, dtype=torch.float32)
        weights = [layers[str(i)]["conv"]["weight"] for i in range(1, len(c.conv_kernel))]
        return w2v_conv.conv_stack_fused(x, weights, c.conv_stride[1:])

    def _encode(self, p: dict, waveforms: torch.Tensor, lengths: torch.Tensor):
        c = self.cfg
        feats = self._frames(p, waveforms)
        out_lengths = c.feat_extract_output_lengths(lengths.to(torch.int32))
        frame_valid = torch.arange(feats.shape[1], device=feats.device)[None, :] < out_lengths[:, None]

        proj = p["feature_projection"]
        x = _dense(layer_norm(feats, proj["layer_norm"], c.layer_norm_eps), proj["projection"])
        x = torch.where(frame_valid[..., None], x, 0.0)
        enc = p["encoder"]
        pc = enc["pos_conv_embed"]["conv"]
        k = c.num_conv_pos_embeddings
        bf16 = lambda t: t.to(torch.bfloat16).float()  # bf16 operands, f32 products and sums
        pos = F.conv1d(bf16(x).transpose(1, 2), bf16(pc["weight"]), padding=k // 2,
                       groups=c.num_conv_pos_embedding_groups).transpose(1, 2) + pc["bias"]
        if k % 2 == 0:
            pos = pos[:, :-1, :]
        x = layer_norm(x + F.gelu(pos), enc["layer_norm"], c.layer_norm_eps)

        mask = (~frame_valid).contiguous()
        for i in range(c.num_hidden_layers):
            lp = enc["layers"][str(i)]
            at = lp["attention"]
            attn = attention(_dense(x, at["q_proj"]), _dense(x, at["k_proj"]), _dense(x, at["v_proj"]),
                             c.num_attention_heads, mask)
            x = layer_norm(x + _dense(attn, at["out_proj"]), lp["layer_norm"], c.layer_norm_eps)
            ff = lp["feed_forward"]
            inner = F.gelu(_dense(x, ff["intermediate_dense"]))
            x = layer_norm(x + _dense(inner, ff["output_dense"]), lp["final_layer_norm"], c.layer_norm_eps)
        return x, out_lengths

    def embed(self, qparams: dict, waveforms: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """[N, H] float32 mean over the valid frames (zeros for a clip with none)."""
        hidden, out_lengths = self._encode(qparams["wav2vec2"], waveforms, lengths)
        valid = (torch.arange(hidden.shape[1], device=hidden.device)[None, :] < out_lengths[:, None])[..., None]
        return torch.where(valid, hidden, 0.0).sum(dim=1) / out_lengths.clamp_min(1)[:, None]

    def apply(self, qparams: dict, waveforms: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """[N, num_labels] float32 classifier logits."""
        x = torch.tanh(_dense(self.embed(qparams, waveforms, lengths), qparams["head_dense"]))
        return _dense(x, qparams["head_out"])
