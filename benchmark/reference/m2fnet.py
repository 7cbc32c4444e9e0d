"""M2FNet (arXiv:2206.02187) in plain PyTorch, float32: emotion logits of
each utterance of a dialogue from its text and audio embeddings.

As the paper's released model (``src/model.py``, in ``torch.nn``'s names)
lays it out: per modality a stack of post-LN ``nn.TransformerEncoderLayer``
encoders (packed q, k, v in-projection, ReLU FFN of ``dim_feedforward``,
eps 1e-5) with a final LayerNorm, added to its input; Linear to the fusion
width; fusion attention modules (attention with query text, key audio,
value text; concatenated with the text, ReLU, Linear 2d -> d, ReLU); the
audio and text concatenated into the classifier (Linear, ReLU, Linear).
Padded utterances are ignored as keys. No dropout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.common import FP32, Precision, attention, layer_norm, linear, merge_heads, split_heads


def _mha_spec(prefix: str, d: int) -> list:
    return [(prefix + "in_proj_weight", (3 * d, d)), (prefix + "in_proj_bias", (3 * d,)),
            (prefix + "out_proj.weight", (d, d)), (prefix + "out_proj.bias", (d,))]


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    spec, dff, fam = [], cfg["dim_feedforward"], cfg["FAM"]["embedding_size"]
    for mod, key in (("AUDIO", "audio"), ("TEXT", "text")):
        m = cfg[mod]
        d = m["embedding_size"]
        for t in range(m["n_transformers"]):
            for i in range(m["n_encoder_layers"]):
                p = f"{key}_encoders.{t}.layers.{i}."
                spec += _mha_spec(p + "self_attn.", d)
                spec += [(p + "linear1.weight", (dff, d)), (p + "linear1.bias", (dff,)),
                         (p + "linear2.weight", (d, dff)), (p + "linear2.bias", (d,)),
                         (p + "norm1.weight", (d,)), (p + "norm1.bias", (d,)),
                         (p + "norm2.weight", (d,)), (p + "norm2.bias", (d,))]
            spec += [(f"{key}_encoders.{t}.norm.weight", (d,)), (f"{key}_encoders.{t}.norm.bias", (d,))]
        spec += [(f"{key}_proj.weight", (fam, d)), (f"{key}_proj.bias", (fam,))]
    for i in range(cfg["FAM"]["n_layers"]):
        spec += _mha_spec(f"fusion_layers.{i}.multihead_attention.", fam)
        spec += [(f"fusion_layers.{i}.linear.weight", (fam, 2 * fam)), (f"fusion_layers.{i}.linear.bias", (fam,))]
    c = cfg["CLASSIFIER"]
    if c["n_layers"] != 2:
        raise ValueError("the reference holds the two-layer classifier")
    spec += [("output_layer.0.weight", (c["hidden_size"], 2 * fam)), ("output_layer.0.bias", (c["hidden_size"],)),
             ("output_layer.3.weight", (c["output_size"], c["hidden_size"])),
             ("output_layer.3.bias", (c["output_size"],))]
    return spec


def _mha(w, p, query, key, value, ignored, n_heads, prec):
    d = query.shape[-1]
    wi, bi = w[p + "in_proj_weight"], w[p + "in_proj_bias"]
    q, k, v = (split_heads(linear(x, wi[j * d:(j + 1) * d], bi[j * d:(j + 1) * d], prec), n_heads)
               for j, x in enumerate((query, key, value)))
    return linear(merge_heads(attention(q, k, v, ignored, prec)), w[p + "out_proj.weight"], w[p + "out_proj.bias"], prec)


def logits(w: dict, cfg: dict, text: torch.Tensor, audio: torch.Tensor, padding: torch.Tensor,
           prec: Precision = FP32) -> torch.Tensor:
    """text, audio [B, U, D] float32, ``padding`` [B, U] bool (True = pad)
    -> logits [B, U, classes]."""
    eps = 1e-5
    out = {}
    for mod, key, x in (("AUDIO", "audio", audio), ("TEXT", "text", text)):
        m = cfg[mod]
        for t in range(m["n_transformers"]):
            h = x
            for i in range(m["n_encoder_layers"]):
                p = f"{key}_encoders.{t}.layers.{i}."
                a = _mha(w, p + "self_attn.", h, h, h, padding, m["n_head"], prec)
                h = layer_norm(h + a, w[p + "norm1.weight"], w[p + "norm1.bias"], eps)
                f = linear(F.relu(linear(h, w[p + "linear1.weight"], w[p + "linear1.bias"], prec)),
                           w[p + "linear2.weight"], w[p + "linear2.bias"], prec)
                h = layer_norm(h + f, w[p + "norm2.weight"], w[p + "norm2.bias"], eps)
            x = x + layer_norm(h, w[f"{key}_encoders.{t}.norm.weight"], w[f"{key}_encoders.{t}.norm.bias"], eps)
        out[key] = linear(x, w[f"{key}_proj.weight"], w[f"{key}_proj.bias"], prec)
    text, audio = out["text"], out["audio"]
    for i in range(cfg["FAM"]["n_layers"]):
        p = f"fusion_layers.{i}."
        a = _mha(w, p + "multihead_attention.", text, audio, text, padding, cfg["FAM"]["n_head"], prec)
        text = F.relu(linear(F.relu(torch.cat([a, text], dim=-1)), w[p + "linear.weight"], w[p + "linear.bias"], prec))
    x = torch.cat([audio, text], dim=-1)
    x = F.relu(linear(x, w["output_layer.0.weight"], w["output_layer.0.bias"], prec))
    return linear(x, w["output_layer.3.weight"], w["output_layer.3.bias"], prec)
