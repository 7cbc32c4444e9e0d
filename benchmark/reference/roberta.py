"""RoBERTa (base) in plain PyTorch, float32: the [CLS] embedding the MELD
text extractor exports.

Follows Hugging Face's ``FacebookAI/roberta-base``: word, position and
token-type embeddings summed, LayerNorm; 12 post-LN layers (12 heads of 64,
exact GELU FFN 3072, eps 1e-5). Position ids count the non-pad tokens from
``pad_token_id + 1``; a pad keeps the pad id. Padded keys are ignored. No
pooler. Parameter names are Hugging Face's under ``roberta.``, with the
emotion head ``classifier_head.{dense,out_proj}`` beside them (the
configuration's weights include it; the [CLS] embedding does not use it).
No dropout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.common import FP32, Precision, attention, layer_norm, linear, merge_heads, split_heads


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    h, ff = cfg["hidden_size"], cfg["intermediate_size"]
    e = "roberta.embeddings."
    spec = [(e + "word_embeddings.weight", (cfg["vocab_size"], h)),
            (e + "position_embeddings.weight", (cfg["max_position_embeddings"], h)),
            (e + "token_type_embeddings.weight", (cfg["type_vocab_size"], h)),
            (e + "LayerNorm.weight", (h,)), (e + "LayerNorm.bias", (h,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"roberta.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            spec += [(p + f"attention.self.{n}.weight", (h, h)), (p + f"attention.self.{n}.bias", (h,))]
        spec += [(p + "attention.output.dense.weight", (h, h)), (p + "attention.output.dense.bias", (h,)),
                 (p + "attention.output.LayerNorm.weight", (h,)), (p + "attention.output.LayerNorm.bias", (h,)),
                 (p + "intermediate.dense.weight", (ff, h)), (p + "intermediate.dense.bias", (ff,)),
                 (p + "output.dense.weight", (h, ff)), (p + "output.dense.bias", (h,)),
                 (p + "output.LayerNorm.weight", (h,)), (p + "output.LayerNorm.bias", (h,))]
    spec += [("classifier_head.dense.weight", (h, h)), ("classifier_head.dense.bias", (h,)),
             ("classifier_head.out_proj.weight", (cfg["num_labels"], h)),
             ("classifier_head.out_proj.bias", (cfg["num_labels"],))]
    return spec


def cls_embedding(w: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    """[B, H] last hidden state of token 0 for token ids [B, S] and their
    attention mask (1 = token, 0 = pad)."""
    eps, pad, n_heads = cfg["layer_norm_eps"], cfg["pad_token_id"], cfg["num_attention_heads"]
    ids = ids.long()
    real = (ids != pad).long()
    positions = torch.cumsum(real, dim=1) * real + pad
    e = "roberta.embeddings."
    x = (F.embedding(ids, w[e + "word_embeddings.weight"]) + F.embedding(positions, w[e + "position_embeddings.weight"])
         + w[e + "token_type_embeddings.weight"][0])
    x = layer_norm(x, w[e + "LayerNorm.weight"], w[e + "LayerNorm.bias"], eps)
    ignored = mask == 0
    for i in range(cfg["num_hidden_layers"]):
        p = f"roberta.encoder.layer.{i}."
        q, k, v = (split_heads(linear(x, w[p + f"attention.self.{n}.weight"], w[p + f"attention.self.{n}.bias"], prec),
                               n_heads) for n in ("query", "key", "value"))
        a = linear(merge_heads(attention(q, k, v, ignored, prec)), w[p + "attention.output.dense.weight"],
                   w[p + "attention.output.dense.bias"], prec)
        x = layer_norm(x + a, w[p + "attention.output.LayerNorm.weight"], w[p + "attention.output.LayerNorm.bias"], eps)
        f = F.gelu(linear(x, w[p + "intermediate.dense.weight"], w[p + "intermediate.dense.bias"], prec))
        f = linear(f, w[p + "output.dense.weight"], w[p + "output.dense.bias"], prec)
        x = layer_norm(x + f, w[p + "output.LayerNorm.weight"], w[p + "output.LayerNorm.bias"], eps)
    return x[:, 0, :]
