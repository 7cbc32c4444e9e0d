"""int8 serving engine of the M2FNet fusion model (counterpart of
``mer_tpu/serving/quant.py``).

Recipe, as in ``mer_tpu``:

- weights: post-training symmetric int8 per output channel
  (``scale = max|W| / 127`` over the input axis); biases and LayerNorms f32;
- activations (a8w8, the default): symmetric int8 per row, the scale from
  the live tensor's abs-max, or a static per-tensor scale baked in by
  :func:`calibration` and :func:`apply_calibration`; the product is int8 x
  int8 -> int32 (``torch._int_mm``: cuBLAS on the card, which ``mer_tpu``'s
  ``lax.dot_general`` counterpart is too, no Pallas kernel);
- w8 (``weight_only=True``): int8 weights cast to bf16, the product of the
  bf16 operands accumulated in f32;
- attention: bf16 q, k, v through
  :func:`~mer_tpu_torch.ops.attention.dot_product_attention` (K1 on the card,
  its plain version on the CPU): bf16 scores and P V, softmax in f32.

A tree of quantized parameters is a nested dict: :func:`module_tree` gives a
module's weights in ``mer_tpu``'s layout (a Linear as ``{"kernel": [in, out],
"bias"}``, packed attention in-projections split into ``q_proj``,
``k_proj``, ``v_proj``), keyed by the module's own names, and
:func:`quantize_tree` replaces every ``kernel`` node by its int8 form. The
engines are functional forwards over such a tree; :class:`M2FNetInt8` reads
the architecture from the module the weights came from.

Why a second forward beside the float modules' own, not a quantized Linear
swapped into them: the engines keep ``mer_tpu``'s serving numerics, f32
activations, residuals and LayerNorms between the int8 products and
attention in bf16, where a float module runs one dtype through its whole
forward (f32 attention is K1's f32 path, bf16 LayerNorm inputs in bf16).
And the modules do not call a Linear child at every site: the fusion
model's attention slices one packed ``in_proj_weight``, and RoBERTa's and
wav2vec2's read each projection's weight in their forward to cast it to the
forward's dtype. A swap would change those forwards and their numerics;
the tree keeps the engines site for site with ``mer_tpu``'s (the tests
hold the fusion engine's every site).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from mer_tpu_torch.ops.attention import dot_product_attention

# ---------------------------------------------------------------------------
# Quantized primitives
# ---------------------------------------------------------------------------


def quantize_weight(w) -> dict:
    """Per-output-channel symmetric int8 of a kernel [..., in, out]. Returns
    ``{"q": int8 [..., in, out], "scale": f32 [..., 1, out]}``."""
    w = torch.as_tensor(w).to(torch.float32)
    amax = w.abs().amax(dim=-2, keepdim=True)  # over the input axis
    scale = (amax / 127.0).clamp_min(1e-12)
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    if q.dim() == 2:
        q = q.t().contiguous().t()  # [in, out] over [out, in] storage: the int8 GEMM's preferred operand layout
    return {"q": q, "scale": scale}


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0])) if (rows, cols) != tuple(x.shape) else x


def cublas_int8_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 a [M, K] and b [K, N] as ``torch._int_mm`` takes them on the card:
    more than 16 rows, K and N multiples of 8 (zero rows and columns added,
    which add nothing to the product), b column-major."""
    (m, k), n = a.shape, b.shape[1]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    a = _pad_to(a.contiguous(), max(m, 17), kp)
    bt = b.t()  # [N, K]; contiguous for a quantized weight
    if (kp, np_) != (k, n) or not bt.is_contiguous():
        bt = _pad_to(bt.contiguous(), np_, kp)
    return a, bt.t()


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] x int8 b [K, N] -> int32 [M, N], exact (``torch._int_mm``;
    on the card through :func:`cublas_int8_operands`)."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    return torch._int_mm(*cublas_int8_operands(a, b))[: a.shape[0], : b.shape[1]]


def int8_dense(x: torch.Tensor, wq: dict, bias: torch.Tensor | None, act_scale: torch.Tensor | None = None,
               weight_only: bool = False) -> torch.Tensor:
    """``y = dequant(quant(x) @ Wq) + b``, float32 [..., N], for x [..., K]
    and ``wq`` from :func:`quantize_weight` ([K, N]).

    - a8w8 (default): x quantized per row from its abs-max (or by the static
      ``act_scale``), the product int8 x int8 -> int32;
    - w8 (``weight_only``): x and the int8 weights in bf16, the product
      accumulated in f32 (as f32 products of the bf16 values, which are
      exact), no activation quantization.
    """
    q, scale = wq["q"], wq["scale"].reshape(1, -1)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if weight_only:
        y = x2.to(torch.bfloat16).float() @ q.float()
        y = y * scale
    else:
        x2 = x2.float()
        if act_scale is None:
            a_scale = (x2.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
        else:
            a_scale = act_scale
        xq = torch.round(x2 / a_scale).clamp(-127, 127).to(torch.int8)
        y = int8_matmul(xq, q).float() * a_scale * scale
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, -1)


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 over the last axis with ``p``'s ``weight`` and ``bias``."""
    return F.layer_norm(x.float(), x.shape[-1:], p["weight"], p["bias"], eps)


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def module_tree(module: nn.Module) -> dict:
    """A module's weights as a nested dict keyed by its own names, float32:
    a Linear as ``{"kernel": weight.T [in, out], "bias"}``, a packed
    attention in-projection (the fusion model's ``MultiheadAttention``) as
    ``q_proj``, ``k_proj`` and ``v_proj`` beside ``out_proj``; every other
    parameter and buffer as it is."""
    from mer_tpu_torch.models.layers import MultiheadAttention

    def linear(weight, bias) -> dict:
        node = {"kernel": weight.detach().float().t()}
        if bias is not None:
            node["bias"] = bias.detach().float()
        return node

    def rec(mod: nn.Module) -> dict:
        if isinstance(mod, nn.Linear):
            return linear(mod.weight, mod.bias)
        if isinstance(mod, MultiheadAttention):
            d = mod.embed_dim
            node = {name: linear(mod.in_proj_weight[i * d:(i + 1) * d], mod.in_proj_bias[i * d:(i + 1) * d])
                    for i, name in enumerate(("q_proj", "k_proj", "v_proj"))}
            node["out_proj"] = rec(mod.out_proj)
            return node
        node = {name: rec(child) for name, child in mod.named_children()}
        for name, t in [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]:
            if t is not None:
                node[name] = t.detach().float() if t.is_floating_point() else t.detach()
        return node

    return rec(module)


def quantize_tree(params: Any, skip_subtrees: tuple[str, ...] = (), weight_only: bool = False) -> Any:
    """Every ``{"kernel", "bias"}`` node of a nested dict replaced by
    ``{"kernel_q": quantize_weight(kernel), "bias"}``; everything else
    float32 (integer tensors as they are). ``skip_subtrees`` names path
    components whose kernels stay float; ``weight_only`` marks every site
    for w8 serving (an empty ``"w8"`` entry)."""

    def rec(node, path):
        if isinstance(node, dict):
            if "kernel" in node and not any(s in path for s in skip_subtrees):
                out = {"kernel_q": quantize_weight(node["kernel"])}
                if "bias" in node:
                    out["bias"] = torch.as_tensor(node["bias"]).float()
                if weight_only:
                    out["w8"] = ()
                return out
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        t = torch.as_tensor(node)
        return t.float() if t.is_floating_point() else t

    return rec(params, ())


def quantize_m2fnet(model: nn.Module, weight_only: bool = False) -> dict:
    """The int8 tree of an ``M2FNet``'s weights (its module names)."""
    return quantize_tree(module_tree(model), weight_only=weight_only)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def quantized_bytes(qparams: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(qparams))


def _dense(x: torch.Tensor, node: dict) -> torch.Tensor:
    if _CALIBRATION_SINK is not None:  # observer pass: the largest |activation| per site
        key = id(node)
        _CALIBRATION_SINK[key] = max(_CALIBRATION_SINK.get(key, 0.0), float(x.abs().max()))
    return int8_dense(x, node["kernel_q"], node.get("bias"), node.get("act_scale"), weight_only="w8" in node)


# ---------------------------------------------------------------------------
# Static activation calibration
# ---------------------------------------------------------------------------


_CALIBRATION_SINK: dict | None = None


def _dense_site_paths(qparams: Any) -> dict[int, tuple]:
    """id(dense node) -> its path in the tree, for every quantized site."""
    out: dict[int, tuple] = {}

    def rec(node, path):
        if isinstance(node, dict):
            if "kernel_q" in node:
                out[id(node)] = path
                return
            for k, v in node.items():
                rec(v, path + (k,))

    rec(qparams, ())
    return out


class calibration:
    """Post-training static activation calibration::

        qp = quantize_m2fnet(model)
        with calibration(qp) as sink:
            for b in calib_batches:
                server.apply(qp, b["text"], b["audio"], b["padding_mask"])
        qp = apply_calibration(qp, sink)

    Every quantized site records the largest |activation| it sees. Given the
    tree, the sink is keyed by each site's path on exit, so a rebuilt copy of
    the tree calibrates as well; without it, by node identity, and the same
    tree object must reach :func:`apply_calibration`."""

    def __init__(self, tree: Any = None):
        self.sink: dict = {}
        self._id_to_path = None if tree is None else _dense_site_paths(tree)

    def __enter__(self):
        global _CALIBRATION_SINK
        if _CALIBRATION_SINK is not None:
            raise RuntimeError("nested calibration contexts")
        _CALIBRATION_SINK = self.sink
        return self.sink

    def __exit__(self, *exc):
        global _CALIBRATION_SINK
        _CALIBRATION_SINK = None
        if self._id_to_path is not None:
            for key in list(self.sink):
                if key in self._id_to_path:
                    self.sink[self._id_to_path[key]] = self.sink.pop(key)
        return False


def apply_calibration(qparams: Any, sink: dict, headroom: float = 1.0, allow_partial: bool = False) -> Any:
    """A copy of ``qparams`` with a static per-tensor ``act_scale`` (headroom
    x amax / 127) at every site the sink observed. Sites match by path, else
    by node identity. An observed site that matches nothing in the tree
    raises unless ``allow_partial``."""
    matched: set = set()

    def rec(node, path):
        if not isinstance(node, dict):
            return node
        if "kernel_q" not in node:
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        site = next((key for key in (path, id(node)) if key in sink), None)
        if site is None:
            return node
        matched.add(site)
        if sink[site] <= 0.0:
            return node
        return {**node, "act_scale": torch.tensor(max(headroom * sink[site] / 127.0, 1e-12), dtype=torch.float32)}

    out = rec(qparams, ())
    unmatched = set(sink) - matched
    if unmatched and not allow_partial:
        raise ValueError(f"{len(unmatched)}/{len(sink)} calibrated sites did not match "
                         f"this tree (e.g. {sorted(map(str, unmatched))[:3]}): identity-keyed sites break when the "
                         "tree is rebuilt between calibrating and applying (pass the tree to calibration(qp) for "
                         "path keys); allow_partial=True accepts a partial bake")
    return out


# ---------------------------------------------------------------------------
# The functional M2FNet forward over the quantized tree
# ---------------------------------------------------------------------------


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              key_padding_mask: torch.Tensor | None) -> torch.Tensor:
    """Attention over [B, S, D] projections in bf16 (K1 on the card), f32 out."""
    b, sq, d = q.shape
    heads = lambda x: x.reshape(b, x.shape[1], num_heads, d // num_heads).transpose(1, 2).to(
        torch.bfloat16).contiguous()
    out = dot_product_attention(heads(q), heads(k), heads(v), key_padding_mask=key_padding_mask)
    return out.float().transpose(1, 2).reshape(b, sq, d)


def _mha(x_q, x_key, x_val, p: dict, num_heads: int, mask) -> torch.Tensor:
    out = attention(_dense(x_q, p["q_proj"]), _dense(x_key, p["k_proj"]), _dense(x_val, p["v_proj"]), num_heads,
                    mask)
    return _dense(out, p["out_proj"])


def _encoder(x, p: dict, num_heads: int, mask) -> torch.Tensor:
    """Post-LN ``TransformerEncoder`` (ReLU feed-forward) and its final LayerNorm."""
    for i in range(len(p["layers"])):
        lp = p["layers"][str(i)]
        x = layer_norm(x + _mha(x, x, x, lp["self_attn"], num_heads, mask), lp["norm1"])
        h = _dense(F.relu(_dense(x, lp["linear1"])), lp["linear2"])
        x = layer_norm(x + h, lp["norm2"])
    return layer_norm(x, p["norm"])


class M2FNetInt8:
    """Deterministic int8 serving forward of an ``M2FNet`` (eval mode): the
    architecture from ``model``, the weights from a :func:`quantize_m2fnet`
    tree."""

    def __init__(self, model: nn.Module):
        if not (model.audio_enabled and model.text_enabled and model.fam_enabled):
            raise ValueError("the int8 serving engine supports the full-modality M2FNet config")
        heads = lambda encoders: encoders[0].layers[0].self_attn.num_heads
        self.n_head_audio, self.n_head_text = heads(model.audio_encoders), heads(model.text_encoders)
        self.n_head_fam = model.fusion_layers[0].multihead_attention.num_heads
        self.classifier = [str(i) for i, m in enumerate(model.output_layer) if isinstance(m, nn.Linear)]

    def apply(self, qparams: dict, text: torch.Tensor, audio: torch.Tensor,
              padding_mask: torch.Tensor) -> torch.Tensor:
        """text / audio [B, U, D] embeddings, ``padding_mask`` [B, U] True = pad -> f32 logits [B, U, classes]."""
        p = qparams
        text, audio = text.float(), audio.float()
        for enc in p["audio_encoders"].values():
            audio = audio + _encoder(audio, enc, self.n_head_audio, padding_mask)
        audio = _dense(audio, p["audio_proj"])
        for enc in p["text_encoders"].values():
            text = text + _encoder(text, enc, self.n_head_text, padding_mask)
        text = _dense(text, p["text_proj"])
        for fam in p["fusion_layers"].values():
            x = _mha(text, audio, text, fam["multihead_attention"], self.n_head_fam, padding_mask)
            text = F.relu(_dense(F.relu(torch.cat([x, text], dim=-1)), fam["linear"]))
        x = torch.cat([audio, text], dim=-1)
        for name in self.classifier[:-1]:
            x = F.relu(_dense(x, p["output_layer"][name]))
        return _dense(x, p["output_layer"][self.classifier[-1]])
