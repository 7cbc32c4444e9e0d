"""Plain PyTorch pieces the references share.

Every product runs in float32 with TF32 off (:func:`float32_exact`).
``Precision`` rounds the operands of every matrix product and convolution
before it: :data:`FP32` leaves them, :data:`FP8` rounds them to float8
e4m3 with one scale per tensor (its largest magnitude at 448), the step
below the bf16 that the configurations state, which the control takes.
The rounding passes gradients through unchanged.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_BIAS = -1e30  # added to the scores of ignored keys


def float32_exact() -> None:
    """float32 products in float32 on the card: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    def __init__(self, name: str):
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x).detach()


FP32 = Precision("float32")
FP8 = Precision("float8_e4m3")


def linear(x, w, b, prec: Precision):
    return F.linear(prec(x), prec(w), b)


def layer_norm(x, w, b, eps: float):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def attention(q, k, v, key_ignored, prec: Precision, dropout: torch.Tensor | None = None):
    """q [B, H, Sq, Dh], k, v [B, H, Sk, Dh], ``key_ignored`` [B, Sk] bool ->
    (softmax(q k^T / sqrt(Dh) - inf * ignored) * dropout) v, ``dropout`` the
    factor [B, H, Sq, Sk] on the probabilities (none: 1)."""
    scores = torch.matmul(prec(q) * (1.0 / math.sqrt(q.shape[-1])), prec(k).transpose(-1, -2))
    scores = scores + torch.where(key_ignored, NEG_BIAS, 0.0)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if dropout is not None:
        probs = probs * dropout
    return torch.matmul(prec(probs), prec(v))


def split_heads(x, n_heads: int):
    b, s, d = x.shape
    return x.view(b, s, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)
