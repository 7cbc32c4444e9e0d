"""Masked attention forward: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``mer_tpu/ops/flash_attention.py:72`` (``_kernel``,
single-pass forward launched from ``_flash_impl``). The CUDA source is
``mer_tpu_torch/csrc/flash_attention_fwd.cu``; its header states the design
and the bound. :func:`flash_attention_forward` launches it for CUDA tensors
and takes :func:`flash_attention_reference` only for CPU tensors.

Semantics (both versions): q [B, H, Sq, Dh], k/v [B, H, Sk, Dh] in float32
or bfloat16; ``key_padding_mask`` [B, Sk] bool, True = ignore that key, adds
-1e30 to its scores; scale 1/sqrt(Dh) applied to q; softmax and logsumexp in
float32. Returns ``out`` [B, H, Sq, Dh] in q's dtype and ``lse`` [B, H, Sq]
float32 (the per-row logsumexp a backward or a ring merge consumes).
"""

from __future__ import annotations

import ctypes
import math

import torch

from mer_tpu_torch.ops import _build

NEG_INF = -1e30  # additive bias on ignored keys (finite, as the TPU kernel's)
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "flash_attention_fwd"


def flash_attention_reference(q, k, v, key_padding_mask=None):
    """Plain PyTorch version of the kernel: ``(out, lse)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask[:, None, None, :], NEG_INF, 0.0)
        scores = scores + bias.to(scores.device, torch.float32)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
    return out, lse


def _check(q, k, v, key_padding_mask) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q [B,H,Sq,Dh] and k, v [B,H,Sk,Dh]; got {q.shape}, {k.shape}, {v.shape}")
    b, h, _, dh = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on B, H or Dh")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside the kernel's range 1..{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    tensors = [q, k, v] + ([key_padding_mask] if key_padding_mask is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and key_padding_mask must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors only")
    if key_padding_mask is not None:
        if key_padding_mask.dtype != torch.bool or tuple(key_padding_mask.shape) != (b, k.shape[2]):
            raise ValueError(f"key_padding_mask must be bool [B, Sk] = {(b, k.shape[2])}; "
                             f"got {key_padding_mask.dtype} {tuple(key_padding_mask.shape)}")


def _kernel_fn():
    fn = _build.load(_KERNEL).mer_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_forward(q, k, v, key_padding_mask=None):
    """``(out, lse)`` of masked attention; the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. ``flash_attention_forward.launches``
    counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v, key_padding_mask)
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                key_padding_mask.data_ptr() if key_padding_mask is not None else None,
                out.data_ptr(), lse.data_ptr(), b, h, sq, sk, dh, 1.0 / math.sqrt(dh),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {rc}")
    flash_attention_forward.launches += 1
    return out, lse


flash_attention_forward.launches = 0
