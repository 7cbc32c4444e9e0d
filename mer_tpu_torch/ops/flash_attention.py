"""Masked attention, forward and backward: the hand-written CUDA kernels,
their plain versions, and the autograd Function that joins them.

Replaces the TPU kernels ``mer_tpu/ops/flash_attention.py:72`` (``_kernel``,
single-pass forward launched from ``_flash_impl``, with its dropout branch
``:86-115``) and ``:270`` (``_bwd_kernel``, the fused backward launched from
``_flash_bwd_fused`` ``:355``). The CUDA sources are
``mer_tpu_torch/csrc/flash_attention_fwd.cu`` and ``flash_attention_bwd.cu``
with the shared Philox generator ``csrc/philox.cuh``; their headers state the
design and the bound. :func:`flash_attention_forward` and
:func:`flash_attention_backward` launch the kernels for CUDA tensors and take
the plain versions only for CPU tensors; :class:`FlashAttention` makes one
differentiable op of the two, on either device.

Semantics (every version): q [B, H, Sq, Dh], k/v [B, H, Sk, Dh] in float32 or
bfloat16 (the plain versions also take float64); ``key_padding_mask`` [B, Sk]
bool, True = ignore that key, adds -1e30 to its scores; scale 1/sqrt(Dh)
applied to q; softmax and logsumexp in float32 (float64 for float64 inputs).
The forward returns ``out`` [B, H, Sq, Dh] in q's dtype and ``lse``
[B, H, Sq] (the per-row logsumexp of the undropped scores).

Dropout (training, torch MHA semantics): the *normalised* probabilities are
multiplied by D = keep / (1 - rate). The keep bit of probability (row, col)
of head ``b * H + h`` is a pure function of the two seed words and those
indices (Philox4x32-10, counter (col, row, b*H + h, 0), first output word;
keep iff bits >= min(int(rate * 2**32), 2**32 - 1)), so the forward kernel,
the backward kernel and the plain versions draw the same mask whatever their
tiling. The stream differs from the TPU's hardware generator; only the
Bernoulli distribution is contract (``mer_tpu/utils/rng.py``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from mer_tpu_torch.ops import _build

NEG_INF = -1e30  # additive bias on ignored keys (finite, as the TPU kernel's)
MAX_HEAD_DIM = 128
MAX_BWD_KEYS = 2048  # the single-pass backward's range (BWD_FUSED_MAX); beyond is K4's
FULLY_MASKED_LSE = -1e29  # a row's lse below this: every key of the row is ignored
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


# -- dropout: Philox4x32-10, the plain version of csrc/philox.cuh ------------


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * m`` for ``a`` in [0, 2**32) (int64)
    and a 32-bit constant ``m``. The 64-bit product would overflow int64, so
    ``m`` is split into 16-bit halves: every partial product stays below 2**49."""
    lo_part = a * (m & 0xFFFF)
    t = a * (m >> 16) + (lo_part >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (lo_part & 0xFFFF)


def philox4x32(counter, key) -> list[torch.Tensor]:
    """Philox4x32-10 (Salmon et al., SC 2011) on int64 tensors holding 32-bit
    words: ``counter`` four broadcastable tensors, ``key`` two ints. Returns
    the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = int(key[0]), int(key[1])
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return [c0, c1, c2, c3]


def philox_bits(seed, bh, row, col) -> torch.Tensor:
    """The 32 random bits (int64) of probability (row, col) of head ``bh``;
    the index tensors broadcast."""
    row = torch.as_tensor(row, dtype=torch.int64)
    return philox4x32((col, row, bh, torch.zeros_like(row)), seed)[0]


def dropout_threshold(rate: float) -> int:
    """Keep iff bits >= this: P(keep) = 1 - rate to 2**-32 (as ``:68``)."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def dropout_factor(seed, shape, rate: float, device=None, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """D for a [B, H, Sq, Sk] block of probabilities starting at query row
    ``row0`` and key ``col0``: 1 / (1 - rate) where kept, 0 where dropped (f32)."""
    b, h, sq, sk = shape
    idx = lambda n, start: torch.arange(start, start + n, dtype=torch.int64, device=device)
    bh = idx(b * h, 0).view(b, h, 1, 1)
    bits = philox_bits(seed, bh, idx(sq, row0).view(1, 1, sq, 1), idx(sk, col0).view(1, 1, 1, sk))
    return torch.where(bits >= dropout_threshold(rate), 1.0 / (1.0 - rate), 0.0).to(torch.float32)


def _dropout_args(seed, rate: float) -> tuple[int, int, int, int, float]:
    """(on, seed0, seed1, threshold, keep_scale) for a kernel launch."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return 0, 0, 0, 0, 1.0
    if seed is None or len(seed) != 2 or not all(0 <= int(s) <= _U32 for s in seed):
        raise ValueError(f"dropout needs a seed of two 32-bit words, got {seed!r}")
    return 1, int(seed[0]), int(seed[1]), dropout_threshold(rate), 1.0 / (1.0 - rate)


# -- plain versions ------------------------------------------------------------


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q, k, key_padding_mask, acc: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(acc) * scale, k.to(acc))
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask[:, None, None, :], NEG_INF, 0.0)
        scores = scores + bias.to(scores.device, acc)
    return scores


def flash_attention_reference(q, k, v, key_padding_mask=None, seed=None, dropout_rate: float = 0.0):
    """Plain PyTorch version of the forward kernel: ``(out, lse)``."""
    acc = _acc_dtype(q.dtype)
    scores = _scores(q, k, key_padding_mask, acc)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    if _dropout_args(seed, dropout_rate)[0]:
        probs = probs * dropout_factor(seed, probs.shape, dropout_rate, q.device).to(acc)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(acc)).to(q.dtype)
    return out, lse


def flash_attention_backward_reference(q, k, v, key_padding_mask, out, lse, g, seed=None,
                                       dropout_rate: float = 0.0, g_lse=None):
    """Plain PyTorch version of the backward kernel: ``(dq, dk, dv)`` from the
    forward's inputs, its ``out`` and ``lse``, the cotangent ``g`` of out and
    (optionally) ``g_lse`` of lse. P is recomputed from lse, a fully masked
    row taking 1/Sk per key, as the kernel does."""
    acc = _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, g))
    scores = _scores(q, k, key_padding_mask, acc)
    lse = lse.to(acc)[..., None]
    p = torch.where(lse < FULLY_MASKED_LSE, 1.0 / scores.shape[-1], torch.exp(scores - lse))
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    delta = (gf * out.to(acc)).sum(-1, keepdim=True)
    if g_lse is not None:
        delta = delta - g_lse.to(acc)[..., None]
    p_dropped = p
    if _dropout_args(seed, dropout_rate)[0]:
        factor = dropout_factor(seed, p.shape, dropout_rate, q.device).to(acc)
        dp, p_dropped = dp * factor, p * factor
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p_dropped, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernels -------------------------------------------------------------------


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


def _check_like(name: str, t, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} {tuple(shape)} on {device}; "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


_DROPOUT_ARGTYPES = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float]


def _kernel_fn(name: str, n_pointers: int):
    fn = getattr(_build.load(name), f"mer_{name}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 5 + [ctypes.c_float]
                       + _DROPOUT_ARGTYPES + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _ptr(t) -> int | None:
    return t.data_ptr() if t is not None else None


def _device_or_raise(q) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return True


def flash_attention_forward(q, k, v, key_padding_mask=None, seed=None, dropout_rate: float = 0.0):
    """``(out, lse)`` of masked attention; the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. ``flash_attention_forward.launches``
    counts kernel launches."""
    if not _device_or_raise(q):
        return flash_attention_reference(q, k, v, key_padding_mask, seed, dropout_rate)
    _check(q, k, v, key_padding_mask)
    drop = _dropout_args(seed, dropout_rate)
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _kernel_fn("flash_attention_fwd", 6)
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
                out.data_ptr(), lse.data_ptr(), b, h, sq, sk, dh, 1.0 / math.sqrt(dh), *drop,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {rc}")
    flash_attention_forward.launches += 1
    return out, lse


flash_attention_forward.launches = 0


def flash_attention_backward(q, k, v, key_padding_mask, out, lse, g, seed=None, dropout_rate: float = 0.0,
                             g_lse=None):
    """``(dq, dk, dv)``; the CUDA kernel for CUDA tensors (Sk <= 2048), the
    plain version for CPU tensors. ``flash_attention_backward.launches``
    counts kernel launches (one per call: the dq and the dk/dv grids)."""
    if not _device_or_raise(q):
        return flash_attention_backward_reference(q, k, v, key_padding_mask, out, lse, g, seed, dropout_rate,
                                                  g_lse)
    _check(q, k, v, key_padding_mask)
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    if sk > MAX_BWD_KEYS:
        raise ValueError(f"the fused backward takes Sk <= {MAX_BWD_KEYS} keys, got {sk}")
    _check_like("out", out, q.shape, q.dtype, q.device)
    _check_like("g", g, q.shape, q.dtype, q.device)
    _check_like("lse", lse, (b, h, sq), torch.float32, q.device)
    if g_lse is not None:
        _check_like("g_lse", g_lse, (b, h, sq), torch.float32, q.device)
    drop = _dropout_args(seed, dropout_rate)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)  # scratch between the two grids
    fn = _kernel_fn("flash_attention_bwd", 12)
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
                out.data_ptr(), lse.data_ptr(), g.data_ptr(), _ptr(g_lse), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), delta.data_ptr(), b, h, sq, sk, dh, 1.0 / math.sqrt(dh), *drop,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {rc}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """``out, lse = FlashAttention.apply(q, k, v, key_padding_mask, seed,
    dropout_rate)``: forward through :func:`flash_attention_forward`,
    backward through :func:`flash_attention_backward`, so the kernels on the
    card and the plain versions on the CPU. Both directions run with autocast
    off: q, k, v arrive in the compute dtype and the kernels keep f32
    arithmetic inside."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, seed, dropout_rate):
        with torch.autocast(q.device.type, enabled=False):
            out, lse = flash_attention_forward(q, k, v, key_padding_mask, seed, dropout_rate)
        ctx.save_for_backward(q, k, v, key_padding_mask, out, lse)
        ctx.seed, ctx.dropout_rate = seed, dropout_rate
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, key_padding_mask, out, lse = ctx.saved_tensors
        g = torch.zeros_like(out) if g is None else g.contiguous()
        with torch.autocast(q.device.type, enabled=False):
            dq, dk, dv = flash_attention_backward(
                q, k, v, key_padding_mask, out, lse, g, ctx.seed, ctx.dropout_rate,
                None if g_lse is None else g_lse.contiguous())
        return dq, dk, dv, None, None, None
