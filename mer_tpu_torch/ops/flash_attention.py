"""Masked attention, forward and backward: the hand-written CUDA kernels,
their plain versions, the dispatch by key count between them, and the
autograd Function that joins them.

Replaces the TPU kernels of ``mer_tpu/ops/flash_attention.py``: ``:72``
(``_kernel``, single-pass forward launched from ``_flash_impl``, with its
dropout branch ``:86-115``) -> K1, ``csrc/flash_attention_fwd.cu``; ``:270``
(``_bwd_kernel``, the fused backward launched from ``_flash_bwd_fused``
``:355``) -> K2, ``csrc/flash_attention_bwd.cu``; ``:424`` (``_stream_kernel``,
the online-softmax forward over key tiles, ``_flash_stream`` ``:465``) -> K3,
``csrc/flash_attention_stream.cu``; ``:579`` + ``:624`` (``_bwd_dkv_kernel``
and ``_bwd_dq_kernel``, the key-tiled backward, ``_flash_bwd_tiled`` ``:659``)
-> K4, ``csrc/flash_attention_tiled_bwd.cu``. At head dim 64 (the wav2vec2
and RoBERTa heads), with 16-byte aligned tensors, K1 and K3 launch the same
Hopper forwards (``csrc/flash_attention_hopper.cuh``, ``wgmma`` and TMA into
an ``mbarrier`` ring filled by a producer warp; ``csrc/sm90.cuh``): in bf16
one launch that makes the key biases from the mask's bytes, in f32 a prep
pass that splits K and V^T into TF32 halves, then both products as three
TF32 ``wgmma`` passes (3xTF32), bound by three TF32 products per f32 product
at 495 TFLOP/s (0.148 ms at the f32 export's [32, 12, 499, 499, 64]). K4 in
bf16 at head dim 64 is a Hopper design of its own, and in f32 at head dim 64
runs the same three launches in 3xTF32 (a prep pass writes the TF32 halves
of q, g, K, V and of the transposes q^T, g^T, K^T). Other head dims (the
fusion model's 96 and 50) and unaligned tensors take two kernel templates,
one forward for K1 and K3 (``csrc/flash_attention_forward.cuh``) and one
backward for K2 and K4 (``csrc/flash_attention_backward.cuh``), on the
tensor-core tile products of ``csrc/flash_attention_tiles.cuh`` in bf16
(``mma.sync``; f32 by FMA on the CUDA cores, bound by the f32 rate); K2 is
the template alone. All draw dropout with the Philox generator
``csrc/philox.cuh``; the templates take several (b*h) slices a block for
sequences up to 32 rows. Each source's header states its design and bound.

Dispatch by key count: :func:`flash_attention_forward` runs K1 up to
``STREAM_THRESHOLD`` keys and K3 above; :func:`flash_attention_backward` runs
K2 up to ``BWD_FUSED_MAX`` keys and K4 above; :func:`flash_attention_stream`
and :func:`flash_attention_tiled_backward` run K3 and K4 at any key count,
:func:`flash_attention_fused_backward` K2 up to ``FUSED_KERNEL_MAX``. The
two thresholds rest on the card's crossover rows
(``python -m mer_tpu_torch.scripts.bench_attention --crossover``, PERF.md):
K1 and K3 run one design at head dim 64, so the forward keeps
``mer_tpu``'s place (``_flash_impl`` ``:510``); K4's Hopper design beats K2
from 48 keys up, so the backward takes K2 for the fusion model's dialogue
buckets alone (``mer_tpu``'s ``_flash_bwd_impl`` switches at 2,048 keys,
``:197-200``).
Each kernel's wrapper launches it for CUDA tensors and takes its plain
version only for CPU tensors, so the CPU runs the algebra the card runs;
:class:`FlashAttention` makes one differentiable op of the two directions, on
either device. Each wrapper counts its kernel's launches in ``.launches``:
:func:`flash_attention_forward` K1's, :func:`flash_attention_stream` K3's,
:func:`flash_attention_backward` K2's, :func:`flash_attention_tiled_backward`
K4's; K1's and K4's ``.routes`` count them again by the design their C entry
took.

Semantics (every version): q [B, H, Sq, Dh], k/v [B, H, Sk, Dh] in float32 or
bfloat16 (the plain versions also take float64); ``key_padding_mask`` [B, Sk]
bool, True = ignore that key, adds -1e30 to its scores; scale 1/sqrt(Dh)
applied to q; softmax and logsumexp in float32 (float64 for float64 inputs).
The forward returns ``out`` [B, H, Sq, Dh] in q's dtype and ``lse``
[B, H, Sq] (the per-row logsumexp of the undropped scores). Every version
rounds the probabilities after dropout (and the backwards' dS) to the input
dtype before their products with v (and k, q, g), as the TPU's forward
kernels do with ``p.astype(v.dtype)``; the TPU's fused backward keeps P o D
and dS in f32, K2 and its plain version round them as K4 does. In f32 none of
this rounds anything.

Dropout (training, torch MHA semantics): the *normalised* probabilities are
multiplied by D = keep / (1 - rate). The keep bit of probability (row, col)
of head ``b * H + h`` is a pure function of the two seed words and those
indices (Philox4x32-10 at counter (col >> 1, row >> 1, b*H + h, 0), output
word 2 (row & 1) + (col & 1): one call per 2 x 2 block of scores; keep iff
bits >= min(int(rate * 2**32), 2**32 - 1)), so the forward kernel,
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
# Above this many keys the forward is K3, up to it K1; above BWD_FUSED_MAX keys the backward is K4, up to it K2. Both
# rest on the card's crossover rows (bench_attention --crossover, recorded in PERF.md). At head dim 64 K1 and K3
# launch one design (csrc/flash_attention_hopper.cuh), so STREAM_THRESHOLD keeps mer_tpu's value. K4's Hopper design
# (bf16, Dh 64) is faster than K2 at every row from 48 keys up (B x H = 192 at 48-499 keys, down to 24 at 2,048;
# dropout 0 and 0.1), so BWD_FUSED_MAX is the fusion model's largest dialogue bucket, 33: K2 keeps the buckets, where
# it packs 2 or 4 slices a block, and its kernel still takes up to FUSED_KERNEL_MAX keys for the crossover rows.
STREAM_THRESHOLD = 4096
BWD_FUSED_MAX = 33
FUSED_KERNEL_MAX = 2048
BLOCK_K = 512  # the plain streaming and tiled versions' key tile (the TPU kernels')
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
    """The 32 random bits (int64) of probability (row, col) of head ``bh``:
    word 2 (row & 1) + (col & 1) of Philox at counter (col >> 1, row >> 1, bh,
    0), one call per 2 x 2 block of scores (``csrc/philox.cuh``). The index
    tensors broadcast."""
    row, col = (torch.as_tensor(x, dtype=torch.int64) for x in (row, col))
    w = philox4x32((col >> 1, row >> 1, bh, 0), seed)
    odd_col = (col & 1).bool()
    return torch.where((row & 1).bool(), torch.where(odd_col, w[3], w[2]), torch.where(odd_col, w[1], w[0]))


def dropout_threshold(rate: float) -> int:
    """Keep iff bits >= this: P(keep) = 1 - rate to 2**-32 (as ``:68``)."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def dropout_factor(seed, shape, rate: float, device=None, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """D for a [B, H, Sq, Sk] block of probabilities starting at query row
    ``row0`` and key ``col0``: 1 / (1 - rate) where kept, 0 where dropped (f32).
    :func:`philox_bits` with one Philox call per 2 x 2 block: the blocks that
    the rows and columns touch, their four words laid out in place, then cut
    to the rows and columns asked for (odd ``row0`` or ``col0`` included)."""
    b, h, sq, sk = shape
    r_lo, c_lo = row0 >> 1, col0 >> 1
    n_r, n_c = ((row0 + sq + 1) >> 1) - r_lo, ((col0 + sk + 1) >> 1) - c_lo
    idx = lambda n, start: torch.arange(start, start + n, dtype=torch.int64, device=device)
    bh = idx(b * h, 0).view(b, h, 1, 1)
    w = [x.expand(b, h, n_r, n_c) for x in
         philox4x32((idx(n_c, c_lo).view(1, 1, 1, n_c), idx(n_r, r_lo).view(1, 1, n_r, 1), bh, 0), seed)]
    # [.., n_r, row parity, n_c, column parity] -> rows and columns from 2 r_lo and 2 c_lo
    bits = torch.stack([torch.stack(w[:2], -1), torch.stack(w[2:], -1)], -3).reshape(b, h, 2 * n_r, 2 * n_c)
    bits = bits[:, :, row0 & 1:(row0 & 1) + sq, col0 & 1:(col0 & 1) + sk]
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
    """Plain PyTorch version of the forward kernel K1: ``(out, lse)``. The
    probabilities (after dropout) are rounded to v's dtype before the product
    with v, as the TPU kernel's ``p.astype(v.dtype)`` (``:117``)."""
    acc = _acc_dtype(q.dtype)
    scores = _scores(q, k, key_padding_mask, acc)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    if _dropout_args(seed, dropout_rate)[0]:
        probs = probs * dropout_factor(seed, probs.shape, dropout_rate, q.device).to(acc)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).to(acc), v.to(acc)).to(q.dtype)
    return out, lse


def _key_tiles(k, key_padding_mask, block_k: int = BLOCK_K):
    """(start, end, mask tile) of each ``block_k``-key tile of the key axis."""
    for k0 in range(0, k.shape[2], block_k):
        k1 = min(k0 + block_k, k.shape[2])
        yield k0, k1, None if key_padding_mask is None else key_padding_mask[:, k0:k1]


def flash_attention_stream_reference(q, k, v, key_padding_mask=None, seed=None, dropout_rate: float = 0.0):
    """Plain PyTorch version of the streaming forward K3: ``(out, lse)`` by an
    online softmax over ``BLOCK_K``-key tiles (``_stream_kernel``'s
    algebra, ``mer_tpu/ops/flash_attention.py:436-462``), P o D rounded to the
    input dtype before the product with v. Memory O(Sq x BLOCK_K)."""
    acc = _acc_dtype(q.dtype)
    drop = _dropout_args(seed, dropout_rate)[0]
    b, h, sq, dh = q.shape
    m = torch.full((b, h, sq, 1), float("-inf"), dtype=acc, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=acc, device=q.device)
    o = torch.zeros((b, h, sq, dh), dtype=acc, device=q.device)
    for k0, k1, mask in _key_tiles(k, key_padding_mask):
        s = _scores(q, k[:, :, k0:k1], mask, acc)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))  # finite from the first tile on (it holds key 0)
        p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if drop:
            p = p * dropout_factor(seed, p.shape, dropout_rate, q.device, col0=k0).to(acc)
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), v[:, :, k0:k1].to(acc))
        m = m_new
    l = l.clamp_min(1e-30)
    return (o / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _backward_reference(q, k, v, key_padding_mask, out, lse, g, seed, dropout_rate, g_lse, block_k: int):
    """``(dq, dk, dv)`` per ``block_k``-key tile from the saved lse: the one
    rule of both backward kernels. P o D and dS are rounded to the input
    dtype before their products (no rounding in f32); a fully masked row
    takes P = 1/Sk."""
    acc = _acc_dtype(q.dtype)
    drop = _dropout_args(seed, dropout_rate)[0]
    scale = 1.0 / math.sqrt(q.shape[-1])
    sk = k.shape[2]
    qf, gf = q.to(acc), g.to(acc)
    lse = lse.to(acc)[..., None]
    delta = (gf * out.to(acc)).sum(-1, keepdim=True)
    if g_lse is not None:
        delta = delta - g_lse.to(acc)[..., None]
    dq = torch.zeros_like(qf)
    dk, dv = [], []
    for k0, k1, mask in _key_tiles(k, key_padding_mask, block_k):
        kt, vt = k[:, :, k0:k1].to(acc), v[:, :, k0:k1].to(acc)
        s = _scores(q, k[:, :, k0:k1], mask, acc)
        p = torch.where(lse < FULLY_MASKED_LSE, 1.0 / sk, torch.exp(s - lse))
        dp = torch.einsum("bhqd,bhkd->bhqk", gf, vt)
        p_dropped = p
        if drop:
            factor = dropout_factor(seed, p.shape, dropout_rate, q.device, col0=k0).to(acc)
            dp, p_dropped = dp * factor, p * factor
        ds = (p * (dp - delta)).to(q.dtype).to(acc)
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kt)
        dk.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale)
        dv.append(torch.einsum("bhqk,bhqd->bhkd", p_dropped.to(q.dtype).to(acc), gf))
    return (dq * scale).to(q.dtype), torch.cat(dk, 2).to(k.dtype), torch.cat(dv, 2).to(v.dtype)


def flash_attention_backward_reference(q, k, v, key_padding_mask, out, lse, g, seed=None,
                                       dropout_rate: float = 0.0, g_lse=None):
    """Plain PyTorch version of the fused backward K2: ``(dq, dk, dv)`` from
    the forward's inputs, its ``out`` and ``lse``, the cotangent ``g`` of out
    and (optionally) ``g_lse`` of lse, all keys as one tile (``_bwd_kernel``'s
    algebra). P is recomputed from lse, a fully masked row taking 1/Sk per
    key, as the kernel does; P o D and dS are rounded to the input dtype
    before their products, as K2 and K4 do (the TPU kernel keeps them in f32)."""
    return _backward_reference(q, k, v, key_padding_mask, out, lse, g, seed, dropout_rate, g_lse, k.shape[2])


def flash_attention_tiled_backward_reference(q, k, v, key_padding_mask, out, lse, g, seed=None,
                                             dropout_rate: float = 0.0, g_lse=None):
    """Plain PyTorch version of the key-tiled backward K4: ``(dq, dk, dv)``
    per ``BLOCK_K``-key tile from the saved lse (``_flash_bwd_tiled``'s
    algebra), the rule of :func:`flash_attention_backward_reference`. A fully
    masked row takes P = 1/Sk, as K2 does (``mer_tpu``'s tiled backward takes
    1 there). Memory O(Sq x BLOCK_K)."""
    return _backward_reference(q, k, v, key_padding_mask, out, lse, g, seed, dropout_rate, g_lse, BLOCK_K)


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


def _launch(name: str, q, pointers, sk: int, drop) -> None:
    """Launch kernel ``name`` on q's device and current stream; raises on a
    refused launch."""
    b, h, sq, dh = q.shape
    fn = _kernel_fn(name, len(pointers))
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], *pointers, b, h, sq, sk, dh, 1.0 / math.sqrt(dh), *drop,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _forward_outputs(q, sk: int):
    """out, lse and the f32 scratch of a K1 or K3 call: :func:`tf32_scratch_numel` floats in f32 at head dim 64 (the
    3xTF32 forward's prep pass), else none."""
    b, h, _, dh = q.shape
    n = tf32_scratch_numel(b, h, sk) if q.dtype == torch.float32 and dh == 64 else 0
    return (torch.empty_like(q), torch.empty(q.shape[:3], dtype=torch.float32, device=q.device),
            torch.empty(n, dtype=torch.float32, device=q.device))


FORWARD_ROUTES = ("template", "wgmma_bf16", "wgmma_tf32")  # K1's designs, by the route code its C entry writes


def flash_attention_forward(q, k, v, key_padding_mask=None, seed=None, dropout_rate: float = 0.0):
    """``(out, lse)`` of masked attention. Above ``STREAM_THRESHOLD`` keys
    through :func:`flash_attention_stream` (K3); else K1 for CUDA tensors,
    its plain version for CPU tensors. ``flash_attention_forward.launches``
    counts K1's launches (one per call), ``.routes`` the same by the design
    that the C entry took (``FORWARD_ROUTES``): ``wgmma_bf16`` for bf16 at
    head dim 64 with 16-byte aligned q, k, v and out (the Hopper forward K3
    shares: one launch), ``wgmma_tf32`` for f32 at head dim 64 with 16-byte
    aligned tensors (a prep pass splits K and V^T into TF32 halves,
    ``tf32_scratch_numel`` floats, then the 3xTF32 forward runs),
    ``template`` otherwise (the fusion model's head dims 96 and 50)."""
    if k.shape[2] > STREAM_THRESHOLD:
        return flash_attention_stream(q, k, v, key_padding_mask, seed, dropout_rate)
    if not _device_or_raise(q):
        return flash_attention_reference(q, k, v, key_padding_mask, seed, dropout_rate)
    return _k1(q, k, v, key_padding_mask, seed, dropout_rate)


def _k1(q, k, v, key_padding_mask, seed, dropout_rate: float, route: int = -1):
    """One K1 launch on CUDA tensors, counted in ``flash_attention_forward.launches`` and ``.routes``. ``route``
    -1 takes the C entry's design; 0 takes the template whatever the call, a hook for timing the designs against
    each other on the same inputs (``bench_attention --crossover``)."""
    _check(q, k, v, key_padding_mask)
    drop = _dropout_args(seed, dropout_rate)
    out, lse, scratch = _forward_outputs(q, k.shape[2])
    taken = ctypes.c_int(route)  # in: the design asked for; out: the design launched
    _launch("flash_attention_fwd", q, [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
                                       out.data_ptr(), lse.data_ptr(), scratch.data_ptr(), ctypes.addressof(taken)],
            k.shape[2], drop)
    flash_attention_forward.launches += 1
    flash_attention_forward.routes[FORWARD_ROUTES[taken.value]] += 1
    return out, lse


flash_attention_forward.launches = 0
flash_attention_forward.routes = dict.fromkeys(FORWARD_ROUTES, 0)


def flash_attention_stream(q, k, v, key_padding_mask=None, seed=None, dropout_rate: float = 0.0):
    """``(out, lse)`` through the streaming forward K3 for CUDA tensors, its
    plain version for CPU tensors. ``flash_attention_stream.launches`` counts
    K3's launches (one per call). At head dim 64 with 16-byte aligned
    tensors it runs K1's Hopper designs: in bf16 one launch, in f32 a prep
    pass writing the keys' biases and K's and V^T's TF32 halves
    (``tf32_scratch_numel`` floats), then the 3xTF32 forward; other head
    dims take the template K1 shares."""
    if not _device_or_raise(q):
        return flash_attention_stream_reference(q, k, v, key_padding_mask, seed, dropout_rate)
    _check(q, k, v, key_padding_mask)
    drop = _dropout_args(seed, dropout_rate)
    out, lse, scratch = _forward_outputs(q, k.shape[2])
    _launch("flash_attention_stream", q, [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
                                          out.data_ptr(), lse.data_ptr(), scratch.data_ptr()], k.shape[2], drop)
    flash_attention_stream.launches += 1
    return out, lse


flash_attention_stream.launches = 0


def tf32_scratch_numel(b: int, h: int, sk: int) -> int:
    """f32 scratch of one K1 or K3 call in f32 at head dim 64 (the 3xTF32
    Hopper forward's prep pass): per key of each batch element its bias in
    log2 units, then K's TF32 halves [2, B*H, Sk padded, 64] and V^T's [2,
    B*H, 64, Sk padded], keys padded to 64."""
    pad = -(-sk // 64) * 64
    return b * pad + 4 * b * h * pad * 64


def _backward_args(q, k, v, key_padding_mask, out, lse, g, seed, dropout_rate, g_lse, scratch_numel=None):
    """Checks a backward call; returns (dq, dk, dv, f32 scratch, dropout args).
    The scratch is delta [B, H, Sq] between the two grids, or ``scratch_numel``
    floats."""
    _check(q, k, v, key_padding_mask)
    _check_like("out", out, q.shape, q.dtype, q.device)
    _check_like("g", g, q.shape, q.dtype, q.device)
    _check_like("lse", lse, q.shape[:3], torch.float32, q.device)
    if g_lse is not None:
        _check_like("g_lse", g_lse, q.shape[:3], torch.float32, q.device)
    drop = _dropout_args(seed, dropout_rate)
    shape = q.shape[:3] if scratch_numel is None else (scratch_numel,)
    scratch = torch.empty(shape, dtype=torch.float32, device=q.device)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), scratch, drop


def tiled_scratch_numel(b: int, h: int, sq: int, sk: int, dropout: bool, tf32: bool = False) -> int:
    """f32 scratch of one K4 call: per query row its lse, delta and
    fully-masked probability, per key its bias, rows padded to 64, and with
    dropout the keep bits the dq kernel hands the dk/dv kernel (the Hopper
    designs'; the older design takes delta [B, H, Sq] from its head). With
    ``tf32`` (f32 at head dim 64, the 3xTF32 design) the prep pass's TF32
    halves follow: q's and g's [4, B*H, Sq padded, 64] (q hi, q lo, g hi, g
    lo), their transposes [4, B*H, 64, Sq padded], K's and V's [4, B*H, Sk
    padded, 64] and K^T's [2, B*H, 64, Sk padded]."""
    pad = lambda n: -(-n // 64) * 64
    n = 3 * b * h * pad(sq) + b * pad(sk) + (b * h * pad(sq) * pad(sk) // 32 if dropout else 0)
    return n + (b * h * 64 * (8 * pad(sq) + 6 * pad(sk)) if tf32 else 0)


TILED_ROUTES = ("template", "wgmma_bf16", "wgmma_tf32")  # K4's designs, by the route code its C entry records


def _tiled_route() -> str:
    """The design K4's last call launched, as its C entry recorded it."""
    fn = _build.load("flash_attention_tiled_bwd").mer_flash_attention_tiled_bwd_route
    fn.argtypes, fn.restype = [], ctypes.c_int
    return TILED_ROUTES[fn()]


def flash_attention_backward(q, k, v, key_padding_mask, out, lse, g, seed=None, dropout_rate: float = 0.0,
                             g_lse=None):
    """``(dq, dk, dv)``. Above ``BWD_FUSED_MAX`` keys through
    :func:`flash_attention_tiled_backward` (K4), else through
    :func:`flash_attention_fused_backward` (K2).
    ``flash_attention_backward.launches`` counts K2's launches (one per call:
    the dq and the dk/dv grids)."""
    if k.shape[2] > BWD_FUSED_MAX:
        return flash_attention_tiled_backward(q, k, v, key_padding_mask, out, lse, g, seed, dropout_rate, g_lse)
    return flash_attention_fused_backward(q, k, v, key_padding_mask, out, lse, g, seed, dropout_rate, g_lse)


flash_attention_backward.launches = 0


def flash_attention_fused_backward(q, k, v, key_padding_mask, out, lse, g, seed=None, dropout_rate: float = 0.0,
                                   g_lse=None):
    """``(dq, dk, dv)`` through the fused backward K2 for CUDA tensors (its
    kernel takes up to ``FUSED_KERNEL_MAX`` keys, whatever the dispatch
    picks: the crossover rows time it above ``BWD_FUSED_MAX``), its plain
    version for CPU tensors. Its launches count in
    ``flash_attention_backward.launches``."""
    if not _device_or_raise(q):
        return flash_attention_backward_reference(q, k, v, key_padding_mask, out, lse, g, seed, dropout_rate,
                                                  g_lse)
    dq, dk, dv, delta, drop = _backward_args(q, k, v, key_padding_mask, out, lse, g, seed, dropout_rate, g_lse)
    _launch("flash_attention_bwd", q, [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
                                       out.data_ptr(), lse.data_ptr(), g.data_ptr(), _ptr(g_lse), dq.data_ptr(),
                                       dk.data_ptr(), dv.data_ptr(), delta.data_ptr()], k.shape[2], drop)
    flash_attention_backward.launches += 1
    return dq, dk, dv


def flash_attention_tiled_backward(q, k, v, key_padding_mask, out, lse, g, seed=None, dropout_rate: float = 0.0,
                                   g_lse=None):
    """``(dq, dk, dv)`` through the key-tiled backward K4 for CUDA tensors, its
    plain version for CPU tensors. ``flash_attention_tiled_backward.launches``
    counts K4's launches (one per call: prep, dq and dk/dv kernels, or the
    older design's two grids), ``.routes`` the same by the design that the
    C entry took (``TILED_ROUTES``): ``wgmma_bf16`` for bf16 and
    ``wgmma_tf32`` for f32 at head dim 64 with 16-byte aligned tensors,
    ``template`` otherwise."""
    if not _device_or_raise(q):
        return flash_attention_tiled_backward_reference(q, k, v, key_padding_mask, out, lse, g, seed,
                                                        dropout_rate, g_lse)
    tf32 = q.dtype == torch.float32 and q.shape[3] == 64
    dq, dk, dv, scratch, drop = _backward_args(q, k, v, key_padding_mask, out, lse, g, seed, dropout_rate, g_lse,
                                               tiled_scratch_numel(*q.shape[:3], k.shape[2], dropout_rate > 0, tf32))
    _launch("flash_attention_tiled_bwd", q, [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
                                             out.data_ptr(), lse.data_ptr(), g.data_ptr(), _ptr(g_lse),
                                             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr()],
              k.shape[2], drop)
    flash_attention_tiled_backward.launches += 1
    flash_attention_tiled_backward.routes[_tiled_route()] += 1
    return dq, dk, dv


flash_attention_tiled_backward.launches = 0
flash_attention_tiled_backward.routes = dict.fromkeys(TILED_ROUTES, 0)


class FlashAttention(torch.autograd.Function):
    """``out, lse = FlashAttention.apply(q, k, v, key_padding_mask, seed,
    dropout_rate)``: forward through :func:`flash_attention_forward`,
    backward through :func:`flash_attention_backward`, each dispatching by
    key count, so the kernels on the card and the plain versions on the CPU.
    The lse cotangent reaches K2 and K4 alike. Both directions run with autocast
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
