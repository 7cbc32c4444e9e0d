"""The wav2vec2 conv frontend's kernels K7 and K6 (hand-written CUDA) and
their plain versions.

Replaces the TPU kernels of ``mer_tpu/ops/w2v_conv_pallas.py``:

- K7, :func:`layer0_gn`: ``layer0_gn_pallas`` (``:227``; ``_l0_stats_kernel``
  ``:194`` and ``_l0_apply_kernel`` ``:214``). Waveforms [B, L] -> conv (k 10,
  stride 5, 1 -> 512 channels, no bias) -> GroupNorm(512, 512), i.e. per
  (clip, channel) statistics over all T0 frames -> exact GELU -> [B, T0, 512].
- K6, :func:`conv_stack_fused`: ``conv_stack_fused`` (``:467``; ``_kernel``
  ``:135``), conv layers 1..6 (k 3, 3, 3, 3, 2, 2, stride 2, 512 -> 512, no
  bias) with the exact GELU after each: [B, T0, 512] -> [B, T6, 512].

The CUDA sources are ``mer_tpu_torch/csrc/w2v_layer0_gn.cu`` and
``w2v_conv_tail.cu``; their headers state the design and the bound. The
wrappers launch them for CUDA tensors, with no switch and no fallback, and
take the plain versions (:func:`layer0_gn_reference`,
:func:`conv_tail_reference`: stock ``F.conv1d``, ``F.group_norm``, ``F.gelu``)
only for CPU tensors. The kernels know the base geometry only; any other
raises ``ValueError`` on the card, while the plain versions take any.

Numerics, every version: the waveform and the weights are cast to the compute
dtype first; products and sums are float32 on those values; GroupNorm
statistics and the GELU are float32; the activation is rounded to the compute
dtype once per layer, after its GELU. The plain versions get there by running
the float32 ops on the rounded values, so float32 on the card means TF32 off
(``torch.backends.cudnn.allow_tf32 = False``), as the entry points set it.

Layout: activations are [B, T, C], channels last, as ``mer_tpu`` keeps them;
weights arrive in the ``state_dict`` layout [C_out, C_in, k] and are restacked
for the kernels (K7 tap-major, K6 per output channel). Forward only: the TPU kernels have no backward, and
a CUDA input that requires grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from mer_tpu_torch.ops import _build

L0_KERNEL = "w2v_layer0_gn"
TAIL_KERNEL = "w2v_conv_tail"
CHANNELS = 512
L0_TAPS, L0_STRIDE = 10, 5
TAIL_TAPS = (3, 3, 3, 3, 2, 2)
TAIL_STRIDES = (2, 2, 2, 2, 2, 2)
_L0_TILE = 256  # frames per block of K7's passes (kTileT in the source)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def conv_out_length(length: int, taps: int, stride: int) -> int:
    return (length - taps) // stride + 1


def tail_lengths(t0: int) -> list[int]:
    """Frame counts after each of the layers 1..6 for ``t0`` layer-0 frames."""
    out = []
    for k, s in zip(TAIL_TAPS, TAIL_STRIDES):
        t0 = conv_out_length(t0, k, s)
        out.append(t0)
    return out


# -- plain versions --------------------------------------------------------------


def layer0_gn_reference(wave: torch.Tensor, weight: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        *, stride: int = L0_STRIDE, eps: float = 1e-5,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K7, any geometry: wave [B, L], weight
    [C, 1, k], gamma / beta [C] -> [B, T0, C] in ``dtype``."""
    x = F.conv1d(wave.to(dtype).float()[:, None, :], weight.to(dtype).float(), stride=stride)  # [B, C, T0] f32
    x = F.group_norm(x, x.shape[1], gamma.float(), beta.float(), eps)
    return F.gelu(x).transpose(1, 2).to(dtype).contiguous()


def conv_tail_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        strides: Sequence[int] = TAIL_STRIDES) -> torch.Tensor:
    """Plain PyTorch version of K6, any geometry: x [B, T, C] in the compute
    dtype, ``weights`` [C_out, C_in, k] per layer -> [B, T_last, C_last] in
    x's dtype, recast to it after every layer's GELU."""
    dtype = x.dtype
    x = x.transpose(1, 2)  # [B, C, T]
    for w, s in zip(weights, strides):
        x = F.gelu(F.conv1d(x.float(), w.to(dtype).float(), stride=s)).to(dtype)
    return x.transpose(1, 2).contiguous()


# -- kernels -----------------------------------------------------------------------


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {t.device}")
    if t.requires_grad:
        raise ValueError(f"the {what} kernel is forward-only; its input must not require grad")
    return True


def check_layer0_geometry(weight: torch.Tensor, stride: int) -> None:
    """Raise unless (weight, stride) is the base layer 0, the only one K7 knows."""
    if tuple(weight.shape) != (CHANNELS, 1, L0_TAPS) or stride != L0_STRIDE:
        raise ValueError("the layer-0 kernel supports the base layer-0 geometry only (k 10, stride 5, 512 channels); "
                         f"got weight {tuple(weight.shape)}, stride {stride}")


def check_tail_geometry(weights: Sequence[torch.Tensor], strides: Sequence[int]) -> None:
    """Raise unless (weights, strides) are the base layers 1..6, the only ones K6 knows."""
    geometry = (tuple(tuple(w.shape) for w in weights), tuple(strides))
    if geometry != (tuple((CHANNELS, CHANNELS, k) for k in TAIL_TAPS), TAIL_STRIDES):
        raise ValueError("the conv-tail kernel supports the base conv geometry only (k 3, 3, 3, 3, 2, 2, stride 2, "
                         f"512 channels); got weights {geometry[0]}, strides {geometry[1]}")


def _l0_kernel_fn():
    fn = getattr(_build.load(L0_KERNEL), f"mer_{L0_KERNEL}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _tail_kernel_fn():
    fn = getattr(_build.load(TAIL_KERNEL), f"mer_{TAIL_KERNEL}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def layer0_gn(wave: torch.Tensor, weight: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              *, stride: int = L0_STRIDE, eps: float = 1e-5, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """wave [B, L] -> [B, T0, C] in ``dtype``: kernel K7 for CUDA tensors (the
    base geometry only: k 10, stride 5, 512 channels), the plain version for
    CPU tensors. ``layer0_gn.launches`` counts kernel launches (one per call:
    the stats, finalize and apply grids)."""
    if not _on_card(wave, "layer-0"):
        return layer0_gn_reference(wave, weight, gamma, beta, stride=stride, eps=eps, dtype=dtype)
    check_layer0_geometry(weight, stride)
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    if wave.dim() != 2 or wave.shape[1] < L0_TAPS or not wave.is_floating_point():
        raise ValueError(f"expected floating-point waveforms [B, L >= {L0_TAPS}]; got {wave.dtype} "
                         f"{tuple(wave.shape)}")
    b, length = wave.shape
    t0 = conv_out_length(length, L0_TAPS, L0_STRIDE)
    out = torch.empty((b, t0, CHANNELS), dtype=dtype, device=wave.device)
    if b == 0:
        return out
    wave = wave.to(dtype).contiguous()
    taps = weight.detach().to(dtype)[:, 0, :].t().contiguous()  # [10, 512], tap-major
    gamma, beta = (p.detach().float().contiguous() for p in (gamma, beta))
    n_tiles = -(-t0 // _L0_TILE)
    partial = torch.empty((b, n_tiles, 2, CHANNELS), dtype=torch.float32, device=wave.device)
    stats = torch.empty((b, 2, CHANNELS), dtype=torch.float32, device=wave.device)
    with torch.cuda.device(wave.device):
        rc = _l0_kernel_fn()(_DTYPE_CODE[dtype], wave.data_ptr(), taps.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                             partial.data_ptr(), stats.data_ptr(), out.data_ptr(), b, length, t0, n_tiles, float(eps),
                             torch.cuda.current_stream(wave.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{L0_KERNEL} launch failed: cudaError {rc} at wave {tuple(wave.shape)} {dtype}")
    layer0_gn.launches += 1
    return out


layer0_gn.launches = 0


def stack_tail_weights(weights: Sequence[torch.Tensor], dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """[C_out, C_in, k] weights of layers 1..6 -> (w3 [4, C, 3 C], w2 [2, C, 2 C])
    in ``dtype``: row c_out, column j * C + c_in, the layout K6 reads (each
    output channel's taps contiguous, as a window's values are); the transpose
    of ``_stack_weights``' tap-major matrices (``w2v_conv_pallas.py:140``)."""
    rows = [w.detach().to(dtype).permute(0, 2, 1).reshape(w.shape[0], -1) for w in weights]
    return torch.stack(rows[:4]).contiguous(), torch.stack(rows[4:]).contiguous()


def conv_stack_fused(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     strides: Sequence[int] = TAIL_STRIDES) -> torch.Tensor:
    """x [B, T0, C] (the layer-0 output, in the compute dtype) -> [B, T6, C]:
    kernel K6 for CUDA tensors (the base geometry only), the plain version
    for CPU tensors. ``conv_stack_fused.launches`` counts kernel launches (one
    per call: six grids, one per layer)."""
    if not _on_card(x, "conv-tail"):
        return conv_tail_reference(x, weights, strides)
    check_tail_geometry(weights, strides)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or x.shape[2] != CHANNELS or not x.is_contiguous():
        raise ValueError(f"expected a contiguous activation [B, T0, {CHANNELS}]; got {tuple(x.shape)}, "
                         f"strides {x.stride()}")
    b, t0, _ = x.shape
    lengths = tail_lengths(t0)
    if lengths[-1] <= 0:
        raise ValueError(f"{t0} layer-0 frames leave no frame after the six layers")
    new = lambda t: torch.empty((b, t, CHANNELS), dtype=x.dtype, device=x.device)
    out = new(lengths[-1])
    if b == 0:
        return out
    w3, w2 = stack_tail_weights(weights, x.dtype)
    buf_a, buf_b = new(lengths[0]), new(lengths[1])
    with torch.cuda.device(x.device):
        rc = _tail_kernel_fn()(_DTYPE_CODE[x.dtype], x.data_ptr(), w3.data_ptr(), w2.data_ptr(), buf_a.data_ptr(),
                               buf_b.data_ptr(), out.data_ptr(), b, t0,
                               torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{TAIL_KERNEL} launch failed: cudaError {rc} at x {tuple(x.shape)} {x.dtype}")
    conv_stack_fused.launches += 1
    return out


conv_stack_fused.launches = 0
