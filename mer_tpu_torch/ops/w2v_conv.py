"""The wav2vec2 conv frontend's kernels K7, K6 and K8 (hand-written CUDA) and
their plain versions.

Replaces the TPU kernels of ``mer_tpu/ops/w2v_conv_pallas.py``:

- K7, :func:`layer0_gn`: ``layer0_gn_pallas`` (``:227``; ``_l0_stats_kernel``
  ``:194`` and ``_l0_apply_kernel`` ``:214``). Waveforms [B, L] -> conv (k 10,
  stride 5, 1 -> 512 channels, no bias) -> GroupNorm(512, 512), i.e. per
  (clip, channel) statistics over all T0 frames -> exact GELU -> [B, T0, 512].
- K6, :func:`conv_stack_fused`: ``conv_stack_fused`` (``:467``; ``_kernel``
  ``:135``), conv layers 1..6 (k 3, 3, 3, 3, 2, 2, stride 2, 512 -> 512, no
  bias) with the exact GELU after each: [B, T0, 512] -> [B, T6, 512]. Its
  bf16 path is Hopper's: per layer an implicit GEMM on ``wgmma`` whose
  operands TMA brings into an ``mbarrier`` ring under a producer warp, the
  layer-0 frames read as pair rows and even frames (the TPU kernel's
  ``_fold_pairs``), so that every load stays inside the tensor; the f32 path
  runs the same pipeline on TF32 with error compensation (3xTF32: each
  operand split into a TF32 high and low half, three products a step), which
  keeps f32's accuracy.
- K8, :func:`gn_gelu`: ``gn_gelu_pallas`` (``:345``; ``_gn_stats_kernel``
  ``:320`` and ``_gn_apply_kernel`` ``:335``), the GroupNorm(512, 512) and
  exact GELU alone, on a layer-0 conv output [B, T, 512] that something else
  computed, with the statistics over the rows ``< t_valid`` only. It serves
  :func:`conv_stack_gnfused` (stock convs + K8); :func:`conv_stack_l0fused`
  is K7 + stock tail convs. Both are the profiling variants of
  ``mer_tpu_torch.scripts.profile_w2v_conv``.

The CUDA sources are ``mer_tpu_torch/csrc/w2v_layer0_gn.cu``,
``w2v_conv_tail.cu`` and ``w2v_gn_gelu.cu``; their headers state the design
and the bound. :func:`conv_plan` sizes K7's and K6's tiles from the grid,
so that batch-2 calls fill the card's 132 SMs: K7's tile length, and per K6
layer a 128 x 128 or 64 x 128 tile and, where even the smaller leaves SMs
idle, K split into parts that the kernel adds in a fixed order (no float
atomics: two calls give the same bits). The wrappers launch them for CUDA
tensors, with no switch and
no fallback, and take the plain versions (:func:`layer0_gn_reference`,
:func:`conv_tail_reference`, :func:`gn_gelu_reference`) only for CPU tensors. The kernels know the base geometry only; any other
raises ``ValueError`` on the card, while the plain versions take any.

Numerics, every version: the waveform and the weights are cast to the compute
dtype first; products and sums are float32 on those values; GroupNorm
statistics and the GELU are float32; the activation is rounded to the compute
dtype once per layer, after its GELU. The plain versions get there by running
the float32 ops on the rounded values, so float32 on the card means TF32 off
(``torch.backends.cudnn.allow_tf32 = False``), as the entry points set it.

Layout: activations are [B, T, C], channels last, as ``mer_tpu`` keeps them;
weights arrive in the ``state_dict`` layout [C_out, C_in, k] and are restacked
for the kernels (K7 tap-major, K6 per output channel). Forward only: the TPU
kernels have no backward (``w2v_conv_pallas.py`` has no ``custom_vjp``;
``mer_tpu`` trains through the XLA convs of its ``ConvFeatureExtractor``), so on
the card a wrapper called with grad enabled on an input or parameter that
requires grad raises: a kernel result carries no ``grad_fn`` and must never
enter a graph. The model takes :func:`conv_stack_stock`, the differentiable
stock route, whenever the frontend trains.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from mer_tpu_torch.ops import _build

L0_KERNEL = "w2v_layer0_gn"
TAIL_KERNEL = "w2v_conv_tail"
GN_KERNEL = "w2v_gn_gelu"
CHANNELS = 512
L0_TAPS, L0_STRIDE = 10, 5
TAIL_TAPS = (3, 3, 3, 3, 2, 2)
TAIL_STRIDES = (2, 2, 2, 2, 2, 2)
_GN_TILE = 128  # rows per block of K8's passes (kTileT in the source)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132  # streaming multiprocessors of the H100 SXM: a grid of fewer blocks leaves some idle
L0_TILES = (256, 128, 64, 32)  # K7's frames per block, by preference
L0_BLOCKS_PER_SM = 2  # K7's apply blocks resident per SM (256 threads of 128 registers)
L0_MOMENTS = 65  # K7's window moments per tile: 10 sums and 55 products (kMoments in the source)
TAIL_TILES = (2, 1)  # K6's tiles by preference: consumer warpgroups of 64 frames (128 x 128, 64 x 128)
TAIL_TILE_CHANNELS = 128  # output channels of every K6 tile (kBN in the source)
TAIL_K_SLICE = 64  # k per stage of K6's bf16 ring (kBK in the source; f32 stages hold 32)
_CACHE_SIZE = 4  # restacked weight sets kept (see _restacked)
_restacked_cache: list = []


def conv_out_length(length: int, taps: int, stride: int) -> int:
    return (length - taps) // stride + 1


def tail_lengths(t0: int) -> list[int]:
    """Frame counts after each of the layers 1..6 for ``t0`` layer-0 frames."""
    out = []
    for k, s in zip(TAIL_TAPS, TAIL_STRIDES):
        t0 = conv_out_length(t0, k, s)
        out.append(t0)
    return out


def tail_blocks(clips: int, t_out: int, warpgroups: int, splits: int = 1) -> int:
    """Blocks of one K6 layer's grid: (512 / 128, ceil(t_out / (64 warpgroups)), clips x splits)."""
    return (CHANNELS // TAIL_TILE_CHANNELS) * -(-t_out // (64 * warpgroups)) * clips * splits


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How K7 and K6 tile one call: ``l0_tile`` frames per K7
    block (both passes), and per K6 layer (consumer warpgroups, K splits)
    of its 128-channel tile."""

    l0_tile: int
    tail: tuple[tuple[int, int], ...]


def conv_plan(clips: int, t0: int) -> ConvPlan:
    """The tiles of a call on ``clips`` clips of ``t0`` layer-0 frames, chosen
    from the grid so that it fills the card. K7: the longest tile of
    ``L0_TILES`` whose grid gives every SM ``L0_BLOCKS_PER_SM`` blocks, else
    the shortest. K6, per layer: the first tile of ``TAIL_TILES`` (128 x 128,
    then 64 x 128) whose grid has a block for every SM; where even 64 x 128
    does not, K splits into the fewest parts that reach one block per SM, at
    most one per two K slices."""
    l0 = next((t for t in L0_TILES if clips * -(-t0 // t) >= L0_BLOCKS_PER_SM * SMS), L0_TILES[-1])
    tail = []
    for taps, t_out in zip(TAIL_TAPS, tail_lengths(t0)):
        if t_out <= 0:  # no frame left: the wrapper refuses such a call
            break
        wg = next((wg for wg in TAIL_TILES if tail_blocks(clips, t_out, wg) >= SMS), TAIL_TILES[-1])
        blocks = tail_blocks(clips, t_out, wg)
        most = taps * CHANNELS // TAIL_K_SLICE // 2  # two K slices a split at least
        tail.append((wg, 1 if blocks >= SMS else min(-(-SMS // blocks), most)))
    return ConvPlan(l0, tuple(tail))


def tail_scratch(clips: int, t0: int, plan: ConvPlan) -> tuple[int, int]:
    """(f32 values, int counters) of K6's split-K scratch for ``plan`` in
    either dtype: what the split layer that needs most takes (0, 0 when no
    layer splits)."""
    values = counters = 0
    for (warpgroups, splits), t_out in zip(plan.tail, tail_lengths(t0)):
        if splits > 1:
            tiles = tail_blocks(clips, t_out, warpgroups)
            counters = max(counters, tiles)
            values = max(values, tiles * splits * 64 * warpgroups * TAIL_TILE_CHANNELS)
    return values, counters


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


def gn_gelu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, t_valid: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K8: x [B, T, C] -> [B, T, C] in x's dtype.
    Per (clip, channel) sum and sum of squares over the rows ``< t_valid`` in
    float32, the biased one-pass variance ``E[x^2] - mean^2``, then
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` and the exact GELU on
    every row."""
    xf = x.float()
    valid = xf[:, :t_valid]
    mean = valid.sum(dim=1, keepdim=True) / t_valid
    var = (valid * valid).sum(dim=1, keepdim=True) / t_valid - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return F.gelu(y).to(x.dtype)


# -- the stock route ---------------------------------------------------------------


def _stock_convs(x: torch.Tensor, weights: Sequence[torch.Tensor], strides: Sequence[int]) -> torch.Tensor:
    """x [B, C, T] through ``F.conv1d`` + exact GELU per layer, in x's dtype."""
    for w, s in zip(weights, strides):
        x = F.gelu(F.conv1d(x, w.to(x.dtype), stride=s))
    return x


def conv_stack_stock(wave: torch.Tensor, weights: Sequence[torch.Tensor], gamma: torch.Tensor, beta: torch.Tensor,
                     strides: Sequence[int], *, eps: float = 1e-5,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The whole conv stack through stock, differentiable PyTorch ops, as
    ``mer_tpu`` trains it through XLA's: wave [B, L] and the 7 conv weights
    cast to ``dtype``, ``F.conv1d`` in ``dtype``, the GroupNorm after layer 0
    with float32 statistics and its output cast back, exact GELU after every
    layer -> [B, T, C]. No kernel of this module runs."""
    x = F.conv1d(wave.to(dtype)[:, None, :], weights[0].to(dtype), stride=strides[0])
    x = F.gelu(F.group_norm(x.float(), x.shape[1], gamma.float(), beta.float(), eps).to(dtype))
    return _stock_convs(x, weights[1:], strides[1:]).transpose(1, 2)


# -- kernels -----------------------------------------------------------------------


def _on_card(what: str, x: torch.Tensor, *params: torch.Tensor) -> bool:
    """True for a CUDA ``x`` (launch the kernel), False for a CPU one. On the
    card, with grad enabled, an input or parameter that requires grad raises:
    the kernels are forward-only."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        raise ValueError(f"the {what} kernel is forward-only (the TPU kernel has no backward): with grad enabled "
                         "neither its input nor its parameters may require grad; train through conv_stack_stock")
    return True


def _restacked(kind: str, weights: Sequence[torch.Tensor], dtype: torch.dtype,
               make: Callable[[], object]):
    """``make()``, the kernels' copy of ``weights`` in ``dtype``, kept for the
    next call with the same tensors: the same objects (held by weak
    reference, so a freed tensor never matches) on the same storage (an
    assignment to ``.data``, as ``Module.to`` makes, moves it) at the same
    versions (an in-place update, such as an optimizer step, bumps a
    tensor's version). An in-place write through ``w.data`` bumps neither
    and is not seen: write weights in place under ``torch.no_grad()``, as
    optimizers and ``load_state_dict`` do. A forward would otherwise cast
    and restack 8.4 MB of weights every call. Inference tensors keep no
    version, so their copy is made anew."""
    if any(w.is_inference() for w in weights):
        return make()
    key = (kind, dtype, tuple(w._version for w in weights), tuple(w.data_ptr() for w in weights))
    for entry in _restacked_cache:
        if entry[0] == key and all(r() is w for r, w in zip(entry[1], weights)):
            return entry[2]
    value = make()
    _restacked_cache.append((key, tuple(weakref.ref(w) for w in weights), value))
    del _restacked_cache[:-_CACHE_SIZE]
    return value


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
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float] + \
            [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def _tail_kernel_fn():
    fn = getattr(_build.load(TAIL_KERNEL), f"mer_{TAIL_KERNEL}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + \
            [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def layer0_gn(wave: torch.Tensor, weight: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              *, stride: int = L0_STRIDE, eps: float = 1e-5, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """wave [B, L] -> [B, T0, C] in ``dtype``: kernel K7 for CUDA tensors (the
    base geometry only: k 10, stride 5, 512 channels), the plain version for
    CPU tensors. ``layer0_gn.launches`` counts kernel launches (one per call:
    the stats grid, whose last block per clip finalizes, and the apply grid,
    after a fill that zeroes the B per-clip counters)."""
    if not _on_card("layer-0", wave, weight, gamma, beta):
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
    taps = _restacked("l0", [weight], dtype,
                      lambda: weight.detach().to(dtype)[:, 0, :].t().contiguous())  # [10, 512], tap-major
    gamma, beta = (p.detach().float().contiguous() for p in (gamma, beta))
    tile = conv_plan(b, t0).l0_tile
    n_tiles = -(-t0 // tile)
    partial = torch.empty((b, n_tiles, L0_MOMENTS), dtype=torch.float64, device=wave.device)
    stats = torch.empty((b, 2, CHANNELS), dtype=torch.float32, device=wave.device)
    counters = torch.zeros(b, dtype=torch.int32, device=wave.device)
    with torch.cuda.device(wave.device):
        rc = _l0_kernel_fn()(_DTYPE_CODE[dtype], wave.data_ptr(), taps.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                             partial.data_ptr(), stats.data_ptr(), out.data_ptr(), b, length, t0, tile, n_tiles,
                             float(eps), counters.data_ptr(), torch.cuda.current_stream(wave.device).cuda_stream)
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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 stored mantissa bits) to nearest, ties
    away from zero, as the kernel's ``cvt.rna.tf32.f32``: the low 13 bits of
    the pattern cleared after adding half their range to the magnitude."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_tail_weights(weights: Sequence[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 weights of K6's 3xTF32 products: :func:`stack_tail_weights`'
    (w3, w2) in float32, each as [2, n, C, k C], the TF32 high halves
    ``hi = tf32(w)`` then the low halves ``lo = tf32(w - hi)``."""
    halves = []
    for w in stack_tail_weights(weights, torch.float32):
        hi = tf32_round(w)
        halves.append(torch.stack([hi, tf32_round(w - hi)]).contiguous())
    return halves[0], halves[1]


def conv_stack_fused(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     strides: Sequence[int] = TAIL_STRIDES) -> torch.Tensor:
    """x [B, T0, C] (the layer-0 output, in the compute dtype) -> [B, T6, C]:
    kernel K6 for CUDA tensors (the base geometry only), the plain version
    for CPU tensors. ``conv_stack_fused.launches`` counts kernel launches (one
    per call: six grids, one per layer, tiled by :func:`conv_plan`, after a
    fill that zeroes the split tiles' counters where a layer splits K)."""
    if not _on_card("conv-tail", x, *weights):
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
    if x.data_ptr() % 16:
        raise ValueError("the conv-tail kernel reads x through TMA, which needs a 16-byte aligned start")
    split = x.dtype == torch.float32  # the 3xTF32 products take each weight's two halves
    w3, w2 = _restacked("tail", weights, x.dtype,
                        lambda: split_tail_weights(weights) if split else stack_tail_weights(weights, x.dtype))
    buf_a, buf_b = new(lengths[0]), new(lengths[1])
    plan = conv_plan(b, t0)
    values, n_counters = tail_scratch(b, t0, plan)
    partial = torch.empty(values, dtype=torch.float32, device=x.device) if values else None
    counters = torch.zeros(n_counters, dtype=torch.int32, device=x.device) if n_counters else None
    plan_ints = (ctypes.c_int * (2 * len(plan.tail)))(*(v for layer in plan.tail for v in layer))
    with torch.cuda.device(x.device):
        rc = _tail_kernel_fn()(_DTYPE_CODE[x.dtype], x.data_ptr(), w3.data_ptr(), w2.data_ptr(), buf_a.data_ptr(),
                               buf_b.data_ptr(), out.data_ptr(), b, t0, plan_ints,
                               None if partial is None else partial.data_ptr(), values,
                               None if counters is None else counters.data_ptr(), n_counters,
                               torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{TAIL_KERNEL} launch failed: cudaError {rc} at x {tuple(x.shape)} {x.dtype}")
    conv_stack_fused.launches += 1
    return out


conv_stack_fused.launches = 0


def _gn_kernel_fn():
    fn = getattr(_build.load(GN_KERNEL), f"mer_{GN_KERNEL}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gn_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, t_valid: int, eps: float = 1e-5) -> torch.Tensor:
    """x [B, T, 512] (a layer-0 conv output in the compute dtype) -> GroupNorm
    over the rows ``< t_valid`` + exact GELU, [B, T, 512] in x's dtype: kernel
    K8 for CUDA tensors, the plain version for CPU tensors. Rows ``>= t_valid``
    stay out of the statistics and are still written. ``gn_gelu.launches``
    counts kernel launches (one per call: the stats, finalize and apply grids)."""
    if x.dim() != 3 or not 0 < t_valid <= x.shape[1]:
        raise ValueError(f"expected x [B, T, C] and 0 < t_valid <= T; got {tuple(x.shape)}, t_valid {t_valid}")
    if not _on_card("GroupNorm + GELU", x, scale, bias):
        return gn_gelu_reference(x, scale, bias, t_valid, eps)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {x.dtype}")
    if x.shape[2] != CHANNELS or not x.is_contiguous():
        raise ValueError(f"expected a contiguous activation [B, T, {CHANNELS}]; got {tuple(x.shape)}, "
                         f"strides {x.stride()}")
    b, rows, _ = x.shape
    out = torch.empty_like(x)
    if b == 0:
        return out
    gamma, beta = (p.detach().float().contiguous() for p in (scale, bias))
    n_tiles = -(-rows // _GN_TILE)
    partial = torch.empty((b, n_tiles, 2, CHANNELS), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2, CHANNELS), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _gn_kernel_fn()(_DTYPE_CODE[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                             partial.data_ptr(), stats.data_ptr(), out.data_ptr(), b, rows, int(t_valid), n_tiles,
                             float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{GN_KERNEL} launch failed: cudaError {rc} at x {tuple(x.shape)} {x.dtype}")
    gn_gelu.launches += 1
    return out


gn_gelu.launches = 0


def conv_stack_gnfused(wave: torch.Tensor, weights: Sequence[torch.Tensor], gamma: torch.Tensor, beta: torch.Tensor,
                       strides: Sequence[int], *, eps: float = 1e-5,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The conv stack with only the GroupNorm + GELU glue in a kernel
    (``conv_stack_gnfused``, ``w2v_conv_pallas.py:403``): stock ``F.conv1d``
    for all 7 layers, :func:`gn_gelu` (K8) after layer 0 -> [B, T6, C]. The
    layer-0 output goes to K8 at its own length (``t_valid`` = T0); nothing is
    padded."""
    x = F.conv1d(wave.to(dtype)[:, None, :], weights[0].to(dtype), stride=strides[0])
    x = x.transpose(1, 2).contiguous()  # [B, T0, C], the kernels' layout
    x = gn_gelu(x, gamma, beta, x.shape[1], eps)
    return _stock_convs(x.transpose(1, 2), weights[1:], strides[1:]).transpose(1, 2).contiguous()


def conv_stack_l0fused(wave: torch.Tensor, weights: Sequence[torch.Tensor], gamma: torch.Tensor, beta: torch.Tensor,
                       strides: Sequence[int], *, eps: float = 1e-5,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The conv stack with layer 0 + GroupNorm + GELU in a kernel
    (``conv_stack_l0fused``, ``w2v_conv_pallas.py:442``): :func:`layer0_gn`
    (K7), then stock ``F.conv1d`` + GELU for layers 1..6 -> [B, T6, C]."""
    x = layer0_gn(wave, weights[0], gamma, beta, stride=strides[0], eps=eps, dtype=dtype)
    return _stock_convs(x.transpose(1, 2), weights[1:], strides[1:]).transpose(1, 2).contiguous()
