"""wav2vec2's positional convolution as one op, kernel K9 (hand-written CUDA),
with its plain version.

The grouped conv of ``ConvPositionalEmbedding`` (k 128, 16 groups of 48
channels in wav2vec2-base), padding k // 2, the last
output frame dropped for an even k, plus its bias, over activations [B, T, C]:

    y[b, t, g Cg + o] = bias[g Cg + o] + sum_j sum_i W[g Cg + o, i, j] x[b, t + j - k // 2, g Cg + i],   t < T

with x zero outside [0, T) and W the conv's weight [C, Cg, k]. No TPU kernel
corresponds: ``mer_tpu`` leaves this conv to XLA. :func:`positional_conv` is
the ``torch.autograd.Function`` :class:`ConvolutionPositional` (its node is
``ConvolutionPositionalBackward``) and takes one of three routes, by what its
input shows:

- ``kernel``: a CUDA tensor in bf16, k 128, 48 channels a group:
  ``csrc/w2v_pos_conv.cu``. Its forward kernel, an implicit GEMM on ``wgmma``,
  also gives the data gradient, run over dy with each group's weight
  transposed and its taps reversed (:func:`transposed_taps`) at padding
  k - 1 - k // 2; a second kernel gives the weight and bias gradients.
- ``stock``: any other CUDA tensor (f32, another geometry): ``F.conv1d`` and
  aten's ``convolution_backward``.
- ``plain``: a CPU tensor: :func:`positional_conv_reference` and its
  gradients, loops over the taps.

Numerics, every route: x's dtype is the compute dtype; the weight and bias
are cast to it, products and sums are float32 (float64 for float64 inputs)
and y, dx are rounded to it once. The weight and bias gradients come back in
the parameters' own dtype (the kernel's float32 sums, not rounded to bf16).

``positional_conv.routes`` counts calls by route, ``positional_conv.launches``
the kernels' launches (one a forward, two a backward: data gradient, weight
and bias gradient).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mer_tpu_torch.ops import _build

KERNEL = "w2v_pos_conv"
TAPS = 128  # the kernel's taps
GROUP_CHANNELS = 48  # the kernel's channels a group (wav2vec2-base's)
ROUTES = ("kernel", "stock", "plain")


def route(x: torch.Tensor, weight: torch.Tensor, groups: int) -> str:
    """The route a call on ``x`` [B, T, C] takes (module docstring)."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type != "cuda":
        raise ValueError(f"no positional conv for device {x.device}")
    c = x.shape[-1]
    cg = c // groups
    if x.dtype == torch.bfloat16 and cg == GROUP_CHANNELS and tuple(weight.shape) == (c, cg, TAPS):
        return "kernel"
    return "stock"


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def transposed_taps(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """The data gradient's weight: W'[g Cg + i, o, j] = W[g Cg + o, i, k - 1 - j]."""
    c, cg, k = weight.shape
    return weight.reshape(groups, cg, cg, k).transpose(1, 2).flip(-1).reshape(c, cg, k)


# -- plain version ------------------------------------------------------------------


def _taps_conv(x: torch.Tensor, weight: torch.Tensor, pad: int, groups: int) -> torch.Tensor:
    """sum_j W[..., j] x[t + j - pad] per group, a loop over the taps in x's dtype: x [B, T, C], weight [C, Cg, k]
    -> [B, T, C]."""
    b, t, c = x.shape
    k = weight.shape[-1]
    cg = c // groups
    padded = F.pad(x, (0, 0, pad, k - 1 - pad)).view(b, t + k - 1, groups, cg)
    w = weight.reshape(groups, cg, cg, k)
    out = x.new_zeros(b, t, groups, cg)
    for j in range(k):
        out += torch.einsum("btgi,goi->btgo", padded[:, j:j + t], w[..., j])
    return out.view(b, t, c)


def positional_conv_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                              groups: int) -> torch.Tensor:
    """Plain PyTorch version of the op, any geometry: x [B, T, C], weight [C,
    C / groups, k], bias [C] or None -> [B, T, C] in x's dtype; a loop over
    the taps in float32 over operands cast to x's dtype."""
    dtype = x.dtype
    acc = _sum_dtype(dtype)
    y = _taps_conv(x.to(acc), weight.to(dtype).to(acc), weight.shape[-1] // 2, groups)
    if bias is not None:
        y = y + bias.to(dtype).to(acc)
    return y.to(dtype)


def positional_conv_reference_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, groups: int,
                                       needs=(True, True, True)):
    """Plain (dx, dW, db) of :func:`positional_conv_reference` for the output
    gradient ``dy`` [B, T, C]: dx in x's dtype, dW and db in float32 (float64),
    each None where ``needs`` says so. The operands are cast to x's dtype."""
    dtype = x.dtype
    acc = _sum_dtype(dtype)
    b, t, c = x.shape
    k = weight.shape[-1]
    cg, pad = c // groups, k // 2
    dyf = dy.to(dtype).to(acc)
    dx = dw = db = None
    if needs[0]:
        dx = _taps_conv(dyf, transposed_taps(weight.to(dtype).to(acc), groups), k - 1 - pad, groups).to(dtype)
    if needs[1]:
        padded = F.pad(x.to(acc), (0, 0, pad, k - 1 - pad)).view(b, t + k - 1, groups, cg)
        dyg = dyf.reshape(b, t, groups, cg)
        dw = torch.stack([torch.einsum("btgo,btgi->goi", dyg, padded[:, j:j + t]) for j in range(k)], dim=-1)
        dw = dw.reshape(c, cg, k)
    if needs[2]:
        db = dyf.sum((0, 1))
    return dx, dw, db


# -- the stock route ------------------------------------------------------------------


def _stock_forward(x, weight, bias, groups):
    dtype, t, k = x.dtype, x.shape[1], weight.shape[-1]
    y = F.conv1d(x.transpose(1, 2), weight.to(dtype), None if bias is None else bias.to(dtype), padding=k // 2,
                 groups=groups)
    return y[:, :, :t].transpose(1, 2)


def _stock_backward(dy, x, weight, bias, groups, needs):
    dtype, k = x.dtype, weight.shape[-1]
    gy = dy.to(dtype).transpose(1, 2)
    gy = F.pad(gy, (0, 1 - k % 2))  # an even k's dropped frame: its zero gradient
    dx, dw, db = torch.ops.aten.convolution_backward(
        gy, x.transpose(1, 2), weight.to(dtype), None if bias is None else [bias.shape[0]], [1], [k // 2], [1],
        False, [0], groups, list(needs))
    return None if dx is None else dx.transpose(1, 2), dw, db


# -- the kernel route ----------------------------------------------------------------------


def forward_taps(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """The kernel's weight operand: [C, Cg, k] -> [C / Cg][k][Cg / 8][Cg][8]
    bf16, per group and tap the matrix B[n = out][k = in] in chunks of 8 input
    channels (``taps`` in the CUDA source)."""
    c, cg, k = weight.shape
    return weight.detach().to(torch.bfloat16).reshape(groups, cg, cg // 8, 8, k).permute(0, 4, 2, 1, 3).contiguous()


def _conv_fn():
    fn = getattr(_build.load(KERNEL), f"mer_{KERNEL}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _wgrad_fn():
    fn = getattr(_build.load(KERNEL), f"mer_{KERNEL}_wgrad")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte aligned start (TMA's), copied only where it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _kernel_conv(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor | None, pad: int) -> torch.Tensor:
    """One launch of the forward kernel: x [B, T, C] bf16 -> [B, T, C] bf16."""
    x = _aligned(x)
    b, t, c = x.shape
    out = torch.empty_like(x)
    if b == 0 or t == 0:
        return out
    bias = None if bias is None else bias.detach().to(torch.bfloat16).contiguous()
    with torch.cuda.device(x.device):
        rc = _conv_fn()(x.data_ptr(), taps.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
                        b, t, c, pad, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {rc} at x {tuple(x.shape)}")
    positional_conv.launches += 1
    return out


def _kernel_wgrad(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, needs_bias: bool):
    """One launch of the weight-gradient kernel: (dW [C, Cg, k], db [C] or None), float32."""
    b, t, c = x.shape
    dw = torch.empty(weight.shape, dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device) if needs_bias else None
    if b == 0 or t == 0:
        return dw.zero_(), None if db is None else db.zero_()
    x, dy = _aligned(x), _aligned(dy)
    with torch.cuda.device(x.device):
        rc = _wgrad_fn()(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), None if db is None else db.data_ptr(), b, t, c,
                         TAPS // 2, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} weight-gradient launch failed: cudaError {rc} at x {tuple(x.shape)}")
    positional_conv.launches += 1
    return dw, db


# -- the op ------------------------------------------------------------------------------------


class ConvolutionPositional(torch.autograd.Function):
    """The op with its gradient on every route; autograd names its node
    ``ConvolutionPositionalBackward``."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups):
        way = route(x, weight, groups)
        positional_conv.routes[way] += 1
        ctx.way, ctx.groups = way, groups
        ctx.save_for_backward(x, weight, bias)
        if way == "kernel":
            return _kernel_conv(x, forward_taps(weight, groups), bias, TAPS // 2)
        if way == "stock":
            return _stock_forward(x, weight, bias, groups)
        return positional_conv_reference(x, weight, bias, groups)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], ctx.needs_input_grad[1], bias is not None and ctx.needs_input_grad[2])
        groups = ctx.groups
        if ctx.way == "kernel":
            dx = dw = db = None
            if needs[0]:
                dx = _kernel_conv(dy, forward_taps(transposed_taps(weight, groups), groups), None, TAPS - 1 - TAPS // 2)
            if needs[1] or needs[2]:
                dw, db = _kernel_wgrad(dy, x, weight, needs[2])
        elif ctx.way == "stock":
            dx, dw, db = _stock_backward(dy, x, weight, bias, groups, needs)
        else:
            dx, dw, db = positional_conv_reference_backward(dy, x, weight, groups, needs)
        dw = dw.to(weight.dtype) if needs[1] else None
        db = db.to(bias.dtype) if needs[2] else None
        return dx, dw, db, None


def positional_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, groups: int) -> torch.Tensor:
    """x [B, T, C] -> the positional conv's output [B, T, C] in x's dtype
    (module docstring), differentiable in x, weight and bias."""
    if x.dim() != 3 or weight.dim() != 3 or x.shape[-1] % groups or weight.shape[:2] != (x.shape[-1],
                                                                                       x.shape[-1] // groups):
        raise ValueError(f"expected x [B, T, C] and weight [C, C / groups, k]; got x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, {groups} groups")
    return ConvolutionPositional.apply(x, weight, bias, groups)


positional_conv.launches = 0
positional_conv.routes = dict.fromkeys(ROUTES, 0)
