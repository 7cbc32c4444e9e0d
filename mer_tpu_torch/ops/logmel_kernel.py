"""Frames -> log-mel: kernel K5 (hand-written CUDA) and its plain version.

Replaces the TPU kernel ``mer_tpu/ops/logmel_pallas.py:78`` (``_kernel``,
launched from ``logmel_frames_pallas`` at ``:106``). For frames [B, F, 400]
f32 it computes

    log((|frames @ (w cos)| (+) |frames @ (w -sin)|) @ mel^T + eps)   [B, F, 128] f32

where (+) is the magnitude sqrt(re^2 + im^2) over the 201 bins, w the
periodic Hann window folded into the DFT matrices (built in float64, cast to
float32, as ``dft_matrices``), mel the L1-normalised Slaney filterbank and
eps the float32 value of the float64 epsilon (JAX's weakly typed add).

The CUDA source is ``mer_tpu_torch/csrc/logmel_fwd.cu``; its header states
the design and the bound (the function is bound by bytes; the dense DFT
the kernel runs is bound by operations on the f32 CUDA cores; the magnitude
stays on chip). :func:`logmel_frames` launches it for CUDA tensors, with no
switch and no fallback, and takes :func:`logmel_frames_reference` only for
CPU tensors. The frames may be the ``unfold`` view of the padded waveforms:
the kernel reads them through their clip and frame strides.

Forward only: no path of the port differentiates through the spectrogram
(``mer_tpu`` routes such gradients through its jnp restatement), so a CUDA
input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mer_tpu_torch.ops import _build
from mer_tpu_torch.ops.logmel import EPS_F64, MelConfig, dft_matrices, hann_window, mel_filterbank

KERNEL = "logmel_fwd"
_PASS_BINS = 128  # the kernel's bins per pass; two passes cover the 201 bins
_PASSES = 2


@functools.lru_cache(maxsize=4)
def _host_operands(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cos [n_fft, bins], sin [n_fft, bins], mel [n_mels, bins]) float32."""
    cos_m, sin_m = dft_matrices(cfg.n_fft, hann_window(cfg.win_length))
    mel_w = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, norm=1)
    return cos_m, sin_m, mel_w


@functools.lru_cache(maxsize=8)
def _plain_operands(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(a).to(device) for a in _host_operands(cfg))


def logmel_frames_reference(frames: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Plain PyTorch version of K5: [B, F, n_fft] -> [B, F, n_mels] f32."""
    cos_m, sin_m, mel_w = _plain_operands(cfg, frames.device)
    frames = frames.to(torch.float32)
    re, im = frames @ cos_m, frames @ sin_m
    mag = torch.sqrt(re * re + im * im)  # power 1
    return torch.log(mag @ mel_w.T + EPS_F64)


@functools.lru_cache(maxsize=8)
def _device_operands(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The kernel's operands on ``device``: the DFT as [2 passes][n_fft][cos
    128 | sin 128] (bin pass * 128 + j, zero past the last bin), the
    filterbank [n_mels, bins], and each band's first and one-past-last
    nonzero bin (0, 0 for a band with none)."""
    cos_m, sin_m, mel_w = _host_operands(cfg)
    bins = cos_m.shape[1]
    operand = np.zeros((_PASSES, cfg.n_fft, 2 * _PASS_BINS), np.float32)
    for p in range(_PASSES):
        cols = slice(p * _PASS_BINS, min((p + 1) * _PASS_BINS, bins))
        width = cols.stop - cols.start
        operand[p, :, :width] = cos_m[:, cols]
        operand[p, :, _PASS_BINS:_PASS_BINS + width] = sin_m[:, cols]
    lo = np.zeros(cfg.n_mels, np.int32)
    hi = np.zeros(cfg.n_mels, np.int32)
    for m in range(cfg.n_mels):
        nz = np.flatnonzero(mel_w[m])
        if len(nz):
            lo[m], hi[m] = nz[0], nz[-1] + 1
    return tuple(torch.from_numpy(a).to(device) for a in (operand, mel_w, lo, hi))


def _kernel_fn():
    fn = getattr(_build.load(KERNEL), f"mer_{KERNEL}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
    return fn


def logmel_frames(frames: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[B, F, n_fft] frames -> [B, F, n_mels] log-mel (unnormalised) f32: the
    kernel for CUDA tensors, the plain version for CPU tensors.
    ``logmel_frames.launches`` counts kernel launches."""
    if frames.device.type == "cpu":
        return logmel_frames_reference(frames, cfg)
    if frames.device.type != "cuda":
        raise ValueError(f"no log-mel kernel for device {frames.device}")
    if frames.requires_grad:
        raise ValueError("the log-mel kernel is forward-only; its input must not require grad")
    if frames.dtype != torch.float32 or frames.dim() != 3 or frames.shape[-1] != cfg.n_fft:
        raise ValueError(f"expected float32 frames [B, F, {cfg.n_fft}]; got {frames.dtype} {tuple(frames.shape)}")
    if frames.stride(-1) != 1 or min(frames.stride()) < 0:
        raise ValueError(f"the kernel reads each frame's taps contiguously; got strides {frames.stride()}")
    b, f, n_fft = frames.shape
    out = torch.empty((b, f, cfg.n_mels), dtype=torch.float32, device=frames.device)
    if b == 0 or f == 0:
        return out
    operand, mel_w, lo, hi = _device_operands(cfg, frames.device)
    with torch.cuda.device(frames.device):
        rc = _kernel_fn()(frames.data_ptr(), frames.stride(0), frames.stride(1), b, f, n_fft, mel_w.shape[1],
                          cfg.n_mels, operand.data_ptr(), mel_w.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                          out.data_ptr(), torch.cuda.current_stream(frames.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {rc} at frames {tuple(frames.shape)}, "
                           f"strides {frames.stride()}")
    logmel_frames.launches += 1
    return out


logmel_frames.launches = 0
