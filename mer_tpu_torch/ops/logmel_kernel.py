"""Frames -> log-mel: kernel K5 (hand-written CUDA) and its plain version.

Replaces the TPU kernel ``mer_tpu/ops/logmel_pallas.py:78`` (``_kernel``,
launched from ``logmel_frames_pallas`` at ``:106``). For frames [B, F, 400]
f32 it computes

    log((|frames @ (w cos)| (+) |frames @ (w -sin)|) @ mel^T + eps)   [B, F, 128] f32

where (+) is the magnitude sqrt(re^2 + im^2) over the 201 bins, w the
periodic Hann window, mel the L1-normalised Slaney filterbank and eps the
float64 epsilon 2^-52 (JAX's weakly typed add; exact in float32 too). The
plain version states it densely in float32 (the window folded into the DFT
matrices, built in float64 and cast to float32, as ``dft_matrices``).

The CUDA source is ``mer_tpu_torch/csrc/logmel_fwd.cu``; its header states
the design and the bound. The kernel computes the real 400-point DFT as a
complex 200-point FFT of the even and odd samples (Stockham, radices 8, 5,
5, in shared memory), unpacks bins 0..200, and keeps the magnitudes on chip
for the mel product; the function is bound by bytes, and a block reads
each sample of its tile of overlapping frames once. It reads f32 samples and
writes f32, with float64 arithmetic between: the mel caches quantise the
log-mel to uint8, and there f32 rounding moves about 1 entry in 10,000 by a
step, while the kernel's cache is the float64 chain's
(:func:`mel_bands_float64`). Its tables (:func:`fft_tables`: the window, the
twiddles W200^m and the unpack factors W400^k) are float64, built on the
host; the filterbank goes in as each band's ``MEL_BAND_WIDTH`` float32
weights (:func:`band_tables`). :func:`logmel_frames` launches it for CUDA tensors, with no switch and no
fallback, and takes :func:`logmel_frames_reference` only for CPU tensors.
The frames may be the ``unfold`` view of the padded waveforms: the kernel
reads them through their clip and frame strides.

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
FFT_RADICES = (8, 5, 5)  # the kernel's Stockham stages over n_fft / 2 = 200 complex points
MEL_BAND_WIDTH = 9  # bins the kernel reads a mel band over (the widest Slaney triangle at 400 taps spans 9)
# How the kernel is held where its plain version cannot witness it: a band at or below MEL_NOTCH of its frame's
# largest band (a spectral notch, where the dense f32 plain version is off a float64 chain beyond 1e-4 in the log) is
# held to a float64 rfft chain instead, as is every band: within MEL_F64_SHARE of the frame's largest band in the
# linear domain (the plain version reads up to 1.5e-6 there and would fail it)
MEL_NOTCH, MEL_F64_SHARE = 1e-2, 1e-6


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


def mel_bands_float64(frames: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """The yardstick that ``MEL_NOTCH`` and ``MEL_F64_SHARE`` hold the kernel
    to, on any device: the mel bands before eps and the log, [B, F, n_mels]
    float64, through a float64 rfft. No path of the port calls it."""
    window = torch.from_numpy(hann_window(cfg.win_length)).to(frames.device)
    bank = torch.from_numpy(_host_operands(cfg)[2]).to(frames.device, torch.float64)
    return torch.fft.rfft(frames.double() * window).abs() @ bank.T


@functools.lru_cache(maxsize=4)
def fft_tables(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's float64 tables: the window [n_fft], the twiddles W200^m =
    exp(-2 pi i m / (n_fft / 2)) as [n_fft / 2, (re, im)] and the unpack
    factors W400^k = exp(-2 pi i k / n_fft) as [bins, (re, im)]."""
    half = cfg.n_fft // 2
    powers = lambda count, n: 2 * np.pi * np.arange(count, dtype=np.float64) / n
    as_pairs = lambda angle: np.stack([np.cos(angle), -np.sin(angle)], axis=-1)
    window = hann_window(cfg.win_length).astype(np.float64)
    return window, as_pairs(powers(half, half)), as_pairs(powers(half + 1, cfg.n_fft))


def band_tables(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank as the kernel reads it: band m's ``MEL_BAND_WIDTH``
    weights [n_mels, MEL_BAND_WIDTH] float32 from bin ``start[m]`` on, each
    window covering the band's nonzeros and held inside the bins (zeros
    around the triangle add exact zeros)."""
    mel_w = _host_operands(cfg)[2]
    bins = mel_w.shape[1]
    start = np.zeros(cfg.n_mels, np.int32)
    for m in range(cfg.n_mels):
        nz = np.flatnonzero(mel_w[m])
        if len(nz):
            if nz[-1] - nz[0] >= MEL_BAND_WIDTH:
                raise ValueError(f"mel band {m} spans {nz[-1] - nz[0] + 1} bins; the kernel reads {MEL_BAND_WIDTH}")
            start[m] = min(nz[0], bins - MEL_BAND_WIDTH)
    weights = np.stack([mel_w[m, s:s + MEL_BAND_WIDTH] for m, s in enumerate(start)])
    return weights, start


@functools.lru_cache(maxsize=8)
def _device_operands(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The kernel's operands on ``device``: :func:`fft_tables` and
    :func:`band_tables`."""
    return tuple(torch.from_numpy(a).to(device) for a in (*fft_tables(cfg), *band_tables(cfg)))


def _kernel_fn():
    fn = getattr(_build.load(KERNEL), f"mer_{KERNEL}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 7)
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
    operands = _device_operands(cfg, frames.device)
    with torch.cuda.device(frames.device):
        rc = _kernel_fn()(frames.data_ptr(), frames.stride(0), frames.stride(1), b, f, n_fft, cfg.n_freqs,
                          cfg.n_mels, MEL_BAND_WIDTH, *(t.data_ptr() for t in operands), out.data_ptr(),
                          torch.cuda.current_stream(frames.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {rc} at frames {tuple(frames.shape)}, "
                           f"strides {frames.stride()}")
    logmel_frames.launches += 1
    return out


logmel_frames.launches = 0
