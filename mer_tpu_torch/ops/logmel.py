"""The log-mel spectrogram frontend (counterpart of ``mer_tpu/ops/logmel.py``).

The recipe of the reference's librosa pipeline (audio_mel/dataset.py:93-115,
160-178), batched on the device:

    y   = audio / max|audio|                     over the true samples
    S   = melspectrogram(y, sr=16000, n_fft=400, hop=160, hann, center=True,
                         power=1, n_mels=128, slaney, norm=1)
    out = log(S + eps)                           eps = np.finfo(float).eps
    out = (out - min) / (max - min)              per clip, valid frames only
    out = floor(out * 255) / 255                 the PNG uint8 cache
    zeros past the valid frames; 3 channels      [B, 3, 1001, 128]

The filterbank, window and DFT matrices are the JAX package's numpy code,
copied (built in float64, cast to float32). Framing is ``unfold`` on the
reflect-padded buffer, a strided view; the frames -> log-mel step is
:func:`mer_tpu_torch.ops.logmel_kernel.logmel_frames`: kernel K5 on the card
(there is no switch), its plain version on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

EPS_F64 = float(np.finfo(np.float64).eps)


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    win_length: int = 400
    n_mels: int = 128
    fmin: float = 0.0
    fmax: float | None = None  # None -> sr/2
    max_seconds: float = 10.0  # reference AUDIO.max_duration

    @property
    def max_samples(self) -> int:
        return int(self.max_seconds * self.sample_rate)

    @property
    def max_frames(self) -> int:
        # reference: int(10 * 16000 / 160) + 1 = 1001 (audio_mel/dataset.py:171)
        return int(self.max_seconds * self.sample_rate / self.hop_length) + 1

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann (scipy get_window('hann', n, fftbins=True))."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float64)


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    return np.where(log_region, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int = 16000, n_fft: int = 400, n_mels: int = 128, fmin: float = 0.0,
                   fmax: float | None = None, norm: int | str | None = 1) -> np.ndarray:
    """librosa.filters.mel parity (htk=False, slaney mel scale); ``norm=1``
    (the reference's) divides each triangle by its L1 norm. [n_mels,
    1 + n_fft // 2] float32."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_min, mel_max = _hz_to_mel_slaney(np.asarray([fmin, fmax]))
    mel_f = _mel_to_hz_slaney(np.linspace(mel_min, mel_max, n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights = weights * (2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels]))[:, None]
    elif norm is not None:
        l1 = np.sum(np.abs(weights), axis=1, keepdims=True)
        weights = np.where(l1 > 0, weights / l1, weights)
    return weights.astype(np.float32)


def dft_matrices(n_fft: int, window: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin matrices [n_fft, n_freqs] float32, window folded in."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    cos_m, sin_m = np.cos(angle), -np.sin(angle)
    if window is not None:
        cos_m = cos_m * window[:, None]
        sin_m = sin_m * window[:, None]
    return cos_m.astype(np.float32), sin_m.astype(np.float32)


def reflect_pad_batch(y: torch.Tensor, length: torch.Tensor, max_samples: int, pad: int) -> torch.Tensor:
    """``np.pad(y[:length], pad, mode='reflect')`` per clip over fixed
    [B, max_samples] buffers -> [B, max_samples + 2 pad].

    The same construction as ``mer_tpu``'s, so the same values everywhere:
    the left edge from the reflect index map, the buffer itself, and a patch
    of 3 pad right-reflected samples placed at each clip's length (zeros
    after it; only frames past ``length // hop`` read there, and the caller
    masks those)."""
    b = y.shape[0]
    length = length.to(device=y.device, dtype=torch.int64).clamp(1, max_samples)
    l1 = (length - 1)[:, None]
    pos = torch.arange(pad, 0, -1, device=y.device)[None, :]  # |arange(-pad, 0)|
    pos = torch.where(pos > l1, 2 * l1 - pos, pos)
    left = torch.gather(y, 1, pos.clamp(0, max_samples - 1))
    tail = 3 * pad
    offsets = torch.arange(tail, device=y.device)[None, :]
    patch = torch.gather(y, 1, (l1 - 1 - offsets).clamp(0, max_samples - 1))
    buf = torch.cat([left, y, y.new_zeros(b, tail)], dim=1)
    buf.scatter_(1, pad + length[:, None] + offsets, patch)
    return buf[:, : max_samples + 2 * pad]


def frame_signal(padded: torch.Tensor, n_frames: int, n_fft: int, hop: int) -> torch.Tensor:
    """[B, L] -> [B, n_frames, n_fft] overlapping frames: a strided view of
    ``padded`` (strides L, hop, 1), nothing copied."""
    return padded.unfold(-1, n_fft, hop)[:, :n_frames]


def log_mel_spectrogram(audio: torch.Tensor, length: torch.Tensor, cfg: MelConfig = MelConfig(), *,
                        quantize_png: bool = True, channels_first: bool = True) -> torch.Tensor:
    """Batched log-mel images in [0, 1], float32.

    Args:
        audio: [B, max_samples] waveforms (any float or int dtype), zero past
            ``length``.
        length: [B] true sample counts.
        quantize_png: the reference's uint8 PNG cache quantisation.
        channels_first: [B, 3, max_frames, n_mels] (the reference's tensor);
            else [B, max_frames, n_mels, 3]. The 3 channels are one
            broadcast view.
    """
    from mer_tpu_torch.ops.logmel_kernel import logmel_frames

    b = audio.shape[0]
    device = audio.device
    audio = audio.to(torch.float32)
    length = length.to(device=device, dtype=torch.int64).clamp_min(1)

    # peak normalisation over the true samples (dataset.py:94)
    sample_valid = torch.arange(cfg.max_samples, device=device)[None, :] < length[:, None]
    peak = torch.where(sample_valid, audio.abs(), 0.0).amax(dim=1, keepdim=True)
    y = audio / peak.clamp_min(1e-30)

    padded = reflect_pad_batch(y, length, cfg.max_samples, cfg.n_fft // 2)
    frames = frame_signal(padded, cfg.max_frames, cfg.n_fft, cfg.hop_length)  # [B, F, n_fft] view
    n_frames = 1 + length // cfg.hop_length
    frame_valid = (torch.arange(cfg.max_frames, device=device)[None, :] < n_frames[:, None])[..., None]

    logmel = logmel_frames(frames, cfg)

    # per-clip min-max over the valid frames only (dataset.py:162-164)
    mn = torch.where(frame_valid, logmel, 1e30).reshape(b, -1).amin(dim=1)[:, None, None]
    mx = torch.where(frame_valid, logmel, -1e30).reshape(b, -1).amax(dim=1)[:, None, None]
    out = (logmel - mn) / (mx - mn).clamp_min(1e-30)
    if quantize_png:
        out = torch.floor(out * 255.0) / 255.0  # float -> uint8 truncation -> float
    out = torch.where(frame_valid, out, 0.0)  # zero padding past the valid frames (dataset.py:171-176)

    if channels_first:  # grayscale -> 3-channel replicate (dataset.py:178)
        return out[:, None].expand(b, 3, cfg.max_frames, cfg.n_mels)
    return out[..., None].expand(b, cfg.max_frames, cfg.n_mels, 3)


def prepare_waveform_batch(waves: list[np.ndarray], cfg: MelConfig = MelConfig()) -> tuple[np.ndarray, np.ndarray]:
    """Host side: truncate to max_seconds, zero-pad into a fixed [B, L] buffer."""
    out = np.zeros((len(waves), cfg.max_samples), dtype=np.float32)
    lengths = np.zeros((len(waves),), dtype=np.int32)
    for i, w in enumerate(waves):
        w = np.asarray(w, dtype=np.float32).reshape(-1)[: cfg.max_samples]
        out[i, : w.shape[0]] = w
        lengths[i] = w.shape[0]
    return out, lengths
